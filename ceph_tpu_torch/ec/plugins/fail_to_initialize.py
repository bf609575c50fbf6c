"""Broken-on-purpose plugin: init entry point raises (reference
src/test/erasure-code/ErasureCodePluginFailToInitialize.cc)."""


def __erasure_code_init__(registry) -> None:
    raise RuntimeError("fail_to_initialize: deliberately failing init")

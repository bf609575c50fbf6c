"""Broken-on-purpose plugin: init succeeds but never registers (reference
src/test/erasure-code/ErasureCodePluginFailToRegister.cc)."""


def __erasure_code_init__(registry) -> None:
    pass

"""Broken-on-purpose plugin: registers with a bad ABI version (reference
src/test/erasure-code/ErasureCodePluginMissingVersion.cc)."""
from ..registry import ErasureCodePlugin


class _BadVersionPlugin(ErasureCodePlugin):
    version = "0.0.0-bogus"

    def factory(self, profile):
        raise AssertionError("must never be reached")


def __erasure_code_init__(registry) -> None:
    registry.add("missing_version", _BadVersionPlugin())

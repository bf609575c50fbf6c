"""Broken-on-purpose plugin: no __erasure_code_init__ symbol (reference
src/test/erasure-code/ErasureCodePluginMissingEntryPoint.cc)."""

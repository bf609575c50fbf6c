"""ISA-L-equivalent codec plugin (reference
src/erasure-code/isa/ErasureCodeIsa.{h,cc} + ErasureCodePluginIsa.cc).

Reproduces the ISA plugin's observable behavior — matrix constructions
(gf_gen_rs_matrix / gf_gen_cauchy1_matrix semantics, same GF(2^8) poly
0x11D), per-chunk 32-byte alignment chunk sizing (EC_ISA_ADDRESS_ALIGNMENT,
reference isa/xor_op.h:28), technique dispatch and k/m clamps
(reference ErasureCodeIsa.cc:320-360) — on our own GF kernels.  The
per-erasure-signature decode-table LRU the reference keeps
(ErasureCodeIsaTableCache.cc) maps to CodecCore's decode cache.
"""
from __future__ import annotations

from ...ops import matrix as mat
from ...ops.engine import CodecCore
from ..interface import ErasureCodeProfile, ErasureCodeValidationError
from ..registry import ErasureCodePlugin
from .jerasure import ErasureCodeJerasure

EC_ISA_ADDRESS_ALIGNMENT = 32


class ErasureCodeIsaDefault(ErasureCodeJerasure):
    """Matrix-backed ISA codec (reference ErasureCodeIsa.h:103)."""

    DEFAULT_K, DEFAULT_M, DEFAULT_W = "7", "3", "8"

    def __init__(self, technique: str = "reed_sol_van"):
        super().__init__(technique)

    def parse(self, profile: ErasureCodeProfile) -> None:
        super().parse(profile)
        self.w = 8  # ISA-L is GF(2^8) only
        if self.technique == "reed_sol_van":
            # verified-safe MDS envelope (reference ErasureCodeIsa.cc:332-360)
            if self.k > 32:
                raise ErasureCodeValidationError(
                    f"Vandermonde: k={self.k} should be less/equal than 32")
            if self.m > 4:
                raise ErasureCodeValidationError(
                    f"Vandermonde: m={self.m} should be less than 5 to "
                    "guarantee an MDS codec")
            if self.m == 4 and self.k > 21:
                raise ErasureCodeValidationError(
                    f"Vandermonde: k={self.k} should be less than 22 "
                    "for m=4 to guarantee an MDS codec")

    def get_alignment(self) -> int:
        return EC_ISA_ADDRESS_ALIGNMENT

    def get_chunk_size(self, object_size: int) -> int:
        """Per-chunk alignment (reference ErasureCodeIsa.cc:66-79)."""
        alignment = self.get_alignment()
        chunk_size = (object_size + self.k - 1) // self.k
        modulo = chunk_size % alignment
        if modulo:
            chunk_size += alignment - modulo
        return chunk_size

    def prepare(self) -> None:
        if self.technique == "cauchy":
            M = mat.isa_cauchy_matrix(self.k, self.m)
        else:
            M = mat.isa_rs_vandermonde_matrix(self.k, self.m)
        self.core = CodecCore(self.k, self.m, 8, coding_matrix=M,
                              layout="byte", backend=self.make_backend())


class ErasureCodePluginIsa(ErasureCodePlugin):
    """Technique dispatch (reference ErasureCodePluginIsa.cc:38-56)."""

    TECHNIQUES = ("reed_sol_van", "cauchy")

    def factory(self, profile: ErasureCodeProfile):
        technique = profile.get("technique", "reed_sol_van")
        if technique not in self.TECHNIQUES:
            raise ErasureCodeValidationError(
                f"technique={technique} is not a valid coding technique")
        codec = ErasureCodeIsaDefault(technique)
        codec.init(profile)
        return codec


def __erasure_code_init__(registry) -> None:
    registry.add("isa", ErasureCodePluginIsa())

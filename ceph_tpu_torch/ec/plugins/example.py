"""Example XOR codec plugin — k=2, m=1, parity = d0 ^ d1.

Equivalent of the reference's in-tree example used by the registry and
base-class tests (reference src/test/erasure-code/ErasureCodeExample.h,
ErasureCodePluginExample.cc): the smallest complete codec.
"""
from __future__ import annotations

from typing import Dict, Mapping, Set

import numpy as np

from ..interface import ErasureCode, ErasureCodeProfile
from ..registry import ErasureCodePlugin


class ErasureCodeExample(ErasureCode):
    k = 2
    m = 1

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_chunk_size(self, object_size: int) -> int:
        return -(-object_size // self.k)

    def minimum_to_decode_with_cost(self, want_to_read: Set[int],
                                    available: Mapping[int, int]) -> Set[int]:
        # prefer the cheapest 2 of the 3 chunks (reference
        # ErasureCodeExample.h:66-89)
        if len(available) < self.k:
            raise IOError("not enough available chunks")
        cheapest = sorted(available, key=lambda c: (available[c], c))
        return set(cheapest[:self.k])

    def encode_chunks(self, want_to_encode: Set[int],
                      encoded: Dict[int, np.ndarray]) -> None:
        encoded[2][:] = np.bitwise_xor(encoded[0], encoded[1])

    def decode_chunks(self, want_to_read: Set[int],
                      chunks: Mapping[int, np.ndarray],
                      decoded: Dict[int, np.ndarray]) -> None:
        if len(chunks) < self.k:
            raise IOError("not enough chunks to decode")
        have = sorted(chunks)
        for i in range(self.k + self.m):
            if i not in chunks:
                a, b = (j for j in have if j != i)
                decoded[i][:] = np.bitwise_xor(np.asarray(chunks[a]),
                                               np.asarray(chunks[b]))


class ErasureCodePluginExample(ErasureCodePlugin):
    def factory(self, profile: ErasureCodeProfile):
        interface = ErasureCodeExample()
        interface.init(profile)
        return interface


def __erasure_code_init__(registry) -> None:
    registry.add("example", ErasureCodePluginExample())

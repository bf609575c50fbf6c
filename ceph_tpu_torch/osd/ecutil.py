"""Stripe algebra + batched stripe codec for the EC backend.

Python-native equivalent of the reference's ECUtil (reference
src/osd/ECUtil.{h,cc}):

* ``StripeInfo`` — the reference's ``stripe_info_t`` (ECUtil.h:27-81):
  stripe_width = k * chunk_size and the offset algebra between logical
  object extents and per-shard chunk extents;
* ``encode`` / ``decode`` — the reference's per-stripe loops
  (ECUtil.cc:120-159 encode, :9-118 decode), re-designed device-first:
  instead of calling the codec once per stripe_width block, the whole
  aligned extent is reshaped to a ``[nstripes, k, chunk]`` array and
  encoded in ONE batched device call (the plugin's ``encode_batch``;
  SURVEY.md §3.1 "HOT LOOP" / §5 "batch the stripe loop into one
  [batch, k, chunk] device call").  Codecs without the batched API
  (jerasure/isa/lrc/shec/clay CPU plugins) fall back to the reference's
  per-stripe loop;
* ``HashInfo`` — per-shard cumulative CRC xattr (reference ECUtil.h:
  161-245, key ``hinfo_key``) used by append writes and deep scrub
  (reference ECBackend.cc:2475 compares chunk CRCs, no decode).
"""
from __future__ import annotations

import json
from ..utils.crc import crc32c
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np

HINFO_KEY = "hinfo_key"  # reference ECUtil.h ECUtil::get_hinfo_key()


def nbytes_of(data) -> int:
    """Byte length of any bytes-like (bytes, bytearray, memoryview,
    uint8 ndarray) — the write path now threads views and arrays, not
    just bytes."""
    if isinstance(data, (bytes, bytearray)):
        return len(data)
    if isinstance(data, np.ndarray):
        return data.nbytes
    return memoryview(data).nbytes


def as_stripe_array(data, nstripes: int, k: int,
                    chunk_size: int) -> np.ndarray:
    """View ``data`` as a [nstripes, k, chunk] uint8 array without
    copying (buffer-protocol objects and ndarrays alike)."""
    if isinstance(data, np.ndarray):
        arr = data if data.dtype == np.uint8 \
            else data.view(np.uint8)
        return arr.reshape(nstripes, k, chunk_size)
    return np.frombuffer(data, dtype=np.uint8).reshape(
        nstripes, k, chunk_size)


class StripeInfo:
    """reference ECUtil::stripe_info_t (ECUtil.h:27)."""

    def __init__(self, k: int, stripe_width: int):
        assert stripe_width % k == 0, \
            f"stripe_width {stripe_width} not a multiple of k {k}"
        self.k = k
        self.stripe_width = stripe_width
        self.chunk_size = stripe_width // k

    # -- offset algebra (reference ECUtil.h:44-81) ------------------------
    def logical_to_prev_chunk_offset(self, offset: int) -> int:
        return (offset // self.stripe_width) * self.chunk_size

    def logical_to_next_chunk_offset(self, offset: int) -> int:
        return ((offset + self.stripe_width - 1) //
                self.stripe_width) * self.chunk_size

    def logical_to_prev_stripe_offset(self, offset: int) -> int:
        return offset - (offset % self.stripe_width)

    def logical_to_next_stripe_offset(self, offset: int) -> int:
        return ((offset + self.stripe_width - 1) //
                self.stripe_width) * self.stripe_width

    def aligned_logical_offset_to_chunk_offset(self, offset: int) -> int:
        assert offset % self.stripe_width == 0
        return (offset // self.stripe_width) * self.chunk_size

    def chunk_aligned_logical_offset_to_chunk_offset(
            self, offset: int) -> int:
        return self.logical_to_prev_chunk_offset(offset)

    def aligned_chunk_offset_to_logical_offset(self, offset: int) -> int:
        assert offset % self.chunk_size == 0
        return (offset // self.chunk_size) * self.stripe_width

    def offset_len_to_stripe_bounds(
            self, offset: int, length: int) -> Tuple[int, int]:
        """Logical extent -> enclosing stripe-aligned extent
        (reference offset_len_to_stripe_bounds)."""
        start = self.logical_to_prev_stripe_offset(offset)
        end = self.logical_to_next_stripe_offset(offset + length)
        return start, end - start

    def object_size_to_shard_size(self, size: int) -> int:
        """Logical (stripe-padded) object size -> per-shard object size."""
        return self.logical_to_next_chunk_offset(size)


# ---------------------------------------------------------------------------
# batched stripe encode / decode
# ---------------------------------------------------------------------------

def chunk_positions(ec_impl) -> List[int]:
    """The codec's chunk position of each shard.

    The backend numbers shards in code order: shard i < k holds data
    column i and shard k + j parity j, as encode_batch and decode_batch
    lay them out.  A codec with a chunk mapping (LRC's kml form maps
    k=4 m=2 l=3 to ``DD__DD__``) names chunks by position in its
    per-chunk API (encode, decode, minimum_to_decode), so calls to that
    API translate shard ids through this list; without a mapping it is
    the identity."""
    return [ec_impl.chunk_index(i) for i in range(ec_impl.get_chunk_count())]


def minimum_to_decode(ec_impl, want: Set[int], avail: Set[int]
                      ) -> Dict[int, List[Tuple[int, int]]]:
    """The codec's minimum_to_decode over shard ids: {shard: sub-chunk
    runs}.  Raises IOError when ``avail`` cannot give ``want``."""
    pos = chunk_positions(ec_impl)
    shard_of = {p: i for i, p in enumerate(pos)}
    need = ec_impl.minimum_to_decode({pos[i] for i in want},
                                     {pos[i] for i in avail})
    return {shard_of[p]: runs for p, runs in need.items()}


def encode(sinfo: StripeInfo, ec_impl, data: bytes,
           want: Optional[Set[int]] = None) -> Dict[int, bytes]:
    """Encode a stripe-aligned extent into per-shard chunk buffers.

    Reference ECUtil::encode (ECUtil.cc:120-159) loops stripe-by-stripe
    calling ec_impl->encode per stripe_width block; here the whole
    extent becomes one [nstripes, k, chunk] batch and a single device
    call when the codec has ``encode_batch`` (the gpu plugin), else the
    per-stripe loop runs on the CPU codec.

    Returns {shard_id: chunk_bytes} of len nstripes*chunk_size each.
    """
    k = ec_impl.get_data_chunk_count()
    m = ec_impl.get_coding_chunk_count()
    nb = nbytes_of(data)
    assert nb % sinfo.stripe_width == 0, \
        f"len {nb} not stripe aligned"
    if want is None:
        want = set(range(k + m))
    nstripes = nb // sinfo.stripe_width
    if nstripes == 0:
        return {i: b"" for i in want}

    arr = as_stripe_array(data, nstripes, k, sinfo.chunk_size)
    if hasattr(ec_impl, "encode_batch"):
        parity = ec_impl.encode_batch(arr)          # [B, m, chunk]
        out: Dict[int, bytes] = {}
        for i in want:
            if i < k:
                out[i] = arr[:, i].tobytes()
            else:
                out[i] = parity[:, i - k].tobytes()
        return out

    # CPU fallback: the reference's sequential per-stripe loop
    pos = chunk_positions(ec_impl)
    chunks: Dict[int, List[bytes]] = {i: [] for i in want}
    for s in range(nstripes):
        encoded = ec_impl.encode(set(range(k + m)),
                                 arr[s].tobytes())
        for i in want:
            chunks[i].append(encoded[pos[i]])
    return {i: b"".join(chunks[i]) for i in want}


def decode(sinfo: StripeInfo, ec_impl,
           have: Mapping[int, bytes],
           want: Set[int]) -> Dict[int, bytes]:
    """Reconstruct wanted shard chunks from available ones, batched.

    Reference ECUtil::decode (ECUtil.cc:47-118): per-stripe
    decode_chunks; here all stripes of the extent decode in one batched
    call when the codec supports it (gpu plugin's ``decode_batch``).
    Every buffer in ``have`` must be the same chunk-aligned length.
    """
    if not have:
        raise IOError("no chunks to decode from")
    total = nbytes_of(next(iter(have.values())))
    assert all(nbytes_of(v) == total for v in have.values()), \
        "shard buffers must be equal length"
    assert total % sinfo.chunk_size == 0
    nstripes = total // sinfo.chunk_size
    missing = set(want) - set(have)
    if not missing:
        return {i: bytes(have[i]) for i in want}
    if nstripes == 0:
        return {i: b"" for i in want}

    if hasattr(ec_impl, "decode_batch"):
        present = {i: as_stripe_array(v, nstripes, 1, sinfo.chunk_size)
                   .reshape(nstripes, sinfo.chunk_size)
                   for i, v in have.items()}
        rec = ec_impl.decode_batch(present, sinfo.chunk_size)
        out: Dict[int, bytes] = {}
        for i in want:
            if i in have:
                out[i] = bytes(have[i])
            else:
                out[i] = np.ascontiguousarray(rec[i]).tobytes()
        return out

    # CPU fallback: per-stripe decode
    pos = chunk_positions(ec_impl)
    parts: Dict[int, List[bytes]] = {i: [] for i in want}
    for s in range(nstripes):
        lo, hi = s * sinfo.chunk_size, (s + 1) * sinfo.chunk_size
        stripe_have = {pos[i]: v[lo:hi] for i, v in have.items()}
        dec = ec_impl.decode({pos[i] for i in want}, stripe_have,
                             sinfo.chunk_size)
        for i in want:
            parts[i].append(dec[pos[i]])
    return {i: b"".join(parts[i]) for i in want}


def decode_concat(sinfo: StripeInfo, ec_impl,
                  have: Mapping[int, bytes]) -> bytes:
    """Reconstruct and concatenate the k data shards back into the
    logical byte stream (reference ECUtil::decode concat variant,
    ECUtil.cc:9-45)."""
    k = ec_impl.get_data_chunk_count()
    want = set(range(k))
    dec = decode(sinfo, ec_impl, have, want)
    total = len(next(iter(dec.values())))
    nstripes = total // sinfo.chunk_size if sinfo.chunk_size else 0
    if nstripes == 0:
        return b""
    shards = np.stack([np.frombuffer(dec[i], dtype=np.uint8).reshape(
        nstripes, sinfo.chunk_size) for i in range(k)], axis=1)
    return shards.reshape(nstripes * sinfo.stripe_width).tobytes()


# ---------------------------------------------------------------------------
# HashInfo (reference ECUtil.h:161-245)
# ---------------------------------------------------------------------------

class HashInfo:
    """Cumulative per-shard chunk CRC + total logical chunk size,
    persisted as the ``hinfo_key`` xattr on every shard object.

    Append-only accounting exactly like the reference: each
    append_chunks() call folds the new chunk bytes into each shard's
    running CRC (reference HashInfo::append).  Deep scrub recomputes a
    shard's CRC from stored bytes and compares — no decode needed
    (reference ECBackend.cc:2475-2579).
    """

    def __init__(self, num_chunks: int):
        self.total_chunk_size = 0            # per-shard bytes hashed
        self.crcs: List[int] = [0] * num_chunks

    def append(self, old_size: int, chunks: Mapping[int, bytes]) -> None:
        assert old_size == self.total_chunk_size, \
            f"append at {old_size} != hashed {self.total_chunk_size}"
        size = None
        for i, buf in chunks.items():
            # crc32c reads straight from the buffer — no bytes() copy
            self.crcs[i] = crc32c(buf, self.crcs[i])
            if size is None:
                size = nbytes_of(buf)
            assert size == nbytes_of(buf), "unequal chunk appends"
        if size:
            self.total_chunk_size += size

    def clear(self) -> None:
        self.total_chunk_size = 0
        self.crcs = [0] * len(self.crcs)

    def encode(self) -> bytes:
        return json.dumps({"s": self.total_chunk_size,
                           "c": self.crcs}).encode()

    @classmethod
    def decode(cls, buf: bytes) -> "HashInfo":
        d = json.loads(buf.decode())
        hi = cls(len(d["c"]))
        hi.total_chunk_size = d["s"]
        hi.crcs = list(d["c"])
        return hi


def chunk_crc(data) -> int:
    """CRC of a full shard object, for deep-scrub comparison."""
    return crc32c(data)

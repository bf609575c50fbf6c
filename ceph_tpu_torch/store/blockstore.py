"""BlockStore: objects on raw block space + KV metadata (BlueStore).

Python-native equivalent of the reference's flagship store (reference
``src/os/bluestore/`` — BlueStore.cc 16.7k LoC): object DATA lives on
a raw block device carved into fixed blocks by an allocator (reference
BitmapAllocator), all METADATA (existence, extent maps, xattrs, omap,
allocator state) lives in a key-value DB (reference RocksDB via
BlueFS; here the framework's LogDB), and overwrites are COPY-ON-WRITE
into freshly allocated blocks (reference blob/extent COW) so crash
consistency reduces to "data blocks written+synced BEFORE the one
atomic KV commit that references them".

Every data block carries a CRC32C in the extent map, verified on
every read (reference BlueStore::_verify_csum on each blob read,
BlueStore.cc:10425,10446 — scrub is the backstop, the csum is the
front line): a mismatch surfaces as EIO so the OSD read path retries
over other replicas/shards and repair-via-recovery can re-home a good
copy over the rot.  Large aligned writes optionally compress inline
through the framework's compressor registry (reference
bluestore_compression_algorithm/_mode, BlueStore.cc:4549 blob
compression): a run of full blocks that shrinks by at least one block
is stored as a compressed SEGMENT; per-logical-block CRCs are kept of
the UNCOMPRESSED content, so the same verify covers both paths.

Layout:
  block file     fixed ``BLOCK`` -sized slots, grown on demand
  kv ``meta``    C/<coll>, E/<coll>/<obj>          (as FileStore)
                 A/… xattrs, M/… omap, H/… omap header
                 X/<coll>/<obj> -> {"size": n, "blocks": [...],
                                    "crcs": [...], "segs": {...}}
                 alloc          -> allocator bitmap (bytes)
                 J/<seq>        -> journaled Transaction (WAL)

``blocks[lb]``: >= 0 raw physical block, -1 hole, <= -2 member of
compressed segment ``-(lb_value) - 2`` (see ``_Extents``).

Write path per transaction: journal the txn (WAL) → for every touched
logical block, read old block (if partial), merge, write a NEW block →
fsync the block file once → commit ONE KV batch that flips extent
maps, frees the replaced blocks in the bitmap, and retires the
journal entry.  A crash before the commit replays the journal; blocks
allocated but never referenced were also never persisted as allocated,
so nothing leaks.
"""
from __future__ import annotations

import errno
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Set

from ..utils.crc import crc32c
from ..utils.finisher import Finisher
from .filestore import _BatchView, _objkey, _unobjkey
from .kv import LogDB, WriteBatch
from .objectstore import (GHObject, ObjectStat, ObjectStore,
                          Transaction, check_ops, xor_into)

BLOCK = 4096
# compress only runs of at least this many full blocks (reference
# bluestore min_blob sizing: tiny blobs aren't worth the cycles)
COMPRESS_MIN_BLOCKS = 4


class BitmapAllocator:
    """Fixed-block allocator (reference BitmapAllocator): a bytearray
    of 0/1 flags, persisted opaquely in the KV at each commit."""

    def __init__(self, state: bytes = b""):
        self.bits = bytearray(state)

    def allocate(self) -> int:
        idx = self.bits.find(0)
        if idx < 0:
            idx = len(self.bits)
            self.bits.extend(b"\x00" * 1024)
        self.bits[idx] = 1
        return idx

    def free(self, idx: int) -> None:
        if 0 <= idx < len(self.bits):
            self.bits[idx] = 0

    def state(self) -> bytes:
        return bytes(self.bits)  # copycheck: ok - allocator bitmap snapshot for the KV record, not payload

    def used(self) -> int:
        return sum(self.bits)


class _Extents:
    """Per-object extent map (reference ExtentMap + blob csums):
    logical block i -> physical block (>= 0), hole (-1), or compressed
    segment member (value <= -2 names segment ``-value - 2``); a
    parallel per-logical-block CRC32C of the UNCOMPRESSED content
    (0 = hole/unknown — pre-csum maps verify lazily as they rewrite);
    and the segment table sid -> {phys blocks, compressed length,
    algorithm, first logical block}."""

    def __init__(self, size: int = 0,
                 blocks: Optional[List[int]] = None,
                 crcs: Optional[List[int]] = None,
                 segs: Optional[Dict[str, dict]] = None):
        self.size = size
        self.blocks = blocks if blocks is not None else []
        self.crcs = crcs if crcs is not None else []
        self.segs = segs if segs is not None else {}
        while len(self.crcs) < len(self.blocks):
            self.crcs.append(0)

    @classmethod
    def load(cls, raw: Optional[bytes]) -> "_Extents":
        if raw is None:
            return cls()
        d = json.loads(raw.decode())
        return cls(d["size"], d["blocks"], d.get("crcs"),
                   d.get("segs"))

    def dump(self) -> bytes:
        out = {"size": self.size, "blocks": self.blocks,
               "crcs": self.crcs}
        if self.segs:
            out["segs"] = self.segs
        return json.dumps(out).encode()

    def seg_of(self, lb: int) -> Optional[str]:
        v = self.blocks[lb]
        return str(-v - 2) if v <= -2 else None

    def next_sid(self) -> str:
        return str(1 + max((int(s) for s in self.segs), default=-1))


class BlockStore(ObjectStore):
    medium = "hdd"
    """reference BlueStore, collapsed to its storage model."""

    def __init__(self, path: str, compression: str = "none"):
        self.path = path
        self._lock = threading.RLock()
        self._db: Optional[LogDB] = None
        self._dev = None                 # block file handle
        self._alloc: Optional[BitmapAllocator] = None
        self._journal_seq = 0
        self._finisher: Optional[Finisher] = None
        # inline compression (reference bluestore_compression_algorithm)
        # — decompression ignores this and honors whatever algorithm a
        # segment was written with, so flipping the option is safe on
        # existing data
        self._comp_alg = "" if compression in ("", "none") \
            else compression
        self._comp = None
        # observability (reference bluestore compressed/original statfs
        # + checksum error counters)
        self.compress_logical_bytes = 0
        self.compress_stored_bytes = 0
        self.csum_failures = 0

    def _compressor(self, alg: str):
        from ..compressor import registry as creg
        if self._comp is None or self._comp.name != alg:
            self._comp = creg().create(alg)
        return self._comp

    # -- lifecycle -----------------------------------------------------
    def mkfs(self) -> None:
        os.makedirs(self.path, exist_ok=True)
        db = LogDB(os.path.join(self.path, "meta.kv"))
        db.open()
        db.close()
        open(os.path.join(self.path, "block.dev"), "ab").close()

    def mount(self) -> None:
        with self._lock:
            if self._db is not None:
                return
            db = LogDB(os.path.join(self.path, "meta.kv"))
            db.open()
            self._db = db
            self._dev = open(os.path.join(self.path, "block.dev"),
                             "r+b" if os.path.exists(
                                 os.path.join(self.path, "block.dev"))
                             else "w+b")
            self._alloc = BitmapAllocator(db.get("alloc") or b"")
            self._finisher = Finisher("blockstore")
            self._replay_journal()

    def umount(self) -> None:
        # drain queued commit callbacks BEFORE closing anything: they
        # may touch the store (FileStore does the same)
        if self._finisher:
            self._finisher.wait_for_empty()
            self._finisher.stop()
            self._finisher = None
        with self._lock:
            if self._db is None:
                return
            self._db.close()
            self._db = None
            self._dev.close()
            self._dev = None

    def _replay_journal(self) -> None:
        """Re-apply journaled transactions (reference deferred-write
        replay): data may have partially landed; COW makes re-apply
        idempotent at the extent-map level."""
        entries = sorted(self._db.iterate("J/"))
        for key, raw in entries:
            txn = Transaction.decode(raw)
            batch = WriteBatch()
            dirty = self._apply_ops(txn.ops, batch, replay=True)
            self._flush_dev(dirty)
            batch.rm(key)
            batch.set("alloc", self._alloc.state())
            self._db.submit(batch, sync=True)
            self._journal_seq = max(self._journal_seq,
                                    int(key.split("/")[1]))

    # -- checksum seam -------------------------------------------------
    def _crc_block(self, ext: _Extents, lb: int, blk: bytes) -> None:
        """Stamp the per-logical-block CRC of freshly written content.
        Synchronous base: compute inline, one host call per block.
        BlueStore overrides to queue the block and fold all CRCs of an
        apply batch through one GF-bitmatrix pass (_crc_fold)."""
        ext.crcs[lb] = crc32c(blk)

    def _crc_fold(self) -> None:
        """Hook before extent maps fold into the KV batch: deferred
        checksum backends materialize queued CRCs here (base: CRCs
        were computed inline, nothing to do)."""

    # -- block IO ------------------------------------------------------
    def _read_block(self, phys: int) -> bytes:
        self._dev.seek(phys * BLOCK)
        buf = self._dev.read(BLOCK)
        return buf.ljust(BLOCK, b"\x00")

    def _write_block(self, phys: int, data: bytes) -> None:
        assert len(data) == BLOCK
        self._dev.seek(phys * BLOCK)
        self._dev.write(data)

    def _flush_dev(self, dirty: bool) -> None:
        if dirty:
            self._dev.flush()
            os.fsync(self._dev.fileno())

    # -- keys ----------------------------------------------------------
    @staticmethod
    def _xkey(coll: str, obj: GHObject) -> str:
        return f"X/{coll}/{_objkey(obj)}"

    def _exists_key(self, coll: str, obj: GHObject) -> str:
        return f"E/{coll}/{_objkey(obj)}"

    def _load_extents(self, coll: str, obj: GHObject) -> _Extents:
        return _Extents.load(self._db.get(self._xkey(coll, obj)))

    # -- transaction apply ---------------------------------------------
    def _do_queue_transactions(self, txns: List[Transaction],
                               on_commit: Optional[Callable[[], None]]
                               = None) -> None:
        with self._lock:
            if self._db is None:
                raise RuntimeError("store not mounted")
            merged = Transaction()
            for txn in txns:
                merged.ops.extend(txn.ops)
            check_ops(merged.ops,
                      lambda c: self._db.get(f"C/{c}") is not None,
                      lambda c, o: self._db.get(
                          self._exists_key(c, o)) is not None)
            self._journal_seq += 1
            jkey = f"J/{self._journal_seq:016d}"
            record = merged.encode()
            self._txn_meta("journal_bytes", len(record))
            # WAL append and WAL durability are separate ledger
            # phases: a wedged disk shows up as journal_fsync, a
            # bloated txn encode as journal_append
            self._db.submit(WriteBatch().set(jkey, record))
            self._stamp_txn("journal_append")
            self._db.sync()
            self._stamp_txn("journal_fsync")
            batch = WriteBatch()
            try:
                dirty = self._apply_ops(merged.ops, batch)
            except Exception:
                # apply failed (e.g. csum EIO on an RMW base read):
                # COW means nothing it did is referenced — the KV
                # batch was never submitted, so extent maps are
                # untouched and blocks it allocated were never
                # persisted as allocated.  Retire the WAL entry and
                # surface the error; leaving it would re-raise the
                # same failure from _replay_journal on EVERY mount
                # (one rotten block must not brick the store)
                self._db.submit(WriteBatch().rm(jkey), sync=True)
                raise
            self._flush_dev(dirty)       # data durable first
            self._stamp_txn("data_write")
            batch.rm(jkey)
            batch.set("alloc", self._alloc.state())
            self._db.submit(batch, sync=True)   # ONE atomic flip
            self._stamp_txn("kv_commit")
            fin = self._finisher
        for txn in txns:
            for fn in txn.on_applied:
                fn()
        self._stamp_txn("flush")
        callbacks = [fn for txn in txns for fn in txn.on_commit]
        if on_commit is not None:
            callbacks.append(on_commit)
        for fn in callbacks:
            fin.queue(fn)

    def apply_transaction(self, txn: Transaction) -> None:
        self.queue_transactions([txn])

    def _apply_ops(self, ops, batch: WriteBatch,
                   replay: bool = False) -> bool:
        """-> True if the block device was written."""
        # overlay of extent maps mutated within this txn; the batch
        # view gives read-your-writes for metadata (same-txn mkcoll,
        # clone of a just-written source, ...)
        ext_cache: Dict[str, _Extents] = {}
        view = _BatchView(self._db, batch)
        freed: Set[int] = set()
        allocated: List[int] = []
        dirty = False
        # alloc/compress interleave per block inside this loop, so
        # their time cannot carry monotone ledger stamps: it
        # accumulates here and rides the ledger as carved meta
        # seconds (store_ledger.charge carves them out of data_write)
        alloc_s = 0.0
        compress_s = 0.0

        def alloc() -> int:
            # every in-txn allocation is tracked so a failed apply
            # (csum EIO mid-transaction) rolls the in-memory bitmap
            # back — otherwise the next successful commit would
            # persist the leak with no reclaim path
            nonlocal alloc_s
            t0 = time.time()
            phys = self._alloc.allocate()
            allocated.append(phys)
            alloc_s += time.time() - t0
            return phys

        def get_ext(coll, obj) -> _Extents:
            key = self._xkey(coll, obj)
            if key not in ext_cache:
                ext_cache[key] = _Extents.load(view.get(key))
            return ext_cache[key]

        def read_in_txn(coll, obj) -> bytes:
            return self._materialize(get_ext(coll, obj))

        def put_ext(coll, obj, ext) -> None:
            ext_cache[self._xkey(coll, obj)] = ext

        def ensure_obj(coll, obj):
            if view.get(f"C/{coll}") is None:
                raise FileNotFoundError(f"no collection {coll!r}")
            batch.set(self._exists_key(coll, obj), b"")

        def free_ext(ext: _Extents) -> None:
            for phys in ext.blocks:
                if phys >= 0:
                    freed.add(phys)
            for seg in ext.segs.values():
                freed.update(seg["phys"])

        def grow(ext: _Extents, nblocks: int) -> None:
            while len(ext.blocks) < nblocks:
                ext.blocks.append(-1)
                ext.crcs.append(0)

        def read_base_block(ext: _Extents, lb: int) -> bytes:
            """RMW base read, CRC-verified: merging over rotten bytes
            and stamping a FRESH crc would launder the corruption as
            valid data — the partial write must fail with EIO instead
            (and the txn unrolls via the queue_transactions guard)."""
            blk = self._read_block(ext.blocks[lb])
            want = ext.crcs[lb] if lb < len(ext.crcs) else 0
            if want and crc32c(blk) != want:
                self.csum_failures += 1
                raise OSError(errno.EIO,
                              f"csum mismatch at logical block {lb} "
                              f"(RMW base)")
            return blk

        def flatten_seg(ext: _Extents, sid: str,
                        drop_lbs: frozenset = frozenset()) -> None:
            """Dissolve a compressed segment back into raw COW blocks
            (members in ``drop_lbs`` become holes instead): any
            mutation that touches part of a segment re-materializes
            the rest — overwrite of compressed data is the store's
            rare path, so simplicity wins over re-compression.  When
            every member is dropped (full overwrite / truncate-away)
            nothing is decompressed: the old bytes are not needed, so
            a ROTTEN segment must not brick the overwrite that would
            replace it."""
            nonlocal dirty
            seg = ext.segs.pop(sid)
            keep = [i for i in range(seg["nlb"])
                    if (lb := seg["lb0"] + i) < len(ext.blocks)
                    and ext.seg_of(lb) == sid and lb not in drop_lbs]
            raw = self._decompress_seg(seg) if keep else b""
            for i in range(seg["nlb"]):
                lb = seg["lb0"] + i
                if lb >= len(ext.blocks) or ext.seg_of(lb) != sid:
                    continue             # member dropped earlier
                if i not in keep:
                    ext.blocks[lb] = -1
                    ext.crcs[lb] = 0
                    continue
                blk = raw[i * BLOCK:(i + 1) * BLOCK]
                phys = alloc()
                self._write_block(phys, blk)
                ext.blocks[lb] = phys
                self._crc_block(ext, lb, blk)
                dirty = True
            freed.update(seg["phys"])

        def flatten_range(ext: _Extents, lb0: int, lb1: int,
                          drop_lbs: frozenset = frozenset()) -> None:
            for lb in range(lb0, min(lb1, len(ext.blocks))):
                sid = ext.seg_of(lb)
                if sid is not None:
                    flatten_seg(ext, sid, drop_lbs)

        def try_compress(ext, data, offset, first_full, last_full
                         ) -> bool:
            """Store the full-block span [first_full, last_full) as a
            compressed segment when it saves at least one block;
            -> True when it did (reference BlueStore blob compression:
            compress, keep only if the result helps)."""
            nonlocal dirty, compress_s
            nfull = last_full - first_full
            if not self._comp_alg or nfull < COMPRESS_MIN_BLOCKS:
                return False
            lo = first_full * BLOCK - offset
            span = data[lo:lo + nfull * BLOCK]
            t0 = time.time()
            try:
                comp = self._compressor(self._comp_alg).compress(span)
            except Exception:
                return False
            finally:
                compress_s += time.time() - t0
            nphys = (len(comp) + BLOCK - 1) // BLOCK
            if nphys >= nfull:           # no win: store raw
                return False
            # old content of the span: raw blocks freed, segment
            # members flattened-with-drop (their survivors re-home)
            flatten_range(ext, first_full, last_full,
                          frozenset(range(first_full, last_full)))
            phys_list = []
            for i in range(nphys):
                phys = alloc()
                self._write_block(phys, comp[i * BLOCK:(i + 1) * BLOCK]
                                  .ljust(BLOCK, b"\x00"))
                phys_list.append(phys)
            sid = ext.next_sid()
            ext.segs[sid] = {"phys": phys_list, "clen": len(comp),
                             "alg": self._comp_alg, "lb0": first_full,
                             "nlb": nfull}
            ref = -(int(sid) + 2)
            for i in range(nfull):
                lb = first_full + i
                if ext.blocks[lb] >= 0:
                    freed.add(ext.blocks[lb])
                ext.blocks[lb] = ref
                self._crc_block(ext, lb,
                                span[i * BLOCK:(i + 1) * BLOCK])
            self.compress_logical_bytes += len(span)
            self.compress_stored_bytes += nphys * BLOCK
            self._txn_meta("compress_logical", len(span))
            self._txn_meta("compress_stored", nphys * BLOCK)
            dirty = True
            return True

        def write_extent(coll, obj, offset, data) -> None:
            nonlocal dirty
            ensure_obj(coll, obj)
            ext = get_ext(coll, obj)
            end = offset + len(data)
            nblocks = (max(ext.size, end) + BLOCK - 1) // BLOCK
            grow(ext, nblocks)
            first_full = (offset + BLOCK - 1) // BLOCK
            last_full = end // BLOCK
            ranges = [(offset, end)]
            if try_compress(ext, data, offset, first_full, last_full):
                ranges = [(offset, first_full * BLOCK),
                          (last_full * BLOCK, end)]
            for lo, hi in ranges:
                if lo >= hi:
                    continue
                # a partial overwrite of a compressed segment member
                # re-materializes the segment's survivors first —
                # but blocks this write FULLY covers need none of
                # their old bytes, so they drop instead of decompress
                # (a rotten segment must not brick the overwrite that
                # replaces it, and a full overwrite of compressed
                # data must not pay a pointless decompress)
                full = frozenset(range((lo + BLOCK - 1) // BLOCK,
                                       hi // BLOCK))
                flatten_range(ext, lo // BLOCK,
                              (hi + BLOCK - 1) // BLOCK, full)
                pos = lo
                while pos < hi:
                    lb = pos // BLOCK
                    boff = pos % BLOCK
                    run = min(BLOCK - boff, hi - pos)
                    old_phys = ext.blocks[lb]
                    if boff == 0 and run == BLOCK:
                        base = b"\x00" * BLOCK
                    elif old_phys >= 0:
                        base = read_base_block(ext, lb)
                    else:
                        base = b"\x00" * BLOCK
                    merged_blk = (base[:boff]
                                  + data[pos - offset:pos - offset
                                         + run]
                                  + base[boff + run:])
                    new_phys = alloc()   # COW
                    self._write_block(new_phys, merged_blk)
                    if old_phys >= 0:
                        freed.add(old_phys)
                    ext.blocks[lb] = new_phys
                    self._crc_block(ext, lb, merged_blk)
                    dirty = True
                    pos += run
            ext.size = max(ext.size, end)
            put_ext(coll, obj, ext)

        def xor_extent(coll, obj, offset, data) -> None:
            """Parity-delta fold: read ONLY the covered blocks
            (zero-fill holes/EOF, compressed members re-home first),
            XOR the delta in, then store through the normal COW write
            path so CRC discipline and crash atomicity are inherited
            rather than re-implemented."""
            ensure_obj(coll, obj)
            ext = get_ext(coll, obj)
            end = offset + len(data)
            lb0, lb1 = offset // BLOCK, (end + BLOCK - 1) // BLOCK
            flatten_range(ext, lb0, lb1)
            base = bytearray(len(data))
            pos = offset
            while pos < end:
                lb = pos // BLOCK
                boff = pos % BLOCK
                run = min(BLOCK - boff, end - pos)
                if lb < len(ext.blocks) and ext.blocks[lb] >= 0:
                    blk = read_base_block(ext, lb)
                    base[pos - offset:pos - offset + run] = \
                        blk[boff:boff + run]
                pos += run
            put_ext(coll, obj, ext)
            xor_into(base, 0, data)
            write_extent(coll, obj, offset, base)

        for op in ops:
            name = op[0]
            try:
                if name == "touch":
                    _, coll, obj = op
                    ensure_obj(coll, obj)
                    put_ext(coll, obj, get_ext(coll, obj))
                elif name == "write":
                    _, coll, obj, offset, data = op
                    write_extent(coll, obj, offset, data)
                elif name == "xor_write":
                    _, coll, obj, offset, data = op
                    xor_extent(coll, obj, offset, data)
                elif name == "zero":
                    _, coll, obj, offset, length = op
                    ensure_obj(coll, obj)
                    ext = get_ext(coll, obj)
                    end = offset + length
                    nblocks = (max(ext.size, end) + BLOCK - 1) // BLOCK
                    grow(ext, nblocks)
                    # aligned full blocks become holes (deallocation,
                    # as BlueStore treats zero); ragged edges RMW;
                    # compressed segments re-home their survivors
                    first_full = (offset + BLOCK - 1) // BLOCK
                    last_full = end // BLOCK
                    flatten_range(ext, first_full, last_full,
                                  frozenset(range(first_full,
                                                  last_full)))
                    for lb in range(first_full, last_full):
                        if ext.blocks[lb] >= 0:
                            freed.add(ext.blocks[lb])
                        ext.blocks[lb] = -1
                        ext.crcs[lb] = 0
                    ext.size = max(ext.size, end)
                    put_ext(coll, obj, ext)
                    if first_full * BLOCK > offset:
                        write_extent(coll, obj, offset,
                                     b"\x00" * min(length,
                                                   first_full * BLOCK
                                                   - offset))
                    if end > max(last_full * BLOCK, offset):
                        lo = max(last_full * BLOCK, offset)
                        write_extent(coll, obj, lo,
                                     b"\x00" * (end - lo))
                elif name == "truncate":
                    _, coll, obj, size = op
                    ensure_obj(coll, obj)
                    ext = get_ext(coll, obj)
                    nblocks = (size + BLOCK - 1) // BLOCK
                    # any segment reaching past the cut (or holding
                    # the new ragged tail block) re-homes its kept
                    # members; the cut ones drop straight to holes.
                    # A block-aligned cut keeps block nblocks-1 whole,
                    # so its segment (if any) survives untouched.
                    flat_from = nblocks if size % BLOCK == 0 \
                        else max(0, nblocks - 1)
                    flatten_range(ext, flat_from, len(ext.blocks),
                                  frozenset(range(nblocks,
                                                  len(ext.blocks))))
                    for phys in ext.blocks[nblocks:]:
                        if phys >= 0:
                            freed.add(phys)
                    ext.blocks = ext.blocks[:nblocks]
                    ext.crcs = ext.crcs[:nblocks]
                    grow(ext, nblocks)           # grow = holes
                    if size % BLOCK and size < ext.size:
                        lb = size // BLOCK
                        if lb < len(ext.blocks) and \
                                ext.blocks[lb] >= 0:
                            base = read_base_block(ext, lb)
                            keep = size % BLOCK
                            blk = base[:keep].ljust(BLOCK, b"\x00")
                            new_phys = alloc()
                            self._write_block(new_phys, blk)
                            freed.add(ext.blocks[lb])
                            ext.blocks[lb] = new_phys
                            self._crc_block(ext, lb, blk)
                            dirty = True
                    ext.size = size
                    put_ext(coll, obj, ext)
                elif name == "remove":
                    _, coll, obj = op
                    if view.get(f"C/{coll}") is None:
                        raise FileNotFoundError(f"no coll {coll!r}")
                    free_ext(get_ext(coll, obj))
                    k = _objkey(obj)
                    batch.rm(self._exists_key(coll, obj))
                    batch.rm(self._xkey(coll, obj))
                    batch.rm(f"H/{coll}/{k}")
                    batch.rm_prefix(f"A/{coll}/{k}/")
                    batch.rm_prefix(f"M/{coll}/{k}/")
                    ext_cache.pop(self._xkey(coll, obj), None)
                elif name == "clone":
                    _, coll, src, dst = op
                    if view.get(self._exists_key(coll, src)) is None:
                        raise FileNotFoundError(
                            f"no object {src} in {coll!r}")
                    data = read_in_txn(coll, src)
                    # dst replaced wholesale
                    free_ext(get_ext(coll, dst))
                    put_ext(coll, dst, _Extents())
                    ensure_obj(coll, dst)
                    if data:
                        write_extent(coll, dst, 0, data)
                    sk, dk = _objkey(src), _objkey(dst)
                    for pfx in ("A", "M"):
                        src_pfx = f"{pfx}/{coll}/{sk}/"
                        src_rows = view.iterate(src_pfx)
                        batch.rm_prefix(f"{pfx}/{coll}/{dk}/")
                        for kk, vv in src_rows:
                            batch.set(
                                f"{pfx}/{coll}/{dk}/"
                                f"{kk[len(src_pfx):]}", vv)
                    hdr = view.get(f"H/{coll}/{sk}")
                    batch.rm(f"H/{coll}/{dk}")
                    if hdr is not None:
                        batch.set(f"H/{coll}/{dk}", hdr)
                elif name == "setattr":
                    _, coll, obj, attr, value = op
                    ensure_obj(coll, obj)
                    batch.set(f"A/{coll}/{_objkey(obj)}/{attr}", value)
                elif name == "setattrs":
                    _, coll, obj, attrs = op
                    ensure_obj(coll, obj)
                    for a, v in attrs.items():
                        batch.set(f"A/{coll}/{_objkey(obj)}/{a}", v)
                elif name == "rmattr":
                    _, coll, obj, attr = op
                    batch.rm(f"A/{coll}/{_objkey(obj)}/{attr}")
                elif name == "omap_setkeys":
                    _, coll, obj, kvs = op
                    ensure_obj(coll, obj)
                    for kk, vv in kvs.items():
                        batch.set(f"M/{coll}/{_objkey(obj)}/{kk}", vv)
                elif name == "omap_rmkeys":
                    _, coll, obj, keys = op
                    for kk in keys:
                        batch.rm(f"M/{coll}/{_objkey(obj)}/{kk}")
                elif name == "omap_clear":
                    _, coll, obj = op
                    batch.rm_prefix(f"M/{coll}/{_objkey(obj)}/")
                elif name == "omap_setheader":
                    _, coll, obj, hdr = op
                    ensure_obj(coll, obj)
                    batch.set(f"H/{coll}/{_objkey(obj)}", hdr)
                elif name == "mkcoll":
                    _, coll = op
                    batch.set(f"C/{coll}", b"")
                elif name == "rmcoll":
                    _, coll = op
                    # free every object's blocks and purge all of the
                    # collection's metadata rows — a later mkcoll with
                    # the same name must start empty (FileStore parity)
                    pfx = f"E/{coll}/"
                    for kk, _vv in view.iterate(pfx):
                        o = _unobjkey(kk[len(pfx):])
                        free_ext(get_ext(coll, o))
                        ext_cache.pop(self._xkey(coll, o), None)
                    batch.rm_prefix(f"E/{coll}/")
                    batch.rm_prefix(f"X/{coll}/")
                    batch.rm_prefix(f"A/{coll}/")
                    batch.rm_prefix(f"M/{coll}/")
                    batch.rm_prefix(f"H/{coll}/")
                    batch.rm(f"C/{coll}")
                elif name == "coll_move_rename":
                    (_, src_coll, src, dst_coll, dst) = op
                    if view.get(self._exists_key(src_coll,
                                                 src)) is None:
                        raise FileNotFoundError(
                            f"no object {src} in {src_coll!r}")
                    data = read_in_txn(src_coll, src)
                    ensure_obj(dst_coll, dst)
                    free_ext(get_ext(dst_coll, dst))
                    put_ext(dst_coll, dst, _Extents())
                    if data:
                        write_extent(dst_coll, dst, 0, data)
                    sk = _objkey(src)
                    dk = _objkey(dst)
                    for pfx in ("A", "M"):
                        src_pfx = f"{pfx}/{src_coll}/{sk}/"
                        rows = view.iterate(src_pfx)
                        batch.rm_prefix(f"{pfx}/{dst_coll}/{dk}/")
                        for kk, vv in rows:
                            batch.set(
                                f"{pfx}/{dst_coll}/{dk}/"
                                f"{kk[len(src_pfx):]}", vv)
                    hdr = view.get(f"H/{src_coll}/{sk}")
                    batch.rm(f"H/{dst_coll}/{dk}")
                    if hdr is not None:
                        batch.set(f"H/{dst_coll}/{dk}", hdr)
                    batch.rm(f"H/{src_coll}/{sk}")
                    # drop the source
                    free_ext(get_ext(src_coll, src))
                    batch.rm(self._exists_key(src_coll, src))
                    batch.rm(self._xkey(src_coll, src))
                    batch.rm_prefix(f"A/{src_coll}/{sk}/")
                    batch.rm_prefix(f"M/{src_coll}/{sk}/")
                    ext_cache.pop(self._xkey(src_coll, src), None)
                else:
                    raise ValueError(f"unknown store op {name!r}")
            except Exception as e:
                # missing object (idempotent re-apply) or csum EIO:
                # on replay, skip the op and keep mounting — a WAL
                # entry poisoned by rot must not brick the store.
                # Any other failure: roll the in-memory bitmap back
                # (nothing this apply did is referenced — the batch
                # never commits) and surface the error.  The rollback
                # covers EVERY exception kind, not just OSError — a
                # malformed op mid-transaction must not leak its
                # earlier allocations into the next commit
                if replay and isinstance(e, OSError):
                    continue
                for phys in allocated:
                    self._alloc.free(phys)
                raise
        # the COW flip: all extent maps updated in the same batch
        # (deferred-checksum backends land their batched CRCs first so
        # the dumped maps carry real values, not placeholders)
        self._crc_fold()
        for key, ext in ext_cache.items():
            batch.set(key, ext.dump())
        for phys in freed:
            self._alloc.free(phys)
        # IO accounting + carved phase seconds onto the ledger
        # (no-ops during mount-time replay — no active ledger)
        if allocated:
            self._txn_meta("blocks_allocated", len(allocated))
        if freed:
            self._txn_meta("blocks_freed", len(freed))
        if alloc_s > 0:
            self._txn_meta("alloc_s", alloc_s)
        if compress_s > 0:
            self._txn_meta("compress_s", compress_s)
        return dirty

    # -- reads ---------------------------------------------------------
    def _check_obj(self, coll: str, obj: GHObject) -> None:
        if self._db is None:
            raise RuntimeError("store not mounted")
        if self._db.get(f"C/{coll}") is None:
            raise FileNotFoundError(f"no collection {coll!r}")
        if self._db.get(self._exists_key(coll, obj)) is None:
            raise FileNotFoundError(f"no object {obj} in {coll!r}")

    def _decompress_seg(self, seg: dict) -> bytes:
        """Compressed segment -> its nlb * BLOCK uncompressed bytes."""
        comp = bytearray()
        for phys in seg["phys"]:
            comp.extend(self._read_block(phys))
        try:
            raw = self._compressor(seg["alg"]).decompress(
                bytes(comp[:seg["clen"]]))  # copycheck: ok - zlib/lz4 need a contiguous buffer; read path, not apply
        except Exception as e:
            self.csum_failures += 1
            raise OSError(errno.EIO,
                          f"segment decompress failed: {e!r}")
        if len(raw) != seg["nlb"] * BLOCK:
            self.csum_failures += 1
            raise OSError(errno.EIO, "segment length mismatch")
        return raw

    def _materialize(self, ext: _Extents) -> bytes:
        """Full object bytes with every block CRC-verified (reference
        _verify_csum on each read, BlueStore.cc:10425): rot surfaces
        as EIO here instead of propagating silently — the OSD read
        path turns it into a reconstructing/replica retry and scrub
        repair re-homes a good copy."""
        out = bytearray()
        seg_cache: Dict[str, bytes] = {}
        for lb, phys in enumerate(ext.blocks):
            if phys == -1:
                out.extend(b"\x00" * BLOCK)
                continue
            sid = ext.seg_of(lb)
            if sid is None:
                blk = self._read_block(phys)
            else:
                if sid not in seg_cache:
                    seg_cache[sid] = self._decompress_seg(
                        ext.segs[sid])
                i = lb - ext.segs[sid]["lb0"]
                blk = seg_cache[sid][i * BLOCK:(i + 1) * BLOCK]
            want = ext.crcs[lb] if lb < len(ext.crcs) else 0
            if want and crc32c(blk) != want:
                self.csum_failures += 1
                raise OSError(errno.EIO,
                              f"csum mismatch at logical block {lb}")
            out.extend(blk)
        return bytes(out[:ext.size])  # copycheck: ok - returns an immutable object image; read path, not apply

    def _read_object(self, coll: str, obj: GHObject) -> bytes:
        return self._materialize(self._load_extents(coll, obj))

    def read(self, coll: str, obj: GHObject, offset: int = 0,
             length: Optional[int] = None) -> bytes:
        with self._lock:
            self._check_obj(coll, obj)
            data = self._read_object(coll, obj)
        if length is None:
            return data[offset:]
        return data[offset:offset + length]

    def stat(self, coll: str, obj: GHObject) -> ObjectStat:
        with self._lock:
            self._check_obj(coll, obj)
            ext = self._load_extents(coll, obj)
            return ObjectStat(size=ext.size)

    def exists(self, coll: str, obj: GHObject) -> bool:
        with self._lock:
            if self._db is None:
                return False
            return self._db.get(self._exists_key(coll, obj)) is not None

    def getattr(self, coll: str, obj: GHObject, name: str) -> bytes:
        with self._lock:
            self._check_obj(coll, obj)
            v = self._db.get(f"A/{coll}/{_objkey(obj)}/{name}")
            if v is None:
                raise KeyError(name)
            return v

    def getattrs(self, coll: str, obj: GHObject) -> Dict[str, bytes]:
        with self._lock:
            self._check_obj(coll, obj)
            pfx = f"A/{coll}/{_objkey(obj)}/"
            return {k[len(pfx):]: v
                    for k, v in self._db.iterate(pfx)}

    def omap_get(self, coll: str, obj: GHObject) -> Dict[str, bytes]:
        with self._lock:
            self._check_obj(coll, obj)
            pfx = f"M/{coll}/{_objkey(obj)}/"
            return {k[len(pfx):]: v
                    for k, v in self._db.iterate(pfx)}

    def omap_get_header(self, coll: str, obj: GHObject) -> bytes:
        with self._lock:
            self._check_obj(coll, obj)
            return self._db.get(f"H/{coll}/{_objkey(obj)}") or b""

    def omap_get_keys(self, coll: str, obj: GHObject,
                      start_after: str = "",
                      max_return: Optional[int] = None) -> List[str]:
        keys = sorted(self.omap_get(coll, obj))
        keys = [k for k in keys if k > start_after]
        return keys[:max_return] if max_return else keys

    def list_collections(self) -> List[str]:
        with self._lock:
            return sorted(k[2:] for k, _ in self._db.iterate("C/"))

    def collection_exists(self, coll: str) -> bool:
        with self._lock:
            return self._db.get(f"C/{coll}") is not None

    def collection_list(self, coll: str, start_after: str = "",
                        max_return: Optional[int] = None
                        ) -> List[GHObject]:
        with self._lock:
            pfx = f"E/{coll}/"
            objs = []
            for k, _ in self._db.iterate(pfx):
                objs.append(_unobjkey(k[len(pfx):]))
            objs.sort(key=lambda o: (o.oid, o.shard))
            objs = [o for o in objs if o.oid > start_after]
            return objs[:max_return] if max_return else objs

    # -- introspection -------------------------------------------------
    def usage(self) -> Dict:
        """Allocator accounting (reference bluestore statfs)."""
        with self._lock:
            return {"block_size": BLOCK,
                    "blocks_used": self._alloc.used(),
                    "bytes_used": self._alloc.used() * BLOCK,
                    "dev_bytes": os.path.getsize(
                        os.path.join(self.path, "block.dev")),
                    "compress_logical_bytes":
                        self.compress_logical_bytes,
                    "compress_stored_bytes":
                        self.compress_stored_bytes,
                    "csum_failures": self.csum_failures}


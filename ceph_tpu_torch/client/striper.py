"""Striping: client-side RAID-0 of logical data over many objects.

Python-native equivalent of the reference's Striper + libradosstriper
(reference ``src/osdc/Striper.h:26`` ``file_to_extents`` /
``extent_to_file``, and ``src/libradosstriper/`` 2.8k LoC exposing it
over librados).  The layout algebra matches ``file_layout_t``
(reference include/fs_types.h): data advances in ``stripe_unit``
blocks round-robin across ``stripe_count`` objects; each object holds
``object_size`` bytes; a group of stripe_count objects is an object
set.  Object names are ``<soid>.%016x`` like libradosstriper's.

Striped-entity metadata (logical size, layout) lives as xattrs on the
first object (``.0000000000000000``), mirroring libradosstriper's
``striper.size``/``striper.layout`` xattrs.  The reference serializes
concurrent size updates with cls_lock; here last-writer-wins on the
size xattr (single-writer per entity is the supported pattern, as in
RBD's one-client-per-image default).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .rados import IoCtx, RadosError

XATTR_SIZE = "striper.size"
XATTR_LAYOUT = "striper.layout"


@dataclass(frozen=True)
class Layout:
    """reference file_layout_t: validity rules per fs_types.h —
    object_size a multiple of stripe_unit; all non-zero."""
    stripe_unit: int = 64 << 10
    stripe_count: int = 4
    object_size: int = 4 << 20

    def validate(self) -> None:
        if self.stripe_unit <= 0 or self.stripe_count <= 0 \
                or self.object_size <= 0:
            raise ValueError("layout fields must be positive")
        if self.object_size % self.stripe_unit:
            raise ValueError("object_size must be a multiple of "
                             "stripe_unit")

    @property
    def stripes_per_object(self) -> int:
        return self.object_size // self.stripe_unit

    def dump(self) -> Dict:
        return {"stripe_unit": self.stripe_unit,
                "stripe_count": self.stripe_count,
                "object_size": self.object_size}

    @classmethod
    def load(cls, d: Dict) -> "Layout":
        return cls(stripe_unit=d["stripe_unit"],
                   stripe_count=d["stripe_count"],
                   object_size=d["object_size"])


@dataclass
class ObjectExtent:
    """One object's slice of a logical extent (reference
    Striper::ObjectExtent): where in the object, and which logical
    ranges land there (buffer_extents)."""
    oid: str
    objectno: int
    offset: int                      # within the object
    length: int
    buffer_extents: List[Tuple[int, int]]  # (logical off, len)


def object_name(soid: str, objectno: int) -> str:
    """libradosstriper naming: ``<soid>.%016x``."""
    return f"{soid}.{objectno:016x}"


def file_to_extents(soid: str, layout: Layout, offset: int,
                    length: int) -> List[ObjectExtent]:
    """Map a logical [offset, offset+length) onto object extents
    (reference Striper::file_to_extents, osdc/Striper.cc — same
    su/stripeno/objectsetno arithmetic, walked su-block by su-block
    with coalescing of adjacent blocks in the same object)."""
    layout.validate()
    su = layout.stripe_unit
    sc = layout.stripe_count
    spo = layout.stripes_per_object
    # 1) cut the logical range into su-blocks, locating each
    blocks: List[Tuple[int, int, int, int]] = []  # (objno, x_off, len, pos)
    pos = offset
    end = offset + length
    while pos < end:
        blockno = pos // su
        stripeno = blockno // sc
        stripepos = blockno % sc         # which object in the set
        objectsetno = stripeno // spo
        objectno = objectsetno * sc + stripepos
        x_off = (stripeno % spo) * su + pos % su
        x_len = min(end - pos, su - (pos % su))
        blocks.append((objectno, x_off, x_len, pos))
        pos += x_len
    # 2) per object, coalesce blocks contiguous in object space into
    # one ObjectExtent (reference assimilates into the extent whose
    # in-object range abuts)
    per_obj: Dict[int, List[Tuple[int, int, int]]] = {}
    for objectno, x_off, x_len, lpos in blocks:
        per_obj.setdefault(objectno, []).append((x_off, x_len, lpos))
    out: List[ObjectExtent] = []
    for objectno in sorted(per_obj):
        runs = sorted(per_obj[objectno])
        cur: Optional[ObjectExtent] = None
        for x_off, x_len, lpos in runs:
            if cur is not None and cur.offset + cur.length == x_off:
                cur.length += x_len
                cur.buffer_extents.append((lpos, x_len))
            else:
                cur = ObjectExtent(
                    oid=object_name(soid, objectno),
                    objectno=objectno, offset=x_off, length=x_len,
                    buffer_extents=[(lpos, x_len)])
                out.append(cur)
    return out


class StripedIoCtx:
    """libradosstriper-equivalent API over an IoCtx (reference
    libradosstriper/RadosStriperImpl.cc write/read/trunc/stat)."""

    def __init__(self, ioctx: IoCtx, layout: Optional[Layout] = None):
        self.ioctx = ioctx
        if layout is None:
            try:
                conf = ioctx.rados.conf   # the CLUSTER's config, not
                # the process-global default (per-cluster overrides
                # must be honored)
                layout = Layout(
                    stripe_unit=conf["fs_default_stripe_unit"],
                    stripe_count=conf["fs_default_stripe_count"],
                    object_size=conf["fs_default_object_size"])
            except Exception:
                layout = Layout()
        self.default_layout = layout

    # -- metadata ------------------------------------------------------
    def _meta_oid(self, soid: str) -> str:
        return object_name(soid, 0)

    def _load_meta(self, soid: str) -> Tuple[int, Layout]:
        try:
            size = int(self.ioctx.getxattr(self._meta_oid(soid),
                                           XATTR_SIZE))
            layout = Layout.load(json.loads(self.ioctx.getxattr(
                self._meta_oid(soid), XATTR_LAYOUT)))
        except RadosError as e:
            if e.errno in (2, 61):       # ENOENT / ENODATA
                # genuinely absent (no object, or object without the
                # striper xattrs) -> ENOENT.  Anything else (EIO,
                # timeout, cluster unhealthy) must NOT read as "new
                # entity" — write() would reset size/layout and corrupt
                # the existing data
                raise RadosError(2, f"no striped object {soid!r}")
            raise
        return size, layout

    def _store_meta(self, soid: str, size: int, layout: Layout) -> None:
        meta = self._meta_oid(soid)
        self.ioctx.setxattr(meta, XATTR_SIZE, str(size).encode())
        self.ioctx.setxattr(meta, XATTR_LAYOUT,
                            json.dumps(layout.dump()).encode())

    # -- data ----------------------------------------------------------
    def _check_file_size(self, end: int) -> None:
        try:
            limit = self.ioctx.rados.conf["mds_max_file_size"]
        except Exception:
            return
        if end > limit:
            raise ValueError(
                f"write past mds_max_file_size ({end} > {limit})")

    def write(self, soid: str, data: bytes, offset: int = 0,
              layout: Optional[Layout] = None) -> None:
        """Scatter one logical write across the objects it touches
        (reference RadosStriperImpl::write -> one aio per extent)."""
        try:
            size, layout = self._load_meta(soid)
        except RadosError as e:
            if e.errno != 2:
                raise
            layout = layout or self.default_layout
            size = 0
        self._check_file_size(offset + len(data))
        completions = []
        # slice per-extent buffers out of ONE view of the caller's
        # data: a single-run extent (the whole-object/full-stripe case)
        # rides as a zero-copy view all the way to the wire; multi-run
        # extents gather once into a preallocated bytearray.  The view
        # pins the caller's buffer until the ops complete — callers
        # must not mutate `data` while a write is in flight.
        src = memoryview(data)
        for ext in file_to_extents(soid, layout, offset, len(data)):
            if len(ext.buffer_extents) == 1:
                lo, ln = ext.buffer_extents[0]
                buf = src[lo - offset:lo - offset + ln]
            else:
                from ..utils import copytrack
                buf = bytearray(ext.length)
                dst = memoryview(buf)
                pos = 0
                for lo, ln in ext.buffer_extents:
                    dst[pos:pos + ln] = src[lo - offset:lo - offset + ln]
                    pos += ln
                copytrack.note_copy(ext.length, "striper.write_gather")
            completions.append(self.ioctx.rados.objecter.submit(
                self.ioctx.pool_id, ext.oid,
                [self._write_op(ext.offset, buf)]))
        for c in completions:
            res = c.wait(self.ioctx.rados.op_timeout)
            if res < 0:
                raise RadosError(-res, f"striped write: {res}")
        new_size = max(size, offset + len(data))
        self._store_meta(soid, new_size, layout)

    @staticmethod
    def _write_op(offset: int, data: bytes):
        from ..msg.messages import OSDOp
        return OSDOp("write", offset=offset, data=data)

    def read(self, soid: str, length: int = 0, offset: int = 0
             ) -> bytes:
        """Gather a logical extent; holes (missing objects / short
        objects) read as zeros, like the reference's sparse handling."""
        size, layout = self._load_meta(soid)
        if offset >= size or size == 0:
            return b""
        if length == 0 or offset + length > size:
            length = size - offset
        out = bytearray(length)
        pending = []
        for ext in file_to_extents(soid, layout, offset, length):
            from ..msg.messages import OSDOp
            c = self.ioctx.rados.objecter.submit(
                self.ioctx.pool_id, ext.oid,
                [OSDOp("read", offset=ext.offset, length=ext.length)])
            pending.append((ext, c))
        out_mv = memoryview(out)
        for ext, c in pending:
            res = c.wait(self.ioctx.rados.op_timeout)
            if res < 0 and res != -2:
                raise RadosError(-res, f"striped read: {res}")
            data = c.reply.out_data[0] if res >= 0 else b""
            # fill the preallocated result through views: no per-chunk
            # intermediate slices, one direct copy reply -> result
            src = memoryview(data)
            pos = 0
            for lo, ln in ext.buffer_extents:
                n = min(ln, len(src) - pos)
                if n > 0:
                    out_mv[lo - offset:lo - offset + n] = \
                        src[pos:pos + n]
                pos += ln
        out_mv.release()
        return bytes(out)  # copycheck: ok - immutable result at the API boundary

    def stat(self, soid: str) -> Tuple[int, Layout]:
        """-> (logical size, layout) (reference rados_striper_stat)."""
        return self._load_meta(soid)

    def truncate(self, soid: str, new_size: int) -> None:
        """Shrink/grow the logical entity (reference
        RadosStriperImpl::trunc): drop whole objects past the end,
        truncate the boundary object, update the size xattr."""
        size, layout = self._load_meta(soid)
        self._check_file_size(new_size)
        if new_size >= size:
            self._store_meta(soid, new_size, layout)
            return
        # objects strictly past the new end
        if new_size == 0:
            last_objectno = -1
        else:
            exts = file_to_extents(soid, layout, 0, new_size)
            last_objectno = max(e.objectno for e in exts)
            # truncate boundary objects to their new local footprint
            per_obj_end: Dict[int, int] = {}
            for e in exts:
                per_obj_end[e.objectno] = max(
                    per_obj_end.get(e.objectno, 0),
                    e.offset + e.length)
        old_exts = file_to_extents(soid, layout, 0, max(size, 1))
        old_last = max(e.objectno for e in old_exts) if old_exts else 0
        for objectno in range(last_objectno + 1, old_last + 1):
            if objectno == 0:
                # keep the metadata object, just empty its data
                self.ioctx.truncate(self._meta_oid(soid), 0)
                continue
            try:
                self.ioctx.remove(object_name(soid, objectno))
            except RadosError:
                pass
        if new_size > 0:
            for objectno, end in per_obj_end.items():
                try:
                    self.ioctx.truncate(object_name(soid, objectno),
                                        end)
                except RadosError:
                    pass
        self._store_meta(soid, new_size, layout)

    def remove(self, soid: str) -> None:
        size, layout = self._load_meta(soid)
        exts = file_to_extents(soid, layout, 0, max(size, 1))
        last = max(e.objectno for e in exts) if exts else 0
        for objectno in range(last + 1):
            try:
                self.ioctx.remove(object_name(soid, objectno))
            except RadosError:
                pass

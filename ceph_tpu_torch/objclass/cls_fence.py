"""cls_fence: epoch-fenced object mutations.

The fencing primitive behind MDS failover (and any other
single-writer-with-takeover protocol): a writer stamps its mutations
with the map epoch it believes it owns; a successor bumps the fence
FIRST, so every in-flight append from the deposed writer is rejected
atomically inside the OSD.  The reference achieves the same with
OSDMap blocklisting before MDS promotion (reference
``src/mds/MDSRank.cc`` rejoin + ``OSDMonitor`` blocklist); fencing at
the journal object keeps the mechanism local to the one object that
needs it and works without touching the OSDMap.

Fence state: xattr ``fence_epoch`` (decimal).  Methods run atomically
with the op under the PG lock, so check+mutate cannot interleave with
another writer's append.
"""
from __future__ import annotations

import json
from typing import Tuple

from . import cls_method

ATTR = "fence_epoch"


def _stored_epoch(ctx) -> int:
    try:
        return int(ctx.getxattr(ATTR).decode())
    except (FileNotFoundError, KeyError, ValueError):
        return 0


@cls_method("fence", "set")
def set_(ctx, indata: bytes) -> Tuple[int, bytes]:
    """Raise the fence to ``epoch`` (monotonic; lowering fails
    -EPERM so a laggy successor can't reopen the door for an even
    older writer)."""
    try:
        epoch = int(json.loads(indata.decode())["epoch"])
    except (ValueError, KeyError):
        return -22, b""
    cur = _stored_epoch(ctx)
    if epoch < cur:
        return -1, b""                   # EPERM: stale fencer
    if not ctx.exists():
        ctx.create()
    ctx.setxattr(ATTR, str(epoch).encode())
    return 0, b""


def _guard(ctx, indata: bytes):
    """Parse {epoch, ...} and check it against the stored fence;
    -> (req, stored_epoch) or (None, errno)."""
    try:
        req = json.loads(indata.decode())
        epoch = int(req["epoch"])
    except (ValueError, KeyError):
        return None, -22
    cur = _stored_epoch(ctx)
    if epoch < cur:
        return None, -1                  # EPERM: fenced-out writer
    return req, cur


def _raise_fence(ctx, req: dict, cur: int) -> None:
    if int(req["epoch"]) > cur:
        ctx.setxattr(ATTR, str(int(req["epoch"])).encode())


@cls_method("fence", "guarded_append")
def guarded_append(ctx, indata: bytes) -> Tuple[int, bytes]:
    """Append ``data`` iff ``epoch`` >= the stored fence; raises the
    fence to ``epoch`` as a side effect so the first append at a new
    epoch immediately fences everything older."""
    req, cur = _guard(ctx, indata)
    if req is None:
        return cur, b""
    try:
        payload = req["data"].encode("utf-8")
    except KeyError:
        return -22, b""
    try:
        size = ctx.stat().size           # O(1); append offset only
    except FileNotFoundError:
        size = 0
    ctx.write(size, payload)
    _raise_fence(ctx, req, cur)
    return 0, b""


@cls_method("fence", "guarded_write_full")
def guarded_write_full(ctx, indata: bytes) -> Tuple[int, bytes]:
    """Replace the object's content iff not fenced out (checkpoint
    watermark writes must obey the same fence as appends, or a zombie
    regresses the successor's applied watermark)."""
    req, cur = _guard(ctx, indata)
    if req is None:
        return cur, b""
    try:
        payload = req["data"].encode("utf-8")
    except KeyError:
        return -22, b""
    ctx.write_full(payload)
    _raise_fence(ctx, req, cur)
    return 0, b""


@cls_method("fence", "guarded_truncate")
def guarded_truncate(ctx, indata: bytes) -> Tuple[int, bytes]:
    """Truncate iff not fenced out (journal trim by a zombie would
    erase the successor's entries)."""
    req, cur = _guard(ctx, indata)
    if req is None:
        return cur, b""
    ctx.truncate(int(req.get("size", 0)))
    _raise_fence(ctx, req, cur)
    return 0, b""

"""cls_version: per-object application version counters.

Python-native equivalent of the reference's version class (reference
``src/cls/version/`` — set/inc/read/check used by RGW metadata
caching).  Version lives as xattr ``objver`` = JSON {"ver": N,
"tag": str}.
"""
from __future__ import annotations

import json
from typing import Tuple

from . import cls_method

ATTR = "objver"


def _load(ctx) -> dict:
    try:
        return json.loads(ctx.getxattr(ATTR).decode())
    except (FileNotFoundError, KeyError, ValueError):
        return {"ver": 0, "tag": ""}


@cls_method("version", "set")
def set_(ctx, indata: bytes) -> Tuple[int, bytes]:
    try:
        req = json.loads(indata.decode())
        ver = int(req["ver"])
    except (ValueError, KeyError):
        return -22, b""
    ctx.setxattr(ATTR, json.dumps(
        {"ver": ver, "tag": req.get("tag", "")}).encode())
    return 0, b""


@cls_method("version", "inc")
def inc(ctx, indata: bytes) -> Tuple[int, bytes]:
    st = _load(ctx)
    st["ver"] += 1
    ctx.setxattr(ATTR, json.dumps(st).encode())
    return 0, json.dumps(st).encode()


@cls_method("version", "read", write=False)
def read(ctx, indata: bytes) -> Tuple[int, bytes]:
    return 0, json.dumps(_load(ctx)).encode()


@cls_method("version", "check", write=False)
def check(ctx, indata: bytes) -> Tuple[int, bytes]:
    """Fail with -ECANCELED unless stored ver matches (reference
    cls_version check_conds)."""
    try:
        want = int(json.loads(indata.decode())["ver"])
    except (ValueError, KeyError):
        return -22, b""
    if _load(ctx)["ver"] != want:
        return -125, b""                 # ECANCELED
    return 0, b""

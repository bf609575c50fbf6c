"""cls_lock: advisory object locks.

Python-native equivalent of the reference's lock class (reference
``src/cls/lock/`` — cls_lock_types LOCK_EXCLUSIVE/LOCK_SHARED,
lock/unlock/break_lock/get_info ops used by RBD exclusive-lock and
RGW).  Lock state is a JSON xattr ``lock.<name>`` on the object:
``{"type": ..., "tag": ..., "lockers": {"owner cookie": {...}}}``.
"""
from __future__ import annotations

import json
from typing import Tuple

from . import cls_method

LOCK_EXCLUSIVE = "exclusive"
LOCK_SHARED = "shared"


def _attr(name: str) -> str:
    return f"lock.{name}"


def _load(ctx, name: str) -> dict:
    try:
        return json.loads(ctx.getxattr(_attr(name)).decode())
    except (FileNotFoundError, KeyError, ValueError):
        return {"type": "", "tag": "", "lockers": {}}


def _locker_key(owner: str, cookie: str) -> str:
    return f"{owner} {cookie}"


@cls_method("lock", "lock")
def lock(ctx, indata: bytes) -> Tuple[int, bytes]:
    """input: {name, type, owner, cookie, tag?, description?}."""
    try:
        req = json.loads(indata.decode())
        name = req["name"]
        ltype = req["type"]
        owner = req["owner"]
        cookie = req.get("cookie", "")
    except (ValueError, KeyError):
        return -22, b""
    if ltype not in (LOCK_EXCLUSIVE, LOCK_SHARED):
        return -22, b""
    st = _load(ctx, name)
    key = _locker_key(owner, cookie)
    if st["lockers"]:
        if key in st["lockers"]:
            # re-lock by the same locker: must not mutate type/tag
            # while others hold it (converting shared->exclusive
            # under co-holders would break the invariant; reference
            # cls_lock returns -EBUSY)
            if len(st["lockers"]) > 1 and \
                    (ltype != st["type"] or
                     req.get("tag", "") != st.get("tag", "")):
                return -16, b""
        elif st["type"] == LOCK_EXCLUSIVE or ltype == LOCK_EXCLUSIVE:
            return -16, b""               # EBUSY
        elif st.get("tag", "") != req.get("tag", ""):
            return -16, b""               # shared locks must share tag
    st["type"] = ltype
    st["tag"] = req.get("tag", "")
    st["lockers"][key] = {"owner": owner, "cookie": cookie,
                          "description": req.get("description", "")}
    ctx.setxattr(_attr(name), json.dumps(st).encode())
    return 0, b""


@cls_method("lock", "unlock")
def unlock(ctx, indata: bytes) -> Tuple[int, bytes]:
    try:
        req = json.loads(indata.decode())
        name, owner = req["name"], req["owner"]
        cookie = req.get("cookie", "")
    except (ValueError, KeyError):
        return -22, b""
    st = _load(ctx, name)
    key = _locker_key(owner, cookie)
    if key not in st["lockers"]:
        return -2, b""                    # ENOENT
    del st["lockers"][key]
    ctx.setxattr(_attr(name), json.dumps(st).encode())
    return 0, b""


@cls_method("lock", "break_lock")
def break_lock(ctx, indata: bytes) -> Tuple[int, bytes]:
    """Forcibly evict another locker (reference break_lock: operator
    recovery for dead clients)."""
    try:
        req = json.loads(indata.decode())
        name = req["name"]
        key = _locker_key(req["locker_owner"],
                          req.get("locker_cookie", ""))
    except (ValueError, KeyError):
        return -22, b""
    st = _load(ctx, name)
    if key not in st["lockers"]:
        return -2, b""
    del st["lockers"][key]
    ctx.setxattr(_attr(name), json.dumps(st).encode())
    return 0, b""


@cls_method("lock", "get_info", write=False)
def get_info(ctx, indata: bytes) -> Tuple[int, bytes]:
    try:
        name = json.loads(indata.decode())["name"]
    except (ValueError, KeyError):
        return -22, b""
    return 0, json.dumps(_load(ctx, name)).encode()

"""Leveled, per-subsystem structured logging.

Python-native equivalent of the reference's dout machinery (reference
src/common/dout.h:122-176 — ``dout(level)`` macros gated on a
per-subsystem debug level; subsystem table src/common/subsys.h; async
writer src/log/Log.cc).  We build on the stdlib ``logging`` module — one
logger per subsystem under the ``ceph_tpu_torch`` root — and keep the
reference's two key behaviors: cheap early-out on level checks and
per-subsystem runtime-adjustable verbosity.

Usage:
    log = Dout("osd")
    log.dout(10, "pg %s: queueing op", pgid)     # debug-level gated
    log.derr("failed to mount store: %s", err)   # always emitted
"""
from __future__ import annotations

import logging
import sys
import threading
from typing import Dict

# the reference's subsystem table, trimmed to what exists here
# (reference common/subsys.h)
SUBSYSTEMS = (
    "ec", "osd", "mon", "msg", "crush", "store", "client", "tools",
    "tpu", "paxos", "heartbeat", "recovery", "scrub",
    "mds", "mgr", "rgw", "rbd", "fs", "objclass",
)

_levels: Dict[str, int] = {}
_levels_lock = threading.Lock()
_configured = False


def _ensure_root() -> None:
    global _configured
    if _configured:
        return
    root = logging.getLogger("ceph_tpu_torch")
    if not root.handlers:
        fmt = logging.Formatter(
            "%(asctime)s.%(msecs)03d %(name)s %(levelname).1s %(message)s",
            datefmt="%H:%M:%S")
        # reference log_file / log_to_stderr: a configured file sink
        # replaces stderr unless stderr is also requested; with
        # neither set, stderr remains the fallback sink
        log_file = ""
        to_stderr = False
        try:
            from .config import default_config
            conf = default_config()
            log_file = conf["log_file"]
            to_stderr = conf["log_to_stderr"]
        except Exception:
            pass
        if log_file:
            try:
                fh = logging.FileHandler(log_file)
                fh.setFormatter(fmt)
                root.addHandler(fh)
            except OSError:
                to_stderr = True         # unwritable path: fall back
        if to_stderr or not log_file:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(fmt)
            root.addHandler(handler)
        root.setLevel(logging.DEBUG)
        root.propagate = False
    _configured = True


def set_subsys_level(subsys: str, level: int) -> None:
    """Runtime verbosity, 0..30 like the reference's debug_<subsys>."""
    with _levels_lock:
        _levels[subsys] = level


def get_subsys_level(subsys: str) -> int:
    with _levels_lock:
        if subsys in _levels:
            return _levels[subsys]
    try:
        from .config import default_config
        conf = default_config()
        # per-subsystem debug_<subsys> option wins when set (>= 0);
        # -1 inherits the default level (reference debug_<subsys>
        # options over common/subsys.h defaults)
        try:
            per = int(conf.get(f"debug_{subsys}"))
            if per >= 0:
                return per
        except KeyError:
            pass
        return int(conf.get("debug_default_level"))
    except Exception:
        return 1


class Dout:
    """Per-subsystem leveled logger (reference dout.h dout/derr)."""

    def __init__(self, subsys: str, prefix: str = ""):
        _ensure_root()
        self.subsys = subsys
        self.prefix = prefix
        self._logger = logging.getLogger(f"ceph_tpu_torch.{subsys}")

    def should(self, level: int) -> bool:
        return level <= get_subsys_level(self.subsys)

    def dout(self, level: int, msg: str, *args) -> None:
        if self.should(level):
            self._logger.debug(self.prefix + msg, *args)

    def dinfo(self, msg: str, *args) -> None:
        self._logger.info(self.prefix + msg, *args)

    def dwarn(self, msg: str, *args) -> None:
        self._logger.warning(self.prefix + msg, *args)

    def derr(self, msg: str, *args) -> None:
        # reference derr writes at level -1 (always)
        self._logger.error(self.prefix + msg, *args)

    def child(self, prefix: str) -> "Dout":
        return Dout(self.subsys, self.prefix + prefix)

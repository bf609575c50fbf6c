"""Shared plumbing for the CLI tools.

Reference analog: ``src/ceph.in`` and ``src/pybind/ceph_argparse.py``
resolve the monitor address from ``-m``/ceph.conf, open a client handle
and ship JSON command dicts to the monitor.  Here every tool accepts
``-m/--mon host:port`` (default from ``$CEPH_TPU_MON``) and talks the
framework's real wire protocol over loopback/DCN, so the same binary
works against an in-process test cluster or a standalone ``vstart``
cluster in another process.
"""
from __future__ import annotations

import json
import os
import sys
from typing import Optional, Tuple

from ..client.rados import Rados


def parse_mon_addr(spec: Optional[str]) -> Tuple[str, int]:
    spec = spec or os.environ.get("CEPH_TPU_MON", "")
    if not spec:
        raise SystemExit(
            "no monitor address: pass -m host:port or set $CEPH_TPU_MON")
    host, _, port = spec.rpartition(":")
    if not host:
        raise SystemExit(f"bad monitor address {spec!r} (want host:port)")
    return host, int(port)


def connect(mon: Optional[str], timeout: float = 10.0) -> Rados:
    return Rados(parse_mon_addr(mon)).connect(timeout)


def print_out(rs: str, out: dict, as_json: bool, file=None) -> None:
    """Command output: human string + structured payload (reference
    ``ceph`` prints outs to stderr and outbl to stdout).  A closed
    pipe (``| head``) ends output quietly instead of tracebacking."""
    file = file or sys.stdout
    try:
        if as_json or (out and not rs):
            if out:
                json.dump(out, file, indent=2, sort_keys=True,
                          default=str)
                file.write("\n")
            if rs:
                print(rs, file=sys.stderr)
        else:
            if rs:
                print(rs, file=file)
            if out:
                json.dump(out, file, indent=2, sort_keys=True,
                          default=str)
                file.write("\n")
    except BrokenPipeError:
        try:
            devnull = os.open(os.devnull, os.O_WRONLY)
            os.dup2(devnull, file.fileno())
        except OSError:
            pass

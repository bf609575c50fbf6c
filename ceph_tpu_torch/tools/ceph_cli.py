"""``ceph`` — the cluster admin CLI.

Reference analog: ``src/ceph.in`` + ``src/pybind/ceph_argparse.py``:
free-form argv is matched against the monitor's command table
(``src/mon/MonCommands.h``) and shipped as a JSON dict
(``{"prefix": ..., args...}``) over MonClient; the monitor replies with
(retcode, outs, outbl).  This implementation mirrors the subset of
``MonCommands.h`` the framework's monitor serves (profile management at
``mon/OSDMonitor.cc:10829``, pool create at ``:7216``, osd out/in/down,
status/health/pg-dump) plus daemon-local ``ceph daemon <sock> <cmd>``
(reference admin socket, ``src/common/admin_socket.cc``).

Usage examples (same shapes as the reference):
    ceph -m HOST:PORT status
    ceph osd erasure-code-profile set gpuprof plugin=gpu k=8 m=4
    ceph osd pool create ecpool 8 erasure gpuprof
    ceph osd pool create rpool 8 replicated --size 3
    ceph osd out 2
    ceph pg dump --format json
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Tuple

from .common import connect, print_out

POOL_TYPES = ("replicated", "erasure")


def _build_command(words: List[str], ns: argparse.Namespace
                   ) -> Tuple[dict, List[str]]:
    """argv words -> monitor command dict (reference
    ceph_argparse.validate_command against MonCommands.h)."""
    w = words

    def is_(*prefix: str) -> bool:
        return w[:len(prefix)] == list(prefix)

    def arg(i: int, usage: str) -> str:
        if len(w) <= i:
            raise SystemExit(f"usage: {usage}")
        return w[i]

    if is_("osd", "erasure-code-profile", "set"):
        name = arg(3, "osd erasure-code-profile set <name> [k=v ...] "
                   "[--force]")
        return ({"prefix": "osd erasure-code-profile set", "name": name,
                 "profile": w[4:], "force": ns.force}, [])
    if is_("osd", "erasure-code-profile", "get"):
        return ({"prefix": "osd erasure-code-profile get",
                 "name": arg(3, "osd erasure-code-profile get <name>")}, [])
    if is_("osd", "erasure-code-profile", "ls"):
        return ({"prefix": "osd erasure-code-profile ls"}, [])
    if is_("osd", "erasure-code-profile", "rm"):
        return ({"prefix": "osd erasure-code-profile rm",
                 "name": arg(3, "osd erasure-code-profile rm <name>")}, [])

    if is_("osd", "pool", "create"):
        # osd pool create <pool> [pg_num] [replicated|erasure [profile]]
        if len(w) < 4:
            raise SystemExit("usage: osd pool create <pool> [pg_num] "
                             "[replicated|erasure [profile]]")
        cmd = {"prefix": "osd pool create", "pool": w[3]}
        rest = w[4:]
        if rest and rest[0].isdigit():
            cmd["pg_num"] = int(rest.pop(0))
        if rest and rest[0] in POOL_TYPES:
            cmd["pool_type"] = rest.pop(0)
            if cmd["pool_type"] == "erasure" and rest:
                cmd["erasure_code_profile"] = rest.pop(0)
        if ns.size is not None:
            cmd["size"] = ns.size
        return cmd, rest
    if is_("osd", "pool", "set"):
        if len(w) < 6:
            raise SystemExit("usage: osd pool set <pool> <var> <val>")
        return ({"prefix": "osd pool set", "pool": w[3], "var": w[4],
                 "val": w[5]}, w[6:])
    if is_("osd", "pool", "delete") or is_("osd", "pool", "rm"):
        return ({"prefix": "osd pool delete",
                 "pool": arg(3, "osd pool delete <pool>")}, w[4:])
    if is_("osd", "pool", "ls"):
        return ({"prefix": "osd pool ls"}, w[3:])

    for verb in ("out", "in", "down"):
        if is_("osd", verb):
            ids = [int(x) for x in w[2:]]
            if not ids:
                raise SystemExit(f"usage: osd {verb} <id> [<id>...]")
            return ({"prefix": f"osd {verb}", "ids": ids}, [])
    if is_("osd", "dump"):
        return ({"prefix": "osd dump"}, w[2:])
    if is_("osd", "tree"):
        return ({"prefix": "osd tree"}, w[2:])

    if is_("fs", "set"):
        return ({"prefix": "fs set",
                 "var": arg(2, "fs set <var> <val>"),
                 "val": arg(3, "fs set <var> <val>")}, w[4:])
    if is_("fs", "pin"):
        return ({"prefix": "fs pin",
                 "path": arg(2, "fs pin <path> <rank>"),
                 "rank": arg(3, "fs pin <path> <rank>")}, w[4:])
    if is_("mds", "getmap") or is_("fs", "status"):
        return ({"prefix": "mds getmap"}, w[2:])

    if is_("status") or is_("-s"):
        return ({"prefix": "status"}, w[1:])
    if is_("health"):
        return ({"prefix": "health"}, w[1:])
    if is_("pg", "stat"):
        return ({"prefix": "pg stat"}, w[2:])
    if is_("pg", "dump"):
        return ({"prefix": "pg dump"}, w[2:])
    if is_("pg", "scrub") or is_("pg", "deep-scrub") or is_("pg", "repair"):
        return ({"prefix": f"pg {w[1]}",
                 "pgid": arg(2, f"pg {w[1]} <pgid>")}, w[3:])

    if is_("tell"):
        # handled out-of-band: direct daemon command, not a mon command
        target = arg(1, "tell osd.<id> <command...>")
        rest = w[2:]
        if not rest:
            raise SystemExit("usage: tell osd.<id> <command...>")
        if rest[:2] == ["config", "get"]:
            if len(rest) < 3:
                raise SystemExit("usage: tell <osd> config get <name>")
            return ({"_tell": target, "prefix": "config get",
                     "name": rest[2]}, [])
        if rest[:2] == ["config", "set"]:
            if len(rest) < 4:
                raise SystemExit("usage: tell <osd> config set "
                                 "<name> <value>")
            return ({"_tell": target, "prefix": "config set",
                     "name": rest[2], "value": rest[3]}, [])
        return ({"_tell": target, "prefix": " ".join(rest)}, [])

    if is_("auth", "get-or-create"):
        return ({"prefix": "auth get-or-create",
                 "entity": arg(2, "auth get-or-create <entity> "
                               "[<svc> <caps> ...]"),
                 "caps": w[3:]}, [])
    if is_("auth", "get"):
        return ({"prefix": "auth get",
                 "entity": arg(2, "auth get <entity>")}, [])
    if is_("auth", "ls"):
        return ({"prefix": "auth ls"}, w[2:])
    if is_("auth", "rm") or is_("auth", "del"):
        return ({"prefix": "auth rm",
                 "entity": arg(2, "auth rm <entity>")}, [])
    if is_("auth", "print-key"):
        return ({"prefix": "auth print-key",
                 "entity": arg(2, "auth print-key <entity>")}, [])

    if is_("config", "set"):
        arg(3, "config set <name> <value>")
        return ({"prefix": "config set", "name": w[2], "value": w[3]}, w[4:])
    if is_("config", "get"):
        return ({"prefix": "config get",
                 "name": arg(2, "config get <name>")}, w[3:])

    raise SystemExit(f"unknown command: {' '.join(w)!r}")


def _split_argv(argv: List[str]) -> Tuple[List[str], List[str]]:
    """Pull our own options out of argv wherever they appear, leaving
    the command words (argparse.REMAINDER would swallow options placed
    after the first word, breaking 'ceph pg dump --format json')."""
    takes_value = {"-m", "--mon", "--format", "--size", "--timeout"}
    flags = {"--force"}
    opts: List[str] = []
    words: List[str] = []
    i = 0
    while i < len(argv):
        tok = argv[i]
        key, _, inline = tok.partition("=")
        if key in takes_value:
            opts.append(tok)
            if not inline and i + 1 < len(argv):
                i += 1
                opts.append(argv[i])
        elif key in flags:
            opts.append(tok)
        elif tok == "-s" and not words:
            words.append("status")
        else:
            words.append(tok)
        i += 1
    return opts, words


def _tell(cluster, target: str, cmd: dict, timeout: float
          ) -> Tuple[int, str, dict]:
    """Direct daemon command (reference 'ceph tell osd.N ...' over
    MCommand): resolve the daemon's address from the osdmap, dial it,
    await the reply."""
    import threading

    from ..msg.messages import MCommand, MCommandReply
    from ..msg.messenger import Dispatcher

    if not target.startswith("osd."):
        raise SystemExit(f"tell target {target!r} not supported "
                         f"(osd.<id> only)")
    try:
        osd = int(target.split(".", 1)[1])
    except ValueError:
        raise SystemExit(f"bad tell target {target!r} "
                         f"(want osd.<id>)")
    ret, rs, out = cluster.mon_command({"prefix": "osd dump"}, timeout)
    if ret != 0:
        return ret, rs, out
    info = next((o for o in out.get("osds", []) if o["osd"] == osd),
                None)
    if info is None or not info.get("up") or not info.get("addr"):
        return -2, f"osd.{osd} is not up", {}

    got = threading.Event()
    reply = {}

    class _Collector(Dispatcher):
        def ms_dispatch(self, conn, msg) -> bool:
            if isinstance(msg, MCommandReply):
                reply["msg"] = msg
                got.set()
                return True
            return False

    cluster.msgr.add_dispatcher(_Collector())
    # lossy, like every client->daemon dial: a lossless session would
    # leave the OSD waiting forever for this short-lived CLI process
    # to reconnect
    conn = cluster.msgr.connect_to(tuple(info["addr"]),
                                   lossless=False,
                                   peer_name=f"osd.{osd}")
    conn.send_message(MCommand(tid=1, cmd=cmd))
    if not got.wait(timeout):
        return -110, f"osd.{osd} did not answer", {}
    m = reply["msg"]
    return m.retcode, m.rs, m.out


def main(argv: List[str] = None) -> int:
    p = argparse.ArgumentParser(
        prog="ceph", description=__doc__.splitlines()[0])
    p.add_argument("-m", "--mon", help="monitor host:port "
                   "(default $CEPH_TPU_MON)")
    p.add_argument("--format", choices=("plain", "json"), default="plain")
    p.add_argument("--force", action="store_true")
    p.add_argument("--size", type=int, help="replica count for pool create")
    p.add_argument("--timeout", type=float, default=30.0)
    if argv is None:
        argv = sys.argv[1:]
    opts, words = _split_argv(list(argv))
    ns = p.parse_args(opts)
    ns.words = words
    if not ns.words:
        p.error("no command")
    cmd, leftover = _build_command(ns.words, ns)
    if leftover:
        raise SystemExit(f"trailing arguments: {leftover}")

    with connect(ns.mon) as cluster:
        if "_tell" in cmd:
            retcode, rs, out = _tell(cluster, cmd.pop("_tell"), cmd,
                                     ns.timeout)
        else:
            retcode, rs, out = cluster.mon_command(cmd, ns.timeout)
    print_out(rs, out, ns.format == "json")
    if retcode < 0:
        print(f"Error: {rs} ({retcode})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Thrash harness: random faults under a model-checked workload.

Python-native equivalent of the reference's chaos engine (reference
``qa/tasks/thrashosds.py`` + ``ceph_manager.py`` kill_osd:2748 /
revive_osd:2790, driving the model-checking random-op client
``ceph_test_rados`` — ``src/test/osd/RadosModel.h`` / ``TestRados.cc``,
SURVEY §4 tier 2: "the workhorse of thrash testing").

Two pieces:

* **RadosModel**: issues random ops (write/append/truncate/delete/
  xattr) against a pool while tracking the EXPECTED state of every
  object; ``verify_all`` reads everything back and compares
  byte-for-byte.  Any acknowledged-write loss, stale read, or
  resurrection after delete is caught.
* **Thrasher**: a background loop randomly killing/reviving OSDs and
  marking them out/in mid-workload, always leaving ``min_alive``
  OSDs up; ``settle`` revives everyone and waits for clean.

A third piece rides the fault-injection registry (utils/faults.py):
``--faults SPEC`` arms named injection points — device dispatch
errors, socket failures, store stalls — for the whole seeded run, and
``--chaos`` expands to a canned multi-site schedule.  The integrity
bar is unchanged: ``verify_all`` must come back empty, i.e. zero
client-visible errors despite the injected faults.

CLI::

    python -m ceph_tpu_torch.tools.thrash --osds 4 --seconds 20 \\
        --pool-type erasure --seed 7 --chaos
"""
from __future__ import annotations

import argparse
import random
import sys
import threading
import time
from typing import Dict, List, Optional

from ..client.rados import RadosError
from ..utils import faults as faultlib

# the --chaos preset: device dispatch faults force the encode retry/
# breaker path, socket failures force messenger reconnect/resend,
# store stalls simulate a slow disk — all in one seeded run
CHAOS_FAULTS = ("device.dispatch:error:1in20"
                ",msg.send:error:1in300"
                ",store.apply:stall:1in50:30")


class RadosModel:
    """Random ops + expected-state tracking (reference RadosModel.h)."""

    OPS = ("write", "append", "writefull", "truncate", "delete",
           "setxattr", "read", "copy_from")
    # EC pools without ec_overwrites reject overwrites/truncate
    # (EOPNOTSUPP, like the reference) — restrict to the append-only
    # vocabulary there (reference thrash-erasure-code workloads
    # likewise use append-style ops)
    EC_OPS = ("append", "writefull", "delete", "setxattr", "read",
              "copy_from")
    # snapshot vocabulary (reference qa/.../thrash-erasure-code
    # workloads/ec-rados-plugin=*.yaml: snap_create/snap_remove/
    # rollback in the op mix); valid on both pool types
    SNAP_OPS = ("snap_create", "snap_remove", "rollback", "snap_read")
    MAX_LIVE_SNAPS = 3

    def __init__(self, ioctx, n_objects: int = 20,
                 seed: int = 0, max_size: int = 1 << 16,
                 ec_mode: bool = False, snaps: bool = False):
        self.ioctx = ioctx
        if ec_mode:
            self.OPS = self.EC_OPS
        if snaps:
            self.OPS = self.OPS + self.SNAP_OPS
        self.rng = random.Random(seed)
        self.names = [f"model_{i}" for i in range(n_objects)]
        self.expect: Dict[str, bytearray] = {}
        self.expect_attrs: Dict[str, Dict[str, bytes]] = {}
        # live snapid -> frozen expected state at snap time
        self.snaps: Dict[int, Dict] = {}
        self.snap_seq = 0
        self.max_size = max_size
        self.ops_done = 0
        self.errors: List[str] = []

    def _set_snapc(self) -> None:
        live = sorted(self.snaps, reverse=True)
        self.ioctx.set_snap_context(self.snap_seq, live)

    def _blob(self, n: int) -> bytes:
        return self.rng.randbytes(n)

    def step(self) -> None:
        """One random op, model updated only on acknowledged success
        (an op that raises must not change expectations — the client
        resend machinery makes acks exactly-once)."""
        oid = self.rng.choice(self.names)
        op = self.rng.choice(self.OPS)
        cur = self.expect.get(oid)
        self.ops_done += 1           # attempts (no-op picks count too)
        try:
            if op == "write":
                off = self.rng.randrange(0, self.max_size // 2)
                data = self._blob(self.rng.randrange(1, 4096))
                self.ioctx.write(oid, data, off)
                base = cur if cur is not None else bytearray()
                if off + len(data) > len(base):
                    base.extend(b"\0" * (off + len(data) - len(base)))
                base[off:off + len(data)] = data
                self.expect[oid] = base
            elif op == "append":
                data = self._blob(self.rng.randrange(1, 4096))
                self.ioctx.append(oid, data)
                base = cur if cur is not None else bytearray()
                base.extend(data)
                self.expect[oid] = base
            elif op == "writefull":
                data = self._blob(self.rng.randrange(1, 8192))
                self.ioctx.write_full(oid, data)
                self.expect[oid] = bytearray(data)
            elif op == "truncate":
                if cur is None:
                    return
                size = self.rng.randrange(0, len(cur) + 1)
                self.ioctx.truncate(oid, size)
                base = cur[:size]
                self.expect[oid] = base
            elif op == "delete":
                if cur is None:
                    return
                self.ioctx.remove(oid)
                self.expect.pop(oid, None)
                self.expect_attrs.pop(oid, None)
            elif op == "copy_from":
                # server-side copy (reference ec-rados workloads run
                # copy_from in their 4000-op mixes)
                src = self.rng.choice(self.names)
                if self.expect.get(src) is None:
                    return
                self.ioctx.copy_from(oid, src)
                self.expect[oid] = bytearray(self.expect[src])
                self.expect_attrs[oid] = dict(
                    self.expect_attrs.get(src, {}))
            elif op == "setxattr":
                if cur is None:
                    return
                name = f"user.k{self.rng.randrange(4)}"
                val = self._blob(16)
                self.ioctx.setxattr(oid, name, val)
                self.expect_attrs.setdefault(oid, {})[name] = val
            elif op == "read":
                got = None
                try:
                    got = self.ioctx.read(oid)
                except RadosError as e:
                    if e.errno != 2:
                        raise
                want = bytes(cur) if cur is not None else None
                if cur is None and got not in (None, b""):
                    self.errors.append(
                        f"{oid}: read returned data after delete")
                elif cur is not None and got != want:
                    self.errors.append(
                        f"{oid}: stale read ({len(got or b'')}B != "
                        f"{len(want)}B expected)")
            elif op == "snap_create":
                if len(self.snaps) >= self.MAX_LIVE_SNAPS:
                    return
                sid = self.ioctx.selfmanaged_snap_create()
                self.snap_seq = max(self.snap_seq, sid)
                # freeze the expected state as of this snapshot
                self.snaps[sid] = {
                    "data": {o: bytes(v)
                             for o, v in self.expect.items()},
                    "attrs": {o: dict(a) for o, a in
                              self.expect_attrs.items()},
                }
                self._set_snapc()
            elif op == "snap_remove":
                if not self.snaps:
                    return
                sid = self.rng.choice(sorted(self.snaps))
                self.ioctx.selfmanaged_snap_remove(sid)
                del self.snaps[sid]
                self._set_snapc()
            elif op == "rollback":
                if not self.snaps or cur is None and not any(
                        oid in s["data"] for s in self.snaps.values()):
                    return
                sid = self.rng.choice(sorted(self.snaps))
                self.ioctx.selfmanaged_snap_rollback(oid, sid)
                frozen = self.snaps[sid]
                if oid in frozen["data"]:
                    self.expect[oid] = bytearray(frozen["data"][oid])
                    self.expect_attrs[oid] = dict(
                        frozen["attrs"].get(oid, {}))
                else:
                    # object did not exist at the snap: rollback = gone
                    self.expect.pop(oid, None)
                    self.expect_attrs.pop(oid, None)
            elif op == "snap_read":
                if not self.snaps:
                    return
                sid = self.rng.choice(sorted(self.snaps))
                frozen = self.snaps[sid]["data"].get(oid)
                got = None
                self.ioctx.snap_set_read(sid)
                try:
                    got = self.ioctx.read(oid)
                except RadosError as e:
                    if e.errno != 2:
                        raise
                finally:
                    self.ioctx.snap_set_read(0)
                if frozen is None:
                    if got not in (None, b""):
                        self.errors.append(
                            f"{oid}@{sid}: data at a snap before "
                            f"creation")
                elif got != frozen:
                    self.errors.append(
                        f"{oid}@{sid}: snap read mismatch "
                        f"({len(got or b'')}B != {len(frozen)}B)")
        except RadosError:
            # deliberate FAIL-FAST: the framework's resend machinery
            # is supposed to absorb churn, so an op error (or timeout)
            # surfacing here IS a finding, exactly like
            # ceph_test_rados treating op failure as fatal.  (The
            # model keeps the prior expectation; whether the failed op
            # partially applied would surface in verify_all if a
            # caller chose to continue.)
            raise

    def run(self, n_ops: int) -> None:
        for _ in range(n_ops):
            self.step()

    def verify_all(self) -> List[str]:
        """Read every object back; -> list of mismatch descriptions
        (reference RadosModel verification at op completion)."""
        problems = list(self.errors)
        for oid in self.names:
            want = self.expect.get(oid)
            try:
                got = self.ioctx.read(oid)
            except RadosError as e:
                got = None if e.errno == 2 else b"<error>"
            if want is None:
                if got not in (None, b""):
                    problems.append(f"{oid}: exists after delete")
            elif got != bytes(want):
                problems.append(
                    f"{oid}: content mismatch "
                    f"({len(got) if got else 0} != {len(want)})")
            for name, val in self.expect_attrs.get(oid, {}).items():
                if want is None:
                    continue
                try:
                    if self.ioctx.getxattr(oid, name) != val:
                        problems.append(f"{oid}: xattr {name} differs")
                except RadosError:
                    problems.append(f"{oid}: xattr {name} missing")
        # every live snapshot must still read back its frozen state
        for sid, frozen in self.snaps.items():
            self.ioctx.snap_set_read(sid)
            try:
                for oid in self.names:
                    want = frozen["data"].get(oid)
                    try:
                        got = self.ioctx.read(oid)
                    except RadosError as e:
                        got = None if e.errno == 2 else b"<error>"
                    if want is None:
                        if got not in (None, b""):
                            problems.append(
                                f"{oid}@{sid}: exists at a snap "
                                f"before creation")
                    elif got != want:
                        problems.append(
                            f"{oid}@{sid}: snap content mismatch "
                            f"({len(got) if got else 0} != "
                            f"{len(want)})")
            finally:
                self.ioctx.snap_set_read(0)
        return problems


class Thrasher:
    """Random OSD kill/revive/out/in loop (reference thrashosds.py)."""

    def __init__(self, cluster, seed: int = 0, min_alive: int = 2,
                 interval: float = 4.5, lose_data_prob: float = 0.3,
                 pggrow_pool: Optional[str] = None,
                 pggrow_max: int = 32):
        self.cluster = cluster
        self.rng = random.Random(seed)
        self.min_alive = min_alive
        self.interval = interval
        self.lose_data_prob = lose_data_prob
        # pggrow (reference thrashosds.py pggrow/morepggrow): grow the
        # pool's pg_num mid-workload, forcing live PG splits
        self.pggrow_pool = pggrow_pool
        self.pggrow_max = pggrow_max
        self.down: List[int] = []
        self.actions: List[str] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _alive(self) -> List[int]:
        return [i for i, osd in self.cluster.osds.items()
                if osd is not None]

    def _act(self) -> None:
        alive = self._alive()
        if self.pggrow_pool and self.rng.random() < 0.25:
            pool = self.cluster.osds[alive[0]].osdmap.get_pool(
                self.cluster.osds[alive[0]].osdmap.pool_name_to_id[
                    self.pggrow_pool]) if alive else None
            if pool is not None:
                # grow (live PG split) or shrink (live PG merge —
                # reference thrashosds pggrow/pgnum shrink support;
                # EC merges are rejected by the monitor, so shrink
                # only replicated pools)
                if pool.pg_num > 2 and not pool.is_erasure() \
                        and self.rng.random() < 0.4:
                    new = max(2, pool.pg_num
                              - self.rng.choice((1, 2, 4)))
                    verb = "pgshrink"
                elif pool.pg_num < self.pggrow_max:
                    new = min(self.pggrow_max,
                              pool.pg_num + self.rng.choice((1, 2, 4)))
                    verb = "pggrow"
                else:
                    return
                ret, _, _ = self.cluster.mon_command(
                    {"prefix": "osd pool set",
                     "pool": self.pggrow_pool, "var": "pg_num",
                     "val": str(new)})
                if ret == 0:
                    self.actions.append(f"{verb} {self.pggrow_pool} "
                                        f"-> {new}")
                return
        # option thrash (reference thrashosds injecting config
        # changes): flip runtime-tunable options through the central
        # config; daemons apply them off the next map, exercising the
        # observer/override machinery under load
        if self.rng.random() < 0.15:
            name, val = self.rng.choice((
                ("osd_recovery_max_active", self.rng.choice(
                    ("1", "3", "8"))),
                ("osd_recovery_sleep", self.rng.choice(
                    ("0", "0.01"))),
                ("ec_tpu_batch_stripes", self.rng.choice(
                    ("256", "1024", "4096"))),
                ("osd_min_pg_log_entries", self.rng.choice(
                    ("100", "1500"))),
                ("osd_heartbeat_grace", self.rng.choice(
                    ("4.0", "6.0"))),
            ))
            if self.rng.random() < 0.3:
                ret, _, _ = self.cluster.mon_command(
                    {"prefix": "config rm", "name": name})
                if ret == 0:
                    self.actions.append(f"config rm {name}")
            else:
                ret, _, _ = self.cluster.mon_command(
                    {"prefix": "config set", "name": name,
                     "value": val})
                if ret == 0:
                    self.actions.append(f"config set {name}={val}")
            return
        # revive when at the floor or by coin flip
        if self.down and (len(alive) <= self.min_alive
                          or self.rng.random() < 0.5):
            osd = self.down.pop(self.rng.randrange(len(self.down)))
            self.cluster.revive_osd(osd)
            self.actions.append(f"revive osd.{osd}")
            return
        # occasionally exercise the mark-out/in remap path (the
        # reference thrasher's out/in actions): CRUSH reweights and
        # data moves without any daemon dying
        if self.rng.random() < 0.25 and len(alive) > self.min_alive:
            osd = self.rng.choice(alive)
            verb = self.rng.choice(("out", "in"))
            ret, _, _ = self.cluster.mon_command(
                {"prefix": f"osd {verb}", "ids": [osd]})
            if ret == 0:
                self.actions.append(f"mark osd.{osd} {verb}")
            return
        if len(alive) > self.min_alive:
            osd = self.rng.choice(alive)
            lose = self.rng.random() < self.lose_data_prob
            self.cluster.kill_osd(osd, lose_data=lose)
            self.down.append(osd)
            self.actions.append(
                f"kill osd.{osd}{' (lose data)' if lose else ''}")

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self._act()
            except Exception as e:       # noqa: BLE001
                self.actions.append(f"error: {e!r}")

    def start(self) -> "Thrasher":
        self._thread = threading.Thread(target=self._loop,
                                        name="thrasher", daemon=True)
        self._thread.start()
        return self

    def stop_and_settle(self, timeout: float = 120.0) -> float:
        """Stop thrashing, revive everyone, wait for clean; -> seconds
        to clean (the rebuild-time metric)."""
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=10)
        for osd in list(self.down):
            self.cluster.revive_osd(osd)
            self.actions.append(f"final revive osd.{osd}")
        self.down.clear()
        # undo any mark-outs so the final state is whole
        self.cluster.mon_command(
            {"prefix": "osd in",
             "ids": sorted(self.cluster.osds)})
        return self.cluster.wait_for_clean(timeout)


def run_thrash(n_osds: int, seconds: float, pool_type: str,
               seed: int, out=sys.stdout, pggrow: bool = False,
               tiered: bool = False, faults: str = "") -> int:
    from ..cluster import Cluster, test_config
    conf = None
    if faults:
        # one registry for the whole in-process cluster: reset any
        # stale schedule, then let Cluster.start's configure_from arm
        # this run's — deterministically, off the same --seed as the
        # workload and the thrasher
        faultlib.registry().reset()
        conf = test_config(fault_injection=faults,
                           fault_injection_seed=seed)
    with Cluster(n_osds=n_osds, conf=conf) as cluster:
        for i in range(n_osds):
            cluster.wait_for_osd_up(i, 30)
        if pool_type == "erasure":
            cluster.create_ec_profile("thrash", plugin="jerasure",
                                      k="2", m="1")
            cluster.create_pool("tp", "erasure",
                                erasure_code_profile="thrash")
        else:
            cluster.create_pool("tp", "replicated",
                                size=min(3, n_osds))
        if tiered:
            # writeback cache tier over the workload pool with tight
            # targets: the model runs against constant promote/flush/
            # evict churn (reference thrash-erasure-code + cache
            # tiering suites)
            cluster.create_pool("tp-cache", "replicated",
                                size=min(3, n_osds))
            for prefix, extra in (
                    ("osd tier add",
                     {"pool": "tp", "tierpool": "tp-cache"}),
                    ("osd tier cache-mode",
                     {"tierpool": "tp-cache", "mode": "writeback"}),
                    ("osd tier set-overlay",
                     {"pool": "tp", "tierpool": "tp-cache"})):
                ret, msg, _ = cluster.mon_command(
                    dict({"prefix": prefix}, **extra))
                assert ret == 0, f"{prefix}: {msg}"
            for var, val in (("target_max_objects", "8"),
                             ("cache_target_dirty_ratio", "0.2")):
                cluster.mon_command(
                    {"prefix": "osd pool set", "pool": "tp-cache",
                     "var": var, "val": val})
        # ops on degraded objects legitimately wait for recovery that
        # relentless churn keeps restarting — the reference's thrash
        # runs don't bound op latency at all; integrity (verify_all)
        # is the assertion, so give ops a long leash
        client = cluster.rados(timeout=30)
        client.op_timeout = 120.0
        io = client.open_ioctx("tp")
        model = RadosModel(io, seed=seed,
                           ec_mode=pool_type == "erasure",
                           snaps=not tiered)
        thrasher = Thrasher(cluster, seed=seed,
                            min_alive=max(2, n_osds - 1
                                          if pool_type == "erasure"
                                          else 2),
                            pggrow_pool="tp" if pggrow
                            else None).start()
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            model.step()
        # the fault window closes WITH the workload: settle polls and
        # verify_all read through fresh client sessions, and faults
        # were transient by contract — counters survive disarming, so
        # the schedule's evidence still prints below
        if faults:
            for site in faultlib.registry().armed_sites():
                faultlib.registry().disarm(site)
        took = thrasher.stop_and_settle()
        problems = model.verify_all()
        print(f"ops={model.ops_done} actions={len(thrasher.actions)} "
              f"clean_in={took:.1f}s problems={len(problems)}",
              file=out)
        for a in thrasher.actions:
            print(f"  {a}", file=out)
        if faults:
            for site, c in sorted(faultlib.registry()
                                  .counters().items()):
                print(f"  fault {site}: trips={c['trips']} "
                      f"hits={c['hits']}", file=out)
            faultlib.registry().reset()
        for p in problems:
            print(f"  PROBLEM: {p}", file=out)
        return 1 if problems else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="thrash",
                                description=__doc__.splitlines()[0])
    p.add_argument("--osds", type=int, default=4)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--pool-type", choices=("replicated", "erasure"),
                   default="replicated")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pggrow", action="store_true",
                   help="grow pg_num mid-workload (live PG splits)")
    p.add_argument("--tiered", action="store_true",
                   help="run the workload through a writeback cache "
                        "tier with promote/flush/evict churn")
    p.add_argument("--faults", default="", metavar="SPEC",
                   help="fault-injection schedule, e.g. "
                        "'device.dispatch:error:1in20' "
                        "(see utils/faults.py for the grammar)")
    p.add_argument("--chaos", action="store_true",
                   help=f"shorthand for --faults '{CHAOS_FAULTS}'")
    ns = p.parse_args(argv)
    faults = ns.faults or (CHAOS_FAULTS if ns.chaos else "")
    return run_thrash(ns.osds, ns.seconds, ns.pool_type, ns.seed,
                      pggrow=ns.pggrow, tiered=ns.tiered,
                      faults=faults)


if __name__ == "__main__":
    sys.exit(main())

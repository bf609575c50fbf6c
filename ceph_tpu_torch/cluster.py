"""In-process development cluster — the framework's vstart.sh.

Python-native equivalent of the reference's dev-cluster fixtures:
``src/vstart.sh`` (mon+mgr+osd from a build tree) and the standalone
test helpers ``qa/standalone/ceph-helpers.sh`` (run_mon :447, run_osd
:631, wait_for_clean :1579, kill/revive via ceph_manager.py
:2748,:2790).  Daemons run as threads in one process, talking over real
loopback TCP through the messenger — the same wire path a multi-host
deployment uses, so thrash tests exercise real reconnect/resend
machinery.

``data_dir=None`` backs OSDs with MemStore (reference tier-2 fake
backend; a *graceful* stop/start keeps the store object so restart is
resume); a path gives every daemon a FileStore/LogDB directory so
kill -9-style restarts recover from disk.  ``kill_osd`` with MemStore
discards the store — the "disk died" scenario that forces a full
rebuild from surviving shards (the BASELINE.json rebuild config).
"""
from __future__ import annotations

import os
import shutil
import time
from typing import Dict, List, Optional, Tuple

from .mon.monitor import Monitor
from .client.rados import Rados, RadosError
from .osd.ecbackend import ECBackend
from .osd.osd import OSD
from .store.filestore import FileStore
from .store.memstore import MemStore
from .store.objectstore import ObjectStore
from .utils.config import Config
from .utils.machine import scaled


def test_config(**overrides) -> Config:
    """Timing scaled for single-host tests (the reference's vstart
    likewise shrinks heartbeat/grace)."""
    base = {
        "osd_heartbeat_interval": 0.25,
        # generous vs the 0.25s ping: single-core pytest runs starve
        # threads for seconds; a tight grace fabricates OSD failures
        "osd_heartbeat_grace": 3.0,
        "mon_tick_interval": 0.2,
        "osd_tick_interval": 0.2,
        # the reference's ssd-tuned recovery concurrency (10) thrashes
        # a single-core test host; pin the classic 3
        "osd_recovery_max_active": 3,
        "mon_osd_down_out_interval": 3.0,
        "osd_pool_default_pg_num": 8,
    }
    base.update(overrides)
    return Config(base)


class Cluster:
    """mon.0 + N OSDs in one process (reference vstart.sh)."""

    def __init__(self, n_osds: int = 3,
                 data_dir: Optional[str] = None,
                 conf: Optional[Config] = None,
                 n_mons: int = 1,
                 with_mgr: bool = False,
                 store_kind: Optional[str] = None):
        self.n_osds = n_osds
        self.n_mons = n_mons
        self.with_mgr = with_mgr
        # file | block (with data_dir); default from osd_objectstore
        # (reference osd_objectstore picks the ObjectStore backend)
        conf0 = conf or test_config()
        self.store_kind = store_kind if store_kind is not None else (
            "file" if conf0["osd_objectstore"] == "memstore"
            else conf0["osd_objectstore"])
        self.mgr = None
        self.data_dir = data_dir
        self.conf = conf or test_config()
        self.mon: Optional[Monitor] = None
        self.mons: Dict[int, Optional[Monitor]] = {}
        self._mon_addrs: List[Tuple[str, int]] = []
        self.osds: Dict[int, Optional[OSD]] = {}
        self.stores: Dict[int, ObjectStore] = {}
        self._clients: List[Rados] = []
        # per-OSD execution-model override (osd_id -> classic|crimson)
        # so one cluster can run both backends side by side; unset ids
        # follow conf["osd_backend"].  Sticky across kill/revive — a
        # thrashed crimson OSD comes back crimson.
        self.backend_overrides: Dict[int, str] = {}

    # ------------------------------------------------------------------
    @property
    def mon_addr(self) -> Tuple[str, int]:
        return self.mon.my_addr

    def _bluestore(self, path: str) -> ObjectStore:
        from .store.bluestore import BlueStore
        return BlueStore(
            path,
            compression=self.conf[
                "blockstore_compression_algorithm"],
            wal_segment_bytes=self.conf[
                "bluestore_wal_segment_bytes"],
            group_commit_window_s=self.conf[
                "bluestore_group_commit_window_us"] / 1e6,
            apply_batch_txns=self.conf["bluestore_apply_batch_txns"],
            deferred_queue_depth=self.conf[
                "bluestore_deferred_queue_depth"])

    def _make_store(self, osd_id: int) -> ObjectStore:
        if self.data_dir is None:
            if self.store_kind == "block":
                raise ValueError(
                    "store_kind='block' needs a data_dir (a durable "
                    "backend silently downgraded to MemStore would "
                    "lose data)")
            if self.store_kind == "bluestore":
                # RAM mode: the full async pipeline (WAL group
                # commit, deferred apply, overlay reads) minus the
                # backing files — memory clusters exercise the real
                # transaction discipline
                store = self._bluestore("")
                store.mkfs()
            else:
                store = MemStore(
                    max_bytes=self.conf["memstore_max_bytes"])
                store.mkfs()
        else:
            path = os.path.join(self.data_dir, f"osd.{osd_id}")
            if self.store_kind == "block":
                from .store.blockstore import BlockStore
                store = BlockStore(
                    path, compression=self.conf[
                        "blockstore_compression_algorithm"])
            elif self.store_kind == "bluestore":
                store = self._bluestore(path)
            else:
                store = FileStore(path,
                                  fsync=self.conf["filestore_fsync"])
            if not os.path.exists(os.path.join(path, "meta.kv")):
                store.mkfs()
        return store

    def _mon_path(self, rank: int) -> str:
        if self.data_dir is None:
            return ""
        path = os.path.join(self.data_dir, f"mon.{rank}")
        os.makedirs(path, exist_ok=True)
        return path

    def start(self) -> "Cluster":
        # arm the process-wide fault registry from the cluster conf
        # before any daemon boots; idempotent, so per-OSD re-configure
        # at restart keeps the sites' RNG streams
        from .utils import faults as faultlib
        faultlib.configure_from(self.conf)
        # construct every mon first (each binds its port), then share
        # the monmap and start them (reference monmaptool --add before
        # first boot)
        for rank in range(self.n_mons):
            self.mons[rank] = Monitor(name=f"mon.{rank}", rank=rank,
                                      data_path=self._mon_path(rank),
                                      conf=self.conf)
        self._mon_addrs = [self.mons[r].my_addr
                           for r in range(self.n_mons)]
        for rank in range(self.n_mons):
            self.mons[rank].set_monmap(self._mon_addrs)
            self.mons[rank].start()
        self.mon = self.mons[0]
        if self.n_mons > 1:
            self.wait_for_quorum()
        for i in range(self.n_osds):
            self.start_osd(i)
        if self.with_mgr:
            from .mgr.manager import Manager
            self.mgr = Manager(self.client_mon_addrs(),
                               conf=self.conf).start()
        return self

    def wait_for_quorum(self, timeout: float = 15.0) -> int:
        """Block until some live mon is leader; -> leader rank.
        Budget machine-factor-scaled, like every cluster wait."""
        timeout = scaled(timeout)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for mon in self.mons.values():
                if mon is not None and mon.quorum.is_leader():
                    return mon.rank
            time.sleep(0.05)
        raise TimeoutError("no mon leader elected")

    def kill_mon(self, rank: int) -> None:
        mon = self.mons.get(rank)
        if mon is not None:
            mon.shutdown()
            self.mons[rank] = None
            if self.mon is mon:
                self.mon = next((m for m in self.mons.values()
                                 if m is not None), None)

    def revive_mon(self, rank: int) -> Monitor:
        mon = Monitor(name=f"mon.{rank}", rank=rank,
                      data_path=self._mon_path(rank), conf=self.conf)
        # rebind moved the port: patch the live monmaps in place (the
        # reference keeps mon addrs stable; our test mons bind port 0)
        self._mon_addrs[rank] = mon.my_addr
        mon.set_monmap(self._mon_addrs)
        for other in self.mons.values():
            if other is not None:
                other.quorum.monmap[rank] = mon.my_addr
        mon.start()
        self.mons[rank] = mon
        if self.mon is None:
            self.mon = mon
        return mon

    def osd_backend(self, osd_id: int) -> str:
        """Execution model for this OSD id (override, else conf)."""
        return self.backend_overrides.get(
            osd_id, self.conf["osd_backend"])

    def start_osd(self, osd_id: int,
                  backend: Optional[str] = None) -> OSD:
        store = self.stores.get(osd_id)
        if store is None:
            store = self._make_store(osd_id)
            self.stores[osd_id] = store
        store.mount()
        if backend is not None:
            self.backend_overrides[osd_id] = backend
        backend_eff = self.osd_backend(osd_id)
        if backend_eff == "crimson" and self.conf["ms_secure_mode"]:
            # the crimson pumps cannot drive the blocking AES-GCM
            # record layer (CrimsonMessenger refuses); secure-mode
            # clusters boot classic OSDs even under the crimson
            # default — see the README migration note
            backend_eff = "classic"
        cls: type = OSD
        if backend_eff == "crimson":
            from .crimson import CrimsonOSD
            cls = CrimsonOSD
        osd = cls(osd_id, store, self.client_mon_addrs(),
                  conf=self.conf)
        osd.start()
        self.osds[osd_id] = osd
        return osd

    def client_mon_addrs(self):
        """What clients/daemons dial: the single mon addr, or the full
        monmap so MonClient can hunt."""
        if self.n_mons == 1:
            return self.mon_addr
        return list(self._mon_addrs)

    def stop(self) -> None:
        for client in self._clients:
            client.shutdown()
        self._clients.clear()
        if self.mgr is not None:
            self.mgr.shutdown()
            self.mgr = None
        for osd in self.osds.values():
            if osd is not None:
                osd.shutdown()
        self.osds = {i: None for i in self.osds}
        for rank, mon in list(self.mons.items()):
            if mon is not None:
                mon.shutdown()
                self.mons[rank] = None
        self.mon = None
        ECBackend.join_activation_warms()

    def __enter__(self) -> "Cluster":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------
    # fault injection (reference qa/tasks/ceph_manager.py kill_osd
    # :2748 / revive_osd :2790)
    # ------------------------------------------------------------------
    def kill_osd(self, osd_id: int, lose_data: bool = False) -> None:
        """Stop an OSD.  ``lose_data`` discards its store — the dead-
        disk scenario: revive comes back empty and must backfill."""
        osd = self.osds.get(osd_id)
        if osd is not None:
            osd.shutdown()
            self.osds[osd_id] = None
        if lose_data:
            store = self.stores.pop(osd_id, None)
            if store is not None and self.data_dir is not None:
                shutil.rmtree(os.path.join(self.data_dir,
                                           f"osd.{osd_id}"),
                              ignore_errors=True)

    def revive_osd(self, osd_id: int) -> OSD:
        return self.start_osd(osd_id)

    # ------------------------------------------------------------------
    # admin conveniences (reference ceph CLI paths)
    # ------------------------------------------------------------------
    def rados(self, timeout: float = 10.0) -> Rados:
        client = Rados(self.client_mon_addrs(),
                       conf=self.conf).connect(timeout)
        self._clients.append(client)
        return client

    def mon_command(self, cmd: dict) -> Tuple[int, str, dict]:
        with Rados(self.client_mon_addrs(), conf=self.conf) as r:
            return r.mon_command(cmd)

    def create_ec_profile(self, name: str, **kv) -> None:
        profile = [f"{k.replace('_', '-') if k.startswith('crush') else k}"
                   f"={v}" for k, v in kv.items()]
        ret, rs, _ = self.mon_command({
            "prefix": "osd erasure-code-profile set", "name": name,
            "profile": profile})
        if ret != 0:
            raise RadosError(-ret, rs)

    def create_pool(self, name: str, pool_type: str = "replicated",
                    pg_num: Optional[int] = None, **kw) -> int:
        cmd = {"prefix": "osd pool create", "pool": name,
               "pool_type": pool_type}
        if pg_num is not None:
            cmd["pg_num"] = pg_num
        cmd.update(kw)
        ret, rs, out = self.mon_command(cmd)
        if ret != 0:
            raise RadosError(-ret, rs)
        return out.get("pool_id", -1)

    # ------------------------------------------------------------------
    # health polling (reference ceph-helpers.sh wait_for_clean :1579)
    # ------------------------------------------------------------------
    def health(self) -> dict:
        ret, rs, out = self.mon_command({"prefix": "health"})
        if ret != 0:
            raise RadosError(-ret, rs)
        return out

    def wait_for_clean(self, timeout: float = 30.0) -> float:
        """Block until every PG reports active+clean; -> seconds it
        took (the rebuild-time metric of BASELINE.json config 5).

        The budget is scaled by the measured machine factor
        (utils/machine.py): fixed constants under variable load fabricate
        failures, and the reference's own helper runs
        with a 300 s default (qa/standalone/ceph-helpers.sh:1579)."""
        timeout = scaled(timeout)
        t0 = time.monotonic()
        deadline = t0 + timeout
        while time.monotonic() < deadline:
            h = self.health()
            if h.get("all_clean"):
                return time.monotonic() - t0
            time.sleep(self.conf["client_retry_interval"])
        raise TimeoutError(
            f"cluster not clean after {timeout}s: {self.health()}")

    def wait_for_osd_up(self, osd_id: int, timeout: float = 10.0) -> None:
        timeout = scaled(timeout)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            ret, _, out = self.mon_command({"prefix": "osd dump"})
            if ret == 0:
                for o in out.get("osds", []):
                    if o["osd"] == osd_id and o["up"]:
                        return
            time.sleep(self.conf["client_retry_interval"])
        raise TimeoutError(f"osd.{osd_id} not up after {timeout}s")

    def wait_for_osd_down(self, osd_id: int,
                          timeout: float = 15.0) -> None:
        timeout = scaled(timeout)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            ret, _, out = self.mon_command({"prefix": "osd dump"})
            if ret == 0:
                for o in out.get("osds", []):
                    if o["osd"] == osd_id and not o["up"]:
                        return
            time.sleep(self.conf["client_retry_interval"])
        raise TimeoutError(f"osd.{osd_id} still up after {timeout}s")

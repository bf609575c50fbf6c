"""Monitor — the cluster's control plane and map authority.

Python-native equivalent of the reference's monitor stack (reference
src/mon/Monitor.cc, mon/OSDMonitor.cc 14.1k LoC, mon/MonitorDBStore.h)
reduced to the single-monitor deployment the framework drives first
(SURVEY.md §7 step 8: "single-mon first, Paxos quorum later"):

* **map authority**: the one OSDMap lineage, advanced by applying
  ``Incremental`` deltas (reference pending_inc + Paxos propose/commit;
  here commit = persist to the MonitorDBStore then publish);
* **MonitorDBStore**: every epoch's full map is persisted to a
  key-value store (reference mon/MonitorDBStore.h:37 over RocksDB;
  here ``store.kv``: LogDB on disk or MemDB), so a monitor restart
  resumes the lineage — reference "mon data dir";
* **command table** (reference mon/MonCommands.h + OSDMonitor
  handlers): ``osd erasure-code-profile set`` validates the profile by
  *instantiating the plugin* exactly like the reference
  (mon/OSDMonitor.cc:7371-7392 get_erasure_code — so the monitor loads
  the gpu plugin too, so a profile names ``device=cpu`` where there is
  no card);
  ``osd pool create`` wires profile -> crush rule via the codec's
  ``create_rule`` (reference OSDMonitor.cc:7216-7368);
* **failure detection** (reference prepare_failure/check_failure,
  mon/OSDMonitor.cc:3257,3172): OSDs report unresponsive peers with
  MOSDFailure; once ``mon_osd_min_down_reporters`` distinct reporters
  from distinct failure-domain subtrees (``mon_osd_reporter_subtree_
  level``) agree, the target is marked down in a new epoch;
* **down-out tick** (reference mon_osd_down_out_interval): OSDs down
  longer than the interval are marked out (weight 0) so CRUSH remaps
  and recovery rebuilds their data elsewhere;
* **PG stat aggregation** (reference MgrStatMonitor/PGMap): primaries
  report per-PG stats (MPGStats); ``status``/``health`` summarize them
  — this is what ``wait_for_clean`` polls (reference
  qa/standalone/ceph-helpers.sh:1579).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..crush.wrapper import CrushWrapper, weight_to_fixed
from ..ec import registry as ec_registry
from ..msg.messages import (MMonCommand, MMonCommandAck, MMonMon,
                            MMonSubscribe, MOSDBoot, MOSDFailure,
                            MOSDMap, MOSDScrub, MPGStats)
from ..msg.messenger import Connection, Dispatcher, Messenger
from ..osd.osdmap import (Incremental, OSDMap, PGid, PGPool,
                          POOL_TYPE_ERASURE, POOL_TYPE_REPLICATED)
from ..store.kv import KeyValueDB, LogDB, MemDB, WriteBatch
from ..utils.config import Config, default_config
from ..utils.lockdep import make_lock
from ..utils.log import Dout

DEFAULT_STRIPE_UNIT = 4096      # reference osd_pool_erasure_code_stripe_unit
REDIRECT_RETCODE = -301         # "ask the leader" (MonClient retries)


class MonitorDBStore:
    """Persisted monitor state (reference mon/MonitorDBStore.h:37):
    full OSDMap per epoch under ``osdmap.<epoch>``, plus the latest
    committed epoch pointer — a monitor restart resumes from here."""

    def __init__(self, path: str = "", compact_on_open: bool = False,
                 compact_factor: int = 4):
        self.db: KeyValueDB = LogDB(os.path.join(path, "mon.db"),
                                    compact_factor=compact_factor) \
            if path else MemDB()
        self.db.open()
        if compact_on_open and hasattr(self.db, "compact"):
            self.db.compact()        # reference mon_compact_on_start

    def put_map(self, epoch: int, wire: dict,
                keep_epochs: int = 500) -> None:
        """Persist one epoch and trim history older than
        ``keep_epochs`` (reference mon_min_osdmap_epochs + PaxosService
        trim) so a long-lived monitor's store stays bounded."""
        batch = WriteBatch()
        batch.set(f"osdmap.{epoch:010d}", json.dumps(wire).encode())
        batch.set("osdmap.last", str(epoch).encode())
        stale = epoch - keep_epochs
        if stale > 0 and self.db.get(f"osdmap.{stale:010d}"):
            batch.rm(f"osdmap.{stale:010d}")
        self.db.submit(batch, sync=True)

    def last_epoch(self) -> int:
        raw = self.db.get("osdmap.last")
        return int(raw.decode()) if raw else 0

    def get_map(self, epoch: int) -> Optional[dict]:
        raw = self.db.get(f"osdmap.{epoch:010d}")
        return json.loads(raw.decode()) if raw else None

    def put_raw(self, key: str, value: dict) -> None:
        """Non-map monitor state (auth keyring etc.; the reference
        stores every PaxosService's data in the same backing kv)."""
        batch = WriteBatch()
        batch.set(f"raw.{key}", json.dumps(value).encode())
        self.db.submit(batch, sync=True)

    def get_raw(self, key: str) -> Optional[dict]:
        raw = self.db.get(f"raw.{key}")
        return json.loads(raw.decode()) if raw else None

    def close(self) -> None:
        self.db.close()


class Monitor(Dispatcher):
    """Single monitor daemon (reference mon/Monitor.cc)."""

    def __init__(self, name: str = "mon.0", data_path: str = "",
                 conf: Optional[Config] = None,
                 addr: Tuple[str, int] = ("127.0.0.1", 0),
                 rank: int = 0):
        self.name = name
        self.rank = rank
        self.conf = conf or default_config()
        self.log = Dout("mon", f"{name} ")
        self.lock = make_lock("mon")
        self.store = MonitorDBStore(
            data_path,
            compact_on_open=self.conf["mon_compact_on_start"],
            compact_factor=self.conf["kv_compact_factor"])
        self.osdmap = OSDMap()
        self.ec_registry = ec_registry.instance()
        # subscribers: conn -> next epoch wanted (reference
        # Session::sub_map / MMonSubscribe)
        self.subs: Dict[Connection, int] = {}
        self.osd_conns: Dict[int, Connection] = {}   # osd -> mon session
        # failure reports: target -> reporter -> (first_seen, failed_for)
        self.failure_reports: Dict[int, Dict[int, Tuple[float, float]]] = {}
        self.pg_stats: Dict[str, dict] = {}
        self.pg_stats_from: Dict[str, int] = {}
        self.osd_stats: Dict[int, dict] = {}     # osd -> osd_stat_t
        self._data_path = data_path
        # MDSMap (reference mon/MDSMonitor.cc FSMap reduced to rank ->
        # name assignment + standbys with beacon-grace failover).
        # "actives" maps rank (str, JSON-keyed) -> daemon name up to
        # max_mds ranks (reference fs set max_mds); "pins" maps a
        # directory subtree path -> authoritative rank (the static
        # analog of reference ceph.dir.pin / Migrator subtree
        # auth delegation); "active" mirrors rank 0 for legacy
        # consumers.  Leader-local, persisted.
        self.mds_map: Dict = {"epoch": 0, "active": None,
                              "addrs": {}, "standbys": [],
                              "max_mds": 1, "actives": {},
                              "pins": {}}
        self._mds_beacons: Dict[str, float] = {}
        self._booted_addr: Dict[int, Tuple[str, int]] = {}
        self.msgr = Messenger(name, conf=self.conf)
        self.my_addr = self.msgr.bind(addr)
        self.msgr.add_dispatcher(self)
        self._stop = threading.Event()
        self._tick_thread: Optional[threading.Thread] = None
        self._down_since: Dict[int, float] = {}
        # single-mon monmap by default; multi-mon deployments call
        # set_monmap with every mon's address before start()
        from .paxos import QuorumService
        self.quorum = QuorumService(self, rank, [self.my_addr])
        # entity keyring (reference AuthMonitor/KeyServer; replicated
        # with every paxos commit — the transport-level cluster secret
        # is conf auth_key, not stored here).  Before
        # _load_or_bootstrap: the genesis commit persists it.
        from ..auth.keyring import Keyring
        rows = self.store.get_raw("keyring")
        self.keyring = Keyring.load(rows) if rows else Keyring()
        if not self.keyring.names():
            # each mon bootstraps an admin key; in a quorum the
            # leader's keyring wholesale-replaces peons' at the first
            # commit, so the cluster converges on the leader's
            self.keyring.get_or_create(
                "client.admin", {"mon": "allow *", "osd": "allow *"})
        self._load_or_bootstrap()

    def _persist_keyring(self) -> None:
        self.store.put_raw("keyring", self.keyring.dump())

    def install_keyring(self, rows: List[dict]) -> None:
        """Adopt replicated keyring state (paxos commit / sync)."""
        from ..auth.keyring import Keyring
        with self.lock:
            self.keyring = Keyring.load(rows)
            self._persist_keyring()

    def set_monmap(self, monmap: List[Tuple[str, int]]) -> None:
        """Install the full monitor map (reference MonMap); must be
        called on every mon before start() in multi-mon deployments."""
        from .paxos import QuorumService
        self.quorum = QuorumService(self, self.rank, monmap)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def _load_or_bootstrap(self) -> None:
        # MDSMap survives a monitor restart (reference MDSMonitor's
        # paxos-persisted FSMap): without this the first beacon after
        # restart would win active regardless of prior assignment, and
        # the epoch would restart at 0, mis-ordering maps at clients.
        # Beacon grace baselines restart at "now" so known daemons get
        # a full grace window to re-beacon before failover.
        saved_mds = self.store.get_raw("mdsmap")
        if saved_mds:
            self.mds_map = saved_mds
            # maps persisted before multi-MDS lack the rank fields
            self.mds_map.setdefault("max_mds", 1)
            self.mds_map.setdefault("pins", {})
            acts = self.mds_map.setdefault("actives", {})
            if self.mds_map.get("active") and not acts:
                acts["0"] = self.mds_map["active"]
            now = time.monotonic()
            for name in self.mds_map.get("addrs", {}):
                self._mds_beacons[name] = now
        last = self.store.last_epoch()
        if last:
            self.osdmap = OSDMap.from_wire_dict(self.store.get_map(last))
            self.log.dout(1, f"resumed at osdmap e{last}")
            return
        # genesis map: crush root + the default replicated rule
        # (reference OSDMonitor::create_initial)
        inc = Incremental(1)
        crush = CrushWrapper()
        crush.add_bucket("default", "root")
        crush.add_simple_rule("replicated_rule", "default", "host",
                              mode="firstn", pool_type="replicated")
        inc.new_crush = crush
        self._commit(inc)

    def start(self) -> None:
        self.msgr.start()
        self._tick_thread = threading.Thread(
            target=self._tick_loop, name=f"{self.name}-tick", daemon=True)
        self._tick_thread.start()
        self.log.dout(1, f"listening on {self.my_addr}")
        if self.quorum.n_mons > 1:
            self.quorum.start_election()

    def on_quorum_formed(self) -> None:
        """Called on the new leader after victory."""
        self.log.dout(1, f"quorum formed: {sorted(self.quorum.quorum)}")

    def shutdown(self) -> None:
        self._stop.set()
        self.msgr.shutdown()
        if self._tick_thread:
            self._tick_thread.join(timeout=5)
        self.store.close()

    # ------------------------------------------------------------------
    # map commit + publish (reference Paxos propose/commit -> publish)
    # ------------------------------------------------------------------
    class NoQuorum(RuntimeError):
        pass

    def _commit(self, inc: Incremental) -> None:
        """Caller need not hold the lock; commits serialize on it.
        Multi-mon: the new map is REPLICATED FIRST (paxos begin/accept
        to a majority) and only then applied/persisted/published —
        a minority leader cannot advance the map (reference
        Paxos::begin gates commit on accepts)."""
        with self.lock:
            candidate = self.osdmap.clone()
            candidate.apply_incremental(inc)
            wire = candidate.to_wire_dict()
            epoch = candidate.epoch
            if self.quorum.n_mons > 1:
                if not self.quorum.is_leader():
                    raise Monitor.NoQuorum("not the leader")
                # the replicated value carries the keyring alongside
                # the map (reference: AuthMonitor state rides the same
                # paxos store as the OSDMonitor's)
                value = {"osdmap": wire,
                         "keyring": self.keyring.dump()}
                if not self.quorum.propose(epoch, value):
                    raise Monitor.NoQuorum(
                        "no quorum majority, map change rejected")
            self.osdmap = candidate
            self.store.put_map(
                epoch, wire,
                keep_epochs=self.conf["mon_min_osdmap_epochs"])
            self._persist_keyring()
            targets = [(conn, since) for conn, since in self.subs.items()
                       if since <= epoch]
            for conn, _ in targets:
                self.subs[conn] = epoch + 1
        for conn, _ in targets:
            conn.send_message(MOSDMap(maps={epoch: wire}))

    def apply_replicated(self, version: int, value: dict) -> None:
        """Peon-side: install state the leader replicated (paxos commit
        or catch-up sync) and publish to this mon's subscribers.
        ``value`` is {"osdmap": wire, "keyring": rows} (or a bare map
        wire dict from the catch-up path)."""
        if "osdmap" in value and "epoch" not in value:
            wire = value["osdmap"]
            keyring_rows = value.get("keyring")
        else:
            wire = value
            keyring_rows = None
        with self.lock:
            if keyring_rows is not None:
                from ..auth.keyring import Keyring
                self.keyring = Keyring.load(keyring_rows)
                self._persist_keyring()
            if version <= self.osdmap.epoch:
                return
            self.osdmap = OSDMap.from_wire_dict(wire)
            self.store.put_map(
                version, wire,
                keep_epochs=self.conf["mon_min_osdmap_epochs"])
            targets = [(conn, since) for conn, since in self.subs.items()
                       if since <= version]
            for conn, _ in targets:
                self.subs[conn] = version + 1
        for conn, _ in targets:
            conn.send_message(MOSDMap(maps={version: wire}))

    def _pending(self) -> Incremental:
        return Incremental(self.osdmap.epoch + 1)

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------
    def ms_dispatch(self, conn: Connection, msg) -> bool:
        if isinstance(msg, MMonMon):
            self.quorum.handle(msg)
            return True
        if isinstance(msg, MMonSubscribe):
            self._handle_subscribe(conn, msg)
        elif isinstance(msg, MMonCommand):
            self._handle_command(conn, msg)
        elif isinstance(msg, (MOSDBoot, MOSDFailure, MPGStats)):
            # map-mutating / aggregate reports belong to the leader; a
            # peon relays (reference mons forward to the leader via
            # MRoute/MForward)
            if not self.quorum.is_leader():
                self._forward_to_leader(msg)
                if isinstance(msg, MOSDBoot):
                    # still remember the direct session for scrub etc.
                    self._note_osd_conn(conn, msg)
                return True
            try:
                if isinstance(msg, MOSDBoot):
                    self._handle_boot(conn, msg)
                elif isinstance(msg, MOSDFailure):
                    self._handle_failure(conn, msg)
                else:
                    self._handle_pg_stats(conn, msg)
            except Monitor.NoQuorum:
                pass                     # senders re-announce
        else:
            return False
        return True

    def _forward_to_leader(self, msg) -> None:
        addr = self.quorum.leader_addr()
        if addr is None:
            return                       # electing: sender retries
        try:
            msg.seq = 0                  # re-stamped on the relay conn
            self.msgr.connect_to(
                addr, peer_name=f"mon.{self.quorum.leader}"
            ).send_message(msg)
        except Exception:
            pass

    def _note_osd_conn(self, conn: Optional[Connection],
                       msg: MOSDBoot) -> None:
        if conn is not None and \
                not conn.peer_name.startswith("mon."):
            with self.lock:
                self.osd_conns[msg.osd] = conn

    def ms_handle_reset(self, conn: Connection) -> None:
        with self.lock:
            self.subs.pop(conn, None)
            for osd, c in list(self.osd_conns.items()):
                if c is conn:
                    del self.osd_conns[osd]

    def _handle_subscribe(self, conn: Connection, msg: MMonSubscribe
                          ) -> None:
        want = msg.what.get("osdmap")
        if want is None:
            return
        with self.lock:
            epoch = self.osdmap.epoch
            wire = self.osdmap.to_wire_dict() if epoch >= want else None
            self.subs[conn] = epoch + 1
        if wire is not None:
            conn.send_message(MOSDMap(maps={epoch: wire}))

    # ------------------------------------------------------------------
    # OSD boot (reference OSDMonitor::prepare_boot)
    # ------------------------------------------------------------------
    def _handle_boot(self, conn: Connection, msg: MOSDBoot) -> None:
        osd, addr = msg.osd, tuple(msg.addr)
        # remember the OSD's own mon session: mon->OSD commands (scrub
        # etc.) ride it back, since dialing the OSD fresh would collide
        # with its MonClient session (the reference likewise sends
        # MOSDScrub down the OSD's mon connection).  Forwarded boots
        # arrive over a mon-mon conn, which is not an OSD session.
        self._note_osd_conn(conn, msg)
        with self.lock:
            info = self.osdmap.osds.get(osd)
            if info is not None and info.up and info.addr == addr:
                return                   # duplicate boot
            self._booted_addr[osd] = addr
            inc = self._pending()
            inc.new_up[osd] = addr
            if info is not None and info.weight == 0 and \
                    self.conf["mon_osd_auto_mark_in"]:
                # a booting OSD that was auto-marked out comes back in
                # (reference mon_osd_auto_mark_booting_in semantics)
                inc.new_weight[osd] = 0x10000
            crush = self.osdmap.crush
            if f"osd.{osd}" not in crush.name_ids:
                # auto-create the crush item under a per-OSD host
                # (vstart-style dev topology; reference `osd crush
                # create-or-move` run by the OSD's init script)
                crush = self._crush_clone()
                host = f"host{osd}"
                if host not in crush.name_ids:
                    crush.add_bucket(host, "host")
                    crush.insert_item(crush.name_ids[host], 0, host,
                                      "default")
                crush.insert_item(osd, 1.0, f"osd.{osd}", host)
                inc.new_crush = crush
            self._commit(inc)
        self.log.dout(1, f"osd.{osd} booted at {addr}")

    def _crush_clone(self) -> CrushWrapper:
        return CrushWrapper.from_wire_dict(
            self.osdmap.crush.to_wire_dict())

    # ------------------------------------------------------------------
    # failure reports (reference OSDMonitor::prepare_failure :3257)
    # ------------------------------------------------------------------
    def _reporter_subtree(self, osd: int) -> str:
        """The failure-domain ancestor of a reporter (reference
        mon_osd_reporter_subtree_level): two reports only count as
        independent if they come from different subtrees."""
        level = self.conf["mon_osd_reporter_subtree_level"]
        crush = self.osdmap.crush
        name = f"osd.{osd}"
        try:
            return crush.ancestor_of(name, level)
        except (KeyError, AttributeError):
            return name                  # no topology: every osd counts

    def _handle_failure(self, conn: Connection, msg: MOSDFailure) -> None:
        now = time.monotonic()
        mark_down = False
        with self.lock:
            if not self.osdmap.is_up(msg.target_osd):
                return
            reports = self.failure_reports.setdefault(msg.target_osd, {})
            reports[msg.from_osd] = (now, msg.failed_for)
            subtrees = {self._reporter_subtree(r) for r in reports}
            need = self.conf["mon_osd_min_down_reporters"]
            up_others = sum(1 for o, i in self.osdmap.osds.items()
                            if i.up and o != msg.target_osd)
            need = min(need, max(up_others, 1))
            if len(subtrees) >= need:
                mark_down = True
                del self.failure_reports[msg.target_osd]
                inc = self._pending()
                inc.new_down.append(msg.target_osd)
                self._commit(inc)
        if mark_down:
            self.log.dout(1, f"marking osd.{msg.target_osd} down "
                            f"({len(reports)} reporters)")

    # ------------------------------------------------------------------
    # pg stats (reference MgrStatMonitor; health for wait_for_clean)
    # ------------------------------------------------------------------
    def _handle_pg_stats(self, conn: Connection, msg: MPGStats) -> None:
        with self.lock:
            if msg.osd_stat:
                self.osd_stats[msg.from_osd] = msg.osd_stat
            for pgid, stat in msg.pg_stats.items():
                old = self.pg_stats.get(pgid)
                if old is not None and old.get("_epoch", 0) > msg.epoch:
                    continue             # stale reporter
                stat = dict(stat)
                stat["_epoch"] = msg.epoch
                self.pg_stats[pgid] = stat
                self.pg_stats_from[pgid] = msg.from_osd

    def _health_summary_locked(self) -> dict:
        expected = sum(p.pg_num for p in self.osdmap.pools.values())
        states: Dict[str, int] = {}
        known = 0
        scrub_errors = 0
        for pgid, stat in self.pg_stats.items():
            pool = pgid.split(".", 1)[0]
            if int(pool) not in self.osdmap.pools:
                continue
            scrub_errors += stat.get("num_scrub_errors", 0)
            # a stat predating the current map may describe a dead
            # interval (e.g. "clean" from before an OSD died); count
            # it as not-yet-reported so wait_for_clean blocks until
            # the live primary reports at this epoch (the reference
            # gates on pg_stat_t::reported_epoch the same way)
            if stat.get("_epoch", 0) < self.osdmap.epoch:
                continue
            known += 1
            states[stat.get("state", "unknown")] = \
                states.get(stat.get("state", "unknown"), 0) + 1
        clean = states.get("active+clean", 0)
        degraded = sum(n for s, n in states.items() if "degraded" in s
                       or "recovering" in s)
        inconsistent = sum(n for s, n in states.items()
                           if "inconsistent" in s)
        if inconsistent or scrub_errors:
            # reference: PG_DAMAGED / OSD_SCRUB_ERRORS => HEALTH_ERR
            status = "HEALTH_ERR"
        elif expected == 0 or (known >= expected and clean == known):
            status = "HEALTH_OK"
        elif degraded or known < expected:
            status = "HEALTH_WARN"
        else:
            status = "HEALTH_WARN"
        # fullness health (reference OSD_FULL/OSD_NEARFULL checks,
        # mon_osd_full_ratio / mon_osd_nearfull_ratio)
        full, nearfull = [], []
        for osd, st in self.osd_stats.items():
            kb = st.get("kb", 0)
            if not kb:
                continue
            ratio = st.get("kb_used", 0) / kb
            if ratio >= self.conf["mon_osd_full_ratio"]:
                full.append(osd)
            elif ratio >= self.conf["mon_osd_nearfull_ratio"]:
                nearfull.append(osd)
        checks = {}
        if full:
            checks["OSD_FULL"] = sorted(full)
            status = "HEALTH_ERR"
        if nearfull:
            checks["OSD_NEARFULL"] = sorted(nearfull)
            if status == "HEALTH_OK":
                status = "HEALTH_WARN"
        # mon data dir free space (reference mon_data_avail_warn)
        warn_pct = self.conf["mon_data_avail_warn"]
        if self._data_path and warn_pct:
            try:
                st = os.statvfs(self._data_path)
                avail_pct = 100 * st.f_bavail // max(st.f_blocks, 1)
                if avail_pct < warn_pct:
                    checks["MON_DISK_LOW"] = avail_pct
                    if status == "HEALTH_OK":
                        status = "HEALTH_WARN"
            except OSError:
                pass
        return {"status": status, "num_pgs": expected,
                "checks": checks,
                "num_pgs_reported": known, "pg_states": states,
                "num_scrub_errors": scrub_errors,
                "all_clean": expected > 0 and known >= expected
                and clean == known}

    # ------------------------------------------------------------------
    # tick: down->out aging (reference mon_osd_down_out_interval)
    # ------------------------------------------------------------------
    def _tick_loop(self) -> None:
        interval = self.conf["mon_tick_interval"]
        while not self._stop.wait(interval):
            try:
                self._tick()
            except Monitor.NoQuorum:
                pass                     # aging retries next tick
            except Exception as e:
                self.log.dout(1, f"tick failed: {e!r}")

    def _tick(self) -> None:
        self.quorum.tick()
        if not self.quorum.is_leader():
            return                       # map aging is the leader's job
        self._mds_tick()
        down_out = self.conf["mon_osd_down_out_interval"]
        if down_out <= 0:
            return
        inc = None
        with self.lock:
            now_epoch = self.osdmap.epoch
            n_total = len(self.osdmap.osds)
            n_in = sum(1 for i in self.osdmap.osds.values()
                       if i.weight > 0)
            for osd, info in self.osdmap.osds.items():
                if info.up or info.weight == 0:
                    continue
                # reference mon_osd_min_in_ratio: never auto-out past
                # the point where too little of the cluster remains in
                # (n_in tracks the outs THIS tick would make, so one
                # batch can't cross the floor)
                if n_total and (n_in - 1) / n_total < \
                        self.conf["mon_osd_min_in_ratio"]:
                    continue
                # age by epochs-as-time: down_at records the epoch; use
                # wall time via _down_since bookkeeping instead
                since = self._down_since.get(osd)
                if since is None:
                    self._down_since[osd] = time.monotonic()
                elif time.monotonic() - since >= down_out:
                    if inc is None:
                        inc = self._pending()
                    inc.new_weight[osd] = 0
                    n_in -= 1
                    self.log.dout(1, f"osd.{osd} down > {down_out}s:"
                                  f" marking out")
            for osd in list(self._down_since):
                info = self.osdmap.osds.get(osd)
                if info is None or info.up:
                    del self._down_since[osd]
            if inc is not None:
                self._commit(inc)

    # ------------------------------------------------------------------
    # commands (reference mon/MonCommands.h table + OSDMonitor handlers)
    # ------------------------------------------------------------------
    # commands a peon can serve from its own state/sessions
    _LOCAL_COMMANDS = ("pg scrub", "pg deep-scrub", "pg repair")

    def _handle_command(self, conn: Connection, msg: MMonCommand) -> None:
        cmd = msg.cmd
        prefix = cmd.get("prefix", "")
        if self.quorum.n_mons > 1 and not self.quorum.is_leader() \
                and prefix not in self._LOCAL_COMMANDS:
            # redirect to the leader (observable equivalent of the
            # reference's MForward routing through the leader)
            addr = self.quorum.leader_addr()
            if addr is None:
                ack = MMonCommandAck(tid=msg.tid, retcode=-11,
                                     rs="quorum is electing, retry")
            else:
                ack = MMonCommandAck(
                    tid=msg.tid, retcode=REDIRECT_RETCODE,
                    rs=f"not leader; retry at mon.{self.quorum.leader}",
                    out={"leader": list(addr)})
            conn.send_message(ack)
            return
        handler = self.COMMANDS.get(prefix)
        if handler is None:
            ack = MMonCommandAck(tid=msg.tid, retcode=-22,
                                 rs=f"unknown command {prefix!r}")
        else:
            try:
                retcode, rs, out = handler(self, cmd)
                ack = MMonCommandAck(tid=msg.tid, retcode=retcode, rs=rs,
                                     out=out)
            except Monitor.NoQuorum as e:
                # -11 + "electing" is the retry signal MonClient
                # already understands
                ack = MMonCommandAck(tid=msg.tid, retcode=-11,
                                     rs=f"quorum is electing, "
                                        f"retry: {e}")
            except Exception as e:       # command errors go to the CLI
                ack = MMonCommandAck(tid=msg.tid, retcode=-22, rs=str(e))
        conn.send_message(ack)

    # -- erasure-code profiles (reference OSDMonitor.cc:10829,7492) ----
    @staticmethod
    def parse_profile(items: List[str]) -> Dict[str, str]:
        """k=v list -> profile map (reference
        parse_erasure_code_profile, OSDMonitor.cc:7492)."""
        prof: Dict[str, str] = {}
        for item in items:
            if "=" not in item:
                raise ValueError(f"profile entry {item!r} is not k=v")
            key, val = item.split("=", 1)
            prof[key.strip()] = val.strip()
        return prof

    def _cmd_profile_set(self, cmd: dict):
        name = cmd["name"]
        prof = self.parse_profile(cmd.get("profile", []))
        prof.setdefault("plugin", "jerasure")
        force = cmd.get("force", False)
        with self.lock:
            existing = self.osdmap.erasure_code_profiles.get(name)
            if existing is not None and existing != prof and not force:
                in_use = any(p.erasure_code_profile == name
                             for p in self.osdmap.pools.values())
                if in_use:
                    return (-16, f"profile {name} is in use and differs; "
                            f"--force to override", {})
        # validate by instantiating the plugin, as the reference's
        # monitor does (OSDMonitor.cc:7371-7392) — a bad k/m/technique
        # fails here, before the profile ever reaches the map
        try:
            check = dict(prof)
            plugin = check.pop("plugin")
            self.ec_registry.factory(plugin, check)
        except Exception as e:
            return (-22, f"invalid profile: {e}", {})
        with self.lock:
            inc = self._pending()
            inc.new_profiles[name] = prof
            self._commit(inc)
        return (0, f"profile {name} set", {})

    def _cmd_profile_get(self, cmd: dict):
        with self.lock:
            prof = self.osdmap.erasure_code_profiles.get(cmd["name"])
        if prof is None:
            return (-2, f"no profile {cmd['name']}", {})
        return (0, "", dict(prof))

    def _cmd_profile_ls(self, cmd: dict):
        with self.lock:
            return (0, "", {"profiles":
                            sorted(self.osdmap.erasure_code_profiles)})

    def _cmd_profile_rm(self, cmd: dict):
        name = cmd["name"]
        with self.lock:
            if any(p.erasure_code_profile == name
                   for p in self.osdmap.pools.values()):
                return (-16, f"profile {name} is in use", {})
            if name not in self.osdmap.erasure_code_profiles:
                return (0, "", {})
            inc = self._pending()
            inc.old_profiles.append(name)
            self._commit(inc)
        return (0, f"profile {name} removed", {})

    # -- pools (reference OSDMonitor::prepare_new_pool :7216) -----------
    def _cmd_pool_create(self, cmd: dict):
        name = cmd["pool"]
        pool_type = cmd.get("pool_type", POOL_TYPE_REPLICATED)
        pg_num = int(cmd.get("pg_num",
                             self.conf["osd_pool_default_pg_num"]))
        with self.lock:
            if self.osdmap.get_pool(name) is not None:
                return (0, f"pool {name} exists", {})
            pid = self.osdmap._next_pool_id
        # the framework's placement IS hashpspool placement; the
        # legacy pre-hashpspool hashing was never implemented, so
        # turning the default flag off is an explicit unsupported
        if not self.conf["osd_pool_default_flag_hashpspool"]:
            return (-95, "non-hashpspool placement is not "
                         "supported", {})
        # pgp_num decoupling (placement subsetting) is likewise not
        # implemented: a default differing from pg_num must fail
        # loudly, not silently place with pg_num
        pgp_default = self.conf["osd_pool_default_pgp_num"]
        if pgp_default and pgp_default != pg_num:
            return (-95, "pgp_num != pg_num is not supported", {})
        # reference mon_max_pg_per_osd pool-creation guard; counts PG
        # INSTANCES (pg_num x size) on both sides, so a wide pool
        # can't slip under the limit by its bare pg_num
        def _pg_guard(new_size: int):
            with self.lock:
                n_osds = max(1, sum(1 for i in
                                    self.osdmap.osds.values() if i.up))
                total = sum(p.pg_num * p.size
                            for p in self.osdmap.pools.values())
            limit = self.conf["mon_max_pg_per_osd"] * n_osds
            if total + pg_num * new_size > limit:
                return (-34, f"pool would push pg-instance count past "
                             f"mon_max_pg_per_osd ({limit})", {})
            return None
        if pool_type == POOL_TYPE_ERASURE:
            prof_name = cmd.get("erasure_code_profile", "default")
            with self.lock:
                prof = self.osdmap.erasure_code_profiles.get(prof_name)
            if prof is None and prof_name == "default":
                # reference osd_pool_default_erasure_code_profile:
                # an unregistered 'default' comes from config
                prof = dict(
                    kv.split("=", 1) for kv in
                    self.conf[
                        "osd_pool_default_erasure_code_profile"
                    ].split())
            if prof is None:
                return (-2, f"no erasure profile {prof_name}", {})
            check = dict(prof)
            plugin = check.pop("plugin", "jerasure")
            try:
                ec = self.ec_registry.factory(plugin, check)
            except Exception as e:
                return (-22, f"profile {prof_name} invalid: {e}", {})
            k = ec.get_data_chunk_count()
            size = ec.get_chunk_count()
            guard = _pg_guard(size)
            if guard is not None:
                return guard
            m = size - k
            # reference: EC min_size = k + min(1, m) (can't serve
            # writes below k shards; one spare before inactivity)
            min_size = k + (1 if m >= 2 else 0)
            stripe_unit = int(prof.get(
                "stripe_unit",
                self.conf["osd_pool_erasure_code_stripe_unit"]))
            stripe_width = k * stripe_unit
            rule_name = cmd.get("rule", f"ecrule_{prof_name}")
            failure_domain = prof.get("crush-failure-domain", "host")
            with self.lock:
                crush = self._crush_clone()
                try:
                    rule_id = crush.rule_id(rule_name)
                except KeyError:
                    # reference ErasureCodeInterface::create_rule ->
                    # add_simple_rule(..., "indep", TYPE_ERASURE)
                    # (erasure-code/ErasureCode.cc:64-83)
                    rule_id = crush.add_simple_rule(
                        rule_name, prof.get("crush-root", "default"),
                        failure_domain, mode="indep",
                        pool_type="erasure")
                pool = PGPool(name=name, pool_id=pid,
                              type=POOL_TYPE_ERASURE, size=size,
                              min_size=min_size, pg_num=pg_num,
                              created_pg_num=pg_num,
                              crush_rule=rule_id,
                              erasure_code_profile=prof_name,
                              stripe_width=stripe_width,
                              ec_overwrites=False,
                              fast_read=self.conf[
                                  "osd_pool_default_ec_fast_read"])
                inc = self._pending()
                inc.new_crush = crush
                inc.new_pools[pid] = pool
                self._commit(inc)
        else:
            size = int(cmd.get("size", self.conf["osd_pool_default_size"]))
            if size == 1 and not self.conf["mon_allow_pool_size_one"]:
                return (-1, "pool size 1 forbidden by "
                            "mon_allow_pool_size_one=false", {})
            guard = _pg_guard(size)
            if guard is not None:
                return guard
            min_size = int(cmd.get("min_size") or
                           self.conf["osd_pool_default_min_size"] or
                           max(1, size - size // 2))
            with self.lock:
                crush = self.osdmap.crush
                default_rule = self.conf[
                    "osd_pool_default_crush_rule"] or "replicated_rule"
                try:
                    rule_id = crush.rule_id(cmd.get("rule",
                                                    default_rule))
                except KeyError:
                    return (-2, "no such crush rule", {})
                pool = PGPool(name=name, pool_id=pid,
                              type=POOL_TYPE_REPLICATED, size=size,
                              min_size=min_size, pg_num=pg_num,
                              created_pg_num=pg_num,
                              crush_rule=rule_id)
                inc = self._pending()
                inc.new_pools[pid] = pool
                self._commit(inc)
        return (0, f"pool '{name}' created", {"pool_id": pid})

    # ------------------------------------------------------------------
    # mgr module control plane (reference MonCommands.h `mgr module
    # enable|disable|ls` -> MgrMonitor editing the MgrMap's module
    # list; here the list is the mgr_enabled_modules central-config
    # option, so every mgr converges off the next map)
    # ------------------------------------------------------------------
    def _mgr_modules(self) -> list:
        return self.conf["mgr_enabled_modules"].split()

    def _set_mgr_modules(self, mods: list):
        val = " ".join(mods)
        self.conf.set("mgr_enabled_modules", val)
        with self.lock:
            inc = self._pending()
            inc.new_config["mgr_enabled_modules"] = val
            self._commit(inc)

    def _cmd_mgr_module_enable(self, cmd: dict):
        name = cmd.get("module", "")
        from ..mgr.modules import discover
        if name not in discover():
            return (-2, f"no such module {name!r} "
                    f"(available: {sorted(discover())})", {})
        mods = self._mgr_modules()
        if name in mods:
            return (0, f"module {name} already enabled", {})
        self._set_mgr_modules(mods + [name])
        return (0, f"module {name} enabled", {})

    def _cmd_mgr_module_disable(self, cmd: dict):
        name = cmd.get("module", "")
        mods = self._mgr_modules()
        if name not in mods:
            return (0, f"module {name} not enabled", {})
        self._set_mgr_modules([m for m in mods if m != name])
        return (0, f"module {name} disabled", {})

    def _cmd_mgr_module_ls(self, cmd: dict):
        from ..mgr.modules import discover
        enabled = self._mgr_modules()
        return (0, "", {"enabled": enabled,
                        "available": sorted(discover())})

    def _mds_fill_ranks_locked(self) -> bool:
        """Assign unfilled ranks 0..max_mds-1 from the standby queue
        (reference MDSMonitor::maybe_promote_standby); -> changed."""
        m = self.mds_map
        changed = False
        for r in range(int(m.get("max_mds", 1))):
            key = str(r)
            if m["actives"].get(key) is None and m["standbys"]:
                m["actives"][key] = m["standbys"].pop(0)
                changed = True
        # ranks past a lowered max_mds drain back to standby
        for key in sorted(m["actives"]):
            if int(key) >= int(m.get("max_mds", 1)):
                name = m["actives"].pop(key)
                if name is not None and name not in m["standbys"]:
                    m["standbys"].append(name)
                changed = True
        if m.get("active") != m["actives"].get("0"):
            m["active"] = m["actives"].get("0")
            changed = True
        return changed

    def _mds_role_of_locked(self, name: str):
        for key, holder in self.mds_map["actives"].items():
            if holder == name:
                return int(key)
        return None

    def _cmd_mds_beacon(self, cmd: dict):
        """MDS liveness + rank assignment (reference MDSMonitor
        beacon handling): beacons fill unheld ranks up to max_mds in
        arrival order; the rest queue as standbys; the tick promotes
        on beacon-grace expiry.  The reply tells the daemon its rank
        and the subtree pin table it must route by."""
        name = cmd.get("name", "")
        addr = tuple(cmd.get("addr", ())) or None
        if not name or addr is None:
            return (-22, "need name + addr", {})
        with self.lock:
            m = self.mds_map
            self._mds_beacons[name] = time.monotonic()
            changed = m["addrs"].get(name) != list(addr)
            m["addrs"][name] = list(addr)
            if self._mds_role_of_locked(name) is None and \
                    name not in m["standbys"]:
                m["standbys"].append(name)
                changed = True
            changed |= self._mds_fill_ranks_locked()
            if changed:
                m["epoch"] += 1
                self.store.put_raw("mdsmap", m)
            rank = self._mds_role_of_locked(name)
            role = "active" if rank is not None else "standby"
            return (0, role, {
                "role": role, "rank": rank, "epoch": m["epoch"],
                "max_mds": int(m.get("max_mds", 1)),
                "pins": dict(m.get("pins", {})),
                "actives": {k: m["addrs"].get(v)
                            for k, v in m["actives"].items()
                            if v is not None}})

    def _cmd_mds_getmap(self, cmd: dict):
        with self.lock:
            m = self.mds_map
            return (0, "", {
                "epoch": m["epoch"], "active": m["active"],
                "addr": m["addrs"].get(m["active"]),
                "standbys": list(m["standbys"]),
                "max_mds": int(m.get("max_mds", 1)),
                "pins": dict(m.get("pins", {})),
                "actives": {k: m["addrs"].get(v)
                            for k, v in m["actives"].items()
                            if v is not None}})

    def _cmd_fs_set(self, cmd: dict):
        """fs set max_mds <n> (reference MDSMonitor fs set): raise or
        lower the active rank count; standbys fill new ranks on the
        spot or at their next beacon."""
        var = cmd.get("var", "")
        if var != "max_mds":
            return (-22, f"unknown fs var {var!r}", {})
        try:
            n = int(cmd.get("val", ""))
        except ValueError:
            return (-22, "max_mds must be an integer", {})
        if not 1 <= n <= 64:
            return (-22, "max_mds must be in [1, 64]", {})
        with self.lock:
            m = self.mds_map
            # pins to ranks being removed would strand their subtrees
            for path, r in m.get("pins", {}).items():
                if int(r) >= n:
                    return (-22, f"pin {path!r} -> rank {r} blocks "
                            f"shrinking max_mds to {n}; unpin first",
                            {})
            m["max_mds"] = n
            self._mds_fill_ranks_locked()
            m["epoch"] += 1
            self.store.put_raw("mdsmap", m)
            return (0, f"max_mds = {n}", {"epoch": m["epoch"]})

    def _cmd_fs_pin(self, cmd: dict):
        """fs pin <path> <rank> (static analog of reference
        ceph.dir.pin): the subtree rooted at path is served by that
        rank; rank -1 removes the pin.  Root ("/") stays rank 0."""
        path = cmd.get("path", "")
        if not path.startswith("/"):
            return (-22, "pin path must be absolute", {})
        path = "/" + path.strip("/")
        if path == "/":
            return (-22, "the root is always rank 0; pin a subtree",
                    {})
        try:
            rank = int(cmd.get("rank", ""))
        except ValueError:
            return (-22, "rank must be an integer", {})
        with self.lock:
            m = self.mds_map
            if rank < 0:
                m.get("pins", {}).pop(path, None)
            else:
                if rank >= int(m.get("max_mds", 1)):
                    return (-22, f"rank {rank} >= max_mds "
                            f"{m.get('max_mds', 1)}", {})
                m.setdefault("pins", {})[path] = rank
            m["epoch"] += 1
            self.store.put_raw("mdsmap", m)
            return (0, f"pinned {path} -> {rank}"
                    if rank >= 0 else f"unpinned {path}",
                    {"epoch": m["epoch"]})

    def _mds_tick(self) -> None:
        """Fail over beacon-silent rank holders to the freshest
        standbys (reference MDSMonitor::tick beacon grace), one rank
        at a time per silent daemon."""
        grace = self.conf["mds_beacon_grace"] * \
            self.conf["mon_mds_beacon_grace_factor"]
        now = time.monotonic()
        with self.lock:
            m = self.mds_map
            changed = False
            for name in list(m["standbys"]):
                if now - self._mds_beacons.get(name, 0) > grace:
                    m["standbys"].remove(name)
                    m["addrs"].pop(name, None)
                    changed = True
            for key in sorted(m["actives"]):
                holder = m["actives"][key]
                if holder is not None and \
                        now - self._mds_beacons.get(holder, 0) > grace:
                    m["addrs"].pop(holder, None)
                    m["actives"][key] = None
                    self.log.dout(1, f"mds {holder} beacon-silent "
                                  f"> {grace}s: rank {key} open")
                    changed = True
            changed |= self._mds_fill_ranks_locked()
            if changed:
                m["epoch"] += 1
                self.store.put_raw("mdsmap", m)

    def _cmd_pool_set(self, cmd: dict):
        """osd pool set <pool> <var> <val> (reference
        OSDMonitor::prepare_command_pool_set); the variable the EC
        tests rely on is allow_ec_overwrites."""
        with self.lock:
            pool = self.osdmap.get_pool(cmd["pool"])
            if pool is None:
                return (-2, f"no pool {cmd['pool']}", {})
            var, val = cmd["var"], str(cmd.get("val", ""))
            import copy as _copy
            newpool = _copy.deepcopy(pool)
            if var == "allow_ec_overwrites":
                if not pool.is_erasure():
                    return (-22, "pool is not erasure", {})
                newpool.ec_overwrites = val.lower() in ("1", "true",
                                                        "yes")
            elif var == "fast_read":
                if not pool.is_erasure():
                    return (-22, "fast_read is an erasure-pool "
                            "option", {})
                newpool.fast_read = val.lower() in ("1", "true",
                                                    "yes")
            elif var == "size":
                newpool.size = int(val)
            elif var == "min_size":
                newpool.min_size = int(val)
            elif var == "pg_num":
                # live pg_num growth -> OSD-side PG split; decrease ->
                # PG merge, children folding back into their split
                # parents (reference OSDMonitor pg_num(_pending) +
                # OSD merge_pgs, osd/OSD.cc:329-422)
                n = int(val)
                if n < 1:
                    return (-22, "pg_num must be >= 1", {})
                if n > 65536:
                    return (-22, "pg_num too large", {})
                if n < pool.pg_num:
                    # merge only from a healthy baseline (the
                    # reference's pg_num_pending holds the decrease
                    # until sources and targets are ready): every
                    # holder then rebases the child log onto an
                    # identical parent log, keeping the merge
                    # deterministic cluster-wide
                    if n * 2 < pool.pg_num:
                        # at most halving per step: one child per
                        # parent, so no two holders ever rebase
                        # DIFFERENT children onto the same parent
                        # versions (the reference likewise merges
                        # stepwise)
                        return (-22, f"pg_num can at most halve per "
                                f"step (>= {(pool.pg_num + 1) // 2})",
                                {})
                    health = self._health_summary_locked()
                    all_up = all(i.up for i in
                                 self.osdmap.osds.values())
                    if not health.get("all_clean") or not all_up:
                        return (-16, "pg_num decrease requires a "
                                "clean cluster with all OSDs up", {})
                    # every child's data must be reachable from its
                    # parent's acting set (a child held ONLY by
                    # strays would never enter the authoritative log
                    # and the stray purge would drop the last copies)
                    from ..osd.osdmap import pg_split_source
                    for c_seed in range(n, pool.pg_num):
                        t = pg_split_source(c_seed, n)
                        _, _, c_act, _ = \
                            self.osdmap.pg_to_up_acting_osds(
                                PGid(pool.pool_id, c_seed))
                        _, _, p_act, _ = \
                            self.osdmap.pg_to_up_acting_osds(
                                PGid(pool.pool_id, t))
                        if not (set(o for o in c_act if o is not None)
                                & set(o for o in p_act
                                      if o is not None)):
                            return (-16, f"child pg {c_seed:x} shares "
                                    f"no OSD with parent {t:x}; "
                                    f"reweight first", {})
                newpool.pg_num = n
                if n < pool.created_pg_num:
                    # keep the stray/ancestor algebra sound when the
                    # pool shrinks below its creation size
                    newpool.created_pg_num = n
            elif var == "target_max_objects":
                newpool.target_max_objects = int(val)
            elif var == "target_max_bytes":
                newpool.target_max_bytes = int(val)
            elif var == "cache_target_dirty_ratio":
                newpool.cache_target_dirty_ratio = float(val)
            else:
                return (-22, f"unknown pool var {var}", {})
            inc = self._pending()
            if var == "pg_num":
                # every holder rebases merge logs at THIS epoch, so a
                # late merger (revived OSD) lands BEHIND the cluster
                # and ordinary catch-up corrects it
                newpool.pg_num_epoch = inc.epoch
            inc.new_pools[pool.pool_id] = newpool
            self._commit(inc)
        return (0, "set", {})

    # ------------------------------------------------------------------
    # cache tiering control plane (reference OSDMonitor "osd tier *"
    # commands -> pg_pool_t tier_of/read_tier/write_tier/cache_mode,
    # consumed by PrimaryLogPG::maybe_handle_cache_detail,
    # PrimaryLogPG.cc:2700)
    # ------------------------------------------------------------------
    def _two_pools(self, cmd: dict):
        base = self.osdmap.get_pool(cmd.get("pool", ""))
        tier = self.osdmap.get_pool(cmd.get("tierpool", ""))
        if base is None or tier is None:
            return None, None, (-2, "no such pool", {})
        return base, tier, None

    def _cmd_tier_add(self, cmd: dict):
        with self.lock:
            base, tier, err = self._two_pools(cmd)
            if err:
                return err
            if tier.is_tier():
                return (-22, f"{tier.name} is already a tier", {})
            if tier.has_tiers() or base.is_tier():
                return (-22, "nested tiers are not supported", {})
            if tier.is_erasure():
                return (-22, "an erasure pool cannot be a cache tier "
                        "(omap/promote need replicated)", {})
            import copy as _copy
            newtier = _copy.deepcopy(tier)
            newtier.tier_of = base.pool_id
            inc = self._pending()
            inc.new_pools[tier.pool_id] = newtier
            self._commit(inc)
        return (0, f"pool {tier.name} is now a tier of {base.name}", {})

    def _cmd_tier_cache_mode(self, cmd: dict):
        mode = cmd.get("mode", "")
        if mode not in ("none", "writeback", "readonly"):
            return (-22, f"bad cache mode {mode!r}", {})
        with self.lock:
            tier = self.osdmap.get_pool(cmd.get("tierpool", ""))
            if tier is None:
                return (-2, "no such pool", {})
            if not tier.is_tier():
                return (-22, f"{tier.name} is not a tier", {})
            import copy as _copy
            newtier = _copy.deepcopy(tier)
            newtier.cache_mode = mode
            inc = self._pending()
            inc.new_pools[tier.pool_id] = newtier
            self._commit(inc)
        return (0, f"cache mode {mode}", {})

    def _cmd_tier_set_overlay(self, cmd: dict):
        with self.lock:
            base, tier, err = self._two_pools(cmd)
            if err:
                return err
            if tier.tier_of != base.pool_id:
                return (-22, f"{tier.name} is not a tier of "
                        f"{base.name}", {})
            if tier.cache_mode == "none":
                return (-22, "set a cache-mode first", {})
            import copy as _copy
            newbase = _copy.deepcopy(base)
            newbase.read_tier = tier.pool_id
            # a readonly tier serves READS only: writes must keep
            # going to the base directly (routing them into the tier
            # would make the base pool permanently unwritable)
            newbase.write_tier = tier.pool_id \
                if tier.cache_mode == "writeback" else -1
            inc = self._pending()
            inc.new_pools[base.pool_id] = newbase
            self._commit(inc)
        return (0, f"overlay for {base.name} is {tier.name}", {})

    def _cmd_tier_remove_overlay(self, cmd: dict):
        with self.lock:
            base = self.osdmap.get_pool(cmd.get("pool", ""))
            if base is None:
                return (-2, "no such pool", {})
            import copy as _copy
            newbase = _copy.deepcopy(base)
            newbase.read_tier = -1
            newbase.write_tier = -1
            inc = self._pending()
            inc.new_pools[base.pool_id] = newbase
            self._commit(inc)
        return (0, f"overlay for {base.name} removed", {})

    def _cmd_tier_remove(self, cmd: dict):
        with self.lock:
            base, tier, err = self._two_pools(cmd)
            if err:
                return err
            if tier.tier_of != base.pool_id:
                return (-22, f"{tier.name} is not a tier of "
                        f"{base.name}", {})
            if base.read_tier == tier.pool_id or \
                    base.write_tier == tier.pool_id:
                return (-16, "remove the overlay first", {})  # EBUSY
            import copy as _copy
            newtier = _copy.deepcopy(tier)
            newtier.tier_of = -1
            newtier.cache_mode = "none"
            inc = self._pending()
            inc.new_pools[tier.pool_id] = newtier
            self._commit(inc)
        return (0, f"pool {tier.name} is no longer a tier", {})

    def _cmd_snap_create(self, cmd: dict):
        """osd pool selfmanaged-snap create <pool> -> new snap id
        (reference OSDMonitor prepare_pool_op SELFMANAGED_SNAP_CREATE:
        allocates from the pool's snap_seq)."""
        with self.lock:
            pool = self.osdmap.get_pool(cmd["pool"])
            if pool is None:
                return (-2, f"no pool {cmd['pool']}", {})
            import copy as _copy
            newpool = _copy.deepcopy(pool)
            newpool.snap_seq += 1
            inc = self._pending()
            inc.new_pools[pool.pool_id] = newpool
            self._commit(inc)
            return (0, "", {"snapid": newpool.snap_seq})

    def _cmd_snap_rm(self, cmd: dict):
        """osd pool selfmanaged-snap rm <pool> <snapid> (reference
        SELFMANAGED_SNAP_DELETE -> pool removed_snaps; OSDs trim)."""
        with self.lock:
            pool = self.osdmap.get_pool(cmd["pool"])
            if pool is None:
                return (-2, f"no pool {cmd['pool']}", {})
            snapid = int(cmd["snapid"])
            if snapid <= 0 or snapid > pool.snap_seq:
                return (-2, f"no snap {snapid}", {})
            import copy as _copy
            newpool = _copy.deepcopy(pool)
            if snapid not in newpool.removed_snaps:
                newpool.removed_snaps.append(snapid)
                newpool.removed_snaps.sort()
            inc = self._pending()
            inc.new_pools[pool.pool_id] = newpool
            self._commit(inc)
            return (0, f"removed snap {snapid}", {})

    def _cmd_pool_mksnap(self, cmd: dict):
        """osd pool mksnap <pool> <snapname> (reference
        prepare_pool_op CREATE_SNAP — pool-wide named snaps)."""
        with self.lock:
            pool = self.osdmap.get_pool(cmd["pool"])
            if pool is None:
                return (-2, f"no pool {cmd['pool']}", {})
            name = cmd["snap"]
            if name in pool.pool_snaps:
                return (-17, f"snap {name} exists", {})
            import copy as _copy
            newpool = _copy.deepcopy(pool)
            newpool.snap_seq += 1
            newpool.pool_snaps[name] = newpool.snap_seq
            inc = self._pending()
            inc.new_pools[pool.pool_id] = newpool
            self._commit(inc)
            return (0, f"created pool snap {name}",
                    {"snapid": newpool.snap_seq})

    def _cmd_pool_rmsnap(self, cmd: dict):
        with self.lock:
            pool = self.osdmap.get_pool(cmd["pool"])
            if pool is None:
                return (-2, f"no pool {cmd['pool']}", {})
            name = cmd["snap"]
            if name not in pool.pool_snaps:
                return (-2, f"no snap {name}", {})
            import copy as _copy
            newpool = _copy.deepcopy(pool)
            snapid = newpool.pool_snaps.pop(name)
            if snapid not in newpool.removed_snaps:
                newpool.removed_snaps.append(snapid)
                newpool.removed_snaps.sort()
            inc = self._pending()
            inc.new_pools[pool.pool_id] = newpool
            self._commit(inc)
            return (0, f"removed pool snap {name}", {})

    def _cmd_pool_delete(self, cmd: dict):
        if not self.conf["mon_allow_pool_delete"]:
            # reference mon_allow_pool_delete guard
            return (-1, "pool deletion is disabled; set "
                        "mon_allow_pool_delete = true", {})
        with self.lock:
            pool = self.osdmap.get_pool(cmd["pool"])
            if pool is None:
                return (-2, f"no pool {cmd['pool']}", {})
            inc = self._pending()
            inc.old_pools.append(pool.pool_id)
            self._commit(inc)
        return (0, f"pool {cmd['pool']} removed", {})

    def _cmd_pool_ls(self, cmd: dict):
        with self.lock:
            return (0, "", {"pools": [p.name for p in
                                      self.osdmap.pools.values()]})

    # -- osd state (reference OSDMonitor out/in/down handlers) ----------
    def _osd_ids(self, cmd: dict) -> List[int]:
        ids = cmd.get("ids", [])
        if isinstance(ids, (int, str)):
            ids = [ids]
        return [int(i) for i in ids]

    def _cmd_osd_out(self, cmd: dict):
        with self.lock:
            inc = self._pending()
            for osd in self._osd_ids(cmd):
                inc.new_weight[osd] = 0
            self._commit(inc)
        return (0, "marked out", {})

    def _cmd_osd_in(self, cmd: dict):
        with self.lock:
            inc = self._pending()
            for osd in self._osd_ids(cmd):
                inc.new_weight[osd] = 0x10000
            self._commit(inc)
        return (0, "marked in", {})

    def _cmd_osd_down(self, cmd: dict):
        with self.lock:
            inc = self._pending()
            for osd in self._osd_ids(cmd):
                if self.osdmap.is_up(osd):
                    inc.new_down.append(osd)
            self._commit(inc)
        return (0, "marked down", {})

    def _cmd_osd_dump(self, cmd: dict):
        with self.lock:
            return (0, "", self.osdmap.dump())

    def _cmd_osd_tree(self, cmd: dict):
        with self.lock:
            return (0, "", self.osdmap.crush.dump())

    def _cmd_status(self, cmd: dict):
        with self.lock:
            health = self._health_summary_locked()
            n_up = sum(1 for i in self.osdmap.osds.values() if i.up)
            n_in = sum(1 for i in self.osdmap.osds.values()
                       if i.weight > 0)
            return (0, "", {
                "health": health,
                "osdmap": {"epoch": self.osdmap.epoch,
                           "num_osds": len(self.osdmap.osds),
                           "num_up_osds": n_up, "num_in_osds": n_in},
                "pgmap": {"num_pgs": health["num_pgs"],
                          "pgs_by_state": health["pg_states"]},
            })

    def _cmd_health(self, cmd: dict):
        with self.lock:
            return (0, "", self._health_summary_locked())

    def _instruct_scrub(self, cmd: dict, deep: bool, repair: bool):
        """'pg scrub|deep-scrub|repair <pgid>': forward MOSDScrub to
        the PG's primary (reference MonCommands.h pg scrub ->
        OSDMonitor sending MOSDScrub to the lead OSD)."""
        try:
            pgid = PGid.parse(cmd["pgid"])
        except (KeyError, ValueError) as e:
            return (-22, f"bad pgid: {e}", {})
        with self.lock:
            pool = self.osdmap.pools.get(pgid.pool)
            if pool is None:
                return (-2, f"no pool {pgid.pool}", {})
            if pgid.seed >= pool.pg_num:
                return (-2, f"pg {pgid} does not exist "
                        f"(pool has {pool.pg_num} pgs)", {})
            _, primary, _, _ = self.osdmap.pg_to_up_acting_osds(pgid)
            conn = (self.osd_conns.get(primary)
                    if primary is not None else None)
        if primary is None:
            return (-11, f"pg {pgid} has no up primary", {})
        if conn is None:
            # the primary's mon session lives on another mon (OSDs
            # session to one mon each): bounce the client to the
            # leader, the usual session holder
            addr = self.quorum.leader_addr()
            if not self.quorum.is_leader() and addr is not None:
                return (REDIRECT_RETCODE,
                        f"no session with osd.{primary} here; retry "
                        f"at mon.{self.quorum.leader}",
                        {"leader": list(addr)})
            return (-11, f"no mon session with osd.{primary}", {})
        conn.send_message(MOSDScrub(
            pgid=str(pgid), deep=deep, repair=repair))
        verb = ("repair" if repair else
                "deep-scrub" if deep else "scrub")
        return (0, f"instructing pg {pgid} on osd.{primary} to {verb}",
                {})

    def _cmd_pg_scrub(self, cmd: dict):
        return self._instruct_scrub(cmd, deep=False, repair=False)

    def _cmd_pg_deep_scrub(self, cmd: dict):
        return self._instruct_scrub(cmd, deep=True, repair=False)

    def _cmd_pg_repair(self, cmd: dict):
        return self._instruct_scrub(cmd, deep=True, repair=True)

    def _cmd_pg_stat(self, cmd: dict):
        with self.lock:
            return (0, "", {"pg_stats": dict(self.pg_stats)})

    def _cmd_pg_dump(self, cmd: dict):
        with self.lock:
            return (0, "", {
                "pg_stats": dict(self.pg_stats),
                "reported_by": dict(self.pg_stats_from)})

    # -- auth (reference AuthMonitor handlers, mon/MonCommands.h auth) --
    @staticmethod
    def _parse_caps(items: List[str]) -> Dict[str, str]:
        """['mon', 'allow *', 'osd', 'allow rwx'] -> caps map (the
        reference's pairwise caps syntax)."""
        if len(items) % 2:
            raise ValueError("caps must be <service> <spec> pairs")
        return {items[i]: items[i + 1] for i in range(0, len(items), 2)}

    def _commit_keyring(self) -> None:
        """Replicate a keyring mutation: an (otherwise empty) map
        epoch bump carries the full keyring through paxos — peons and
        a future leader keep the same credentials (reference
        AuthMonitor's paxos-versioned KeyServerData)."""
        with self.lock:
            self._commit(self._pending())

    def _cmd_auth_get_or_create(self, cmd: dict):
        caps = self._parse_caps(cmd.get("caps", []))
        with self.lock:
            ent = self.keyring.get_or_create(cmd["entity"], caps)
            text = self.keyring.to_text(only=ent.name)
            dump = ent.dump()
        self._commit_keyring()
        return (0, text, dump)

    def _cmd_auth_get(self, cmd: dict):
        with self.lock:
            ent = self.keyring.get(cmd["entity"])
            if ent is None:
                return (-2, f"no such entity {cmd['entity']!r}", {})
            return (0, self.keyring.to_text(only=ent.name), ent.dump())

    def _cmd_auth_ls(self, cmd: dict):
        with self.lock:
            return (0, self.keyring.to_text(),
                    {"entities": self.keyring.dump()})

    def _cmd_auth_rm(self, cmd: dict):
        with self.lock:
            if not self.keyring.remove(cmd["entity"]):
                return (-2, f"no such entity {cmd['entity']!r}", {})
        self._commit_keyring()
        return (0, "updated", {})

    def _cmd_auth_print_key(self, cmd: dict):
        with self.lock:
            ent = self.keyring.get(cmd["entity"])
        if ent is None:
            return (-2, f"no such entity {cmd['entity']!r}", {})
        return (0, ent.key, {"key": ent.key})

    def _cmd_config_set(self, cmd: dict):
        """Central config (reference ConfigMonitor): the override is
        validated locally, then replicated to every daemon by riding
        the next map epoch — daemons apply it on publish and their
        config observers fire."""
        try:
            self.conf.set(cmd["name"], cmd["value"])
        except (KeyError, ValueError) as e:
            return (-22, str(e), {})
        with self.lock:
            inc = self._pending()
            inc.new_config[cmd["name"]] = str(cmd["value"])
            self._commit(inc)
        return (0, "", {})

    def _cmd_config_rm(self, cmd: dict):
        with self.lock:
            inc = self._pending()
            inc.old_config.append(cmd["name"])
            self._commit(inc)
        return (0, "", {})

    def _cmd_config_get(self, cmd: dict):
        try:
            return (0, "", {"value": self.conf.get(cmd["name"])})
        except KeyError as e:
            return (-2, str(e), {})

    COMMANDS = {
        "osd erasure-code-profile set": _cmd_profile_set,
        "osd erasure-code-profile get": _cmd_profile_get,
        "osd erasure-code-profile ls": _cmd_profile_ls,
        "osd erasure-code-profile rm": _cmd_profile_rm,
        "osd pool create": _cmd_pool_create,
        "osd pool set": _cmd_pool_set,
        "mds beacon": _cmd_mds_beacon,
        "mds getmap": _cmd_mds_getmap,
        "fs set": _cmd_fs_set,
        "fs pin": _cmd_fs_pin,
        "osd pool delete": _cmd_pool_delete,
        "mgr module enable": _cmd_mgr_module_enable,
        "mgr module disable": _cmd_mgr_module_disable,
        "mgr module ls": _cmd_mgr_module_ls,
        "osd tier add": _cmd_tier_add,
        "osd tier cache-mode": _cmd_tier_cache_mode,
        "osd tier set-overlay": _cmd_tier_set_overlay,
        "osd tier remove-overlay": _cmd_tier_remove_overlay,
        "osd tier remove": _cmd_tier_remove,
        "osd pool ls": _cmd_pool_ls,
        "osd pool selfmanaged-snap create": _cmd_snap_create,
        "osd pool selfmanaged-snap rm": _cmd_snap_rm,
        "osd pool mksnap": _cmd_pool_mksnap,
        "osd pool rmsnap": _cmd_pool_rmsnap,
        "osd out": _cmd_osd_out,
        "osd in": _cmd_osd_in,
        "osd down": _cmd_osd_down,
        "osd dump": _cmd_osd_dump,
        "osd tree": _cmd_osd_tree,
        "status": _cmd_status,
        "health": _cmd_health,
        "pg stat": _cmd_pg_stat,
        "pg dump": _cmd_pg_dump,
        "pg scrub": _cmd_pg_scrub,
        "pg deep-scrub": _cmd_pg_deep_scrub,
        "pg repair": _cmd_pg_repair,
        "config set": _cmd_config_set,
        "config rm": _cmd_config_rm,
        "config get": _cmd_config_get,
        "auth get-or-create": _cmd_auth_get_or_create,
        "auth get": _cmd_auth_get,
        "auth ls": _cmd_auth_ls,
        "auth rm": _cmd_auth_rm,
        "auth print-key": _cmd_auth_print_key,
    }

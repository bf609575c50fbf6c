"""OSD daemon — hosts PGs, serves clients, heartbeats peers.

Python-native equivalent of the reference's OSD/OSDService (reference
src/osd/OSD.{h,cc} 10.8k LoC) reduced to the daemon duties the
framework's PG/backend stack needs:

* **boot** (reference OSD::init :3262 + _send_boot): mount the store,
  subscribe to osdmaps, announce ourselves to the monitor (MOSDBoot);
  restart is resume — PGs reload their logs from the store when the
  first map arrives;
* **map handling** (reference handle_osd_map :7753 +
  handle_advance_map): every published epoch advances all hosted PGs;
  PGs are instantiated on demand for any pool whose CRUSH mapping
  places a shard here (reference load_pgs / handle_pg_create);
* **op dispatch** (reference ms_fast_dispatch :7008 -> enqueue_op
  :9612 -> op_shardedwq): client MOSDOps land in a sharded op queue
  (``osd_op_num_shards`` × ``osd_op_num_threads_per_shard`` workers,
  reference common/options.cc:2869-2901) hashed by PG so per-PG order
  holds — **this queue is the gpu plugin's batching point**: stripes from many in-flight ops on different PGs gather into
  one device call; backend sub-ops fast-dispatch inline (reference
  fast dispatch bypasses the queue for sub-ops);
* **heartbeats + failure reports** (reference OSD.cc:5079-5632): ping
  every up peer on an interval; a peer silent past
  ``osd_heartbeat_grace`` is reported to the monitor (MOSDFailure),
  which marks it down once enough distinct reporters agree;
* **recovery driving** (reference start_recovery_ops + recovery wq):
  a background thread drains primary PGs' missing sets through their
  backends, ``osd_recovery_max_active`` object recoveries at a time;
* **PG stats** (reference MPGStats tick): primaries report per-PG
  state to the monitor, feeding ``status``/``wait_for_clean``.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from ..ec import registry as ec_registry
from ..mon.client import MonClient
from ..msg.messages import (MCommand, MCommandReply, MOSDECSubOpRead,
                            MOSDECSubOpReadReply, MOSDECSubOpWrite,
                            MOSDECSubOpWriteReply, MOSDMap, MOSDOp,
                            MOSDPGLog, MOSDPGNotify, MOSDPGPull,
                            MOSDPGPush, MOSDPGPushReply, MOSDPGQuery,
                            MOSDPGRemove,
                            MOSDPing, MOSDRepOp, MOSDRepOpReply,
                            MOSDScrub, MRepScrub, MRepScrubMap)
from ..msg.messenger import Connection, Dispatcher, Messenger
from ..store.objectstore import ObjectStore
from ..utils.config import Config, default_config
from ..utils.lockdep import make_lock
from ..utils.log import Dout
from .osdmap import OSDMap, PGid
from .pg import PG, STATE_ACTIVE, STATE_PEERING

_BACKEND_MSGS = (MOSDECSubOpWrite, MOSDECSubOpWriteReply,
                 MOSDECSubOpRead, MOSDECSubOpReadReply,
                 MOSDRepOp, MOSDRepOpReply, MOSDPGPush,
                 MOSDPGPushReply, MOSDPGPull)
_PEERING_MSGS = (MOSDPGQuery, MOSDPGNotify, MOSDPGLog)


class OSDService:
    """The narrow service surface PGs and backends consume (reference
    OSDService in osd/OSD.h)."""

    def __init__(self, osd: "OSD"):
        self._osd = osd

    @property
    def whoami(self) -> int:
        return self._osd.whoami

    @property
    def conf(self) -> Config:
        return self._osd.conf

    @property
    def store(self) -> ObjectStore:
        return self._osd.store

    @property
    def ec_registry(self):
        return self._osd.ec_registry

    @property
    def encode_batcher(self):
        return self._osd.encode_batcher

    @property
    def tracer(self):
        return self._osd.tracer

    @property
    def perf(self):
        return self._osd.perf

    @property
    def flight_recorder(self):
        return self._osd.flight_recorder

    @property
    def hops(self):
        return self._osd.hops

    @property
    def hops_read(self):
        return self._osd.hops_read

    @property
    def hops_recovery(self):
        return self._osd.hops_recovery

    @property
    def slo(self):
        return self._osd.slo

    @property
    def contention(self):
        return self._osd.contention

    def call_later(self, delay: float, fn):
        """Cancellable one-shot timer (EC sub-write deadlines); the
        crimson OSD substitutes a reactor timer."""
        return self._osd._call_later(delay, fn)

    def report_laggard(self, osd: int, elapsed: float) -> None:
        self._osd.report_laggard(osd, elapsed)

    def get_osdmap(self) -> OSDMap:
        return self._osd.osdmap

    def send_osd(self, osd: int, msg) -> None:
        self._osd.send_osd(osd, msg)

    def pg_activated(self, pg: PG) -> None:
        self._osd.kick_recovery()

    def kick_recovery(self, pg: Optional[PG] = None) -> None:
        self._osd.kick_recovery()

    def objecter_ioctx(self, pool_id: int, bypass_tier: bool = True):
        return self._osd.objecter_ioctx(pool_id, bypass_tier)

    def ensure_pg(self, pgid) -> Optional[PG]:
        """Get-or-create a local PG instance regardless of acting-set
        membership (split children are created on the parent's holders
        even when they are strays there)."""
        return self._osd._ensure_pg(pgid, self._osd.osdmap)

    def forget_pg(self, pgid) -> None:
        """Drop a purged stray PG from the local registry."""
        with self._osd.pg_lock:
            self._osd.pgs.pop(pgid, None)


class OSD(Dispatcher):
    """One object-storage daemon (reference ceph_osd.cc + OSD.cc)."""

    def __init__(self, whoami: int, store: ObjectStore,
                 mon_addr: Tuple[str, int],
                 conf: Optional[Config] = None,
                 addr: Tuple[str, int] = ("127.0.0.1", 0)):
        self.whoami = whoami
        self.store = store
        self.conf = conf or default_config()
        self.log = Dout("osd", f"osd.{whoami} ")
        self.ec_registry = ec_registry.instance()
        self.ec_registry.preload_from_conf(self.conf)
        self.osdmap = OSDMap()
        self.map_lock = make_lock("osd.map")
        self.pgs: Dict[PGid, PG] = {}
        self.pg_lock = make_lock("osd.pgs")
        self.service = OSDService(self)
        self.msgr = self._make_messenger()
        self.my_addr = self.msgr.bind(addr)
        self.msgr.add_dispatcher(self)
        self.monc = MonClient(self.msgr, mon_addr,
                              map_cb=self._on_map_published)
        self._mon_addr = mon_addr
        self._int_client = None          # lazy internal objecter
                                         # (copy_from, cache tiering)
        self._int_client_lock = threading.Lock()
        # sharded op queue (reference op_shardedwq, OSD.h:1287) with
        # mClock-style QoS per shard (reference osd/scheduler/): the
        # client/recovery/scrub classes stop sharing a plain FIFO
        from .scheduler import OpScheduler, qos_from_conf
        self._n_shards = self.conf["osd_op_num_shards"]
        fifo = self.conf["osd_op_queue"] == "fifo"
        qos = {} if fifo else qos_from_conf(self.conf)
        hard = any(lim > 0 for _, _, lim in qos.values())
        self._shard_queues: List[OpScheduler] = [
            OpScheduler(qos, hard_limits=hard, fifo=fifo)
            for _ in range(self._n_shards)]
        # sustained-growth detector for the OP_QUEUE_BACKLOG health
        # check: consecutive ticks the client class got deeper
        self._opq_last_depth = 0
        self._opq_growth_ticks = 0
        self._workers: List[threading.Thread] = []
        self._stop = threading.Event()
        self._recovery_kick = threading.Event()
        # heartbeat state: peer -> last reply time (reference
        # HeartbeatInfo, OSD.h)
        self._hb_last_rx: Dict[int, float] = {}
        self._hb_reported: Dict[int, float] = {}
        self._threads: List[threading.Thread] = []
        # observability (reference l_osd_* counters OSD.cc:9630 +
        # OpTracker dump_historic_ops OSD.cc:2457)
        from ..utils.optracker import OpTracker
        from ..utils.perf import PerfCountersCollection, TYPE_TIME_AVG
        self.perf_coll = PerfCountersCollection()
        self.perf = self.perf_coll.create("osd")
        self.perf.add("op", description="client operations")
        self.perf.add("op_w", description="client writes")
        self.perf.add("op_r", description="client reads")
        self.perf.add("op_in_bytes", description="client bytes written")
        self.perf.add("op_latency", TYPE_TIME_AVG,
                      "client op latency (dequeue to reply)")
        self.perf.add("op_w_latency", TYPE_TIME_AVG,
                      "client write latency")
        self.perf.add("op_r_latency", TYPE_TIME_AVG,
                      "client read latency")
        self.perf.add("subop", description="replica/shard sub-ops")
        self.perf.add("recovery_ops", description="objects recovered")
        self.perf.add("ec_batch_calls",
                      description="batched EC encode device calls")
        self.perf.add("ec_batch_stripes",
                      description="stripes encoded through the batcher")
        self.perf.add("ec_batch_coalesced",
                      description="write ops that shared a device call")
        self.perf.add("ec_dec_batch_calls",
                      description="batched EC decode calls")
        self.perf.add("ec_dec_batch_coalesced",
                      description="decode requests that shared a call")
        self.perf.add("ec_delta_batch_calls",
                      description="batched parity-delta (RMW) device "
                      "calls")
        self.perf.add("ec_delta_batch_coalesced",
                      description="delta requests that shared a call")
        self.perf.add("ec_subwrite_timeouts",
                      description="EC sub-write deadlines expired")
        self.perf.add("ec_subwrite_retries",
                      description="EC sub-writes re-requested from "
                      "laggard shards")
        self.perf.add("ec_subwrite_peer_reports",
                      description="laggard peers reported to the mon")
        # mClock scheduler telemetry: per-class queue
        # depth/served/deficit aggregated over this daemon's op-queue
        # shards.  Registered at boot on BOTH backends so the mgr
        # prometheus scrape carries the ceph_op_queue_* families
        # before any traffic; refreshed on every tick and perf dump.
        from ..utils.perf import TYPE_U64
        self.op_queue_perf = self.perf_coll.create("op_queue")
        from .scheduler import DEFAULT_QOS
        for cls_name in DEFAULT_QOS:
            self.op_queue_perf.add(
                f"{cls_name}_queued_now", TYPE_U64,
                f"{cls_name}-class ops queued across shards")
            self.op_queue_perf.add(
                f"{cls_name}_served",
                description=f"{cls_name}-class ops dequeued")
            self.op_queue_perf.add(
                f"{cls_name}_depth_hwm", TYPE_U64,
                f"max {cls_name}-class depth on any one shard")
            self.op_queue_perf.add(
                f"{cls_name}_deficit_now", TYPE_U64,
                f"{cls_name}-class weighted-fair deficit (sum)")
        # process-wide fault injection (utils/faults.py): arm the
        # registry from fault_injection/_seed; idempotent, so an OSD
        # restart mid-run keeps the sites' RNG streams
        from ..utils import faults as faultlib
        faultlib.configure_from(self.conf)
        # per-OSD hashed timer wheel: EC sub-write deadlines, recovery
        # pacing (one thread total; see utils/timer_wheel.py)
        from ..utils.timer_wheel import TimerWheel
        self.timer_wheel = TimerWheel()
        # per-OSD flight recorder: bounded ring of recent routing/
        # batcher/fault events, dumped via dump_flight_recorder and
        # auto-dumped on op timeout / breaker-open / client encode
        # error (utils/flight_recorder.py)
        from ..utils.flight_recorder import FlightRecorder
        self.flight_recorder = FlightRecorder(
            capacity=self.conf["flight_recorder_events"],
            name=f"osd.{whoami}")
        # lock/queue contention telemetry ("contention" subsystem):
        # the PG lock, batcher condition, store mutex and messenger
        # send queues report wait/hold/depth here; stalls over the
        # threshold leave a breadcrumb in the flight recorder
        from ..utils.locks import ContentionStats, TimedLock
        self.contention = ContentionStats(
            perf_coll=self.perf_coll, recorder=self.flight_recorder,
            stall_threshold_s=self.conf["contention_stall_threshold"])
        self.contention.register_queue("msgr_sendq")
        self.msgr.contention = self.contention
        # retrofit the store mutex; a restart on a surviving store
        # finds it already wrapped and just rebinds the sink
        st_lock = getattr(store, "_lock", None)
        if isinstance(st_lock, TimedLock):
            st_lock.bind(self.contention)
        elif st_lock is not None:
            store._lock = TimedLock("store_lock", stats=self.contention,
                                    inner=st_lock)
        # store-transaction ledger (utils/store_ledger.py): every
        # queue_transactions charges its wall to the phase waterfall
        # ("store" perf subsystem, dump_store command); a phase at or
        # over store_phase_stall_ms flight-records a store_stall and
        # rate-limit auto-dumps.  Idempotent across OSD restart on a
        # surviving store — accumulated history stays, the counters
        # rebind into this daemon's collection.
        self.store.attach_observability(
            perf_coll=self.perf_coll, recorder=self.flight_recorder,
            stall_threshold_s=self.conf["store_phase_stall_ms"] / 1e3)
        # cross-daemon hop-ledger accumulators: this OSD's view of
        # sub-op round trips, split by op class so the read/recovery
        # waterfall doesn't smear into the write one ("hops" = write
        # sub-ops, "hops_read" = client-facing shard reads,
        # "hops_recovery" = pushes/pulls + scrub windows; the client
        # owns the end-to-end MOSDOp views)
        from ..utils.hops import HopAccum
        self.hops = HopAccum(perf_coll=self.perf_coll)
        self.hops_read = HopAccum(perf_coll=self.perf_coll,
                                  subsystem="hops_read")
        self.hops_recovery = HopAccum(perf_coll=self.perf_coll,
                                      subsystem="hops_recovery")
        # cross-op device stripe coalescer (the batching point)
        from .batcher import EncodeBatcher
        self.encode_batcher = EncodeBatcher(
            self.conf, perf=self.perf, perf_coll=self.perf_coll,
            recorder=self.flight_recorder, contention=self.contention)
        # checksum offload: a deferred-checksum store (BlueStore)
        # folds its apply-batch CRCs through the codec backend's
        # GF-bitmatrix kernel when an accelerator is live; resolved
        # per batch because the batcher only learns its backend on
        # first device dispatch
        if hasattr(self.store, "attach_device_batcher"):
            self.store.attach_device_batcher(
                lambda: getattr(self.encode_batcher,
                                "_last_backend", None))
        # timer-wheel fire lag rides the batcher's ec_device
        # subsystem (one device-machinery surface); tick-scale lag is
        # normal, so only fires a full revolution late (a wedged
        # wheel thread) are flight-recorded
        _dperf = self.encode_batcher.dperf
        _wheel = self.timer_wheel
        _late_s = _wheel.tick_s * _wheel.slots

        def _note_fire_lag(lag, _dp=_dperf, _rec=self.flight_recorder,
                           _late=_late_s):
            if _dp is not None:
                _dp.hinc("timer_fire_lag_us", lag * 1e6)
            if lag > _late:
                _rec.note("timer", event="late_fire",
                          lag_ms=round(lag * 1e3, 3))
        self.timer_wheel.on_fire_lag = _note_fire_lag
        self.op_tracker = OpTracker(
            history_size=self.conf["osd_op_history_size"],
            history_duration=self.conf["osd_op_history_duration"],
            slow_op_warn_threshold=self.conf["osd_op_complaint_time"])
        # per-op critical-path analysis on every retired op: stage
        # budget + bounding-stage census, exported as the "critpath"
        # perf subsystem and the dump_critical_path command
        from ..utils.critpath import CriticalPathAccum
        self.critpath = CriticalPathAccum(perf_coll=self.perf_coll)
        # per-op-class SLO accounting (mgr/slo.py): client classes
        # feed from op retirement, recovery/scrub from their own
        # completion paths; both observers are chained post-reply and
        # must not raise
        from ..mgr.slo import SLOEngine
        self.slo = SLOEngine(conf=self.conf, perf_coll=self.perf_coll)

        def _on_retire(op, _cp=self.critpath.observe,
                       _slo=self.slo.observe_op):
            _cp(op)
            _slo(op)
        self.op_tracker.on_retire = _on_retire
        # decode device faults burn recovery-class budget even though
        # the CPU-twin fallback keeps the op itself successful
        self.encode_batcher.on_decode_fault = \
            lambda: self.slo.note_error("recovery")
        # closed-loop per-OSD tuner (utils/tuner.py):
        # a guarded hill-climb over the Option-marked tunable batcher
        # knobs, fed by the telemetry ladder (overlap engine, staging
        # stalls, contention stalls, SLO burn) from _maybe_tuner_tick.
        # Built even while osd_tuner_enable is off so the "tuner" perf
        # subsystem and dump_tuner exist on every daemon.
        from ..utils.tuner import Tuner, knobs_from_config
        tuner_knobs = []
        if hasattr(self.conf, "tunables"):
            tuner_knobs = knobs_from_config(
                self.conf,
                # seeds give the 0-means-auto knobs a real first step
                {"ec_tpu_queue_window_max_us": {"seed": 20000},
                 "ec_tpu_inflight_groups": {},
                 "ec_tpu_staging_depth": {},
                 "osd_ec_pipeline_segment_bytes": {"seed": 1 << 20}},
                pinned=self.conf["osd_tuner_pin"])
        self.tuner = Tuner(
            f"osd.{whoami}", tuner_knobs,
            hysteresis=self.conf["osd_tuner_hysteresis"],
            cooldown_ticks=self.conf["osd_tuner_cooldown_ticks"],
            blacklist_ticks=self.conf["osd_tuner_blacklist_ticks"],
            recorder=self.flight_recorder,
            perf_coll=self.perf_coll)
        self._tuner_ticks = 0
        self._tuner_last = (None, 0)     # (monotonic, reqs) objective
        self._tuner_last_overlap = None  # collapse-guard memory
        # live mClock retune seam: the mgr tuner module (or an
        # operator `config set`) changes an osd_mclock_scheduler_*
        # option; the central config rides the next map epoch into
        # this daemon's conf, whose observer pushes the new triples
        # into every RUNNING shard queue (OpScheduler.set_qos) — no
        # restart, no queue drain
        if hasattr(self.conf, "add_observer"):
            def _remclock(_name, _val):
                self._reapply_mclock()
            for _cls in ("client", "recovery", "scrub", "peering"):
                for _part in ("res", "wgt", "lim"):
                    self.conf.add_observer(
                        f"osd_mclock_scheduler_{_cls}_{_part}",
                        _remclock)
        from ..utils.tracer import Tracer
        self.tracer = Tracer(f"osd.{whoami}",
                             enabled=self.conf["osd_tracing"],
                             keep=self.conf["trace_keep_spans"])
        # optional unix-socket command surface (reference AdminSocket,
        # common/admin_socket.cc; the MCommand path stays primary)
        self.admin_socket = None
        sock_tmpl = self.conf["admin_socket"]
        if sock_tmpl:
            from string import Template
            from ..utils.admin_socket import AdminSocket
            path = Template(sock_tmpl).safe_substitute(
                name=f"osd.{whoami}")
            self.admin_socket = AdminSocket(path)
            for prefix in ("perf dump", "dump_traces",
                           "dump_historic_ops",
                           "dump_historic_slow_ops",
                           "dump_blocked_ops", "dump_ops_in_flight",
                           "dump_slow_ops", "dump_flight_recorder",
                           "dump_critical_path", "dump_hops",
                           "dump_slo", "dump_trace",
                           "dump_profile", "dump_device",
                           "dump_op_queue", "dump_tuner",
                           "dump_store",
                           "dump_health", "status",
                           "config get", "config set"):
                self.admin_socket.register(
                    prefix, self._admin_socket_hook)

    def _make_messenger(self) -> Messenger:
        """Messenger factory — the crimson OSD substitutes its
        reactor-driven messenger here."""
        return Messenger(f"osd.{self.whoami}", conf=self.conf)

    # -- sampling profiler lifecycle (utils/sampler.py) ----------------
    # refcounted: the process-wide sampler thread runs while any
    # daemon holds a reference and stops with the last release, so
    # cluster teardown leaves no sampler thread behind
    _sampler_held = False

    def _sampler_retain(self) -> None:
        hz = self.conf["osd_sampler_hz"]
        if hz <= 0 or self._sampler_held:
            return
        from ..utils.sampler import global_sampler
        global_sampler(hz=hz).retain()
        self._sampler_held = True

    def _sampler_release(self) -> None:
        if not self._sampler_held:
            return
        self._sampler_held = False
        from ..utils.sampler import global_sampler
        global_sampler().release()

    # ------------------------------------------------------------------
    # lifecycle (reference OSD::init)
    # ------------------------------------------------------------------
    def start(self) -> None:
        self._sampler_retain()
        self.msgr.start()
        for shard in range(self._n_shards):
            for t in range(self.conf["osd_op_num_threads_per_shard"]):
                w = threading.Thread(
                    target=self._op_worker, args=(shard,),
                    name=f"osd{self.whoami}-op-{shard}.{t}", daemon=True)
                w.start()
                self._workers.append(w)
        for target, name in ((self._recovery_loop, "recovery"),
                             (self._heartbeat_loop, "hb"),
                             (self._tick_loop, "tick")):
            t = threading.Thread(target=target,
                                 name=f"osd{self.whoami}-{name}",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        self.monc.subscribe_osdmap()
        self.monc.send_boot(self.whoami, self.my_addr)
        if self.admin_socket is not None:
            self.admin_socket.start()
        self.log.dout(1, f"booted, addr {self.my_addr}")

    def shutdown(self) -> None:
        self._stop.set()
        if self.admin_socket is not None:
            self.admin_socket.stop()
        self.encode_batcher.stop(
            drain=self.conf["osd_batcher_drain_timeout"])
        self.timer_wheel.stop()
        self._recovery_kick.set()
        for q in self._shard_queues:
            q.close()
        if self._int_client is not None:
            try:
                self._int_client.shutdown()
            except Exception:
                pass
        self.msgr.shutdown()
        for t in self._workers + self._threads:
            t.join(timeout=5)
        self._sampler_release()
        try:
            self.store.umount()
        except Exception:
            pass

    # ------------------------------------------------------------------
    # map handling (reference handle_osd_map :7753)
    # ------------------------------------------------------------------
    def _on_map_published(self, wire: dict) -> None:
        newmap = OSDMap.from_wire_dict(wire)
        with self.map_lock:
            if newmap.epoch <= self.osdmap.epoch:
                return
            oldmap, self.osdmap = self.osdmap, newmap
        for osd, info in newmap.osds.items():
            prev = oldmap.osds.get(osd)
            if osd != self.whoami and prev is not None and \
                    prev.addr is not None and info.addr != prev.addr:
                self.msgr.mark_down_restarted(f"osd.{osd}")
        # central config overrides ride the map (reference
        # ConfigMonitor -> MConfig): apply changes, REVERT removals,
        # observers fire either way
        from ..utils.config import apply_cluster_config_overrides
        self._applied_overrides = apply_cluster_config_overrides(
            self.conf, newmap.cluster_config,
            getattr(self, "_applied_overrides", {}))
        self._advance_pgs(newmap)
        # if the monitor thinks we're down (e.g. spurious failure
        # reports) but we're alive, re-boot (reference OSD re-sends
        # MOSDBoot when marked down while up)
        info = newmap.osds.get(self.whoami)
        if (info is None or not info.up) and not self._stop.is_set():
            self.monc.send_boot(self.whoami, self.my_addr)

    def _maybe_merge_collections(self, osdmap: OSDMap) -> None:
        """PG merge — the inverse of maybe_split (reference OSD
        merge tracking, osd/OSD.cc:329-422 + PG::merge_from): when a
        pool's pg_num SHRANK, collections whose seed is at or past the
        new pg_num fold their objects back into the split parent
        (pg_split_source).  Deterministic on every replica — all
        holders of a child move the same objects into the same parent
        collections (sorted order, so multi-child merges append log
        entries identically everywhere) — and the parent adopts the
        child's log rebased onto its own; peering catches up holders
        that had no child data.  EC chunks land at the holder's CHILD
        shard position, which may differ from its parent position:
        those serve as mispositioned recovery sources
        (extra_recovery_sources) while log recovery reconstructs the
        proper placement.  Runs on the STORE, not the PG objects, so
        merges pending from shrink-while-down complete on restart."""
        # cheap gate: scan the store only when some pool's pg_num
        # actually DECREASED since the last map we processed (or on
        # the first map after boot, covering shrink-while-down)
        prev = getattr(self, "_prev_pool_pgnums", None)
        cur = {pid: p.pg_num for pid, p in osdmap.pools.items()}
        self._prev_pool_pgnums = cur
        if prev is not None and all(
                cur[pid] >= prev.get(pid, 0) for pid in cur):
            return
        import re as _re

        from ..store.objectstore import GHObject, Transaction
        from .osdmap import pg_split_source
        from .pg import PGMETA_OID
        from .pglog import MissingSet, PGLog
        try:
            colls = sorted(self.store.list_collections())
        except Exception:
            return
        groups: Dict[Tuple[int, int], List[Tuple[str, int]]] = {}
        for coll in colls:
            m = _re.fullmatch(r"(\d+)\.([0-9a-f]+)(?:s(\d+))?", coll)
            if not m:
                continue
            pool_id = int(m.group(1))
            seed = int(m.group(2), 16)
            shard = int(m.group(3)) if m.group(3) is not None else -1
            pool = osdmap.pools.get(pool_id)
            if pool is None or seed < pool.pg_num:
                continue                 # pool gone (purge handles) or
                                         # still a live PG
            groups.setdefault((pool_id, seed), []).append((coll,
                                                           shard))
        import json as _json
        for (pool_id, seed) in sorted(groups):
            pool = osdmap.pools[pool_id]
            tseed = pg_split_source(seed, pool.pg_num)
            base = f"{pool_id}.{tseed:x}"
            _, _, p_acting, _ = osdmap.pg_to_up_acting_osds(
                PGid(pool_id, tseed))
            if self.whoami not in [o for o in p_acting
                                   if o is not None] \
                    and not pool.is_erasure():
                # replicated pool, and we hold child data but are NOT
                # a parent acting member: the merge gate required a
                # fully CLEAN cluster, so the acting set holds
                # everything current — our copy may even be a STALE
                # stray left by churn.  Folding it could rebase stale
                # history into the parent; drop it instead (the purge
                # we would get anyway, just earlier).  EC pools take
                # the fold path below even when non-acting: each
                # holder owns ONE chunk position, so the parent acting
                # set alone cannot reconstruct the merged objects —
                # the holder must keep serving its chunk as a
                # shard-qualified stray source until recovery lands
                # (adopt_merge's stray branch; split machinery in
                # reverse).  Quiesce like the fold path: a racing
                # client op must bounce, not ack into a collection
                # being removed.
                with self.pg_lock:
                    dropped = self.pgs.pop(PGid(pool_id, seed), None)
                import contextlib as _ctx
                guard = dropped.lock if dropped is not None \
                    else _ctx.nullcontext()
                with guard:
                    if dropped is not None:
                        dropped._merged_away = True
                    txn = Transaction()
                    for coll, _shard in sorted(
                            groups[(pool_id, seed)]):
                        txn.remove_collection(coll)
                    try:
                        self.store.queue_transactions([txn],
                                                      op="pg_merge")
                    except Exception:
                        pass
                self.log.dout(1, f"dropped non-acting child copy "
                              f"{pool_id}.{seed:x} at merge")
                continue
            # the in-memory child PG dies first; late ops bounce to
            # the client, which re-targets the parent off the new map.
            # The object snapshot + move txn run UNDER the child's
            # lock with the merged-away flag set, so no write can
            # commit between the snapshot and the collection removal
            # (an acked write must never be silently dropped)
            with self.pg_lock:
                child = self.pgs.pop(PGid(pool_id, seed), None)
            import contextlib
            child_guard = child.lock if child is not None \
                else contextlib.nullcontext()
            child_log = None
            child_missing = None
            merged_locs: Dict[str, int] = {}   # oid -> local shard
            ok = True
            with child_guard:
                if child is not None:
                    child._merged_away = True
                txn = Transaction()
                for coll, shard in sorted(groups[(pool_id, seed)]):
                    tcoll = base if shard < 0 else f"{base}s{shard}"
                    if child_log is None:
                        try:
                            omap = self.store.omap_get(
                                coll, GHObject(PGMETA_OID, shard))
                            raw = omap.get("info")
                            if raw:
                                child_log = PGLog.decode(raw)
                            raw = omap.get("missing")
                            if raw:
                                child_missing = MissingSet.from_dict(
                                    _json.loads(raw.decode()))
                        except Exception:
                            pass
                    if not self.store.collection_exists(tcoll):
                        txn.create_collection(tcoll)
                    for obj in self.store.collection_list(coll):
                        if obj.oid == PGMETA_OID:
                            continue
                        merged_locs.setdefault(obj.oid, shard)
                        txn.collection_move_rename(coll, obj, tcoll,
                                                   obj)
                    txn.remove_collection(coll)
                try:
                    self.store.queue_transactions([txn],
                                                  op="pg_merge")
                except Exception as e:
                    self.log.dout(1, f"merge of {pool_id}.{seed:x} -> "
                                  f"{base} failed: {e!r}; retrying on "
                                  f"the next map")
                    ok = False
            if not ok:
                continue
            parent = self._ensure_pg(PGid(pool_id, tseed), osdmap)
            if parent is not None:
                parent.adopt_merge(child_log, child_missing,
                                   pool.pg_num, merged_locs,
                                   merge_epoch=pool.pg_num_epoch)
            self.log.dout(1, f"merged pg {pool_id}.{seed:x} -> {base}")

    def _advance_pgs(self, osdmap: OSDMap) -> None:
        """Instantiate PGs mapped here and advance every hosted PG
        (reference consume_map / handle_pg_create).  Splits run before
        interval handling so children hold their objects before their
        peering starts (reference OSD::advance_pg split-then-peer
        ordering, osd/OSD.cc:8926)."""
        self._maybe_merge_collections(osdmap)
        for pool_id in list(osdmap.pools):
            for pgid in osdmap.pgs_for_pool(pool_id):
                _, _, acting, _ = osdmap.pg_to_up_acting_osds(pgid)
                if self.whoami in [o for o in acting if o is not None]:
                    self._ensure_pg(pgid, osdmap)
        with self.pg_lock:
            pgs = list(self.pgs.values())
        for pg in pgs:
            try:
                pg.maybe_split(osdmap)
            except Exception as e:   # one sick PG must not wedge the
                self.log.dout(1, f"split {pg.pgid} failed: {e!r}")
        with self.pg_lock:
            pgs = list(self.pgs.values())  # splits may add children
        for pg in pgs:
            try:
                pg.advance_map(osdmap)
            except Exception as e:   # map pump (all PGs starve if one
                self.log.dout(1,     # advance raises)
                              f"advance {pg.pgid} failed: {e!r}")

    def _ensure_pg(self, pgid: PGid, osdmap: OSDMap) -> Optional[PG]:
        with self.pg_lock:
            pg = self.pgs.get(pgid)
            if pg is not None:
                return pg
            pool = osdmap.get_pool(pgid.pool)
            if pool is None:
                return None
            pg = PG(self.service, pgid, pool)
            self._pg_created(pg)
            self.pgs[pgid] = pg
            return pg

    def _pg_created(self, pg: PG) -> None:
        """Backend hook on PG instantiation; the crimson OSD stamps
        the owning reactor shard here."""

    def _lookup_pg(self, pgid: PGid, create: bool = True
                   ) -> Optional[PG]:
        with self.pg_lock:
            pg = self.pgs.get(pgid)
        if pg is not None:
            return pg
        if not create:
            return None
        # message raced our map: create if the current map places this
        # PG here (reference wait-for-map + create semantics)
        with self.map_lock:
            osdmap = self.osdmap
        if pgid.pool not in osdmap.pools:
            return None
        _, _, acting, _ = osdmap.pg_to_up_acting_osds(pgid)
        if self.whoami not in [o for o in acting if o is not None]:
            return None
        pg = self._ensure_pg(pgid, osdmap)
        if pg is not None:
            pg.advance_map(osdmap)
        return pg

    # ------------------------------------------------------------------
    # dispatch (reference ms_fast_dispatch :7008)
    # ------------------------------------------------------------------
    def ms_dispatch(self, conn: Connection, msg) -> bool:
        if isinstance(msg, MOSDOp):
            msg.stamp_hop("dispatch_queued")
            self._enqueue_op(conn, msg)
            return True
        if isinstance(msg, _BACKEND_MSGS):
            self.perf.inc("subop")
            msg.stamp_hop("dispatch_queued")
            pgid = PGid.parse(msg.pgid)
            pg = self._lookup_pg(pgid)
            if pg is not None:
                with pg.lock:
                    msg.stamp_hop("pg_locked")
                    if pg.pool.is_erasure() and pg.own_shard < 0:
                        # map race: we are not (yet) in this PG's
                        # acting set, so there is no shard collection
                        # to apply against — park until advance_map
                        # assigns the shard
                        pg.waiting_for_shard.append(msg)
                    else:
                        pg.backend.handle_message(msg)
            return True
        if isinstance(msg, MCommand):
            self._handle_command(conn, msg)
            return True
        if isinstance(msg, _PEERING_MSGS):
            pgid = PGid.parse(msg.pgid)
            pg = self._lookup_pg(pgid)
            if pg is None:
                return True
            if isinstance(msg, MOSDPGQuery):
                pg.handle_pg_query(msg)
            elif isinstance(msg, MOSDPGNotify):
                pg.handle_pg_notify(msg)
            else:
                pg.handle_pg_log(msg)
            return True
        if isinstance(msg, MOSDPGRemove):
            pg = self._lookup_pg(PGid.parse(msg.pgid), create=False)
            if pg is not None:
                pg.handle_pg_remove(msg)
            return True
        if isinstance(msg, (MOSDScrub, MRepScrub, MRepScrubMap)):
            pg = self._lookup_pg(PGid.parse(msg.pgid))
            if pg is not None:
                with pg.lock:
                    if isinstance(msg, MOSDScrub):
                        pg.scrubber.start(msg.deep, msg.repair)
                    elif isinstance(msg, MRepScrub):
                        pg.scrubber.handle_rep_scrub(msg)
                    else:
                        pg.scrubber.handle_rep_scrub_map(msg)
            return True
        if isinstance(msg, MOSDPing):
            self._handle_ping(conn, msg)
            return True
        return False        # MOSDMap etc. fall through to the MonClient

    # -- sharded op queue (reference enqueue_op/dequeue_op) -------------
    def _enqueue_op(self, conn: Connection, msg: MOSDOp) -> None:
        pgid = PGid(msg.pool, msg.pgid_seed)
        # track from ENQUEUE so queue-wait shows in the event timeline
        # (reference OpTracker starts at op receipt, not dequeue)
        msg.tracked = self.op_tracker.create(
            f"osd_op({msg.client}.{msg.tid} {pgid} {msg.oid} "
            f"{'+'.join(op.op for op in msg.ops)})")
        # class tag consumed by SLOEngine.observe_op at retirement
        msg.tracked.slo_class = "client_write" \
            if any(PG._op_is_write(op) for op in msg.ops) \
            else "client_read"
        msg.tracked.mark_event("queued_for_pg")
        msg.stamp_hop("pg_queued")
        shard = hash(pgid) % self._n_shards
        self._shard_queues[shard].enqueue("client", (conn, msg))

    def _shard_of_pg(self, pg: PG) -> int:
        return hash(pg.pgid) % self._n_shards

    def queue_recovery_item(self, pg: PG) -> None:
        """One recovery scheduling unit for this PG (reference
        PGRecovery OpSchedulerItem); deduped so a PG holds at most one
        queued item."""
        with pg.lock:
            if getattr(pg, "_recovery_queued", False):
                return
            pg._recovery_queued = True
        self._shard_queues[self._shard_of_pg(pg)].enqueue(
            "recovery", pg)

    def _tuned(self, base: str):
        """hdd/ssd-tuned option resolution (reference dual-default
        options): an EXPLICITLY SET base value wins — including an
        explicit 0 (e.g. osd_recovery_sleep=0 to disable pacing) —
        otherwise the store medium picks the _hdd/_ssd variant."""
        v = self.conf[base]
        if v or self.conf.is_overridden(base):
            return v
        medium = getattr(self.store, "medium", "ssd")
        return self.conf[f"{base}_{medium}"]

    def _run_recovery_item(self, pg: PG) -> None:
        with pg.lock:
            pg._recovery_queued = False
        try:
            budget = min(self._tuned("osd_recovery_max_active"),
                         max(1, self.conf[
                             "osd_recovery_max_single_start"]))
            started = pg.start_recovery_ops(budget)
        except Exception:
            import traceback
            traceback.print_exc()
            started = 0
        if started:
            self.perf.inc("recovery_ops", started)
            with pg.lock:
                more = pg.is_primary() and pg.num_missing() > 0
            if more:
                sleep = self._tuned("osd_recovery_sleep")
                if sleep:
                    # pace WITHOUT blocking the shard worker (a sleep
                    # here would stall queued client ops): defer the
                    # requeue instead
                    self.timer_wheel.call_later(
                        sleep, lambda pg=pg: self.queue_recovery_item(pg))
                else:
                    self.queue_recovery_item(pg)

    def _op_worker(self, shard: int) -> None:
        q = self._shard_queues[shard]
        while True:
            out = q.dequeue()
            if out is None:
                return
            self._run_sched_item(*out)

    def _run_sched_item(self, cls: str, item) -> None:
        """Run one scheduled op-queue item.  Shared by the classic
        shard workers and the crimson per-shard reactor drain."""
        if cls == "recovery":
            self._run_recovery_item(item)
            return
        if cls == "scrub":
            try:
                item()
            except Exception:
                import traceback
                traceback.print_exc()
            return
        conn, msg = item
        if getattr(msg, "_crossed_shard", False):
            # crimson: the op was enqueued from a foreign reactor —
            # charge the hop now that the owner shard picked it up
            msg._crossed_shard = False
            msg.stamp_hop("xshard_handoff")
        self._run_client_op(conn, msg)

    # -- op-queue telemetry ---------------------------------------------
    def _op_queue_stats(self) -> Dict[str, Dict[str, float]]:
        """Aggregate per-class scheduler stats over every shard."""
        agg: Dict[str, Dict[str, float]] = {}
        for q in self._shard_queues:
            for cls, row in q.stats().items():
                a = agg.setdefault(cls, {"queued": 0, "served": 0,
                                         "deficit": 0.0,
                                         "depth_hwm": 0})
                a["queued"] += row["queued"]
                a["served"] += row["served"]
                a["deficit"] += row["deficit"]
                a["depth_hwm"] = max(a["depth_hwm"], row["depth_hwm"])
        return agg

    def _refresh_op_queue_perf(self) -> Dict[str, Dict[str, float]]:
        agg = self._op_queue_stats()
        perf = self.op_queue_perf
        for cls, row in agg.items():
            try:
                perf.set(f"{cls}_queued_now", row["queued"])
                perf.set(f"{cls}_served", row["served"])
                perf.set(f"{cls}_depth_hwm", row["depth_hwm"])
                perf.set(f"{cls}_deficit_now",
                         round(row["deficit"], 4))
            except KeyError:
                pass            # ad-hoc class outside DEFAULT_QOS
        # growth streak for OP_QUEUE_BACKLOG: consecutive refreshes
        # where the client class got strictly deeper
        depth = int((agg.get("client") or {}).get("queued", 0))
        if depth > self._opq_last_depth:
            self._opq_growth_ticks += 1
        else:
            self._opq_growth_ticks = 0
        self._opq_last_depth = depth
        return agg

    def _run_client_op(self, conn: Connection, msg: MOSDOp) -> None:
        """Dequeued client op: span + perf + PG dispatch.  Shared by
        the classic shard workers and the crimson reactor (which runs
        it as a continuation instead of on a pool thread)."""
        pgid = PGid(msg.pool, msg.pgid_seed)
        tracked = getattr(msg, "tracked", None)
        pg = self._lookup_pg(pgid)
        if pg is None:
            # not our PG: tell the client to refresh its map
            from ..msg.messages import MOSDOpReply
            conn.send_message(MOSDOpReply(
                tid=msg.tid, result=-108, epoch=self.osdmap.epoch))
            if tracked is not None:
                tracked.finish()
            return
        is_write = any(PG._op_is_write(op) for op in msg.ops)
        span = self.tracer.start(
            "osd_op", msg.trace_id,
            getattr(msg, "parent_span_id", 0)) \
            if msg.trace_id else None
        if span is not None:
            span.tag("pg", str(pgid)).tag("oid", msg.oid) \
                .tag("write", is_write)
            # child sub-ops (EC shard writes) parent under us
            msg.osd_span_id = span.span_id
        if tracked is not None:
            tracked.mark_event("reached_pg")
        t0 = time.monotonic()
        self.perf.inc("op")
        self.perf.inc("op_w" if is_write else "op_r")
        if is_write:
            self.perf.inc("op_in_bytes",
                          sum(len(op.data or b"") for op in msg.ops))
        try:
            pg.do_request(msg, conn)
        except Exception:
            import traceback
            traceback.print_exc()
        finally:
            # latency = queue dispatch time; commit waits are async
            # (reference splits l_osd_op_*_lat similarly)
            dt = time.monotonic() - t0
            self.perf.tinc("op_latency", dt)
            self.perf.tinc("op_w_latency" if is_write
                           else "op_r_latency", dt)
            # async writes hand the tracked op to the commit
            # pipeline (PG._reply finishes it); parked ops (latest
            # event "waiting ...") stay in flight for
            # dump_blocked_ops until requeued.  finish() is
            # idempotent, so a synchronous reply that already
            # retired the op is a no-op here.
            if tracked is not None and \
                    not getattr(msg, "_tracked_async", False) and \
                    not (tracked.events and
                         tracked.events[-1][1].startswith(
                             "waiting")):
                tracked.finish()
            if span is not None:
                span.finish()

    # ------------------------------------------------------------------
    # daemon-direct commands (reference 'ceph tell osd.N', MCommand;
    # command set mirrors the admin socket's, common/admin_socket.cc)
    # ------------------------------------------------------------------
    def _exec_command(self, cmd: dict) -> Tuple[int, str, dict]:
        """Shared command table behind both MCommand ('ceph tell') and
        the unix admin socket ('ceph daemon') — one implementation, two
        transports (reference common/admin_socket.cc)."""
        prefix = cmd.get("prefix", "")
        retcode, rs, out = 0, "", {}
        try:
            if prefix == "perf dump":
                self._refresh_op_queue_perf()
                out = self.perf_coll.perf_dump()
                # fault-injection trip counters ride the same dump so
                # admin socket / tell / mgr prometheus all see them
                from ..utils import faults as faultlib
                counters = faultlib.registry().counters()
                if counters:
                    out["faults"] = counters
            elif prefix == "dump_traces":
                out = {"spans": self.tracer.dump()}
            elif prefix == "dump_historic_ops":
                out = {"ops": self.op_tracker.dump_historic_ops()}
            elif prefix == "dump_historic_slow_ops":
                out = {"ops":
                       self.op_tracker.dump_historic_slow_ops()}
            elif prefix == "dump_blocked_ops":
                out = {"ops": self.op_tracker.dump_blocked_ops()}
            elif prefix == "dump_ops_in_flight":
                out = {"ops": self.op_tracker.dump_ops_in_flight()}
            elif prefix == "dump_slow_ops":
                out = {"ops": self.op_tracker.slow_ops()}
            elif prefix == "dump_flight_recorder":
                out = self.flight_recorder.dump_state()
            elif prefix == "dump_critical_path":
                out = self.critpath.dump()
            elif prefix == "dump_hops":
                # write view at top level (back-compat), read/recovery
                # class views nested
                out = self.hops.dump()
                out["read"] = self.hops_read.dump()
                out["recovery"] = self.hops_recovery.dump()
            elif prefix == "dump_slo":
                out = self.slo.dump()
            elif prefix == "dump_trace":
                out = self._trace_bundle()
            elif prefix == "dump_profile":
                from ..utils.sampler import global_sampler
                s = global_sampler()
                out = {"samples": s.samples,
                       "hz": s.hz,
                       "running": s.running,
                       "folded": s.dump_folded(
                           prefix=f"osd{self.whoami}-"),
                       "self_time": s.top_self_time(
                           prefix=f"osd{self.whoami}-", n=10)}
            elif prefix == "dump_device":
                out = self.encode_batcher.device_dump()
            elif prefix == "dump_op_queue":
                out = {"classes": self._refresh_op_queue_perf(),
                       "shards": [q.stats()
                                  for q in self._shard_queues],
                       "growth_ticks": self._opq_growth_ticks}
            elif prefix == "dump_tuner":
                out = self.tuner.dump()
                out["enabled"] = bool(
                    self.conf["osd_tuner_enable"])
            elif prefix == "dump_store":
                out = self.store.dump_store()
            elif prefix == "dump_health":
                out = self._health_dump()
            elif prefix == "status":
                with self.pg_lock:
                    n_pgs = len(self.pgs)
                out = {"osd": self.whoami, "num_pgs": n_pgs,
                       "osdmap_epoch": self.osdmap.epoch,
                       "state": "active"}
            elif prefix == "config get":
                out = {"value": self.conf.get(cmd["name"])}
            elif prefix == "config set":
                self.conf.set(cmd["name"], cmd["value"])
            else:
                retcode, rs = -22, f"unknown command {prefix!r}"
        except Exception as e:
            retcode, rs = -22, str(e)
        return retcode, rs, out

    def _health_dump(self) -> dict:
        """``dump_health``: this daemon's view of the named cluster
        health checks (mgr/health.py); bench merges every daemon's
        view into the one-look HEALTH_* line."""
        from ..mgr import health as healthlib
        slow = blocked = 0
        try:
            slow = len(self.op_tracker.slow_ops())
            blocked = len(self.op_tracker.dump_blocked_ops())
        except Exception:
            pass
        down = [o for o, info in self.osdmap.osds.items()
                if not info.up]
        with self.pg_lock:
            total_pgs = len(self.pgs)
            degraded = sum(1 for pg in self.pgs.values()
                           if pg.state != STATE_ACTIVE)
        oq = self._op_queue_stats().get("client") or {}
        checks = healthlib.checks_from_signals(
            breaker_open=getattr(self.encode_batcher,
                                 "_breaker_open", False),
            slo=self.slo.dump(),
            slow_ops=slow, blocked_ops=blocked,
            down_osds=down,
            degraded_pgs=degraded, total_pgs=total_pgs,
            op_queue={"client_queued": int(oq.get("queued", 0)),
                      "client_growth_ticks": self._opq_growth_ticks},
            store=self.store.store_stall_signals())
        out = healthlib.summarize(checks)
        out["daemon"] = f"osd.{self.whoami}"
        return out

    def _trace_bundle(self) -> dict:
        """Raw material for tools/trace_export.py (one bundle per
        daemon, merged into a single Perfetto trace): recent hop
        ledgers by op class, optracker stage timelines, flight-
        recorder events, per-shard reactor utilization samples
        (crimson; classic OSDs report none), and the sampler's folded
        stacks for this daemon."""
        reactors = []
        for r in getattr(self, "reactors", []) or []:
            reactors.append({"shard": r.shard,
                             "ticks": r.ticks,
                             "busy_s": r.busy_s,
                             "loop_lag_s": r.loop_lag_s,
                             "util": r.util_dump()})
        folded = {}
        try:
            from ..utils.sampler import global_sampler
            folded = global_sampler().dump_folded(
                prefix=f"osd{self.whoami}-")
        except Exception:
            pass
        return {
            "daemon": f"osd.{self.whoami}",
            "ledgers": {"write": self.hops.recent(),
                        "read": self.hops_read.recent(),
                        "recovery": self.hops_recovery.recent()},
            "ops": (self.op_tracker.dump_historic_ops()
                    + self.op_tracker.dump_ops_in_flight()),
            "flight": self.flight_recorder.dump_state(),
            "reactors": reactors,
            "device": self.encode_batcher.device_trace_block(),
            "store": {"ledgers":
                      self.store._store_accum().recent()},
            "folded": folded,
        }

    def _handle_command(self, conn: Connection, msg: MCommand) -> None:
        retcode, rs, out = self._exec_command(msg.cmd)
        conn.send_message(MCommandReply(tid=msg.tid, retcode=retcode,
                                        rs=rs, out=out))

    def _admin_socket_hook(self, cmd: dict):
        retcode, rs, out = self._exec_command(cmd)
        if retcode != 0:
            raise RuntimeError(rs or f"error {retcode}")
        return out

    # ------------------------------------------------------------------
    # peer messaging
    # ------------------------------------------------------------------
    def send_osd(self, osd: int, msg) -> None:
        if osd == self.whoami:
            # local delivery loops through dispatch (the reference
            # short-circuits local sub-ops similarly)
            self.ms_dispatch(None, msg)
            return
        with self.map_lock:
            addr = self.osdmap.get_addr(osd)
        if addr is None:
            self.log.dout(10, f"no addr for osd.{osd}, dropping "
                          f"{type(msg).__name__}")
            return
        self.msgr.connect_to(addr, lossless=True,
                             peer_name=f"osd.{osd}").send_message(msg)

    def objecter_ioctx(self, pool_id: int, bypass_tier: bool = True):
        """IoCtx on the OSD's own internal client (the reference
        OSD's objecter, used by copy-from and cache tiering —
        reference ceph_osd.cc objecter messenger + PrimaryLogPG
        do_copy_from).  ``bypass_tier``: internal promote/flush IO
        must address the named pool DIRECTLY (reference
        CEPH_OSD_FLAG_IGNORE_OVERLAY), or a tiered base pool's
        redirect would bounce the promote right back into the cache
        that issued it; a tiered copy_from's SOURCE fetch instead
        wants the overlay (the source may live only in the base after
        an evict — the read promotes it back)."""
        with self.map_lock:
            pool = self.osdmap.pools.get(pool_id)
        if pool is None:
            raise KeyError(f"no pool {pool_id}")
        with self._int_client_lock:
            if self._int_client is None:
                from ..client.rados import Rados
                self._int_client = Rados(self._mon_addr,
                                         conf=self.conf).connect()
        io = self._int_client.open_ioctx(pool.name)
        io._bypass_tier = bypass_tier
        return io

    # ------------------------------------------------------------------
    # timers + laggard reporting (EC sub-write deadlines)
    # ------------------------------------------------------------------
    def _call_later(self, delay: float, fn):
        """One-shot cancellable timer on the per-OSD hashed timer
        wheel (utils/timer_wheel.py): O(1) arm/cancel on a single
        daemon thread instead of one thread per timer — the EC fanout
        arms k+m of these per segment.  CrimsonOSD shares the same
        wheel but marshals the fire onto its reactor so deadline
        continuations keep running on the reactor thread."""
        return self.timer_wheel.call_later(delay, fn)

    def report_laggard(self, osd: int, elapsed: float) -> None:
        """A peer sat on an EC sub-write past two deadlines: report it
        to the monitor exactly like a missed heartbeat (reference
        MOSDFailure).  Enough distinct reporters mark it down, the map
        change re-peers the PG and clients resend."""
        self.log.dout(1, f"osd.{osd} laggard on EC sub-write "
                      f"({elapsed * 1000:.0f}ms), reporting")
        try:
            self.monc.report_failure(osd, self.whoami, elapsed,
                                     self.osdmap.epoch)
        except Exception:
            pass

    # ------------------------------------------------------------------
    # heartbeats (reference OSD.cc:5079-5632)
    # ------------------------------------------------------------------
    def _hb_peers(self) -> List[int]:
        """Up peers to ping.  Large clusters ping a ring neighborhood
        of at least osd_heartbeat_min_peers instead of everyone
        (reference maybe_update_heartbeat_peers, OSD.cc:5079 — crush-
        adjacent plus padding to the minimum); every OSD still has
        enough watchers for the monitor's reporter quorum."""
        with self.map_lock:
            up = sorted(o for o, info in self.osdmap.osds.items()
                        if info.up and o != self.whoami)
        want = self.conf["osd_heartbeat_min_peers"]
        if len(up) <= want:
            return up
        # ring neighborhood centered on our id: deterministic, and
        # the union over all OSDs covers every peer both ways
        import bisect
        at = bisect.bisect_left(up, self.whoami)
        half = (want + 1) // 2
        sel = {up[(at + i) % len(up)] for i in range(1, half + 1)}
        sel |= {up[(at - i) % len(up)] for i in range(1, half + 1)}
        return sorted(sel)

    def _handle_ping(self, conn: Connection, msg: MOSDPing) -> None:
        if msg.op == MOSDPing.PING:
            self.send_osd(msg.from_osd, MOSDPing(
                op=MOSDPing.PING_REPLY, from_osd=self.whoami,
                epoch=self.osdmap.epoch, stamp=msg.stamp))
        else:
            self._hb_last_rx[msg.from_osd] = time.monotonic()

    def _heartbeat_loop(self) -> None:
        interval = self.conf["osd_heartbeat_interval"]
        while not self._stop.wait(interval):
            self._heartbeat_once()

    def _heartbeat_once(self) -> None:
        """One heartbeat round: ping peers, report the silent ones.
        Shared by the classic heartbeat thread and the crimson
        reactor's heartbeat timer — the grace/report behavior is
        IDENTICAL across backends by construction."""
        grace = self.conf["osd_heartbeat_grace"]
        now = time.monotonic()
        for peer in self._hb_peers():
            last = self._hb_last_rx.get(peer)
            if last is None:
                self._hb_last_rx[peer] = now       # grace starts now
            elif now - last > grace:
                reported = self._hb_reported.get(peer, 0)
                if now - reported > grace:
                    self._hb_reported[peer] = now
                    self.log.dout(1, f"osd.{peer} silent "
                                  f"{now - last:.1f}s, reporting")
                    try:
                        self.monc.report_failure(
                            peer, self.whoami, now - last,
                            self.osdmap.epoch)
                    except Exception:
                        pass
            pad = self.conf["osd_heartbeat_min_size"]
            self.send_osd(peer, MOSDPing(
                op=MOSDPing.PING, from_osd=self.whoami,
                epoch=self.osdmap.epoch, stamp=now,
                padding="x" * pad))
        # forget peers no longer up (map took them out)
        up = set(self._hb_peers())
        for peer in list(self._hb_last_rx):
            if peer not in up:
                self._hb_last_rx.pop(peer, None)
                self._hb_reported.pop(peer, None)

    # ------------------------------------------------------------------
    # recovery (reference start_recovery_ops + recovery_wq)
    # ------------------------------------------------------------------
    def kick_recovery(self) -> None:
        self._recovery_kick.set()

    def _recovery_loop(self) -> None:
        """Scan for PGs owing recovery and hand them to the sharded
        op queues as ``recovery``-class items — the mClock scheduler
        arbitrates them against client IO (reference: recovery work
        rides OpSchedulerItems through the same queues)."""
        while not self._stop.is_set():
            self._recovery_kick.wait(timeout=0.2)
            self._recovery_kick.clear()
            if self._stop.is_set():
                return
            self._recovery_scan()

    def _recovery_scan(self) -> None:
        """One pass over hosted PGs, queueing recovery items up to the
        backfill budget.  Shared by the classic recovery thread and
        the crimson reactor's recovery timer."""
        with self.pg_lock:
            pgs = list(self.pgs.values())
        # osd_max_backfills: bound the PGs QUEUED for recovery at
        # once per daemon (reference backfill reservations) so one
        # OSD's rebuild never floods every PG simultaneously.
        # Only count transient queued state — an in-backend
        # recovery op wedged on a dead peer must not eat a slot
        # forever (its PG re-queues via the tick's stuck-retry)
        slots = self.conf["osd_max_backfills"] * 4
        active_recovering = sum(
            1 for pg in pgs
            if getattr(pg, "_recovery_queued", False))
        for pg in pgs:
            if self._stop.is_set():
                return
            if active_recovering >= slots:
                break                    # next kick continues
            try:
                with pg.lock:
                    need = pg.is_primary() and \
                        pg.state == STATE_ACTIVE and \
                        (pg.num_missing() > 0
                         or pg.waiting_for_degraded)
                if need:
                    self.queue_recovery_item(pg)
                    active_recovering += 1
            except Exception:
                import traceback
                traceback.print_exc()

    # ------------------------------------------------------------------
    # tick: pg stats + stuck-peering retry
    # ------------------------------------------------------------------
    def _tick_loop(self) -> None:
        interval = self.conf["osd_tick_interval"]
        while not self._stop.wait(interval):
            self._tick_once()

    def _tick_once(self) -> None:
        """One maintenance tick.  Shared by the classic tick thread
        and the crimson reactor's tick timer."""
        # osd_mon_report_interval throttles stat traffic on big
        # clusters; 0 reports every tick (test default)
        min_gap = self.conf["osd_mon_report_interval"]
        if time.monotonic() - getattr(self, "_last_stat_report",
                                      0.0) >= min_gap:
            self._last_stat_report = time.monotonic()
            self._send_pg_stats()
        self._retry_stuck_peering()
        self._renotify_strays()
        self._refresh_op_queue_perf()
        self._maybe_schedule_scrub()
        self._maybe_trim_snaps()
        self._maybe_trim_pg_logs()
        self._maybe_cache_agent()
        self._maybe_reboot()
        self._maybe_tuner_tick()

    def _maybe_tuner_tick(self) -> None:
        """Per-OSD closed-loop tuner tick.  Runs on
        BOTH backends for free: the classic tick thread and the
        crimson reactor timer share _tick_once.  Every
        osd_tuner_interval_ticks ticks it feeds the controller one
        (objective, signals, guard) sample — objective is EC requests
        retired per second, signals are the overlap/waterfall/stall
        ladder, the guard trips on SLO burn, an open device breaker,
        or an overlap collapse — then re-applies the batcher's live
        knobs so an accepted step lands within this tick."""
        try:
            if not self.conf["osd_tuner_enable"]:
                return
            interval = max(1, self.conf["osd_tuner_interval_ticks"])
        except (KeyError, TypeError):
            return
        self._tuner_ticks += 1
        if self._tuner_ticks % interval:
            return
        b = self.encode_batcher
        now = time.monotonic()
        reqs = b.reqs_total + b.dec_reqs
        last_t, last_reqs = self._tuner_last
        self._tuner_last = (now, reqs)
        if last_t is None or now <= last_t:
            return                   # first sample: baseline only
        objective = (reqs - last_reqs) / (now - last_t)
        signals, guard = self._tuner_signals()
        self.tuner.step(objective, signals=signals, guard=guard)
        b.apply_tuning()

    def _tuner_signals(self):
        """(signals, guard) for the controller: the observability
        ladder collapsed to one cheap snapshot.  Must not raise —
        a telemetry hiccup must never take down the tick."""
        b = self.encode_batcher
        signals = {}
        guard = None
        try:
            from ..utils.device_ledger import overlap_stats
            ov = overlap_stats(b.ledger_accum.recent())
            frac = ov.get("pipeline_overlap_frac", 0.0)
            signals["overlap_frac"] = frac
            if ov.get("bounding_phase"):
                signals["bounding_phase"] = ov["bounding_phase"]
            ps = dict(b.ledger_accum.phase_seconds)
            if ps:
                signals["top_hop"] = max(ps, key=ps.get)
            signals["staging_stalls"] = b._staging_stalls_seen
            cperf = getattr(self.contention, "cperf", None)
            if cperf is not None:
                signals["contention_stalls"] = int(
                    cperf.get("stalls"))
            # guard 1: overlap collapse — a step that halves a
            # previously healthy overlap is wrong no matter what the
            # throughput sample says this tick
            last = self._tuner_last_overlap
            self._tuner_last_overlap = frac
            if last is not None and last >= 0.25 and frac < 0.5 * last:
                guard = "overlap_collapse"
            # guard 2: SLO burn — any class consuming its error
            # budget faster than allowed vetoes the current probe
            for cls in self.slo.CLASSES:
                burn = self.slo.burn(cls)
                if burn > 1.0:
                    signals[f"{cls}_burn"] = round(burn, 3)
                    guard = f"slo_burn:{cls}"
            # guard 3: an open device circuit breaker means the
            # device is sick — never walk knobs on top of that
            if b.device_dump().get("breaker_open"):
                guard = "breaker_open"
        except Exception:
            pass
        return signals, guard

    def _reapply_mclock(self) -> None:
        """Config-observer target for the osd_mclock_scheduler_*
        options: push the current triples into every live shard
        queue.  The mgr tuner module's `config set` lands here via
        the central config riding the next map epoch."""
        try:
            if self.conf["osd_op_queue"] == "fifo":
                return
            from .scheduler import qos_from_conf
            qos = qos_from_conf(self.conf)
            changed = False
            for sq in self._shard_queues:
                changed = sq.set_qos(qos) or changed
            if changed:
                self.flight_recorder.note(
                    "mclock_retune",
                    **{cls: str(tuple(qos[cls]))
                       for cls in sorted(qos)})
        except Exception:
            pass

    def _renotify_strays(self) -> None:
        """Stray copies (split children on the parent's holders,
        migrated-away PGs) re-announce themselves until the primary
        purges them — covers notifies lost to races or primary
        failover."""
        with self.pg_lock:
            pgs = list(self.pgs.values())
        with self.map_lock:
            osdmap = self.osdmap
        for pg in pgs:
            try:
                if pg.is_stray():
                    pg.maybe_notify_stray(osdmap)
                pg.maybe_announce_merge(osdmap)
            except Exception:
                pass

    def _maybe_trim_snaps(self) -> None:
        """Drive snap trimming on primary PGs (reference OSD ticks the
        SnapTrimmer via the snap_trim work queue)."""
        with self.pg_lock:
            pgs = list(self.pgs.values())
        for pg in pgs:
            try:
                pg.maybe_trim_snaps()
            except Exception:
                import traceback
                traceback.print_exc()

    def _maybe_trim_pg_logs(self) -> None:
        """Clean primaries trim their log to osd_min_pg_log_entries
        (reference PeeringState::calc_trim_to: min while clean, max
        while degraded — degraded PGs keep history for log-based
        catch-up)."""
        min_e = self.conf["osd_min_pg_log_entries"]
        with self.pg_lock:
            pgs = list(self.pgs.values())
        for pg in pgs:
            try:
                with pg.lock:
                    if pg.is_primary() and pg.state == STATE_ACTIVE \
                            and pg.num_missing() == 0 \
                            and not any(ms.items for ms in
                                        pg.peer_missing.values()):
                        pg.log.trim_to(min_e)
            except Exception:
                pass

    def _maybe_cache_agent(self) -> None:
        """Drive the cache-tier agent on primary tier-pool PGs
        (reference OSD tick -> agent_work)."""
        with self.pg_lock:
            pgs = list(self.pgs.values())
        for pg in pgs:
            try:
                if pg.pool.is_tier():
                    pg.cache_agent()
            except Exception:
                import traceback
                traceback.print_exc()

    def _maybe_reboot(self) -> None:
        """The boot can be lost to a mon election (commit rejected by
        a dissolving quorum, or a lossy mon session dropping it):
        keep re-announcing until the map shows us up (reference OSD
        start_boot retry ticks)."""
        with self.map_lock:
            info = self.osdmap.osds.get(self.whoami)
        if (info is None or not info.up or
                tuple(info.addr or ()) != tuple(self.my_addr)) \
                and not self._stop.is_set():
            try:
                self.monc.send_boot(self.whoami, self.my_addr)
            except Exception:
                pass

    def _maybe_schedule_scrub(self) -> None:
        """Periodic scrub scheduling (reference OSD::sched_scrub:
        shallow every osd_scrub_interval, deep every
        osd_deep_scrub_interval; 0 disables)."""
        shallow = self.conf["osd_scrub_interval"]
        deep_iv = self.conf["osd_deep_scrub_interval"]
        now = time.time()
        with self.pg_lock:
            pgs = list(self.pgs.values())
        for pg in pgs:
            with pg.lock:
                pg.scrubber.maybe_abort_stuck()
                pg.scrubber.kick()       # drain-wait retries
        if shallow <= 0:
            return
        # reference osd_scrub_load_threshold: a loaded host defers
        # background scrubbing entirely
        load_cap = self.conf["osd_scrub_load_threshold"]
        if load_cap > 0:
            try:
                import os as _os
                if _os.getloadavg()[0] > load_cap:
                    return
            except OSError:
                pass
        # osd_max_scrubs bounds concurrent scrub rounds per daemon
        # (reference osd_max_scrubs + scrub reservations)
        budget = self.conf["osd_max_scrubs"] - sum(
            1 for pg in pgs if pg.scrubber.active)
        if self.conf["osd_scrub_sleep"] > 0:
            # pacing (reference osd_scrub_sleep, applied between scrub
            # chunks there): schedule at most one PG's round per tick
            # — lock-free pacing, no sleeping under the PG lock
            budget = min(budget, 1)
        if not self.conf["osd_scrub_during_recovery"] and any(
                pg.is_primary() and pg.num_missing() > 0
                for pg in pgs):
            # reference osd_scrub_during_recovery=false: recovery IO
            # outranks background scrub on this daemon
            return
        # per-PG jittered cadence (reference osd_scrub_min_interval /
        # osd_scrub_max_interval): a stable per-PG offset spreads
        # rounds out instead of scrubbing every PG in one burst
        smin = self.conf["osd_scrub_min_interval"]
        smax = self.conf["osd_scrub_max_interval"]
        for pg in pgs:
            if budget <= 0:
                break
            with pg.lock:
                if not pg.is_primary() or pg.state != STATE_ACTIVE \
                        or pg.scrubber.active:
                    continue
                interval = shallow
                if 0 < smin < smax:
                    frac = (hash(str(pg.pgid)) & 0xFFFF) / 0xFFFF
                    interval = smin + frac * (smax - smin)
                if now - pg.scrubber.last_scrub < interval:
                    continue
                budget -= 1
                deep = deep_iv > 0 and \
                    now - pg.scrubber.last_deep_scrub >= deep_iv
                self._queue_scrub(pg, deep)

    def _queue_scrub(self, pg: PG, deep: bool) -> None:
        """Scrub-class work goes through the scheduler so it never
        outruns client IO (reference PGScrub items); the crimson OSD
        queues it on the reactor instead."""
        self._shard_queues[self._shard_of_pg(pg)].enqueue(
            "scrub", lambda p=pg, d=deep: self._start_scrub(p, d))

    def _start_scrub(self, pg: PG, deep: bool) -> None:
        with pg.lock:
            if not pg.is_primary() or pg.state != STATE_ACTIVE \
                    or pg.scrubber.active:
                return
            # re-check freshness: stacked queue items must not run
            # back-to-back scrubs of the same PG
            if time.time() - pg.scrubber.last_scrub < \
                    self.conf["osd_scrub_interval"]:
                return
            pg.scrubber.start(deep=deep, repair=False)

    def _send_pg_stats(self) -> None:
        stats: Dict[str, dict] = {}
        with self.pg_lock:
            pgs = list(self.pgs.items())
        for pgid, pg in pgs:
            if pg.is_primary():
                try:
                    stats[str(pgid)] = pg.get_stats()
                except Exception:
                    pass
        # osd_stat_t analog: store fullness feeds the monitor's
        # OSD_FULL/OSD_NEARFULL health checks (mon_osd_full_ratio /
        # mon_osd_nearfull_ratio); only capacity-capped stores report
        osd_stat = {}
        cap = getattr(self.store, "max_bytes", 0)
        if cap:
            osd_stat = {"kb": cap >> 10,
                        "kb_used": getattr(self.store, "_data_bytes",
                                           0) >> 10}
        if stats or osd_stat:
            try:
                self.monc.send_pg_stats(self.whoami, self.osdmap.epoch,
                                        stats, osd_stat=osd_stat)
            except Exception:
                pass

    def _retry_stuck_peering(self) -> None:
        """A peering Query or recovery sub-op can race a peer's map
        (messages for PGs it can't place yet are dropped); the primary
        re-queries / re-runs recovery until everyone answers (the
        reference's peering statechart retries via map-epoch events)."""
        with self.pg_lock:
            pgs = list(self.pgs.values())
        kick = False
        for pg in pgs:
            with pg.lock:
                if pg.is_primary() and pg.state == STATE_PEERING:
                    pg._start_peering()
                if pg.is_primary() and pg.requeue_stale_recovery():
                    kick = True
                if pg.is_primary() and pg.state == STATE_ACTIVE \
                        and pg.num_missing() > 0:
                    kick = True          # belt-and-braces recovery kick
        if kick:
            self.kick_recovery()

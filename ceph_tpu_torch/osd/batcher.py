"""Cross-op device stripe batcher — the OSD-level encode coalescer.

This is the framework's "batching point" (SURVEY.md §3.1): where the
reference encodes each write's stripes on the submitting thread inside
ECBackend::try_reads_to_commit (reference src/osd/ECBackend.cc:1939,
via ECUtil::encode's per-stripe loop, src/osd/ECUtil.cc:136-148), a
card pays per *device call*, not per stripe — so the win is gathering
stripes from MANY in-flight ops (across PGs, one batcher per OSD) into
ONE batched kernel launch (B1 for the byte codes, B2 or B3 for the
packet codes, through the `gpu` plugin).

Mechanics:

* ``submit()`` (called under the PG lock from the EC write pipeline)
  enqueues an encode request keyed by codec geometry and wakes the
  collector.  The submitting thread never blocks on the device.
* The collector thread waits ``ec_tpu_queue_window_us`` from the first
  queued request (or until ``ec_tpu_batch_stripes`` stripes are
  pending) for more ops to arrive, then concatenates each geometry
  group to one ``[N, k, chunk]`` array and issues a single
  ``encode_batch_async`` device call — h2d staging, kernel and parity
  d2h are enqueued back to back, and the next window is collected
  while they run.
* Parity is split back per request and each continuation runs in
  submission order (per-PG FIFO holds: the PG pipeline admits one
  encode per PG at a time, and one collector drains batches serially).

Locking: ``submit`` takes only the batcher lock; continuations take
the owning PG's lock while the batcher lock is dropped — no ordering
cycle with the op workers (which take PG lock then ``submit``).

Reference anchors: the op queue this rides behind is the sharded work
queue (reference src/osd/OSD.cc:9612 enqueue_op -> op_shardedwq); the
in-order commit contract it must preserve is ECBackend::check_ops
(reference src/osd/ECBackend.cc:2151-2156).

Every codec with ``encode_batch_async`` coalesces, packet codes
included: the `gpu` plugin's ``encode_batch_async`` XORs whole packets
per super-word (kernels B2/B3), the same parity as ``encode_batch`` and
jerasure.  Threads that touch the card (collector, completion worker,
prewarm) all enqueue on the current stream of the codec's device, which
the backend selects around each dispatch.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import ecutil
from ..utils import copytrack
from ..utils import faults as faultlib
from ..utils.device_ledger import DeviceLedgerAccum, overlap_stats
from ..utils.locks import TimedCondition
from ..utils.perf import TYPE_U64


class _Req:
    """One queued encode.  ``data`` may be bytes, bytearray,
    memoryview or a uint8 ndarray — the caller hands over ownership
    and must not mutate the buffer until ``cb`` fires."""

    def __init__(self, ec_impl, sinfo: ecutil.StripeInfo, data,
                 cb: Callable[[Dict[int, bytes]], None], tracked=None):
        self.ec_impl = ec_impl
        self.sinfo = sinfo
        self.data = data
        self.cb = cb
        self.nbytes = ecutil.nbytes_of(data)
        self.nstripes = self.nbytes // sinfo.stripe_width
        self.tracked = tracked       # OpTracker handle (stage events)
        self.t_enq = time.monotonic()
        self.done = False            # cb delivered (guards double-fail)

    def as_array(self, k: int) -> np.ndarray:
        """[nstripes, k, chunk] view of the request buffer — no copy."""
        return ecutil.as_stripe_array(self.data, self.nstripes, k,
                                      self.sinfo.chunk_size)


class _DecReq:
    """One queued reconstruction: rebuild ``want - have`` shard chunks
    from the equal-length chunk buffers in ``have``."""

    def __init__(self, ec_impl, sinfo: ecutil.StripeInfo,
                 have: Dict[int, bytes], want,
                 cb: Callable[[Optional[Dict[int, bytes]]], None]):
        self.ec_impl = ec_impl
        self.sinfo = sinfo
        self.have = have
        self.want = frozenset(want)
        self.cb = cb
        self.done = False
        total = ecutil.nbytes_of(next(iter(have.values())))
        self.nstripes = total // sinfo.chunk_size
        self.t_enq = time.monotonic()


class _DeltaReq:
    """One queued parity-delta encode (sub-stripe overwrite RMW):
    ``delta`` holds old XOR new chunk bytes for the DIRTY data
    columns only, laid out ``[nstripes, D, chunk]`` for
    D = len(dirty_cols).  GF(2^8) linearity makes the parity update
    ``new_parity = old_parity XOR M[:,dirty]·Δdata``, so only the
    dirty columns ride the device — the rider's ``cb`` receives
    {parity_shard_index: Δparity chunk bytes} to XOR into the
    stored parity chunks (store-level ``xor_write``)."""

    def __init__(self, ec_impl, sinfo: ecutil.StripeInfo, delta,
                 dirty_cols,
                 cb: Callable[[Optional[Dict[int, bytes]]], None],
                 tracked=None):
        self.ec_impl = ec_impl
        self.sinfo = sinfo
        self.delta = delta
        self.dirty_cols = tuple(dirty_cols)
        self.cb = cb
        self.tracked = tracked
        self.nbytes = ecutil.nbytes_of(delta)
        self.nstripes = self.nbytes // (
            len(self.dirty_cols) * sinfo.chunk_size)
        self.t_enq = time.monotonic()
        self.done = False

    def as_array(self, ncols: int) -> np.ndarray:
        """[nstripes, D, chunk] view of the delta buffer — no copy."""
        return ecutil.as_stripe_array(self.delta, self.nstripes,
                                      ncols, self.sinfo.chunk_size)


class _BatchTwin:
    """Device-free execution twin with the BATCHED codec API: encode
    and decode run as ONE kernel call over a whole [N, k, chunk]
    stripe batch — through the native C++ GF kernels when the
    toolchain is available, numpy otherwise.  This is what a coalesced
    group executes on when the learned crossover routes it off the
    device: the coalescing win (one call for many ops' stripes) is
    preserved even when the device round trip would lose, where the
    reference encodes stripe-by-stripe on the submitting thread
    (reference src/osd/ECUtil.cc:136-148 per-stripe loop).

    Wraps a jerasure-plugin codec of the same geometry (bit-exact by
    the corpus contract) and exposes ``encode_batch`` /
    ``decode_batch`` like the gpu plugin, so ``ecutil.encode/decode``
    take their batched paths."""

    def __init__(self, base):
        self.base = base
        try:
            from ..ops import native as native_mod
            base.core.backend = native_mod.NativeBackend()
        except Exception:
            pass                     # no toolchain: numpy stays

    def __getattr__(self, name):
        return getattr(self.base, name)

    def encode_batch(self, data: np.ndarray) -> np.ndarray:
        return self.base.core.encode_batch(
            np.asarray(data, dtype=np.uint8))

    def decode_batch(self, present, chunk_len: int):
        arrays = {i: np.asarray(c, dtype=np.uint8)
                  for i, c in present.items()}
        return self.base.core.decode_chunks(arrays, chunk_len)


def _geometry_key(ec_impl, sinfo: ecutil.StripeInfo) -> Tuple:
    """Requests may share one device call iff they encode with the
    same coding matrix over the same chunk size.  The matrix is a
    deterministic function of (plugin, technique, k, m, w,
    packetsize), so that tuple + chunk_size is a sound key even
    across codec instances from different PGs of the same pool."""
    return (type(ec_impl).__name__,
            ec_impl.get_data_chunk_count(),
            ec_impl.get_coding_chunk_count(),
            getattr(ec_impl, "technique", ""),
            getattr(ec_impl, "w", 0),
            getattr(ec_impl, "packetsize", 0),
            sinfo.chunk_size)


class EncodeBatcher:
    """Per-OSD encode coalescer (one collector thread).

    The CPU/device crossover and measured CPU rates are CLASS-level:
    the device and the link are machine properties, so every batcher
    in the process (one per OSD in test clusters; one per daemon in a
    real deployment) shares one learned estimate instead of each
    paying its own slow probe."""

    _cpu_bps: Dict[Tuple, float] = {}        # per geometry, shared
    _min_device_bytes: float = 0.0           # learned crossover, shared
    _pinned_min_device_bytes: float = 0.0    # operator pin (breaker
                                             # close resets TO this)
    _dec_min_device_bytes: float = 0.0       # decode-side crossover;
                                             # 0 = not yet learned ->
                                             # seeded from the encode
                                             # EWMA (_dec_min_bytes)
    _delta_min_device_bytes: float = 0.0     # parity-delta crossover;
                                             # 0 = not yet learned ->
                                             # seeded like the decode
                                             # side (_delta_min_bytes)
    _probe_tick: int = 0                     # shared probe cadence
    _warmed: set = set()                     # geometries prewarmed
    _h2d_bps: float = 0.0                    # warm link rate EWMA, shared
    _dev_bps: Dict[Tuple, float] = {}        # steady-state device
                                             # throughput EWMA per
                                             # geometry (compile/outlier
                                             # rejection in the learner)
    # per-mesh-shape learner state: the crossover and link EWMA model
    # the AGGREGATE device+interconnect bandwidth, so a dp x sp mesh and
    # a single card must not share one estimate.  _mesh_key is the
    # (dp, sp) shape the CURRENT class-level scalars belong to (None =
    # single chip); _mesh_state stashes the scalars of every other
    # shape seen, swapped by _rekey_mesh when the live mesh changes.
    _mesh_key: Optional[Tuple] = None
    _mesh_state: Dict[Optional[Tuple], dict] = {}
    # shared idle clocks, seeded by the FIRST batcher construction
    # (None until then): seeding at import would treat process
    # lifetime as device idleness, while re-seeding on every
    # construction would reset the idle-reprobe clock for ALL
    # batchers each time a multi-OSD cluster builds another OSD
    _last_device_ts: Optional[float] = None     # last device activity
    _last_idle_probe_ts: Optional[float] = None
    # device circuit breaker — class-level like the crossover it
    # guards: the device is a machine property, so one OSD's string
    # of dispatch failures should route EVERY in-process batcher's
    # traffic to the CPU twin, not just its own
    _breaker_lock = threading.Lock()
    _breaker_failures: int = 0               # consecutive device errors
    _breaker_open: bool = False
    _breaker_opens: int = 0                  # cumulative open transitions
    _breaker_closes: int = 0                 # cumulative re-admissions

    def __init__(self, conf=None, perf=None, perf_coll=None,
                 recorder=None, contention=None):
        def get(k, d):
            if conf is None:
                return d
            try:
                return conf[k]
            except KeyError:
                return d
        # kept for the live-tuning seam: apply_tuning() re-reads the
        # runtime-tunable knobs from here at safe points (collector
        # loop top + OSD tuner tick) instead of latching them forever
        self.conf = conf
        self.max_stripes = get("ec_tpu_batch_stripes", 1024)
        self.window_s = get("ec_tpu_queue_window_us", 200) / 1e6
        # admission-aware coalescing window: the effective window
        # (dyn_window_s) doubles while submits keep arriving at its
        # expiry (queue pressure -> bigger batches clear the device
        # crossover) and halves back toward the base once a window
        # closes with no new joiners (drained queue -> don't tax
        # latency).  tick_flush() remains the hard cut.
        wmax = get("ec_tpu_queue_window_max_us", 0)
        self.window_base_s = self.window_s
        self.window_max_s = (wmax / 1e6) if wmax > 0 \
            else max(self.window_s * 16, 0.02)
        self.dyn_window_s = self.window_s
        self.window_grows = 0        # admission extensions granted
        self.window_cuts = 0         # drain-driven shrinks
        self.last_queue_depth = 0    # requests in the last dispatch
        self.queue_depth_hwm = 0
        # encode-group occupancy: the biggest single group
        # dispatched, in requests and stripes — the shard-per-core
        # regression bar is "concurrent cluster writes coalesce into
        # >=k-stripe groups, not per-PG singletons"
        self.group_reqs_hwm = 0
        self.group_stripes_hwm = 0
        self.bytes_copied = 0        # full-payload copies inside the
                                     # batcher (gathers/concats)
        # adaptive CPU/device routing (ec_tpu_fallback_cpu): a device
        # call pays a fixed dispatch+transfer cost that can dwarf the
        # kernel's win on small batches — especially over a slow link.  The
        # crossover is LEARNED: batches below the threshold encode on
        # the CPU twin; the threshold doubles when a device call loses
        # to the predicted CPU time and halves when it wins big.
        self.adaptive_cpu = get("ec_tpu_fallback_cpu", True)
        pin = get("ec_tpu_min_device_bytes", 0)
        if pin:
            # operator-pinned crossover: routing is deterministic from
            # the first op instead of riding the prewarm/learning race
            # (probes + big wins can still lower it at runtime).  The
            # pin is remembered separately so a circuit-breaker close
            # restores the OPERATOR's crossover, not whatever CPU bias
            # the learner accumulated while the device was sick.
            # Deliberately PROCESS-global even though the conf is per
            # instance: the crossover models the machine's device+link,
            # so in a multi-OSD process the last-constructed OSD's pin
            # wins (mixed per-OSD pins in one process are unsupported).
            EncodeBatcher._min_device_bytes = float(pin)
            EncodeBatcher._pinned_min_device_bytes = float(pin)
        self.probe_interval = get("ec_tpu_crossover_probe_interval", 16)
        # a device that served ZERO recent traffic gets re-probed
        # aggressively (one group per idle period) — the 1-in-N tick
        # probe alone starves on a lightly loaded OSD where small
        # batches would otherwise pin the CPU bias forever
        self.idle_reprobe_s = get("ec_tpu_device_idle_reprobe_s", 2.0)
        # collection/dispatch of window N+1 overlaps completion of
        # window N: dispatched groups hand off to a completion worker
        # through a bounded FIFO (depth = groups genuinely in flight
        # on the device; the blocking put is the throttle)
        self.inflight_groups = max(1, get("ec_tpu_inflight_groups", 2))
        # multi-device mesh shape: 0 = auto (use every visible device,
        # dp x sp factored by the backend); >1 forces the
        # device count, ec_tpu_mesh_sp forces the chunk-width axis.
        # The batcher only FORWARDS the shape — the backend owns mesh
        # construction and the sharded dispatch path.
        self.mesh_devices = get("ec_tpu_mesh_devices", 0)
        self.mesh_sp = get("ec_tpu_mesh_sp", 0)
        self._mesh_noted = False     # mesh_build drained to recorder
        # seed the shared idle clocks ONCE (first batcher built, not
        # at import and not per construction — see the class attrs)
        if EncodeBatcher._last_device_ts is None:
            EncodeBatcher._last_device_ts = time.monotonic()
            EncodeBatcher._last_idle_probe_ts = time.monotonic()
        self.crossover_min = get("ec_tpu_crossover_min_bytes", 64 << 10)
        self.device_error_threshold = get(
            "ec_tpu_device_error_threshold", 3)
        self.device_retry_s = get("ec_tpu_device_retry_ms", 2.0) / 1e3
        # device-phase stall threshold: an h2d or compute-fence phase
        # exceeding this flight-records a device_stall (+ rate-limited
        # auto-dump), mirroring the lock_stall path
        self.phase_stall_s = get(
            "ec_tpu_device_phase_stall_ms", 250.0) / 1e3
        self.prewarm_enabled = get("osd_ec_prewarm", True)
        self.cpu_reqs = 0                        # routed to CPU twin
        self.perf = perf
        # dedicated "ec_batcher" counter subsystem: per-stage
        # histograms + routing/transfer/compile counters, dumped via
        # the admin socket's perf dump and scraped by mgr prometheus
        self.bperf = None
        if perf_coll is not None:
            bp = perf_coll.create("ec_batcher")
            if "queue_wait_us" not in bp._types:
                bp.add_histogram(
                    "queue_wait_us",
                    [50, 100, 200, 500, 1000, 2000, 5000, 20000,
                     100000],
                    "per-request wait from submit to dispatch (us)")
                bp.add_histogram(
                    "batch_stripes",
                    [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024],
                    "stripes per batched device/twin call")
                bp.add_histogram(
                    "dispatch_ms",
                    [0.5, 1, 2, 5, 10, 25, 50, 100, 250, 1000],
                    "fenced dispatch-to-parity latency (ms)")
                bp.add("h2d_bytes",
                       description="data bytes staged to the device")
                bp.add("d2h_bytes",
                       description="parity bytes fetched back")
                bp.add("device_reqs",
                       description="encode requests routed to device")
                bp.add("cpu_reqs",
                       description="encode requests routed to twin")
                bp.add("coalesced_reqs",
                       description="requests that shared a call")
                bp.add("compile_count",
                       description="warm dispatches paid (prewarm)")
                bp.add_time_avg("compile_seconds",
                                "seconds per warm dispatch")
                bp.add("bytes_copied",
                       description="payload bytes copied inside the "
                                   "batcher (shard gathers/concats)")
                bp.add("ec_encode_errors",
                       description="encode/continuation failures "
                                   "(each fails its rider ops with "
                                   "EIO rather than hanging them)")
                bp.add("device_errors",
                       description="classified device dispatch/"
                                   "completion failures (post-retry)")
                bp.add("breaker_open",
                       description="circuit-breaker open transitions "
                                   "(device -> CPU twin routing)")
                bp.add("breaker_close",
                       description="circuit-breaker re-admissions "
                                   "(successful probe closed it)")
            self.bperf = bp
        # flight recorder (utils/flight_recorder.py): every routing
        # verdict / breaker transition / staging stall / encode error
        # appends one ring event; None under unit-test stubs
        self.recorder = recorder
        # decode-side device-fault hook (OSD wires this to the SLO
        # engine's recovery-class error feed): called once per
        # classified decode device failure, after the CPU-twin
        # fallback is already queued.  Must not raise.
        self.on_decode_fault = None
        # "ec_device" perf subsystem — the device-side telemetry:
        # crossover routing verdicts BY REASON,
        # StagingPool ring occupancy/stall-grows, h2d link EWMA,
        # inflight-group depth, breaker state.  The timer-wheel
        # fire-lag histogram lives here too (filled by the OSD's
        # wheel callback) so one subsystem answers "what did the
        # device machinery do" in perf dump / prometheus.
        self.dperf = None
        if perf_coll is not None:
            dp = perf_coll.create("ec_device")
            # one guard for the whole subsystem: batchers that share a
            # perf collection register it once; the decode and delta
            # lanes carry the same reason ladder as encode
            if "route_device" not in dp._types:
                for reason, desc in (
                        ("device", "batches over the crossover -> "
                                   "device"),
                        ("pin", "batches under the operator/"
                                "calibration pin -> twin "
                                "(deterministic)"),
                        ("learned", "batches under the LEARNED "
                                    "crossover -> twin"),
                        ("idle_probe", "idle-device re-probes forced "
                                       "to the device"),
                        ("tick_probe", "1-in-N periodic probes "
                                       "forced to the device"),
                        ("breaker_open", "batches the open breaker "
                                         "routed to the twin"),
                        ("breaker_probe", "re-admission probes "
                                          "through the open "
                                          "breaker")):
                    dp.add(f"route_{reason}",
                           description="routing verdicts: " + desc)
                for g, desc in (
                        ("staging_hits", "stagings served from a "
                                         "reused ring slot"),
                        ("staging_allocs", "staging arrays ever "
                                           "allocated"),
                        ("staging_stall_allocs", "ring grows after "
                                                 "an acquire stall"),
                        ("staging_slots", "staging slots live across "
                                          "all shape rings"),
                        ("staging_in_flight", "staging slots checked "
                                              "out right now"),
                        ("h2d_bps", "h2d link bandwidth EWMA "
                                    "(bytes/s, fenced samples)"),
                        ("inflight_groups_now", "encode groups in "
                                                "flight on the "
                                                "device"),
                        ("inflight_groups_hwm", "high-water mark of "
                                                "in-flight encode "
                                                "groups"),
                        ("breaker_open_now", "device circuit breaker "
                                             "state (1=open)")):
                    dp.add(g, TYPE_U64, desc)
                dp.add("breaker_opened",
                       description="breaker open transitions")
                dp.add("breaker_closed",
                       description="breaker close (re-admission) "
                                   "transitions")
                dp.add_histogram(
                    "timer_fire_lag_us",
                    [100, 500, 1000, 5000, 10000, 25000, 50000,
                     100000, 500000],
                    "timer-wheel fire lag vs requested deadline (us)")
                for reason, desc in (
                        ("device", "decode batches over the "
                                   "crossover -> device"),
                        ("learned", "decode batches under the "
                                    "LEARNED crossover -> twin"),
                        ("breaker_open", "decode batches the open "
                                         "breaker routed to the "
                                         "twin"),
                        ("breaker_probe", "decode re-admission "
                                          "probes through the open "
                                          "breaker")):
                    dp.add(f"dec_route_{reason}",
                           description="decode routing verdicts: "
                                       + desc)
                for reason, desc in (
                        ("pin", "decode batches under the operator/"
                                "calibration pin -> twin "
                                "(deterministic)"),
                        ("idle_probe", "idle-device decode re-probes "
                                       "forced to the device"),
                        ("tick_probe", "1-in-N periodic decode "
                                       "probes forced to the "
                                       "device")):
                    dp.add(f"dec_route_{reason}",
                           description="decode routing verdicts: "
                                       + desc)
                for reason, desc in (
                        ("device", "delta batches over the "
                                   "crossover -> device"),
                        ("pin", "delta batches under the operator/"
                                "calibration pin -> twin "
                                "(deterministic)"),
                        ("learned", "delta batches under the LEARNED "
                                    "crossover -> twin"),
                        ("idle_probe", "idle-device delta re-probes "
                                       "forced to the device"),
                        ("tick_probe", "1-in-N periodic delta probes "
                                       "forced to the device"),
                        ("breaker_open", "delta batches the open "
                                         "breaker routed to the "
                                         "twin"),
                        ("breaker_probe", "delta re-admission probes "
                                          "through the open "
                                          "breaker")):
                    dp.add(f"delta_route_{reason}",
                           description="parity-delta routing "
                                       "verdicts: " + desc)
                for g, desc in (
                        ("staging_host_bytes_now", "host staging ring "
                                                   "footprint (bytes)"),
                        ("staging_host_bytes_peak", "peak host staging "
                                                    "ring footprint"),
                        ("dev_matrix_bytes_now", "device-resident "
                                                 "coding matrix bytes "
                                                 "(per-geometry cache)"),
                        ("compile_cache_entries", "compiled-executable "
                                                  "cache occupancy"),
                        ("pipeline_overlap_frac", "fraction of window "
                                                  "wall where group "
                                                  "N+1 h2d overlaps "
                                                  "group N compute")):
                    dp.add(g, TYPE_U64, desc)
                dp.add("device_phase_stalls",
                       description="device phases (h2d / compute "
                                   "fence) that exceeded "
                                   "ec_tpu_device_phase_stall_ms")
                for g, desc in (
                        ("mesh_dp", "stripe-batch (dp) axis of the "
                                    "active device mesh (0 = single "
                                    "chip)"),
                        ("mesh_sp", "chunk-width (sp) axis of the "
                                    "active device mesh"),
                        ("mesh_devices", "devices in the active "
                                         "encode/decode mesh")):
                    dp.add(g, TYPE_U64, desc)
            self.dperf = dp
        # device-phase ledger accumulator (utils/device_ledger):
        # per-group stage_acquire..deliver stamps harvested from each
        # AsyncBatch at completion, plus the overlap engine over its
        # recent ring.  Dumped via the OSD's dump_device command and
        # bench's device_waterfall block.
        self.ledger_accum = DeviceLedgerAccum(perf_coll)
        self._ledger_completions = 0
        self._last_backend = None    # codec backend seen at completion
        self._route_reason = None    # last verdict's reason code
        self._staging_stalls_seen = 0
        self._inflight_hwm = 0
        # cumulative per-stage attribution (seconds of request time
        # spent in each pipeline stage; consumed by bench.py's
        # time-attribution line).  Collector-thread writes only.
        self.stage_seconds = {"queue_wait": 0.0, "batch_form": 0.0,
                              "h2d": 0.0, "device": 0.0, "d2h": 0.0}
        self.compile_count = 0
        self.compile_seconds = 0.0
        # collector wakeup condition, wait-time instrumented when the
        # OSD supplies its contention sink (utils/locks.py)
        self._cond = TimedCondition("batcher_cond", stats=contention)
        self._queues: Dict[Tuple, List] = {}
        self._pending_stripes = 0
        self._first_enqueue = 0.0
        self._flush_now = False      # tick_flush(): cut the window
        self._stop = False
        # introspection (tested + surfaced via perf counters)
        self.calls = 0               # batched encode calls issued
        self.reqs_total = 0          # requests encoded
        self.reqs_coalesced = 0      # requests that shared a call
        self.cpu_calls = 0           # batched encode calls on the twin
        self.dec_calls = 0           # batched decode calls issued
        self.dec_reqs = 0            # decode requests served
        self.dec_coalesced = 0       # decode requests that shared a call
        self.dec_cpu_reqs = 0        # decode requests on the CPU twin
        self.delta_calls = 0         # batched parity-delta calls issued
        self.delta_reqs = 0          # delta requests served
        self.delta_coalesced = 0     # delta requests that shared a call
        self.delta_cpu_reqs = 0      # delta requests on the CPU twin
        self.encode_errors = 0       # encode/continuation failures
        self.device_errors = 0       # classified device failures
        self._cpu_twins: Dict[Tuple, object] = {}  # device-failure path
        self._dec_threads: List[threading.Thread] = []
        self._warm_threads: List[threading.Thread] = []
        self.prewarm_error: Optional[BaseException] = None
        # completion worker: joins dispatched groups in FIFO order so
        # the collector can collect/dispatch the NEXT window while
        # this window's parity is still in flight (segment N+1's h2d
        # overlaps segment N's fanout)
        self._completions: "queue.Queue" = queue.Queue(
            maxsize=self.inflight_groups)
        self._comp_thread = threading.Thread(
            target=self._completion_loop, name="ec-batcher-join",
            daemon=True)
        self._comp_thread.start()
        self._thread = threading.Thread(target=self._run,
                                        name="ec-batcher", daemon=True)
        self._thread.start()

    # -- producer side ---------------------------------------------------
    def submit(self, ec_impl, sinfo: ecutil.StripeInfo, data: bytes,
               cb: Callable[[Dict[int, bytes]], None],
               tracked=None) -> None:
        """Queue one aligned extent for encoding; ``cb`` receives the
        full {shard: bytes} chunk map (data + parity) later, from the
        collector thread.  ``tracked`` is an optional OpTracker handle
        that receives batcher stage events.  Codecs without the
        batched async API don't benefit from coalescing — they encode
        inline."""
        if self._stop or not hasattr(ec_impl, "encode_batch_async"):
            cb(ecutil.encode(sinfo, ec_impl, data))
            return
        req = _Req(ec_impl, sinfo, data, cb, tracked)
        if req.nstripes == 0:
            cb({i: b"" for i in range(ec_impl.get_chunk_count())})
            return
        with self._cond:
            if self._stop:
                stopped = True       # raced shutdown: encode inline
            else:
                stopped = False
                if not self._queues:
                    self._first_enqueue = time.monotonic()
                self._queues.setdefault(
                    ("enc",) + _geometry_key(ec_impl, sinfo),
                    []).append(req)
                self._pending_stripes += req.nstripes
                self._cond.notify()
        if stopped:
            cb(ecutil.encode(sinfo, ec_impl, data))

    def submit_decode(self, ec_impl, sinfo: ecutil.StripeInfo,
                      have: Dict[int, bytes], want,
                      cb: Callable[[Optional[Dict[int, bytes]]], None]
                      ) -> None:
        """Queue a batched reconstruction of ``want - have`` shard
        chunks; ``cb`` later receives {missing_shard: bytes} (or None
        on failure) from the collector thread.

        Decode requests coalesce per (geometry, erasure signature):
        recovery after an OSD loss hammers ONE signature for the whole
        rebuild (every object lost the same shard), which makes it the
        best possible coalescing customer — the reference decodes each
        object's recovery window separately on the submitting thread
        (reference src/osd/ECBackend.cc:414-481
        handle_recovery_read_complete)."""
        missing = set(want) - set(have)
        if not missing:
            # everything wanted was read directly (e.g. a stray held
            # the 'missing' shard): passthrough, like ecutil.decode
            cb({s: (have[s] if isinstance(have[s], bytes)
                    else memoryview(have[s]).cast("B"))
                for s in want})
            return
        stopped = self._stop or not hasattr(ec_impl, "decode_batch")
        req = None
        if not stopped:
            req = _DecReq(ec_impl, sinfo, have, want, cb)
            if req.nstripes == 0:
                cb({s: b"" for s in want})
                return
            key = ("dec", _geometry_key(ec_impl, sinfo),
                   tuple(sorted(have)), tuple(sorted(missing)))
            with self._cond:
                if self._stop:
                    stopped = True   # raced shutdown: decode inline
                else:
                    if not self._queues:
                        self._first_enqueue = time.monotonic()
                    self._queues.setdefault(key, []).append(req)
                    self._pending_stripes += req.nstripes
                    self._cond.notify()
        if stopped:
            try:
                dec = ecutil.decode(sinfo, ec_impl, have, set(want))
            except Exception:
                dec = None
            cb(dec)

    def submit_delta(self, ec_impl, sinfo: ecutil.StripeInfo, delta,
                     dirty_cols,
                     cb: Callable[[Optional[Dict[int, bytes]]], None],
                     tracked=None) -> None:
        """Queue a parity-delta encode for a partial-stripe
        overwrite: ``delta`` is old XOR new chunk bytes for the DIRTY
        data columns only ([nstripes, D, chunk] layout); ``cb`` later
        receives {parity_shard_index: Δparity bytes} (or None on
        failure) from the collector thread — the caller XORs each
        Δparity into the stored parity chunk (``xor_write``).

        Delta requests coalesce per (geometry, dirty-column
        signature): a sub-stripe overwrite workload re-hits few
        signatures (a 4 KiB write always dirties one column), so hot
        small-write traffic lands on a handful of prewarmed compiled
        shapes — the same coalescing economics as recovery."""
        cols = tuple(sorted(dirty_cols))
        stopped = self._stop or \
            not hasattr(ec_impl, "delta_encode_batch_async")
        req = None
        if not stopped:
            req = _DeltaReq(ec_impl, sinfo, delta, cols, cb, tracked)
            if req.nstripes == 0:
                k = ec_impl.get_data_chunk_count()
                m = ec_impl.get_coding_chunk_count()
                cb({k + j: b"" for j in range(m)})
                return
            key = ("delta", _geometry_key(ec_impl, sinfo), cols)
            with self._cond:
                if self._stop:
                    stopped = True   # raced shutdown: compute inline
                else:
                    if not self._queues:
                        self._first_enqueue = time.monotonic()
                    self._queues.setdefault(key, []).append(req)
                    self._pending_stripes += req.nstripes
                    self._cond.notify()
        if stopped:
            try:
                out = self._delta_inline(ec_impl, sinfo, delta, cols)
            except Exception:
                out = None
            cb(out)

    def _delta_inline(self, ec_impl, sinfo: ecutil.StripeInfo,
                      delta, cols) -> Dict[int, memoryview]:
        """Synchronous device-free Δparity (shutdown/no-async-API
        fallback for submit_delta)."""
        cs = sinfo.chunk_size
        nstripes = ecutil.nbytes_of(delta) // (len(cols) * cs)
        arr = np.asarray(ecutil.as_stripe_array(
            delta, nstripes, len(cols), cs), dtype=np.uint8)
        if hasattr(ec_impl, "delta_encode_batch"):
            parity = ec_impl.delta_encode_batch(arr, cols)
        else:
            parity = ec_impl.core.delta_parity(arr, cols)
        k = ec_impl.get_data_chunk_count()
        return {k + j: memoryview(
                    np.ascontiguousarray(parity[:, j])).cast("B")
                for j in range(parity.shape[1])}

    def tick_flush(self) -> None:
        """Cut the coalescing window NOW: everything queued dispatches
        as one group set without waiting out ``window_s``.  The crimson
        reactor calls this at the end of each event-loop tick — every
        stripe submitted by ops processed in the tick has already
        joined the queue, so waiting longer buys no extra coalescing,
        only latency (the classic OSD has no such natural barrier and
        must rely on the time window).  No-op when nothing is queued."""
        with self._cond:
            if self._queues and not self._flush_now:
                self._flush_now = True
                self._cond.notify()

    def prewarm(self, ec_impl, sinfo: ecutil.StripeInfo
                ) -> Optional[threading.Thread]:
        """Pay the pool geometry's one-time costs at backend-build
        time instead of on the first client op (the reference pays GF
        table setup at plugin load — jerasure_init.cc:37, preloaded at
        global_init.cc:600): measure the CPU twin's rate for the
        crossover router, and on a card seed the h2d link estimate and
        run the batch shapes the coalescer dispatches through the
        device once (staging rings, kernel build, operand upload).
        Background thread — OSD boot is not stalled; a first op racing
        the warm simply shares the in-progress operand build (ChainLRU
        in-progress marker).  Once per geometry process-wide.

        Returns the warm thread (None when nothing was started).  Its
        failures are best-effort as in the reference, but the last one
        is kept in ``prewarm_error`` so a broken warm is visible."""
        if not self.prewarm_enabled or \
                not hasattr(ec_impl, "encode_batch_async"):
            return None
        # configure the backend's device mesh BEFORE any learner
        # seeding: the h2d EWMA and crossover thresholds are keyed per
        # mesh shape (_rekey_mesh), so the seed measurements below
        # must accrue to the shape real dispatches will ride.
        backend = getattr(getattr(ec_impl, "core", None),
                          "backend", None)
        if backend is not None and hasattr(backend, "configure_mesh"):
            backend.configure_mesh(self.mesh_devices, self.mesh_sp)
            self._note_mesh(backend)
        key = _geometry_key(ec_impl, sinfo)
        with self._cond:
            if key in EncodeBatcher._warmed:
                return None
            EncodeBatcher._warmed.add(key)

        def work():
            try:
                # the probe must be REPRESENTATIVE: a tiny buffer
                # under-measures the CPU twin (per-stripe call
                # overhead dominates), which makes device round trips
                # look competitive and mis-routes real batches
                nprobe = max(64, min(self.max_stripes, 256))
                probe = _Req(ec_impl, sinfo,
                             b"\0" * (sinfo.stripe_width * nprobe),
                             lambda _c: None)
                self._cpu_rate(key, probe)
                if not getattr(backend, "is_cuda", False):
                    return       # no card behind the codec: the CPU
                                 # path has nothing to warm
                dev = backend.device
                with torch.cuda.device(dev):
                    self._warm_device(ec_impl, sinfo, dev)
            except Exception as e:
                self.prewarm_error = e   # warms are best-effort
        t = threading.Thread(target=work, name="ec-prewarm", daemon=True)
        self._warm_threads = [x for x in self._warm_threads
                              if x.is_alive()] + [t]
        t.start()
        return t

    def _warm_device(self, ec_impl, sinfo: ecutil.StripeInfo,
                     dev) -> None:
        """The card half of prewarm(): seed the h2d link EWMA, then
        dispatch each batch shape twice and teach the crossover from
        the second (warm) call."""
        k = ec_impl.get_data_chunk_count()
        for nb in sorted({max(1, self.max_stripes),
                          max(1, self.max_stripes // 2)}):
            if self._stop:
                return
            z = np.zeros((nb, k, sinfo.chunk_size), dtype=np.uint8)
            if EncodeBatcher._h2d_bps <= 0:
                # seed the link estimate from a WARM transfer: the
                # first copy pays allocator/runtime warmup that is NOT
                # link cost — timing it under-states the link by an
                # order of magnitude and poisons the h2d/device/d2h
                # split AND the overlap model's bottleneck leg.  Copy
                # once cold (discarded), time the second, from pinned
                # memory as the staging pool copies.  Real batches
                # keep updating the EWMA afterwards (staging-pool
                # samples).
                try:
                    host = torch.zeros(z.shape, dtype=torch.uint8,
                                       pin_memory=True)
                    dst = torch.empty(z.shape, dtype=torch.uint8,
                                      device=dev)
                    stream = torch.cuda.current_stream(dev)
                    dst.copy_(host, non_blocking=True)
                    stream.synchronize()
                    t0 = time.monotonic()
                    dst.copy_(host, non_blocking=True)
                    stream.synchronize()
                    EncodeBatcher._h2d_bps = z.nbytes / max(
                        time.monotonic() - t0, 1e-9)
                    del host, dst
                except Exception as e:
                    self.prewarm_error = e
            t0 = time.monotonic()
            ec_impl.encode_batch_async(z).wait()      # cold
            dt = time.monotonic() - t0
            self.compile_count += 1
            self.compile_seconds += dt
            if self.bperf is not None:
                self.bperf.inc("compile_count")
                self.bperf.tinc("compile_seconds", dt)
            # SEED the crossover from a second, WARM call (timing the
            # first would fold the kernel build and first-touch
            # allocations into the estimate and misroute a healthy
            # device to the CPU twin): on a slow device link the very
            # first client op must already route to the CPU twin
            # instead of waiting out a doomed round trip
            t0 = time.monotonic()
            ec_impl.encode_batch_async(z).wait()
            warm_req = _Req(ec_impl, sinfo, z.tobytes(),  # copycheck: ok - one-time warmup calibration buffer
                            lambda _c: None)
            self._learn_crossover([warm_req], time.monotonic() - t0,
                                  trust_win=False)

    def stop(self, drain: float = 30.0) -> None:
        """Stop the collector, draining in-flight device work first
        (up to ``drain`` seconds) so no continuation lands after the
        caller unmounts the store.  Idle batchers return instantly."""
        with self._cond:
            self._stop = True
            self._cond.notify()
        deadline = time.monotonic() + max(drain, 0.1)
        self._thread.join(timeout=max(drain, 0.1))
        # the collector queued a sentinel on exit; the completion
        # worker drains every in-flight group behind it, then stops
        self._comp_thread.join(
            timeout=max(0.1, deadline - time.monotonic()))
        for t in self._dec_threads + self._warm_threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))

    def _note_copy(self, nbytes: int, site: str) -> None:
        self.bytes_copied += nbytes
        copytrack.note_copy(nbytes, site)
        if self.bperf is not None:
            self.bperf.inc("bytes_copied", nbytes)

    def _shard_views(self, arr: np.ndarray, parity: np.ndarray,
                     k: int, m: int) -> Dict[int, memoryview]:
        """Per-shard chunk buffers as 1-D byte memoryviews.

        The column gathers (arr[:, i] / parity[:, j]) are the ONE
        unavoidable copy on the encode output side — the
        [nstripes, k, chunk] layout interleaves shards, so each
        shard's chunks must be made contiguous exactly once.  The
        views then ride by reference through the sub-write
        transactions, the wire iovecs and the store with no further
        bytes()/tobytes() round trips.  memoryview compares by
        content, so callers that check chunks against reference
        encodes with == still work.
        """
        out: Dict[int, memoryview] = {}
        copied = 0
        for i in range(k):
            src = arr[:, i]
            col = np.ascontiguousarray(src)
            if col is not src:
                copied += col.nbytes
            out[i] = memoryview(col).cast("B")
        for j in range(m):
            src = parity[:, j]
            col = np.ascontiguousarray(src)
            if col is not src:
                copied += col.nbytes
            out[k + j] = memoryview(col).cast("B")
        if copied:
            self._note_copy(copied, "batcher.shard_gather")
        return out

    # -- collector -------------------------------------------------------
    def apply_tuning(self) -> None:
        """Re-read the runtime-tunable knobs from conf and apply them
        to the LIVE pipeline — no restart, bit-exact output (the
        knobs only shape batching/overlap, never data).  Called at
        the top of every collector cycle and from the OSD tuner tick,
        so a ``conf.set(..., source="runtime")`` (operator or
        autotuner) lands within one window:

        * ``ec_tpu_queue_window_max_us`` — coalescing-window ceiling;
          the dynamic window is re-clamped under ``_cond``.
        * ``ec_tpu_inflight_groups`` — the bounded completion FIFO's
          depth; ``queue.Queue`` checks ``maxsize`` under its own
          mutex on every put, so resizing it there (+ waking blocked
          putters) is the safe seam.
        * ``ec_tpu_staging_depth`` — forwarded to the codec backend's
          StagingPool (torch_engine) when one has been seen.
        """
        conf = self.conf
        if conf is None:
            return
        def get(k, d):
            try:
                return conf[k]
            except Exception:
                return d
        wmax = get("ec_tpu_queue_window_max_us", None)
        if wmax is not None:
            new_max = (wmax / 1e6) if wmax > 0 \
                else max(self.window_base_s * 16, 0.02)
            if new_max != self.window_max_s:
                with self._cond:
                    self.window_max_s = new_max
                    self.dyn_window_s = max(
                        min(self.dyn_window_s, new_max),
                        min(self.window_base_s, new_max))
        infl = get("ec_tpu_inflight_groups", None)
        if infl is not None:
            infl = max(1, int(infl))
            if infl != self.inflight_groups:
                self.inflight_groups = infl
                q = self._completions
                with q.mutex:
                    q.maxsize = infl
                    q.not_full.notify_all()
        depth = get("ec_tpu_staging_depth", None)
        backend = self._last_backend
        if depth is not None and backend is not None and \
                hasattr(backend, "configure_staging"):
            try:
                backend.configure_staging(int(depth))
            except Exception:
                pass

    def _run(self) -> None:
        while True:
            grew = False
            self.apply_tuning()
            with self._cond:
                while not self._queues and not self._stop:
                    self._cond.wait()
                if not self._queues and self._stop:
                    break       # sentinel queued below, OUTSIDE _cond
                # linger for the (admission-aware) window so concurrent
                # ops can join, unless the stripe budget is already met
                deadline = self._first_enqueue + self.dyn_window_s
                hard = self._first_enqueue + self.window_max_s
                seen = self._pending_stripes
                while (not self._stop and not self._flush_now
                       and self._pending_stripes < self.max_stripes):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        if self._pending_stripes > seen \
                                and deadline < hard:
                            # submits kept arriving: extend by one base
                            # window (bounded by window_max_s) and widen
                            # the next cycle's opening window
                            grew = True
                            self.window_grows += 1
                            seen = self._pending_stripes
                            self.dyn_window_s = min(
                                self.dyn_window_s * 2,
                                self.window_max_s)
                            deadline = min(
                                time.monotonic() + self.window_base_s,
                                hard)
                            continue
                        break
                    self._cond.wait(remaining)
                if self._flush_now or not grew:
                    # the queue drained inside the window (or the
                    # reactor tick cut it): shrink back toward the base
                    nw = max(self.window_base_s, self.dyn_window_s / 2)
                    if nw < self.dyn_window_s:
                        self.window_cuts += 1
                        self.dyn_window_s = nw
                queues, self._queues = self._queues, {}
                depth = sum(len(v) for v in queues.values())
                self.last_queue_depth = depth
                if depth > self.queue_depth_hwm:
                    self.queue_depth_hwm = depth
                self._pending_stripes = 0
                self._flush_now = False
            # dispatch EVERY group's device call before joining any:
            # group B's staging and enqueue overlap group A's parity
            # d2h and continuations.  Joins then run on the completion worker —
            # the collector immediately loops back to collect the
            # NEXT window, so up to ``inflight_groups`` encode groups
            # genuinely overlap (segment N+1's h2d during segment N's
            # fanout); the bounded queue's blocking put is the
            # throttle.
            groups = []
            for key, reqs in queues.items():
                if len(reqs) > self.group_reqs_hwm:
                    self.group_reqs_hwm = len(reqs)
                gstripes = sum(r.nstripes for r in reqs)
                if gstripes > self.group_stripes_hwm:
                    self.group_stripes_hwm = gstripes
                if key[0] == "dec":
                    # decode groups route + dispatch HERE like encode
                    # groups: the async handle rides the
                    # same bounded completion queue, so decode honors
                    # ec_tpu_inflight_groups and pipelines its h2d
                    # under the previous group's compute
                    groups.append((key, reqs,
                                   self._route_dec_group(key, reqs)))
                    continue
                if key[0] == "delta":
                    # parity-delta groups route + dispatch like
                    # decode groups: async handle on the bounded
                    # completion queue, h2d pipelined under the
                    # previous group's compute
                    groups.append((key, reqs,
                                   self._route_delta_group(key,
                                                           reqs)))
                    continue
                to_cpu = self._route_to_cpu(key, reqs)
                if not to_cpu and self._breaker_blocks():
                    to_cpu = True
                self._note_route(key, reqs, to_cpu)
                groups.append((key, reqs, "cpu" if to_cpu
                               else self._dispatch_group(reqs)))
            for key, reqs, handle in groups:
                self._completions.put((key, reqs, handle,
                                       len(groups)))
                if self.dperf is not None:
                    depth = self._completions.qsize()
                    self.dperf.set("inflight_groups_now", depth)
                    if depth > self._inflight_hwm:
                        self._inflight_hwm = depth
                        self.dperf.set("inflight_groups_hwm", depth)
        # shutdown: queue the completion-worker sentinel with _cond
        # RELEASED — _completions is bounded, and a blocking put while
        # holding the cond would deadlock against any continuation
        # that re-enters submit()/flush() (which take _cond)
        self._completions.put(None)   # worker: drain + exit

    def _completion_loop(self) -> None:
        """FIFO join of dispatched groups (continuations preserve
        submission order — the contract ECBackend::check_ops needs).
        A continuation that raises must not kill the worker — that
        would wedge every EC write on the OSD — so each group is
        fault-isolated to its own ops."""
        while True:
            item = self._completions.get()
            if item is None:
                return
            key, reqs, handle, ngroups = item
            try:
                if handle == "dec":
                    self._complete_group_dec(key, reqs)
                elif handle == "dec_cpu":
                    self._complete_group_dec_twin(key, reqs)
                elif isinstance(handle, tuple) and handle \
                        and handle[0] == "decdev":
                    self._complete_group_dec_dev(
                        key, reqs, handle,
                        trust_win=(ngroups == 1))
                elif handle == "delta_cpu":
                    self._complete_group_delta_twin(key, reqs)
                elif isinstance(handle, tuple) and handle \
                        and handle[0] == "deltadev":
                    self._complete_group_delta_dev(
                        key, reqs, handle,
                        trust_win=(ngroups == 1))
                elif handle == "cpu":
                    self._complete_group_cpu(reqs)
                else:
                    # loss-direction learning runs on EVERY group
                    # (raising the threshold is safe even when
                    # sibling completions inflate dev_time — worst
                    # case we conservatively route small batches to
                    # the CPU twin); the win direction (lowering it)
                    # only trusts single-group cycles
                    self._complete_group(reqs, handle, learn=True,
                                         trust_win=(ngroups == 1))
            except Exception:
                # fail every rider op that has not completed yet: a
                # worker-level fault must surface as EIO on the
                # affected ops, never as a hang
                self._cb_error(reqs)

    def _route_to_cpu(self, key: Tuple, reqs: List[_Req]) -> bool:
        """True when the learned crossover says this batch is too
        small to pay the device round trip."""
        if not self.adaptive_cpu or self._min_device_bytes <= 0:
            self._route_reason = "device"
            return False
        total = sum(r.nbytes for r in reqs)
        if total >= self._min_device_bytes:
            self._route_reason = "device"
            return False
        # idle re-probe: a device that served ZERO traffic for a
        # whole idle period gets one group as a probe IMMEDIATELY —
        # a learned CPU bias with no device activity behind it is
        # exactly the misrouting failure mode (every encode on the
        # twin, crossover never challenged), and on a lightly loaded
        # OSD the 1-in-N tick below may take minutes to fire.  Rate
        # limited to one probe per idle period so an actually-slow
        # device is not hammered.
        #
        # A crossover sitting AT (or under) an operator/calibration
        # pin is not learned bias — it is the measured answer for
        # this machine, and the pin's contract is DETERMINISTIC
        # routing (see __init__) — so below-pin groups take the twin
        # with no probe taxes at all; only a threshold the LEARNER
        # pushed above the pin (or learned from scratch) gets
        # challenged by the idle/tick probes below.
        cls = EncodeBatcher
        if 0 < cls._pinned_min_device_bytes and \
                cls._min_device_bytes <= cls._pinned_min_device_bytes:
            self._route_reason = "pin"
            return True
        now = time.monotonic()
        if self.idle_reprobe_s > 0 and \
                now - cls._last_device_ts > self.idle_reprobe_s and \
                now - cls._last_idle_probe_ts > self.idle_reprobe_s:
            cls._last_idle_probe_ts = now
            self._route_reason = "idle_probe"
            return False
        # periodic probe: route an occasional small batch to the
        # device anyway so the threshold can come back down when the
        # link/device recovers.  The tick is class-level like the
        # crossover it refreshes: 13 in-process OSDs share ONE
        # learned threshold, so they should share one probe cadence
        # instead of each paying its own 1-in-N device round trips
        # (per-instance ticks also mean a primary seeing few ops
        # never probes at all)
        EncodeBatcher._probe_tick += 1
        blocked = EncodeBatcher._probe_tick % self.probe_interval != 0
        self._route_reason = "learned" if blocked else "tick_probe"
        return blocked

    def _breaker_blocks(self) -> bool:
        """True when the open circuit breaker routes this encode
        group to the coalesced CPU twin.  Rides the shared probe tick
        so 1-in-``probe_interval`` groups still reach the device as
        re-admission probes — a probe that completes closes the
        breaker (_device_success)."""
        if not EncodeBatcher._breaker_open:
            return False
        EncodeBatcher._probe_tick += 1
        blocked = EncodeBatcher._probe_tick % self.probe_interval != 0
        self._route_reason = "breaker_open" if blocked \
            else "breaker_probe"
        return blocked

    def _note_route(self, key: Tuple, reqs: List[_Req],
                    to_cpu: bool) -> None:
        """Publish one routing verdict: reason-coded counter in the
        ec_device subsystem + one flight-recorder event.  Collector
        thread only — no locking beyond the perf counters' own."""
        reason = self._route_reason or \
            ("learned" if to_cpu else "device")
        self._route_reason = None
        if self.dperf is not None and \
                f"route_{reason}" in self.dperf._types:
            self.dperf.inc(f"route_{reason}")
        rec = self.recorder
        if rec is not None:
            rec.note("route", reason=reason,
                     to="cpu" if to_cpu else "device",
                     bytes=sum(r.nbytes for r in reqs),
                     reqs=len(reqs),
                     crossover=int(EncodeBatcher._min_device_bytes))

    def _device_failure(self, kind: str) -> None:
        """Record one classified device failure (post-retry); opens
        the breaker after ``ec_tpu_device_error_threshold``
        consecutive failures."""
        self.device_errors += 1
        if self.bperf is not None:
            self.bperf.inc("device_errors")
        opened = False
        cls = EncodeBatcher
        with cls._breaker_lock:
            cls._breaker_failures += 1
            if not cls._breaker_open and \
                    cls._breaker_failures >= self.device_error_threshold:
                cls._breaker_open = True
                cls._breaker_opens += 1
                opened = True
        rec = self.recorder
        if rec is not None:
            rec.note("device_error", error=kind,
                     failures=cls._breaker_failures,
                     breaker_opened=opened)
        if kind == "decode":
            hook = self.on_decode_fault
            if hook is not None:
                try:
                    hook()
                except Exception:
                    pass             # telemetry must not kill decode
        if opened:
            if self.bperf is not None:
                self.bperf.inc("breaker_open")
            if self.dperf is not None:
                self.dperf.inc("breaker_opened")
                self.dperf.set("breaker_open_now", 1)
            # breaker-open is an incident: dump the recent routing/
            # error evidence while it is still in the ring
            if rec is not None:
                rec.note("breaker", state="open", cause=kind)
                rec.auto_dump("breaker-open")

    def _device_success(self) -> None:
        """A device call completed: clear the consecutive-failure
        run; if this was a probe through an open breaker, re-admit
        the device."""
        cls = EncodeBatcher
        cls._last_device_ts = time.monotonic()
        if not cls._breaker_failures and not cls._breaker_open:
            return                   # hot path: nothing to clear
        closed = False
        with cls._breaker_lock:
            cls._breaker_failures = 0
            if cls._breaker_open:
                cls._breaker_open = False
                cls._breaker_closes += 1
                closed = True
        if closed:
            # re-admission must come with FRESH routing stats: while
            # the breaker was open every group encoded on the twin
            # and the learner could only accumulate CPU bias, so the
            # crossover snaps back to the operator's pin (or fully
            # unlearned) and the device gets re-tried on its merits
            cls._min_device_bytes = cls._pinned_min_device_bytes
            cls._dec_min_device_bytes = 0.0   # re-seed from encode
            cls._delta_min_device_bytes = 0.0
            cls._dev_bps = {}
            if self.bperf is not None:
                self.bperf.inc("breaker_close")
            if self.dperf is not None:
                self.dperf.inc("breaker_closed")
                self.dperf.set("breaker_open_now", 0)
            if self.recorder is not None:
                self.recorder.note("breaker", state="closed",
                                   crossover=int(
                                       cls._min_device_bytes))

    def _cb_error(self, reqs=None) -> None:
        """Report a continuation/encode failure.  During shutdown the
        op is already dead (teardown races deliver into an unmounting
        OSD — e.g. 'store not mounted'), so stay quiet rather than
        spraying tracebacks over the console and bench output.

        When ``reqs`` is given, every request that has not seen its
        callback yet gets ``cb(None)`` so its write op fails with EIO
        back through the EC backend instead of hanging until the
        client op timeout."""
        if not self._stop:
            import traceback
            traceback.print_exc()
            self.encode_errors += 1
            if self.bperf is not None:
                self.bperf.inc("ec_encode_errors")
            # a client op is about to die with EIO — flight-record
            # the failure and dump the evidence around it (the chaos
            # soak's "client error" incident trigger)
            if self.recorder is not None:
                self.recorder.note("encode_error",
                                   reqs=len(reqs or ()))
                self.recorder.auto_dump("client-encode-error")
        for r in (reqs or ()):
            if r.done:
                continue
            r.done = True
            try:
                r.cb(None)
            except Exception:
                pass                 # op teardown races

    @classmethod
    def reset_learning(cls) -> None:
        """Forget the shared crossover/rates and breaker state
        (tests; ops can call it after a hardware change)."""
        cls._min_device_bytes = 0.0
        cls._pinned_min_device_bytes = 0.0
        cls._dec_min_device_bytes = 0.0
        cls._delta_min_device_bytes = 0.0
        cls._probe_tick = 0
        cls._cpu_bps = {}
        cls._dev_bps = {}
        cls._warmed = set()
        cls._h2d_bps = 0.0
        cls._mesh_state = {}
        cls._mesh_key = None
        cls._last_device_ts = time.monotonic()
        cls._last_idle_probe_ts = time.monotonic()
        cls.reset_breaker()

    @classmethod
    def reset_breaker(cls) -> None:
        """Zero the breaker state/counters WITHOUT forgetting the
        learned crossover (bench runs isolate their breaker stats but
        keep the routing calibration)."""
        with cls._breaker_lock:
            cls._breaker_failures = 0
            cls._breaker_open = False
            cls._breaker_opens = 0
            cls._breaker_closes = 0

    @classmethod
    def _rekey_mesh(cls, key: Optional[Tuple]) -> None:
        """Swap the shared routing/link learner scalars to the state
        belonging to mesh shape ``key`` ((dp, sp), or None for single
        chip).  The h2d EWMA and the crossover thresholds model the
        AGGREGATE device+ICI bandwidth of the active mesh — carrying a
        single-chip estimate into a 4x2 mesh (or back) misroutes every
        batch until the learner recovers.  The outgoing shape's state
        is stashed, so flipping back restores what was learned."""
        if key == cls._mesh_key:
            return
        cls._mesh_state[cls._mesh_key] = {
            "h2d_bps": cls._h2d_bps,
            "min_device_bytes": cls._min_device_bytes,
            "pinned_min_device_bytes": cls._pinned_min_device_bytes,
            "dec_min_device_bytes": cls._dec_min_device_bytes,
            "delta_min_device_bytes": cls._delta_min_device_bytes,
            "dev_bps": dict(cls._dev_bps),
        }
        st = cls._mesh_state.get(key)
        if st is not None:
            cls._h2d_bps = st["h2d_bps"]
            cls._min_device_bytes = st["min_device_bytes"]
            cls._pinned_min_device_bytes = st["pinned_min_device_bytes"]
            cls._dec_min_device_bytes = st["dec_min_device_bytes"]
            cls._delta_min_device_bytes = st.get(
                "delta_min_device_bytes", 0.0)
            cls._dev_bps = dict(st["dev_bps"])
        # first time on this shape: keep the current scalars as the
        # seed (a mesh is at worst as fast as one of its chips)
        cls._mesh_key = key

    def _note_mesh(self, backend) -> None:
        """Fold the backend's active mesh into the batcher's
        telemetry: rekey the learner state to the mesh shape, set the
        mesh_* gauges, and (once) drain the backend's mesh_build
        events into the flight recorder so a misconfigured mesh is
        diagnosable from the admin socket."""
        # one card (TorchBackend.mesh_info() is None): the learner
        # state belongs to the single-device key None
        info = backend.mesh_info() if hasattr(backend, "mesh_info") \
            else None
        key = (info["dp"], info["sp"]) if info else None
        EncodeBatcher._rekey_mesh(key)
        dp = self.dperf
        if dp is not None and "mesh_dp" in dp._types:
            dp.set("mesh_dp", info["dp"] if info else 0)
            dp.set("mesh_sp", info["sp"] if info else 0)
            dp.set("mesh_devices", info["n_devices"] if info else 0)
        rec = self.recorder
        if rec is not None and not self._mesh_noted:
            self._mesh_noted = True
            for ev in list(getattr(backend, "mesh_events", ()) or ()):
                rec.note("mesh_build",
                         dp=ev.get("dp"), sp=ev.get("sp"),
                         n_devices=ev.get("n_devices"),
                         device_ids=ev.get("device_ids"))

    def _cpu_rate(self, key: Tuple, req: _Req) -> float:
        """CPU twin throughput for this geometry, measured once on
        real data (bytes/sec); shared process-wide."""
        rate = self._cpu_bps.get(key)
        if rate is None:
            t0 = time.monotonic()
            self._cpu_encode(req)
            dt = max(time.monotonic() - t0, 1e-6)
            rate = req.nbytes / dt
            EncodeBatcher._cpu_bps[key] = rate
        return rate

    def _complete_group_cpu(self, reqs: List[_Req]) -> None:
        """Coalesced device-free encode: the whole group's stripes go
        through ONE batched kernel call on the _BatchTwin (native C++
        when available) — the coalescing win survives CPU routing."""
        t_form = time.monotonic()
        t_wall = time.time()
        self._account_queue_wait(reqs, t_form)
        for r in reqs:
            if r.tracked is not None:
                r.tracked.mark_event("ec:batch_dispatched")
        chunks_list: Optional[List] = None
        try:
            sinfo = reqs[0].sinfo
            k = reqs[0].ec_impl.get_data_chunk_count()
            m = reqs[0].ec_impl.get_coding_chunk_count()
            twin = self.cpu_twin(reqs[0].ec_impl, sinfo)
            arrs = [r.as_array(k) for r in reqs]
            if len(arrs) > 1:
                batch = np.concatenate(arrs, axis=0)
                self._note_copy(batch.nbytes, "batcher.batch_concat")
            else:
                batch = arrs[0]
            parity = twin.encode_batch(batch)
            self.cpu_calls += 1
            # twin encode is pure compute: no transfer legs
            self.stage_seconds["device"] += \
                time.monotonic() - t_form
            # twin groups still fold into the device waterfall: a
            # coarse two-stamp ledger keyed device=-1 (host), so
            # dump_device and the bench attribution account for every
            # group regardless of routing.  No h2d/d2h stamps — the
            # whole interval charges to the compute fence — and the
            # overlap engine ignores negative device ids (a host
            # group has no transfer to hide under compute).
            t_done = time.time()
            self._observe_device_ledger(
                {"stage_acquire": t_wall, "compute_start": t_wall,
                 "compute_done": t_done, "deliver": t_done,
                 "device": -1, "bytes": int(batch.nbytes),
                 "stripes": int(batch.shape[0]), "group": "encode"})
            if self.bperf is not None:
                self.bperf.hinc("batch_stripes", batch.shape[0])
                self.bperf.inc("cpu_reqs", len(reqs))
                if len(reqs) > 1:
                    self.bperf.inc("coalesced_reqs", len(reqs))
            if len(reqs) > 1:
                self.reqs_coalesced += len(reqs)
                if self.perf is not None:
                    self.perf.inc("ec_batch_coalesced", len(reqs))
            chunks_list = []
            off = 0
            for r, arr in zip(reqs, arrs):
                p = parity[off:off + r.nstripes]
                off += r.nstripes
                chunks_list.append(
                    self._shard_views(arr, p, k, m))
        except Exception:
            chunks_list = None
        if chunks_list is None:
            # twin trouble: per-request fallback (still device-free)
            chunks_list = []
            for r in reqs:
                try:
                    chunks = self._cpu_encode(r)
                    self.cpu_calls += 1
                except Exception:
                    self._cb_error()
                    chunks = None
                chunks_list.append(chunks)
        for r, chunks in zip(reqs, chunks_list):
            self.reqs_total += 1
            self.cpu_reqs += 1
            try:
                r.done = True
                r.cb(chunks)
            except Exception:
                self._cb_error()

    def _complete_group_dec(self, key: Tuple,
                            reqs: List[_DecReq]) -> None:
        """One batched reconstruction for every decode request of one
        (geometry, erasure-signature) group.  Routing mirrors the
        encode side: below the learned crossover the batch decodes on
        the _BatchTwin (one native C++ call); above it, on the device
        codec's signature-cached compiled kernel.  Device round trips
        run on their OWN thread — a congested-tunnel decode stalling
        the collector would block every pending encode group behind
        it (the encode path likewise dispatches all groups before
        joining any)."""
        sinfo = reqs[0].sinfo
        total = sum(sum(ecutil.nbytes_of(v) for v in r.have.values())
                    for r in reqs)
        impl = None
        if (self.adaptive_cpu and self._dec_min_bytes() > 0 and
                total < self._dec_min_bytes()) or \
                self._breaker_blocks():
            try:
                impl = self.cpu_twin(reqs[0].ec_impl, sinfo)
            except Exception:
                impl = None
        on_twin = impl is not None
        # publish the verdict (and consume _route_reason so a decode
        # probe through the breaker cannot leak its reason into the
        # next encode group's _note_route)
        reason = self._route_reason
        self._route_reason = None
        if reason is None:
            reason = "learned" if on_twin else "device"
        if self.dperf is not None and \
                f"dec_route_{reason}" in self.dperf._types:
            self.dperf.inc(f"dec_route_{reason}")
        if impl is None:
            impl = reqs[0].ec_impl
        if on_twin:
            self._exec_group_dec(key, reqs, impl, on_twin)
        else:
            t = threading.Thread(
                target=self._exec_group_dec,
                args=(key, reqs, impl, on_twin),
                name="ec-dec-dev", daemon=True)
            # tracked so stop() can honor its drain contract (no
            # continuation after the caller unmounts the store)
            self._dec_threads = [x for x in self._dec_threads
                                 if x.is_alive()] + [t]
            t.start()

    def _exec_group_dec(self, key: Tuple, reqs: List[_DecReq],
                        impl, on_twin: bool) -> None:
        sinfo = reqs[0].sinfo
        cs = sinfo.chunk_size
        have_ids, missing = key[2], key[3]
        try:
            present = {
                s: (np.concatenate(
                    [ecutil.as_stripe_array(r.have[s], r.nstripes,
                                            1, cs)
                     .reshape(r.nstripes, cs) for r in reqs], axis=0)
                    if len(reqs) > 1 else
                    ecutil.as_stripe_array(
                        reqs[0].have[s], reqs[0].nstripes, 1, cs)
                    .reshape(-1, cs))
                for s in have_ids}
        except Exception:
            present = None           # malformed input, not a device
                                     # fault: per-request fallback
        rec = None
        if present is not None:
            try:
                if not on_twin:
                    faultlib.registry().hit(faultlib.DEVICE_DISPATCH)
                t0 = time.time()
                rec = impl.decode_batch(present, cs)
                # decode_batch is a fenced synchronous call, so the
                # group ledger is coarse: the whole interval charges
                # to the compute fence.  Still keyed and accumulated
                # like encode groups so the read path shows up in
                # the device waterfall; twin-routed groups carry
                # device=-1 (host lane, excluded from overlap).
                t1 = time.time()
                led = {"stage_acquire": t0, "compute_start": t0,
                       "compute_done": t1, "deliver": t1,
                       "group": "decode"}
                if on_twin:
                    led["device"] = -1
                self._observe_device_ledger(led)
                if not on_twin:
                    self._device_success()
            except Exception:
                rec = None
                if not on_twin:
                    self._device_failure("decode")
        if rec is None:
            # group decode trouble: per-request fallback
            for r in reqs:
                try:
                    dec = ecutil.decode(sinfo, r.ec_impl, r.have,
                                        set(r.want))
                except Exception:
                    self._cb_error()
                    dec = None
                self.dec_reqs += 1
                try:
                    r.done = True
                    r.cb(dec)
                except Exception:
                    self._cb_error()
            return
        self.dec_calls += 1
        self.dec_reqs += len(reqs)
        if len(reqs) > 1:
            self.dec_coalesced += len(reqs)
        if on_twin:
            self.dec_cpu_reqs += len(reqs)
        if self.perf is not None:
            self.perf.inc("ec_dec_batch_calls")
            if len(reqs) > 1:
                self.perf.inc("ec_dec_batch_coalesced", len(reqs))
        off = 0
        for r in reqs:
            # reconstructed shards from the batched call; wanted
            # shards that were read directly pass through (same
            # contract as ecutil.decode)
            out = {}
            for s in r.want:
                if s in missing:
                    # row slice of a contiguous [B, cs] batch result:
                    # ascontiguousarray is a no-copy view here, and
                    # the memoryview rides downstream by reference
                    out[s] = memoryview(np.ascontiguousarray(
                        rec[s][off:off + r.nstripes])).cast("B")
                else:
                    h = r.have[s]
                    out[s] = h if isinstance(h, bytes) else \
                        memoryview(h).cast("B")
            off += r.nstripes
            try:
                r.done = True
                r.cb(out)
            except Exception:
                self._cb_error()

    # -- decode device pipeline ---------------------------------------
    def _dec_min_bytes(self) -> float:
        """The decode-side crossover threshold.  Decode keeps its own
        learned value (recovery moves k survivor chunks IN per erased
        chunk OUT, so its transfer economics differ from encode's
        k-in/m-out), but until decode groups have taught it anything
        it is SEEDED from the encode EWMA — the device and link are
        the same hardware, so encode's measurement beats flying
        blind on the first rebuild window."""
        cls = EncodeBatcher
        if cls._dec_min_device_bytes > 0:
            return cls._dec_min_device_bytes
        return cls._min_device_bytes

    def _route_dec_group(self, key: Tuple, reqs: List[_DecReq]):
        """Collect-time routing + dispatch for one decode group.
        Returns the completion-queue handle:

        * ``("decdev", handles, t_disp, in_bytes)`` — async device
          dispatch in flight (joined by _complete_group_dec_dev);
        * ``"dec_cpu"`` — routed to the CPU twin (verdict already
          published);
        * ``"dec"`` — legacy completion-time path for codecs without
          the async decode API (routing happens there)."""
        impl = reqs[0].ec_impl
        sup = getattr(impl, "decode_async_supported", None)
        if sup is None or not hasattr(impl, "decode_batch_async"):
            return "dec"
        try:
            if not sup():
                return "dec"
        except Exception:
            return "dec"
        to_cpu = self._route_to_cpu_dec(key, reqs)
        if not to_cpu and self._breaker_blocks():
            to_cpu = True
        self._note_route_dec(key, reqs, to_cpu)
        if to_cpu:
            return "dec_cpu"
        handle = self._dispatch_group_dec(key, reqs)
        if handle is None:
            return "dec_cpu"         # dispatch failed: twin serves
        return ("decdev",) + handle

    def _route_to_cpu_dec(self, key: Tuple,
                          reqs: List[_DecReq]) -> bool:
        """_route_to_cpu with the decode-side crossover: same
        pin/idle-probe/tick-probe ladder (shared probe cadence and
        idle clocks — the device is one machine property), judged
        against _dec_min_bytes()."""
        if not self.adaptive_cpu:
            self._route_reason = "device"
            return False
        thr = self._dec_min_bytes()
        if thr <= 0:
            self._route_reason = "device"
            return False
        cs = reqs[0].sinfo.chunk_size
        total = sum(r.nstripes * cs * len(r.have) for r in reqs)
        if total >= thr:
            self._route_reason = "device"
            return False
        cls = EncodeBatcher
        if 0 < cls._pinned_min_device_bytes and \
                thr <= cls._pinned_min_device_bytes:
            self._route_reason = "pin"
            return True
        now = time.monotonic()
        if self.idle_reprobe_s > 0 and \
                now - cls._last_device_ts > self.idle_reprobe_s and \
                now - cls._last_idle_probe_ts > self.idle_reprobe_s:
            cls._last_idle_probe_ts = now
            self._route_reason = "idle_probe"
            return False
        cls._probe_tick += 1
        blocked = cls._probe_tick % self.probe_interval != 0
        self._route_reason = "learned" if blocked else "tick_probe"
        return blocked

    def _note_route_dec(self, key: Tuple, reqs: List[_DecReq],
                        to_cpu: bool) -> None:
        """Publish one decode routing verdict (dec_route_* counter +
        flight-recorder event).  Collector thread only."""
        reason = self._route_reason or \
            ("learned" if to_cpu else "device")
        self._route_reason = None
        if self.dperf is not None and \
                f"dec_route_{reason}" in self.dperf._types:
            self.dperf.inc(f"dec_route_{reason}")
        rec = self.recorder
        if rec is not None:
            cs = reqs[0].sinfo.chunk_size
            rec.note("dec_route", reason=reason,
                     to="cpu" if to_cpu else "device",
                     bytes=sum(r.nstripes * cs * len(r.have)
                               for r in reqs),
                     reqs=len(reqs),
                     crossover=int(self._dec_min_bytes()))

    def _dispatch_group_dec(self, key: Tuple, reqs: List[_DecReq]):
        """Issue the async device decode for one (geometry,
        erasure-signature) group: concat every request's survivor
        chunks into one [B, cs] stack per shard id and dispatch
        tile-by-tile through decode_batch_async (signature-cached
        combined recovery rows, StagingPool staging, full seven-phase
        ledger).  Returns (handles, t_disp, in_bytes) or None on
        dispatch failure."""
        t_form = time.monotonic()
        self._account_queue_wait(reqs, t_form)
        sinfo = reqs[0].sinfo
        cs = sinfo.chunk_size
        have_ids = key[2]
        try:
            present = {
                s: (np.concatenate(
                    [ecutil.as_stripe_array(r.have[s], r.nstripes,
                                            1, cs)
                     .reshape(r.nstripes, cs) for r in reqs], axis=0)
                    if len(reqs) > 1 else
                    ecutil.as_stripe_array(
                        reqs[0].have[s], reqs[0].nstripes, 1, cs)
                    .reshape(-1, cs))
                for s in have_ids}
            if len(reqs) > 1:
                self._note_copy(sum(v.nbytes
                                    for v in present.values()),
                                "batcher.dec_batch_concat")
        except Exception:
            # malformed request payload: NOT a device fault (must not
            # trip the breaker) — the twin path fails the bad rider
            # per-request and still serves its group-mates
            return None
        nstripes = sum(r.nstripes for r in reqs)
        in_bytes = sum(v.nbytes for v in present.values())
        tile = max(1, self.max_stripes)
        handles = None
        delay = self.device_retry_s
        for attempt in range(3):
            try:
                faultlib.registry().hit(faultlib.DEVICE_DISPATCH)
                handles = [
                    reqs[0].ec_impl.decode_batch_async(
                        {s: v[i:i + tile]
                         for s, v in present.items()}, cs)
                    for i in range(0, nstripes, tile)]
                break
            except Exception:
                handles = None
                if attempt < 2 and delay > 0:
                    time.sleep(min(delay, 0.1))
                    delay *= 2
        if handles is None:
            self._device_failure("dispatch")
            return None
        t_disp = time.monotonic()
        EncodeBatcher._last_device_ts = t_disp
        self.stage_seconds["batch_form"] += t_disp - t_form
        if self.bperf is not None:
            self.bperf.hinc("batch_stripes", nstripes)
            self.bperf.inc("h2d_bytes", in_bytes)
        return (handles, t_disp, in_bytes)

    def _complete_group_dec_twin(self, key: Tuple,
                                 reqs: List[_DecReq]) -> None:
        """Execute a decode group the collect-time router already
        sent to the CPU (verdict published there — no re-routing)."""
        impl = None
        try:
            impl = self.cpu_twin(reqs[0].ec_impl, reqs[0].sinfo)
        except Exception:
            impl = None
        on_twin = impl is not None
        if impl is None:
            impl = reqs[0].ec_impl
        self._exec_group_dec(key, reqs, impl, on_twin)

    def _complete_group_dec_dev(self, key: Tuple,
                                reqs: List[_DecReq], handle,
                                trust_win: bool = True) -> None:
        """Join one in-flight device decode group: the decode twin of
        _complete_group.  Harvests the seven-phase ledgers, folds h2d
        samples into the link EWMA, teaches the decode crossover, and
        splits the reconstructed [B, cs] stacks back to each rider's
        callback.  Device trouble falls the WHOLE group back to the
        batched CPU twin — zero client errors."""
        _tag, handles, t_disp, in_bytes = handle
        sinfo = reqs[0].sinfo
        missing = key[3]
        rec = None
        dev_time = None
        out_bytes = 0
        try:
            faultlib.registry().hit(faultlib.DEVICE_COMPLETION)
            parts = [h.wait() for h in handles]
            rec = parts[0] if len(parts) == 1 else {
                e: np.concatenate([p[e] for p in parts], axis=0)
                for e in parts[0]}
            out_bytes = sum(v.nbytes for v in rec.values())
            dev_time = time.monotonic() - t_disp
            self._device_success()
            for h in handles:
                hb = getattr(h, "h2d_bytes", 0)
                hs = getattr(h, "h2d_seconds", 0.0)
                if hb and hs > 0:
                    bps = hb / hs
                    EncodeBatcher._h2d_bps = bps \
                        if EncodeBatcher._h2d_bps <= 0 else (
                            0.7 * EncodeBatcher._h2d_bps + 0.3 * bps)
        except Exception:
            rec = None
            self._device_failure("completion")
        if rec is None:
            self._complete_group_dec_twin(key, reqs)
            return
        if self.adaptive_cpu:
            self._learn_crossover_dec(key, reqs, dev_time, in_bytes,
                                      out_bytes, trust_win=trust_win)
        self.dec_calls += 1
        self.dec_reqs += len(reqs)
        if len(reqs) > 1:
            self.dec_coalesced += len(reqs)
        if self.perf is not None:
            self.perf.inc("ec_dec_batch_calls")
            if len(reqs) > 1:
                self.perf.inc("ec_dec_batch_coalesced", len(reqs))
        # fenced-window stage split, same link-rate model as encode
        h2d_s = d2h_s = 0.0
        if self._h2d_bps > 0:
            h2d_s = min(dev_time, in_bytes / self._h2d_bps)
            d2h_s = min(dev_time - h2d_s, out_bytes / self._h2d_bps)
        self.stage_seconds["h2d"] += h2d_s
        self.stage_seconds["d2h"] += d2h_s
        self.stage_seconds["device"] += max(
            0.0, dev_time - h2d_s - d2h_s)
        if self.bperf is not None:
            self.bperf.hinc("dispatch_ms", dev_time * 1e3)
            self.bperf.inc("d2h_bytes", out_bytes)
            self.bperf.inc("device_reqs", len(reqs))
            if len(reqs) > 1:
                self.bperf.inc("coalesced_reqs", len(reqs))
        for h in handles:
            # a mesh dispatch carries one ledger clone per chip
            # (AsyncBatch.ledgers); single-chip keeps the scalar
            leds = getattr(h, "ledgers", None) or \
                [getattr(h, "ledger", None)]
            for led in leds:
                if led is not None:
                    led["group"] = "decode"
                self._observe_device_ledger(led)
        self._publish_device_telemetry(reqs[0].ec_impl)
        off = 0
        for r in reqs:
            out = {}
            for s in r.want:
                if s in missing:
                    out[s] = memoryview(np.ascontiguousarray(
                        rec[s][off:off + r.nstripes])).cast("B")
                else:
                    hv = r.have[s]
                    out[s] = hv if isinstance(hv, bytes) else \
                        memoryview(hv).cast("B")
            off += r.nstripes
            try:
                r.done = True
                r.cb(out)
            except Exception:
                self._cb_error()

    def _cpu_rate_dec(self, key: Tuple,
                      reqs: List[_DecReq]) -> float:
        """CPU twin DECODE throughput for this geometry (bytes of
        survivor input per second), measured once on real data;
        shared process-wide like _cpu_rate."""
        rk = ("dec", key[1])
        rate = EncodeBatcher._cpu_bps.get(rk)
        if rate is None:
            r = reqs[0]
            cs = r.sinfo.chunk_size
            try:
                twin = self.cpu_twin(r.ec_impl, r.sinfo)
                present = {
                    s: ecutil.as_stripe_array(r.have[s], r.nstripes,
                                              1, cs)
                    .reshape(r.nstripes, cs) for s in r.have}
                t0 = time.monotonic()
                twin.decode_batch(present, cs)
                dt = max(time.monotonic() - t0, 1e-6)
                rate = sum(v.nbytes for v in present.values()) / dt
            except Exception:
                # no twin: fall back to the encode-side measurement
                # (same matmul cost model) rather than guessing
                rate = EncodeBatcher._cpu_bps.get(key[1], 0.0)
            EncodeBatcher._cpu_bps[rk] = rate
        return rate

    def _learn_crossover_dec(self, key: Tuple, reqs: List[_DecReq],
                             dev_time: float, in_bytes: int,
                             out_bytes: int,
                             trust_win: bool = True) -> None:
        """_learn_crossover for decode groups: the same pipelined
        cost model (max of the h2d/compute/d2h legs vs the CPU twin's
        prediction) and compile/outlier rejection, but moving the
        DECODE-side threshold and its own per-geometry device-rate
        EWMA bucket."""
        try:
            cls = EncodeBatcher
            rk = ("dec", key[1])
            cpu_rate = max(self._cpu_rate_dec(key, reqs), 1.0)
            cpu_pred = in_bytes / cpu_rate
            h2d_s = d2h_s = 0.0
            if cls._h2d_bps > 0:
                h2d_s = min(dev_time, in_bytes / cls._h2d_bps)
                d2h_s = min(max(0.0, dev_time - h2d_s),
                            out_bytes / cls._h2d_bps)
            compute_s = max(0.0, dev_time - h2d_s - d2h_s)
            rate = cls._dev_bps.get(rk, 0.0)
            if rate > 0 and compute_s > 5.0 * (in_bytes / rate) \
                    and compute_s > 1e-3:
                return               # compile/stall outlier
            if compute_s > 0:
                bps = in_bytes / compute_s
                cls._dev_bps[rk] = bps if rate <= 0 else (
                    0.7 * rate + 0.3 * bps)
            dev_pipe = max(h2d_s, compute_s, d2h_s) \
                if (h2d_s or d2h_s) else dev_time
            cur = self._dec_min_bytes()
            if dev_pipe > cpu_pred:
                cls._dec_min_device_bytes = max(
                    cur, dev_pipe * cpu_rate / 2, self.crossover_min)
            elif trust_win and dev_pipe < cpu_pred / 2 and cur > 0:
                cls._dec_min_device_bytes = min(cur, in_bytes / 2)
        except Exception:
            pass                     # learning is best-effort

    # -- parity-delta device pipeline (sub-stripe overwrite RMW) -------
    def _delta_min_bytes(self) -> float:
        """The parity-delta crossover threshold.  Delta keeps its own
        learned value (a delta call moves D dirty columns IN per m
        parity columns OUT — different transfer economics from both
        encode and decode), seeded from the encode EWMA until delta
        groups have taught it anything, same as the decode side."""
        cls = EncodeBatcher
        if cls._delta_min_device_bytes > 0:
            return cls._delta_min_device_bytes
        return cls._min_device_bytes

    def _route_delta_group(self, key: Tuple,
                           reqs: List["_DeltaReq"]):
        """Collect-time routing + dispatch for one parity-delta
        group.  Returns the completion-queue handle:

        * ``("deltadev", handles, t_disp, in_bytes)`` — async device
          dispatch in flight (joined by _complete_group_delta_dev);
        * ``"delta_cpu"`` — routed to (or falling back on) the CPU
          twin's delta_parity."""
        impl = reqs[0].ec_impl
        sup = getattr(impl, "delta_async_supported", None)
        if sup is None or \
                not hasattr(impl, "delta_encode_batch_async"):
            return "delta_cpu"
        try:
            if not sup():
                return "delta_cpu"
        except Exception:
            return "delta_cpu"
        to_cpu = self._route_to_cpu_delta(key, reqs)
        if not to_cpu and self._breaker_blocks():
            to_cpu = True
        self._note_route_delta(key, reqs, to_cpu)
        if to_cpu:
            return "delta_cpu"
        handle = self._dispatch_group_delta(key, reqs)
        if handle is None:
            return "delta_cpu"       # dispatch failed: twin serves
        return ("deltadev",) + handle

    def _route_to_cpu_delta(self, key: Tuple,
                            reqs: List["_DeltaReq"]) -> bool:
        """_route_to_cpu with the delta-side crossover: same
        pin/idle-probe/tick-probe ladder (shared probe cadence and
        idle clocks), judged against _delta_min_bytes() over the
        group's dirty-column input bytes."""
        if not self.adaptive_cpu:
            self._route_reason = "device"
            return False
        thr = self._delta_min_bytes()
        if thr <= 0:
            self._route_reason = "device"
            return False
        total = sum(r.nbytes for r in reqs)
        if total >= thr:
            self._route_reason = "device"
            return False
        cls = EncodeBatcher
        if 0 < cls._pinned_min_device_bytes and \
                thr <= cls._pinned_min_device_bytes:
            self._route_reason = "pin"
            return True
        now = time.monotonic()
        if self.idle_reprobe_s > 0 and \
                now - cls._last_device_ts > self.idle_reprobe_s and \
                now - cls._last_idle_probe_ts > self.idle_reprobe_s:
            cls._last_idle_probe_ts = now
            self._route_reason = "idle_probe"
            return False
        cls._probe_tick += 1
        blocked = cls._probe_tick % self.probe_interval != 0
        self._route_reason = "learned" if blocked else "tick_probe"
        return blocked

    def _note_route_delta(self, key: Tuple, reqs: List["_DeltaReq"],
                          to_cpu: bool) -> None:
        """Publish one delta routing verdict (delta_route_* counter
        + flight-recorder event).  Collector thread only."""
        reason = self._route_reason or \
            ("learned" if to_cpu else "device")
        self._route_reason = None
        if self.dperf is not None and \
                f"delta_route_{reason}" in self.dperf._types:
            self.dperf.inc(f"delta_route_{reason}")
        rec = self.recorder
        if rec is not None:
            rec.note("delta_route", reason=reason,
                     to="cpu" if to_cpu else "device",
                     bytes=sum(r.nbytes for r in reqs),
                     reqs=len(reqs),
                     dirty_cols=len(key[2]),
                     crossover=int(self._delta_min_bytes()))

    def _dispatch_group_delta(self, key: Tuple,
                              reqs: List["_DeltaReq"]):
        """Issue the async device delta-matmul for one (geometry,
        dirty-column signature) group: concat every request's
        [nstripes, D, chunk] delta stack and dispatch tile-by-tile
        through delta_encode_batch_async (prewarmed compiled shape,
        StagingPool staging, full seven-phase ledger).  Returns
        (handles, t_disp, in_bytes) or None on dispatch failure."""
        t_form = time.monotonic()
        self._account_queue_wait(reqs, t_form)
        cols = key[2]
        try:
            arrs = [r.as_array(len(cols)) for r in reqs]
            if len(arrs) > 1:
                batch = np.concatenate(arrs, axis=0)
                self._note_copy(batch.nbytes,
                                "batcher.delta_batch_concat")
            else:
                batch = np.asarray(arrs[0])
        except Exception:
            # malformed request payload: NOT a device fault (must not
            # trip the breaker) — the twin path fails the bad rider
            # per-request and still serves its group-mates
            return None
        in_bytes = batch.nbytes
        tile = max(1, self.max_stripes)
        handles = None
        delay = self.device_retry_s
        for attempt in range(3):
            try:
                faultlib.registry().hit(faultlib.DEVICE_DISPATCH)
                handles = [
                    reqs[0].ec_impl.delta_encode_batch_async(
                        batch[i:i + tile], cols)
                    for i in range(0, batch.shape[0], tile)]
                break
            except Exception:
                handles = None
                if attempt < 2 and delay > 0:
                    time.sleep(min(delay, 0.1))
                    delay *= 2
        if handles is None:
            self._device_failure("dispatch")
            return None
        t_disp = time.monotonic()
        EncodeBatcher._last_device_ts = t_disp
        self.stage_seconds["batch_form"] += t_disp - t_form
        if self.bperf is not None:
            self.bperf.hinc("batch_stripes", batch.shape[0])
            self.bperf.inc("h2d_bytes", in_bytes)
        for r in reqs:
            if r.tracked is not None:
                r.tracked.mark_event("ec:delta_dispatched")
        return (handles, t_disp, in_bytes)

    def _complete_group_delta_twin(self, key: Tuple,
                                   reqs: List["_DeltaReq"]) -> None:
        """Coalesced device-free Δparity: the whole group's delta
        stripes go through ONE CodecCore.delta_parity call on the
        CPU twin (native GF kernels when available) — the coalescing
        win survives CPU routing, like _complete_group_cpu."""
        t_form = time.monotonic()
        t_wall = time.time()
        self._account_queue_wait(reqs, t_form)
        cols = key[2]
        k = reqs[0].ec_impl.get_data_chunk_count()
        parity = None
        arrs = None
        try:
            twin = self.cpu_twin(reqs[0].ec_impl, reqs[0].sinfo)
            arrs = [r.as_array(len(cols)) for r in reqs]
            if len(arrs) > 1:
                batch = np.concatenate(arrs, axis=0)
                self._note_copy(batch.nbytes,
                                "batcher.delta_batch_concat")
            else:
                batch = np.asarray(arrs[0])
            parity = twin.core.delta_parity(
                np.asarray(batch, dtype=np.uint8), cols)
        except Exception:
            parity = None
        if parity is None:
            # twin trouble: per-request fallback (still device-free)
            for r in reqs:
                try:
                    out = self._delta_inline(r.ec_impl, r.sinfo,
                                             r.delta, cols)
                except Exception:
                    self._cb_error()
                    out = None
                self.delta_reqs += 1
                self.delta_cpu_reqs += 1
                try:
                    r.done = True
                    r.cb(out)
                except Exception:
                    self._cb_error()
            return
        self.delta_calls += 1
        self.cpu_calls += 1
        self.delta_cpu_reqs += len(reqs)
        self.stage_seconds["device"] += time.monotonic() - t_form
        # twin groups still fold into the device waterfall: coarse
        # two-stamp host-lane ledger, same idiom as the encode twin
        t_done = time.time()
        self._observe_device_ledger(
            {"stage_acquire": t_wall, "compute_start": t_wall,
             "compute_done": t_done, "deliver": t_done,
             "device": -1, "bytes": int(sum(r.nbytes for r in reqs)),
             "stripes": int(sum(r.nstripes for r in reqs)),
             "group": "delta"})
        if self.bperf is not None:
            self.bperf.hinc("batch_stripes",
                            sum(r.nstripes for r in reqs))
            self.bperf.inc("cpu_reqs", len(reqs))
            if len(reqs) > 1:
                self.bperf.inc("coalesced_reqs", len(reqs))
        if len(reqs) > 1:
            self.delta_coalesced += len(reqs)
        self._deliver_delta(reqs, parity, k)

    def _complete_group_delta_dev(self, key: Tuple,
                                  reqs: List["_DeltaReq"], handle,
                                  trust_win: bool = True) -> None:
        """Join one in-flight device delta group: harvest the
        seven-phase ledgers, fold h2d samples into the link EWMA,
        teach the delta crossover, and split the [B, m, chunk]
        Δparity stack back to each rider.  Device trouble falls the
        WHOLE group back to the batched CPU twin — zero client
        errors."""
        _tag, handles, t_disp, in_bytes = handle
        k = reqs[0].ec_impl.get_data_chunk_count()
        parity = None
        dev_time = None
        out_bytes = 0
        try:
            faultlib.registry().hit(faultlib.DEVICE_COMPLETION)
            parts = [np.asarray(h.wait()) for h in handles]
            parity = parts[0] if len(parts) == 1 \
                else np.concatenate(parts, axis=0)
            out_bytes = parity.nbytes
            dev_time = time.monotonic() - t_disp
            self._device_success()
            for h in handles:
                hb = getattr(h, "h2d_bytes", 0)
                hs = getattr(h, "h2d_seconds", 0.0)
                if hb and hs > 0:
                    bps = hb / hs
                    EncodeBatcher._h2d_bps = bps \
                        if EncodeBatcher._h2d_bps <= 0 else (
                            0.7 * EncodeBatcher._h2d_bps + 0.3 * bps)
        except Exception:
            parity = None
            self._device_failure("completion")
        if parity is None:
            self._complete_group_delta_twin(key, reqs)
            return
        if self.adaptive_cpu:
            self._learn_crossover_delta(key, reqs, dev_time,
                                        in_bytes, out_bytes,
                                        trust_win=trust_win)
        self.delta_calls += 1
        if len(reqs) > 1:
            self.delta_coalesced += len(reqs)
        if self.perf is not None:
            self.perf.inc("ec_delta_batch_calls")
            if len(reqs) > 1:
                self.perf.inc("ec_delta_batch_coalesced", len(reqs))
        # fenced-window stage split, same link-rate model as decode
        h2d_s = d2h_s = 0.0
        if self._h2d_bps > 0:
            h2d_s = min(dev_time, in_bytes / self._h2d_bps)
            d2h_s = min(dev_time - h2d_s, out_bytes / self._h2d_bps)
        self.stage_seconds["h2d"] += h2d_s
        self.stage_seconds["d2h"] += d2h_s
        self.stage_seconds["device"] += max(
            0.0, dev_time - h2d_s - d2h_s)
        if self.bperf is not None:
            self.bperf.hinc("dispatch_ms", dev_time * 1e3)
            self.bperf.inc("d2h_bytes", out_bytes)
            self.bperf.inc("device_reqs", len(reqs))
            if len(reqs) > 1:
                self.bperf.inc("coalesced_reqs", len(reqs))
        for h in handles:
            leds = getattr(h, "ledgers", None) or \
                [getattr(h, "ledger", None)]
            for led in leds:
                if led is not None:
                    led["group"] = "delta"
                self._observe_device_ledger(led)
        self._publish_device_telemetry(reqs[0].ec_impl)
        self._deliver_delta(reqs, parity, k)

    def _deliver_delta(self, reqs: List["_DeltaReq"],
                       parity: np.ndarray, k: int) -> None:
        """Split a [B, m, chunk] Δparity stack back per rider and
        fire callbacks with {parity_shard_index: Δparity bytes}.
        The per-parity column gathers are the one unavoidable copy
        (the stack interleaves shards) — the memoryviews then ride
        by reference into the xor_write sub-transactions."""
        m = parity.shape[1]
        off = 0
        copied = 0
        for r in reqs:
            p = parity[off:off + r.nstripes]
            off += r.nstripes
            out = {}
            for j in range(m):
                src = p[:, j]
                col = np.ascontiguousarray(src)
                if col is not src:
                    copied += col.nbytes
                out[k + j] = memoryview(col).cast("B")
            self.delta_reqs += 1
            try:
                r.done = True
                r.cb(out)
            except Exception:
                self._cb_error()
        if copied:
            self._note_copy(copied, "batcher.delta_shard_gather")

    def _cpu_rate_delta(self, key: Tuple,
                        reqs: List["_DeltaReq"]) -> float:
        """CPU twin Δparity throughput for this geometry (bytes of
        dirty-column input per second), measured once on real data;
        shared process-wide like _cpu_rate.  One bucket per geometry
        (not per dirty signature): the GF matmul's bytes/s is nearly
        independent of D — compute and input both scale with D."""
        rk = ("delta", key[1])
        rate = EncodeBatcher._cpu_bps.get(rk)
        if rate is None:
            r = reqs[0]
            cols = key[2]
            try:
                twin = self.cpu_twin(r.ec_impl, r.sinfo)
                arr = np.asarray(r.as_array(len(cols)),
                                 dtype=np.uint8)
                t0 = time.monotonic()
                twin.core.delta_parity(arr, cols)
                dt = max(time.monotonic() - t0, 1e-6)
                rate = r.nbytes / dt
            except Exception:
                # no twin: fall back to the encode-side measurement
                # (same matmul cost model) rather than guessing
                rate = EncodeBatcher._cpu_bps.get(key[1], 0.0)
            EncodeBatcher._cpu_bps[rk] = rate
        return rate

    def _learn_crossover_delta(self, key: Tuple,
                               reqs: List["_DeltaReq"],
                               dev_time: float, in_bytes: int,
                               out_bytes: int,
                               trust_win: bool = True) -> None:
        """_learn_crossover for delta groups: same pipelined cost
        model (max of the h2d/compute/d2h legs vs the CPU twin's
        prediction) and compile/outlier rejection, moving the
        DELTA-side threshold and its own per-geometry device-rate
        EWMA bucket."""
        try:
            cls = EncodeBatcher
            rk = ("delta", key[1])
            cpu_rate = max(self._cpu_rate_delta(key, reqs), 1.0)
            cpu_pred = in_bytes / cpu_rate
            h2d_s = d2h_s = 0.0
            if cls._h2d_bps > 0:
                h2d_s = min(dev_time, in_bytes / cls._h2d_bps)
                d2h_s = min(max(0.0, dev_time - h2d_s),
                            out_bytes / cls._h2d_bps)
            compute_s = max(0.0, dev_time - h2d_s - d2h_s)
            rate = cls._dev_bps.get(rk, 0.0)
            if rate > 0 and compute_s > 5.0 * (in_bytes / rate) \
                    and compute_s > 1e-3:
                return               # compile/stall outlier
            if compute_s > 0:
                bps = in_bytes / compute_s
                cls._dev_bps[rk] = bps if rate <= 0 else (
                    0.7 * rate + 0.3 * bps)
            dev_pipe = max(h2d_s, compute_s, d2h_s) \
                if (h2d_s or d2h_s) else dev_time
            cur = self._delta_min_bytes()
            if dev_pipe > cpu_pred:
                cls._delta_min_device_bytes = max(
                    cur, dev_pipe * cpu_rate / 2, self.crossover_min)
            elif trust_win and dev_pipe < cpu_pred / 2 and cur > 0:
                cls._delta_min_device_bytes = min(cur, in_bytes / 2)
        except Exception:
            pass                     # learning is best-effort

    def _learn_crossover(self, reqs: List[_Req],
                         dev_time: float,
                         trust_win: bool = True) -> None:
        """Compare the device's PIPELINED cost model against the CPU
        twin's predicted time for the same bytes and move the routing
        threshold: lost -> raise it past this batch size; won big ->
        lower it.

        Two properties matter here (both were misrouting bugs):

        * the fenced ``dev_time`` is a SERIAL h2d + kernel + d2h sum,
          but in steady state consecutive batches overlap those legs
          (async dispatch, double-buffered staging) — so the cost the
          router should compare is ``max(h2d, compute, d2h)``, not
          the sum.  Judging the device on the serial number makes a
          device that wins pipelined look like it loses, and 100% of
          traffic lands on the twin.
        * a call that paid jit compile (or any one-off stall) must
          not teach the router: if this call ran far slower than the
          geometry's own steady-state EWMA predicts, it is an
          outlier, not a measurement."""
        try:
            cls = EncodeBatcher
            key = _geometry_key(reqs[0].ec_impl, reqs[0].sinfo)
            total = sum(r.nbytes for r in reqs)
            m_over_k = (reqs[0].ec_impl.get_coding_chunk_count()
                        / max(1, reqs[0].ec_impl.get_data_chunk_count()))
            cpu_rate = max(self._cpu_rate(key, reqs[0]), 1.0)
            cpu_pred = total / cpu_rate
            # split the fenced window into transfer legs (measured
            # warm link rate) and the compute remainder
            h2d_s = d2h_s = 0.0
            if cls._h2d_bps > 0:
                h2d_s = min(dev_time, total / cls._h2d_bps)
                d2h_s = min(max(0.0, dev_time - h2d_s),
                            total * m_over_k / cls._h2d_bps)
            compute_s = max(0.0, dev_time - h2d_s - d2h_s)
            # compile/outlier rejection BEFORE the EWMA absorbs it:
            # against this geometry's steady-state compute rate, a
            # 5x-slower call is a one-off (jit compile, allocator
            # stall, scheduler hiccup), not the device's cost
            rate = cls._dev_bps.get(key, 0.0)
            if rate > 0 and compute_s > 5.0 * (total / rate) \
                    and compute_s > 1e-3:
                return
            if compute_s > 0:
                bps = total / compute_s
                cls._dev_bps[key] = bps if rate <= 0 else (
                    0.7 * rate + 0.3 * bps)
            # the PIPELINED device cost: legs overlap across batches,
            # so the sustained per-batch cost is the slowest leg
            dev_pipe = max(h2d_s, compute_s, d2h_s) \
                if (h2d_s or d2h_s) else dev_time
            if dev_pipe > cpu_pred:
                # the device LOST even with overlap credited: set the
                # crossover where the CPU would have taken as long as
                # this call's bottleneck leg (one losing measurement
                # teaches the whole region below it, not just 2x this
                # batch — bursts must not need a convergence loop)
                cls._min_device_bytes = max(
                    self._min_device_bytes,
                    dev_pipe * cpu_rate / 2, self.crossover_min)
            elif trust_win and dev_pipe < cpu_pred / 2 and \
                    self._min_device_bytes > 0:
                cls._min_device_bytes = min(
                    self._min_device_bytes, total / 2)
        except Exception:
            pass                     # learning is best-effort

    # -- decode-side routing (consumed by ECBackend reads/recovery) ----
    def route_decode(self, nbytes: int) -> bool:
        """prefer_cpu() with the measurement the encode side has had
        always had: one reason-coded ``dec_route_*`` verdict counter
        per call (device / learned / breaker_open) so perf dump and
        prometheus answer WHERE decode traffic actually ran.  True
        means the caller should take the CPU twin."""
        if EncodeBatcher._breaker_open:
            reason, to_cpu = "breaker_open", True
        elif (self.adaptive_cpu and self._dec_min_bytes() > 0
                and nbytes < self._dec_min_bytes()):
            reason, to_cpu = "learned", True
        else:
            reason, to_cpu = "device", False
        if self.dperf is not None and \
                f"dec_route_{reason}" in self.dperf._types:
            self.dperf.inc(f"dec_route_{reason}")
        return to_cpu

    def prefer_cpu(self, nbytes: int) -> bool:
        """Should a ``nbytes``-sized codec call avoid the device?
        Shares the encode path's learned crossover — the fixed
        dispatch/transfer cost is the same either direction."""
        if EncodeBatcher._breaker_open:
            return True              # breaker open: device is sick
        return (self.adaptive_cpu and self._min_device_bytes > 0
                and nbytes < self._min_device_bytes)

    def cpu_twin(self, ec_impl, sinfo: ecutil.StripeInfo):
        """The device-free BATCHED twin for this geometry (cached);
        bit-exact by the corpus contract, executing whole stripe
        batches in one native C++ kernel call (_BatchTwin).  Used by
        encode/decode fallback and by read/recovery decode when
        prefer_cpu() says the device round trip loses."""
        key = _geometry_key(ec_impl, sinfo)
        twin = self._cpu_twins.get(key)
        if twin is None:
            from ..ec import registry as ecreg
            prof = {"k": str(ec_impl.get_data_chunk_count()),
                    "m": str(ec_impl.get_coding_chunk_count()),
                    "technique": getattr(ec_impl, "technique",
                                         "reed_sol_van"),
                    "w": str(getattr(ec_impl, "w", 8))}
            ps = getattr(ec_impl, "packetsize", 0)
            if ps:
                prof["packetsize"] = str(ps)
            twin = _BatchTwin(ecreg.instance().factory("jerasure",
                                                       prof))
            self._cpu_twins[key] = twin
        return twin

    def _cpu_encode(self, req: _Req) -> Dict[int, bytes]:
        """Device-free encode through the CPU twin; jerasure lacks the
        batched device API, so ecutil.encode takes its per-stripe CPU
        loop."""
        twin = self.cpu_twin(req.ec_impl, req.sinfo)
        return ecutil.encode(req.sinfo, twin, req.data)

    def _dispatch_group(self, reqs: List[_Req]):
        """Issue one async device call for every request of one
        geometry; returns (arrs, async_handle) or None on dispatch
        failure (completion falls back to per-request CPU encode).
        One card, no mesh: each tile is one kernel launch on the
        codec's device, with one ledger (AsyncBatch.ledger)."""
        t_form = time.monotonic()
        self._account_queue_wait(reqs, t_form)
        try:
            k = reqs[0].ec_impl.get_data_chunk_count()
            arrs = [r.as_array(k) for r in reqs]
            if len(arrs) > 1:
                batch = np.concatenate(arrs, axis=0)
                self._note_copy(batch.nbytes, "batcher.batch_concat")
            else:
                batch = arrs[0]
        except Exception:
            # malformed request payload/geometry: NOT a device fault
            # (must not trip the breaker) — completion falls back to
            # per-request CPU encode, which fails the bad rider with
            # EIO and still serves its group-mates
            return None
        # tile oversized batches at max_stripes: bounds per-call
        # device memory AND caps the largest compiled batch shape
        # at bucket(max_stripes) — the shape prewarm() compiles —
        # so a burst can never hit a never-seen (slow-compiling)
        # shape mid-benchmark.  All tiles dispatch before any
        # wait.
        tile = max(1, self.max_stripes)
        handles = None
        delay = self.device_retry_s
        for attempt in range(3):
            try:
                faultlib.registry().hit(faultlib.DEVICE_DISPATCH)
                handles = [
                    reqs[0].ec_impl.encode_batch_async(
                        batch[i:i + tile])
                    for i in range(0, batch.shape[0], tile)]
                break
            except Exception:
                # classified device dispatch failure: transient until
                # proven otherwise — retry with capped backoff before
                # charging the breaker
                handles = None
                if attempt < 2 and delay > 0:
                    time.sleep(min(delay, 0.1))
                    delay *= 2
        if handles is None:
            self._device_failure("dispatch")
            return None
        t_disp = time.monotonic()
        EncodeBatcher._last_device_ts = t_disp
        self.stage_seconds["batch_form"] += t_disp - t_form
        if self.bperf is not None:
            self.bperf.hinc("batch_stripes", batch.shape[0])
            self.bperf.inc("h2d_bytes", batch.nbytes)
        for r in reqs:
            if r.tracked is not None:
                r.tracked.mark_event("ec:batch_dispatched")
        return (arrs, handles, t_disp)

    def _publish_device_telemetry(self, ec_impl) -> None:
        """Refresh the ec_device staging/link gauges from the codec's
        StagingPool after a device completion (completion worker
        only).  A stall-grow since the last look is an incident-grade
        event: it means the ring wedged past STALL_S and the pool
        grew to protect the write path — flight-record it."""
        dp = self.dperf
        rec = self.recorder
        backend = getattr(getattr(ec_impl, "core", None),
                          "backend", None)
        if backend is not None and hasattr(backend, "memory_stats"):
            # remembered so dump_device can report memory accounting
            # even on a daemon with no perf plumbing (unit stubs)
            self._last_backend = backend
        if backend is not None and hasattr(backend, "mesh_info"):
            # keep the mesh gauges / learner keying current even when
            # prewarm was skipped (ec_tpu_prewarm=false paths)
            self._note_mesh(backend)
        if dp is None and rec is None:
            return
        pool = getattr(backend, "staging", None)
        if pool is not None:
            try:
                st = pool.stats()
            except Exception:
                st = None
            if st:
                if dp is not None:
                    dp.set("staging_hits", st["hits"])
                    dp.set("staging_allocs", st["allocs"])
                    dp.set("staging_stall_allocs",
                           st["stall_allocs"])
                    dp.set("staging_slots", st["slots"])
                    dp.set("staging_in_flight", st["in_flight"])
                if st["stall_allocs"] > self._staging_stalls_seen:
                    self._staging_stalls_seen = st["stall_allocs"]
                    if rec is not None:
                        rec.note("staging", event="stall_grow",
                                 stall_allocs=st["stall_allocs"],
                                 slots=st["slots"])
        if dp is not None:
            dp.set("h2d_bps", int(EncodeBatcher._h2d_bps))
            if self._last_backend is not None and \
                    "staging_host_bytes_now" in dp._types:
                try:
                    mem = self._last_backend.memory_stats()
                except Exception:
                    mem = None
                if mem:
                    dp.set("staging_host_bytes_now",
                           mem["staging_host_bytes"])
                    dp.set("staging_host_bytes_peak",
                           mem["staging_host_bytes_peak"])
                    dp.set("dev_matrix_bytes_now",
                           mem["dev_matrix_bytes"])
                    dp.set("compile_cache_entries",
                           mem["compile_cache_entries"])

    def _observe_device_ledger(self, led) -> None:
        """Fold one completed group's device-phase ledger into the
        accumulator; stall-check the h2d and compute-fence phases
        (the two that bound the pipeline), mirroring lock_stall.
        Completion-worker only.  Must not raise."""
        if not led:
            return
        try:
            self.ledger_accum.observe(led)
        except Exception:
            return
        self._ledger_completions += 1
        dp = self.dperf
        if dp is not None and self._ledger_completions % 32 == 0 and \
                "pipeline_overlap_frac" in dp._types:
            # periodic refresh: sorting the 256-deep recent ring on
            # every completion is not free, 1-in-32 is
            try:
                ov = overlap_stats(self.ledger_accum.recent())
                dp.set("pipeline_overlap_frac",
                       ov["pipeline_overlap_frac"])
            except Exception:
                pass
        stall = self.phase_stall_s
        if stall <= 0:
            return
        for phase, a, b in (("h2d", "h2d_start", "h2d_done"),
                            ("fence", "compute_start",
                             "compute_done")):
            ta, tb = led.get(a), led.get(b)
            if ta is None or tb is None or tb - ta < stall:
                continue
            if dp is not None and "device_phase_stalls" in dp._types:
                dp.inc("device_phase_stalls")
            rec = self.recorder
            if rec is not None:
                rec.note("device_stall", phase=phase,
                         ms=round((tb - ta) * 1e3, 3),
                         device=led.get("device", 0),
                         bytes=led.get("bytes", 0))
                rec.auto_dump("device-phase-stall")

    def device_dump(self) -> dict:
        """``dump_device`` admin-command payload: the per-phase
        waterfall (with p50/p99 + overlap verdict), memory
        accounting, and the batcher's coarse stage split."""
        dump = self.ledger_accum.dump()
        mem = None
        backend = self._last_backend
        if backend is not None:
            try:
                mem = backend.memory_stats()
            except Exception:
                mem = None
        mesh = None
        if backend is not None and hasattr(backend, "mesh_info"):
            try:
                mesh = backend.mesh_info()
            except Exception:
                mesh = None
        return {
            "ledger": dump,
            "overlap": dump.get("overlap"),
            "memory": mem,
            "mesh": mesh,
            "stage_seconds": dict(self.stage_seconds),
            "breaker_open": bool(EncodeBatcher._breaker_open),
        }

    def device_trace_block(self) -> dict:
        """Raw recent group ledgers (+ memory snapshot) for the
        unified trace exporter's per-device phase lanes."""
        mem = None
        backend = self._last_backend
        if backend is not None:
            try:
                mem = backend.memory_stats()
            except Exception:
                mem = None
        return {"ledgers": self.ledger_accum.recent(), "memory": mem}

    def _account_queue_wait(self, reqs: List[_Req],
                            now: float) -> None:
        for r in reqs:
            w = max(0.0, now - r.t_enq)
            self.stage_seconds["queue_wait"] += w
            if self.bperf is not None:
                self.bperf.hinc("queue_wait_us", w * 1e6)

    def _complete_group(self, reqs: List[_Req], handle,
                        learn: bool = True,
                        trust_win: bool = True) -> None:
        k = reqs[0].ec_impl.get_data_chunk_count()
        m = reqs[0].ec_impl.get_coding_chunk_count()
        parity = None
        dev_time = None
        if handle is not None:
            arrs, async_tiles, t_dispatch = handle
            try:
                faultlib.registry().hit(faultlib.DEVICE_COMPLETION)
                parts = [t.wait() for t in async_tiles]
                parity = parts[0] if len(parts) == 1 \
                    else np.concatenate(parts, axis=0)
                dev_time = time.monotonic() - t_dispatch
                self._device_success()
                # fold any fenced WARM h2d samples the staging pool
                # took during this batch into the shared link EWMA —
                # real-traffic measurements keep the h2d/device/d2h
                # split and the overlap model honest
                for t in async_tiles:
                    hb = getattr(t, "h2d_bytes", 0)
                    hs = getattr(t, "h2d_seconds", 0.0)
                    if hb and hs > 0:
                        bps = hb / hs
                        EncodeBatcher._h2d_bps = bps \
                            if EncodeBatcher._h2d_bps <= 0 else (
                                0.7 * EncodeBatcher._h2d_bps
                                + 0.3 * bps)
            except Exception:
                # classified completion failure (a dispatched handle
                # cannot be re-waited, so no retry here — the CPU
                # twin serves the group and the breaker learns)
                parity = None
                self._device_failure("completion")
        if parity is None:
            # device trouble: encode each request on a REAL CPU path
            # (a jerasure twin of the same geometry — bit-exact by the
            # corpus contract, and free of the broken device).  A
            # request that still cannot encode gets cb(None) so the
            # write op fails with EIO instead of hanging.
            for r in reqs:
                try:
                    chunks = self._cpu_encode(r)
                except Exception:
                    self._cb_error()
                    chunks = None
                try:
                    r.done = True
                    r.cb(chunks)
                except Exception:
                    self._cb_error()
            return
        if dev_time is not None and self.adaptive_cpu and learn:
            self._learn_crossover(reqs, dev_time,
                                  trust_win=trust_win)
        self.calls += 1
        self.reqs_total += len(reqs)
        nstripes = sum(r.nstripes for r in reqs)
        if len(reqs) > 1:
            self.reqs_coalesced += len(reqs)
        if self.perf is not None:
            self.perf.inc("ec_batch_calls")
            self.perf.inc("ec_batch_stripes", nstripes)
            if len(reqs) > 1:
                self.perf.inc("ec_batch_coalesced", len(reqs))
        if dev_time is not None:
            # split the fenced device window into transfer vs compute
            # using the link rate prewarm measured; without a
            # measurement the whole window is charged to "device"
            in_bytes = sum(r.nbytes for r in reqs)
            out_bytes = parity.nbytes
            h2d_s = d2h_s = 0.0
            if self._h2d_bps > 0:
                h2d_s = min(dev_time, in_bytes / self._h2d_bps)
                d2h_s = min(dev_time - h2d_s,
                            out_bytes / self._h2d_bps)
            self.stage_seconds["h2d"] += h2d_s
            self.stage_seconds["d2h"] += d2h_s
            self.stage_seconds["device"] += max(
                0.0, dev_time - h2d_s - d2h_s)
            if self.bperf is not None:
                self.bperf.hinc("dispatch_ms", dev_time * 1e3)
                self.bperf.inc("d2h_bytes", out_bytes)
                self.bperf.inc("device_reqs", len(reqs))
                if len(reqs) > 1:
                    self.bperf.inc("coalesced_reqs", len(reqs))
            # harvest each tile's device-phase ledger (finalized by
            # AsyncBatch.wait above): feeds the phase accumulator,
            # the overlap engine, and the stall flight recorder.  A
            # mesh dispatch finalizes one clone per chip (.ledgers),
            # so every device gets its own waterfall/trace lane.
            for t in async_tiles:
                for led in (getattr(t, "ledgers", None) or
                            [getattr(t, "ledger", None)]):
                    self._observe_device_ledger(led)
            self._publish_device_telemetry(reqs[0].ec_impl)
        off = 0
        for r, arr in zip(reqs, arrs):
            p = parity[off:off + r.nstripes]
            off += r.nstripes
            out = self._shard_views(arr, p, k, m)
            try:
                r.done = True
                r.cb(out)
            except Exception:
                # a failing continuation affects only its own op
                self._cb_error()

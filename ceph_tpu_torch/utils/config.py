"""Typed option table + layered configuration.

Python-native equivalent of the reference's config system (reference
src/common/options.cc — 1,676 ``Option(...)`` rows; schema
src/common/options.h; md_config_t in src/common/config.cc): a single
table of typed, documented options with defaults and validation, values
layered from (lowest to highest precedence) compiled defaults < config
file < environment < command line < runtime overrides (the reference's
monitor central config, mon/ConfigMonitor.cc), with change observers
notified on runtime updates.

Only the options the framework actually consumes are declared here —
the table grows with the subsystems.  Unknown keys raise, as the
reference's ``ceph config set`` does for unknown names.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

LEVEL_BASIC = "basic"
LEVEL_ADVANCED = "advanced"
LEVEL_DEV = "dev"


@dataclass
class Option:
    """One typed option (reference common/options.h Option struct)."""
    name: str
    type: type                      # int, float, bool, str
    default: Any
    level: str = LEVEL_ADVANCED
    description: str = ""
    min: Optional[float] = None
    max: Optional[float] = None
    enum_allowed: Tuple[str, ...] = ()
    see_also: Tuple[str, ...] = ()
    # machine-readable autotuner marker (utils/tuner.py enumerates
    # these instead of a hand-kept knob list; reference has no analog
    # — the closest is options tagged ``runtime``).  A tunable option
    # MUST carry finite min/max bounds so no controller step can walk
    # it out of its safe range.
    tunable: bool = False

    def validate(self, value: Any) -> Any:
        if self.type is bool and isinstance(value, str):
            if value.lower() in ("true", "yes", "1"):
                value = True
            elif value.lower() in ("false", "no", "0"):
                value = False
            else:
                raise ValueError(f"{self.name}: not a boolean: {value!r}")
        try:
            value = self.type(value)
        except (TypeError, ValueError):
            raise ValueError(
                f"{self.name}: cannot convert {value!r} to "
                f"{self.type.__name__}")
        if self.min is not None and value < self.min:
            raise ValueError(f"{self.name}: {value} < min {self.min}")
        if self.max is not None and value > self.max:
            raise ValueError(f"{self.name}: {value} > max {self.max}")
        if self.enum_allowed and value not in self.enum_allowed:
            raise ValueError(
                f"{self.name}: {value!r} not in {self.enum_allowed}")
        return value


def _opts() -> List[Option]:
    """The option table (the subset of reference common/options.cc the
    framework consumes; reference line refs inline)."""
    return [
        # -- erasure code (reference options.cc:564,2659,2665) -----------
        Option("erasure_code_dir", str, "",
               description="plugin search path override"),
        # the port's device plugin takes the place of the JAX package's
        # tpu: each name here must be a plugin of this package
        Option("osd_erasure_code_plugins", str, "jerasure isa lrc shec gpu",
               description="plugins to preload at daemon start"),
        Option("osd_pool_default_erasure_code_profile", str,
               "plugin=jerasure technique=reed_sol_van k=2 m=1",
               description="default profile for new EC pools"),
        # -- tpu codec batching (framework-specific) ----------------------
        Option("ec_tpu_batch_stripes", int, 1024, min=1, max=1 << 20,
               description="stripes gathered per device call"),
        Option("ec_tpu_queue_window_us", int, 200, min=0, max=1_000_000,
               description="max microseconds a stripe waits for a batch"),
        Option("ec_tpu_queue_window_max_us", int, 0, min=0,
               max=5_000_000, tunable=True,
               description="ceiling for the admission-aware coalescing "
                           "window (0 = auto: max(16x base, 20ms)); the "
                           "effective window doubles under sustained "
                           "queue pressure and shrinks back when the "
                           "queue drains"),
        Option("osd_ec_pipeline_segment_bytes", int, 2 << 20, min=0,
               max=256 << 20, tunable=True,
               description="segment size for pipelined EC writes: an "
                           "aligned write larger than this is encoded "
                           "and fanned out segment-by-segment so the "
                           "encode of segment N+1 overlaps the "
                           "sub-write fanout of segment N (0 disables "
                           "segmentation)"),
        Option("osd_ec_delta_rmw", bool, True,
               description="parity-delta RMW for sub-stripe EC "
                           "overwrites: read back only the dirty data "
                           "columns, device-compute Δparity = "
                           "M[:,dirty]·Δdata once on the primary, and "
                           "apply it on parity shards with a store "
                           "XOR (false = always full-stripe "
                           "re-encode)"),
        Option("osd_ec_delta_rmw_max_dirty", float, 0.5, min=0.0,
               max=1.0, tunable=True,
               description="dirty-column fraction above which the "
                           "delta path yields to the full re-encode "
                           "(reading most of the stripe back anyway)"),
        Option("ec_tpu_fallback_cpu", bool, True,
               description="CPU bit-plane path when no device is present "
                           "(monitors validate profiles without devices)"),
        Option("ec_tpu_min_device_bytes", int, 0, min=0,
               description="pin the device/CPU-twin routing crossover: "
                           "encode groups smaller than this route to "
                           "the batched CPU twin (0 = learn the "
                           "crossover adaptively at runtime; pin it "
                           "after characterizing the host so routing "
                           "does not depend on the learning race)"),
        # -- osd (reference options.cc:2869-2901,2478,3159) ---------------
        Option("osd_backend", str, "crimson",
               enum_allowed=("classic", "crimson"),
               description="OSD execution model: the crimson shard-"
                           "per-core reactor OSD (default, reference "
                           "crimson-osd), or the classic sharded "
                           "thread pools; both speak the same wire "
                           "protocol and can mix within one cluster"),
        Option("crimson_num_reactors", int, 0, min=0,
               description="reactor shards per crimson OSD; PGs are "
                           "statically partitioned across shards by "
                           "hash(pgid) mod N and cross-shard work "
                           "moves over SPSC mailboxes (seastar "
                           "submit_to).  0 = min(cores, 4)"),
        Option("osd_op_num_shards", int, 5, min=1,
               description="sharded op queue shard count"),
        Option("osd_op_queue", str, "mclock_scheduler",
               enum_allowed=("mclock_scheduler", "fifo"),
               description="op scheduler: mclock_scheduler or fifo "
                           "(reference osd_op_queue)"),
        # dmClock triples (reference osd_mclock_scheduler_*): res =
        # guaranteed tokens/s, wgt = spare-capacity share, lim = cap
        # (0 = none).  Bounded [0, 1e6] so neither the operator nor
        # the mgr tuner module can walk one negative or unbounded;
        # wgt floors at 1 so no class can be starved to a zero share.
        Option("osd_mclock_scheduler_client_res", float, 100.0,
               min=0.0, max=1e6, tunable=True),
        Option("osd_mclock_scheduler_client_wgt", float, 100.0,
               min=1.0, max=1e6, tunable=True),
        Option("osd_mclock_scheduler_client_lim", float, 0.0,
               min=0.0, max=1e6, tunable=True),
        Option("osd_mclock_scheduler_recovery_res", float, 0.0,
               min=0.0, max=1e6, tunable=True),
        Option("osd_mclock_scheduler_recovery_wgt", float, 10.0,
               min=1.0, max=1e6, tunable=True),
        Option("osd_mclock_scheduler_recovery_lim", float, 0.0,
               min=0.0, max=1e6, tunable=True),
        Option("osd_mclock_scheduler_scrub_res", float, 0.0,
               min=0.0, max=1e6, tunable=True),
        Option("osd_mclock_scheduler_scrub_wgt", float, 5.0,
               min=1.0, max=1e6, tunable=True),
        Option("osd_mclock_scheduler_scrub_lim", float, 0.0,
               min=0.0, max=1e6, tunable=True),
        Option("osd_mclock_scheduler_peering_res", float, 50.0,
               min=0.0, max=1e6),
        Option("osd_mclock_scheduler_peering_wgt", float, 50.0,
               min=1.0, max=1e6),
        Option("osd_mclock_scheduler_peering_lim", float, 0.0,
               min=0.0, max=1e6),
        Option("crimson_conn_affinity", bool, True,
               description="re-pin a client connection's reactor to "
                           "the shard owning the majority of its PG "
                           "ops, eliminating the cross-shard mailbox "
                           "hop under fan-in"),
        Option("crimson_admission_hwm", int, 192, min=0,
               description="per-shard queued-op high-water mark; past "
                           "it the messenger stops reading client "
                           "sockets so overload queues at the edge "
                           "(TCP backpressure) instead of inflating "
                           "reactor loop-lag.  0 = unlimited"),
        Option("osd_op_num_threads_per_shard", int, 1, min=1),
        Option("osd_recovery_max_active", int, 0, min=0,
               description="recovery ops in flight per OSD; 0 = pick "
                           "the hdd/ssd-tuned variant by store medium "
                           "(reference dual-default scheme)"),
        # hdd/ssd-tuned variants (reference options.cc device-class
        # defaults; consumers pick by store medium)
        Option("osd_recovery_max_active_hdd", int, 3, min=1),
        Option("osd_recovery_max_active_ssd", int, 10, min=1),
        Option("osd_recovery_sleep_hdd", float, 0.1, min=0),
        Option("osd_recovery_sleep_ssd", float, 0.0, min=0),
        Option("osd_max_backfills", int, 1, min=1,
               description="backfill reservations per OSD "
                           "(reference osd_max_backfills)"),
        Option("osd_recovery_max_single_start", int, 1, min=1),
        Option("osd_max_object_size", int, 128 << 20, min=1,
               description="reject client objects larger than this "
                           "(reference osd_max_object_size)"),
        Option("osd_client_message_size_cap", int, 500 << 20, min=0),
        Option("osd_heartbeat_min_peers", int, 10, min=1),
        Option("osd_deep_scrub_stride", int, 512 << 10, min=4096),
        Option("osd_scrub_during_recovery", bool, False,
               description="allow scheduling scrubs while this daemon "
                           "has PGs recovering (reference "
                           "osd_scrub_during_recovery)"),
        Option("osd_pool_default_flag_hashpspool", bool, True),
        Option("mon_max_pg_per_osd", int, 250, min=1,
               description="pool creation guard (reference "
                           "mon_max_pg_per_osd)"),
        Option("mon_osd_min_in_ratio", float, 0.75, min=0.0,
               description="never auto-out below this in-fraction "
                           "(reference mon_osd_min_in_ratio)"),
        Option("mon_clock_drift_allowed", float, 0.05, min=0),
        Option("objecter_inflight_ops", int, 1024, min=1,
               description="client op window (reference "
                           "objecter_inflight_ops)"),
        Option("rados_osd_op_timeout", float, 30.0, min=0,
               description="client ops error with ETIMEDOUT after "
                           "this many seconds (0 = wait forever; "
                           "reference rados_osd_op_timeout defaults "
                           "0, here nonzero so a wedged OSD surfaces "
                           "as an error instead of a hang)"),
        Option("osd_recovery_sleep", float, 0.0, min=0.0),
        Option("osd_heartbeat_interval", float, 1.0, min=0.05,
               description="seconds between peer pings "
                           "(reference default 6s, scaled down)"),
        Option("osd_heartbeat_grace", float, 4.0, min=0.1,
               description="seconds without reply before reporting "
                           "(reference default 20s, scaled down)"),
        Option("osd_pool_default_size", int, 3, min=1),
        Option("osd_pool_default_min_size", int, 0, min=0),
        Option("osd_pool_default_pg_num", int, 32, min=1),
        Option("osd_scrub_interval", float, 0.0, min=0.0,
               description="0 disables background scrub"),
        Option("osd_op_complaint_time", float, 30.0, min=0.1,
               description="ops in flight longer than this surface as "
                           "slow ops (reference osd_op_complaint_time)"),
        # -- SLO engine (mgr/slo.py: per-op-class latency targets +
        #    error budgets; generous defaults — the SLO gate flags
        #    pathology, not ordinary slowness on a loaded test box) ---
        Option("slo_client_read_p99_ms", float, 30000.0, min=0.0,
               description="client read-class latency target in ms; "
                           "slower ops burn error budget "
                           "(0 disables the latency gate)"),
        Option("slo_client_write_p99_ms", float, 30000.0, min=0.0,
               description="client write-class latency target (ms, "
                           "0 disables)"),
        Option("slo_recovery_p99_ms", float, 60000.0, min=0.0,
               description="recovery-class per-object latency target "
                           "(ms, 0 disables)"),
        Option("slo_scrub_p99_ms", float, 120000.0, min=0.0,
               description="scrub-class per-round latency target "
                           "(ms, 0 disables)"),
        Option("slo_error_budget", float, 0.001, min=0.000001,
               description="allowed bad-op fraction per class; "
                           "burn rate = observed bad fraction / "
                           "this budget (1.0 = burning exactly the "
                           "budget)"),
        Option("osd_tracing", bool, False,
               description="record blkin-style spans for traced ops "
                           "(reference osd_blkin_trace_all)"),
        Option("rados_tracing", bool, False,
               description="client starts a trace per op "
                           "(reference rbd_blkin_trace_all analog)"),
        Option("trace_sample_every", int, 1, min=1,
               description="trace every Nth client op"),
        Option("mgr_tick_interval", float, 1.0, min=0.05,
               description="mgr perf-collection cadence "
                           "(reference mgr_tick_period)"),
        Option("mds_beacon_interval", float, 1.0, min=0.05,
               description="MDS -> mon beacon cadence "
                           "(reference mds_beacon_interval)"),
        Option("mds_beacon_grace", float, 4.0, min=0.1,
               description="beacon-silent MDS is failed over after "
                           "this (reference mds_beacon_grace)"),
        Option("mgr_enabled_modules", str,
               "prometheus restful dashboard balancer pg_autoscaler "
               "alerts tuner",
               description="mgr modules to run (reference MgrMap "
                           "module list; edited by `ceph mgr module "
                           "enable/disable` through the central "
                           "config)"),
        # -- closed-loop tuner (utils/tuner.py + mgr/modules/tuner.py) ----
        Option("osd_tuner_enable", bool, False,
               description="per-OSD closed-loop tuner: each OSD tick "
                           "hill-climbs the tunable batcher/staging "
                           "knobs from the device telemetry "
                           "(pipeline_overlap_frac, bounding_phase, "
                           "staging stalls, contention stalls).  Off "
                           "by default so benches compare static vs "
                           "tuned explicitly"),
        Option("osd_tuner_interval_ticks", int, 2, min=1, max=1000,
               description="run the per-OSD tuner controller every N "
                           "housekeeping ticks (one tick = "
                           "osd_tick_interval seconds)"),
        Option("osd_tuner_cooldown_ticks", int, 1, min=0, max=1000,
               description="controller ticks to sit still after a "
                           "knob move so its effect lands in the "
                           "signals before the next decision"),
        Option("osd_tuner_blacklist_ticks", int, 8, min=1, max=10000,
               description="after a guarded rollback, the reverted "
                           "(knob, direction) pair is blacklisted for "
                           "this many controller ticks"),
        Option("osd_tuner_hysteresis", float, 0.05, min=0.0, max=1.0,
               description="relative objective deadband: a step is "
                           "kept only if the objective improves by "
                           "more than this fraction, reverted only if "
                           "it regresses by more (prevents "
                           "oscillation on a noisy plateau)"),
        Option("osd_tuner_pin", str, "",
               description="space/comma-joined tunable option names "
                           "the tuner must never move (operator "
                           "opt-out; a pinned knob keeps its "
                           "configured value)"),
        Option("mgr_tuner_mode", str, "act",
               enum_allowed=("off", "advisory", "act"),
               description="cluster tuner mgr module: 'act' applies "
                           "mClock res/wgt retunes through the "
                           "central config (the balancer/"
                           "pg_autoscaler pattern, but defaulting to "
                           "act), 'advisory' only records what it "
                           "would do, 'off' disables the loop"),
        Option("mgr_tuner_burn_high", float, 1.0, min=0.0,
               description="SLO burn (1.0 = consuming the whole error "
                           "budget) above which the client class is "
                           "considered under pressure and recovery "
                           "is demoted"),
        Option("mgr_tuner_burn_low", float, 0.25, min=0.0,
               description="client burn below which a lagging rebuild "
                           "may be promoted (recovery weight raised)"),
        Option("mgr_pg_autoscale_mode", str, "off",
               enum_allowed=("off", "on"),
               description="apply pg_autoscaler recommendations (grow "
                           "only; reference pg_autoscale_mode — the "
                           "reference defaults on, here off so test "
                           "pools keep their explicit pg_num)"),
        Option("osd_deep_scrub_interval", float, 0.0, min=0.0,
               description="deep-scrub cadence when background scrub "
                           "is on (reference osd_deep_scrub_interval)"),
        Option("osd_recovery_chunk_size", int, 8 << 20, min=4096,
               description="recovery read window bytes "
                           "(reference osd_recovery_max_chunk)"),
        # -- mon (reference options.cc mon_* ) ----------------------------
        Option("mon_osd_reporter_subtree_level", str, "host",
               description="failure reports must span this crush level"),
        Option("mon_osd_min_down_reporters", int, 2, min=1),
        Option("mon_tick_interval", float, 0.5, min=0.05),
        Option("mon_lease", float, 5.0, min=0.1,
               description="leader lease seconds (reference mon_lease)"),
        Option("mon_election_timeout", float, 2.0, min=0.1,
               description="restart a stalled election after this "
                           "(reference mon_election_timeout)"),
        Option("mon_osd_down_out_interval", float, 10.0, min=0.0,
               description="seconds down before auto-out "
                           "(reference default 600s, scaled down)"),
        Option("paxos_propose_interval", float, 0.05, min=0.0),
        # -- messenger (reference options.cc:1075 ms_*) --------------------
        Option("ms_inject_socket_failures", int, 0, min=0,
               description="one in N sends fails (fault injection)"),
        Option("ms_connection_retry_interval", float, 0.2, min=0.01),
        Option("ms_crc_data", bool, True),
        Option("ms_secure_mode", bool, False,
               description="AES-GCM-encrypt every wire frame "
                           "(reference msgr2 secure mode); requires "
                           "cephx auth for key material"),
        Option("ms_compress_mode", str, "",
               description="frame compression codec ('' off; zlib/"
                           "bz2/lzma; reference msgr2 compression)"),
        Option("ms_compress_min_size", int, 4096, min=0,
               description="only compress frames at least this big"),
        Option("auth_cluster_required", str, "none",
               enum_allowed=("none", "cephx"),
               description="'cephx' = mutual shared-secret handshake "
                           "on every connection (reference "
                           "auth_cluster_required)"),
        Option("auth_key", str, "",
               description="cluster shared secret for cephx mode"),
        # -- logging -------------------------------------------------------
        Option("log_to_stderr", bool, False),
        Option("log_file", str, ""),
        Option("debug_default_level", int, 1, min=0, max=30),
        # per-subsystem debug levels (reference common/subsys.h table +
        # debug_<subsys> options; -1 = inherit debug_default_level).
        # Consumed by utils/log.py get_subsys_level.
        Option("debug_ec", int, -1, min=-1, max=30),
        Option("debug_osd", int, -1, min=-1, max=30),
        Option("debug_mon", int, -1, min=-1, max=30),
        Option("debug_msg", int, -1, min=-1, max=30),
        Option("debug_crush", int, -1, min=-1, max=30),
        Option("debug_store", int, -1, min=-1, max=30),
        Option("debug_client", int, -1, min=-1, max=30),
        Option("debug_tools", int, -1, min=-1, max=30),
        Option("debug_tpu", int, -1, min=-1, max=30),
        Option("debug_paxos", int, -1, min=-1, max=30),
        Option("debug_heartbeat", int, -1, min=-1, max=30),
        Option("debug_recovery", int, -1, min=-1, max=30),
        Option("debug_scrub", int, -1, min=-1, max=30),
        Option("debug_mds", int, -1, min=-1, max=30),
        Option("debug_mgr", int, -1, min=-1, max=30),
        Option("debug_rgw", int, -1, min=-1, max=30),
        Option("debug_rbd", int, -1, min=-1, max=30),
        Option("debug_fs", int, -1, min=-1, max=30),
        Option("debug_objclass", int, -1, min=-1, max=30),
        # -- osd: pg log / batcher / prewarm / scrub / snap trim ----------
        Option("osd_min_pg_log_entries", int, 1500, min=10,
               description="log entries kept while clean (reference "
                           "osd_min_pg_log_entries)"),
        Option("osd_max_pg_log_entries", int, 3000, min=10,
               description="log trim bound (reference "
                           "osd_max_pg_log_entries); PGLog trims to "
                           "this"),
        Option("osd_batcher_drain_timeout", float, 30.0, min=0.0,
               description="seconds shutdown waits for in-flight "
                           "batched encodes before unmounting the "
                           "store"),
        Option("osd_ec_prewarm", bool, True,
               description="compile pool-geometry device kernels + "
                           "probe the CPU twin at EC backend build "
                           "(first-op cold-start killer)"),
        Option("ec_tpu_crossover_probe_interval", int, 16, min=1,
               description="1-in-N small batches probe the device so "
                           "the learned crossover can recover"),
        Option("ec_tpu_crossover_min_bytes", int, 64 << 10, min=0,
               description="floor for the learned CPU/device "
                           "crossover threshold"),
        Option("ec_tpu_device_error_threshold", int, 3, min=1,
               description="consecutive classified device failures "
                           "(dispatch or completion) before the "
                           "EncodeBatcher circuit breaker opens and "
                           "routes all encode traffic to the "
                           "coalesced CPU twin; probes re-admit the "
                           "device when they succeed"),
        Option("ec_tpu_device_retry_ms", float, 2.0, min=0.0,
               description="base backoff before retrying a transient "
                           "device dispatch failure (doubles per "
                           "attempt, capped; 2 retries max)"),
        Option("ec_tpu_device_phase_stall_ms", float, 250.0, min=0.0,
               description="device-phase stall threshold: an h2d or "
                           "compute-fence phase of one encode/decode "
                           "group exceeding this flight-records a "
                           "device_stall event and rate-limit "
                           "auto-dumps (mirrors lock_stall; 0 "
                           "disables)"),
        Option("store_phase_stall_ms", float, 250.0, min=0.0,
               description="store-phase stall threshold: any phase "
                           "of one store transaction (journal fsync, "
                           "kv commit, data write, ...) at or over "
                           "this flight-records a store_stall event "
                           "and rate-limit auto-dumps (mirrors "
                           "device_stall/lock_stall; 0 disables)"),
        Option("ec_tpu_device_idle_reprobe_s", float, 2.0, min=0.0,
               description="a device with zero traffic for this long "
                           "gets the next small batch as an immediate "
                           "probe (one per idle period) instead of "
                           "waiting out the 1-in-N probe tick — a "
                           "learned CPU bias must not outlive the "
                           "condition that taught it (0 disables)"),
        Option("ec_tpu_inflight_groups", int, 2, min=1, max=64,
               tunable=True,
               description="encode groups in flight per batcher: the "
                           "collector dispatches window N+1 while the "
                           "completion worker joins window N, so h2d "
                           "staging overlaps fanout (bounded FIFO; "
                           "continuations stay in submission order)"),
        Option("ec_tpu_staging_depth", int, 2, min=1, max=32,
               tunable=True,
               description="pinned host staging buffers per shape in "
                           "the torch_engine StagingPool ring; deeper "
                           "rings absorb h2d bursts at the cost of "
                           "pinned host memory (the pool still grows "
                           "one emergency slot on a sustained stall)"),
        Option("ec_tpu_mesh_devices", int, 0, min=0,
               description="devices in the encode/decode dispatch "
                           "mesh: 0 = auto (every visible device "
                           "when >1, single-chip otherwise), 1 forces "
                           "single-chip, >1 forces that many chips "
                           "(clamped to what is visible).  Groups are "
                           "laid out dp x sp (stripe-batch x "
                           "chunk-width) with one sharded GF matmul "
                           "per dispatch"),
        Option("ec_tpu_mesh_sp", int, 0, min=0,
               description="chunk-width (sp) axis of the dispatch "
                           "mesh: 0 = auto-factor; an explicit value "
                           "that cannot shard a geometry's padded "
                           "chunk raises at prewarm time rather than "
                           "mid-dispatch"),
        Option("osd_ec_subwrite_timeout_ms", float, 0.0, min=0.0,
               description="primary re-requests an EC sub-write from "
                           "a laggard shard after this deadline "
                           "(once, with 2x backoff), then reports "
                           "the peer to the monitor (0 disables "
                           "deadlines)"),
        # -- fault injection (utils/faults.py registry) --------------------
        Option("fault_injection", str, "",
               description="comma-joined fault clauses "
                           "site:mode:1inN|everyN|once[:stall_ms] "
                           "arming the process fault registry at "
                           "daemon/cluster start (sites: "
                           "device.dispatch device.completion "
                           "store.apply msg.send msg.recv "
                           "ec.subwrite_ack; modes: error stall "
                           "corrupt)"),
        Option("fault_injection_seed", int, 0,
               description="deterministic seed for fault-registry "
                           "site RNGs"),
        Option("osd_scrub_sleep", float, 0.0, min=0.0,
               description="pause between scrub chunks (reference "
                           "osd_scrub_sleep)"),
        Option("osd_max_scrubs", int, 1, min=1,
               description="concurrent scrubs per OSD (reference "
                           "osd_max_scrubs)"),
        Option("osd_snap_trim_sleep", float, 0.0, min=0.0,
               description="pause between snap-trim rounds "
                           "(reference osd_snap_trim_sleep)"),
        Option("osd_pool_default_ec_fast_read", bool, False,
               description="new EC pools read all shards and "
                           "reconstruct from the first k (reference "
                           "osd_pool_default_ec_fast_read)"),
        Option("osd_pool_default_pgp_num", int, 0, min=0,
               description="0 = follow pg_num (reference "
                           "osd_pool_default_pgp_num)"),
        Option("osd_mon_report_interval", float, 0.0, min=0.0,
               description="min seconds between PG stat reports; 0 "
                           "reports every tick (reference "
                           "osd_mon_report_interval)"),
        Option("osd_objectstore", str, "memstore",
               enum_allowed=("memstore", "file", "block", "bluestore"),
               description="backing store kind for new OSDs "
                           "(reference osd_objectstore; consumed by "
                           "vstart/cephadm provisioning)"),
        # -- mds / fs -----------------------------------------------------
        Option("mds_journal_checkpoint_interval", int, 64, min=1,
               description="journaled ops between watermark+trim "
                           "(reference mds_log_max_segments analog)"),
        Option("mds_recall_timeout", float, 2.0, min=0.05,
               description="seconds before an unanswered cap recall "
                           "is forced (reference mds_recall_warning "
                           "analog)"),
        Option("fs_default_stripe_unit", int, 64 << 10, min=4096,
               description="default file layout stripe unit "
                           "(reference fs_types default layout)"),
        Option("fs_default_stripe_count", int, 4, min=1,
               description="default file layout stripe count"),
        Option("fs_default_object_size", int, 4 << 20, min=4096,
               description="default file layout object size"),
        # -- rbd ----------------------------------------------------------
        Option("rbd_default_order", int, 22, min=12, max=26,
               description="new images use 2^order-byte objects "
                           "(reference rbd_default_order)"),
        Option("rbd_default_size", int, 1 << 30, min=1,
               description="image size when the CLI gets none "
                           "(reference create defaults)"),
        # -- rgw ----------------------------------------------------------
        Option("rgw_list_max_keys", int, 1000, min=1,
               description="S3 ListObjects page cap (reference "
                           "rgw_max_listing_results)"),
        Option("rgw_multipart_part_limit", int, 10000, min=1,
               description="max parts per multipart upload "
                           "(reference rgw_multipart_part_upload_limit)"),
        Option("rgw_max_put_size", int, 5 << 30, min=1,
               description="largest single PUT (reference "
                           "rgw_max_put_size)"),
        Option("rgw_lc_interval", float, 86400.0, min=0.0,
               description="seconds between lifecycle worker passes; "
                           "0 disables the worker (reference "
                           "rgw_lc_debug_interval/rgw_lifecycle_work_"
                           "time)"),
        # -- mon ----------------------------------------------------------
        Option("mon_allow_pool_delete", bool, True,
               description="refuse `osd pool delete` when false "
                           "(reference mon_allow_pool_delete; the "
                           "reference defaults false, here true so "
                           "test teardown keeps working)"),
        Option("mon_allow_pool_size_one", bool, True,
               description="permit size=1 replicated pools "
                           "(reference mon_allow_pool_size_one)"),
        Option("mon_min_osdmap_epochs", int, 500, min=1,
               description="full maps kept before trim (reference "
                           "mon_min_osdmap_epochs)"),
        Option("mon_mds_beacon_grace_factor", float, 1.0, min=0.1,
               description="multiplier on mds_beacon_grace applied "
                           "by the monitor (load tolerance)"),
        # -- messenger ----------------------------------------------------
        Option("ms_tcp_nodelay", bool, True,
               description="disable Nagle on data sockets "
                           "(reference ms_tcp_nodelay)"),
        Option("ms_tcp_listen_backlog", int, 128, min=1,
               description="accept queue depth (reference "
                           "ms_tcp_listen_backlog)"),
        Option("ms_max_backoff", float, 2.0, min=0.01,
               description="reconnect backoff cap; retries double "
                           "from ms_connection_retry_interval up to "
                           "this (reference ms_max_backoff)"),
        # -- stores -------------------------------------------------------
        Option("memstore_max_bytes", int, 0, min=0,
               description="per-store capacity cap, 0 unlimited "
                           "(reference memstore_device_bytes); writes "
                           "past it fail ENOSPC"),
        Option("kv_compact_factor", int, 4, min=2,
               description="LogDB compacts when the log exceeds this "
                           "multiple of live data"),
        Option("filestore_fsync", bool, False,
               description="fsync the WAL before acking commits "
                           "(durability vs test speed)"),
        Option("blockstore_compression_algorithm", str, "none",
               enum_allowed=("none", "zlib", "bz2", "lzma", "snappy",
                             "zstd"),
               description="inline-compress large aligned BlockStore "
                           "writes with this registry codec "
                           "(reference bluestore_compression_"
                           "algorithm; none disables; reads honor "
                           "whatever a segment was written with)"),
        Option("bluestore_wal_segment_bytes", int, 16 << 20,
               min=1 << 20, max=256 << 20, tunable=True,
               description="BlueStore WAL rolls to a new segment "
                           "past this size; retired whole once fully "
                           "applied (reference bluefs/WAL sizing)"),
        Option("bluestore_group_commit_window_us", int, 0,
               min=0, max=10000, tunable=True,
               description="group-commit leader dwells this long "
                           "before the shared WAL fsync so "
                           "concurrent committers pile in; 0 syncs "
                           "immediately (reference "
                           "bluefs_alloc_size-era batching analog)"),
        Option("bluestore_apply_batch_txns", int, 16,
               min=1, max=512, tunable=True,
               description="max WAL-durable transactions folded into "
                           "one deferred apply batch: one vectored "
                           "device pass + one KV commit (reference "
                           "bluestore_deferred_batch_ops)"),
        Option("bluestore_deferred_queue_depth", int, 128,
               min=1, max=4096, tunable=True,
               description="pending (committed, unapplied) txns "
                           "before queue_transactions blocks — "
                           "bounds the commit→apply window "
                           "(reference bluestore_throttle_deferred_"
                           "bytes analog)"),
        # -- client -------------------------------------------------------
        Option("rados_mon_op_timeout", float, 30.0, min=0.1,
               description="default mon_command timeout (reference "
                           "rados_mon_op_timeout)"),
        Option("client_retry_interval", float, 0.05, min=0.001,
               description="client poll cadence while waiting on "
                           "cluster state transitions"),
        # -- compressor ---------------------------------------------------
        Option("compressor_zlib_level", int, 5, min=1, max=9,
               description="zlib compression level (reference "
                           "compressor_zlib_level)"),
        # -- osd: ticks / history / scrub cadence / watch-notify ----------
        Option("osd_tick_interval", float, 0.5, min=0.05,
               description="OSD housekeeping tick cadence (reference "
                           "OSD::tick)"),
        Option("osd_op_history_size", int, 20, min=0,
               description="completed ops kept for dump_historic_ops "
                           "(reference osd_op_history_size)"),
        Option("osd_op_history_duration", float, 600.0, min=0.0,
               description="seconds a completed op stays in the "
                           "history (reference "
                           "osd_op_history_duration)"),
        Option("trace_keep_spans", int, 512, min=1,
               description="finished spans retained per tracer"),
        Option("flight_recorder_events", int, 256, min=16,
               description="bounded ring of recent routing/batcher/"
                           "fault events kept per OSD for "
                           "dump_flight_recorder and auto-dumps"),
        Option("contention_stall_threshold", float, 0.05, min=0.0,
               description="lock/condition waits at or over this many "
                           "seconds count as stalls and are noted "
                           "into the flight recorder"),
        Option("osd_sampler_hz", float, 67.0, min=0.0,
               description="wall-clock stack sampler rate for the "
                           "process-wide profiler behind dump_profile "
                           "(0 disables; the thread runs while any "
                           "OSD holds it retained)"),
        Option("admin_socket", str, "",
               description="unix-socket path template for daemon admin "
                           "commands; $name expands to the daemon name "
                           "(reference admin_socket, empty disables)"),
        Option("osd_heartbeat_min_size", int, 0, min=0,
               description="pad pings to at least this many bytes "
                           "(reference osd_heartbeat_min_size — "
                           "exposes MTU blackholes)"),
        Option("osd_scrub_auto_repair", bool, False,
               description="repair scrub-found inconsistencies "
                           "automatically (reference "
                           "osd_scrub_auto_repair)"),
        Option("osd_scrub_min_interval", float, 0.0, min=0.0,
               description="per-PG randomized scrub cadence lower "
                           "bound; 0 = use osd_scrub_interval flat"),
        Option("osd_scrub_max_interval", float, 0.0, min=0.0,
               description="per-PG randomized scrub cadence upper "
                           "bound"),
        Option("osd_default_notify_timeout", float, 5.0, min=0.1,
               description="watch/notify ack timeout when the client "
                           "sends none (reference "
                           "osd_default_notify_timeout)"),
        Option("osd_pool_default_crush_rule", str, "",
               description="rule for new replicated pools when the "
                           "command names none ('' = replicated_rule; "
                           "reference osd_pool_default_crush_rule)"),
        # -- mon: boot / fullness / disk health ---------------------------
        Option("mon_osd_auto_mark_in", bool, True,
               description="booting OSDs that were auto-marked out "
                           "come back in (reference "
                           "mon_osd_auto_mark_booting_in)"),
        Option("mon_osd_full_ratio", float, 0.95, min=0.0, max=1.0,
               description="store usage above this is OSD_FULL health "
                           "(reference mon_osd_full_ratio)"),
        Option("mon_osd_nearfull_ratio", float, 0.85, min=0.0,
               max=1.0,
               description="store usage above this is OSD_NEARFULL "
                           "health (reference mon_osd_nearfull_ratio)"),
        Option("mon_data_avail_warn", int, 30, min=0, max=100,
               description="warn when the mon data dir's filesystem "
                           "has less free %% than this (reference "
                           "mon_data_avail_warn)"),
        # -- client throttles ---------------------------------------------
        Option("objecter_inflight_op_bytes", int, 100 << 20, min=1,
               description="client dirty-byte window (reference "
                           "objecter_inflight_op_bytes)"),
        # -- auth triple (reference auth_*_required) ----------------------
        Option("auth_service_required", str, "none",
               enum_allowed=("none", "cephx")),
        Option("auth_client_required", str, "none",
               enum_allowed=("none", "cephx")),
        # -- messenger bind range -----------------------------------------
        Option("ms_bind_port_min", int, 6800, min=1, max=65535,
               description="daemon port range start when binding "
                           "without an explicit port (reference "
                           "ms_bind_port_min; 0-port test binds "
                           "stay ephemeral unless set)"),
        Option("ms_bind_port_max", int, 7300, min=1, max=65535),
        Option("ms_bind_port_range_enabled", bool, False,
               description="bind daemons inside "
                           "[ms_bind_port_min, ms_bind_port_max] "
                           "instead of ephemeral ports"),
        # -- rbd ----------------------------------------------------------
        Option("rbd_validate_names", bool, True,
               description="reject image names with reserved "
                           "characters (reference rbd_validate_pool)"),
        Option("mon_compact_on_start", bool, False,
               description="force a LogDB compaction when a monitor "
                           "store opens (reference "
                           "mon_compact_on_start)"),
        Option("ms_die_on_bad_msg", bool, False,
               description="raise on an undecodable frame instead of "
                           "dropping it (reference ms_die_on_bad_msg; "
                           "debugging aid)"),
        Option("mds_max_file_size", int, 1 << 40, min=1,
               description="largest file the striper will address "
                           "(reference mds_max_file_size)"),
        Option("ms_tcp_rcvbuf", int, 0, min=0,
               description="SO_RCVBUF on data sockets; 0 = OS default "
                           "(reference ms_tcp_rcvbuf)"),
        Option("osd_pool_erasure_code_stripe_unit", int, 4096,
               min=512,
               description="default EC chunk size when the profile "
                           "sets none (reference "
                           "osd_pool_erasure_code_stripe_unit)"),
        Option("osd_scrub_load_threshold", float, 0.0, min=0.0,
               description="skip scheduling scrubs while 1-min load "
                           "average exceeds this; 0 disables the "
                           "check (reference osd_scrub_load_threshold)"),
        Option("ec_tpu_scrub_window_bytes", int, 16 << 20, min=1 << 20,
               description="deep-scrub checksum window: object bytes "
                           "batched into ONE linear-CRC device apply "
                           "(ops/crclinear); bounds per-window host "
                           "memory and device batch size"),
        Option("osd_deep_scrub_syndrome", bool, False,
               description="deep scrub also emits per-object GF "
                           "syndrome CRC partials per shard; the "
                           "primary XORs them across the acting set "
                           "— nonzero means the code word is "
                           "inconsistent even when every shard's own "
                           "CRC matches (whole-stripe check beyond "
                           "reference ECBackend.cc:2475 per-shard "
                           "compare)"),
    ]


class Config:
    """Layered config values + observer notification (reference
    common/config.cc md_config_t::set_val / apply_changes)."""

    SOURCES = ("default", "file", "env", "cli", "runtime")

    def __init__(self, overrides: Optional[Dict[str, Any]] = None):
        self._lock = threading.RLock()
        self.schema: Dict[str, Option] = {o.name: o for o in _opts()}
        self._values: Dict[str, Dict[str, Any]] = {
            s: {} for s in self.SOURCES}
        self._observers: Dict[str, List[Callable[[str, Any], None]]] = {}
        for name, opt in self.schema.items():
            self._values["default"][name] = opt.default
        self._load_env()
        for k, v in (overrides or {}).items():
            self.set(k, v, source="cli")

    def _load_env(self) -> None:
        # CEPH_TPU_<OPTION_NAME_UPPER>=value
        for name in self.schema:
            env = os.environ.get("CEPH_TPU_" + name.upper())
            if env is not None:
                self._values["env"][name] = self.schema[name].validate(env)

    # -- access ------------------------------------------------------------
    def get(self, name: str) -> Any:
        with self._lock:
            if name not in self.schema:
                raise KeyError(f"unknown option {name!r}")
            for source in reversed(self.SOURCES):
                if name in self._values[source]:
                    return self._values[source][name]
        raise AssertionError("unreachable: defaults always populated")

    def __getitem__(self, name: str) -> Any:
        return self.get(name)

    def is_overridden(self, name: str) -> bool:
        """True when any non-default layer sets the option — lets a
        consumer distinguish an explicit 0 from the compiled default
        (the hdd/ssd-tuned options' 0-means-auto convention)."""
        with self._lock:
            if name not in self.schema:
                raise KeyError(f"unknown option {name!r}")
            return any(name in self._values[src]
                       for src in self.SOURCES if src != "default")

    def unset(self, name: str, source: str = "runtime") -> None:
        """Drop a layered override so the option falls back to the
        next source/default; observers fire on an effective change."""
        with self._lock:
            if name not in self.schema:
                raise KeyError(f"unknown option {name!r}")
            old = self.get(name)
            self._values.get(source, {}).pop(name, None)
            new = self.get(name)
            observers = list(self._observers.get(name, ())) \
                if new != old else []
        for fn in observers:
            fn(name, new)

    def set(self, name: str, value: Any, source: str = "runtime") -> None:
        with self._lock:
            if name not in self.schema:
                raise KeyError(f"unknown option {name!r}")
            if source not in self.SOURCES:
                raise ValueError(f"unknown source {source!r}")
            old = self.get(name)
            value = self.schema[name].validate(value)
            self._values[source][name] = value
            new = self.get(name)
            observers = list(self._observers.get(name, ())) \
                if new != old else []
        for fn in observers:
            fn(name, new)

    def add_observer(self, name: str,
                     fn: Callable[[str, Any], None]) -> None:
        """Called with (name, new_value) after an effective change
        (reference md_config_obs_t)."""
        with self._lock:
            if name not in self.schema:
                raise KeyError(f"unknown option {name!r}")
            self._observers.setdefault(name, []).append(fn)

    def dump(self) -> Dict[str, Any]:
        with self._lock:
            return {name: self.get(name) for name in sorted(self.schema)}

    def diff(self) -> Dict[str, Any]:
        """Only options changed from their defaults (reference
        `ceph config diff`)."""
        with self._lock:
            return {name: self.get(name) for name in sorted(self.schema)
                    if self.get(name) != self.schema[name].default}

    def tunables(self) -> List[Option]:
        """Options carrying the machine-readable ``tunable`` marker —
        the autotuner's knob universe (utils/tuner.py enumerates this
        instead of keeping its own list)."""
        with self._lock:
            return [o for o in self.schema.values() if o.tunable]


def apply_cluster_config_overrides(conf: "Config",
                                   cluster_config: Dict[str, str],
                                   applied: Dict[str, str]
                                   ) -> Dict[str, str]:
    """Apply the monitor's central-config overrides that ride every
    published map (reference ConfigMonitor -> MConfig): set changed
    values, REVERT removals, return the updated applied-set.  Shared
    by every daemon that consumes maps (OSD, mgr)."""
    for name, raw in cluster_config.items():
        try:
            if str(conf.get(name)) != raw:
                conf.set(name, raw)
            applied[name] = raw
        except (KeyError, ValueError):
            pass                     # unknown/bad option: skip
    for name in list(applied):
        if name not in cluster_config:
            try:
                conf.unset(name)
            except KeyError:
                pass
            del applied[name]
    return applied


_default: Optional[Config] = None
_default_lock = threading.Lock()


def default_config() -> Config:
    """Process-wide config (the reference's g_ceph_context->_conf)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = Config()
        return _default

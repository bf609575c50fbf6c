"""Port twins of the JAX package's OSD batcher tests.

The cross-op stripe batcher (ceph_tpu_torch/osd/batcher.py) driven
through the `gpu` plugin on the CPU, where each kernel wrapper runs its
plain PyTorch version: twins of the non-cluster tests of
tests/test_batcher.py, of the batcher parts of test_decode_pipeline.py,
test_rmw_delta.py, test_device_waterfall.py and test_faults.py, a
whole-slice comparison with the JAX package's batcher over the `tpu`
codec, and the packet lane held to jerasure (where the JAX package's
batcher is not the oracle: it sends packet codes down a byte-domain
apply).  Last, the three live-cluster tests of tests/test_batcher.py on
a 3-OSD cluster of the port's daemons with a `gpu` k=2 m=1 pool.
``test_dispatch_rides_mesh_on_multidevice_host`` is twinned in
tests/test_torch_mesh_pipeline.py (a forced four-device mesh)."""
import os
import threading
import time
import types

import numpy as np
import pytest

from ceph_tpu_torch.ec import registry as ecreg
from ceph_tpu_torch.osd import ecutil
from ceph_tpu_torch.osd.batcher import EncodeBatcher
from ceph_tpu_torch.utils import faults as faultlib
from ceph_tpu_torch.utils.device_ledger import PHASE_ORDER, charge_phases
from ceph_tpu_torch.utils.faults import DEVICE_COMPLETION, DEVICE_DISPATCH
from ceph_tpu_torch.utils.flight_recorder import FlightRecorder
from ceph_tpu_torch.utils.perf import PerfCountersCollection


def make_codec(k, m, technique="reed_sol_van", **profile):
    """A `gpu` plugin codec on the CPU."""
    return ecreg.instance().factory(
        "gpu", {"k": str(k), "m": str(m), "technique": technique,
                "device": "cpu", **profile})


def make_jerasure(k, m, **profile):
    return ecreg.instance().factory(
        "jerasure", {"k": str(k), "m": str(m), **profile})


def make_batcher(**over):
    conf = {"ec_tpu_batch_stripes": 1024,
            "ec_tpu_queue_window_us": 30_000}
    conf.update(over)
    EncodeBatcher.reset_learning()   # crossover state is process-wide
    return EncodeBatcher(conf)


@pytest.fixture
def codec():
    return make_codec(2, 1)


def test_dispatch_on_single_card_has_no_mesh(codec):
    """One card, no mesh: the backend reports mesh_info() None and no
    mesh_build events, a dispatch carries one ledger, and the batcher
    keys its learner state to the single-device shape (None) — the
    state of a mesh shape seen before is stashed, not carried over."""
    backend = codec.core.backend
    assert backend.mesh_info() is None
    assert list(backend.mesh_events) == []
    ab = codec.encode_batch_async(np.zeros((5, 2, 256), dtype=np.uint8))
    ab.wait()
    assert ab.ledger["device"] == 0
    assert getattr(ab, "ledgers", None) is None
    coll = PerfCountersCollection()
    rec = FlightRecorder(capacity=64, name="osd.mesh")
    EncodeBatcher.reset_learning()
    EncodeBatcher._mesh_key = (4, 2)     # learned under a 4 x 2 mesh
    EncodeBatcher._h2d_bps = 5.0
    b = EncodeBatcher({"ec_tpu_batch_stripes": 1024,
                       "ec_tpu_queue_window_us": 1000},
                      perf_coll=coll, recorder=rec)
    try:
        sinfo = ecutil.StripeInfo(2, 2 * 256)
        rng = np.random.default_rng(3)
        data = rng.integers(0, 256, (5, 2, 256), dtype=np.uint8).tobytes()
        got, ev = {}, threading.Event()
        b.submit(codec, sinfo, data, lambda ch: (got.update(ch), ev.set()))
        assert ev.wait(30)
        assert got == ecutil.encode(sinfo, codec, data)
        assert EncodeBatcher._mesh_key is None
        assert EncodeBatcher._mesh_state[(4, 2)]["h2d_bps"] == 5.0
        dp = coll.perf_dump()["ec_device"]
        assert (dp["mesh_dp"], dp["mesh_sp"], dp["mesh_devices"]) == \
            (0, 0, 0)
        assert not [e for e in rec.dump() if e["kind"] == "mesh_build"]
        assert b.device_dump()["mesh"] is None
    finally:
        b.stop()
        EncodeBatcher.reset_learning()


def test_two_ops_share_one_device_call(codec):
    """Two concurrent submits inside the window coalesce into a single
    encode_batch_async call, and each op's chunks are bit-exact with
    the synchronous path."""
    b = make_batcher()
    try:
        sinfo = ecutil.StripeInfo(2, 8192)
        d1 = os.urandom(3 * 8192)        # 3 stripes
        d2 = os.urandom(5 * 8192)        # 5 stripes
        got = {}
        done = threading.Event()

        def cb(tag):
            def _cb(chunks):
                got[tag] = chunks
                if len(got) == 2:
                    done.set()
            return _cb

        b.submit(codec, sinfo, d1, cb("a"))
        b.submit(codec, sinfo, d2, cb("b"))
        assert done.wait(30)
        assert b.calls == 1, "expected ONE device call for both ops"
        assert b.reqs_coalesced == 2
        assert got["a"] == ecutil.encode(sinfo, codec, d1)
        assert got["b"] == ecutil.encode(sinfo, codec, d2)
    finally:
        b.stop()


def test_different_geometries_never_mix(codec):
    other = make_codec(3, 2)
    b = make_batcher()
    try:
        s2 = ecutil.StripeInfo(2, 8192)
        s3 = ecutil.StripeInfo(3, 12288)
        d2 = os.urandom(2 * 8192)
        d3 = os.urandom(2 * 12288)
        got = {}
        done = threading.Event()

        def cb(tag):
            def _cb(chunks):
                got[tag] = chunks
                if len(got) == 2:
                    done.set()
            return _cb

        b.submit(codec, s2, d2, cb("k2"))
        b.submit(other, s3, d3, cb("k3"))
        assert done.wait(30)
        assert b.calls == 2              # one per geometry
        assert got["k2"] == ecutil.encode(s2, codec, d2)
        assert got["k3"] == ecutil.encode(s3, other, d3)
    finally:
        b.stop()


def test_stripe_budget_flushes_before_window(codec):
    """Hitting ec_tpu_batch_stripes releases the batch without waiting
    out the (deliberately huge) window."""
    b = make_batcher(ec_tpu_batch_stripes=4,
                     ec_tpu_queue_window_us=60_000_000)
    try:
        sinfo = ecutil.StripeInfo(2, 8192)
        data = os.urandom(4 * 8192)      # meets the budget alone
        done = threading.Event()
        b.submit(codec, sinfo, data, lambda chunks: done.set())
        assert done.wait(30), \
            "budget-full batch should flush immediately"
    finally:
        b.stop()


def test_non_batchable_codec_encodes_inline():
    jr = ecreg.instance().factory("jerasure", {"k": "2", "m": "1"})
    b = make_batcher()
    try:
        sinfo = ecutil.StripeInfo(2, 8192)
        data = os.urandom(8192)
        out = {}
        b.submit(jr, sinfo, data, out.update)
        # inline: the callback already ran on this thread
        assert out == ecutil.encode(sinfo, jr, data)
        assert b.calls == 0
    finally:
        b.stop()


def test_collector_survives_raising_continuation(codec, capsys):
    """A continuation that raises must not kill the collector thread
    (that would wedge every EC write on the OSD)."""
    b = make_batcher()
    try:
        sinfo = ecutil.StripeInfo(2, 8192)
        data = os.urandom(8192)

        def bad_cb(chunks):
            raise RuntimeError("continuation exploded")

        b.submit(codec, sinfo, data, bad_cb)
        # the next op must still encode fine on the same collector
        done = threading.Event()
        out = {}

        def good_cb(chunks):
            out.update(chunks)
            done.set()

        deadline = time.monotonic() + 30
        while not done.is_set() and time.monotonic() < deadline:
            b.submit(codec, sinfo, data, good_cb)
            done.wait(1)
        assert done.is_set(), "collector died after a bad continuation"
        assert out == ecutil.encode(sinfo, codec, data)
    finally:
        b.stop()


def test_adaptive_crossover_routes_small_batches_to_cpu(codec):
    """A device whose round trip loses to the CPU twin must push the
    learned crossover up, after which small batches encode on the CPU
    — bit-exactly — and the stats show it."""
    b = make_batcher(ec_tpu_queue_window_us=1000)
    try:
        sinfo = ecutil.StripeInfo(2, 8192)
        data = os.urandom(2 * 8192)

        real_async = type(codec).encode_batch_async

        class SlowBatch:
            def __init__(self, inner):
                self.inner = inner

            def wait(self):
                time.sleep(0.5)      # simulated terrible link
                return self.inner.wait()

        def slow_async(self_codec, arr):
            return SlowBatch(real_async(self_codec, arr))

        type(codec).encode_batch_async = slow_async
        try:
            done = threading.Event()
            b.submit(codec, sinfo, data, lambda c: done.set())
            assert done.wait(30)
            assert b._min_device_bytes > len(data), \
                "losing device call should raise the crossover"
            # subsequent small batches take the CPU path
            out = {}
            done2 = threading.Event()
            b.submit(codec, sinfo, data,
                     lambda c: (out.update(c), done2.set()))
            assert done2.wait(30)
            assert b.cpu_reqs >= 1
            assert out == ecutil.encode(sinfo, codec, data)
        finally:
            type(codec).encode_batch_async = real_async
    finally:
        b.stop()


def test_oversized_group_tiles_at_max_stripes(codec):
    """A dispatch group larger than ec_tpu_batch_stripes is tiled into
    multiple device calls (bounded per-call memory + a bounded compile
    shape set), and the reassembled chunks stay bit-exact."""
    b = make_batcher(ec_tpu_batch_stripes=4,
                     ec_tpu_queue_window_us=30_000)
    try:
        sinfo = ecutil.StripeInfo(2, 8192)
        d1 = os.urandom(7 * 8192)        # 7 stripes > 4-stripe tile
        d2 = os.urandom(3 * 8192)
        got = {}
        done = threading.Event()

        def cb(tag):
            def _cb(chunks):
                got[tag] = chunks
                if len(got) == 2:
                    done.set()
            return _cb

        b.submit(codec, sinfo, d1, cb("a"))
        b.submit(codec, sinfo, d2, cb("b"))
        assert done.wait(30)
        assert got["a"] == ecutil.encode(sinfo, codec, d1)
        assert got["b"] == ecutil.encode(sinfo, codec, d2)
    finally:
        b.stop()


def test_prewarm_measures_cpu_rate_ahead_of_ops(codec):
    """prewarm() at EC-backend build fills the crossover router's CPU
    rate for the geometry BEFORE any client op, and is once-per-
    geometry process-wide."""
    from ceph_tpu_torch.osd.batcher import _geometry_key
    b = make_batcher()
    try:
        sinfo = ecutil.StripeInfo(2, 8192)
        key = _geometry_key(codec, sinfo)
        assert key not in EncodeBatcher._cpu_bps
        b.prewarm(codec, sinfo)
        deadline = time.time() + 20
        while key not in EncodeBatcher._cpu_bps \
                and time.time() < deadline:
            time.sleep(0.05)
        assert EncodeBatcher._cpu_bps.get(key, 0) > 0, \
            "prewarm did not measure the CPU twin rate"
        assert key in EncodeBatcher._warmed
        # second prewarm is a no-op (already warmed)
        b.prewarm(codec, sinfo)
    finally:
        b.stop()


def test_stop_drains_inflight_work(codec):
    """stop() must not return while a device call + continuation are
    still in flight — OSD shutdown unmounts the store right after, and
    a late continuation would land in an unmounted store."""
    b = make_batcher(ec_tpu_queue_window_us=1000)
    sinfo = ecutil.StripeInfo(2, 8192)
    done = threading.Event()
    orig = codec.encode_batch_async

    def slow(data):
        time.sleep(0.8)              # a cold compile / busy device
        return orig(data)
    codec.encode_batch_async = slow
    try:
        b.submit(codec, sinfo, os.urandom(8192), lambda _c: done.set())
        time.sleep(0.2)              # collector picks the group up
        b.stop()
        assert done.is_set(), \
            "stop() returned before the in-flight continuation ran"
    finally:
        del codec.encode_batch_async


def test_decode_requests_coalesce_per_signature(codec):
    """Concurrent reconstructions of the SAME
    erasure signature (what a rebuild produces for every object) share
    one batched decode call, bit-exact with the synchronous path."""
    b = make_batcher()
    try:
        sinfo = ecutil.StripeInfo(2, 8192)
        d1 = os.urandom(3 * 2 * 8192)    # 3 stripes
        d2 = os.urandom(5 * 2 * 8192)    # 5 stripes
        enc1 = ecutil.encode(sinfo, codec, d1)
        enc2 = ecutil.encode(sinfo, codec, d2)
        have1 = {0: enc1[0], 2: enc1[2]}     # shard 1 lost
        have2 = {0: enc2[0], 2: enc2[2]}
        got = {}
        done = threading.Event()

        def cb(tag):
            def _cb(dec):
                got[tag] = dec
                if len(got) == 2:
                    done.set()
            return _cb

        b.submit_decode(codec, sinfo, have1, {1}, cb("a"))
        b.submit_decode(codec, sinfo, have2, {1}, cb("b"))
        assert done.wait(30)
        assert b.dec_calls == 1, "same signature must share one call"
        assert b.dec_coalesced == 2
        assert got["a"] == {1: enc1[1]}
        assert got["b"] == {1: enc2[1]}
    finally:
        b.stop()


def test_decode_signatures_never_mix(codec):
    """Different erasure signatures (different shards lost) must not
    share a decode call — their row sets differ."""
    b = make_batcher()
    try:
        sinfo = ecutil.StripeInfo(2, 8192)
        d = os.urandom(2 * 2 * 8192)
        enc = ecutil.encode(sinfo, codec, d)
        got = {}
        done = threading.Event()

        def cb(tag):
            def _cb(dec):
                got[tag] = dec
                if len(got) == 2:
                    done.set()
            return _cb

        b.submit_decode(codec, sinfo, {0: enc[0], 2: enc[2]}, {1},
                        cb("s1"))
        b.submit_decode(codec, sinfo, {1: enc[1], 2: enc[2]}, {0},
                        cb("s0"))
        assert done.wait(30)
        assert b.dec_calls == 2
        assert b.dec_coalesced == 0
        assert got["s1"] == {1: enc[1]}
        assert got["s0"] == {0: enc[0]}
    finally:
        b.stop()


def test_cpu_routed_group_still_coalesces(codec):
    """When the learned crossover routes a group off the device, the
    group still encodes as ONE batched twin call (native C++ when
    available) — the coalescing win survives CPU routing ('0 coalesced, 9
    routed to cpu twin' must be impossible for a multi-op group)."""
    b = make_batcher()
    try:
        EncodeBatcher._min_device_bytes = 1 << 30   # force CPU route
        EncodeBatcher._probe_tick = 1               # avoid probe tick
        sinfo = ecutil.StripeInfo(2, 8192)
        d1 = os.urandom(3 * 8192)
        d2 = os.urandom(5 * 8192)
        got = {}
        done = threading.Event()

        def cb(tag):
            def _cb(chunks):
                got[tag] = chunks
                if len(got) == 2:
                    done.set()
            return _cb

        b.submit(codec, sinfo, d1, cb("a"))
        b.submit(codec, sinfo, d2, cb("b"))
        assert done.wait(30)
        assert b.calls == 0, "device must not be touched"
        assert b.cpu_calls == 1, "ONE batched twin call for the group"
        assert b.reqs_coalesced == 2
        assert b.cpu_reqs == 2
        assert got["a"] == ecutil.encode(sinfo, codec, d1)
        assert got["b"] == ecutil.encode(sinfo, codec, d2)
    finally:
        b.stop()
        EncodeBatcher.reset_learning()


def test_batch_twin_is_bit_exact_for_packet_codec():
    """The native-backed _BatchTwin must be bit-exact for packet-layout
    (cauchy) geometries too — the rebuild path's decode twin."""
    cauchy = make_codec(4, 2, technique="cauchy_good", packetsize="128")
    b = make_batcher()
    try:
        sinfo = ecutil.StripeInfo(4, 4 * 8 * 128)
        twin = b.cpu_twin(cauchy, sinfo)
        rng = np.random.default_rng(11)
        data = rng.integers(0, 256, (6, 4, 8 * 128), dtype=np.uint8)
        assert np.array_equal(twin.encode_batch(data),
                              cauchy.encode_batch(data))
        parity = cauchy.encode_batch(data)
        present = {0: data[:, 0], 2: data[:, 2], 3: data[:, 3],
                   4: parity[:, 0]}
        rec = twin.decode_batch(present, 8 * 128)
        assert np.array_equal(rec[1], data[:, 1])
    finally:
        b.stop()


def test_stage_counters_and_tracked_events(codec):
    """The dedicated ec_batcher perf subsystem fills the per-stage
    histograms/counters for a device-routed group, the cumulative
    stage clocks advance, and a tracked op receives the batcher's
    dispatch stage event."""
    from ceph_tpu_torch.utils.optracker import OpTracker
    from ceph_tpu_torch.utils.perf import PerfCountersCollection
    EncodeBatcher.reset_learning()
    coll = PerfCountersCollection()
    b = EncodeBatcher({"ec_tpu_batch_stripes": 1024,
                       "ec_tpu_queue_window_us": 1000},
                      perf_coll=coll)
    try:
        top = OpTracker().create("osd_op(client.1.1 ...)")
        sinfo = ecutil.StripeInfo(2, 8192)
        data = os.urandom(4 * 8192)
        done = threading.Event()
        b.submit(codec, sinfo, data, lambda _c: done.set(),
                 tracked=top)
        assert done.wait(30)
        assert "ec:batch_dispatched" in [e for _, e in top.events]
        d = coll.perf_dump()["ec_batcher"]
        assert sum(d["queue_wait_us"]["buckets"]) == 1
        assert sum(d["batch_stripes"]["buckets"]) == 1
        assert sum(d["dispatch_ms"]["buckets"]) == 1
        assert d["device_reqs"] == 1 and d["cpu_reqs"] == 0
        assert d["h2d_bytes"] == len(data)
        assert d["d2h_bytes"] > 0            # parity came back
        assert b.stage_seconds["queue_wait"] > 0
        # the fenced window is fully attributed across the legs
        dev = (b.stage_seconds["h2d"] + b.stage_seconds["device"]
               + b.stage_seconds["d2h"])
        assert dev > 0
    finally:
        b.stop()


def test_admission_window_grows_under_pressure_and_cuts(codec):
    """The coalescing window is admission-aware: submits arriving at
    window expiry extend it (bounded), and a cycle that closes with no
    joiners shrinks it back toward the base."""
    b = make_batcher(ec_tpu_queue_window_us=80_000)
    try:
        sinfo = ecutil.StripeInfo(2, 8192)
        base = b.window_base_s
        got = []
        done = threading.Event()

        def cb(chunks):
            got.append(chunks)
            if len(got) >= 2:
                done.set()

        b.submit(codec, sinfo, os.urandom(2 * 8192), cb)
        time.sleep(0.04)                  # mid-window: a joiner lands
        b.submit(codec, sinfo, os.urandom(2 * 8192), cb)
        assert done.wait(30)
        assert b.window_grows >= 1, \
            "late joiner did not extend the admission window"
        assert b.dyn_window_s > base
        assert b.dyn_window_s <= b.window_max_s
        assert b.queue_depth_hwm >= 2

        # a lone op afterwards closes its window with no joiners: the
        # window must shrink back toward base
        lone = threading.Event()
        b.submit(codec, sinfo, os.urandom(2 * 8192),
                 lambda _c: lone.set())
        assert lone.wait(30)
        assert b.window_cuts >= 1, \
            "drained queue did not cut the admission window"
        assert b.dyn_window_s < 2 * base + 1e-9
    finally:
        b.stop()


def test_view_based_encode_bit_exact_with_bytes_path(codec):
    """memoryview / bytearray / ndarray submissions must produce
    chunks byte-identical to the synchronous bytes-input encode (the
    zero-copy rework may change buffer types, never content)."""
    sinfo = ecutil.StripeInfo(2, 8192)
    data = os.urandom(4 * 8192)
    ref = ecutil.encode(sinfo, codec, data)
    for variant in (memoryview(data), bytearray(data),
                    np.frombuffer(data, dtype=np.uint8)):
        b = make_batcher(ec_tpu_queue_window_us=1_000)
        try:
            out = {}
            ev = threading.Event()

            def cb(chunks):
                out["c"] = chunks
                ev.set()

            b.submit(codec, sinfo, variant, cb)
            assert ev.wait(30)
            got = out["c"]
            assert set(got) == set(ref)
            for s in ref:
                assert bytes(got[s]) == bytes(ref[s]), \
                    f"shard {s} diverged for {type(variant).__name__}"
        finally:
            b.stop()


def test_8mib_k8m4_group_routes_to_device():
    """The misrouting regression: a healthy device with warm
    geometry must route an 8 MiB k8m4 encode group to the DEVICE
    (attribution: device calls > 0, batched-twin calls == 0) — with
    the crossover pinned where the fixed bench calibration pins it
    when the device wins pipelined (1 MiB)."""
    k8m4 = make_codec(8, 4)
    b = make_batcher(ec_tpu_queue_window_us=1000,
                     ec_tpu_min_device_bytes=1 << 20)
    try:
        from ceph_tpu_torch.osd.batcher import _geometry_key
        sinfo = ecutil.StripeInfo(8, 8 * 16384)      # 128 KiB stripes
        b.prewarm(k8m4, sinfo)
        key = _geometry_key(k8m4, sinfo)
        deadline = time.time() + 20
        while key not in EncodeBatcher._cpu_bps \
                and time.time() < deadline:
            time.sleep(0.05)
        assert key in EncodeBatcher._cpu_bps       # geometry is warm
        data = os.urandom(8 << 20)                   # 64 stripes
        out = {}
        done = threading.Event()
        b.submit(k8m4, sinfo, data,
                 lambda c: (out.update(c), done.set()))
        assert done.wait(60)
        assert b.calls >= 1, \
            "8 MiB group with a healthy warm device never reached it"
        assert b.cpu_calls == 0 and b.cpu_reqs == 0, \
            "8 MiB group misrouted to the batched CPU twin"
        assert out == ecutil.encode(sinfo, k8m4, data)
        # a CPU codec copies nothing host to device, so no h2d sample
        # exists here; tests/test_torch_cuda.py holds the EWMA update
        # from a real batch transfer on the card
        assert EncodeBatcher._h2d_bps == 0
    finally:
        b.stop()


def test_idle_device_gets_reprobed_despite_cpu_bias(codec):
    """A stale learned CPU bias with ZERO recent device traffic is the
    misrouting failure mode: once the device has been idle past
    ec_tpu_device_idle_reprobe_s, the next group must go to the
    device as a probe instead of waiting out the 1-in-N tick."""
    b = make_batcher(ec_tpu_queue_window_us=1000)
    try:
        # absurd learned bias (every batch "too small" for the device)
        EncodeBatcher._min_device_bytes = 1 << 30
        # ...but the device has been idle for a long time
        past = time.monotonic() - 10 * b.idle_reprobe_s
        EncodeBatcher._last_device_ts = past
        EncodeBatcher._last_idle_probe_ts = past
        sinfo = ecutil.StripeInfo(2, 8192)
        data = os.urandom(2 * 8192)
        done = threading.Event()
        b.submit(codec, sinfo, data, lambda c: done.set())
        assert done.wait(30)
        assert b.calls == 1 and b.cpu_reqs == 0, \
            "idle device never re-probed; CPU bias locked in"
        # the probe is rate-limited: an immediate second small batch
        # (device no longer idle) goes back to the learned route
        done2 = threading.Event()
        EncodeBatcher._min_device_bytes = 1 << 30
        EncodeBatcher._probe_tick = 1   # keep the 1-in-N tick silent
        b.submit(codec, sinfo, data, lambda c: done2.set())
        assert done2.wait(30)
        assert b.cpu_reqs == 1
    finally:
        b.stop()


def test_breaker_close_resets_learned_crossover(codec):
    """While the breaker is open every group encodes
    on the twin, so the learner can only accumulate CPU bias — on
    close the crossover must snap back to the operator's pin and the
    per-geometry device EWMAs must be dropped."""
    b = make_batcher(ec_tpu_min_device_bytes=4096)
    try:
        assert EncodeBatcher._pinned_min_device_bytes == 4096
        # bias accumulated while the device was sick
        EncodeBatcher._min_device_bytes = 1 << 30
        EncodeBatcher._dev_bps = {("stale",): 1.0}
        for _ in range(b.device_error_threshold):
            b._device_failure("dispatch", "encode", 0)
        assert EncodeBatcher._breaker_open
        b._device_success()          # re-admission probe completed
        assert not EncodeBatcher._breaker_open
        assert EncodeBatcher._min_device_bytes == 4096, \
            "breaker close must restore the operator's crossover pin"
        assert EncodeBatcher._dev_bps == {}, \
            "breaker close must drop stale device-rate EWMAs"
    finally:
        b.stop()


def test_learn_crossover_uses_pipelined_model_and_rejects_outliers(codec):
    """Unit-level checks on the rebuilt learner: (a) a serial fenced
    time whose slowest LEG still beats the CPU must not raise the
    threshold (pipelined overlap credited); (b) a call 5x slower than
    the geometry's steady-state EWMA is a compile/outlier and teaches
    nothing."""
    from ceph_tpu_torch.osd.batcher import _Req, _geometry_key
    b = make_batcher()
    try:
        sinfo = ecutil.StripeInfo(2, 8192)
        data = b"\0" * (64 * 8192)               # 512 KiB group
        req = _Req(codec, sinfo, data, lambda c: None)
        key = _geometry_key(codec, sinfo)
        total = float(len(data))
        # measured machine profile: CPU 1 GB/s, link 2 GB/s — the
        # transfer legs are a real fraction of the fenced window
        EncodeBatcher._cpu_bps[key] = 1e9
        EncodeBatcher._h2d_bps = 2e9
        cpu_pred = total / 1e9
        # (a) serial fence = 1.2x the CPU time, but split over
        # h2d (total/2e9) + d2h + compute, every leg is well under
        # cpu_pred: the pipelined router must NOT raise the threshold
        # (the old serial-sum judge did, and misrouted everything)
        b._learn_crossover([req], dev_time=1.2 * cpu_pred)
        assert EncodeBatcher._min_device_bytes == 0, \
            "serial-sum judging regressed: pipelined win raised the " \
            "crossover"
        steady = EncodeBatcher._dev_bps.get(key, 0.0)
        assert steady > 0
        # (b) a 100x-slower call (a cold build) must be rejected: no
        # threshold move, EWMA not poisoned
        b._learn_crossover([req], dev_time=100 * total / steady)
        assert EncodeBatcher._min_device_bytes == 0
        assert EncodeBatcher._dev_bps[key] == steady, \
            "compile outlier absorbed into the steady-state EWMA"
    finally:
        b.stop()


def test_route_verdicts_hit_recorder_and_ec_device_counters(codec):
    """Every routing verdict lands in the flight
    recorder with a reason code plus the crossover snapshot, and
    increments the matching ``ec_device`` ``route_*`` counter; the
    completed device group publishes staging/h2d telemetry."""
    from ceph_tpu_torch.utils.flight_recorder import FlightRecorder
    from ceph_tpu_torch.utils.perf import PerfCountersCollection

    coll = PerfCountersCollection()
    rec = FlightRecorder(capacity=64, name="osd.t")
    EncodeBatcher.reset_learning()
    b = EncodeBatcher({"ec_tpu_batch_stripes": 1024,
                       "ec_tpu_queue_window_us": 1000,
                       "ec_tpu_min_device_bytes": 1},
                      perf_coll=coll, recorder=rec)
    try:
        sinfo = ecutil.StripeInfo(2, 8192)
        data = os.urandom(2 * 8192)
        done = threading.Event()
        b.submit(codec, sinfo, data, lambda c: done.set())
        assert done.wait(30)
        routes = [e for e in rec.dump() if e["kind"] == "route"]
        assert routes, rec.dump()
        assert routes[0]["to"] == "device"
        assert routes[0]["reason"] == "device"
        assert routes[0]["bytes"] == len(data)
        assert routes[0]["crossover"] == 1
        dp = coll.perf_dump()["ec_device"]
        assert dp["route_device"] >= 1
        assert dp["route_pin"] == 0
        # the completed group published the staging-pool and link
        # telemetry into the same subsystem
        deadline = time.monotonic() + 10
        while coll.perf_dump()["ec_device"]["staging_slots"] == 0 \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        dp = coll.perf_dump()["ec_device"]
        assert dp["staging_slots"] >= 1
        assert dp["staging_hits"] + dp["staging_allocs"] >= 1
    finally:
        b.stop()


def test_pin_routed_twin_group_is_reason_coded(codec):
    """A crossover pinned above the group size routes to the twin
    with reason="pin" — the evidence trail a misrouting post-mortem
    needs."""
    from ceph_tpu_torch.utils.flight_recorder import FlightRecorder
    from ceph_tpu_torch.utils.perf import PerfCountersCollection

    coll = PerfCountersCollection()
    rec = FlightRecorder(capacity=64, name="osd.t2")
    EncodeBatcher.reset_learning()
    b = EncodeBatcher({"ec_tpu_batch_stripes": 1024,
                       "ec_tpu_queue_window_us": 1000,
                       "ec_tpu_min_device_bytes": 256 << 20},
                      perf_coll=coll, recorder=rec)
    try:
        sinfo = ecutil.StripeInfo(2, 8192)
        data = os.urandom(2 * 8192)
        out = {}
        done = threading.Event()
        b.submit(codec, sinfo, data,
                 lambda c: (out.update(c), done.set()))
        assert done.wait(30)
        assert out == ecutil.encode(sinfo, codec, data)
        routes = [e for e in rec.dump() if e["kind"] == "route"]
        assert routes and routes[0]["to"] == "cpu"
        assert routes[0]["reason"] == "pin"
        assert coll.perf_dump()["ec_device"]["route_pin"] >= 1
    finally:
        b.stop()


def test_breaker_transitions_are_recorded_and_auto_dumped(codec,
                                                          capsys):
    """Opening the breaker records the device_error run and the
    open transition, and auto-dumps the ring to stderr (rate
    limited); closing records the close with the restored
    crossover."""
    from ceph_tpu_torch.utils.flight_recorder import FlightRecorder
    from ceph_tpu_torch.utils.perf import PerfCountersCollection

    coll = PerfCountersCollection()
    rec = FlightRecorder(capacity=64, name="osd.t3")
    EncodeBatcher.reset_learning()
    b = EncodeBatcher({"ec_tpu_min_device_bytes": 4096},
                      perf_coll=coll, recorder=rec)
    try:
        for _ in range(b.device_error_threshold):
            b._device_failure("dispatch", "encode", 0)
        assert EncodeBatcher._breaker_open
        dp = coll.perf_dump()["ec_device"]
        assert dp["breaker_opened"] == 1
        assert dp["breaker_open_now"] == 1
        kinds = [e["kind"] for e in rec.dump()]
        assert kinds.count("device_error") == b.device_error_threshold
        opens = [e for e in rec.dump() if e["kind"] == "breaker"
                 and e["state"] == "open"]
        assert opens and opens[0]["cause"] == "dispatch"
        err = capsys.readouterr().err
        assert "flight-recorder auto-dump [osd.t3] " \
               "reason=breaker-open" in err
        b._device_success()
        assert not EncodeBatcher._breaker_open
        dp = coll.perf_dump()["ec_device"]
        assert dp["breaker_closed"] == 1
        assert dp["breaker_open_now"] == 0
        closes = [e for e in rec.dump() if e["kind"] == "breaker"
                  and e["state"] == "closed"]
        assert closes and closes[0]["crossover"] == 4096
    finally:
        b.stop()


# -- decode lane (tests/test_decode_pipeline.py) --------------------------
def test_decode_group_rides_device_with_full_ledger():
    """A device-routed decode group dispatches async, completes
    bit-exact, and folds a SEVEN-phase ledger tagged group=="decode"
    into the accumulator (not a coarse two-stamp ledger); the dec_route_device verdict and the decode
    counters land in the ec_device subsystem."""
    from ceph_tpu_torch.utils.device_ledger import PHASE_ORDER
    from ceph_tpu_torch.utils.perf import PerfCountersCollection

    codec = make_codec(2, 1)
    coll = PerfCountersCollection()
    EncodeBatcher.reset_learning()
    b = EncodeBatcher({"ec_tpu_batch_stripes": 1024,
                       "ec_tpu_queue_window_us": 1000,
                       "ec_tpu_min_device_bytes": 1},
                      perf_coll=coll)
    try:
        sinfo = ecutil.StripeInfo(2, 8192)
        d1 = os.urandom(3 * 2 * 8192)
        d2 = os.urandom(2 * 2 * 8192)
        enc1 = ecutil.encode(sinfo, codec, d1)
        enc2 = ecutil.encode(sinfo, codec, d2)
        got = {}
        done = threading.Event()

        def cb(tag):
            def _cb(dec):
                got[tag] = dec
                if len(got) == 2:
                    done.set()
            return _cb

        b.submit_decode(codec, sinfo, {0: enc1[0], 2: enc1[2]}, {1},
                        cb("a"))
        b.submit_decode(codec, sinfo, {0: enc2[0], 2: enc2[2]}, {1},
                        cb("b"))
        assert done.wait(30)
        assert got["a"] == {1: enc1[1]}
        assert got["b"] == {1: enc2[1]}
        assert b.dec_calls == 1 and b.dec_coalesced == 2
        assert b.dec_cpu_reqs == 0, "group was device-routed"
        dec_leds = [led for led in b.ledger_accum.recent()
                    if led.get("group") == "decode"]
        assert dec_leds, "no decode-tagged ledger reached the accum"
        for led in dec_leds:
            missing = [p for p in PHASE_ORDER if led.get(p) is None]
            assert not missing, f"decode ledger lacks {missing}"
            assert led.get("device", -1) >= 0
        dp = coll.perf_dump()["ec_device"]
        assert dp["dec_route_device"] >= 1
        assert dp["dec_route_pin"] == 0
        # decode groups count into the shared inflight accounting
        assert dp["inflight_groups_hwm"] >= 1
    finally:
        b.stop()


def test_decode_pin_routes_to_twin_with_reason():
    """A crossover pinned above the group routes decode to the twin
    batch path with reason="pin" — same evidence trail as encode."""
    from ceph_tpu_torch.utils.perf import PerfCountersCollection

    codec = make_codec(2, 1)
    coll = PerfCountersCollection()
    EncodeBatcher.reset_learning()
    b = EncodeBatcher({"ec_tpu_batch_stripes": 1024,
                       "ec_tpu_queue_window_us": 1000,
                       "ec_tpu_min_device_bytes": 256 << 20},
                      perf_coll=coll)
    try:
        EncodeBatcher._probe_tick = 1     # keep the tick probe silent
        EncodeBatcher._last_device_ts = time.monotonic()
        sinfo = ecutil.StripeInfo(2, 8192)
        d = os.urandom(2 * 2 * 8192)
        enc = ecutil.encode(sinfo, codec, d)
        out = {}
        done = threading.Event()
        b.submit_decode(codec, sinfo, {0: enc[0], 2: enc[2]}, {1},
                        lambda dec: (out.update(dec), done.set()))
        assert done.wait(30)
        assert out == {1: enc[1]}
        assert b.dec_cpu_reqs == 1
        dp = coll.perf_dump()["ec_device"]
        assert dp["dec_route_pin"] >= 1
        assert dp["dec_route_device"] == 0
    finally:
        b.stop()


def test_decode_crossover_seeds_from_encode_ewma():
    """Until decode groups teach their own threshold, routing judges
    against the ENCODE-learned crossover; a decode-learned value then
    takes over, and breaker close / reset_learning clear it back to
    the seed."""
    b = make_batcher()
    try:
        EncodeBatcher._min_device_bytes = 123456.0
        EncodeBatcher._dec_min_device_bytes = 0.0
        assert b._dec_min_bytes() == 123456.0, \
            "decode crossover must seed from the encode EWMA"
        EncodeBatcher._dec_min_device_bytes = 777.0
        assert b._dec_min_bytes() == 777.0
        # breaker close re-seeds decode from encode
        for _ in range(b.device_error_threshold):
            b._device_failure("dispatch", "encode", 0)
        assert EncodeBatcher._breaker_open
        b._device_success()
        assert not EncodeBatcher._breaker_open
        assert EncodeBatcher._dec_min_device_bytes == 0.0, \
            "breaker close must drop the stale decode crossover"
        EncodeBatcher._dec_min_device_bytes = 42.0
        EncodeBatcher.reset_learning()
        assert EncodeBatcher._dec_min_device_bytes == 0.0
    finally:
        b.stop()
        EncodeBatcher.reset_learning()


def test_breaker_open_decode_falls_to_twin_without_errors():
    """Chaos: with the circuit breaker OPEN, device-eligible decode
    groups fall to the CPU twin — bit-exact results, zero
    client-visible errors, and the dec_route_breaker_open verdict on
    the books."""
    from ceph_tpu_torch.utils.perf import PerfCountersCollection

    codec = make_codec(2, 1)
    coll = PerfCountersCollection()
    EncodeBatcher.reset_learning()
    b = EncodeBatcher({"ec_tpu_batch_stripes": 1024,
                       "ec_tpu_queue_window_us": 1000,
                       "ec_tpu_min_device_bytes": 1},
                      perf_coll=coll)
    try:
        for _ in range(b.device_error_threshold):
            b._device_failure("dispatch", "encode", 0)
        assert EncodeBatcher._breaker_open
        EncodeBatcher._probe_tick = 1    # keep the 1-in-N probe silent
        sinfo = ecutil.StripeInfo(2, 8192)
        results = []
        done = threading.Event()
        enc = []
        for i in range(3):
            d = os.urandom(2 * 2 * 8192)
            enc.append(ecutil.encode(sinfo, codec, d))

        def cb(dec):
            results.append(dec)
            if len(results) == 3:
                done.set()

        for e in enc:
            b.submit_decode(codec, sinfo, {0: e[0], 2: e[2]}, {1}, cb)
        assert done.wait(30)
        assert all(r is not None for r in results), \
            "breaker-open decode leaked an error to the client"
        assert sorted(bytes(r[1]) for r in results) == \
            sorted(bytes(e[1]) for e in enc)
        assert b.dec_cpu_reqs == 3
        dp = coll.perf_dump()["ec_device"]
        assert dp["dec_route_breaker_open"] >= 1
    finally:
        b.stop()
        EncodeBatcher.reset_breaker()
        EncodeBatcher.reset_learning()


# -- parity-delta lane (tests/test_rmw_delta.py) ----------------------------
CS = 4096


def _oracle_delta(jer, old, new):
    """Full re-encode oracle: Δparity == P(new) ^ P(old)."""
    return jer.core.encode_batch(old) ^ jer.core.encode_batch(new)


def _submit_and_wait(b, impl, sinfo, delta, cols, timeout=30):
    out = {}
    ev = threading.Event()

    def cb(res):
        out["res"] = res
        ev.set()

    b.submit_delta(impl, sinfo, delta, cols, cb)
    deadline = time.monotonic() + timeout
    while not ev.is_set() and time.monotonic() < deadline:
        b.tick_flush()
        ev.wait(0.01)
    assert ev.is_set(), "delta encode never completed"
    return out["res"]


def _chunks_to_parity(res, k, m, nst, cs):
    assert res is not None
    assert set(res) == {k + j for j in range(m)}
    return np.stack([np.frombuffer(bytes(res[k + j]), np.uint8)
                     .reshape(nst, cs) for j in range(m)], axis=1)


@pytest.mark.parametrize("k,m", [(8, 4), (2, 1)])
def test_batcher_delta_device_route_bit_exact(k, m):
    """submit_delta through the batcher's DEVICE lane: one coalesced
    delta-matmul, results bit-exact per rider."""
    gpu = make_codec(k, m)
    jer = make_jerasure(k, m)
    sinfo = ecutil.StripeInfo(k, k * CS)
    b = make_batcher()
    try:
        # pin the crossover at 1 byte: every group routes DEVICE
        EncodeBatcher._pinned_min_device_bytes = 1.0
        rng = np.random.default_rng(7)
        cols = (0,) if k == 2 else (1, 4)
        old = rng.integers(0, 256, (4, k, CS), dtype=np.uint8)
        new = old.copy()
        new[:, list(cols), :] ^= 0x5A
        delta = np.ascontiguousarray((old ^ new)[:, list(cols), :])
        res = _submit_and_wait(b, gpu, sinfo, delta, cols)
        got = _chunks_to_parity(res, k, m, 4, CS)
        assert np.array_equal(got, _oracle_delta(jer, old, new))
        assert b.delta_reqs == 1
        assert b.delta_calls == 1
        assert b.delta_cpu_reqs == 0, "device-pinned group hit the twin"
    finally:
        EncodeBatcher._pinned_min_device_bytes = 0.0
        b.stop()


def test_batcher_delta_twin_route_bit_exact():
    """Crossover pinned sky-high: the delta group routes to the CPU
    twin, still bit-exact, counted as delta_cpu_reqs."""
    k, m = 4, 2
    gpu = make_codec(k, m)
    jer = make_jerasure(k, m)
    sinfo = ecutil.StripeInfo(k, k * CS)
    b = make_batcher()
    try:
        # both knobs: the crossover threshold itself plus the pin that
        # freezes the probe ladder (mirrors prefer_cpu pinning)
        EncodeBatcher._pinned_min_device_bytes = float(1 << 30)
        EncodeBatcher._delta_min_device_bytes = float(1 << 30)
        cols = (0, 2)
        rng = np.random.default_rng(9)
        old = rng.integers(0, 256, (3, k, CS), dtype=np.uint8)
        new = old.copy()
        new[:, list(cols), :] ^= 0x77
        delta = np.ascontiguousarray((old ^ new)[:, list(cols), :])
        res = _submit_and_wait(b, gpu, sinfo, delta, cols)
        got = _chunks_to_parity(res, k, m, 3, CS)
        assert np.array_equal(got, _oracle_delta(jer, old, new))
        assert b.delta_cpu_reqs == 1, "pinned crossover hit the device"
    finally:
        EncodeBatcher._pinned_min_device_bytes = 0.0
        EncodeBatcher._delta_min_device_bytes = 0.0
        b.stop()


def test_batcher_delta_inline_fallback_after_stop():
    """A submit racing shutdown must still deliver a bit-exact result
    inline (never silently dropping the parity update)."""
    k, m = 2, 1
    gpu = make_codec(k, m)
    jer = make_jerasure(k, m)
    sinfo = ecutil.StripeInfo(k, k * CS)
    b = make_batcher()
    b.stop()
    rng = np.random.default_rng(3)
    old = rng.integers(0, 256, (2, k, CS), dtype=np.uint8)
    new = old.copy()
    new[:, 0, :] ^= 0x11
    delta = np.ascontiguousarray((old ^ new)[:, [0], :])
    out = {}
    b.submit_delta(gpu, sinfo, delta, (0,), lambda r: out.update(r=r))
    got = _chunks_to_parity(out["r"], k, m, 2, CS)
    assert np.array_equal(got, _oracle_delta(jer, old, new))


# -- device-phase ledger (tests/test_device_waterfall.py) ------------------
def test_encode_through_batcher_harvests_exact_ledger():
    """An encode through the real batcher (CPU torch backend) must leave
    a complete device ledger in the accumulator whose charged phases
    sum to the group wall exactly, and dump_device must report the
    staging/compile-cache memory block."""
    codec = make_codec(2, 1)
    EncodeBatcher.reset_learning()
    b = EncodeBatcher({"ec_tpu_batch_stripes": 1024,
                       "ec_tpu_queue_window_us": 30_000})
    try:
        sinfo = ecutil.StripeInfo(2, 8192)
        done = threading.Event()
        b.submit(codec, sinfo, os.urandom(8 * 8192),
                 lambda chunks: done.set())
        assert done.wait(30)
        recent = b.ledger_accum.recent()
        assert recent, "no device ledger harvested"
        for led in recent:
            stamps = [led[p] for p in PHASE_ORDER if p in led]
            assert len(stamps) >= 2
            assert sum(dt for _, dt in charge_phases(led)) == \
                pytest.approx(stamps[-1] - stamps[0], abs=1e-9)
        dump = b.device_dump()
        assert dump["ledger"]["groups"] >= 1
        assert dump["overlap"]["groups"] >= 1
        mem = dump["memory"]
        assert mem is not None
        assert mem["staging_host_bytes_peak"] >= \
            mem["staging_host_bytes"] > 0
        assert mem["dev_matrix_entries"] >= 1
        # the trace block feeds the exporter the same ring
        blk = b.device_trace_block()
        assert blk["ledgers"] and blk["memory"] is not None
    finally:
        b.stop()


def test_twin_routed_encode_still_carries_a_ledger():
    """Deterministic twin routing (pinned crossover) must still fold
    a coarse device=-1 ledger — the bench waterfall has to account
    for every group even on a box where nothing reaches the device."""
    codec = make_codec(2, 1)
    EncodeBatcher.reset_learning()
    b = EncodeBatcher({"ec_tpu_batch_stripes": 1024,
                       "ec_tpu_queue_window_us": 30_000,
                       "ec_tpu_min_device_bytes": 1 << 40})
    try:
        sinfo = ecutil.StripeInfo(2, 8192)
        done = threading.Event()
        b.submit(codec, sinfo, os.urandom(8 * 8192),
                 lambda chunks: done.set())
        assert done.wait(30)
        recent = b.ledger_accum.recent()
        assert recent, "twin group left no ledger"
        twin_leds = [l for l in recent if l.get("device") == -1]
        assert twin_leds and twin_leds[0]["group"] == "encode"
        for led in twin_leds:
            assert "h2d_start" not in led and "d2h_done" not in led
            assert sum(dt for _, dt in charge_phases(led)) == \
                pytest.approx(led["deliver"] - led["stage_acquire"],
                              abs=1e-9)
        dump = b.device_dump()
        assert dump["ledger"]["groups"] >= 1
        # overlap window stays empty: the host lane is excluded
        assert dump["overlap"]["groups"] == 0
    finally:
        b.stop()
        EncodeBatcher.reset_learning()


# -- batcher hardening (tests/test_faults.py) ------------------------------
@pytest.fixture
def clean_registry():
    """The fault registry and the breaker are process-wide state: each
    test starts and ends disarmed, with zeroed counters and a closed
    breaker."""
    faultlib.registry().reset()
    EncodeBatcher.reset_learning()
    yield
    faultlib.registry().reset()
    EncodeBatcher.reset_learning()


def reg():
    return faultlib.registry()


def make_fault_batcher(**over):
    conf = {"ec_tpu_batch_stripes": 1024,
            "ec_tpu_queue_window_us": 1000,
            "ec_tpu_fallback_cpu": False}
    conf.update(over)
    return EncodeBatcher(conf)


def encode_one(b, impl, sinfo, data, timeout=30):
    out = {}
    done = threading.Event()
    b.submit(impl, sinfo, data, lambda c: (out.update(c or {"err": None}),
                                           done.set()))
    assert done.wait(timeout)
    return out


@pytest.mark.usefixtures("clean_registry")
def test_device_fault_falls_back_to_cpu_twin_bit_exact():
    """A device whose every dispatch raises must still complete the
    group — CPU twin, bit-exact — and charge device_errors."""
    impl = make_codec(2, 1)
    b = make_fault_batcher()
    try:
        reg().arm(DEVICE_DISPATCH, mode="error", every=1)
        sinfo = ecutil.StripeInfo(2, 8192)
        data = os.urandom(2 * 8192)
        got = encode_one(b, impl, sinfo, data)
        reg().disarm(DEVICE_DISPATCH)
        assert got == ecutil.encode(sinfo, impl, data)
        assert b.device_errors >= 1
        assert b.calls == 0, "no device call can have succeeded"
        assert reg().trips(DEVICE_DISPATCH) >= 3, "retries also draw"
    finally:
        b.stop()


@pytest.mark.usefixtures("clean_registry")
def test_completion_fault_serves_group_from_cpu():
    """A dispatched handle whose wait() fails is a classified
    completion failure: the CPU twin serves the riders bit-exactly."""
    impl = make_codec(2, 1)
    b = make_fault_batcher()
    try:
        reg().arm(DEVICE_COMPLETION, mode="error", one_shot=True)
        sinfo = ecutil.StripeInfo(2, 8192)
        data = os.urandom(3 * 8192)
        got = encode_one(b, impl, sinfo, data)
        assert got == ecutil.encode(sinfo, impl, data)
        assert b.device_errors == 1
        assert not EncodeBatcher._breaker_open, "1 failure < threshold"
    finally:
        b.stop()


@pytest.mark.usefixtures("clean_registry")
def test_breaker_opens_after_threshold_and_probe_readmits():
    impl = make_codec(2, 1)
    b = make_fault_batcher()
    try:
        reg().arm(DEVICE_DISPATCH, mode="error", every=1)
        sinfo = ecutil.StripeInfo(2, 8192)
        for _ in range(b.device_error_threshold):
            encode_one(b, impl, sinfo, os.urandom(8192))
        assert EncodeBatcher._breaker_open, \
            "consecutive failures must open the breaker"
        assert EncodeBatcher._breaker_opens == 1
        reg().disarm(DEVICE_DISPATCH)    # device 'recovers'

        # open breaker: a non-probe group routes to the CPU twin
        # without touching the (now healthy) device
        EncodeBatcher._probe_tick = 0
        calls_before = b.calls
        encode_one(b, impl, sinfo, os.urandom(8192))
        assert b.calls == calls_before
        assert b.cpu_calls >= 1
        assert EncodeBatcher._breaker_open, "no probe ran yet"

        # force the shared probe tick: the probe reaches the device,
        # succeeds, and re-admits it
        EncodeBatcher._probe_tick = b.probe_interval - 1
        got = encode_one(b, impl, sinfo, os.urandom(2 * 8192))
        assert not EncodeBatcher._breaker_open, \
            "successful probe must close the breaker"
        assert EncodeBatcher._breaker_closes == 1
        assert b.calls == calls_before + 1
        assert "err" not in got
    finally:
        b.stop()


@pytest.mark.usefixtures("clean_registry")
def test_cb_error_fails_undone_requests_with_eio():
    """_cb_error(reqs) must deliver cb(None) to every request that has
    not completed — the EC backend turns that into EIO — and never
    re-fire one that already has."""
    b = make_fault_batcher()
    try:
        seen = []
        fresh = types.SimpleNamespace(done=False,
                                      cb=lambda c: seen.append(c))
        served = types.SimpleNamespace(
            done=True, cb=lambda c: seen.append("dup"))
        before = b.encode_errors
        b._cb_error([fresh, served])
        assert seen == [None]
        assert fresh.done is True
        assert b.encode_errors == before + 1
    finally:
        b.stop()


# -- the whole slice against the JAX package's batcher ---------------------
def _drive(batcher, impl, ecutil_mod, sinfo, k, m, objs, erased, cols,
           deltas):
    """Encode every object, rebuild ``erased`` of each from the rest and
    compute each object's Δparity for ``cols``, all through one batcher
    from several threads at once; returns the three result lists as
    bytes."""
    n = len(objs)
    enc, dec, dlt = [None] * n, [None] * n, [None] * n
    left = threading.Semaphore(0)

    def put(store, i):
        def cb(res):
            store[i] = None if res is None else {
                s: bytes(v) for s, v in res.items()}
            left.release()
        return cb

    def writer(i):
        batcher.submit(impl, sinfo, objs[i], put(enc, i))
    threads = [threading.Thread(target=writer, args=(i,))
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for _ in range(n):
        assert left.acquire(timeout=120)
    for i in range(n):
        have = {s: enc[i][s] for s in range(k + m) if s not in erased}
        batcher.submit_decode(impl, sinfo, have, set(erased), put(dec, i))
        batcher.submit_delta(impl, sinfo, deltas[i], cols, put(dlt, i))
    for _ in range(2 * n):
        assert left.acquire(timeout=120)
    return enc, dec, dlt


@pytest.mark.parametrize("k,m", [(8, 4), (4, 2), (2, 1)])
def test_whole_slice_matches_the_jax_batcher(k, m):
    """The same payloads (numpy, seeded) through the JAX package's
    EncodeBatcher over its `tpu` codec and through the port's over the
    `gpu` codec: encode chunk maps, rebuilt chunks for an m-erasure
    signature (4 erasures at k=8 m=4) and the Δparity of a 2-column
    overwrite are equal byte for byte, with every group on each
    batcher's device route and coalesced."""
    from ceph_tpu.ec import registry as ref_registry
    from ceph_tpu.osd import ecutil as ref_ecutil
    from ceph_tpu.osd.batcher import EncodeBatcher as RefBatcher

    cs, nst, nobj = 4096, 3, 6
    erased = tuple([1, 5, 9, 11, 0, 2][:m] if k == 8 else
                   [1, k + m - 1, 0][:m])
    cols = (2, 6) if k == 8 else (0, k - 1)
    rng = np.random.default_rng(0x5EED + 10 * k + m)
    objs = [rng.integers(0, 256, nst * k * cs, dtype=np.uint8).tobytes()
            for _ in range(nobj)]
    deltas = [rng.integers(0, 256, (nst, len(cols), cs), dtype=np.uint8)
              for _ in range(nobj)]
    conf = {"ec_tpu_batch_stripes": 1024,
            "ec_tpu_queue_window_us": 20_000,
            "ec_tpu_fallback_cpu": False}
    profile = {"k": str(k), "m": str(m), "technique": "reed_sol_van"}
    results = []
    for batcher_cls, impl, ecu in (
            (RefBatcher, ref_registry.instance().factory("tpu", profile),
             ref_ecutil),
            (EncodeBatcher, make_codec(k, m), ecutil)):
        batcher_cls.reset_learning()
        b = batcher_cls(dict(conf))
        try:
            sinfo = ecu.StripeInfo(k, k * cs)
            results.append(_drive(b, impl, ecu, sinfo, k, m, objs,
                                  erased, cols, deltas))
            assert b.cpu_reqs == b.dec_cpu_reqs == b.delta_cpu_reqs == 0
            assert b.calls < nobj and b.reqs_coalesced >= 2
        finally:
            b.stop()
            batcher_cls.reset_learning()
    ref, got = results
    for what, want, have in zip(("encode", "decode", "delta"), ref, got):
        assert None not in have, what
        assert have == want, f"{what} differs from the JAX batcher"
    # and the port's chunks are the objects' own bytes plus parity
    sinfo = ecutil.StripeInfo(k, k * cs)
    jer = make_jerasure(k, m)
    for obj, chunks in zip(objs, got[0]):
        assert chunks == {s: bytes(v) for s, v in
                          ecutil.encode(sinfo, jer, obj).items()}


PACKET_CODES = [("cauchy_good", {"k": "4", "m": "2"}),
                ("liberation", {"k": "5", "m": "3", "w": "7"}),
                ("blaum_roth", {"k": "4", "m": "2", "w": "7"})]


@pytest.mark.parametrize("packetsize", [128, 36])
@pytest.mark.parametrize("technique,profile", PACKET_CODES)
def test_packet_lane_matches_jerasure(technique, profile, packetsize):
    """The port's batcher coalesces packet-code writes through the `gpu`
    codec's encode_batch_async (B2 at a packet size that is a multiple
    of 128, B3 otherwise) and every op's chunk map equals the port's
    jerasure codec's, byte for byte."""
    gpu = make_codec(int(profile["k"]), int(profile["m"]), technique,
                     packetsize=str(packetsize),
                     **{k: v for k, v in profile.items()
                        if k not in ("k", "m")})
    jer = make_jerasure(technique=technique, packetsize=str(packetsize),
                        **profile)
    k = gpu.get_data_chunk_count()
    cs = 4 * gpu.core.w * packetsize      # jerasure's chunk alignment
    sinfo = ecutil.StripeInfo(k, k * cs)
    rng = np.random.default_rng(packetsize + k)
    objs = [rng.integers(0, 256, (1 + i % 3) * k * cs,
                         dtype=np.uint8).tobytes() for i in range(4)]
    b = make_batcher(ec_tpu_queue_window_us=20_000,
                     ec_tpu_fallback_cpu=False)
    try:
        got = [None] * len(objs)
        left = threading.Semaphore(0)
        for i, obj in enumerate(objs):
            b.submit(gpu, sinfo, obj,
                     lambda c, i=i: (got.__setitem__(i, c),
                                     left.release()))
        for _ in objs:
            assert left.acquire(timeout=60)
        assert b.cpu_reqs == 0 and b.calls < len(objs)
        for obj, chunks in zip(objs, got):
            assert chunks == ecutil.encode(sinfo, jer, obj)
    finally:
        b.stop()


def test_a_cuda_codec_never_reaches_the_batcher_without_a_card():
    """No fallback hides the card: a `gpu` codec built for CUDA raises
    on a machine without one, so there is nothing the batcher's CPU twin
    could quietly serve.  With a card, the codec's backend is CUDA."""
    import torch
    if torch.cuda.is_available():
        codec = ecreg.instance().factory("gpu", {"k": "2", "m": "1"})
        assert codec.core.backend.is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ecreg.instance().factory("gpu", {"k": "2", "m": "1"})


# -- live-cluster twins of tests/test_batcher.py ---------------------------


def _cluster(conf_over):
    from ceph_tpu_torch.cluster import Cluster
    from ceph_tpu_torch.cluster import test_config as make_conf
    return Cluster(n_osds=3, conf=make_conf(**conf_over))


def _gpu_pool(c, profile, pool):
    for i in range(3):
        c.wait_for_osd_up(i, 20)
    c.create_ec_profile(profile, plugin="gpu", k="2", m="1", device="cpu")
    c.create_pool(pool, "erasure", erasure_code_profile=profile)


def test_cluster_concurrent_writes_coalesce():
    """Live cluster: concurrent client writes across PGs land in shared
    device calls on the primaries (the README's 'gathers stripes from
    many in-flight ops into one device call' claim)."""
    # adaptive CPU routing off: this test asserts DEVICE coalescing
    with _cluster({"ec_tpu_queue_window_us": 100_000,
                   "ec_tpu_fallback_cpu": False}) as c:
        _gpu_pool(c, "eb", "ecb")
        io = c.rados().open_ioctx("ecb")
        blob = os.urandom(24 << 10)
        comps = [io.aio_write_full(f"o{i}", blob) for i in range(16)]
        for comp in comps:
            assert comp.wait(30) == 0
        coalesced = sum(o.encode_batcher.reqs_coalesced
                        for o in c.osds.values() if o is not None)
        calls = sum(o.encode_batcher.calls
                    for o in c.osds.values() if o is not None)
        reqs = sum(o.encode_batcher.reqs_total
                   for o in c.osds.values() if o is not None)
        assert reqs == 16, "every write encodes through the batcher"
        assert coalesced >= 2, \
            f"no cross-op coalescing observed ({calls} calls/16 ops)"
        assert calls < reqs
        for i in range(16):
            assert io.read(f"o{i}") == blob


def test_rebuild_decodes_ride_the_batcher():
    """Live cluster: a rebuild's recovery decodes go through the OSD
    batcher (dec_reqs > 0 on the recovering primaries) and the rebuilt
    data is intact."""
    with _cluster({"ec_tpu_queue_window_us": 5_000}) as c:
        _gpu_pool(c, "er", "ecr")
        io = c.rados().open_ioctx("ecr")
        blob = os.urandom(64 << 10)
        for i in range(8):
            io.write_full(f"r{i}", blob)
        c.wait_for_clean(30)
        c.kill_osd(1, lose_data=True)
        c.wait_for_osd_down(1)
        c.revive_osd(1)
        c.wait_for_osd_up(1)
        c.wait_for_clean(60)
        dec_reqs = sum(o.encode_batcher.dec_reqs
                       for o in c.osds.values() if o is not None)
        assert dec_reqs > 0, \
            "recovery decodes did not ride the batcher"
        for i in range(8):
            assert io.read(f"r{i}") == blob


@pytest.mark.parametrize("backend", ["classic", "crimson"])
def test_cluster_workload_device_routes_and_window_adapts(backend):
    """Cluster-shaped workload: concurrent client writes must land in at
    least one DEVICE-routed encode group, and the admission window must
    both grow (overlapping waves) and cut (drained solo ops).

    ``crimson`` is the reference's setup (the config default), and
    states the fault both packages share (ROADMAP C19): each reactor's
    tick ends in ``ReactorBatcher.shard_tick`` -> ``tick_flush``, which
    cuts the admission window, so whether it grows depends on the
    host's tick timing (on an idle host it never does, and the
    reference test is red there).  That case holds the device routing,
    the read-back and the tick cut; ``classic``, where the window is the
    batcher's alone, holds the reference's whole body."""
    conf = {"ec_tpu_queue_window_us": 150_000,
            "ec_tpu_fallback_cpu": False}
    if backend == "classic":
        conf["osd_backend"] = "classic"
    with _cluster(conf) as c:
        _gpu_pool(c, "aw", "awp")
        batchers = [o.encode_batcher for o in c.osds.values()
                    if o is not None]
        tick_cuts = []
        for b in batchers:
            inner = getattr(b, "_inner", None)
            if inner is not None:
                def counted(real=inner.tick_flush):
                    tick_cuts.append(1)
                    real()
                inner.tick_flush = counted
        assert (backend == "crimson") == bool(
            batchers and all(hasattr(b, "_inner") for b in batchers))
        io = c.rados().open_ioctx("awp")
        blob = os.urandom(48 << 10)
        # wave 1 opens the windows; wave 2 lands mid-window -> grow
        w1 = [io.aio_write_full(f"a{i}", blob) for i in range(8)]
        time.sleep(0.07)
        w2 = [io.aio_write_full(f"b{i}", blob) for i in range(8)]
        for comp in w1 + w2:
            assert comp.wait(30) == 0
        assert sum(b.calls for b in batchers) >= 1, \
            "no device-routed encode group in a cluster workload"
        assert sum(b.cpu_reqs for b in batchers) == 0
        if backend == "crimson":
            assert tick_cuts, "no reactor tick cut the admission window"
        else:
            assert sum(b.window_grows for b in batchers) >= 1, \
                "overlapping write waves never grew a window"
        # sequential solo writes drain each primary's queue -> cut
        for i in range(6):
            assert io.aio_write_full(f"s{i}", blob).wait(30) == 0
        if backend == "classic":
            assert sum(b.window_cuts for b in batchers) >= 1, \
                "drained queues never cut a grown window"
            assert sum(b.queue_depth_hwm for b in batchers) >= 2
        for i in range(8):
            assert io.read(f"a{i}") == blob
            assert io.read(f"b{i}") == blob

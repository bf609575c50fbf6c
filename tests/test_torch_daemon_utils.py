"""Port twins of the JAX package's tests of the daemon utilities:
tests/test_timer_wheel.py, tests/test_critpath.py and
tests/test_scheduler.py, run on ceph_tpu_torch; then the log levels,
the machine factor, the tracer, the stack sampler, the admin socket and
the SLO and health helpers, each also held against the JAX package's
module on the same inputs where the output is deterministic.  The one
live-cluster case runs classic OSDs (osd_backend="classic"): the
crimson OSD is not ported."""
import io
import json
import os
import tempfile
import threading
import time

import pytest

from ceph_tpu_torch.osd.scheduler import OpScheduler
from ceph_tpu_torch.utils import critpath
from ceph_tpu_torch.utils.flight_recorder import FlightRecorder
from ceph_tpu_torch.utils.optracker import OpTracker
from ceph_tpu_torch.utils.perf import PerfCountersCollection
from ceph_tpu_torch.utils.timer_wheel import TimerWheel


# ------------------------------------------------------- timer wheel
def test_fires_once_and_in_order_of_deadline():
    w = TimerWheel(tick_s=0.002, slots=64)
    try:
        fired = []
        w.call_later(0.05, lambda: fired.append("late"))
        w.call_later(0.01, lambda: fired.append("early"))
        deadline = time.monotonic() + 5
        while len(fired) < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert fired == ["early", "late"]
        assert w.pending() == 0
    finally:
        w.stop()


def test_cancel_prevents_fire():
    w = TimerWheel(tick_s=0.002, slots=64)
    try:
        fired = []
        h = w.call_later(0.03, lambda: fired.append(1))
        assert not h.cancelled
        h.cancel()
        assert h.cancelled
        time.sleep(0.1)
        assert fired == []
        # cancel is idempotent
        h.cancel()
    finally:
        w.stop()


def test_multi_revolution_delay():
    """A delay longer than one full ring revolution rides the rounds
    counter: it must fire neither early (first pass over its slot)
    nor never."""
    w = TimerWheel(tick_s=0.002, slots=8)   # ring spans 16 ms
    try:
        fired = threading.Event()
        t0 = time.monotonic()
        w.call_later(0.06, fired.set)       # ~4 revolutions
        assert fired.wait(5)
        assert time.monotonic() - t0 >= 0.05
    finally:
        w.stop()


def test_exact_revolution_delay_not_one_revolution_late():
    """A delay that is an exact multiple of one wheel revolution
    lands on the cursor's current slot (offset 0); it must fire on
    the FIRST full pass, not carry a surplus round and fire a whole
    revolution late (regression: 20 ms on a 20 ms-revolution wheel
    fired at 40 ms)."""
    w = TimerWheel(tick_s=0.02, slots=5)    # revolution = 100 ms
    try:
        fired = threading.Event()
        t0 = time.monotonic()
        w.call_later(0.1, fired.set)        # exactly one revolution
        assert fired.wait(5)
        dt = time.monotonic() - t0
        assert dt >= 0.08                   # not early
        assert dt < 0.16, f"fired a revolution late ({dt*1e3:.0f} ms)"
    finally:
        w.stop()


def test_thousand_timers_one_thread():
    """Arm/cancel/fire under 1k concurrent deadlines: thread count
    stays flat (the wheel is ONE thread), every un-cancelled timer
    fires exactly once, every cancelled one never does."""
    w = TimerWheel(tick_s=0.002, slots=64)
    try:
        # force the wheel thread into existence before baselining
        warm = threading.Event()
        w.call_later(0.004, warm.set)
        assert warm.wait(5)
        base = threading.active_count()

        lock = threading.Lock()
        fired = [0]

        def bump():
            with lock:
                fired[0] += 1

        # 500 short deadlines that fire, 500 long ones we cancel
        # (long so cancellation cannot race the fire)
        firing = [w.call_later(0.01 + (i % 17) * 0.003, bump)
                  for i in range(500)]
        doomed = [w.call_later(30.0, bump) for _ in range(500)]
        # arming 1000 deadlines must not have spawned threads
        assert threading.active_count() <= base
        for h in doomed:
            h.cancel()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            with lock:
                if fired[0] >= 500:
                    break
            time.sleep(0.01)
        time.sleep(0.05)             # catch any late double-fire
        with lock:
            assert fired[0] == 500
        assert threading.active_count() <= base
        assert w.pending() == 0
        assert all(h.cancelled for h in doomed)
        assert firing
    finally:
        w.stop()


def test_stop_joins_and_clears():
    w = TimerWheel(tick_s=0.002, slots=16)
    w.call_later(30.0, lambda: None)
    w.stop()
    assert w.pending() == 0
    for t in threading.enumerate():
        assert t.name != "timer-wheel" or not t.is_alive()



# ---------------------------------------------- critical path
def _timeline(*steps, t0=100.0):
    """[(dt, event), ...] -> OpTracker-shaped event tuples."""
    out, t = [(t0, "initiated")], t0
    for dt, ev in steps:
        t += dt
        out.append((t, ev))
    return out


def test_analyze_charges_interval_to_ending_event():
    ev = _timeline((0.001, "queued_for_pg"),
                   (0.002, "reached_pg"),
                   (0.001, "started_write"),
                   (0.001, "ec:encode_queued"),
                   (0.003, "ec:batch_dispatched"),
                   (0.010, "ec:encoded"),
                   (0.001, "ec:sub_write_sent"),
                   (0.006, "ec:all_shards_committed"),
                   (0.001, "op_commit"),
                   (0.001, "done"))
    res = critpath.analyze(ev)
    # stage seconds sum exactly to the op duration
    assert abs(sum(res["stages"].values()) - res["total"]) < 1e-12
    assert abs(res["total"] - 0.027) < 1e-9
    # each interval charged to the stage named by its ENDING event
    assert abs(res["stages"]["encode"] - 0.010) < 1e-9
    assert abs(res["stages"]["commit_wait"] - 0.006) < 1e-9
    assert abs(res["stages"]["pg_queue_wait"] - 0.002) < 1e-9
    assert res["bounding_stage"] == "encode"


def test_analyze_repeated_and_unknown_events():
    # segmented fanout repeats ec:sub_write_sent; waiting* events
    # charge to "blocked"; unknown events to "other" — the breakdown
    # still sums to the duration
    ev = _timeline((0.002, "ec:sub_write_sent"),
                   (0.003, "ec:sub_write_sent"),
                   (0.004, "waiting_for_scrub"),
                   (0.005, "mystery_event"),
                   (0.001, "done"))
    res = critpath.analyze(ev)
    assert abs(res["stages"]["fanout_send"] - 0.005) < 1e-9
    assert abs(res["stages"]["blocked"] - 0.004) < 1e-9
    assert abs(res["stages"]["other"] - 0.005) < 1e-9
    assert abs(sum(res["stages"].values()) - res["total"]) < 1e-12
    # dict-shaped events (dump format) parse identically
    dicts = [{"time": t, "event": e} for t, e in ev]
    assert critpath.analyze(dicts) == res


def test_accum_via_op_tracker_retire_and_perf_export():
    coll = PerfCountersCollection()
    accum = critpath.CriticalPathAccum(perf_coll=coll)
    trk = OpTracker(history_size=8)
    trk.on_retire = accum.observe
    op = trk.create("osd_op(write b1)")
    op.mark_event("queued_for_pg")
    op.mark_event("reached_pg")
    op.mark_event("ec:encoded")
    op.finish()
    d = accum.dump()
    assert d["ops"] == 1
    assert d["slowest_op"]["description"] == "osd_op(write b1)"
    assert d["bounding_ops"]
    # dump() rounds each stage to 6 decimals independently: allow
    # up to 0.5us of rounding drift per stage vs the rounded total
    assert abs(sum(d["stage_seconds"].values())
               - d["op_seconds_total"]) < 0.5e-6 * (
                   len(d["stage_seconds"]) + 1)
    pd = coll.perf_dump()["critpath"]
    assert pd["ops"] == 1
    assert pd["stage_encode"]["avgcount"] == 1
    bound = d["slowest_op"]["bounding_stage"]
    assert pd[f"bound_{bound}"] == 1
    # an op with fewer than 2 events is skipped, not crashed on
    accum.observe({"events": [{"time": 1.0, "event": "initiated"}]})
    assert accum.dump()["ops"] == 1


def test_merge_dumps_sums_budgets_and_keeps_slowest():
    a = {"ops": 2, "op_seconds_total": 0.5,
         "stage_seconds": {"encode": 0.3, "commit_wait": 0.2},
         "bounding_ops": {"encode": 2},
         "slowest_op": {"total": 0.3, "stages": {"encode": 0.3},
                        "bounding_stage": "encode",
                        "description": "a"}}
    b = {"ops": 1, "op_seconds_total": 0.9,
         "stage_seconds": {"encode": 0.1, "msg_recv": 0.8},
         "bounding_ops": {"msg_recv": 1},
         "slowest_op": {"total": 0.9, "stages": {"msg_recv": 0.9},
                        "bounding_stage": "msg_recv",
                        "description": "b"}}
    m = critpath.merge_dumps([a, b, None, {}])
    assert m["ops"] == 3
    assert abs(m["op_seconds_total"] - 1.4) < 1e-9
    assert abs(m["stage_seconds"]["encode"] - 0.4) < 1e-9
    assert m["bounding_ops"] == {"encode": 2, "msg_recv": 1}
    assert m["slowest_op"]["description"] == "b"
    # canonical stage order preserved in the merged budget
    keys = list(m["stage_seconds"])
    order = [critpath.STAGE_ORDER.index(k) for k in keys]
    assert order == sorted(order)


def test_flight_recorder_ring_bounds_and_order():
    r = FlightRecorder(capacity=16, name="t")
    for i in range(40):
        r.note("route", i=i)
    evs = r.dump()
    assert len(evs) == 16                 # bounded
    assert [e["i"] for e in evs] == list(range(24, 40))  # newest kept
    assert [e["seq"] for e in evs] == sorted(e["seq"] for e in evs)
    st = r.dump_state()
    assert st["recorded"] == 40 and st["capacity"] == 16
    # reserved keys cannot be shadowed by event fields
    r.note("breaker", kind="bogus", seq=-1)
    last = r.dump()[-1]
    assert last["kind"] == "breaker" and last["seq"] > 0


def test_flight_recorder_auto_dump_rate_limited():
    r = FlightRecorder(capacity=8, name="osd.9",
                       auto_dump_interval_s=60.0)
    r.note("subwrite_timeout", tid=7)
    buf = io.StringIO()
    assert r.auto_dump("subwrite-timeout", out=buf) is True
    text = buf.getvalue()
    assert "auto-dump [osd.9] reason=subwrite-timeout" in text
    assert '"tid": 7' in text
    # second trigger inside the interval is suppressed (the event
    # itself stays in the ring)
    assert r.auto_dump("subwrite-timeout", out=buf) is False
    st = r.dump_state()
    assert st["auto_dumps"] == 1 and st["auto_dump_suppressed"] == 1


def test_timer_wheel_reports_fire_lag():
    lags = []
    tw = TimerWheel(tick_s=0.005, slots=64)
    tw.on_fire_lag = lags.append
    try:
        import threading
        done = threading.Event()
        tw.call_later(0.02, done.set)
        assert done.wait(5)
        deadline = time.monotonic() + 5
        while not lags and time.monotonic() < deadline:
            time.sleep(0.01)
        assert lags, "fire-lag callback never ran"
        # lag is non-negative and bounded by a few ticks on an idle
        # wheel (generous bound: one full second absorbs CI noise)
        assert 0.0 <= lags[0] < 1.0
        assert tw.fire_lag_max >= lags[0]
        assert tw.fire_lag_total >= lags[0]
        # a broken lag observer must not break timer dispatch
        tw.on_fire_lag = lambda lag: 1 / 0
        done2 = threading.Event()
        tw.call_later(0.01, done2.set)
        assert done2.wait(5)
    finally:
        tw.stop()



# ----------------------------------------------- op scheduler
def drain(sched, n):
    out = []
    for _ in range(n):
        got = sched.dequeue(timeout=1.0)
        if got is None:
            break
        out.append(got[0])
    return out


def test_client_beats_background_flood():
    s = OpScheduler()
    for i in range(500):
        s.enqueue("recovery", i)
    for i in range(10):
        s.enqueue("client", i)
    served = drain(s, 60)
    first_client = [i for i, c in enumerate(served) if c == "client"]
    assert len(first_client) == 10, "every client op must be served"
    assert first_client[-1] < 40, \
        f"client ops starved behind recovery: positions {first_client}"
    s.close()


def test_weighted_sharing_of_spare_capacity():
    s = OpScheduler({"recovery": (0, 10, 0), "scrub": (0, 5, 0)})
    for i in range(600):
        s.enqueue("recovery", i)
        s.enqueue("scrub", i)
    served = drain(s, 300)
    rec = served.count("recovery")
    scr = served.count("scrub")
    assert rec > scr, (rec, scr)
    # 10:5 weights -> ~2:1 split; allow slack for the deficit rounding
    assert 1.5 < rec / max(scr, 1) < 2.7, (rec, scr)
    s.close()


def test_hard_limit_caps_a_class():
    s = OpScheduler({"scrub": (0, 5, 10.0)}, hard_limits=True)
    for i in range(100):
        s.enqueue("scrub", i)
    t0 = time.monotonic()
    served = drain(s, 15)
    took = time.monotonic() - t0
    # 10 tokens/s (plus <=1s initial burst): 15 items need >= ~0.5s
    assert took > 0.3, f"limit not enforced ({took:.2f}s for 15)"
    s.close()


def test_reservation_phase_served_first():
    """dmClock phase 1: a class holding reservation tokens is served
    before ANY weighted work — even a class with a vastly larger
    weight."""
    s = OpScheduler({"fg": (50.0, 1.0, 0.0), "bg": (0.0, 1000.0, 0.0)})
    time.sleep(0.12)                 # fg accrues ~6 reservation tokens
    for i in range(20):
        s.enqueue("bg", i)
    for i in range(5):
        s.enqueue("fg", i)
    served = drain(s, 5)
    assert served == ["fg"] * 5, \
        f"reservation phase lost to weight: {served}"
    s.close()


def test_soft_limit_uses_idle_capacity():
    """hard_limits=False (the default profile): a class past its
    limit may still soak otherwise-idle capacity — the same 50 items
    that take seconds under hard limits drain instantly."""
    s = OpScheduler({"scrub": (0, 5, 10.0)}, hard_limits=False)
    for i in range(50):
        s.enqueue("scrub", i)
    t0 = time.monotonic()
    served = drain(s, 50)
    took = time.monotonic() - t0
    assert len(served) == 50
    assert took < 1.0, f"soft limit throttled an idle queue ({took:.2f}s)"
    s.close()


def test_dequeue_nowait_token_gated():
    """The crimson reactor drain: ``dequeue_nowait`` NEVER blocks —
    token-gated work returns None and stays queued for a later tick,
    then serves once the refill has accrued a whole token."""
    s = OpScheduler({"scrub": (0, 5, 2.0)}, hard_limits=True)
    for i in range(10):
        s.enqueue("scrub", i)
    assert s.dequeue_nowait() is None      # no tokens accrued yet
    assert s.queued() == 10                # ...and nothing was lost
    time.sleep(0.6)                        # 2 tokens/s -> ~1.2 tokens
    assert s.dequeue_nowait() == ("scrub", 0)
    assert s.dequeue_nowait() is None      # bucket drained again
    assert s.queued() == 9
    st = s.stats()["scrub"]
    assert st["served"] == 1 and st["queued"] == 9
    assert st["depth_hwm"] == 10
    s.close()


def test_unknown_class_still_served():
    s = OpScheduler()
    s.enqueue("exotic", "x")
    got = s.dequeue(timeout=2.0)
    assert got == ("exotic", "x")
    s.close()


def test_close_wakes_dequeue():
    s = OpScheduler()
    import threading
    out = []
    t = threading.Thread(target=lambda: out.append(s.dequeue()))
    t.start()
    time.sleep(0.1)
    s.close()
    t.join(5)
    assert out == [None]


def test_client_latency_under_recovery_load():
    """Live cluster: while a large recovery churns, client reads must
    keep completing promptly — the starvation the scheduler exists to
    prevent."""
    from ceph_tpu_torch.cluster import Cluster, test_config

    with Cluster(n_osds=3, conf=test_config(osd_backend="classic")) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        c.create_pool("qos", "replicated", size=3)
        client = c.rados(timeout=30)
        client.op_timeout = 60.0
        io = client.open_ioctx("qos")
        blob = os.urandom(64 << 10)
        for i in range(40):
            io.write_full(f"q{i}", blob)
        c.wait_for_clean(30)
        c.kill_osd(2, lose_data=True)
        c.wait_for_osd_down(2)
        c.revive_osd(2)
        c.wait_for_osd_up(2)
        # recovery of 40 objects is now churning; client reads must
        # not queue behind it
        lat = []
        for i in range(15):
            t0 = time.monotonic()
            assert io.read(f"q{i}") == blob
            lat.append(time.monotonic() - t0)
        lat.sort()
        assert lat[-1] < 10.0, f"client read starved: {lat[-3:]}"
        c.wait_for_clean(60)     # and recovery still finishes


def test_set_qos_live_retune_preserves_queue():
    """The mgr tuner module's actuation seam — ``set_qos``
    on a RUNNING queue changes the weighted split without dropping a
    single queued item, and the clamped burst credit means a demoted
    class cannot coast on stale tokens."""
    s = OpScheduler({"recovery": (0, 10, 0), "scrub": (0, 5, 0)})
    for i in range(600):
        s.enqueue("recovery", i)
        s.enqueue("scrub", i)
    first = drain(s, 150)
    # 10:5 -> recovery dominates the first window
    assert first.count("recovery") > first.count("scrub")
    # live demote recovery 10 -> 1 (the module's halving walk, twice
    # over) while 800+ items are still queued
    assert s.set_qos({"recovery": (0.0, 1.0, 0.0)}) is True
    assert s.set_qos({"recovery": (0.0, 1.0, 0.0)}) is False  # no-op
    second = drain(s, 300)
    # 1:5 -> scrub now dominates; deficit rounding gets slack
    ratio = second.count("scrub") / max(second.count("recovery"), 1)
    assert ratio > 2.0, (second.count("scrub"),
                         second.count("recovery"))
    # nothing was lost across the retune
    rest = drain(s, 2000)
    assert len(first) + len(second) + len(rest) == 1200
    s.close()


@pytest.mark.parametrize("backend", ["classic"])
def test_qos_demotes_recovery_without_client_burn(backend):
    """Live contention on the classic backend (the crimson OSD is not
    ported): with the
    recovery SLO tightened to 1 ms, mClock's demotion of the recovery
    class under client traffic must be VISIBLE as recovery-class burn
    while the client classes burn nothing — and both classes must
    demonstrably have ridden the per-shard op scheduler."""
    from ceph_tpu_torch.cluster import Cluster, test_config
    from ceph_tpu_torch.mgr.slo import SLOEngine

    conf = test_config(osd_backend=backend, slo_recovery_p99_ms=1.0)
    with Cluster(n_osds=3, conf=conf) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 30)
        c.create_pool("qosd", "replicated", size=3)
        client = c.rados(timeout=30)
        client.op_timeout = 60.0
        io = client.open_ioctx("qosd")
        blob = os.urandom(32 << 10)
        for i in range(24):
            io.write_full(f"d{i}", blob)
        c.wait_for_clean(30)
        c.kill_osd(2, lose_data=True)
        c.wait_for_osd_down(2)
        c.revive_osd(2)
        c.wait_for_osd_up(2)
        # client reads compete with the 24-object recovery churn
        for i in range(12):
            assert io.read(f"d{i}") == blob
        c.wait_for_clean(60)
        # evidence from exported counters alone: both classes rode
        # the scheduler...
        served: dict = {}
        for osd in c.osds.values():
            _, _, dump = osd._exec_command({"prefix": "dump_op_queue"})
            for cls, row in (dump.get("classes") or {}).items():
                served[cls] = served.get(cls, 0) \
                    + int(row.get("served", 0))
        assert served.get("client", 0) > 0, served
        assert served.get("recovery", 0) > 0, served
        # ...recovery ran demoted (late vs its 1 ms target -> burn),
        # clients rode their reservation and burned NOTHING
        slo = SLOEngine.merge_dumps(
            [o.slo.dump() for o in c.osds.values()
             if getattr(o, "slo", None) is not None])
        assert (slo.get("recovery") or {}).get("burn", 0.0) > 0.0, slo
        for cls in ("client_read", "client_write"):
            row = slo.get(cls) or {}
            assert row.get("burn", 0.0) == 0.0, (cls, row)
            assert row.get("errors", 0) == 0, (cls, row)



# --------------------------------------------------------------- log
def test_dout_levels_gate_and_prefix_children():
    import logging

    from ceph_tpu_torch.utils import log as portlog
    seen = []

    class Grab(logging.Handler):
        def emit(self, record):
            seen.append((record.name, record.levelname,
                         record.getMessage()))

    d = portlog.Dout("scrub", prefix="pg 1.0: ")
    h = Grab()
    d._logger.addHandler(h)
    before = portlog.get_subsys_level("scrub")
    try:
        portlog.set_subsys_level("scrub", 5)
        assert portlog.get_subsys_level("scrub") == 5
        assert d.should(5) and not d.should(6)
        d.dout(5, "kept %d", 1)
        d.dout(6, "dropped")
        d.child("obj a: ").derr("bad %s", "crc")
        assert seen == [
            ("ceph_tpu_torch.scrub", "DEBUG", "pg 1.0: kept 1"),
            ("ceph_tpu_torch.scrub", "ERROR",
             "pg 1.0: obj a: bad crc")]
    finally:
        d._logger.removeHandler(h)
        portlog.set_subsys_level("scrub", before)


def test_log_subsystems_equal_jax_package():
    from ceph_tpu.utils import log as reflog
    from ceph_tpu_torch.utils import log as portlog
    assert portlog.SUBSYSTEMS == reflog.SUBSYSTEMS
    for s in ("osd", "mon", "paxos", "scrub"):
        assert portlog.get_subsys_level(s) == reflog.get_subsys_level(s)


# ----------------------------------------------------------- machine
def test_machine_factor_override_clamps_and_scales(monkeypatch):
    from ceph_tpu_torch.utils import machine
    monkeypatch.setattr(machine, "_MFACTOR", None)
    monkeypatch.setenv("CEPH_TPU_MACHINE_FACTOR", "50")
    assert machine.machine_factor() == 20.0
    monkeypatch.setattr(machine, "_MFACTOR", None)
    monkeypatch.setenv("CEPH_TPU_MACHINE_FACTOR", "0.5")
    monkeypatch.setenv("CEPH_TPU_MACHINE_FACTOR_MIN", "2")
    assert machine.machine_factor() == 2.0
    assert machine.scaled(3.0) == 6.0


def test_machine_factor_probe_runs_the_ports_jerasure(monkeypatch):
    from ceph_tpu_torch.utils import machine
    monkeypatch.setattr(machine, "_MFACTOR", None)
    monkeypatch.delenv("CEPH_TPU_MACHINE_FACTOR", raising=False)
    monkeypatch.delenv("CEPH_TPU_MACHINE_FACTOR_MIN", raising=False)
    f = machine.machine_factor()
    assert 1.0 <= f <= 20.0
    assert machine.machine_factor() == f          # probed once
    assert machine.scaled(2.0) == 2.0 * f


# ------------------------------------------------------------ tracer
def test_tracer_spans_and_sampling():
    from ceph_tpu_torch.utils.tracer import Tracer
    t = Tracer("svc", enabled=True, sample_every=2)
    spans = [t.maybe_start("op") for _ in range(8)]
    started = [s for s in spans if s is not None]
    assert len(started) == 4             # every 2nd sampled
    for s in started:
        s.tag("k", "v").finish()
    dump = t.dump()
    assert len(dump) == 4
    assert dump[0]["tags"] == {"k": "v"}
    assert dump[0]["service"] == "svc"
    # child continuation inherits the trace id
    child = t.start("sub", started[0].trace_id,
                    started[0].span_id)
    child.finish()
    same = t.dump(trace_id=started[0].trace_id)
    assert {d["name"] for d in same} == {"op", "sub"}
    # disabled tracer costs one branch — including for propagated
    # contexts (an operator who turned tracing off records nothing)
    off = Tracer("svc2", enabled=False)
    assert off.maybe_start("x") is None
    assert off.start("x", 0) is None
    assert off.start("x", 12345) is None


def test_trace_trees_equal_jax_package():
    """build_trees and slowest_child give the JAX package's answer on
    the same span dicts."""
    from ceph_tpu.utils import tracer as reftr
    from ceph_tpu_torch.utils import tracer as porttr
    spans = [
        {"name": "op", "trace_id": 7, "span_id": 1, "parent_id": 0,
         "service": "client", "start": 0.0, "duration_us": 900, "tags": {}},
        {"name": "sub", "trace_id": 7, "span_id": 2, "parent_id": 1,
         "service": "osd.0", "start": 0.1, "duration_us": 300, "tags": {}},
        {"name": "sub", "trace_id": 7, "span_id": 3, "parent_id": 1,
         "service": "osd.1", "start": 0.1, "duration_us": 600, "tags": {}},
        {"name": "apply", "trace_id": 7, "span_id": 4, "parent_id": 3,
         "service": "osd.1", "start": 0.2, "duration_us": 200, "tags": {}},
    ]
    rt = reftr.build_trees([dict(s) for s in spans])
    pt = porttr.build_trees([dict(s) for s in spans])
    assert json.dumps(pt, sort_keys=True, default=str) == \
        json.dumps(rt, sort_keys=True, default=str)
    root = pt[7]["roots"][0]
    assert [c["span_id"] for c in root["children"]] == [2, 3]
    assert porttr.slowest_child(root, "sub")["span_id"] == 3
    assert porttr.slowest_child(root, "sub") == \
        reftr.slowest_child(rt[7]["roots"][0], "sub")


# ----------------------------------------------------------- sampler
def test_sampler_folds_named_threads_and_top_self_time():
    from ceph_tpu_torch.utils.sampler import StackSampler
    s = StackSampler(hz=50.0)
    stop = threading.Event()

    def park_here():
        stop.wait()

    parked = threading.Thread(target=park_here, name="osd9-parked",
                              daemon=True)
    parked.start()
    try:
        for _ in range(3):
            s.sample_once()
    finally:
        stop.set()
        parked.join()
    assert s.samples == 3
    lines = s.dump_folded(prefix="osd9-")
    assert lines
    stack, _, count = lines[0].rpartition(" ")
    assert stack.startswith("osd9-parked;") and int(count) == 3
    assert "park_here" in stack
    assert s.top_self_time(prefix="osd9-")[0][1] == 3
    s.reset()
    assert s.samples == 0 and s.dump_folded() == []


def test_sampler_refcount_lifecycle():
    from ceph_tpu_torch.utils.sampler import (SAMPLER_THREAD_NAME,
                                              StackSampler)

    def live():
        return [t for t in threading.enumerate()
                if t.name == SAMPLER_THREAD_NAME and t.is_alive()]

    base = len(live())
    s = StackSampler(hz=200.0)
    s.retain()
    s.retain()
    assert s.running and len(live()) == base + 1
    s.release()
    assert s.running                      # one holder left
    deadline = time.monotonic() + 5
    while s.samples == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert s.samples > 0
    s.release()
    assert not s.running and len(live()) == base


def test_sampler_disabled_by_config():
    from ceph_tpu_torch.cluster import Cluster, test_config
    from ceph_tpu_torch.utils.sampler import SAMPLER_THREAD_NAME
    with Cluster(n_osds=2, conf=test_config(osd_backend="classic",
                                            osd_sampler_hz=0.0)) as c:
        for i in range(2):
            c.wait_for_osd_up(i, 20)
        assert not [t for t in threading.enumerate()
                    if t.name == SAMPLER_THREAD_NAME]


# ------------------------------------------------------ admin socket
def test_admin_socket_round_trip():
    from ceph_tpu_torch.utils.admin_socket import AdminSocket, admin_command
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "asok")
        sock = AdminSocket(path)
        coll = PerfCountersCollection()
        pc = coll.create("osd")
        pc.add("ops")
        pc.inc("ops", 42)
        sock.register("perf dump", lambda cmd: coll.perf_dump())
        sock.register("echo", lambda cmd: cmd.get("payload"))
        sock.start()
        try:
            out = admin_command(path, "perf dump")
            assert out["osd"]["ops"] == 42
            assert admin_command(path, "echo", payload=[1, 2]) == [1, 2]
            with pytest.raises(RuntimeError, match="unknown command"):
                admin_command(path, "nope")
            assert "perf dump" in admin_command(path, "help")
        finally:
            sock.stop()


def test_admin_socket_survives_garbage_client():
    import socket

    from ceph_tpu_torch.utils.admin_socket import AdminSocket, admin_command
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "asok")
        sock = AdminSocket(path)
        sock.register("ping", lambda cmd: "pong")
        sock.start()
        try:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.connect(path)
            s.sendall(b"\xff\x00not json")
            s.close()
            assert admin_command(path, "ping") == "pong"
        finally:
            sock.stop()


# ------------------------------------------------------ slo + health
def _slo_feed(engine):
    for i in range(40):
        engine.observe("client_write", 0.001 * (i % 7))
        engine.observe("client_read", 0.002, ok=(i % 13 != 0))
        engine.observe("recovery", 0.05 if i % 5 else 3.0)
    engine.note_error("scrub")
    return engine.dump()


def test_slo_dump_equal_jax_package():
    from ceph_tpu.mgr.slo import SLOEngine as RefSLO
    from ceph_tpu_torch.mgr.slo import SLOEngine
    targets = {"recovery": 1000.0, "client_write": 5.0}
    port = _slo_feed(SLOEngine(perf_coll=PerfCountersCollection(),
                               targets_ms=targets, budget=0.01))
    ref = _slo_feed(RefSLO(targets_ms=targets, budget=0.01))
    assert port == ref
    assert port["recovery"]["burn"] > 0
    assert SLOEngine.merge_dumps([port, port]) == \
        RefSLO.merge_dumps([ref, ref])


@pytest.mark.parametrize("signals", [
    {},
    {"breaker_open": True, "slow_ops": 3, "down_osds": [2],
     "degraded_pgs": 4, "total_pgs": 32},
    {"slo": {"recovery": {"burn": 12.0}, "client_read": {"burn": 0.5}},
     "op_queue": {"client_growth_ticks": 4, "client_queued": 9},
     "store": {"stalls": 2}, "blocked_ops": 1},
])
def test_health_checks_equal_jax_package(signals):
    from ceph_tpu.mgr import health as refh
    from ceph_tpu_torch.mgr import health as porth
    p = porth.checks_from_signals(**signals)
    r = refh.checks_from_signals(**signals)
    assert p == r
    assert porth.summarize(p) == refh.summarize(r)
    assert porth.merge([{"checks": p}, None]) == \
        refh.merge([{"checks": r}, None])

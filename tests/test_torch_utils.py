"""Port twins of the JAX package's tests of the utilities the OSD
batcher stands on: the fault registry (tests/test_faults.py, registry
part), the device-phase ledger units (tests/test_device_waterfall.py),
the autotuner (tests/test_tuner.py) and the lock-order checker
(tests/test_lockdep.py), against ceph_tpu_torch.utils.  Codecs are the
`gpu` plugin on the CPU.  The store is not ported yet, so the
store.apply gate is driven through a stand-in with the store
Transaction's op layout."""
import os
import threading
import time
import types

import pytest

from ceph_tpu_torch.utils import faults as faultlib
from ceph_tpu_torch.utils import lockdep
from ceph_tpu_torch.utils.config import Config
from ceph_tpu_torch.utils.device_ledger import (PHASE_ORDER,
                                                DeviceLedgerAccum,
                                                charge_phases,
                                                device_waterfall_block,
                                                merge_dumps, overlap_stats)
from ceph_tpu_torch.utils.faults import (DEVICE_COMPLETION,
                                         DEVICE_DISPATCH, MSG_SEND,
                                         STORE_APPLY, InjectedError)
from ceph_tpu_torch.utils.tuner import (VERDICT_KEPT, VERDICT_NEUTRAL,
                                        VERDICT_PROBE,
                                        VERDICT_ROLLED_BACK, KnobSpec,
                                        Tuner, knobs_from_config)


# ------------------------------------------------------------ faults
@pytest.fixture
def clean_registry():
    """The registry is process-wide state: every fault test starts and
    ends disarmed with zeroed counters."""
    faultlib.registry().reset()
    yield
    faultlib.registry().reset()


def reg():
    return faultlib.registry()


def GHObject(oid, shard=-1):
    """Store-level object identity, as the gate's match predicates see
    it."""
    return types.SimpleNamespace(oid=oid, shard=shard)


class Transaction:
    """The store Transaction's op layout, ("write", coll, obj, offset,
    data), which the store.apply gate reads and corrupts in place."""

    def __init__(self):
        self.ops = []

    def write(self, coll, obj, offset, data):
        self.ops.append(("write", coll, obj, offset, data))
        return self


@pytest.mark.usefixtures("clean_registry")
def test_every_n_fires_periodically_and_counts():
    reg().arm(DEVICE_DISPATCH, mode="error", every=3)
    trips = 0
    for _ in range(9):
        try:
            reg().hit(DEVICE_DISPATCH)
        except InjectedError as e:
            assert e.site == DEVICE_DISPATCH
            trips += 1
    assert trips == 3
    c = reg().counters()[DEVICE_DISPATCH]
    assert c == {"hits": 9, "trips": 3, "armed": 1}
    assert reg().trips(DEVICE_DISPATCH) == 3


@pytest.mark.usefixtures("clean_registry")
def test_one_in_is_deterministic_for_a_seed():
    def pattern(seed):
        reg().reset()
        reg().arm(MSG_SEND, mode="error", one_in=4, seed=seed)
        return [reg().check_drop(MSG_SEND) for _ in range(200)]

    a, b = pattern(7), pattern(7)
    assert a == b, "same seed must replay the same trip pattern"
    assert any(a), "1-in-4 over 200 checks must trip"
    assert pattern(8) != a, "different seed, different pattern"


@pytest.mark.usefixtures("clean_registry")
def test_sites_draw_independent_rngs():
    """One site's trip schedule must not depend on how often the
    other sites were checked (per-site RNG keyed by (seed, name))."""
    reg().seed_all(3)
    reg().arm(MSG_SEND, mode="error", one_in=5)
    lone = [reg().check_drop(MSG_SEND) for _ in range(100)]
    reg().reset()
    reg().seed_all(3)
    reg().arm(MSG_SEND, mode="error", one_in=5)
    reg().arm(STORE_APPLY, mode="error", one_in=5)
    mixed = []
    for _ in range(100):
        reg().check_drop(STORE_APPLY)    # interleaved traffic
        mixed.append(reg().check_drop(MSG_SEND))
    assert mixed == lone


@pytest.mark.usefixtures("clean_registry")
def test_one_shot_fires_once_then_disarms():
    reg().arm(STORE_APPLY, mode="error", one_shot=True)
    assert STORE_APPLY in reg().armed_sites()
    with pytest.raises(InjectedError):
        reg().hit(STORE_APPLY)
    reg().hit(STORE_APPLY)               # disarmed: no-op
    assert STORE_APPLY not in reg().armed_sites()
    assert reg().trips(STORE_APPLY) == 1


@pytest.mark.usefixtures("clean_registry")
def test_stall_mode_sleeps_in_place():
    reg().arm(DEVICE_COMPLETION, mode="stall", every=1, stall_s=0.15)
    t0 = time.monotonic()
    reg().hit(DEVICE_COMPLETION)         # must not raise
    assert time.monotonic() - t0 >= 0.14
    # check_drop treats a stall as 'slow, not dead'
    assert reg().check_drop(DEVICE_COMPLETION) is False


@pytest.mark.usefixtures("clean_registry")
def test_corrupt_bytes_flips_one_bit():
    reg().arm(MSG_SEND, mode="corrupt", every=1)
    data = bytes(range(64))
    out = reg().corrupt_bytes(MSG_SEND, data)
    assert out != data
    diff = [i for i in range(64) if out[i] != data[i]]
    assert len(diff) == 1
    assert out[diff[0]] ^ data[diff[0]] == 0x40
    assert data == bytes(range(64)), "input must not be mutated"


@pytest.mark.usefixtures("clean_registry")
def test_store_apply_corrupt_respects_match_predicate():
    hit_obj = GHObject("victim", 0)
    miss_obj = GHObject("bystander", 0)

    def only_victim(txns):
        return any(op[0] == "write" and op[2].oid == "victim"
                   for t in txns for op in t.ops)

    reg().arm(STORE_APPLY, mode="corrupt", every=1, max_trips=1,
              match=only_victim)
    miss = Transaction().write("1.0s0", miss_obj, 0, b"a" * 32)
    reg().store_apply([miss])
    assert bytes(miss.ops[0][4]) == b"a" * 32, "non-match untouched"
    hit = Transaction().write("1.0s0", hit_obj, 0, b"a" * 32)
    reg().store_apply([hit])
    flipped = bytes(hit.ops[0][4])
    assert flipped != b"a" * 32
    assert sum(x != ord("a") for x in flipped) == 1
    # max_trips=1: the next matching apply sails through
    again = Transaction().write("1.0s0", hit_obj, 0, b"b" * 32)
    reg().store_apply([again])
    assert bytes(again.ops[0][4]) == b"b" * 32


@pytest.mark.usefixtures("clean_registry")
def test_check_send_absorbs_legacy_conf_into_site_counters():
    # nothing armed: the legacy conf alone drives (and counts) trips
    assert reg().check_send(MSG_SEND, conf_one_in=1) is True
    c = reg().counters()[MSG_SEND]
    assert c["trips"] == 1 and c["armed"] == 0
    # conf off and nothing armed: never trips
    assert reg().check_send(MSG_SEND, conf_one_in=0) is False


@pytest.mark.usefixtures("clean_registry")
def test_configure_grammar_idempotence_and_errors():
    reg().configure("device.dispatch:error:every2,"
                    "store.apply:stall:1in10:250", seed=5)
    assert set(reg().armed_sites()) == {DEVICE_DISPATCH, STORE_APPLY}
    site = reg().site(STORE_APPLY)
    assert site.mode == "stall" and site.stall_s == 0.25
    with pytest.raises(InjectedError):
        for _ in range(2):
            reg().hit(DEVICE_DISPATCH)
    hits_before = reg().counters()[DEVICE_DISPATCH]["hits"]
    # identical (spec, seed): a daemon restart must NOT reset RNGs
    # or counters mid-run
    reg().configure("device.dispatch:error:every2,"
                    "store.apply:stall:1in10:250", seed=5)
    assert reg().counters()[DEVICE_DISPATCH]["hits"] == hits_before
    for bad in ("device.dispatch:error", "store.apply:error:sometimes"):
        with pytest.raises(ValueError):
            reg().configure(bad, seed=0)


@pytest.mark.usefixtures("clean_registry")
def test_configure_from_cluster_conf():
    conf = Config({"fault_injection": "msg.recv:error:1in9",
                   "fault_injection_seed": 11})
    faultlib.configure_from(conf)
    assert reg().armed_sites() == ["msg.recv"]
    faultlib.configure_from({})          # no options: ignored
    assert reg().armed_sites() == ["msg.recv"]


# ------------------------------------------------ device ledger
def _led(t0, device=0, **over):
    led = {"stage_acquire": t0, "h2d_start": t0 + 0.001,
           "h2d_done": t0 + 0.003, "compute_start": t0 + 0.004,
           "compute_done": t0 + 0.010, "d2h_done": t0 + 0.012,
           "deliver": t0 + 0.013, "device": device,
           "bytes": 1 << 20, "group": "encode"}
    led.update(over)
    return led


def test_charge_phases_sum_equals_group_wall():
    led = _led(1000.0)
    charged = charge_phases(led)
    # every interval charged to the phase ending it; meta fields
    # (device, bytes, group) never appear as phases
    assert [n for n, _ in charged] == list(PHASE_ORDER[1:])
    assert sum(dt for _, dt in charged) == \
        led["deliver"] - led["stage_acquire"]


def test_charge_phases_partial_ledger_stays_exact():
    # the coarse decode ledger: whole interval charges to the fence
    led = {"stage_acquire": 5.0, "compute_start": 5.0,
           "compute_done": 5.02, "deliver": 5.02, "group": "decode"}
    charged = charge_phases(led)
    wall = led["deliver"] - led["stage_acquire"]
    assert sum(dt for _, dt in charged) == wall
    assert dict(charged)["compute_done"] == wall
    assert charge_phases({"compute_done": 1.0}) == []
    assert charge_phases({}) == []


def test_overlap_stats_exact_fraction():
    # group B's h2d (10.004..10.008) under group A's compute
    # (10.002..10.010): overlap 4 ms of a 20 ms window -> 0.2
    a = _led(10.0, h2d_start=10.0, h2d_done=10.002,
             compute_start=10.002, compute_done=10.010,
             d2h_done=10.011, deliver=10.012)
    b = _led(10.004, h2d_start=10.004, h2d_done=10.008,
             compute_start=10.010, compute_done=10.018,
             d2h_done=10.019, deliver=10.020)
    ov = overlap_stats([a, b])
    assert ov["pairs"] == 1 and ov["groups"] == 2
    assert ov["devices"] == [0]
    assert abs(ov["overlap_s"] - 0.004) < 1e-9
    assert abs(ov["window_wall_s"] - 0.020) < 1e-9
    assert abs(ov["pipeline_overlap_frac"] - 0.2) < 1e-3


def test_overlap_stats_bubble_census_names_bounding_phase():
    # B's compute starts 6 ms after A's ends; most of the gap is
    # covered by B's h2d interval -> h2d_done bounds the pipeline
    a = _led(20.0, compute_start=20.002, compute_done=20.004,
             d2h_done=20.005, deliver=20.006)
    b = _led(20.004, h2d_start=20.004, h2d_done=20.009,
             compute_start=20.010, compute_done=20.012,
             d2h_done=20.013, deliver=20.014)
    ov = overlap_stats([a, b])
    assert ov["bounding_phase"] == "h2d_done"
    assert abs(sum(ov["bubble_s"].values()) - 0.006) < 1e-6
    # devices never pairing (different ids) produce no bubbles
    assert overlap_stats([_led(1.0, device=0),
                          _led(1.0, device=1)])["pairs"] == 0
    assert overlap_stats([]) == overlap_stats([{}])


def test_twin_groups_fold_in_but_stay_out_of_overlap():
    # a CPU-twin group (device=-1, no h2d/d2h stamps) folds into the
    # phase accounting but the overlap engine skips it: it has no
    # transfer to hide under compute, and its wall must not dilute
    # the per-device window
    a = _led(10.0, h2d_start=10.0, h2d_done=10.002,
             compute_start=10.002, compute_done=10.010,
             d2h_done=10.011, deliver=10.012)
    b = _led(10.004, h2d_start=10.004, h2d_done=10.008,
             compute_start=10.010, compute_done=10.018,
             d2h_done=10.019, deliver=10.020)
    twin = {"stage_acquire": 10.0, "compute_start": 10.0,
            "compute_done": 10.5, "deliver": 10.5,
            "device": -1, "bytes": 1 << 20, "group": "encode"}
    ov = overlap_stats([a, b, twin])
    assert ov["groups"] == 2 and ov["devices"] == [0]
    assert ov == overlap_stats([a, b])   # 0.5 s twin wall: no dilution
    accum = DeviceLedgerAccum()
    for led in (a, b, twin):
        accum.observe(led)
    dump = accum.dump()
    assert dump["groups"] == 3           # ...but it IS a counted group
    assert abs(sum(dump["phase_seconds"].values())
               - dump["group_seconds"]) < 1e-9


def test_accum_dump_and_waterfall_block():
    accum = DeviceLedgerAccum()
    for j in range(8):
        accum.observe(_led(100.0 + j * 0.02))
    accum.observe(None)                      # tolerated, not counted
    accum.observe({"bytes": 4096})           # stamp-free: not counted
    dump = accum.dump()
    assert dump["groups"] == 8
    # accumulated phase seconds == accumulated group walls (the
    # invariant, summed)
    assert abs(sum(dump["phase_seconds"].values())
               - dump["group_seconds"]) < 1e-9
    assert abs(dump["group_seconds"] - 8 * 0.013) < 1e-6
    assert set(dump["p99_s"]) == set(PHASE_ORDER[1:])
    blk = device_waterfall_block(dump, wall_s=2.0)
    assert blk["sum_of_shares"] == pytest.approx(1.0, abs=1e-3)
    assert blk["vs_wall"] == pytest.approx(1.0, abs=1e-3)
    # compute dominates the synthetic ledger (6 ms of 13 ms)
    assert blk["top_phase"] == "compute_done"
    assert abs(sum(blk["scaled_s"].values()) - 2.0) < 1e-2


def test_merge_dumps_pools_devices_and_recomputes_frac():
    a, b = DeviceLedgerAccum(), DeviceLedgerAccum()
    for j in range(4):
        a.observe(_led(50.0 + j * 0.02, device=0))
        b.observe(_led(80.0 + j * 0.02, device=1))
    merged = merge_dumps([a.dump(), b.dump(), None, {}])
    assert merged["groups"] == 8
    assert merged["overlap"]["devices"] == [0, 1]
    assert 0.0 <= merged["overlap"]["pipeline_overlap_frac"] <= 1.0
    assert abs(sum(merged["phase_seconds"].values())
               - merged["group_seconds"]) < 1e-9


# ------------------------------------------------------------ tuner
def make_knob(name="k", lo=1, hi=64, init=2, is_int=True, **kw):
    """A KnobSpec over a plain cell, returned with the cell so tests
    can read/poke the 'live' value."""
    cell = {"v": init}
    spec = KnobSpec(name, lo, hi, is_int,
                    get=lambda: cell["v"],
                    set=lambda v: cell.__setitem__("v", v), **kw)
    return spec, cell


def drive(tuner, objective_of, n):
    """n controller ticks; objective is a pure function of the live
    knob values at tick time (the deterministic synthetic plant)."""
    records = []
    for _ in range(n):
        rec = tuner.step(objective_of())
        if rec is not None:
            records.append(rec)
    return records


def test_hill_climb_converges_to_optimum():
    """Throughput rises with the knob up to 8 then falls: the
    controller must climb 2 -> 8 and hold there (kept on the way up,
    rollbacks past the peak, neutral/quiet at the plateau)."""
    spec, cell = make_knob(init=2)
    t = Tuner("t", [spec], hysteresis=0.02, cooldown_ticks=0,
              blacklist_ticks=4)

    def objective():
        v = cell["v"]
        return 100.0 * min(v, 8) - 60.0 * max(0, v - 8)

    recs = drive(t, objective, 60)
    assert cell["v"] == 8, f"expected convergence to 8, at {cell['v']}"
    assert t.counts[VERDICT_KEPT] >= 3          # climbed, not jumped
    assert t.counts[VERDICT_ROLLED_BACK] >= 1   # found the cliff
    verdicts = {r["verdict"] for r in recs}
    assert VERDICT_PROBE in verdicts
    # bounds were never violated at any point of the walk
    assert all(spec.lo <= r["new"] <= spec.hi for r in recs)


def test_noisy_plateau_does_not_oscillate():
    """Objective noise inside the hysteresis deadband must read as
    neutral: no kept, no rollback/blacklist, knob restored after every
    probe -- i.e. the controller doesn't random-walk a flat system."""
    spec, cell = make_knob(init=8)
    t = Tuner("t", [spec], hysteresis=0.05, cooldown_ticks=0,
              blacklist_ticks=4)
    noise = [0.0, +0.02, -0.02, +0.01, -0.015, +0.005]
    i = [0]

    def objective():
        i[0] += 1
        return 1000.0 * (1.0 + noise[i[0] % len(noise)])

    drive(t, objective, 40)
    assert cell["v"] == 8, "plateau walk moved the knob"
    assert t.counts[VERDICT_KEPT] == 0
    assert t.counts[VERDICT_ROLLED_BACK] == 0
    assert t.counts[VERDICT_NEUTRAL] == t.counts[VERDICT_PROBE] > 0
    assert t.dump()["blacklist"] == []


def test_injected_regression_rolls_back_and_blacklists():
    """Any move off 8 tanks the objective: both directions must be
    probed at most once, rolled back (value restored), blacklisted,
    and the controller then holds still until the blacklist expires."""
    spec, cell = make_knob(init=8)
    t = Tuner("t", [spec], hysteresis=0.02, cooldown_ticks=0,
              blacklist_ticks=100)

    def objective():
        return 800.0 if cell["v"] == 8 else 100.0

    drive(t, objective, 30)
    assert cell["v"] == 8, "regressing probe was not rolled back"
    assert t.counts[VERDICT_ROLLED_BACK] == 2   # once per direction
    assert t.counts[VERDICT_KEPT] == 0
    d = t.dump()
    assert {(b["knob"], b["dir"]) for b in d["blacklist"]} == \
        {("k", +1), ("k", -1)}
    # fully blacklisted: no further probes happen
    assert t.counts[VERDICT_PROBE] == 2


def test_blacklist_expires_and_reprobes():
    spec, cell = make_knob(init=8)
    t = Tuner("t", [spec], hysteresis=0.02, cooldown_ticks=0,
              blacklist_ticks=3)

    def objective():
        return 800.0 if cell["v"] == 8 else 100.0

    drive(t, objective, 12)
    assert t.counts[VERDICT_PROBE] > 2, \
        "blacklist never expired -> knob never re-probed"
    assert cell["v"] == 8                        # still guarded


def test_guard_trip_forces_rollback():
    """A probe that improves the objective but trips a guard signal
    (SLO burn, overlap collapse) must still be reverted + counted."""
    spec, cell = make_knob(init=4)
    t = Tuner("t", [spec], hysteresis=0.02, cooldown_ticks=0)
    rec = t.step(100.0)                          # probe applied
    assert rec["verdict"] == VERDICT_PROBE
    assert cell["v"] != 4
    rec = t.step(500.0, guard="slo_burn:client") # better, but tripped
    assert rec["verdict"] == VERDICT_ROLLED_BACK
    assert rec["guard"] == "slo_burn:client"
    assert cell["v"] == 4
    assert t.counts["guard_trips"] == 1
    # and a standing guard stops NEW probes from starting at all
    assert t.step(500.0, guard="overlap_collapse") is None


def test_idle_system_is_left_alone():
    """objective <= 0 (no traffic) must never start a probe."""
    spec, cell = make_knob(init=4)
    t = Tuner("t", [spec], cooldown_ticks=0)
    for _ in range(10):
        assert t.step(0.0) is None
    assert cell["v"] == 4
    assert t.counts[VERDICT_PROBE] == 0


def test_pinned_knob_is_never_touched():
    pinned, pcell = make_knob(name="p", init=4, pinned=True)
    free, fcell = make_knob(name="f", init=4)
    t = Tuner("t", [pinned, free], hysteresis=0.02, cooldown_ticks=0)
    drive(t, lambda: 100.0 + fcell["v"], 20)
    assert pcell["v"] == 4, "pinned knob moved"
    assert t.counts[VERDICT_PROBE] > 0           # free knob still walked


def test_cooldown_spaces_decisions():
    spec, cell = make_knob(init=4)
    t = Tuner("t", [spec], hysteresis=0.02, cooldown_ticks=2)
    assert t.step(100.0)["verdict"] == VERDICT_PROBE
    assert t.step(100.0) is None                 # settling
    assert t.step(100.0) is None
    assert t.step(200.0)["verdict"] == VERDICT_KEPT


def test_zero_auto_knob_seeds_up_and_never_goes_negative():
    spec, cell = make_knob(init=0, lo=0, hi=100, seed=20)
    t = Tuner("t", [spec], hysteresis=0.02, cooldown_ticks=0)
    rec = t.step(100.0)
    assert rec["verdict"] == VERDICT_PROBE and rec["new"] == 20
    t.step(10.0)                                 # regress: roll back
    assert cell["v"] == 0
    # down from 0 is unproposable; up is blacklisted -> hold
    assert t.step(100.0) is None


def test_dump_shape_and_audit_ring():
    spec, cell = make_knob(init=4)
    t = Tuner("osd.0", [spec], cooldown_ticks=0)
    t.step(100.0)
    t.step(200.0)
    d = t.dump()
    assert d["name"] == "osd.0"
    assert d["knobs"][0]["name"] == "k"
    assert d["knobs"][0]["min"] == 1 and d["knobs"][0]["max"] == 64
    assert d["counts"][VERDICT_PROBE] == 1
    assert len(d["steps"]) == 2
    assert d["steps"][0]["verdict"] == VERDICT_PROBE
    assert d["steps"][1]["verdict"] == VERDICT_KEPT


def test_every_tunable_option_has_finite_bounds():
    """The schema audit, as a standing invariant: an Option marked
    tunable without finite min/max is a schema bug the controller
    would otherwise walk off a cliff."""
    conf = Config()
    tunables = conf.tunables()
    assert len(tunables) >= 4
    for opt in tunables:
        assert opt.min is not None and opt.max is not None, \
            f"tunable option {opt.name} lacks finite min/max bounds"
        assert opt.min < opt.max, opt.name
    names = {o.name for o in tunables}
    assert {"ec_tpu_queue_window_max_us", "ec_tpu_inflight_groups",
            "ec_tpu_staging_depth",
            "osd_ec_pipeline_segment_bytes"} <= names
    # QoS triples for the mgr half; peering deliberately NOT tunable
    assert "osd_mclock_scheduler_recovery_wgt" in names
    assert "osd_mclock_scheduler_peering_wgt" not in names


def test_knobs_from_config_live_set_and_pinning():
    conf = Config()
    knobs = knobs_from_config(
        conf,
        {"ec_tpu_inflight_groups": {},
         "ec_tpu_staging_depth": {},
         "ec_tpu_queue_window_max_us": {"seed": 20000}},
        pinned="ec_tpu_staging_depth, ec_tpu_queue_window_max_us")
    by = {k.name: k for k in knobs}
    assert len(by) == 3
    assert by["ec_tpu_staging_depth"].pinned
    assert by["ec_tpu_queue_window_max_us"].pinned
    assert by["ec_tpu_queue_window_max_us"].seed == 20000
    infl = by["ec_tpu_inflight_groups"]
    assert not infl.pinned and infl.is_int
    old = infl.get()
    infl.set(old + 1)                    # through Config.set(runtime)
    assert conf["ec_tpu_inflight_groups"] == old + 1
    # Option bounds arrived in the spec: the controller's clamp range
    assert infl.lo >= 1 and infl.hi <= 64


def test_knobs_from_config_skips_unbounded_tunable():
    """Defense in depth: even if a schema slips an unbounded tunable
    in, knobs_from_config refuses to walk it."""
    conf = Config()
    with conf._lock:
        opt = conf.schema["ec_tpu_inflight_groups"]
    import dataclasses
    bad = dataclasses.replace(opt, max=None)
    try:
        with conf._lock:
            conf.schema["ec_tpu_inflight_groups"] = bad
        knobs = knobs_from_config(conf,
                                  {"ec_tpu_inflight_groups": {}})
        assert knobs == []
    finally:
        with conf._lock:
            conf.schema["ec_tpu_inflight_groups"] = opt


def test_live_knob_mutation_keeps_output_bit_exact():
    """Flip every runtime-tunable batcher knob on a LIVE batcher in
    the middle of an encode stream; every op's chunk map must stay
    bit-identical to the synchronous ecutil.encode path."""
    from ceph_tpu_torch.ec import registry as ecreg
    from ceph_tpu_torch.osd import ecutil
    from ceph_tpu_torch.osd.batcher import EncodeBatcher

    conf = {"ec_tpu_batch_stripes": 1024,
            "ec_tpu_queue_window_us": 2_000,
            "ec_tpu_queue_window_max_us": 30_000,
            "ec_tpu_inflight_groups": 4,
            "ec_tpu_staging_depth": 2}
    EncodeBatcher.reset_learning()
    codec = ecreg.instance().factory(
        "gpu", {"k": "2", "m": "1", "technique": "reed_sol_van",
                "device": "cpu"})
    b = EncodeBatcher(conf)
    try:
        sinfo = ecutil.StripeInfo(2, 8192)
        n_ops = 24
        datas = [os.urandom((1 + i % 3) * 8192) for i in range(n_ops)]
        got = {}
        done = threading.Event()
        lock = threading.Lock()

        def cb(i):
            def _cb(chunks):
                with lock:
                    got[i] = chunks
                    if len(got) == n_ops:
                        done.set()
            return _cb

        # mutation schedule: hit each knob mid-stream, twice (up and
        # down) so both resize directions run against live traffic
        mutations = {
            6: ("ec_tpu_inflight_groups", 1),
            10: ("ec_tpu_queue_window_max_us", 500),
            14: ("ec_tpu_staging_depth", 8),
            18: ("ec_tpu_inflight_groups", 16),
            20: ("ec_tpu_queue_window_max_us", 100_000),
            22: ("ec_tpu_staging_depth", 1),
        }
        for i, data in enumerate(datas):
            if i in mutations:
                key, val = mutations[i]
                conf[key] = val          # a runtime conf.set
            b.submit(codec, sinfo, data, cb(i))
        assert done.wait(60), f"stream stalled: {len(got)}/{n_ops}"
        for i, data in enumerate(datas):
            assert got[i] == ecutil.encode(sinfo, codec, data), \
                f"op {i} chunks diverged after live knob mutation"
        # the seams actually latched the final values
        b.apply_tuning()
        assert b.inflight_groups == 16
        assert b._completions.maxsize == 16
        assert b.window_max_s == pytest.approx(0.1)
    finally:
        b.stop()


def test_staging_pool_set_depth_live():
    """Raising depth admits new slots; lowering stops growth without
    touching slots already in flight (bit-exactness by construction:
    buffers are never resized or freed under a writer)."""
    from ceph_tpu_torch.ops.torch_engine import StagingPool
    pool = StagingPool(depth=2)
    shape = (1, 2, 512)
    a = pool.acquire(shape)
    bslot = pool.acquire(shape)
    assert pool.allocs == 2
    pool.set_depth(4)
    c = pool.acquire(shape)              # third slot now admitted
    assert pool.allocs == 3
    pool.set_depth(1)                    # shrink target below live
    host_a = a.host
    pool.release(shape, a, None)
    got = pool.acquire(shape)            # in-flight slot keeps cycling
    assert got.host is host_a
    assert pool.allocs == 3              # no growth past the target
    pool.release(shape, bslot, None)
    pool.release(shape, c, None)
    pool.release(shape, got, None)


def test_queue_window_zero_means_auto_restores_adaptive_ceiling():
    from ceph_tpu_torch.osd.batcher import EncodeBatcher
    conf = {"ec_tpu_batch_stripes": 64,
            "ec_tpu_queue_window_us": 1_000,
            "ec_tpu_queue_window_max_us": 50_000}
    EncodeBatcher.reset_learning()
    b = EncodeBatcher(conf)
    try:
        b.apply_tuning()
        assert b.window_max_s == pytest.approx(0.05)
        conf["ec_tpu_queue_window_max_us"] = 0
        b.apply_tuning()
        # 0 = auto: back to the adaptive default ceiling
        assert b.window_max_s == pytest.approx(
            max(b.window_base_s * 16, 0.02))
        assert b.dyn_window_s <= b.window_max_s
    finally:
        b.stop()


# ---------------------------------------------------------- lockdep
@pytest.fixture
def lockdep_on():
    was = lockdep.enabled()
    lockdep.enable(True)
    lockdep.reset()
    yield
    lockdep.enable(was)
    lockdep.reset()


@pytest.mark.usefixtures("lockdep_on")
def test_inversion_detected_without_deadlock():
    a = lockdep.DebugRLock("A")
    b = lockdep.DebugRLock("B")
    with a:
        with b:
            pass
    with b:                    # opposite order, single thread: no
        with a:                # actual deadlock — still a finding
            pass
    v = lockdep.violations()
    assert len(v) == 1
    assert "B -> A" in v[0] and "A -> B" in v[0]


@pytest.mark.usefixtures("lockdep_on")
def test_transitive_cycle_detected():
    a = lockdep.DebugRLock("A")
    b = lockdep.DebugRLock("B")
    c = lockdep.DebugRLock("C")
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    with c:
        with a:
            pass               # A->B->C->A
    assert lockdep.violations()


@pytest.mark.usefixtures("lockdep_on")
def test_recursion_and_consistent_order_clean():
    a = lockdep.DebugRLock("A")
    b = lockdep.DebugRLock("B")
    with a:
        with a:                # recursion is fine
            with b:
                pass
    with a:
        with b:                # same order again: fine
            pass
    assert lockdep.violations() == []

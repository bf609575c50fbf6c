"""Port twins of tests/test_faults.py: seeded faults on the port's store,
daemons and device route.

The store.apply gate of the port's MemStore (an injected error before
any mutation, an injected stall that fires the store-stall forensics),
the EC sub-write deadline that re-requests a dropped ack on classic and
crimson OSDs, and the reference's tier-1 chaos smoke with the `gpu`
plugin (``device="cpu"``): 1-in-20 device-dispatch faults at seed 42
under an EC write load, every byte read back, the trips in the exported
perf dump.  Last, two tests of the port alone: every lane of the batcher
(encode, degraded read, parity delta) with every dispatch failing, then
one completion fault, each group served bit-exactly by the CPU twin and
counted by lane and reason, at a small geometry; and the faults phase
of ``chip_smoke.py`` itself (``faults_drive``, which
``chip_smoke.py --faults-child`` runs on the card) run on the CPU at its
own sizes, B1's plain version in the kernel's place.

Every test starts and ends with the process-wide fault registry disarmed
and zeroed and the batcher's class-level learning and breaker state
(``_breaker_open``, ``_breaker_opens`` ...) reset, so no later test in
the worker inherits an armed site or an open breaker.

Reference tests not twinned here:

- the registry unit tests (``test_every_n_fires_periodically_and_counts``
  through ``test_configure_from_cluster_conf``): the tests of the same
  names in tests/test_torch_utils.py.
- the batcher hardening tests
  (``test_device_fault_falls_back_to_cpu_twin_bit_exact``,
  ``test_completion_fault_serves_group_from_cpu``,
  ``test_breaker_opens_after_threshold_and_probe_readmits``,
  ``test_cb_error_fails_undone_requests_with_eio``): the tests of the
  same names in tests/test_torch_batcher.py.
"""
import os
import threading

import numpy as np
import pytest

from ceph_tpu_torch.cluster import Cluster
from ceph_tpu_torch.cluster import test_config as make_conf
from ceph_tpu_torch.ec import registry as ecreg
from ceph_tpu_torch.osd import ecutil
from ceph_tpu_torch.osd.batcher import EncodeBatcher
from ceph_tpu_torch.store import GHObject, MemStore, Transaction
from ceph_tpu_torch.utils import faults as faultlib
from ceph_tpu_torch.utils.faults import (DEVICE_COMPLETION, DEVICE_DISPATCH,
                                         EC_SUBWRITE_ACK, STORE_APPLY,
                                         InjectedError)


@pytest.fixture(autouse=True)
def clean_registry():
    """The registry and the breaker are process-wide state: every test
    starts and ends disarmed with zeroed counters and a closed
    breaker."""
    faultlib.registry().reset()
    EncodeBatcher.reset_learning()
    try:
        yield
    finally:
        faultlib.registry().reset()
        EncodeBatcher.reset_learning()


def reg():
    return faultlib.registry()


# ------------------------------------------------------- store gate
def test_store_queue_transactions_consults_the_gate():
    s = MemStore()
    s.mkfs()
    s.mount()
    try:
        s.queue_transactions([Transaction().create_collection("1.0s0")])
        reg().arm(STORE_APPLY, mode="error", one_shot=True)
        t = Transaction().write("1.0s0", GHObject("o", 0), 0, b"data")
        with pytest.raises(InjectedError):
            s.queue_transactions([t])
        # error raised BEFORE any mutation; the retry lands cleanly
        assert not s.exists("1.0s0", GHObject("o", 0))
        s.queue_transactions([t])
        assert s.read("1.0s0", GHObject("o", 0)) == b"data"
    finally:
        s.umount()


def test_injected_store_stall_fires_store_stall_forensics():
    """An injected store.apply stall lands in the transaction's phase
    ledger (t0 is stamped before the fault gate), crosses the stall
    threshold, emits a ``store_stall`` flight-recorder event with
    forensics fields, and surfaces as a STORE_SLOW warn through the
    health-check feed.  A clean store records zero stall events."""
    from ceph_tpu_torch.mgr import health
    from ceph_tpu_torch.utils.flight_recorder import FlightRecorder

    rec = FlightRecorder(capacity=64, name="store-test")
    s = MemStore()
    s.mkfs()
    s.mount()
    s.attach_observability(recorder=rec, stall_threshold_s=0.05)
    try:
        s.queue_transactions([Transaction().create_collection("1.0s0")])
        # clean traffic first: no stall events, STORE_SLOW ok
        s.queue_transactions(
            [Transaction().write("1.0s0", GHObject("a", 0), 0, b"x")],
            op="client_write")
        assert not [e for e in rec.dump() if e["kind"] == "store_stall"]
        sig = s.store_stall_signals()
        assert sig["stalls"] == 0 and sig["txns"] >= 2
        ok = health.checks_from_signals(store=sig)
        assert ok["STORE_SLOW"]["severity"] == "ok"

        reg().arm(STORE_APPLY, mode="stall", every=1, stall_s=0.08,
                  max_trips=1)
        s.queue_transactions(
            [Transaction().write("1.0s0", GHObject("b", 0), 0, b"y")],
            op="client_write")
        events = [e for e in rec.dump() if e["kind"] == "store_stall"]
        assert len(events) == 1
        ev = events[0]
        # a stall at the gate charges into the first following phase
        assert ev["phase"] in ("journal_append", "data_write")
        assert ev["ms"] >= 75
        assert ev["backend"] == "MemStore"
        assert ev["op"] == "client_write"
        sig = s.store_stall_signals()
        assert sig["stalls"] == 1
        warn = health.checks_from_signals(store=sig)
        assert warn["STORE_SLOW"]["severity"] == "warn"
        assert warn["STORE_SLOW"]["stalls"] == 1
    finally:
        s.umount()


# ------------------------------------------------------ cluster level
def test_chaos_smoke_seeded_device_faults_zero_client_errors():
    """Tier-1 chaos smoke: 1-in-20 device-dispatch faults, seeded, over a
    small cluster EC write load on a `gpu` pool — every op must succeed,
    every byte verify, and the trips must surface in the exported perf
    dump."""
    conf = make_conf(fault_injection="device.dispatch:error:1in20",
                     fault_injection_seed=42,
                     ec_tpu_fallback_cpu=False)
    with Cluster(n_osds=3, conf=conf) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 30)
        c.create_ec_profile("chaos", plugin="gpu", k="2", m="1",
                            device="cpu")
        c.create_pool("chp", "erasure", erasure_code_profile="chaos")
        io = c.rados().open_ioctx("chp")
        blob = os.urandom(32 << 10)
        for i in range(12):
            io.write_full(f"c{i}", blob)
        for i in range(12):
            assert io.read(f"c{i}") == blob, "client saw bad bytes"
        cnt = reg().counters()
        assert cnt[DEVICE_DISPATCH]["hits"] > 0, \
            "no dispatch ever consulted the armed site"
        # the registry rides the OSD perf dump (-> admin socket,
        # ceph tell, mgr prometheus)
        ret, _, out = c.osds[0]._exec_command({"prefix": "perf dump"})
        assert ret == 0
        assert out["faults"][DEVICE_DISPATCH]["armed"] == 1
        assert out["faults"][DEVICE_DISPATCH]["hits"] == \
            cnt[DEVICE_DISPATCH]["hits"]


@pytest.mark.parametrize("backend", ["classic", "crimson"])
def test_subwrite_deadline_rerequests_after_dropped_ack(backend):
    """Drop the first MOSDECSubOpWriteReply delivery: the primary's
    sub-write deadline must fire, re-request the laggard shard, and
    complete the write — on the classic (timer thread) and crimson
    (reactor timer) OSDs alike."""
    conf = make_conf(osd_ec_subwrite_timeout_ms=400.0,
                     fault_injection="ec.subwrite_ack:error:once",
                     fault_injection_seed=1)
    if backend == "crimson":
        conf.set("osd_backend", "crimson")
    else:
        conf.set("osd_backend", "classic")
    with Cluster(n_osds=3, conf=conf) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 30)
        c.create_ec_profile("dl", plugin="jerasure", k="2", m="1")
        c.create_pool("dlp", "erasure", erasure_code_profile="dl")
        io = c.rados().open_ioctx("dlp")
        blob = os.urandom(16 << 10)
        io.write_full("laggard", blob)   # blocks until all shards ack
        assert io.read("laggard") == blob
        assert reg().trips(EC_SUBWRITE_ACK) == 1
        dumps = [c.osds[i]._exec_command({"prefix": "perf dump"})[2]
                 for i in range(3)]
        assert sum(d["osd"]["ec_subwrite_timeouts"]
                   for d in dumps) >= 1, "deadline never fired"
        assert sum(d["osd"]["ec_subwrite_retries"]
                   for d in dumps) >= 1, "laggard never re-requested"
        # follow-up writes are undisturbed (the one-shot is spent,
        # the re-request dedup left no stuck state)
        for i in range(4):
            io.write_full(f"after{i}", blob)
            assert io.read(f"after{i}") == blob


# ------------------------------------- the device-fault route, port only
K, M, CS, NST = 4, 2, 4096, 2
ERASED = (1, 4)
DIRTY = (0, 2)


def _lane_ops(b, codec, sinfo, objs, encoded, deltas):
    """Submit one op of each lane per object, one at a time (every op its
    own group), and wait for each: -> {lane: [results]}."""
    out = {"encode": [], "decode": [], "delta": []}

    def one(submit):
        got, ev = {}, threading.Event()
        submit(lambda res: (got.update(r=res), ev.set()))
        assert ev.wait(30), "a request never completed"
        return got["r"]
    for i, obj in enumerate(objs):
        out["encode"].append(one(lambda cb: b.submit(codec, sinfo, obj,
                                                     cb)))
        have = {s: c for s, c in encoded[i].items() if s not in ERASED}
        out["decode"].append(one(lambda cb: b.submit_decode(
            codec, sinfo, have, set(ERASED), cb)))
        out["delta"].append(one(lambda cb: b.submit_delta(
            codec, sinfo, deltas[i], DIRTY, cb)))
    return out


def test_device_fault_route_serves_every_lane_and_counts_it():
    """Every dispatch failing, then one completion fault: each lane's
    groups are served by the CPU twin byte-equal to jerasure, every
    such group is counted by lane (``fault_twin_groups``) with a
    ``fault_twin`` flight-recorder event naming its reason, the breaker
    opens and routes the lanes to the twin with reason-coded verdicts,
    a probe readmits the device, and the staging ring ends idle."""
    from ceph_tpu_torch.utils.config import default_config
    from ceph_tpu_torch.utils.flight_recorder import FlightRecorder
    from ceph_tpu_torch.utils.perf import PerfCountersCollection

    codec = ecreg.instance().factory(
        "gpu", {"k": str(K), "m": str(M), "device": "cpu"})
    jer = ecreg.instance().factory("jerasure", {"k": str(K), "m": str(M)})
    sinfo = ecutil.StripeInfo(K, K * CS)
    rng = np.random.default_rng(19)
    objs = [rng.integers(0, 256, NST * K * CS, dtype=np.uint8).tobytes()
            for _ in range(4)]
    encoded = [ecutil.encode(sinfo, jer, o) for o in objs]
    deltas = [rng.integers(0, 256, (NST, len(DIRTY), CS), dtype=np.uint8)
              for _ in objs]
    conf = default_config()
    conf.set("ec_tpu_fallback_cpu", False)
    conf.set("ec_tpu_queue_window_us", 1000)
    coll = PerfCountersCollection()
    rec = FlightRecorder(capacity=256, name="osd.faults")
    b = EncodeBatcher(conf, perf_coll=coll, recorder=rec)
    pool = codec.core.backend.staging
    stalls = pool.stats()["stall_allocs"]

    def check(out):
        for i, enc in enumerate(encoded[:len(out["encode"])]):
            assert out["encode"][i] == enc
            assert out["decode"][i] == {e: enc[e] for e in ERASED}
            dpar = jer.core.delta_parity(deltas[i], DIRTY)
            assert {s: bytes(v) for s, v in out["delta"][i].items()} == \
                {K + j: dpar[:, j].tobytes() for j in range(M)}
    try:
        reg().arm(DEVICE_DISPATCH, mode="error", every=1)
        check(_lane_ops(b, codec, sinfo, objs, encoded, deltas))
        assert reg().trips(DEVICE_DISPATCH) >= 3
        assert b.device_errors >= b.device_error_threshold
        assert EncodeBatcher._breaker_open
        assert EncodeBatcher._breaker_opens == 1
        assert all(b.fault_twin_groups[lane] >= 1
                   for lane in ("encode", "decode", "delta"))
        assert sum(b.fault_twin_groups.values()) == b.device_errors
        events = [e for e in rec.dump() if e["kind"] == "fault_twin"]
        assert len(events) == b.device_errors
        assert {e["reason"] for e in events} == {"dispatch"}
        dp = coll.perf_dump()["ec_device"]
        assert dp["route_breaker_open"] >= 1
        assert dp["dec_route_breaker_open"] >= 1
        assert dp["delta_route_breaker_open"] >= 1
        assert b.calls == b.dec_calls - b.dec_cpu_reqs == 0

        # one completion fault on a live handle: the next probe through
        # the open breaker reaches the device, its handle is abandoned
        # and the twin serves the group; the probe after readmits
        reg().disarm(DEVICE_DISPATCH)
        reg().arm(DEVICE_COMPLETION, mode="error", one_shot=True)
        errors = b.device_errors
        while reg().trips(DEVICE_COMPLETION) == 0:
            check(_lane_ops(b, codec, sinfo, objs[:1], encoded, deltas))
        assert b.device_errors == errors + 1
        assert [e["reason"] for e in rec.dump()
                if e["kind"] == "fault_twin"][-1] == "completion"
        while EncodeBatcher._breaker_open:
            check(_lane_ops(b, codec, sinfo, objs[:1], encoded, deltas))
        assert EncodeBatcher._breaker_closes == 1
        calls = b.calls + b.dec_calls + b.delta_calls
        check(_lane_ops(b, codec, sinfo, objs, encoded, deltas))
        assert b.device_errors == errors + 1
        assert b.calls + b.dec_calls + b.delta_calls > calls
    finally:
        b.stop()
    st = pool.stats()
    assert st["in_flight"] == 0
    assert st["stall_allocs"] == stalls


def test_chip_smoke_faults_phase_runs_on_the_cpu():
    """chip_smoke.py's faults phase, as its child drives it on the card,
    on the CPU: every lane's dispatch site trips from a closed breaker,
    every lane's completion site abandons one live handle, a probe
    readmits the device, the chaos smoke's perf dump equals the
    registry, and the staging ring ends idle.  faults_drive raises on
    any output not byte-equal to jerasure or any count the route must
    show."""
    import torch

    import chip_smoke
    r = chip_smoke.faults_drive(torch, np, "cpu")
    lanes = ("encode", "decode", "delta")
    assert all(r["dispatch"]["fault_twin_groups"][lane] >= 1
               for lane in lanes)
    assert r["completion"]["fault_twin_groups"] == dict.fromkeys(lanes, 1)
    assert r["completion"]["readmit"] is not None
    assert r["chaos"]["perf_dump"] == r["chaos"]["registry"]
    assert r["staging"]["in_flight"] == 0
    assert not reg().counters()

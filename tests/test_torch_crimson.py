"""The port's crimson OSD (ceph_tpu_torch/crimson): port twins of the JAX
package's tests/test_crimson.py and tests/test_shards.py, then the
reactor front of the batcher held against the JAX package's.

The reactor runs an OSD's client data path on event-loop threads with
futures; the crimson messenger keeps every session rule of the threaded
one; the batcher's window is cut at tick boundaries; a crimson OSD
boots, reports failures, recovers and mixes with classic ones exactly
as a classic one does; cross-shard work moves over SPSC mailboxes and
every PG-targeted op runs on the shard ``hash(pgid) % N`` owns.  EC
pools use the `gpu` plugin on the CPU (``device=cpu`` in the profile)
where the reference names its `tpu` plugin.  The RadosModel thrash soak
is marked ``slow``, as its reference is.  Four tests more hold the
port's repairs below the crimson OSD (ROADMAP faults C6-C8 and C10):
BlueStore's apply pump on a reactor, crc32c keeping the interpreter
lock, lock-free config reads, and dropping the session of a peer that
restarted elsewhere."""
import os
import threading
import time

import numpy as np
import pytest

from ceph_tpu_torch.cluster import Cluster
from ceph_tpu_torch.cluster import test_config as make_conf
from ceph_tpu_torch.crimson import CrimsonOSD, Reactor
from ceph_tpu_torch.crimson.net import CrimsonMessenger
from ceph_tpu_torch.crimson.osd import ReactorBatcher
from ceph_tpu_torch.ec import registry as ecreg
from ceph_tpu_torch.osd import ecutil
from ceph_tpu_torch.osd.batcher import EncodeBatcher
from ceph_tpu_torch.osd.osd import OSD
from ceph_tpu_torch.osd.pg import PG
from ceph_tpu_torch.utils.locks import ContentionStats
from ceph_tpu_torch.utils.machine import scaled
from ceph_tpu_torch.utils.perf import PerfCountersCollection


def gpu_profile(cluster, name, k, m, **kv):
    cluster.create_ec_profile(name, plugin="gpu", k=str(k), m=str(m),
                              device="cpu", **kv)


def make_codec(k, m, technique="reed_sol_van", **profile):
    """A `gpu` plugin codec on the CPU."""
    return ecreg.instance().factory(
        "gpu", {"k": str(k), "m": str(m), "technique": technique,
                "device": "cpu", **profile})


# ------------------------------------------- tests/test_crimson.py: reactor
def test_call_soon_runs_on_reactor_thread():
    r = Reactor(name="t-reactor")
    r.start()
    try:
        seen = []
        done = threading.Event()

        def job(tag):
            seen.append((tag, threading.current_thread().name))
            if len(seen) == 3:
                done.set()

        for i in range(3):
            r.call_soon(job, i)
        assert done.wait(5)
        assert [s[0] for s in seen] == [0, 1, 2], "FIFO order"
        assert all(name == "t-reactor" for _, name in seen)
    finally:
        r.stop()


def test_call_later_ordering_and_cancel():
    r = Reactor()
    r.start()
    try:
        fired = []
        done = threading.Event()
        r.call_later(0.15, lambda: (fired.append("late"), done.set()))
        r.call_later(0.01, lambda: fired.append("early"))
        victim = r.call_later(0.05, lambda: fired.append("never"))
        victim.cancel()
        assert done.wait(5)
        assert fired == ["early", "late"]
    finally:
        r.stop()


def test_future_chain_and_exception_propagation():
    r = Reactor()
    r.start()
    try:
        out = []
        done = threading.Event()
        f = r.future()
        # a mapper returning a Future splices in; an exception
        # propagates down the chain past intermediate stages
        chained = f.then(lambda v: v + 1).then(
            lambda v: r.resolved(v * 10))

        def tail(v):
            out.append(v)
            raise RuntimeError("boom")

        err = chained.then(tail)
        err.add_done_callback(lambda fut: (
            out.append(type(fut.exception()).__name__), done.set()))
        f.set_result(1)
        assert done.wait(5)
        assert out == [20, "RuntimeError"]
    finally:
        r.stop()


def test_set_result_defers_callbacks():
    """Resolving a future never runs continuations synchronously, even
    from the reactor thread: a chain resolved under a lock must not
    reenter."""
    r = Reactor()
    r.start()
    try:
        order = []
        done = threading.Event()

        def resolve_on_reactor():
            f = r.future()
            f.then(lambda _: (order.append("cb"), done.set()))
            f.set_result(None)
            order.append("after-set")

        r.call_soon(resolve_on_reactor)
        assert done.wait(5)
        assert order == ["after-set", "cb"]
    finally:
        r.stop()


def test_tick_hooks_run_every_tick():
    r = Reactor()
    hits = []
    r.add_tick_hook(lambda: hits.append(1))
    r.start()
    try:
        deadline = time.monotonic() + 5
        while len(hits) < 3 and time.monotonic() < deadline:
            r.call_soon(lambda: None)
            time.sleep(0.01)
        assert len(hits) >= 3
    finally:
        r.stop()


def test_tick_flush_cuts_the_batch_window():
    """With a multi-second window, tick_flush() dispatches the queued
    stripes at once: what makes reactor-tick batching latency-free
    against the classic timed window."""
    codec = make_codec(2, 1)
    EncodeBatcher.reset_learning()
    b = EncodeBatcher({"ec_tpu_batch_stripes": 1024,
                       "ec_tpu_queue_window_us": 8_000_000})
    try:
        sinfo = ecutil.StripeInfo(2, 8192)
        data = os.urandom(4 * 8192)
        got = {}
        done = threading.Event()
        b.submit(codec, sinfo, data,
                 lambda chunks: (got.update(chunks), done.set()))
        assert not done.wait(0.3), "dispatched before the window cut?"
        t0 = time.monotonic()
        b.tick_flush()
        assert done.wait(10)
        assert time.monotonic() - t0 < 5.0, \
            "tick_flush did not cut the 8s window"
        assert got == ecutil.encode(sinfo, codec, data)
        assert b.calls + b.cpu_calls == 1
    finally:
        b.stop()


# ----------------------------------------- tests/test_crimson.py: messenger
class _Capture:
    """Dispatcher recording (msg, dispatching-thread-name)."""

    def __init__(self):
        self.got = []
        self.cond = threading.Condition()

    def ms_dispatch(self, conn, msg):
        with self.cond:
            self.got.append((msg, threading.current_thread().name))
            self.cond.notify_all()
        return True

    def ms_handle_connect(self, conn):
        pass

    def ms_handle_reset(self, conn):
        pass

    def wait_n(self, n, timeout=10.0):
        deadline = time.monotonic() + scaled(timeout)
        with self.cond:
            while len(self.got) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self.cond.wait(left)
        return True


def test_crimson_messengers_exchange_and_reply_on_reactor():
    from ceph_tpu_torch.msg.messages import MOSDPing

    conf = make_conf()
    ra, rb = Reactor(name="msgr-ra"), Reactor(name="msgr-rb")
    ra.start()
    rb.start()
    ma = CrimsonMessenger("osd.0", conf=conf, reactor=ra)
    mb = CrimsonMessenger("osd.1", conf=conf, reactor=rb)
    ca, cb = _Capture(), _Capture()
    ma.add_dispatcher(ca)
    mb.add_dispatcher(cb)
    try:
        ma.bind()
        mb.bind()
        ma.start()
        mb.start()
        conn = ma.connect_to(mb.my_addr, peer_name="osd.1")
        n = 40
        for i in range(n):
            conn.send_message(MOSDPing(op=MOSDPing.PING, from_osd=0,
                                       epoch=i))
        assert cb.wait_n(n), f"B got {len(cb.got)}/{n}"
        # the receiver dispatched inline on ITS reactor thread
        assert {t for _, t in cb.got} == {"msgr-rb"}
        assert [m.epoch for m, _ in cb.got] == list(range(n))
        # reply over the accepted (also crimson) connection
        back = cb.got[0][0].connection
        for i in range(n):
            back.send_message(MOSDPing(op=MOSDPing.PING_REPLY,
                                       from_osd=1, epoch=i))
        assert ca.wait_n(n), f"A got {len(ca.got)}/{n}"
        assert {t for _, t in ca.got} == {"msgr-ra"}
    finally:
        ma.shutdown()
        mb.shutdown()
        ra.stop()
        rb.stop()


def test_crimson_lossless_survives_socket_death():
    """Kill the TCP socket under a lossless session: the base-class
    reconnect machinery redials and the unacked queue resends, with the
    non-blocking pumps registered again on the new socket."""
    from ceph_tpu_torch.msg.messages import MOSDPing

    conf = make_conf()
    ra, rb = Reactor(), Reactor()
    ra.start()
    rb.start()
    ma = CrimsonMessenger("osd.0", conf=conf, reactor=ra)
    mb = CrimsonMessenger("osd.1", conf=conf, reactor=rb)
    cb = _Capture()
    mb.add_dispatcher(cb)
    ma.add_dispatcher(_Capture())
    try:
        ma.bind()
        mb.bind()
        ma.start()
        mb.start()
        conn = ma.connect_to(mb.my_addr, peer_name="osd.1")
        conn.send_message(MOSDPing(op=MOSDPing.PING, from_osd=0,
                                   epoch=0))
        assert cb.wait_n(1)
        # yank the transport out from under the session
        with conn.lock:
            sock = conn.sock
        sock.close()
        for i in range(1, 21):
            conn.send_message(MOSDPing(op=MOSDPing.PING, from_osd=0,
                                       epoch=i))
        assert cb.wait_n(21, 20), \
            f"only {len(cb.got)}/21 after reconnect"
        # at-most-once delivery held across the reconnect
        epochs = [m.epoch for m, _ in cb.got]
        assert epochs == sorted(set(epochs)) == list(range(21))
    finally:
        ma.shutdown()
        mb.shutdown()
        ra.stop()
        rb.stop()


def test_socket_failure_injection_parity_with_classic():
    """``ms_inject_socket_failures`` behaves the same on the crimson
    messenger and the classic one: both consult the same fault-registry
    site (msg.send) before every frame write, both count their trips
    there, and both survive the injected socket deaths with
    exactly-once in-order delivery."""
    from ceph_tpu_torch.msg.messages import MOSDPing
    from ceph_tpu_torch.msg.messenger import Messenger
    from ceph_tpu_torch.utils import faults as faultlib

    def run(flavor):
        faultlib.registry().reset()
        faultlib.registry().seed_all(13)
        conf = make_conf(ms_inject_socket_failures=10,
                         ms_connection_retry_interval=0.02)
        reactors = []
        if flavor == "crimson":
            reactors = [Reactor(), Reactor()]
            for r in reactors:
                r.start()
            ma = CrimsonMessenger("osd.0", conf=conf,
                                  reactor=reactors[0])
            mb = CrimsonMessenger("osd.1", conf=conf,
                                  reactor=reactors[1])
        else:
            ma = Messenger("osd.0", conf=conf)
            mb = Messenger("osd.1", conf=conf)
        sink = _Capture()
        mb.add_dispatcher(sink)
        ma.add_dispatcher(_Capture())
        try:
            ma.bind()
            addr = mb.bind()
            ma.start()
            mb.start()
            conn = ma.connect_to(addr, peer_name="osd.1")
            n = 60
            for i in range(n):
                conn.send_message(MOSDPing(op=MOSDPing.PING,
                                           from_osd=0, epoch=i))
            assert sink.wait_n(n, 60), \
                f"{flavor}: {len(sink.got)}/{n} after injection"
            epochs = [m.epoch for m, _ in sink.got]
            assert epochs == list(range(n)), \
                f"{flavor}: delivery not exactly-once in-order"
            c = faultlib.registry().counters()[faultlib.MSG_SEND]
        finally:
            ma.shutdown()
            mb.shutdown()
            for r in reactors:
                r.stop()
            faultlib.registry().reset()
        return c

    classic = run("classic")
    crimson = run("crimson")
    # both flavors absorbed the legacy conf into the shared site
    for flavor, c in (("classic", classic), ("crimson", crimson)):
        assert c["trips"] >= 1, f"{flavor} never tripped msg.send"
        assert c["hits"] >= 60, f"{flavor} skipped the injection gate"


@pytest.mark.parametrize("flavor", ["classic", "crimson"])
def test_session_of_a_restarted_peer_is_dropped_for_a_dial(flavor):
    """A session we accepted from a peer that then died waits for that
    peer to redial.  When the map shows the peer back at another address
    (its OSD is revived), mark_down_restarted drops that session, so the
    next connect_to dials the new incarnation and the message arrives,
    even if the new incarnation never dials us.  An open session is
    kept."""
    from ceph_tpu_torch.msg.messages import MOSDPing
    from ceph_tpu_torch.msg.messenger import Messenger

    conf = make_conf()
    reactors = []

    def msgr(name):
        if flavor == "classic":
            return Messenger(name, conf=conf)
        r = Reactor(name=f"{name}-r")
        r.start()
        reactors.append(r)
        return CrimsonMessenger(name, conf=conf, reactor=r)

    def ping(epoch):
        return MOSDPing(op=MOSDPing.PING, from_osd=7, epoch=epoch)

    a, old, new = msgr("osd.7"), msgr("osd.0"), msgr("osd.0")
    got_a, got_old, got_new = _Capture(), _Capture(), _Capture()
    for m, cap in ((a, got_a), (old, got_old), (new, got_new)):
        m.add_dispatcher(cap)
    try:
        for m in (a, old, new):
            m.bind()
            m.start()
        # the old incarnation dials us: we hold an accepted session
        old.connect_to(a.my_addr, peer_name="osd.7").send_message(ping(1))
        assert got_a.wait_n(1)
        accepted = a.conns_by_name["osd.0"]
        assert not accepted.connector
        a.mark_down_restarted("osd.0")          # open: kept
        assert accepted.state == "open"
        old.shutdown()
        deadline = time.monotonic() + scaled(10)
        while accepted.state == "open" and time.monotonic() < deadline:
            time.sleep(0.01)
        assert accepted.state == "connecting"
        a.mark_down_restarted("osd.0")
        assert accepted.state == "closed"
        conn = a.connect_to(new.my_addr, peer_name="osd.0")
        assert conn is not accepted
        conn.send_message(ping(2))
        assert got_new.wait_n(1), "the new incarnation got nothing"
        assert got_new.got[0][0].epoch == 2
    finally:
        for m in (a, old, new):
            m.shutdown()
        for r in reactors:
            r.stop()


def test_crimson_messenger_rejects_secure_mode():
    r = Reactor()
    with pytest.raises(ValueError, match="secure"):
        CrimsonMessenger("osd.9", conf=make_conf(
            ms_secure_mode=True, auth_cluster_required="cephx",
            auth_key="c2VjcmV0"), reactor=r)


# ------------------------------------------- tests/test_crimson.py: cluster
def test_crimson_cluster_replicated_and_ec_io():
    conf = make_conf(osd_backend="crimson")
    with Cluster(n_osds=3, conf=conf) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 30)
        assert all(type(o) is CrimsonOSD for o in c.osds.values())
        c.create_pool("rp", "replicated")
        io = c.rados().open_ioctx("rp")
        io.write_full("obj", b"crimson" * 512)
        assert io.read("obj") == b"crimson" * 512
        gpu_profile(c, "p21", 2, 1)
        c.create_pool("ecp", "erasure", erasure_code_profile="p21")
        io2 = c.rados().open_ioctx("ecp")
        blob = os.urandom(256 << 10)
        io2.write_full("eobj", blob)
        assert io2.read("eobj") == blob
        # the op tracker keeps the classic stage names, so attribution
        # compares across backends
        events = set()
        for osd in c.osds.values():
            for opd in osd.op_tracker.dump_historic_ops():
                events.update(e["event"] for e in opd["events"])
        assert "queued_for_pg" in events
        assert "reached_pg" in events
        # the reactors ticked and ran the continuations
        assert all(o.reactor.callbacks_run > 0
                   for o in c.osds.values())


def test_mixed_cluster_classic_and_crimson_side_by_side():
    """Crimson is the default, so the mixed cluster pins the conf to
    classic and promotes one OSD."""
    conf = make_conf(osd_backend="classic")
    c = Cluster(n_osds=3, conf=conf)
    c.backend_overrides[1] = "crimson"
    with c:
        for i in range(3):
            c.wait_for_osd_up(i, 30)
        assert type(c.osds[0]) is OSD
        assert type(c.osds[1]) is CrimsonOSD
        assert type(c.osds[2]) is OSD
        gpu_profile(c, "pm", 2, 1)
        c.create_pool("mixed", "erasure", erasure_code_profile="pm")
        io = c.rados().open_ioctx("mixed")
        for i in range(8):
            io.write_full(f"o{i}", bytes([i]) * 8192)
        for i in range(8):
            assert io.read(f"o{i}") == bytes([i]) * 8192


def test_crimson_is_the_default_backend():
    """A cluster built with no backend override boots crimson OSDs, and
    boot, heartbeats and IO behave as they do on classic ones."""
    with Cluster(n_osds=3, conf=make_conf()) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 30)
        assert all(type(o) is CrimsonOSD for o in c.osds.values())
        c.create_pool("dp", "replicated")
        io = c.rados().open_ioctx("dp")
        io.write_full("obj", b"default" * 64)
        assert io.read("obj") == b"default" * 64


def test_crimson_default_kill_revive_recovery_parity():
    """Kill an OSD under the default conf, see its peers report it
    down, revive it and rebuild to clean: the classic threads'
    maintenance, run as reactor timers, drives the same outcome."""
    with Cluster(n_osds=3, conf=make_conf()) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 30)
        c.create_pool("rp", "replicated", size=2)
        io = c.rados().open_ioctx("rp")
        for i in range(8):
            io.write_full(f"o{i}", bytes([i]) * 4096)
        c.wait_for_clean(30)
        c.kill_osd(2)
        c.wait_for_osd_down(2, 30)
        c.revive_osd(2)
        assert type(c.osds[2]) is CrimsonOSD
        c.wait_for_osd_up(2, 15)
        c.wait_for_clean(60)
        for i in range(8):
            assert io.read(f"o{i}") == bytes([i]) * 4096


def test_crimson_osd_down_detection_and_rebuild():
    """Heartbeat reporting marks a killed crimson OSD down; a revive
    with a fresh store (disk loss) rebuilds to clean with every object
    intact."""
    conf = make_conf(osd_backend="crimson")
    with Cluster(n_osds=4, conf=conf) as c:
        for i in range(4):
            c.wait_for_osd_up(i, 30)
        gpu_profile(c, "p21", 2, 1)
        c.create_pool("ecp", "erasure", erasure_code_profile="p21")
        io = c.rados().open_ioctx("ecp")
        for i in range(12):
            io.write_full(f"o{i}", bytes([i]) * 8192)
        c.wait_for_clean(30)
        c.kill_osd(3, lose_data=True)
        c.wait_for_osd_down(3, 30)       # peers reported it silent
        assert io.read("o5") == bytes([5]) * 8192, "degraded read"
        c.revive_osd(3)
        assert type(c.osds[3]) is CrimsonOSD, "backend sticky"
        c.wait_for_osd_up(3, 15)
        c.wait_for_clean(120)
        for i in range(12):
            assert io.read(f"o{i}") == bytes([i]) * 8192


@pytest.mark.slow
def test_crimson_thrash_radosmodel_soak(monkeypatch):
    """Random kills and revives under a random RadosModel workload,
    byte-exact verification after settling: the thrash bar with crimson
    OSDs.  The port has no thrash tool, so the JAX package's RadosModel
    and Thrasher drive the port's cluster; they only call its public
    surface, and the model catches the port's RadosError."""
    from ceph_tpu.tools import thrash
    from ceph_tpu_torch.client.rados import RadosError

    monkeypatch.setattr(thrash, "RadosError", RadosError)
    conf = make_conf(osd_backend="crimson")
    with Cluster(n_osds=4, conf=conf) as c:
        for i in range(4):
            c.wait_for_osd_up(i, 30)
        c.create_pool("soak", "replicated", size=3)
        client = c.rados(timeout=30)
        client.op_timeout = 120.0
        io = client.open_ioctx("soak")
        model = thrash.RadosModel(io, seed=7, snaps=True)
        model.run(50)
        thrasher = thrash.Thrasher(c, seed=7, min_alive=3,
                                   interval=4.0).start()
        deadline = time.monotonic() + 12.0
        while time.monotonic() < deadline:
            model.step()
        thrasher.stop_and_settle(timeout=120)
        assert model.verify_all() == [], thrasher.actions
        assert all(type(o) is CrimsonOSD
                   for o in c.osds.values() if o is not None)


# ------------------------------------------ tests/test_shards.py: submit_to
def _start_group(n, name="tshard"):
    peers = Reactor.group(n, name=name)
    for r in peers:
        r.start()
    return peers


def _stop_group(peers):
    for r in peers:
        r.stop()


def test_group_wiring_shard_ids_and_mailboxes():
    peers = Reactor.group(3, name="g")
    assert [r.shard for r in peers] == [0, 1, 2]
    for r in peers:
        assert r._peers == peers
        # one inbound SPSC mailbox per peer shard
        assert len(r._mailboxes) == 3
    # a lone reactor is shard 0 of a group of itself
    lone = Reactor()
    assert lone.shard == 0 and lone._peers == [lone]


def test_submit_to_round_trip_fifo_and_reply_shard():
    """Items submitted r0 -> r1 run FIFO on shard 1's thread; each reply
    future resolves back on shard 0's thread, in submission order."""
    peers = _start_group(2)
    try:
        ran, resolved = [], []
        done = threading.Event()

        def work(i):
            ran.append((i, threading.current_thread().name))
            return i * 10

        def kick():
            for i in range(8):
                fut = peers[0].submit_to(1, work, i)
                fut.add_done_callback(
                    lambda f: (resolved.append(
                        (f.result(), threading.current_thread().name)),
                        done.set() if len(resolved) == 8 else None))

        peers[0].call_soon(kick)
        assert done.wait(5)
        assert [i for i, _ in ran] == list(range(8)), "target FIFO"
        assert all(name == "tshard-r1" for _, name in ran)
        assert [v for v, _ in resolved] == [i * 10 for i in range(8)]
        assert all(name == "tshard-r0" for _, name in resolved)
        assert peers[0].xshard_out == 8 and peers[1].xshard_in == 8
    finally:
        _stop_group(peers)


def test_submit_to_exception_travels_back_to_caller():
    peers = _start_group(2)
    try:
        got = []
        done = threading.Event()

        def boom():
            raise ValueError("shard says no")

        def kick():
            peers[0].submit_to(1, boom).add_done_callback(
                lambda f: (got.append(f.exception()), done.set()))

        peers[0].call_soon(kick)
        assert done.wait(5)
        assert isinstance(got[0], ValueError)
    finally:
        _stop_group(peers)


def test_submit_to_same_shard_and_foreign_thread():
    peers = _start_group(2)
    try:
        # same shard: a plain continuation, still resolves
        done = threading.Event()
        peers[0].call_soon(
            lambda: peers[0].submit_to(0, lambda: 7).add_done_callback(
                lambda f: done.set() if f.result() == 7 else None))
        assert done.wait(5)
        # a foreign thread (this test) is no shard's SPSC producer: it
        # falls back to the locked ready queue, same semantics
        fut = peers[0].submit_to(
            1, lambda: threading.current_thread().name)
        deadline = time.monotonic() + 5
        while not fut.done() and time.monotonic() < deadline:
            time.sleep(0.001)
        assert fut.result() == "tshard-r1"
        # the fallback never touched a mailbox
        assert peers[1].xshard_in == 0
    finally:
        _stop_group(peers)


def test_mailbox_wakes_a_sleeping_reactor():
    """An idle target pops out of its selector wait on the empty to
    non-empty mailbox transition: the round trip is far below one
    _IDLE_WAIT (0.05 s), let alone the two a polling drain would
    cost."""
    peers = _start_group(2)
    try:
        time.sleep(0.2)          # both reactors deep in idle waits
        best = None
        for _ in range(5):
            done = threading.Event()
            durations = []

            def kick():
                t0 = time.monotonic()
                peers[0].submit_to(1, lambda: None).add_done_callback(
                    lambda f: (durations.append(time.monotonic() - t0),
                               done.set()))

            peers[0].call_soon(kick)
            assert done.wait(5)
            best = durations[0] if best is None else min(best,
                                                         durations[0])
            time.sleep(0.06)     # let them go idle again
        assert best < 0.045, f"no wakeup: best round-trip {best:.3f}s"
    finally:
        _stop_group(peers)


def test_mailbox_telemetry_depth_and_handoff_latency():
    """bind_contention surfaces the mailbox depth gauges and the
    xshard_handoff wait histogram through the contention counters."""
    coll = PerfCountersCollection()
    st = ContentionStats(perf_coll=coll)
    st.register_site("xshard_handoff")
    peers = Reactor.group(2, name="tm")
    for r in peers:
        site = f"mailbox_r{r.shard}"
        st.register_queue(site)
        r.bind_contention(st, site)
        r.start()
    try:
        done = threading.Event()

        def kick():
            futs = [peers[0].submit_to(1, lambda: None)
                    for _ in range(6)]
            futs[-1].add_done_callback(lambda f: done.set())

        peers[0].call_soon(kick)
        assert done.wait(5)
        cp = coll.create("contention")
        assert cp.get("xshard_handoff_acquires") == 6
        assert sum(cp.dump()["xshard_handoff_wait_us"]["buckets"]) == 6
        # all 6 were appended in one callback, so the drain saw a
        # multi-item mailbox at least once
        assert cp.get("mailbox_r1_depth_hwm") >= 2
        assert peers[1].mailbox_hwm >= 2
    finally:
        _stop_group(peers)


# ------------------------------------- tests/test_shards.py: ReactorBatcher
class _FakeBatcher:
    """Records submissions and window cuts; completes inline."""

    def __init__(self):
        self.lock = threading.Lock()
        self.submits = []
        self.decodes = []
        self.flushes = 0

    def submit(self, ec_impl, sinfo, data, cb, tracked=None):
        with self.lock:
            self.submits.append(data)
        cb(("encoded", data))

    def submit_decode(self, ec_impl, sinfo, have, want, cb):
        with self.lock:
            self.decodes.append(want)
        cb(("decoded", want))

    def tick_flush(self):
        with self.lock:
            self.flushes += 1

    def stop(self, drain=30.0):
        pass


def test_reactor_batcher_marshals_completion_to_submitting_shard():
    peers = _start_group(2, name="tb")
    inner = _FakeBatcher()
    rb = ReactorBatcher(inner, peers)
    for r in peers:
        r.add_tick_hook(lambda i=r.shard: rb.shard_tick(i))
    try:
        results = []
        done = threading.Event()

        def submit_from(shard, tag):
            def cb(result):
                results.append(
                    (tag, threading.current_thread().name))
                if len(results) == 2:
                    done.set()
            rb.submit(None, None, tag, cb)

        peers[0].call_soon(submit_from, 0, "s0")
        peers[1].call_soon(submit_from, 1, "s1")
        assert done.wait(5)
        # both shards' stripes reached the ONE shared inner batcher
        assert sorted(inner.submits) == ["s0", "s1"]
        # each completion ran on its submitting shard's reactor
        shards = dict(results)
        assert shards["s0"] == "tb-r0" and shards["s1"] == "tb-r1"
        assert inner.flushes > 0, "window cut after shards drained"
    finally:
        _stop_group(peers)


def test_reactor_batcher_foreign_thread_passthrough_and_flush():
    peers = Reactor.group(2, name="tf")      # never started
    inner = _FakeBatcher()
    rb = ReactorBatcher(inner, peers)
    got = []
    rb.submit(None, None, "direct", got.append)
    # a foreign submit went straight through; cb marshalled to shard 0
    assert inner.submits == ["direct"]
    # buffered work (simulated: stuff the pending queue) drains via
    # flush_pending from a non-reactor thread at shutdown
    rb._pending[1].append(("enc", (None, None, "late",
                                   lambda r: got.append(r), None)))
    rb.flush_pending()
    assert inner.submits == ["direct", "late"]
    assert not rb._pending[1]


# ------------------------------------------- BlueStore's apply on a reactor
def test_apply_reactor_pump_waits_while_another_thread_applies():
    """A BlueStore bound to an apply reactor runs its apply batches as
    tasks there.  While another thread holds the applier mutex (a reader
    stealing the apply), the reactor's one pump looks again every
    APPLY_RETRY_S instead of re-queuing itself at once, which spun the
    reactor on every queued transaction's pump and starved the applying
    thread of the interpreter lock on a 13-OSD cluster.  Once the mutex
    is free the pump applies everything queued, with no further kick."""
    from ceph_tpu_torch.store import GHObject
    from ceph_tpu_torch.store.bluestore import APPLY_RETRY_S, BlueStore
    from ceph_tpu_torch.store.objectstore import Transaction

    store = BlueStore()
    store.mkfs()
    store.mount()
    r = Reactor(name="apply-r")
    r.start()
    calls = []
    pump = store._pump_once

    def counted():
        calls.append(1)
        return pump()
    store._pump_once = counted
    try:
        store.queue_transactions([Transaction().create_collection("c")])
        store.bind_apply_reactor(r)
        deadline = time.monotonic() + 5
        while store._applied_seq < store._wal_seq and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        blobs = {f"o{i}": os.urandom(4096) for i in range(20)}
        hold = 0.3
        with store._apply_mutex:
            del calls[:]
            for name, blob in blobs.items():
                store.queue_transactions([Transaction().write(
                    "c", GHObject(name, 0), 0, blob)])
            time.sleep(hold)
            held_calls = len(calls)
            assert store._applied_seq < store._wal_seq
        # one pump chain at 1 / APPLY_RETRY_S, with slack for timers
        assert held_calls <= 3 * hold / APPLY_RETRY_S, held_calls
        deadline = time.monotonic() + 5
        while store._applied_seq < store._wal_seq and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert store._applied_seq == store._wal_seq, "pump never came back"
        for name, blob in blobs.items():
            assert bytes(store.read("c", GHObject(name, 0))) == blob
        # a store bound anew (its OSD revived on the same store) pumps on
        # the new reactor, though a pump stayed queued on the old one
        idle = Reactor(name="apply-idle")        # never started
        store.bind_apply_reactor(idle)
        store.queue_transactions([Transaction().write(
            "c", GHObject("late", 0), 0, b"x" * 4096)])
        store.bind_apply_reactor(r)
        deadline = time.monotonic() + 5
        while store._applied_seq < store._wal_seq and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert store._applied_seq == store._wal_seq, "rebound pump idle"
    finally:
        store.bind_apply_reactor(None)
        r.stop()
        store.umount()


def test_crc32c_keeps_the_interpreter_lock_among_busy_threads():
    """A store read checks a crc32c for each 4 KiB block.  The native
    crc32c is loaded so that its calls keep the interpreter lock: 128
    block checksums take about a millisecond however many threads are
    runnable, where a call that drops the lock waits to win it back
    among them (seconds for 128 calls beside 24 busy threads)."""
    import ctypes

    from ceph_tpu_torch.utils import crc

    lib = crc._load()
    if lib is None:
        pytest.skip("no g++ here: crc32c runs its Python fallback")
    assert lib._func_flags_ & ctypes._FUNCFLAG_PYTHONAPI
    blocks = [os.urandom(4096) for _ in range(128)]
    want = [crc.crc32c(b) for b in blocks]
    stop = threading.Event()

    def busy():
        while not stop.is_set():
            pass
    threads = [threading.Thread(target=busy) for _ in range(24)]
    for t in threads:
        t.start()
    try:
        rounds = []
        for _ in range(4):
            t0 = time.perf_counter()
            got = [crc.crc32c(b) for b in blocks]
            rounds.append(time.perf_counter() - t0)
            assert got == want
    finally:
        stop.set()
        for t in threads:
            t.join(10)
            assert not t.is_alive()
    assert min(rounds) < 0.05, rounds


def test_config_reads_never_wait_on_a_writer():
    """Every daemon of a cluster reads one Config on its hot paths: a
    read takes no lock, so it returns at once while another thread
    holds the config's lock, and sees a set made before it."""
    from ceph_tpu_torch.utils.config import Config

    conf = Config({"osd_heartbeat_grace": 7.0})
    held, release = threading.Event(), threading.Event()

    def writer():
        with conf._lock:
            held.set()
            release.wait(10)
    t = threading.Thread(target=writer)
    t.start()
    try:
        assert held.wait(10)
        got = []
        reader = threading.Thread(target=lambda: got.append(
            (conf["osd_heartbeat_grace"], conf.get("osd_backend"))))
        reader.start()
        reader.join(5)
        assert not reader.is_alive(), "a read waited on the writer"
        assert got == [(7.0, "crimson")]
    finally:
        release.set()
        t.join(10)
    conf.set("osd_heartbeat_grace", 9.0)
    assert conf["osd_heartbeat_grace"] == 9.0
    conf.unset("osd_heartbeat_grace", source="runtime")
    assert conf["osd_heartbeat_grace"] == 7.0
    with pytest.raises(KeyError):
        conf.get("no_such_option")


# --------------------------------------- tests/test_shards.py: live cluster
def test_cluster_pg_to_reactor_affinity(monkeypatch):
    """Every client op executes on the reactor shard that owns its PG
    (thread name suffix ``-r{hash(pgid) % N}``), wrong-shard arrivals
    hop through the mailboxes, and the handoff shows in the contention
    counters."""
    seen = []
    orig = PG.do_request

    def spy(self, msg, conn):
        seen.append((threading.current_thread().name, self.home_shard))
        return orig(self, msg, conn)

    monkeypatch.setattr(PG, "do_request", spy)
    conf = make_conf(osd_backend="crimson", crimson_num_reactors=2)
    with Cluster(n_osds=3, conf=conf) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 30)
        assert all(type(o) is CrimsonOSD and o.n_reactors == 2
                   for o in c.osds.values())
        gpu_profile(c, "ps", 2, 1)
        c.create_pool("shardp", "erasure", erasure_code_profile="ps")
        io = c.rados().open_ioctx("shardp")
        cs = [io.aio_write_full(f"o{i}", bytes([i]) * 16384)
              for i in range(16)]
        for comp in cs:
            assert comp.wait(30) == 0
        assert len(seen) >= 16
        for name, home in seen:
            assert home is not None
            assert name.endswith(f"-r{home}"), \
                f"op ran on {name}, PG owned by shard {home}"
        # with round-robin connection pinning and 2 shards, some ops
        # landed on the wrong reactor and crossed a mailbox
        hops = sum(o.perf_coll.create("contention")
                   .get("xshard_handoff_acquires")
                   for o in c.osds.values())
        xin = sum(r.xshard_in for o in c.osds.values()
                  for r in o.reactors)
        assert hops > 0 and xin > 0
        for i in range(16):
            assert io.read(f"o{i}") == bytes([i]) * 16384


def test_cluster_forced_four_shards(monkeypatch):
    """crimson_num_reactors=4 whatever the core count: PG affinity holds
    on all four shards, wrong-shard arrivals ride the mailboxes (the
    depth high-water mark and handoff counters move), and four
    concurrent clients do not collapse below a lone client's
    throughput."""
    seen = []
    orig = PG.do_request

    def spy(self, msg, conn):
        seen.append((threading.current_thread().name, self.home_shard))
        return orig(self, msg, conn)

    monkeypatch.setattr(PG, "do_request", spy)
    conf = make_conf(osd_backend="crimson", crimson_num_reactors=4)
    with Cluster(n_osds=3, conf=conf) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 30)
        assert all(type(o) is CrimsonOSD and o.n_reactors == 4
                   for o in c.osds.values())
        assert all(len(o._shard_queues) == 4 and len(o.reactors) == 4
                   for o in c.osds.values())
        c.create_pool("forcep", "replicated", size=2)
        blob = os.urandom(32 << 10)
        n_each = 6
        rad = c.rados(timeout=30)
        rad.op_timeout = 60.0
        io = rad.open_ioctx("forcep")
        # rung 1: a lone serial client
        t0 = time.monotonic()
        for i in range(n_each):
            io.write_full(f"s{i}", blob)
        serial_bps = n_each * len(blob) / (time.monotonic() - t0)

        # rung 4: four concurrent clients over their own connections
        errs = []

        def writer(cj):
            try:
                rj = c.rados(timeout=30)
                rj.op_timeout = 60.0
                ioj = rj.open_ioctx("forcep")
                for i in range(n_each):
                    ioj.write_full(f"c{cj}-{i}", blob)
            except Exception as e:  # noqa: BLE001 — reported below
                errs.append(e)

        ts = [threading.Thread(target=writer, args=(cj,))
              for cj in range(4)]
        t0 = time.monotonic()
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
            assert not t.is_alive()
        conc_bps = 4 * n_each * len(blob) / (time.monotonic() - t0)
        assert not errs, errs
        # fan-in must not collapse aggregate throughput below the lone
        # client's, with generous noise slack
        assert conc_bps > 0.4 * serial_bps, \
            (f"4-client rung collapsed: {conc_bps / 1e6:.1f} MB/s vs "
             f"lone client {serial_bps / 1e6:.1f} MB/s")
        # affinity held on every one of the 4 shards
        assert len(seen) >= 4 * n_each + n_each
        homes = set()
        for name, home in seen:
            assert home is not None and 0 <= home < 4
            homes.add(home)
            assert name.endswith(f"-r{home}"), \
                f"op ran on {name}, PG owned by shard {home}"
        assert len(homes) >= 2, f"all PGs hashed to one shard: {homes}"
        # wrong-shard arrivals crossed mailboxes and registered depth
        hops = sum(o.perf_coll.create("contention")
                   .get("xshard_handoff_acquires")
                   for o in c.osds.values())
        hwm = max(r.mailbox_hwm for o in c.osds.values()
                  for r in o.reactors)
        assert hops > 0 and hwm >= 1, (hops, hwm)
        for i in range(n_each):
            assert io.read(f"s{i}") == blob


def test_connection_affinity_migration_ends_tail_handoffs():
    """Sustained one-PG traffic re-pins the client's connection to the
    PG's owning shard (a majority over the 32-op vote window), so tail
    ops stop crossing a mailbox: the client's own write-hop ledger gains
    no xshard_handoff stamp over the tail."""
    conf = make_conf(osd_backend="crimson", crimson_num_reactors=2)
    with Cluster(n_osds=3, conf=conf) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 30)
        c.create_pool("affp", "replicated", size=2)
        rad = c.rados(timeout=30)
        rad.op_timeout = 60.0
        io = rad.open_ioctx("affp")
        blob = b"a" * 4096
        for _ in range(40):          # > the 32-op vote window
            io.write_full("pinned", blob)
        before = rad.objecter.hops.dump()["hop_counts"].get(
            "xshard_handoff", 0)
        for _ in range(8):
            io.write_full("pinned", blob)
        after = rad.objecter.hops.dump()["hop_counts"].get(
            "xshard_handoff", 0)
        assert after == before, \
            (f"tail writes still crossed shards "
             f"({after - before} handoffs after migration)")


def test_concurrent_cluster_writes_coalesce_multi_stripe_groups():
    """Concurrent cluster writes from many PGs (and both reactor shards)
    dispatch as multi-request groups of at least k stripes, not as
    per-PG singleton calls."""
    conf = make_conf(osd_backend="crimson", crimson_num_reactors=2,
                     ec_tpu_queue_window_us=5000)
    with Cluster(n_osds=3, conf=conf) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 30)
        k = 2
        gpu_profile(c, "pc", k, 1)
        c.create_pool("coalp", "erasure", erasure_code_profile="pc")
        io = c.rados().open_ioctx("coalp")
        blob = os.urandom(64 << 10)
        cs = [io.aio_write_full(f"o{i}", blob) for i in range(32)]
        for comp in cs:
            assert comp.wait(30) == 0
        greqs = max(o.encode_batcher.group_reqs_hwm
                    for o in c.osds.values())
        gstripes = max(o.encode_batcher.group_stripes_hwm
                       for o in c.osds.values())
        coalesced = sum(o.encode_batcher.reqs_coalesced
                        for o in c.osds.values())
        assert greqs >= 2, "no cross-op group formed"
        assert gstripes >= k, \
            f"largest group only {gstripes} stripes (< k={k})"
        assert coalesced >= 2
        for i in range(4):
            assert io.read(f"o{i}") == blob


# ------------------------ the reactor front against the JAX package's
def _drive_reactor_batcher(reactor_cls, front_cls, inner, impl, sinfo, k,
                           m, objs, erased, cols, deltas):
    """Encode every object, rebuild ``erased`` of each and compute each
    object's parity delta for ``cols``, each request submitted from one
    of two reactor shards through ``front_cls`` over ``inner``.  Returns
    per request its result as bytes and the thread its completion ran
    on."""
    peers = reactor_cls.group(2, name="xb")
    front = front_cls(inner, peers)
    for r in peers:
        r.add_tick_hook(lambda i=r.shard: front.shard_tick(i))
        r.start()
    n = len(objs)
    enc, dec, dlt = [None] * n, [None] * n, [None] * n
    left = threading.Semaphore(0)

    def put(store, i):
        def cb(res):
            store[i] = (None if res is None else
                        {s: bytes(v) for s, v in res.items()},
                        threading.current_thread().name)
            left.release()
        return cb

    try:
        for i in range(n):
            peers[i % 2].call_soon(front.submit, impl, sinfo, objs[i],
                                   put(enc, i))
        for _ in range(n):
            assert left.acquire(timeout=120)
        for i in range(n):
            have = {s: enc[i][0][s] for s in range(k + m)
                    if s not in erased}
            peers[i % 2].call_soon(front.submit_decode, impl, sinfo, have,
                                   set(erased), put(dec, i))
            peers[(i + 1) % 2].call_soon(front.submit_delta, impl, sinfo,
                                         deltas[i], cols, put(dlt, i))
        for _ in range(2 * n):
            assert left.acquire(timeout=120)
    finally:
        front.stop()
        for r in peers:
            r.stop()
    return enc, dec, dlt


@pytest.mark.parametrize("k,m", [(8, 4), (2, 1)])
def test_reactor_batcher_matches_the_jax_package(k, m):
    """The same seeded encode, decode and delta submissions, each from
    one of two reactor shards, through the JAX package's ReactorBatcher
    over its CPU EncodeBatcher and `tpu` codec and through the port's
    over the `gpu` codec on the CPU: every chunk map, rebuilt chunk and
    parity delta is equal byte for byte, and each completion ran on the
    same shard in both, the one that submitted it."""
    from ceph_tpu.crimson import Reactor as RefReactor
    from ceph_tpu.crimson.osd import ReactorBatcher as RefReactorBatcher
    from ceph_tpu.ec import registry as ref_registry
    from ceph_tpu.osd import ecutil as ref_ecutil
    from ceph_tpu.osd.batcher import EncodeBatcher as RefBatcher

    cs, nst, nobj = 4096, 3, 6
    erased = (1, 5, 9, 11) if k == 8 else (k + m - 1,)
    cols = (2, 6) if k == 8 else (0, k - 1)
    rng = np.random.default_rng(0xC41 + 10 * k + m)
    objs = [rng.integers(0, 256, nst * k * cs, dtype=np.uint8).tobytes()
            for _ in range(nobj)]
    deltas = [rng.integers(0, 256, (nst, len(cols), cs), dtype=np.uint8)
              for _ in range(nobj)]
    conf = {"ec_tpu_batch_stripes": 1024,
            "ec_tpu_queue_window_us": 20_000,
            "ec_tpu_fallback_cpu": False}
    profile = {"k": str(k), "m": str(m), "technique": "reed_sol_van"}
    results = []
    for reactor_cls, front_cls, batcher_cls, impl, ecu in (
            (RefReactor, RefReactorBatcher, RefBatcher,
             ref_registry.instance().factory("tpu", profile), ref_ecutil),
            (Reactor, ReactorBatcher, EncodeBatcher, make_codec(k, m),
             ecutil)):
        batcher_cls.reset_learning()
        b = batcher_cls(dict(conf))
        try:
            results.append(_drive_reactor_batcher(
                reactor_cls, front_cls, b, impl,
                ecu.StripeInfo(k, k * cs), k, m, objs, erased, cols,
                deltas))
            assert b.cpu_reqs == b.dec_cpu_reqs == b.delta_cpu_reqs == 0
        finally:
            b.stop()
            batcher_cls.reset_learning()
    ref, got = results
    for what, want, have in zip(("encode", "decode", "delta"), ref, got):
        assert all(r[0] is not None for r in have), what
        assert have == want, f"{what} differs from the JAX package"
    for i, (e, d, x) in enumerate(zip(*got)):
        assert e[1] == d[1] == f"xb-r{i % 2}"
        assert x[1] == f"xb-r{(i + 1) % 2}"
    jer = ecreg.instance().factory("jerasure", {"k": str(k), "m": str(m)})
    sinfo = ecutil.StripeInfo(k, k * cs)
    for obj, (chunks, _) in zip(objs, got[0]):
        assert chunks == {s: bytes(v) for s, v in
                          ecutil.encode(sinfo, jer, obj).items()}


def test_reactor_batcher_keeps_packet_codes_on_the_packet_route(
        monkeypatch):
    """A cauchy_good k=4 m=2 packetsize=128 codec through the port's
    ReactorBatcher from two shards: the front forwards to the batcher,
    whose device route runs B2's wrapper (its plain version on the CPU)
    and never the byte-domain apply, and every chunk map equals
    jerasure's."""
    from ceph_tpu_torch.ops import packet_kernel

    b2_calls = []
    plain = packet_kernel.packet_apply_plain
    monkeypatch.setattr(packet_kernel, "packet_apply_plain",
                        lambda *a, **kw: (b2_calls.append(1),
                                          plain(*a, **kw))[1])
    k, m, ps = 4, 2, 128
    gpu = make_codec(k, m, "cauchy_good", packetsize=str(ps))
    jer = ecreg.instance().factory("jerasure", {
        "k": str(k), "m": str(m), "technique": "cauchy_good",
        "packetsize": str(ps)})
    cs = 4 * gpu.core.w * ps
    sinfo = ecutil.StripeInfo(k, k * cs)
    rng = np.random.default_rng(ps + k)
    objs = [rng.integers(0, 256, (1 + i % 3) * k * cs,
                         dtype=np.uint8).tobytes() for i in range(6)]
    EncodeBatcher.reset_learning()
    b = EncodeBatcher({"ec_tpu_batch_stripes": 1024,
                       "ec_tpu_queue_window_us": 20_000,
                       "ec_tpu_fallback_cpu": False})
    peers = Reactor.group(2, name="pk")
    front = ReactorBatcher(b, peers)
    for r in peers:
        r.add_tick_hook(lambda i=r.shard: front.shard_tick(i))
        r.start()
    got = [None] * len(objs)
    left = threading.Semaphore(0)
    try:
        for i, obj in enumerate(objs):
            peers[i % 2].call_soon(
                front.submit, gpu, sinfo, obj,
                lambda c, i=i: (got.__setitem__(i, c), left.release()))
        for _ in objs:
            assert left.acquire(timeout=60)
        assert b.cpu_reqs == 0 and b.calls >= 1
        assert len(b2_calls) >= b.calls
    finally:
        front.stop()
        for r in peers:
            r.stop()
        EncodeBatcher.reset_learning()
    for obj, chunks in zip(objs, got):
        assert chunks == ecutil.encode(sinfo, jer, obj)

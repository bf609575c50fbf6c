"""Port twins of the JAX package's multi-monitor quorum tests
(tests/test_multimon.py) on ceph_tpu_torch, with classic OSDs
(osd_backend="classic"; the crimson default has its twins in
tests/test_torch_crimson.py), and the
monitor's maps held against the JAX package's monitor for one command
sequence.

Reference analog: mon/Elector + mon/Paxos behavior driven by
qa/standalone/mon/* (quorum formation, leader loss, peon redirect,
no-quorum stalls, store-backed restart)."""
import time

import pytest

from ceph_tpu_torch.client.rados import Rados
from ceph_tpu_torch.cluster import Cluster
from ceph_tpu_torch.cluster import test_config as make_conf
from ceph_tpu_torch.mon.client import CommandTimeout


def quorum_conf(**over):
    # lease comfortably above tick so GIL stalls under pytest load
    # don't fake leader death
    over.setdefault("osd_backend", "classic")
    return make_conf(mon_lease=2.5, mon_election_timeout=1.0,
                     mon_tick_interval=0.25, **over)


@pytest.fixture
def cl():
    with Cluster(n_osds=2, n_mons=3, conf=quorum_conf()) as c:
        c.wait_for_quorum()
        for i in range(2):
            c.wait_for_osd_up(i, 45)
        yield c


def test_quorum_forms_and_maps_replicate(cl):
    leader = cl.wait_for_quorum()
    assert cl.mons[leader].quorum.is_leader()
    cl.create_pool("mm1", "replicated", size=2)
    # commits reach every mon (paxos to the quorum, lease catch-up for
    # any straggler outside it)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        epochs = {r: m.osdmap.epoch for r, m in cl.mons.items()}
        if len(set(epochs.values())) == 1:
            break
        time.sleep(0.2)
    else:
        detail = {r: {"epoch": m.osdmap.epoch,
                      "leader": m.quorum.leader,
                      "e_epoch": m.quorum.election_epoch,
                      "is_leader": m.quorum.is_leader()}
                  for r, m in cl.mons.items()}
        raise TimeoutError(f"mon epochs diverged: {detail}")
    names = {r: list(m.osdmap.pools)
             for r, m in cl.mons.items()}
    assert all(v == list(names.values())[0] for v in names.values())


def test_commands_via_peon_redirect(cl):
    leader = cl.wait_for_quorum()
    peons = [r for r in cl.mons if r != leader]
    # a client pointed ONLY at a peon must still mutate the map
    # (peon answers with a leader redirect the client follows)
    r = Rados(cl.mons[peons[0]].my_addr, conf=cl.conf).connect()
    try:
        ret, rs, _ = r.mon_command(
            {"prefix": "osd pool create", "pool": "viapeon",
             "pool_type": "replicated", "size": 2})
        assert ret == 0, rs
        ret, _, out = r.mon_command({"prefix": "osd pool ls"})
        assert "viapeon" in out["pools"]
    finally:
        r.shutdown()


def test_leader_failover(cl):
    leader = cl.wait_for_quorum()
    cl.create_pool("mmf", "replicated", size=2)
    io = cl.rados().open_ioctx("mmf")
    io.write_full("survivor", b"x" * 2048)

    cl.kill_mon(leader)
    new_leader = cl.wait_for_quorum(30)
    assert new_leader != leader
    # control plane and data plane keep working on a 2/3 quorum
    ret, rs, _ = cl.mon_command({"prefix": "osd pool create",
                                 "pool": "postfail",
                                 "pool_type": "replicated", "size": 2})
    assert ret == 0, rs
    io2 = cl.rados().open_ioctx("mmf")
    assert io2.read("survivor") == b"x" * 2048


def test_no_quorum_blocks_mutations():
    with Cluster(n_osds=1, n_mons=3, conf=quorum_conf()) as c:
        leader = c.wait_for_quorum()
        alive = [r for r in c.mons][0]
        ranks = sorted(c.mons)
        # kill two mons: majority gone, mutations must not commit
        dead = [r for r in ranks if r != ranks[0]]
        for r in dead:
            c.kill_mon(r)
        time.sleep(4.0)          # leases expire, election can't win
        survivor = c.mons[ranks[0]]
        # a minority mon must refuse (propose can't reach majority:
        # either an explicit no-quorum error or, once it steps down,
        # an "electing" stall ending in timeout)
        from ceph_tpu_torch.mon.client import MonClient
        from ceph_tpu_torch.msg.messenger import Messenger
        m = Messenger("client.999", conf=c.conf)
        m.start()
        try:
            ret, rs, _ = MonClient(m, survivor.my_addr).command(
                {"prefix": "osd pool create", "pool": "nope",
                 "pool_type": "replicated"}, timeout=8.0)
            assert ret < 0, f"minority mon committed: {ret} {rs}"
        except CommandTimeout:
            pass
        finally:
            m.shutdown()
        # revive one mon: quorum back, command succeeds
        c.revive_mon(dead[0])
        c.wait_for_quorum(30)
        ret, rs, _ = c.mon_command({"prefix": "osd pool create",
                                    "pool": "back",
                                    "pool_type": "replicated",
                                    "size": 1})
        assert ret == 0, rs


def test_auth_keyring_survives_leader_failover(cl):
    """Keyring mutations replicate through paxos: credentials created
    on one leader must be served identically by its successor."""
    ret, _, out = cl.mon_command(
        {"prefix": "auth get-or-create", "entity": "client.ha",
         "caps": ["mon", "allow r"]})
    assert ret == 0
    key = out["key"]
    leader = cl.wait_for_quorum()
    cl.kill_mon(leader)
    cl.wait_for_quorum(30)
    ret, _, out = cl.mon_command(
        {"prefix": "auth get", "entity": "client.ha"})
    assert ret == 0, "credential lost across failover"
    assert out["key"] == key


def test_paxos_completes_uncommitted_round():
    """A leader that dies between majority-ACCEPT and the COMMIT
    broadcast has already acked the client: the next leader must
    complete the round from the pendings carried in election acks
    (classic Paxos collect), not lose the acknowledged value."""
    with Cluster(n_osds=0, n_mons=3, conf=quorum_conf()) as c:
        leader = c.wait_for_quorum()
        lm = c.mons[leader]
        orig = lm.quorum._broadcast

        def drop_commits(msg, ranks=None):
            if msg.op == "commit":
                return                   # die before commit broadcast
            return orig(msg, ranks)

        lm.quorum._broadcast = drop_commits
        ret, _, out = c.mon_command(
            {"prefix": "auth get-or-create",
             "entity": "client.lost", "caps": []})
        assert ret == 0                  # client was acked
        key = out["key"]
        c.kill_mon(leader)
        c.wait_for_quorum(30)
        ret, _, out = c.mon_command(
            {"prefix": "auth get", "entity": "client.lost"})
        assert ret == 0, "acknowledged mutation lost across failover"
        assert out["key"] == key


def test_paxos_uncommitted_pn_highest_wins():
    """Two different values pending for the same version (a dead
    leader's majority-accepted value vs an older aborted round's):
    the new leader must complete the one accepted under the highest
    proposal number, regardless of ack arrival order (reference
    Paxos uncommitted_pn)."""
    import threading

    from ceph_tpu_torch.mon.paxos import QuorumService
    from ceph_tpu_torch.msg.messages import MMonMon

    class StubMap:
        epoch = 5

    class StubStore:
        def get_map(self, e):
            return None

    class StubKeyring:
        def dump(self):
            return {}

    class StubMon:
        name = "stub"

        def __init__(self):
            self.lock = threading.RLock()
            self.osdmap = StubMap()
            self.conf = {"mon_lease": 5.0,
                         "mon_election_timeout": 5.0}
            self.store = StubStore()
            self.keyring = StubKeyring()
            self.applied = []

        def apply_replicated(self, version, value):
            self.applied.append((version, value))
            self.osdmap.epoch = version

        def on_quorum_formed(self):
            pass

    for order in ("old-first", "new-first"):
        mon = StubMon()
        # 4 mons -> majority 3: victory needs both peer acks, so both
        # competing pendings are on the table when the round completes
        q = QuorumService(mon, 0, [("h", 1), ("h", 2), ("h", 3),
                                   ("h", 4)])
        q._send = lambda *a, **k: None
        q._broadcast = lambda *a, **k: None
        q.election_epoch = 11            # electing
        q._acks = {0: 5}
        losing = MMonMon(op="ack", from_rank=1, epoch=11,
                         last_committed=5, version=6,
                         value={"who": "loser"}, pn=6)
        winning = MMonMon(op="ack", from_rank=2, epoch=11,
                          last_committed=5, version=6,
                          value={"who": "winner"}, pn=10)
        first, second = (losing, winning) if order == "old-first" \
            else (winning, losing)
        q._handle_ack(first)
        q._handle_ack(second)
        # three of four acked: the candidate wins when the election
        # period ends (reference end_election_period)
        assert not q.is_leader()
        q._election_started = time.monotonic() - 10.0
        q.tick()
        assert q.is_leader()
        assert mon.applied == [(6, {"who": "winner"})], order


class _ElectionNet:
    """Three electors (the port's QuorumService over stub monitors)
    whose messages wait in one queue until the test delivers them, so a
    message order is replayed exactly.  Records every victory as
    (election epoch, rank)."""

    def __init__(self, n=3, lc=7):
        import threading

        from ceph_tpu_torch.mon.paxos import QuorumService
        self.queue = []                  # (src, dst, msg), oldest first
        self.victories = []
        net = self

        class Conn:
            def __init__(self, src, dst):
                self.src, self.dst = src, dst

            def send_message(self, msg):
                net.queue.append((self.src, self.dst, msg))

        class Msgr:
            def __init__(self, rank):
                self.rank = rank

            def connect_to(self, addr, peer_name=None):
                return Conn(self.rank, int(peer_name.split(".")[1]))

        class Mon:
            def __init__(self, rank):
                self.name = f"mon.{rank}"
                self.lock = threading.RLock()
                self.osdmap = type("M", (), {"epoch": lc})()
                self.conf = {"mon_lease": 5.0, "mon_election_timeout": 2.0,
                             "mon_clock_drift_allowed": 0.05,
                             "paxos_propose_interval": 0.05}
                self.msgr = Msgr(rank)
                self.quorum = None

            def on_quorum_formed(self):
                net.victories.append((self.quorum.election_epoch,
                                      self.quorum.rank))

        self.mons = [Mon(r) for r in range(n)]
        monmap = [("127.0.0.1", 6789 + r) for r in range(n)]
        for r, m in enumerate(self.mons):
            m.quorum = QuorumService(m, r, monmap)

    def q(self, rank):
        return self.mons[rank].quorum

    def deliver(self, src, dst, op):
        """Hand the oldest queued ``op`` from src to dst to its
        elector."""
        for i, (s, d, msg) in enumerate(self.queue):
            if (s, d, msg.op) == (src, dst, op):
                del self.queue[i]
                self.q(dst).handle(msg)
                return msg
        raise AssertionError(f"no {op} queued from {src} to {dst}: "
                             f"{[(s, d, m.op) for s, d, m in self.queue]}")

    def drain(self, drop=()):
        while self.queue:
            s, d, msg = self.queue.pop(0)
            if d not in drop:
                self.q(d).handle(msg)

    def one_leader_per_epoch(self):
        by_epoch = {}
        for epoch, rank in self.victories:
            by_epoch.setdefault(epoch, set()).add(rank)
        return all(len(r) == 1 for r in by_epoch.values()), by_epoch


def test_elector_one_leader_per_epoch():
    """Two candidates in one round and a monitor that acks both: mon.1
    proposes, mon.2 acks it; mon.0 (better: same data, lower rank)
    proposes, and mon.2 acks it too.  Victory at the first majority
    crowned both in one epoch.  mon.1 must wait (2 of 3 acks), defer to
    mon.0's propose, and mon.0 win with every ack; the deferred mon.1
    ignores late acks (reference ElectionLogic receive_ack,
    propose_classic_handler)."""
    net = _ElectionNet()
    net.q(1).start_election()
    net.q(0).start_election()
    net.deliver(1, 2, "propose")         # mon.2 defers to mon.1
    net.deliver(2, 1, "ack")             # mon.1: a majority, not everyone
    net.deliver(0, 2, "propose")         # mon.2 defers to the better mon.0
    net.deliver(2, 0, "ack")
    net.deliver(0, 1, "propose")         # mon.1 defers to mon.0
    net.deliver(1, 0, "ack")             # mon.0: every monitor acked
    net.drain()
    ok, by_epoch = net.one_leader_per_epoch()
    assert ok, by_epoch
    assert net.victories == [(2, 0)], net.victories
    assert [net.q(r).leader for r in range(3)] == [0, 0, 0]
    assert {net.q(r).election_epoch for r in range(3)} == {2}
    assert net.q(0).quorum == {0, 1, 2}


def test_elector_acks_only_a_better_candidate_in_one_round():
    """A monitor that acked mon.0 in a round ignores mon.1's propose of
    the same round (worse than mon.0): no second ack goes out."""
    net = _ElectionNet()
    net.q(0).start_election()
    net.q(1).start_election()
    net.deliver(0, 2, "propose")
    queued = len(net.queue)
    net.deliver(1, 2, "propose")
    assert len(net.queue) == queued - 1  # nothing sent in reply
    assert net.q(2)._deferred_to == 0


def test_elector_majority_wins_when_the_period_ends():
    """With mon.2 silent, mon.0 holds 2 of 3 acks: it does not win on
    the ack, and wins at the end of the election period; a candidate
    that deferred does not win on its stale majority."""
    net = _ElectionNet()
    net.q(0).start_election()
    net.deliver(0, 1, "propose")
    net.deliver(1, 0, "ack")
    assert net.victories == [] and net.q(0).leader is None
    net.q(0)._election_started -= 10.0
    net.q(0).tick()
    assert net.victories == [(2, 0)]
    net.drain(drop={2})
    assert net.q(1).leader == 0
    # a deferred candidate: mon.1 proposes, mon.2 acks it, then mon.1
    # hears mon.0's propose and defers; its period ends: no victory
    net = _ElectionNet()
    net.q(1).start_election()
    net.deliver(1, 2, "propose")
    net.deliver(2, 1, "ack")
    net.q(0).start_election()
    net.deliver(0, 1, "propose")
    assert net.q(1)._deferred_to == 0
    net.q(1)._election_started -= 2.5
    net.q(1).tick()
    assert net.victories == [] and net.q(1).leader is None


def test_broadcast_gives_each_monitor_its_own_message():
    """A connection stamps its sequence number on the message object it
    sends: one object queued for two monitors left the second peer with
    the first connection's numbers, and it then dropped its own
    session's later messages (a sync a lagging monitor asked for) as
    duplicates.  Every broadcast (propose, victory, lease) hands each
    peer its own unstamped copy with the same content."""
    net = _ElectionNet()
    net.q(0).start_election()
    net.deliver(0, 1, "propose")
    net.deliver(0, 2, "propose")
    net.deliver(1, 0, "ack")
    net.deliver(2, 0, "ack")             # every ack: victory broadcast
    net.q(0)._last_lease_tx = 0.0
    net.q(0).tick()                      # lease broadcast
    for op in ("victory", "lease"):
        sent = {d: m for s, d, m in net.queue if s == 0 and m.op == op}
        assert set(sent) == {1, 2}, op
        assert sent[1] is not sent[2], op
        assert sent[1].seq == sent[2].seq == 0, op
        assert vars(sent[1]) == vars(sent[2]), op


def test_mon_restart_resumes_from_store(tmp_path):
    ddir = str(tmp_path / "mm")
    with Cluster(n_osds=1, n_mons=3, data_dir=ddir,
                 conf=quorum_conf()) as c:
        c.wait_for_quorum()
        c.create_pool("persist", "replicated", size=1)
        target_epoch = c.mon.osdmap.epoch
        victim = [r for r in c.mons
                  if not c.mons[r].quorum.is_leader()][0]
        c.kill_mon(victim)
        c.create_pool("while-down", "replicated", size=1)
        c.revive_mon(victim)
        # revived mon resumes from its MonitorDBStore, then catches up
        # the epochs it missed
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            m = c.mons[victim]
            if m is not None and m.osdmap.epoch > target_epoch and \
                    "while-down" in [p.name
                                     for p in m.osdmap.pools.values()]:
                break
            time.sleep(0.2)
        else:
            raise TimeoutError(
                f"revived mon stuck at e{c.mons[victim].osdmap.epoch}")


MON_SEQUENCE = [
    {"prefix": "osd erasure-code-profile set", "name": "p42",
     "profile": ["plugin=jerasure", "k=4", "m=2",
                 "crush-failure-domain=osd"]},
    {"prefix": "osd erasure-code-profile get", "name": "p42"},
    {"prefix": "osd pool create", "pool": "ecp", "pool_type": "erasure",
     "erasure_code_profile": "p42", "pg_num": 8},
    {"prefix": "osd pool create", "pool": "rep",
     "pool_type": "replicated", "size": 3},
    {"prefix": "osd pool set", "pool": "ecp",
     "var": "allow_ec_overwrites", "val": "true"},
    {"prefix": "osd erasure-code-profile set", "name": "bad",
     "profile": ["plugin=jerasure", "k=0", "m=2"]},
    {"prefix": "osd pool delete", "pool": "rep"},
    {"prefix": "osd pool ls"},
]


def _mon_run(cluster_mod):
    conf = cluster_mod.test_config(osd_backend="classic")
    with cluster_mod.Cluster(n_osds=0, conf=conf) as c:
        replies = [c.mon_command(dict(cmd)) for cmd in MON_SEQUENCE]
        return replies, c.mon.osdmap.to_wire_dict()


def test_monitor_maps_equal_jax_package():
    """One command sequence (profiles, pools, flags, a refused
    profile, a delete) through a monitor of each package: the replies
    and the resulting OSDMap wire dicts are equal."""
    from ceph_tpu import cluster as ref_cluster
    from ceph_tpu_torch import cluster as port_cluster
    port_replies, port_map = _mon_run(port_cluster)
    ref_replies, ref_map = _mon_run(ref_cluster)
    assert port_replies == ref_replies
    assert port_replies[5][0] == -22
    assert port_map == ref_map
    assert port_map["pools"]["1"]["ec_overwrites"] is True
    assert "2" not in port_map["pools"]


def test_monitor_builds_the_gpu_codec_to_validate_a_profile():
    """The monitor validates a profile by building its codec: a `gpu`
    profile on the CPU is accepted, a bad one refused with -EINVAL."""
    with Cluster(n_osds=0, conf=quorum_conf()) as c:
        c.create_ec_profile("g", plugin="gpu", k="8", m="4",
                            device="cpu")
        ret, _, out = c.mon_command(
            {"prefix": "osd erasure-code-profile get", "name": "g"})
        assert ret == 0 and out["plugin"] == "gpu"
        ret, rs, _ = c.mon_command(
            {"prefix": "osd erasure-code-profile set", "name": "g2",
             "profile": ["plugin=gpu", "k=8", "m=4", "device=cpu",
                         "technique=nope"]})
        assert ret == -22, rs


def test_session_reset_between_connect_and_send_is_survived():
    """A client given every mon's address dials the one its index names;
    a dead mon refuses at once, and the messenger's reset (another
    thread) clears the session and hunts to the next mon.  A send that
    read the session again after connect() then found None and raised
    AttributeError (``cluster.mon_command`` after a leader's death, 2
    runs in 20 beside busy processes).  The send now goes to the session
    connect() saw, and the hunt renews the subscription on the next
    mon."""
    import threading

    from ceph_tpu_torch.mon.client import MonClient
    from ceph_tpu_torch.msg.messages import MMonSubscribe

    class FakeConn:
        def __init__(self, addr):
            self.addr, self.state, self.sent = addr, "connecting", []

        def send_message(self, msg):
            if self.state != "closed":
                self.sent.append(msg)

        def mark_down(self):
            self.state = "closed"

    class FakeMsgr:
        name = "client.fake"

        def __init__(self):
            self.conns = []

        def add_dispatcher(self, d):
            pass

        def is_stopping(self):
            return False

        def connect_to(self, addr, lossless=True, peer_name=""):
            conn = FakeConn(addr)
            self.conns.append(conn)
            return conn

    msgr = FakeMsgr()
    dead, live = ("127.0.0.1", 1), ("127.0.0.1", 2)
    monc = MonClient(msgr, [dead, live])
    connect = monc.connect

    def connect_then_reset():
        conn = connect()
        if conn.addr == dead and conn.state != "closed":
            # the dial to the dead mon is refused: the reset runs on the
            # messenger's thread and clears the session before we send
            conn.state = "closed"
            hunt = threading.Thread(target=monc.ms_handle_reset,
                                    args=(conn,))
            hunt.start()
            deadline = time.monotonic() + 5
            while monc.conn is not None and time.monotonic() < deadline:
                time.sleep(0.001)
        return conn

    monc.connect = connect_then_reset
    monc.subscribe_osdmap()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and not any(
            c.addr == live and c.sent for c in msgr.conns):
        time.sleep(0.01)
    subs = [m for c in msgr.conns if c.addr == live for m in c.sent]
    assert subs and all(isinstance(m, MMonSubscribe) for m in subs), subs
    assert monc.conn is not None and monc.conn.addr == live

"""Port twins of the JAX package's multi-monitor quorum tests
(tests/test_multimon.py) on ceph_tpu_torch, with classic OSDs
(osd_backend="classic"; the crimson OSD is not ported), and the
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
        assert q.is_leader()
        assert mon.applied == [(6, {"who": "winner"})], order


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

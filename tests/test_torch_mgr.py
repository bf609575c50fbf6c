"""The manager in the port (ceph_tpu_torch.mgr.manager and
ceph_tpu_torch.mgr.modules): perf collection from every up OSD, the HTTP
frontend and its modules (prometheus, restful, dashboard, balancer,
pg_autoscaler, alerts, tuner), enabled and disabled at runtime through
the monitor, on the port's cluster at the config default (crimson), as
the reference's tests run it.

Port twins of all 17 tests of tests/test_mgr.py.  ``ceph tell`` is the
reference's CLI (tools/, not ported), so the twin of
``test_tell_osd_perf_dump`` sends the CLI's MCommands over the port's
client messenger as the CLI does.  The reference's tests are not always
green in a loaded six-worker tier-1 run: ``test_dashboard_module`` has
failed there, and in another run seven tests of that file (not named in
the record); their twins here are held green all the same.  Then the slice
held against the JAX package: the prometheus ``render`` of one fixed
perf dump and of a live port OSD's dump gives byte-equal text, a port
cluster's scrape has the families and types of a JAX-package cluster's,
``pg_autoscale_recommendations`` and ``balancer_report`` of one OSDMap's
wire dict are equal, and ``discover()`` finds the reference's seven
modules with ``ceph_tpu`` blocked."""
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from ceph_tpu_torch.cluster import Cluster
from ceph_tpu_torch.cluster import test_config as make_conf
from ceph_tpu_torch.mgr.manager import (balancer_report,
                                        pg_autoscale_recommendations)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ["alerts", "balancer", "dashboard", "pg_autoscaler",
           "prometheus", "restful", "tuner"]


def tell(cluster, osd, cmd, timeout=30.0):
    """``ceph tell osd.<id> <cmd>`` as the reference's CLI sends it: the
    daemon's address from ``osd dump``, one lossy dial, one MCommand,
    its reply -> (retcode, rs, out)."""
    from ceph_tpu_torch.msg.messages import MCommand, MCommandReply
    from ceph_tpu_torch.msg.messenger import Dispatcher
    client = cluster.rados()
    ret, rs, out = client.mon_command({"prefix": "osd dump"}, timeout)
    assert ret == 0, rs
    info = next(o for o in out["osds"] if o["osd"] == osd)
    assert info["up"] and info["addr"], info
    got = threading.Event()
    reply = {}

    class _Collector(Dispatcher):
        def ms_dispatch(self, conn, msg) -> bool:
            if isinstance(msg, MCommandReply):
                reply["msg"] = msg
                got.set()
                return True
            return False

    client.msgr.add_dispatcher(_Collector())
    conn = client.msgr.connect_to(tuple(info["addr"]), lossless=False,
                                  peer_name=f"osd.{osd}")
    conn.send_message(MCommand(tid=1, cmd=cmd))
    assert got.wait(timeout), f"osd.{osd} did not answer"
    m = reply["msg"]
    return m.retcode, m.rs, m.out


@pytest.fixture(scope="module")
def cl():
    conf = make_conf(mgr_tick_interval=0.3)
    with Cluster(n_osds=3, conf=conf, with_mgr=True) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        c.create_pool("mgrp", "replicated", size=2)
        io = c.rados().open_ioctx("mgrp")
        for i in range(5):
            io.write_full(f"m{i}", b"x" * 4096)
        for i in range(5):
            io.read(f"m{i}")
        yield c


def test_mgr_aggregates_daemon_perf(cl):
    deadline = time.monotonic() + 25
    total_ops = 0
    while time.monotonic() < deadline:
        st = cl.mgr.status()
        with cl.mgr.lock:
            perf = dict(cl.mgr.daemon_perf)
        if len(st["daemons_reporting"]) == 3:
            total_ops = sum(p["perf"]["osd"]["op"]
                            for p in perf.values())
            # snapshots are pulled per tick: wait until they COVER
            # the fixture's ops, not merely until daemons reported
            if total_ops >= 10:
                break
        time.sleep(0.3)
    assert total_ops >= 10          # 5 writes + 5 reads landed somewhere
    one = next(iter(perf.values()))["perf"]["osd"]
    assert one["op_latency"]["avgcount"] == one["op"]


def test_prometheus_endpoint(cl):
    host, port = cl.mgr.http_addr
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        body = urllib.request.urlopen(
            f"http://{host}:{port}/metrics", timeout=5).read().decode()
        if 'ceph_osd_op{daemon="osd.0"}' in body:
            break
        time.sleep(0.3)
    else:
        raise TimeoutError("metrics never included daemon counters")
    assert "ceph_osd_up 3" in body
    assert "ceph_pool_count" in body
    assert "# TYPE ceph_osd_op counter" in body
    assert 'ceph_osd_op_latency_total{daemon=' in body
    # device-telemetry and critical-path subsystems ride the same
    # perf dump, so the scrape must carry their families (registered
    # at OSD boot — present even before traffic)
    assert 'ceph_ec_device_route_device{daemon="osd.0"}' in body
    assert "ceph_ec_device_staging_hits" in body
    assert "# TYPE ceph_ec_device_breaker_open_now gauge" in body
    assert "# TYPE ceph_ec_device_h2d_bps gauge" in body
    assert "# TYPE ceph_ec_device_timer_fire_lag_us histogram" in body
    assert "ceph_critpath_ops" in body
    assert "ceph_critpath_stage_encode_total" in body
    assert "ceph_critpath_bound_commit_wait" in body
    # hop-ledger and contention subsystems likewise register at boot
    assert 'ceph_hops_ops{daemon="osd.0"}' in body
    assert "# TYPE ceph_hops_store_apply_hist_s histogram" in body
    assert 'ceph_contention_stalls{daemon="osd.0"}' in body
    assert "# TYPE ceph_contention_msgr_sendq_depth_now gauge" in body
    assert "ceph_contention_pg_lock_wait_us_bucket" in body
    assert "ceph_contention_batcher_cond_wait_us_bucket" in body
    # op-queue QoS telemetry: per-class depth/served
    # gauges registered at OSD boot ride the same scrape
    assert 'ceph_op_queue_client_queued_now{daemon="osd.0"}' in body
    assert "# TYPE ceph_op_queue_client_queued_now gauge" in body
    assert "# TYPE ceph_op_queue_client_depth_hwm gauge" in body
    assert "# TYPE ceph_op_queue_client_deficit_now gauge" in body
    assert "# TYPE ceph_op_queue_client_served counter" in body
    assert 'ceph_op_queue_recovery_served{daemon="osd.0"}' in body
    assert "ceph_op_queue_scrub_queued_now" in body
    # store-transaction ledger: per-phase waterfall, op
    # census and IO accounting register at OSD boot too
    assert 'ceph_store_txns{daemon="osd.0"}' in body
    assert "# TYPE ceph_store_data_write_hist_s histogram" in body
    assert "# TYPE ceph_store_kv_commit_hist_s histogram" in body
    assert "ceph_store_op_write" in body
    assert "ceph_store_bytes_written" in body
    assert "ceph_store_phase_stalls" in body

    st = json.loads(urllib.request.urlopen(
        f"http://{host}:{port}/status", timeout=5).read().decode())
    assert st["osdmap_epoch"] >= 1
    assert "balancer" in st and "pg_autoscaler" in st


def test_tell_osd_perf_dump(cl):
    ret, _, out = tell(cl, 0, {"prefix": "perf dump"})
    assert ret == 0
    assert "osd" in out and "op" in out["osd"]
    ret, _, st = tell(cl, 1, {"prefix": "status"})
    assert ret == 0
    assert st["osd"] == 1 and st["state"] == "active"
    ret, _, out = tell(cl, 0, {"prefix": "dump_historic_ops"})
    assert ret == 0
    ops = out["ops"]
    assert isinstance(ops, list)
    if ops:
        assert "events" in ops[0] and "duration" not in ops[0]
    # config get/set carry their args beside the prefix
    ret, _, out = tell(cl, 0, {"prefix": "config get",
                               "name": "osd_op_complaint_time"})
    assert ret == 0
    assert float(out["value"]) > 0
    ret, rs, _ = tell(cl, 0, {"prefix": "config set",
                              "name": "osd_op_complaint_time",
                              "value": "12.5"})
    assert ret == 0, rs


def test_autoscaler_and_balancer_logic():
    """Pure-logic checks of the advisory modules."""
    from ceph_tpu_torch.crush.wrapper import build_flat_map
    from ceph_tpu_torch.osd.osdmap import Incremental, OSDMap, PGPool
    m = OSDMap()
    inc = Incremental(1)
    inc.new_crush = build_flat_map(10)
    rule = inc.new_crush.add_simple_rule("r", "default", "host",
                                         mode="firstn")
    for o in range(10):
        inc.new_up[o] = ("127.0.0.1", 1)
        inc.new_weight[o] = 0x10000
    m.apply_incremental(inc)
    inc2 = Incremental(2)
    inc2.new_pools[1] = PGPool(name="p1", pool_id=1, size=3, pg_num=8,
                               crush_rule=rule)
    m.apply_incremental(inc2)

    recs = pg_autoscale_recommendations(m)
    assert len(recs) == 1
    # one pool, 10 osds, size 3 -> ~333 target, power of two = 256
    assert recs[0]["target_pg_num"] == 256
    assert recs[0]["would_adjust"]

    rep = balancer_report(m)
    assert sum(rep["per_osd"].values()) == 8 * 3
    assert rep["spread"] >= 0


def test_autoscaler_applies_when_on():
    """mgr_pg_autoscale_mode=on: the mgr issues `osd pool set pg_num`
    and the cluster splits live to the recommended (grow-only) target
    (the autoscaler must be able to act, not just advise)."""
    conf = make_conf(mgr_tick_interval=0.2,
                     mgr_pg_autoscale_mode="on")
    with Cluster(n_osds=3, conf=conf, with_mgr=True) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        c.create_pool("asp", "replicated", pg_num=2, size=2)
        io = c.rados().open_ioctx("asp")
        blobs = {}
        for i in range(8):
            blobs[f"a{i}"] = bytes([i]) * 4096
            io.write_full(f"a{i}", blobs[f"a{i}"])
        # the recommendation for 3 osds / 1 pool / size 2 is >= 64;
        # wait for the mgr to apply it
        deadline = time.monotonic() + 20
        pool_id = None
        while time.monotonic() < deadline:
            osdmap = next(o for o in c.osds.values()
                          if o is not None).osdmap
            pool_id = osdmap.pool_name_to_id["asp"]
            if osdmap.pools[pool_id].pg_num > 2:
                break
            time.sleep(0.3)
        else:
            raise TimeoutError("autoscaler never grew the pool")
        c.wait_for_clean(60)
        for name, blob in blobs.items():
            assert io.read(name, len(blob)) == blob, name


def test_module_host_enable_disable_runtime():
    """`ceph mgr module enable/disable` edits the central config; the
    running mgr reconciles its active module set off the next map
    (load/enable/disable at runtime, >= 3 modules on the host)."""
    import time as _t

    from ceph_tpu_torch.cluster import Cluster, test_config
    from ceph_tpu_torch.mgr.manager import Manager
    conf = test_config()
    with Cluster(n_osds=2, conf=conf) as c:
        for i in range(2):
            c.wait_for_osd_up(i, 20)
        mgr = Manager(c.mon_addr, conf=conf).start()
        try:
            assert len(mgr.modules.active) >= 3
            assert "alerts" in mgr.modules.active
            # disable at runtime through the monitor
            ret, msg, _ = c.mon_command(
                {"prefix": "mgr module disable", "module": "alerts"})
            assert ret == 0, msg
            deadline = _t.time() + 15
            while "alerts" in mgr.modules.active and \
                    _t.time() < deadline:
                _t.sleep(0.2)
            assert "alerts" not in mgr.modules.active
            # ls reflects it
            ret, _, out = c.mon_command({"prefix": "mgr module ls"})
            assert ret == 0 and "alerts" not in out["enabled"]
            assert "alerts" in out["available"]
            # re-enable
            ret, msg, _ = c.mon_command(
                {"prefix": "mgr module enable", "module": "alerts"})
            assert ret == 0, msg
            deadline = _t.time() + 15
            while "alerts" not in mgr.modules.active and \
                    _t.time() < deadline:
                _t.sleep(0.2)
            assert "alerts" in mgr.modules.active
            # unknown module is a clean error
            ret, _, _ = c.mon_command(
                {"prefix": "mgr module enable", "module": "nope"})
            assert ret == -2
        finally:
            mgr.shutdown()


def test_restful_endpoints_and_module_commands():
    """The restful module's JSON API + module handle_command routing
    (reference pybind/mgr/restful + `ceph mgr <module> ...`)."""
    import json as _json
    import urllib.request

    from ceph_tpu_torch.cluster import Cluster, test_config
    from ceph_tpu_torch.mgr.manager import Manager
    conf = test_config()
    with Cluster(n_osds=2, conf=conf) as c:
        for i in range(2):
            c.wait_for_osd_up(i, 20)
        c.create_pool("mrp", "replicated", size=2)
        mgr = Manager(c.mon_addr, conf=conf).start()
        try:
            host, port = mgr.http_addr
            osds = _json.loads(urllib.request.urlopen(
                f"http://{host}:{port}/api/osd", timeout=5
            ).read().decode())
            assert {o["osd"] for o in osds} == {0, 1}
            pools = _json.loads(urllib.request.urlopen(
                f"http://{host}:{port}/api/pool", timeout=5
            ).read().decode())
            assert any(p["name"] == "mrp" for p in pools)
            # health lands once the collect tick fetched it
            import time as _t
            deadline = _t.time() + 40
            health = {}
            while _t.time() < deadline:
                health = _json.loads(urllib.request.urlopen(
                    f"http://{host}:{port}/api/health", timeout=5
                ).read().decode())
                if health.get("status"):
                    break
                _t.sleep(0.3)
            assert health.get("status", "").startswith("HEALTH")
            # module commands through the host
            rc, _, out = mgr.modules.handle_command(
                "balancer", {"args": ["status"]})
            assert rc == 0, out
            assert out
            rc, _, out = mgr.modules.handle_command(
                "pg_autoscaler", {"args": []})
            assert rc == 0 and "recommendations" in out
            rc, msg, _ = mgr.modules.handle_command("nope", {})
            assert rc == -2
        finally:
            mgr.shutdown()


def test_alerts_module_records_health_transitions():
    """The from-scratch `alerts` module (written purely against the
    MgrModule API) journals health transitions: killing an OSD flips
    health away from OK and the transition lands in its history."""
    import time as _t

    from ceph_tpu_torch.cluster import Cluster, test_config
    from ceph_tpu_torch.mgr.manager import Manager
    conf = test_config()
    with Cluster(n_osds=3, conf=conf) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        c.create_pool("alp", "replicated", size=3)
        io = c.rados().open_ioctx("alp")
        io.write_full("x", b"payload")
        c.wait_for_clean(30)
        mgr = Manager(c.mon_addr, conf=conf).start()
        try:
            # let the module see HEALTH_OK first
            deadline = _t.time() + 20
            alerts = {}
            while _t.time() < deadline:
                rc, _, alerts = mgr.modules.handle_command(
                    "alerts", {"args": ["history"]})
                if alerts.get("current") == "HEALTH_OK":
                    break
                _t.sleep(0.3)
            assert alerts.get("current") == "HEALTH_OK", alerts
            c.kill_osd(2)
            c.wait_for_osd_down(2)
            deadline = _t.time() + 30
            while _t.time() < deadline:
                rc, _, alerts = mgr.modules.handle_command(
                    "alerts", {"args": ["history"]})
                if alerts.get("current") not in (None, "HEALTH_OK"):
                    break
                _t.sleep(0.3)
            assert alerts["current"] != "HEALTH_OK", alerts
            transitions = [(a["from"], a["to"])
                           for a in alerts["alerts"]]
            assert any(f == "HEALTH_OK" for f, t in transitions
                       if f is not None), transitions
        finally:
            mgr.shutdown()


def test_dashboard_module():
    """The dashboard module (reference pybind/mgr/dashboard): serves the page and a composite data
    endpoint carrying health, OSD states, pools and PG states in one
    round trip, plus a status command reporting its URL."""
    import json as _json
    import urllib.request

    from ceph_tpu_torch.cluster import Cluster, test_config
    from ceph_tpu_torch.mgr.manager import Manager
    conf = test_config()
    with Cluster(n_osds=2, conf=conf) as c:
        for i in range(2):
            c.wait_for_osd_up(i, 20)
        c.create_pool("dbp", "replicated", size=2)
        mgr = Manager(c.mon_addr, conf=conf).start()
        try:
            host, port = mgr.http_addr
            page = urllib.request.urlopen(
                f"http://{host}:{port}/dashboard", timeout=5
            ).read().decode()
            assert "<html" in page and "dashboard" in page
            import time as _t
            deadline = _t.time() + 40
            data = {}
            while _t.time() < deadline:
                data = _json.loads(urllib.request.urlopen(
                    f"http://{host}:{port}/dashboard/data",
                    timeout=5).read().decode())
                if data.get("health", {}).get("status") and \
                        data.get("num_pgs"):
                    break
                _t.sleep(0.3)
            assert data["health"]["status"].startswith("HEALTH")
            assert data["osds_up"] == 2 and data["osds_in"] == 2
            assert any(p["name"] == "dbp" for p in data["pools"])
            assert data["num_pgs"] > 0
            assert sum(data["pg_states"].values()) == data["num_pgs"]
            rc, msg, out = mgr.modules.handle_command(
                "dashboard", {"args": ["status"]})
            assert rc == 0 and "/dashboard" in out["url"]
        finally:
            mgr.shutdown()


def test_prometheus_histogram_roundtrip():
    """Histogram counter sets render with every sample of a family
    contiguous under ONE # TYPE line, and the emitted p50/p95/p99
    gauges match percentiles recomputed from the raw buckets parsed
    back out of the exposition text."""
    import re
    from types import SimpleNamespace

    from ceph_tpu_torch.mgr.modules.prometheus import (_histogram_percentile,
                                                 render)
    bounds = [50, 100, 200, 500]
    buckets = [3, 7, 5, 2, 1]
    perf = {"osd.0": {"ec_batcher": {
                "queue_wait_us": {"bounds": bounds,
                                  "buckets": buckets},
                "h2d_bytes": 4096}},
            "osd.1": {"ec_batcher": {
                "queue_wait_us": {"bounds": bounds,
                                  "buckets": [0, 1, 0, 0, 4]},
                "h2d_bytes": 512}}}
    osdmap = SimpleNamespace(osds={}, pools={}, epoch=7)
    body = render(osdmap, perf)
    lines = body.splitlines()
    m = "ceph_ec_batcher_queue_wait_us"
    # exactly one TYPE line; every family sample contiguous below it
    ti = lines.index(f"# TYPE {m} histogram")
    block = []
    for ln in lines[ti + 1:]:
        if ln.startswith("# TYPE"):
            break
        block.append(ln)
    in_block = set(range(ti + 1, ti + 1 + len(block)))
    stray = [ln for i, ln in enumerate(lines)
             if ln.startswith(m + "_bucket") and i not in in_block]
    assert not stray, stray
    # parse osd.0's cumulative buckets back out of the text
    pat = re.compile(m + r'_bucket\{daemon="osd\.0",'
                         r'le="([^"]+)"\} (\d+)')
    cum = {mt.group(1): int(mt.group(2))
           for ln in block if (mt := pat.match(ln))}
    assert cum["+Inf"] == sum(buckets)
    raw, prev = [], 0
    for bnd in bounds:
        raw.append(cum[str(bnd)] - prev)
        prev = cum[str(bnd)]
    raw.append(cum["+Inf"] - prev)
    assert raw == buckets                # lossless round trip
    assert f'{m}_count{{daemon="osd.0"}} {sum(buckets)}' in body
    # percentile gauges match the raw-bucket computation
    for q, sfx in ((0.50, "p50"), (0.95, "p95"), (0.99, "p99")):
        assert f"# TYPE {m}_{sfx} gauge" in body
        got = [float(ln.rsplit(" ", 1)[1]) for ln in lines
               if ln.startswith(f'{m}_{sfx}{{daemon="osd.0"}}')]
        assert len(got) == 1
        assert abs(got[0] - _histogram_percentile(bounds, raw, q)) \
            < 1e-9
    # plain counters from the same subsystem still render
    assert 'ceph_ec_batcher_h2d_bytes{daemon="osd.0"} 4096' in body


def test_health_checks_and_cluster_merge():
    from ceph_tpu_torch.mgr import health

    ok = health.checks_from_signals(
        breaker_open=False, slo=None, slow_ops=0, blocked_ops=0,
        down_osds=[], degraded_pgs=0, total_pgs=8)
    s = health.summarize(ok)
    assert s["status"] == "HEALTH_OK"
    assert set(s["checks"]) >= {"EC_BREAKER_OPEN", "SLO_BURN",
                                "SLOW_OPS", "OSD_DOWN"}
    bad = health.checks_from_signals(
        breaker_open=True,
        slo={"client_write": {"burn": 12.0}}, slow_ops=3,
        blocked_ops=1, down_osds=[2], degraded_pgs=4, total_pgs=8)
    s2 = health.summarize(bad)
    assert s2["status"] == "HEALTH_ERR"
    for name in ("EC_BREAKER_OPEN", "SLO_BURN", "OSD_DOWN"):
        assert name in s2["line"]
    # cluster merge: worst severity wins, counts sum, down sets union
    warn = health.checks_from_signals(
        breaker_open=False, slo={"client_write": {"burn": 1.5}},
        slow_ops=2, blocked_ops=0, down_osds=[5], degraded_pgs=0,
        total_pgs=8)
    merged = health.merge([{"checks": ok}, {"checks": warn},
                           {"checks": bad}, None])
    assert merged["status"] == "HEALTH_ERR"
    assert merged["checks"]["SLOW_OPS"]["slow"] == 5
    assert merged["checks"]["OSD_DOWN"]["down"] == [2, 5]
    assert merged["checks"]["EC_BREAKER_OPEN"]["daemons_firing"] == 1
    # OP_QUEUE_BACKLOG: sustained client-class queue
    # growth warns; a transient spike (short streak) or an empty
    # queue after a long streak does not
    grow = health.checks_from_signals(
        op_queue={"client_growth_ticks": 3, "client_queued": 40})
    assert grow["OP_QUEUE_BACKLOG"]["severity"] == "warn"
    assert grow["OP_QUEUE_BACKLOG"]["queued"] == 40
    assert grow["OP_QUEUE_BACKLOG"]["growth_ticks"] == 3
    spike = health.checks_from_signals(
        op_queue={"client_growth_ticks": 2, "client_queued": 40})
    assert spike["OP_QUEUE_BACKLOG"]["severity"] == "ok"
    drained = health.checks_from_signals(
        op_queue={"client_growth_ticks": 5, "client_queued": 0})
    assert drained["OP_QUEUE_BACKLOG"]["severity"] == "ok"
    assert ok["OP_QUEUE_BACKLOG"]["severity"] == "ok"
    # STORE_SLOW: store-phase stalls warn; the check is
    # always present and defaults to ok, and merged stall counts sum
    assert ok["STORE_SLOW"]["severity"] == "ok"
    stall = health.checks_from_signals(
        store={"stalls": 2, "txns": 100})
    assert stall["STORE_SLOW"]["severity"] == "warn"
    assert stall["STORE_SLOW"]["stalls"] == 2
    assert stall["STORE_SLOW"]["txns"] == 100
    more = health.checks_from_signals(
        store={"stalls": 3, "txns": 40})
    smerged = health.merge([{"checks": ok}, {"checks": stall},
                            {"checks": more}])
    assert smerged["checks"]["STORE_SLOW"]["severity"] == "warn"
    assert smerged["checks"]["STORE_SLOW"]["stalls"] == 5


def test_dump_health_admin_round_trip(cl):
    for osd_id in range(3):
        ret, _, out = cl.osds[osd_id]._exec_command(
            {"prefix": "dump_health"})
        assert ret == 0
        assert out["daemon"] == f"osd.{osd_id}"
        assert out["status"] in ("HEALTH_OK", "HEALTH_WARN",
                                 "HEALTH_ERR")
        # a healthy fixture cluster: breaker closed, no OSDs down,
        # op queues draining
        assert out["checks"]["EC_BREAKER_OPEN"]["severity"] == "ok"
        assert out["checks"]["OSD_DOWN"]["severity"] == "ok"
        assert out["checks"]["OP_QUEUE_BACKLOG"]["severity"] == "ok"
        assert out["checks"]["STORE_SLOW"]["severity"] == "ok"


def test_dump_op_queue_admin_round_trip(cl):
    """The per-class scheduler telemetry behind the ceph_op_queue_*
    scrape: every OSD answers dump_op_queue with aggregated classes
    plus the raw per-shard stats, and the fixture's client traffic
    shows up as served client-class ops somewhere in the cluster."""
    client_served = 0
    for osd_id in range(3):
        ret, _, out = cl.osds[osd_id]._exec_command(
            {"prefix": "dump_op_queue"})
        assert ret == 0
        classes = out["classes"]
        for cls in ("client", "recovery", "scrub", "peering"):
            assert cls in classes, classes
            for field in ("queued", "served", "deficit", "depth_hwm"):
                assert field in classes[cls]
        assert len(out["shards"]) >= 1
        assert out["growth_ticks"] >= 0
        client_served += classes["client"]["served"]
    assert client_served > 0, "fixture ops never rode the scheduler"


def test_dump_tuner_admin_round_trip(cl):
    """Every OSD answers dump_tuner (the controller is built even when
    disabled, so the audit surface always exists): knob universe from
    the Option schema with bounds attached, counters, decision ring."""
    for osd_id in range(3):
        ret, _, out = cl.osds[osd_id]._exec_command(
            {"prefix": "dump_tuner"})
        assert ret == 0
        assert out["name"] == f"osd.{osd_id}"
        assert out["enabled"] is False           # default off
        names = {k["name"] for k in out["knobs"]}
        assert names == {"ec_tpu_queue_window_max_us",
                         "ec_tpu_inflight_groups",
                         "ec_tpu_staging_depth",
                         "osd_ec_pipeline_segment_bytes"}
        for k in out["knobs"]:
            assert k["min"] is not None and k["max"] is not None
            assert k["min"] <= k["value"] <= k["max"], k
        assert out["counts"]["probe"] == 0       # disabled: no walks
        assert out["steps"] == []
        assert out["blacklist"] == []


def test_prometheus_tuner_family(cl):
    """The tuner perf subsystem rides the standard scrape: counter +
    gauge families typed correctly, knob count visible per daemon."""
    host, port = cl.mgr.http_addr
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        body = urllib.request.urlopen(
            f"http://{host}:{port}/metrics", timeout=5).read().decode()
        if 'ceph_tuner_steps{daemon="osd.0"}' in body:
            break
        time.sleep(0.3)
    else:
        raise TimeoutError("metrics never included tuner counters")
    assert "# TYPE ceph_tuner_steps counter" in body
    assert "# TYPE ceph_tuner_rolled_back counter" in body
    assert "# TYPE ceph_tuner_guard_trips counter" in body
    assert "# TYPE ceph_tuner_objective_now gauge" in body
    assert "# TYPE ceph_tuner_knobs_now gauge" in body
    assert "# TYPE ceph_tuner_probing_now gauge" in body
    assert 'ceph_tuner_knobs_now{daemon="osd.0"} 4' in body


def _tuner_module_host(wgt=10.0, mode="act"):
    """Stub Manager for pure-logic mgr tuner module tests: conf dict,
    a monc whose `config set` lands back in conf (the map ride), and
    synthetic SLO burn gauges (permille, as in perf dumps)."""
    class _Monc:
        def __init__(self, host):
            self.host = host
            self.cmds = []

        def command(self, cmd, timeout):
            self.cmds.append(cmd)
            if cmd.get("prefix") == "config set":
                self.host.conf[cmd["name"]] = float(cmd["value"])
            return 0, "", {}

    class _Host:
        def __init__(self):
            self.conf = {
                "mgr_tuner_mode": mode,
                "mgr_tuner_burn_high": 1.0,
                "mgr_tuner_burn_low": 0.25,
                "osd_mclock_scheduler_recovery_wgt": wgt,
            }
            self.burns = {"client": 0.0, "recovery": 0.0}
            self.monc = _Monc(self)

        def _module_get(self, what):
            assert what == "perf_counters"
            return {"osd.0": {"slo": {
                "client_write_burn_now": self.burns["client"] * 1000,
                "client_read_burn_now": 0,
                "recovery_burn_now": self.burns["recovery"] * 1000,
            }}}

    return _Host()


def test_mgr_tuner_module_demote_promote_restore():
    from ceph_tpu_torch.mgr.modules.tuner import Module as TunerModule
    host = _tuner_module_host(wgt=10.0)
    mod = TunerModule(host)

    # clients burning error budget -> recovery weight halves
    host.burns["client"] = 2.0
    mod._tick()
    assert host.conf["osd_mclock_scheduler_recovery_wgt"] == 5.0
    assert host.monc.cmds[-1]["prefix"] == "config set"
    # cooldown: nothing moves even though burn persists
    for _ in range(3):
        mod._tick()
    assert host.conf["osd_mclock_scheduler_recovery_wgt"] == 5.0
    mod._tick()                                  # cooldown expired
    assert host.conf["osd_mclock_scheduler_recovery_wgt"] == 2.5

    # both calm -> drift back toward the 10.0 baseline, additively
    host.burns["client"] = 0.0
    for _ in range(40):
        mod._tick()
    assert host.conf["osd_mclock_scheduler_recovery_wgt"] == 10.0

    # rebuild lagging, clients idle -> promote past the baseline
    host.burns["recovery"] = 1.5
    for _ in range(4):
        mod._tick()
    assert host.conf["osd_mclock_scheduler_recovery_wgt"] == 15.0

    steps = mod.handle_command({})[2]["steps"]
    actions = [s["action"] for s in steps]
    assert actions[0] == "demote_recovery"
    assert "restore_recovery" in actions
    assert actions[-1] == "promote_recovery"
    assert all(s["applied"] for s in steps)


def test_mgr_tuner_module_advisory_and_operator_override():
    from ceph_tpu_torch.mgr.modules.tuner import Module as TunerModule

    # advisory mode records the decision but never issues config set
    host = _tuner_module_host(wgt=10.0, mode="advisory")
    mod = TunerModule(host)
    host.burns["client"] = 2.0
    mod._tick()
    assert host.monc.cmds == []
    assert host.conf["osd_mclock_scheduler_recovery_wgt"] == 10.0
    steps = mod.handle_command({})[2]["steps"]
    assert steps and steps[0]["applied"] is False

    # act mode: an operator override re-baselines instead of being
    # "restored" away
    host2 = _tuner_module_host(wgt=10.0)
    mod2 = TunerModule(host2)
    mod2._tick()                                 # calm: baseline=10
    host2.burns["client"] = 2.0
    mod2._tick()                                 # demote 10 -> 5
    assert host2.conf["osd_mclock_scheduler_recovery_wgt"] == 5.0
    host2.burns["client"] = 0.0
    host2.conf["osd_mclock_scheduler_recovery_wgt"] = 3.0  # operator
    for _ in range(10):
        mod2._tick()
    # 3.0 is the new baseline: calm ticks must NOT walk it back up
    assert host2.conf["osd_mclock_scheduler_recovery_wgt"] == 3.0


# ------------------------------------------- held against the JAX package
def _fixed_perf():
    """One perf dump of two daemons with every kind of value render
    types: counters, gauges by each suffix, a time average, histograms
    (one with an empty overflow), fault sites and a non-numeric value
    it skips."""
    bounds = [50, 100, 200, 500]
    return {
        "osd.1": {
            "osd": {"op": 12, "op_w": 7, "ec_batch_calls": 5,
                    "op_latency": {"avgcount": 12, "sum": 0.375},
                    "note": "skipped"},
            "ec_device": {"route_device": 3, "h2d_bps": 1.5e9,
                          "staging_slots": 8, "inflight_hwm": 2,
                          "staging_peak": 1 << 20,
                          "cache_entries": 4, "overlap_frac": 0.25,
                          "breaker_open_now": 0, "launch_in_flight": 1,
                          "timer_fire_lag_us": {
                              "bounds": bounds,
                              "buckets": [3, 7, 5, 2, 1]}},
            "faults": {"device.dispatch": {"hits": 4, "trips": 1,
                                           "armed": True},
                       "store.apply": {"hits": 0, "trips": 0,
                                       "armed": False}}},
        "osd.0": {
            "osd": {"op": 3, "op_w": 1, "ec_batch_calls": 2,
                    "op_latency": {"avgcount": 3, "sum": 0.0625}},
            "ec_batcher": {"queue_wait_us": {"bounds": bounds,
                                             "buckets": [0, 1, 0, 0]},
                           "h2d_bytes": 4096}},
    }


def _osdmap_pair():
    """One OSDMap built by the JAX package (10 OSDs, two pools), and
    the port's OSDMap from its wire dict."""
    from ceph_tpu.crush.wrapper import build_flat_map
    from ceph_tpu.osd.osdmap import Incremental, OSDMap, PGPool
    from ceph_tpu_torch.osd.osdmap import OSDMap as PortOSDMap
    m = OSDMap()
    inc = Incremental(1)
    inc.new_crush = build_flat_map(10)
    rule = inc.new_crush.add_simple_rule("r", "default", "host",
                                         mode="firstn")
    for o in range(10):
        inc.new_up[o] = ("127.0.0.1", 6800 + o)
        inc.new_weight[o] = 0x10000 if o != 7 else 0
    m.apply_incremental(inc)
    inc2 = Incremental(2)
    inc2.new_pools[1] = PGPool(name="p1", pool_id=1, size=3, pg_num=8,
                               crush_rule=rule)
    inc2.new_pools[2] = PGPool(name="p2", pool_id=2, size=2, pg_num=32,
                               crush_rule=rule)
    m.apply_incremental(inc2)
    return m, PortOSDMap.from_wire_dict(m.to_wire_dict())


def test_prometheus_render_equals_jax_package(cl):
    from ceph_tpu.mgr.modules.prometheus import render as ref_render
    from ceph_tpu_torch.mgr.modules.prometheus import render
    ref_map, port_map = _osdmap_pair()
    fixed = _fixed_perf()
    assert render(port_map, fixed) == ref_render(ref_map, fixed)
    # a live port OSD's dump: every family the port registers
    ret, _, live = cl.osds[0]._exec_command({"prefix": "perf dump"})
    assert ret == 0
    perf = {"osd.0": live}
    body = render(port_map, perf)
    assert body == ref_render(ref_map, perf)
    assert "# TYPE ceph_osd_ec_batch_calls counter" in body


def _scrape_types(cluster_mod, faults_mod, profile):
    """The ``# TYPE`` lines of the prometheus scrape of a 3-OSD cluster
    of ``cluster_mod``'s package with a manager, after writes to an EC
    pool of ``profile``: each family and its type.  The fault-injection
    registry is process-wide (its sites ride every OSD's perf dump), so
    it starts disarmed and zeroed, whatever earlier tests armed."""
    faults_mod.registry().reset()
    conf = cluster_mod.test_config(mgr_tick_interval=0.3)
    with cluster_mod.Cluster(n_osds=3, conf=conf, with_mgr=True) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        c.create_ec_profile("sp", **profile)
        c.create_pool("spp", "erasure", erasure_code_profile="sp")
        io = c.rados().open_ioctx("spp")
        for i in range(4):
            io.write_full(f"s{i}", bytes([i]) * 20000)
        host, port = c.mgr.http_addr
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            body = urllib.request.urlopen(
                f"http://{host}:{port}/metrics", timeout=5).read().decode()
            if all(f'ceph_osd_op{{daemon="osd.{i}"}}' in body
                   for i in range(3)):
                break
            time.sleep(0.3)
        else:
            raise TimeoutError("the scrape never held all three OSDs")
    return {ln for ln in body.splitlines() if ln.startswith("# TYPE")}


def test_scrape_families_equal_jax_package():
    """The port's OSDs register the reference's counters under the
    reference's names and kinds: the batcher's and the device's
    subsystems included, so no family goes missing or changes type."""
    from ceph_tpu import cluster as ref_cluster
    from ceph_tpu.utils import faults as ref_faults
    from ceph_tpu_torch import cluster as port_cluster
    from ceph_tpu_torch.utils import faults as port_faults
    port = _scrape_types(port_cluster, port_faults,
                         {"plugin": "gpu", "k": "2", "m": "1",
                          "device": "cpu"})
    ref = _scrape_types(ref_cluster, ref_faults,
                        {"plugin": "tpu", "k": "2", "m": "1"})
    assert port == ref, (sorted(port - ref), sorted(ref - port))
    for family in ("ec_batcher", "ec_device", "ec_device_ledger"):
        assert any(f" ceph_{family}_" in ln for ln in port), family


def test_autoscale_and_balancer_equal_jax_package():
    from ceph_tpu.mgr import manager as ref
    ref_map, port_map = _osdmap_pair()
    assert pg_autoscale_recommendations(port_map) == \
        ref.pg_autoscale_recommendations(ref_map)
    assert pg_autoscale_recommendations(port_map, 50) == \
        ref.pg_autoscale_recommendations(ref_map, 50)
    rep = balancer_report(port_map)
    assert rep == ref.balancer_report(ref_map)
    assert sum(rep["per_osd"].values()) == 8 * 3 + 32 * 2


def test_discover_finds_the_seven_modules_without_the_jax_package():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ceph_tpu'] = None\n"
        "from ceph_tpu_torch.mgr.modules import MgrModule, discover\n"
        "found = discover()\n"
        "assert all(issubclass(c, MgrModule) for c in found.values())\n"
        "assert all(c.__module__.startswith('ceph_tpu_torch.mgr.modules.')"
        " for c in found.values()), found\n"
        "print(' '.join(sorted(found)))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == MODULES
    from ceph_tpu.mgr.modules import discover as ref_discover
    assert sorted(ref_discover()) == MODULES

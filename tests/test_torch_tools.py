"""The command-line tools of the port (ceph_tpu_torch.tools): the ceph,
rados, erasure-code, crushtool, osdmaptool, objectstore and cephadm
tools.

Port twins of the 18 tests of tests/test_tools.py that drive
ceph_tpu.tools (not the two copycheck tests, which test the repo-root
tools/copycheck.py).  Live-cluster tools run against one module-scoped
port cluster at the config default (crimson OSDs) over loopback TCP.
The `gpu` plugin runs on the CPU (``device=cpu`` in its profile) where
the reference names its `tpu` plugin.

Then the tools held against the JAX package's on the same inputs, every
comparison byte equality: ec_tool's chunk files of one seeded 1 MiB
file at k=8 m=4 and at cauchy_good k=10 m=4 packetsize 2048, and its
decode after 4 losses; crushtool's and osdmaptool's written maps and
printed lines; objectstore_tool's listing, dumps and object bytes of a
store that either package's cluster wrote, FileStore and BlockStore;
ec_benchmark's KiB column.  Last, a vstart process with a `gpu` EC pool
answers the CLIs over TCP and exits 0 on SIGTERM."""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from ceph_tpu_torch.cluster import Cluster
from ceph_tpu_torch.tools import (ceph_cli, crushtool, ec_benchmark, ec_tool,
                                  objectstore_tool, osdmaptool, rados_cli)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cluster():
    with Cluster(n_osds=3) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        yield c


@pytest.fixture(scope="module")
def mon(cluster):
    host, port = cluster.mon_addr
    return f"{host}:{port}"


def run_ceph(mon, *words, fmt="json"):
    return ceph_cli.main(["-m", mon, "--format", fmt, *words])


# ---------------------------------------------------------------- ceph


def test_ceph_status_health(mon, capsys):
    assert run_ceph(mon, "status") == 0
    out = json.loads(capsys.readouterr().out)
    assert out["osdmap"]["num_up_osds"] == 3

    assert run_ceph(mon, "health") == 0
    assert "num_pgs" in json.loads(capsys.readouterr().out)


def test_ceph_profile_and_pool_lifecycle(mon, capsys):
    assert run_ceph(mon, "osd", "erasure-code-profile", "set", "cliprof",
                    "plugin=jerasure", "k=2", "m=1") == 0
    capsys.readouterr()
    assert run_ceph(mon, "osd", "erasure-code-profile", "get",
                    "cliprof") == 0
    prof = json.loads(capsys.readouterr().out)
    assert prof["k"] == "2" and prof["plugin"] == "jerasure"

    assert run_ceph(mon, "osd", "erasure-code-profile", "ls") == 0
    assert "cliprof" in json.loads(capsys.readouterr().out)["profiles"]

    assert run_ceph(mon, "osd", "pool", "create", "cliec", "8", "erasure",
                    "cliprof") == 0
    capsys.readouterr()
    assert run_ceph(mon, "osd", "pool", "ls") == 0
    assert "cliec" in json.loads(capsys.readouterr().out)["pools"]

    # profile in use: rm must refuse (reference OSDMonitor in-use check)
    assert run_ceph(mon, "osd", "erasure-code-profile", "rm",
                    "cliprof") == 1
    capsys.readouterr()

    assert run_ceph(mon, "osd", "pool", "delete", "cliec") == 0
    capsys.readouterr()


def test_ceph_osd_out_in_dump(mon, capsys):
    assert run_ceph(mon, "osd", "out", "2") == 0
    capsys.readouterr()
    assert run_ceph(mon, "osd", "dump") == 0
    dump = json.loads(capsys.readouterr().out)
    info = {o["osd"]: o for o in dump["osds"]}
    assert info[2]["weight"] == 0
    assert run_ceph(mon, "osd", "in", "2") == 0
    capsys.readouterr()
    assert run_ceph(mon, "osd", "tree") == 0
    capsys.readouterr()


def test_ceph_unknown_command(mon):
    with pytest.raises(SystemExit):
        run_ceph(mon, "bogus", "verb")


def test_ceph_options_after_command_words(mon, capsys):
    """Options may follow the command words (ceph pg dump --format
    json) — REMAINDER-style swallowing is a bug."""
    assert ceph_cli.main(["-m", mon, "pg", "dump", "--format",
                          "json"]) == 0
    json.loads(capsys.readouterr().out)
    assert ceph_cli.main(["-m", mon, "-s", "--format", "json"]) == 0
    assert "osdmap" in json.loads(capsys.readouterr().out)
    # --force after the profile entries must be an option, not a k=v
    assert ceph_cli.main(["-m", mon, "osd", "erasure-code-profile",
                          "set", "cliprof2", "plugin=jerasure", "k=2",
                          "m=1", "--force", "--format", "json"]) == 0
    capsys.readouterr()


def test_ceph_truncated_commands_give_usage(mon):
    for words in (["osd", "erasure-code-profile", "get"],
                  ["osd", "erasure-code-profile", "rm"],
                  ["osd", "pool", "delete"],
                  ["config", "set", "onlyname"],
                  ["config", "get"]):
        with pytest.raises(SystemExit):
            run_ceph(mon, *words)


# --------------------------------------------------------------- rados


@pytest.fixture(scope="module")
def datapool(cluster, mon):
    run_ceph(mon, "osd", "pool", "create", "clidata", "8", "replicated")
    return "clidata"


def test_rados_put_get_roundtrip(mon, datapool, tmp_path, capsys):
    src = tmp_path / "in.bin"
    src.write_bytes(os.urandom(70000))
    dst = tmp_path / "out.bin"
    assert rados_cli.main(["-m", mon, "-p", datapool, "put", "obj1",
                           str(src)]) == 0
    assert rados_cli.main(["-m", mon, "-p", datapool, "get", "obj1",
                           str(dst)]) == 0
    assert dst.read_bytes() == src.read_bytes()

    assert rados_cli.main(["-m", mon, "-p", datapool, "ls"]) == 0
    assert "obj1" in capsys.readouterr().out.split()

    assert rados_cli.main(["-m", mon, "-p", datapool, "stat", "obj1"]) == 0
    assert "size 70000" in capsys.readouterr().out

    assert rados_cli.main(["-m", mon, "-p", datapool, "setxattr", "obj1",
                           "user.k", "v1"]) == 0
    assert rados_cli.main(["-m", mon, "-p", datapool, "getxattr", "obj1",
                           "user.k"]) == 0
    assert capsys.readouterr().out.strip() == "v1"

    assert rados_cli.main(["-m", mon, "-p", datapool, "rm", "obj1"]) == 0


def test_rados_bench_write_then_seq(mon, datapool, capsys):
    argv = ["-m", mon, "-p", datapool, "bench", "1", "write",
            "-b", str(64 << 10), "-t", "4", "--no-cleanup",
            "--format", "json"]
    assert rados_cli.main(argv) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["total_ops"] > 0 and summary["errors"] == 0
    assert summary["bandwidth_mb_sec"] > 0

    argv = ["-m", mon, "-p", datapool, "bench", "1", "seq",
            "--format", "json"]
    assert rados_cli.main(argv) == 0
    rd = json.loads(capsys.readouterr().out)
    assert rd["total_ops"] >= summary["total_ops"]  # full pass
    assert rd["errors"] == 0


# ----------------------------------------------- erasure-code offline


def test_ec_tool_roundtrip(tmp_path, capsys):
    f = tmp_path / "payload"
    f.write_bytes(os.urandom(12345))
    prof = "plugin=jerasure,k=4,m=2"
    assert ec_tool.main(["encode", prof, "4096", "all", str(f)]) == 0
    capsys.readouterr()
    # lose two chunks, decode from the rest
    os.unlink(f"{f}.0")
    os.unlink(f"{f}.5")
    assert ec_tool.main(["decode", prof, "4096", "all", str(f)]) == 0
    assert (tmp_path / "payload.decoded").read_bytes()[:12345] == \
        f.read_bytes()


def test_ec_tool_plugin_exists_and_chunk_size(capsys):
    assert ec_tool.main(["test-plugin-exists", "gpu"]) == 0
    capsys.readouterr()
    assert ec_tool.main(["test-plugin-exists", "nope-such"]) == 1
    capsys.readouterr()
    assert ec_tool.main(["calc-chunk-size", "plugin=jerasure,k=2,m=1",
                         "4096"]) == 0
    assert int(capsys.readouterr().out) >= 2048


def test_ec_benchmark_output_format(capsys):
    assert ec_benchmark.main(["-p", "jerasure", "-P", "k=2,m=1",
                              "-S", str(64 << 10), "-i", "2",
                              "-w", "encode"]) == 0
    secs, kib = capsys.readouterr().out.split("\t")
    assert float(secs) > 0 and int(kib) == 2 * 64
    assert ec_benchmark.main(["-p", "jerasure", "-P", "k=2,m=1",
                              "-S", str(64 << 10), "-i", "3",
                              "-w", "decode", "-e", "1",
                              "--erasures-generation",
                              "exhaustive"]) == 0
    secs, kib = capsys.readouterr().out.split("\t")
    assert float(secs) > 0 and int(kib) == 3 * 64


def test_ec_benchmark_over_erasure_is_usage_error():
    with pytest.raises(SystemExit):
        ec_benchmark.main(["-p", "jerasure", "-P", "k=2,m=1",
                           "-S", "4096", "-w", "decode", "-e", "4",
                           "--erasures-generation", "exhaustive"])


# -------------------------------------------------- crush/osdmap tools


def test_crushtool_build_and_test(tmp_path, capsys):
    mapfn = str(tmp_path / "crush.json")
    assert crushtool.main(["--build", "--num-osds", "8", "-o", mapfn,
                           "host", "straw2", "2", "rack", "straw2",
                           "0"]) == 0
    capsys.readouterr()
    assert crushtool.main(["--test", "-i", mapfn, "--rule", "0",
                           "--num-rep", "2", "--min-x", "0", "--max-x",
                           "255", "--show-utilization"]) == 0
    out = capsys.readouterr().out
    assert "device" in out
    assert crushtool.main(["-d", mapfn]) == 0
    dump = json.loads(capsys.readouterr().out)
    assert len([b for b in dump.get("buckets", [])]) >= 4


def test_osdmaptool_create_print_test(tmp_path, capsys):
    mapfn = str(tmp_path / "osdmap.json")
    assert osdmaptool.main(["--createsimple", "6",
                            "--with-default-pool", "-o", mapfn]) == 0
    capsys.readouterr()
    assert osdmaptool.main(["--print", mapfn]) == 0
    dump = json.loads(capsys.readouterr().out)
    assert dump["epoch"] >= 2
    assert osdmaptool.main(["--test-map-pgs", "--pool", "1", mapfn]) == 0
    assert "total pgs 64" in capsys.readouterr().out
    assert osdmaptool.main(["--test-map-object", "foo", "--pool", "1",
                            mapfn]) == 0
    assert "-> up" in capsys.readouterr().out


# ---------------------------------------------- objectstore offline


def test_objectstore_tool(tmp_path, capsys):
    ddir = str(tmp_path / "cl")
    with Cluster(n_osds=2, data_dir=ddir) as c:
        c.create_pool("ostp", "replicated", size=2)
        r = c.rados()
        io = r.open_ioctx("ostp")
        io.write_full("ostobj", b"ostool-payload")
        io.setxattr("ostobj", "user.a", b"xv")
        c.wait_for_clean(45)
    # cluster stopped: examine osd.0's store offline
    path = os.path.join(ddir, "osd.0")
    assert objectstore_tool.main(["--data-path", path, "--op",
                                  "list"]) == 0
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.splitlines()]
    target = [(c0, o) for c0, o in lines if "ostobj" in o]
    assert target, f"ostobj not found in {lines}"
    coll, objname = target[0]
    assert objectstore_tool.main(["--data-path", path, coll, objname,
                                  "get-bytes"]) == 0
    assert b"ostool-payload" in capsys.readouterr().out.encode()
    assert objectstore_tool.main(["--data-path", path, coll, objname,
                                  "dump"]) == 0
    dump = json.loads(capsys.readouterr().out)
    assert dump["size"] == len(b"ostool-payload")
    assert objectstore_tool.main(["--data-path", path, "--op",
                                  "fsck"]) == 0
    capsys.readouterr()


def test_objectstore_tool_ec_shard_objects(tmp_path, capsys):
    """EC shard objects print as 'name(sN)' in --op list; that exact
    string must be accepted back for per-object commands."""
    ddir = str(tmp_path / "cle")
    with Cluster(n_osds=3, data_dir=ddir) as c:
        c.create_ec_profile("ostprof", plugin="jerasure", k="2", m="1")
        c.create_pool("ostec", "erasure", erasure_code_profile="ostprof")
        io = c.rados().open_ioctx("ostec")
        io.write_full("shardobj", b"z" * 8192)
        c.wait_for_clean(45)
    found = False
    for osd in range(3):
        path = os.path.join(ddir, f"osd.{osd}")
        assert objectstore_tool.main(["--data-path", path, "--op",
                                      "list"]) == 0
        lines = [json.loads(ln) for ln in
                 capsys.readouterr().out.splitlines()]
        for coll, objname in lines:
            if "shardobj" in objname and "(s" in objname:
                assert objectstore_tool.main(
                    ["--data-path", path, coll, objname, "dump"]) == 0
                dump = json.loads(capsys.readouterr().out)
                assert dump["size"] > 0
                found = True
    assert found, "no EC shard objects listed"


def test_cephadm_bootstrap_and_orch():
    """cephadm-style spec bootstrap + orch ls/ps + daemon stop/start
    + osd scale-up (reference cephadm bootstrap / `ceph orch`)."""
    from ceph_tpu_torch.tools.cephadm import CephAdm
    adm = CephAdm({"osd": {"count": 2},
                   "rgw": {"count": 1},
                   "mds": {"count": 1}}).bootstrap()
    try:
        services = {s["service"]: s["running"] for s in adm.orch_ls()}
        assert services["mon"] == 1 and services["osd"] == 2
        assert services["rgw"] == 1 and services["mds"] == 1
        daemons = {d["daemon"]: d for d in adm.orch_ps()}
        assert daemons["osd.0"]["status"] == "running"
        assert daemons["mds.a"]["addr"] is not None

        # the deployed services actually serve
        import urllib.request
        host, port = adm.services["rgw.x"].addr
        urllib.request.urlopen(f"http://{host}:{port}/", timeout=10)
        from ceph_tpu_torch.fs.mdsclient import MDSClient
        fsc = MDSClient(adm.cluster.rados(),
                        adm.services["mds.a"].my_addr, "fsdata")
        fsc.mkdir("/adm")
        assert [e["name"] for e in fsc.listdir("/")] == ["adm"]

        # daemon management + scale-up
        adm.daemon_stop("osd.1")
        assert {d["daemon"]: d["status"] for d in adm.orch_ps()}[
            "osd.1"] == "stopped"
        adm.daemon_start("osd.1")
        assert adm.orch_apply_osd(3) == 1
        services = {s["service"]: s["running"] for s in adm.orch_ls()}
        assert services["osd"] == 3
    finally:
        adm.shutdown()


def test_cephadm_service_restart():
    from ceph_tpu_torch.tools.cephadm import CephAdm
    adm = CephAdm({"osd": {"count": 2}, "rgw": {"count": 1}}
                  ).bootstrap()
    try:
        adm.daemon_stop("rgw.x")
        assert {d["daemon"]: d["status"] for d in adm.orch_ps()}[
            "rgw.x"] == "stopped"
        adm.daemon_start("rgw.x")
        import urllib.request
        host, port = adm.services["rgw.x"].addr
        urllib.request.urlopen(f"http://{host}:{port}/", timeout=10)
    finally:
        adm.shutdown()


# ------------------------------------- the tools against the JAX package
TOOLS_SEED = 20261020
EC_PROFILES = {"reed_sol_van": "k=8,m=4",
               "cauchy_good": "k=10,m=4,technique=cauchy_good,"
                              "packetsize=2048"}


def ref_tools():
    from ceph_tpu.tools import (crushtool as r_crush, ec_benchmark as r_bench,
                                ec_tool as r_ec, objectstore_tool as r_ost,
                                osdmaptool as r_osdmap)
    return {"crushtool": r_crush, "ec_benchmark": r_bench, "ec_tool": r_ec,
            "objectstore_tool": r_ost, "osdmaptool": r_osdmap}


def run_tool(main, argv, capsys):
    """(return code, stdout) of one tool's main(argv)."""
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("technique", sorted(EC_PROFILES))
def test_ec_tool_chunks_equal_jax_package(technique, tmp_path, capsys):
    """Byte equality: every chunk file of one seeded 1 MiB file, gpu
    (device=cpu) against the JAX package's tpu; then 4 chunks lost and
    the file decoded back."""
    ref = ref_tools()["ec_tool"]
    data = np.random.default_rng(TOOLS_SEED).integers(
        0, 256, 1 << 20, dtype=np.uint8).tobytes()
    prof = EC_PROFILES[technique]
    files = {}
    for who in ("port", "ref"):
        d = tmp_path / who
        d.mkdir()
        files[who] = d / "obj.bin"
        files[who].write_bytes(data)
    rc, out = run_tool(ec_tool.main, ["encode", f"plugin=gpu,device=cpu,{prof}",
                                      "4096", "all", str(files["port"])],
                       capsys)
    rc_ref, out_ref = run_tool(ref.main, ["encode", f"plugin=tpu,{prof}",
                                          "4096", "all", str(files["ref"])],
                               capsys)
    assert rc == rc_ref == 0 and out == out_ref
    n = 12 if technique == "reed_sol_van" else 14
    for i in range(n):
        assert (tmp_path / "port" / f"obj.bin.{i}").read_bytes() == \
            (tmp_path / "ref" / f"obj.bin.{i}").read_bytes(), i
    assert not (tmp_path / "port" / f"obj.bin.{n}").exists()
    for i in (0, 3, 7, n - 1):
        os.unlink(f"{files['port']}.{i}")
    rc, out = run_tool(ec_tool.main, ["decode", f"plugin=gpu,device=cpu,{prof}",
                                      "4096", "all", str(files["port"])],
                       capsys)
    assert rc == 0, out
    got = (tmp_path / "port" / "obj.bin.decoded").read_bytes()
    assert got[:len(data)] == data
    assert not any(got[len(data):])


CRUSH_BUILD = ["--num-osds", "12", "host", "straw2", "3", "rack", "straw2",
               "2", "root", "straw2", "0"]


def test_crushtool_outputs_equal_jax_package(tmp_path, capsys):
    """Byte equality: the --build map written with -o, its decompiled
    dump, and the lines --test prints (mappings and utilization)."""
    ref = ref_tools()["crushtool"]
    maps = {}
    for who, main in (("port", crushtool.main), ("ref", ref.main)):
        maps[who] = str(tmp_path / f"{who}.json")
        assert run_tool(main, ["--build", "-o", maps[who], *CRUSH_BUILD],
                        capsys)[0] == 0
    assert open(maps["port"]).read() == open(maps["ref"]).read()
    for argv in (["-d", maps["port"]],
                 ["--test", "-i", maps["port"], "--num-rep", "3",
                  "--min-x", "0", "--max-x", "511", "--show-mappings",
                  "--show-utilization", "--show-bad-mappings"],
                 ["-c", maps["port"], "-o", str(tmp_path / "c.json")]):
        port_out = run_tool(crushtool.main, argv, capsys)
        ref_out = run_tool(ref.main, argv, capsys)
        assert port_out == ref_out, argv
        assert port_out[1].strip()


def test_osdmaptool_outputs_equal_jax_package(tmp_path, capsys):
    """Byte equality: the --createsimple map written with -o, --print,
    and the lines --test-map-pgs and --test-map-object print."""
    ref = ref_tools()["osdmaptool"]
    maps = {}
    for who, main in (("port", osdmaptool.main), ("ref", ref.main)):
        maps[who] = str(tmp_path / f"{who}.json")
        rc, out = run_tool(main, ["--createsimple", "13",
                                  "--with-default-pool", "-o", maps[who]],
                           capsys)
        assert rc == 0 and "writing epoch 2" in out
    assert open(maps["port"]).read() == open(maps["ref"]).read()
    for argv in (["--print", maps["port"]],
                 ["--test-map-pgs", "--pool", "1", maps["port"]],
                 ["--test-map-pgs", maps["port"]],
                 ["--test-map-object", "rbd_data.1", "--pool", "1",
                  maps["port"]]):
        port_out = run_tool(osdmaptool.main, argv, capsys)
        assert port_out == run_tool(ref.main, argv, capsys), argv
        assert port_out[1].strip()


def write_store(cluster_mod, ddir, store_kind):
    """A 3-OSD cluster of ``cluster_mod`` on ``store_kind`` stores under
    ``ddir``: a replicated object with an xattr and omap, and an object
    of a jerasure k=2 m=1 pool (shard objects); stopped after clean."""
    with cluster_mod.Cluster(n_osds=3, data_dir=ddir,
                             store_kind=store_kind) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 30)
        c.create_pool("rp", "replicated", size=3)
        c.create_ec_profile("ep", plugin="jerasure", k="2", m="1")
        c.create_pool("ec", "erasure", erasure_code_profile="ep")
        r = c.rados()
        rio, eio = r.open_ioctx("rp"), r.open_ioctx("ec")
        gen = np.random.default_rng(TOOLS_SEED)
        rio.write_full("robj", gen.integers(0, 256, 20000,
                                            dtype=np.uint8).tobytes())
        rio.setxattr("robj", "user.a", b"xv")
        rio.omap_set("robj", {"k1": b"v1", "k2": b"v2"})
        eio.write_full("eobj", gen.integers(0, 256, 12288,
                                            dtype=np.uint8).tobytes())
        c.wait_for_clean(60)


def tool_view(main, path, out, capsys):
    """Everything the tool prints of one store: --op list, meta-list and
    fsck, then dump, list-attrs and list-omap of every listed object and
    the bytes get-bytes exports of it into ``out``."""
    view = []
    for op in ("list", "meta-list", "fsck"):
        view.append(run_tool(main, ["--data-path", path, "--op", op],
                             capsys))
    for line in view[0][1].splitlines():
        coll, obj = json.loads(line)
        for cmd in ("dump", "list-attrs", "list-omap"):
            view.append(run_tool(main, ["--data-path", path, coll, obj, cmd],
                                 capsys))
        view.append(run_tool(main, ["--data-path", path, coll, obj,
                                    "get-bytes", out], capsys))
        with open(out, "rb") as f:
            view.append(f.read())
    return view


@pytest.mark.parametrize("store_kind", ["file", "block"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_objectstore_tool_reads_the_other_package_store(writer, store_kind,
                                                        tmp_path, capsys):
    """State carried across: a store that one package's cluster wrote
    reads the same through both packages' objectstore_tool, byte for
    byte, every OSD's store."""
    import ceph_tpu.cluster as ref_cluster
    import ceph_tpu_torch.cluster as port_cluster
    ddir = str(tmp_path / "cl")
    write_store(ref_cluster if writer == "jax" else port_cluster, ddir,
                store_kind)
    ref = ref_tools()["objectstore_tool"]
    objects = 0
    for osd in range(3):
        path = os.path.join(ddir, f"osd.{osd}")
        out = str(tmp_path / "export.bin")
        port_view = tool_view(objectstore_tool.main, path, out, capsys)
        assert port_view == tool_view(ref.main, path, out, capsys), osd
        assert all(v[0] == 0 for v in port_view if isinstance(v, tuple))
        objects += len(port_view[0][1].splitlines())
    # robj on 3 OSDs, eobj's 3 shards, and each PG's metadata objects
    assert objects >= 6


def test_ec_benchmark_kib_equals_jax_package(capsys):
    """The seconds/KiB line of both packages' benchmark for the same
    arguments: one line each, the same KiB."""
    ref = ref_tools()["ec_benchmark"]
    for argv in (["-S", str(1 << 20), "-i", "3", "-w", "encode"],
                 ["-S", str(1 << 20), "-i", "4", "-w", "decode", "-e",
                  "4"],
                 ["-S", str(300_000), "-i", "2", "-w", "decode", "-e", "2",
                  "--erasures-generation", "exhaustive"]):
        rc, out = run_tool(ec_benchmark.main, ["-p", "gpu", "-P",
                                               "k=8,m=4,device=cpu", *argv],
                           capsys)
        rc_ref, out_ref = run_tool(ref.main, ["-p", "tpu", "-P", "k=8,m=4",
                                              *argv], capsys)
        assert rc == rc_ref == 0
        (secs, kib), = [ln.split("\t") for ln in out.splitlines()]
        (_, kib_ref), = [ln.split("\t") for ln in out_ref.splitlines()]
        assert float(secs) > 0 and int(kib) == int(kib_ref) > 0, argv


# ---------------------------------------------------------- vstart


def wait_for_file(path, proc, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path) and open(path).read().strip():
            return open(path).read().strip()
        assert proc.poll() is None, proc.communicate()
        time.sleep(0.2)
    raise AssertionError(f"{path} not written in {timeout} s")


def test_vstart_process_serves_the_clis_and_exits_on_sigterm(tmp_path,
                                                             capsys):
    """``python -m ceph_tpu_torch.tools.vstart -e`` in its own process,
    its `gpu` k=2 m=1 pool on the CPU (``--device cpu``): the ceph and
    rados CLIs reach it over TCP, an object reads back, and SIGTERM
    ends it with exit code 0."""
    addr_file = str(tmp_path / "mon.addr")
    log = open(tmp_path / "vstart.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ceph_tpu_torch.tools.vstart", "-n", "3",
         "--ec-pool", "--device", "cpu", "--out-conf", addr_file],
        cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=REPO))
    try:
        mon = wait_for_file(addr_file, proc, 120)
        assert run_ceph(mon, "osd", "erasure-code-profile", "get",
                        "gpuprof") == 0
        prof = json.loads(capsys.readouterr().out)
        assert (prof["plugin"], prof["k"], prof["m"], prof["device"]) == \
            ("gpu", "2", "1", "cpu")
        src = tmp_path / "in.bin"
        src.write_bytes(os.urandom(100_000))
        dst = tmp_path / "out.bin"
        assert rados_cli.main(["-m", mon, "-p", "ecpool", "put", "o1",
                               str(src)]) == 0
        assert rados_cli.main(["-m", mon, "-p", "ecpool", "get", "o1",
                               str(dst)]) == 0
        assert dst.read_bytes() == src.read_bytes()
        assert run_ceph(mon, "status") == 0
        assert json.loads(capsys.readouterr().out)["osdmap"][
            "num_up_osds"] == 3
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        log.close()
    assert rc == 0, (tmp_path / "vstart.log").read_text()[-4000:]
    assert "vstart: 3 osds up" in (tmp_path / "vstart.log").read_text()

"""The daemonless file system in the port (ceph_tpu_torch.fs): a
hierarchy over a metadata pool and striped file data in a data pool.

Port twins of the 11 tests of tests/test_fs.py (reference analog:
src/test/libcephfs/), test_cli_put_replaces_whole_file and
test_cephfs_cli through the port's cephfs command-line tool
(ceph_tpu_torch.tools.cephfs_cli).  Then the slice held against the JAX
package: one seeded tree (directories, files, offset writes, truncates,
renames, unlinks) through FileSystem on a 3-OSD cluster of each
package, metadata replicated and data on a k=2 m=1 pool, with the
walk, every entry's type, size and bytes, and the data pool's
(object, size) list equal."""
import os

import numpy as np
import pytest

from ceph_tpu_torch.client.striper import Layout
from ceph_tpu_torch.cluster import Cluster
from ceph_tpu_torch.fs import FileSystem, FSError


@pytest.fixture(scope="module")
def cl():
    with Cluster(n_osds=3) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        c.create_pool("fsmeta", "replicated", size=2)
        c.create_ec_profile("fsp", plugin="jerasure", k="2", m="1")
        c.create_pool("fsdata", "erasure", erasure_code_profile="fsp")
        yield c


@pytest.fixture(scope="module")
def fs(cl):
    r = cl.rados()
    return FileSystem(r.open_ioctx("fsmeta"),
                      layout=Layout(stripe_unit=8 << 10,
                                    stripe_count=2,
                                    object_size=32 << 10))


def test_hierarchy_and_io(fs):
    fs.mkdir("/proj")
    fs.mkdir("/proj/src")
    data = os.urandom(150_000)           # spans many striped objects
    fs.write_file("/proj/src/main.bin", data)
    assert fs.read_file("/proj/src/main.bin") == data
    assert fs.read_file("/proj/src/main.bin", 1000, 140_000) == \
        data[140_000:141_000]
    names = [e["name"] for e in fs.listdir("/proj")]
    assert names == ["src"]
    st = fs.stat("/proj/src/main.bin")
    assert st["size"] == 150_000 and st["type"] == "file"
    assert fs.stat("/proj")["type"] == "dir"


def test_offset_write_and_truncate(fs):
    fs.write_file("/f1", b"hello world")
    fs.write_file("/f1", b"WORLD", 6)
    assert fs.read_file("/f1") == b"hello WORLD"
    fs.truncate("/f1", 5)
    assert fs.read_file("/f1") == b"hello"
    assert fs.stat("/f1")["size"] == 5


def test_errors(fs):
    with pytest.raises(FSError):
        fs.read_file("/nope")
    with pytest.raises(FSError):
        fs.mkdir("/proj")                # exists
    with pytest.raises(FSError):
        fs.listdir("/f1")                # not a dir
    with pytest.raises(FSError):
        fs.unlink("/proj")               # is a dir
    with pytest.raises(FSError):
        fs.rmdir("/proj")                # not empty
    with pytest.raises(FSError):
        fs.read_file("/a/../b")          # dotdot rejected


def test_rename_and_unlink(fs):
    fs.mkdir("/mv")
    fs.write_file("/mv/a.txt", b"content-a")
    fs.rename("/mv/a.txt", "/mv/b.txt")
    assert not fs.exists("/mv/a.txt")
    assert fs.read_file("/mv/b.txt") == b"content-a"
    # overwrite-rename unlinks the target
    fs.write_file("/mv/c.txt", b"content-c")
    fs.rename("/mv/c.txt", "/mv/b.txt")
    assert fs.read_file("/mv/b.txt") == b"content-c"
    fs.unlink("/mv/b.txt")
    fs.rmdir("/mv")
    assert not fs.exists("/mv")


def test_dir_rename(fs):
    fs.mkdir("/d1")
    fs.write_file("/d1/x", b"x")
    fs.rename("/d1", "/d2")
    assert fs.read_file("/d2/x") == b"x"
    assert not fs.exists("/d1")


def test_rename_edge_cases(fs):
    """POSIX edges: self-rename is a no-op; moving a directory into
    its own subtree is EINVAL (not silent orphaning)."""
    fs.mkdir("/re")
    fs.write_file("/re/f", b"keep me")
    fs.rename("/re/f", "/re/f")
    assert fs.read_file("/re/f") == b"keep me"
    fs.mkdir("/re/sub")
    with pytest.raises(FSError):
        fs.rename("/re", "/re/sub/inside")
    assert fs.exists("/re/sub")


def test_cli_put_replaces_whole_file(cl, tmp_path):
    """put then a smaller put must round-trip (no stale tail)."""
    from ceph_tpu_torch.tools import cephfs_cli
    host, port = cl.mon_addr
    base = ["-m", f"{host}:{port}", "--meta-pool", "fsmeta"]
    big = tmp_path / "big.bin"
    big.write_bytes(os.urandom(80_000))
    small = tmp_path / "small.bin"
    small.write_bytes(os.urandom(20_000))
    out = tmp_path / "round.bin"
    assert cephfs_cli.main([*base, "put", str(big), "/repl.bin"]) == 0
    assert cephfs_cli.main([*base, "put", str(small),
                            "/repl.bin"]) == 0
    assert cephfs_cli.main([*base, "get", "/repl.bin",
                            str(out)]) == 0
    assert out.read_bytes() == small.read_bytes()


def test_walk(fs):
    fs.mkdir("/w")
    fs.mkdir("/w/sub")
    fs.write_file("/w/f1", b"1")
    fs.write_file("/w/sub/f2", b"2")
    seen = {p: (d, f) for p, d, f in fs.walk("/w")}
    assert seen["/w"] == (["sub"], ["f1"])
    assert seen["/w/sub"] == ([], ["f2"])


def test_ec_data_pool(cl):
    """Metadata on replicated, data on EC — the reference's layout."""
    r = cl.rados()
    fs2 = FileSystem(r.open_ioctx("fsmeta"),
                     data=r.open_ioctx("fsdata"))
    payload = os.urandom(100_000)
    fs2.write_file("/ecfile", payload)
    assert fs2.read_file("/ecfile") == payload
    # data objects live in the EC pool, not the metadata pool
    data_objs = [o for o in r.open_ioctx("fsdata").list_objects()
                 if o.startswith("data.")]
    assert data_objs


def test_persistence_across_mounts(cl):
    """A second 'mount' (fresh FileSystem over fresh client) sees
    everything (no MDS session state to lose)."""
    r = cl.rados()
    fs2 = FileSystem(r.open_ioctx("fsmeta"))
    assert fs2.exists("/proj/src/main.bin")
    assert fs2.stat("/proj/src/main.bin")["size"] == 150_000


def test_cephfs_cli(cl, tmp_path, capsys):
    from ceph_tpu_torch.tools import cephfs_cli
    host, port = cl.mon_addr
    m = f"{host}:{port}"
    base = ["-m", m, "--meta-pool", "fsmeta"]
    assert cephfs_cli.main([*base, "mkdir", "/cli"]) == 0
    src = tmp_path / "in.bin"
    src.write_bytes(os.urandom(50_000))
    assert cephfs_cli.main([*base, "put", str(src),
                            "/cli/file.bin"]) == 0
    dst = tmp_path / "out.bin"
    assert cephfs_cli.main([*base, "get", "/cli/file.bin",
                            str(dst)]) == 0
    assert dst.read_bytes() == src.read_bytes()
    assert cephfs_cli.main([*base, "ls", "/cli"]) == 0
    assert "file.bin" in capsys.readouterr().out
    assert cephfs_cli.main([*base, "mv", "/cli/file.bin",
                            "/cli/rn.bin"]) == 0
    assert cephfs_cli.main([*base, "stat", "/cli/rn.bin"]) == 0
    assert "size=50000" in capsys.readouterr().out
    assert cephfs_cli.main([*base, "tree", "/"]) == 0
    capsys.readouterr()
    assert cephfs_cli.main([*base, "rm", "/cli/rn.bin"]) == 0
    assert cephfs_cli.main([*base, "rmdir", "/cli"]) == 0
    assert cephfs_cli.main([*base, "rm", "/cli/never"]) == 1
    capsys.readouterr()


# ------------------------------------------ the slice against the JAX package
FS_SEED = 20261019
FS_LAYOUT = dict(stripe_unit=8 << 10, stripe_count=2, object_size=32 << 10)


def fs_script():
    """A seeded tree: directories, files of drawn sizes, then writes at
    drawn offsets (some past the end), truncates, renames and unlinks.
    -> a list of (op, args) that a FileSystem or MDSClient runs."""
    rng = np.random.default_rng(FS_SEED)
    dirs = ["/d0", "/d1", "/d2", "/d0/s0", "/d1/s1", "/d1/s1/t"]
    ops = [("mkdir", (d,)) for d in dirs]
    files = []
    for i in range(12):
        path = f"{dirs[int(rng.integers(0, len(dirs)))]}/f{i}.bin"
        size = int(rng.integers(1, 200_000))
        files.append(path)
        ops.append(("write_file", (path, rng.integers(
            0, 256, size, dtype=np.uint8).tobytes(), 0)))
    for _ in range(5):
        path = files[int(rng.integers(0, len(files)))]
        ops.append(("write_file", (path, rng.integers(
            0, 256, int(rng.integers(1, 40_000)), dtype=np.uint8).tobytes(),
            int(rng.integers(0, 220_000)))))
    for i in (1, 4):
        ops.append(("truncate", (files[i], int(rng.integers(0, 50_000)))))
    ops += [("rename", (files[2], "/d0/renamed.bin")),
            ("rename", (files[3], files[5])),
            ("unlink", (files[6],)),
            ("unlink", (files[7],)),
            ("rename", ("/d2", "/d3"))]
    return ops


def fs_tree(fs, path="/"):
    """(path, type, size, bytes or None) of every entry under ``path``,
    depth first in listing order."""
    out = []
    for e in fs.listdir(path):
        sub = path.rstrip("/") + "/" + e["name"]
        st = fs.stat(sub)
        data = fs.read_file(sub) if st["type"] == "file" else None
        out.append((sub, st["type"], st["size"], data))
        if st["type"] == "dir":
            out += fs_tree(fs, sub)
    return out


def ec_fs_cluster(cluster_mod, profile):
    """A 3-OSD cluster of ``cluster_mod``'s package with a replicated
    metadata pool and a k=2 m=1 data pool with ``allow_ec_overwrites``
    (the reference's layout, tests/test_fs.py)."""
    c = cluster_mod.Cluster(n_osds=3)
    c.start()
    for i in range(3):
        c.wait_for_osd_up(i, 30)
    c.create_pool("eqmeta", "replicated", size=2)
    c.create_ec_profile("eqfs", **profile)
    c.create_pool("eqdata", "erasure", erasure_code_profile="eqfs")
    ret, rs, _ = c.mon_command({"prefix": "osd pool set", "pool": "eqdata",
                                "var": "allow_ec_overwrites",
                                "val": "true"})
    assert ret == 0, rs
    return c


def run_fs_script(fs, data_io):
    """The script through ``fs``; -> (tree, the sorted (name, size) of
    the data pool's objects)."""
    for op, args in fs_script():
        getattr(fs, op)(*args)
    return fs_tree(fs), sorted((o, data_io.stat(o)[0])
                               for o in data_io.list_objects())


GPU_K2M1 = {"plugin": "gpu", "k": "2", "m": "1", "device": "cpu"}
TPU_K2M1 = {"plugin": "tpu", "k": "2", "m": "1"}


def _fs_on(cluster_mod, fs_mod, striper_mod, profile):
    c = ec_fs_cluster(cluster_mod, profile)
    try:
        r = c.rados(timeout=30)
        r.wait_for_epoch(c.mon.osdmap.epoch, 10)
        data = r.open_ioctx("eqdata")
        fs = fs_mod.FileSystem(r.open_ioctx("eqmeta"), data=data,
                               layout=striper_mod.Layout(**FS_LAYOUT))
        return run_fs_script(fs, data)
    finally:
        c.stop()


def test_fs_script_equals_jax_package():
    from ceph_tpu import cluster as ref_cluster
    from ceph_tpu import fs as ref_fs
    from ceph_tpu.client import striper as ref_striper
    from ceph_tpu_torch import cluster as port_cluster
    from ceph_tpu_torch import fs as port_fs
    from ceph_tpu_torch.client import striper as port_striper
    port_tree, port_objs = _fs_on(port_cluster, port_fs, port_striper,
                                  GPU_K2M1)
    ref_tree, ref_objs = _fs_on(ref_cluster, ref_fs, ref_striper, TPU_K2M1)
    assert [t[:3] for t in port_tree] == [t[:3] for t in ref_tree]
    for p, r in zip(port_tree, ref_tree):
        assert p[3] == r[3], p[:3]
    assert port_objs == ref_objs
    # what the script was written for: the renamed directory, the
    # rename over an existing file, the unlinked files' data gone
    paths = {t[0] for t in port_tree}
    assert "/d3" in paths and "/d2" not in paths
    assert "/d0/renamed.bin" in paths
    assert all(o.startswith("data.") for o, _ in port_objs)
    assert len({o.rsplit(".", 1)[0] for o, _ in port_objs}) == \
        sum(1 for t in port_tree if t[1] == "file" and t[2])

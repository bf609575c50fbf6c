"""Port twins of the JAX package's mesh tests (tests/test_parallel.py),
and the port's sharded functions held against the JAX package's.

Both packages shard over 8 devices, dp=4 x sp=2: the JAX package over
the conftest's 8 virtual CPU devices, the port over 8 logical CPU
devices (CEPH_TPU_TORCH_FORCE_DEVICE_COUNT=8, set by the fixture only),
where each block runs its kernel's plain version.  The same seeded numpy
data goes through both; parity and digest must be equal."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ceph_tpu.ec import registry as jax_registry
from ceph_tpu.ops.matrix import (matrix_to_bitmatrix,
                                 reed_sol_vandermonde_coding_matrix)
from ceph_tpu.parallel import mesh as jmesh
from ceph_tpu_torch.ec import registry as ecreg
from ceph_tpu_torch.ec.plugins import gpu
from ceph_tpu_torch.ops.torch_engine import TorchBackend
from ceph_tpu_torch.osd.batcher import EncodeBatcher
from ceph_tpu_torch.parallel import dryrun
from ceph_tpu_torch.parallel import mesh as pmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reset():
    """Forget every mesh the variable built: the module caches, the
    shared CPU backend's resolved mesh (a changed conf makes it probe
    again) and its mesh_build records, and the batcher's learner."""
    pmesh.reset()
    be = gpu.shared_backend("cpu")
    be.configure_mesh(1, 0)
    be.configure_mesh(0, 0)
    be.mesh_events.clear()
    EncodeBatcher.reset_learning()


@pytest.fixture
def eight(monkeypatch):
    """8 logical CPU devices for this test alone: the variable is set by
    monkeypatch and every cache that saw it is reset on both sides, so
    no later test of this worker lands on the sharded path."""
    monkeypatch.setenv(pmesh.FORCE_DEVICE_COUNT, "8")
    _reset()
    yield
    _reset()


def jerasure(k, m):
    return ecreg.instance().factory("jerasure", {"k": str(k), "m": str(m)})


def bitmatrix(k, m, w):
    return matrix_to_bitmatrix(
        reed_sol_vandermonde_coding_matrix(k, m, w), w).astype(np.int8)


def data_of(seed, batch, k, L):
    return np.random.default_rng(seed).integers(0, 256, (batch, k, L),
                                                dtype=np.uint8)


# ---------------------------------------------------------------------
# twins of tests/test_parallel.py
# ---------------------------------------------------------------------
def test_virtual_devices_present(eight):
    assert len(pmesh.visible_devices("cpu")) == 8
    assert len(jax.devices()) == 8


def test_sharded_encode_bit_exact(eight):
    k, m, w = 8, 4, 8
    mesh = pmesh.make_mesh(8, device="cpu")
    assert mesh.devices.size == 8
    B = bitmatrix(k, m, w)
    data = data_of(21, 16, k, 1024)  # batch % dp == 0, L % sp == 0

    fn = pmesh.sharded_encode_fn(mesh, w)
    parity, digest = fn(B, pmesh.shard_batch(mesh, data))
    parity = np.asarray(parity)

    cpu = jerasure(k, m)
    for b in range(16):
        assert np.array_equal(parity[b], cpu.core.encode(data[b]))

    # digest is a deterministic function of the data
    _, digest2 = fn(B, pmesh.shard_batch(mesh, data))
    assert int(digest) == int(digest2)
    data2 = data.copy()
    data2[0, 0, 0] ^= 1
    _, digest3 = fn(B, pmesh.shard_batch(mesh, data2))
    assert int(digest) != int(digest3)


def test_mesh_factor(eight):
    mesh = pmesh.make_mesh(8, device="cpu")
    assert mesh.shape["dp"] * mesh.shape["sp"] == 8


def test_sharded_gf8_fast_path_bit_exact(eight):
    k, m, w = 4, 2, 8
    mesh = pmesh.make_mesh(8, device="cpu")
    Mgf = reed_sol_vandermonde_coding_matrix(k, m, w)
    B = matrix_to_bitmatrix(Mgf, w).astype(np.int8)
    data = data_of(3, 2 * mesh.shape["dp"], k, 128 * mesh.shape["sp"])
    slow = pmesh.sharded_encode_fn(mesh, w)
    p1, _ = slow(B, pmesh.shard_batch(mesh, data))
    fast = pmesh.sharded_encode_gf8_fn(mesh, Mgf)
    p2, d2 = fast(pmesh.shard_batch(mesh, data))
    assert np.array_equal(np.asarray(p1), np.asarray(p2))
    _, d2b = fast(pmesh.shard_batch(mesh, data))
    assert int(d2) == int(d2b)
    data2 = data.copy()
    data2[0, 0, 0] ^= 1
    _, d2c = fast(pmesh.shard_batch(mesh, data2))
    assert int(d2) != int(d2c)
    cpu = jerasure(k, m)
    for b in range(data.shape[0]):
        assert np.array_equal(np.asarray(p2)[b], cpu.core.encode(data[b]))


# ---------------------------------------------------------------------
# the port's mesh against the JAX package's, dp=4 x sp=2
# ---------------------------------------------------------------------
@pytest.fixture
def meshes(eight):
    jm, pm = jmesh.make_mesh(8), pmesh.make_mesh(8, device="cpu")
    assert pmesh.mesh_info(pm) == jmesh.mesh_info(jm)
    assert pmesh.mesh_info(pm)["dp"] == 4
    return jm, pm


@pytest.mark.parametrize("w", [8, 16, 32])
def test_sharded_encode_fn_equals_jax_package(meshes, w):
    jm, pm = meshes
    k, m = 5, 3
    B = bitmatrix(k, m, w)
    data = data_of(100 + w, 8, k, 1024)
    pj, dj = jmesh.sharded_encode_fn(jm, w)(B, jmesh.shard_batch(jm, data))
    pt, dt = pmesh.sharded_encode_fn(pm, w)(B, pmesh.shard_batch(pm, data))
    assert np.array_equal(np.asarray(pt), np.asarray(pj))
    assert int(dt) == int(dj)


@pytest.mark.parametrize("w", [8, 16, 32])
def test_sharded_apply_fn_equals_jax_package(meshes, w):
    jm, pm = meshes
    k, m = 4, 2
    B = bitmatrix(k, m, w)
    data = data_of(200 + w, 4, k, 512)
    pj = jmesh.sharded_apply_fn(jm, w)(B, jmesh.shard_batch(jm, data))
    pt = pmesh.sharded_apply_fn(pm, w)(B, pmesh.shard_batch(pm, data))
    assert np.array_equal(np.asarray(pt), np.asarray(pj))
    # a replicated operand gives the same parity as a host bitmatrix
    rep = pmesh.Replicated(pm, B, w)
    assert rep.nbytes > 0
    again = pmesh.sharded_apply_fn(pm, w)(rep, pmesh.shard_batch(pm, data))
    assert np.array_equal(np.asarray(again), np.asarray(pj))


def test_sharded_apply_refuses_blocks_of_partial_words(meshes):
    _, pm = meshes
    B = bitmatrix(2, 1, 32)
    # 4 bytes a word, 2 sp blocks of 258 bytes: no whole words
    data = data_of(5, 4, 2, 516)
    with pytest.raises(ValueError, match="whole number"):
        pmesh.sharded_apply_fn(pm, 32)(B, pmesh.shard_batch(pm, data))


@pytest.mark.parametrize("with_digest", [True, False])
def test_sharded_encode_gf8_fn_equals_jax_package(meshes, with_digest):
    jm, pm = meshes
    Mgf = reed_sol_vandermonde_coding_matrix(8, 4, 8)
    data = data_of(31, 8, 8, 768)
    fj = jmesh.sharded_encode_gf8_fn(jm, Mgf, with_digest=with_digest)
    ft = pmesh.sharded_encode_gf8_fn(pm, Mgf, with_digest=with_digest)
    oj = fj(jmesh.shard_batch(jm, data))
    ot = ft(pmesh.shard_batch(pm, data))
    if with_digest:
        (pj, dj), (pt, dt) = oj, ot
        assert int(dt) == int(dj)
    else:
        pj, pt = oj, ot
    assert np.array_equal(np.asarray(pt), np.asarray(pj))


def test_sharded_rows_fn_equals_jax_package(meshes):
    """Encode rows and an erasure signature's recovery rows, as the
    backends dispatch them."""
    jm, pm = meshes
    from ceph_tpu_torch.ops.engine import CodecCore
    Mgf = reed_sol_vandermonde_coding_matrix(8, 4, 8)
    core = CodecCore(8, 4, 8, coding_matrix=Mgf)
    rows_gf, _ = core._recovery_rows((0, 2, 3, 4, 6, 7, 8, 10),
                                     (1, 5, 9, 11))
    data = data_of(41, 4, 8, 256)
    for rows in (Mgf, rows_gf):
        pj = jmesh.sharded_rows_fn(jm, rows)(jmesh.shard_batch(jm, data))
        pt = pmesh.sharded_rows_fn(pm, rows, donate=True)(
            pmesh.shard_batch(pm, data))
        assert np.array_equal(np.asarray(pt), np.asarray(pj))


def test_shard_batch_blocks_equal_jax_shards(meshes):
    """Block (i, j) holds what the JAX package places on the device at
    mesh position (i, j), as its own contiguous tensor."""
    jm, pm = meshes
    data = data_of(51, 8, 3, 512)
    js = jmesh.shard_batch(jm, data)
    by_id = {s.device.id: np.asarray(s.data) for s in js.addressable_shards}
    ts = pmesh.shard_batch(pm, data)
    for i in range(4):
        for j in range(2):
            blk = ts.blocks[i][j]
            assert blk.is_contiguous()
            assert np.array_equal(blk.numpy(),
                                  by_id[jm.devices[i, j].id])
            assert pm.devices[i, j].id == jm.devices[i, j].id
    assert np.array_equal(np.asarray(ts), data)
    with pytest.raises(ValueError):
        pmesh.shard_batch(pm, data[:5])


def test_shared_encoder_equals_jax_package(eight):
    """The process-wide encoder pads a batch of 5 to a dp multiple; packet
    and w=16 codecs get none, as in the JAX package."""
    codec = ecreg.instance().factory("gpu", {"k": "4", "m": "2",
                                             "device": "cpu"})
    jcodec = jax_registry.instance().factory("tpu", {"k": "4", "m": "2"})
    enc, jenc = pmesh.shared_encoder(codec), jmesh.shared_encoder(jcodec)
    assert enc is not None and jenc is not None
    assert pmesh.shared_encoder(codec) is enc
    assert (enc.dp, enc.sp) == (jenc.dp, jenc.sp) == (4, 2)
    data = data_of(61, 5, 4, 256)
    out = enc.encode_async(data).wait()
    assert np.array_equal(out, jenc.encode_async(data).wait())
    assert np.array_equal(out, np.stack([jerasure(4, 2).core.encode(d)
                                         for d in data]))
    assert enc.encode_async(data[..., :255]) is None
    for profile in ({"technique": "cauchy_good", "packetsize": "32"},
                    {"w": "16"}):
        other = ecreg.instance().factory("gpu", {
            "k": "4", "m": "2", "device": "cpu", **profile})
        assert pmesh.shared_encoder(other) is None
    assert pmesh.default_mesh("cpu") is pmesh.default_mesh("cpu")
    pmesh.reset()
    assert pmesh._ENCODERS == {} and pmesh._DEFAULT_MESH == {}


@pytest.mark.parametrize("n,sp", [(8, None), (8, 4), (8, 1), (6, None),
                                  (3, None), (2, 2)])
def test_make_mesh_equals_jax_package(eight, n, sp):
    assert pmesh.mesh_info(pmesh.make_mesh(n, sp=sp, device="cpu")) == \
        jmesh.mesh_info(jmesh.make_mesh(n, sp=sp))


def test_make_mesh_refuses_sp_that_does_not_divide(eight):
    with pytest.raises(ValueError):
        jmesh.make_mesh(8, sp=3)
    with pytest.raises(ValueError, match="does not divide"):
        pmesh.make_mesh(8, sp=3, device="cpu")
    # the knobs clamp to the visible count, and one device is no mesh
    assert pmesh.mesh_info(pmesh.resolve_mesh(64, device="cpu")) == \
        jmesh.mesh_info(jmesh.resolve_mesh(64))
    assert pmesh.resolve_mesh(1, device="cpu") is None
    assert jmesh.resolve_mesh(1) is None


@pytest.mark.parametrize("s", [0, 1, 255, 2**32 - 1, 2**32, 2**32 + 7,
                               17_123_456_789, 2**40 - 3])
def test_fold_digest_wraps_as_uint32(s):
    """The JAX package sums in uint32 and multiplies in uint32; the port
    folds an int64 sum (a block's parity sum passes 2^32 at the headline
    shape) to the same value."""
    import torch
    want = int(jmesh._fold_digest(jnp.asarray(s % 2**32, jnp.uint32)))
    assert int(pmesh._fold_digest(torch.tensor(s))) == want


def test_no_mesh_without_a_forced_count(monkeypatch):
    """One CPU, no variable: no mesh, and the backend says so."""
    monkeypatch.delenv(pmesh.FORCE_DEVICE_COUNT, raising=False)
    assert pmesh.resolve_mesh(device="cpu") is None
    assert len(pmesh.visible_devices("cpu")) == 1
    assert TorchBackend("cpu").mesh_info() is None
    for bad in ("0", "-2", "eight"):
        monkeypatch.setenv(pmesh.FORCE_DEVICE_COUNT, bad)
        with pytest.raises(ValueError, match=pmesh.FORCE_DEVICE_COUNT):
            pmesh.visible_devices("cpu")


def test_entry_equals_jax_package():
    import torch
    sys.path.insert(0, REPO)
    import __graft_entry__
    jfn, jargs = __graft_entry__.entry()
    fn, args = dryrun.entry("cpu")
    assert np.array_equal(np.asarray(args[1]), jargs[1])
    out = fn(*args)
    assert isinstance(out, torch.Tensor) and out.shape == (4, 4, 512)
    assert np.array_equal(out.numpy(), np.asarray(jax.jit(jfn)(*jargs)))


def test_dryrun_multichip_in_process(eight, capsys):
    dryrun.dryrun_multichip(8, "cpu")
    assert "dryrun_multichip OK: mesh dp=4 sp=2" in capsys.readouterr().out


def test_dryrun_command_forces_its_own_devices():
    """``python -m ceph_tpu_torch.parallel.dryrun 4 --device cpu`` with
    no variable set sees one CPU, runs itself in a child with 4 logical
    devices and prints the child's verdict."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop(pmesh.FORCE_DEVICE_COUNT, None)
    res = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.parallel.dryrun", "4",
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=280)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "dryrun_multichip OK: mesh dp=2 sp=2" in res.stdout

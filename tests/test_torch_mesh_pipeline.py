"""Port twins of the JAX package's mesh pipeline tests
(tests/test_mesh_pipeline.py) and of
tests/test_batcher.py::test_dispatch_rides_mesh_on_multidevice_host.

The production batcher dispatch on a dp=4 x sp=2 mesh of 8 logical CPU
devices: CEPH_TPU_TORCH_FORCE_DEVICE_COUNT=8, the port's counterpart of
XLA's --xla_force_host_platform_device_count, set by the fixture for
each test alone (or, in the recipe test, by a child interpreter itself),
so TorchBackend._staged_put shards every byte-code group and applies
each block on its own logical device (B1's plain version here).
Covered: encode and decode byte-exact against the jerasure oracle across
geometries and erasure signatures, dp padding, per-device ledger lanes,
the single-device and bad-conf edges, and the dispatch held against the
JAX package's on its 8 virtual devices."""
import itertools
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from ceph_tpu.ec import registry as jax_registry
from ceph_tpu_torch.ec import registry as ecreg
from ceph_tpu_torch.ec.plugins import gpu
from ceph_tpu_torch.osd import ecutil
from ceph_tpu_torch.osd.batcher import EncodeBatcher
from ceph_tpu_torch.parallel import mesh as pmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_codec(k, m):
    return ecreg.instance().factory(
        "gpu", {"k": str(k), "m": str(m), "technique": "reed_sol_van",
                "device": "cpu"})


def make_cpu(k, m):
    return ecreg.instance().factory(
        "jerasure", {"k": str(k), "m": str(m),
                     "technique": "reed_sol_van"})


def oracle(k, m, data):
    """Parity [B, m, L] of data [B, k, L] by jerasure, a stripe at a
    time."""
    cpu = make_cpu(k, m)
    return np.stack([cpu.core.encode(d) for d in data])


def make_batcher(**over):
    conf = {"ec_tpu_batch_stripes": 1024,
            "ec_tpu_queue_window_us": 1000}
    conf.update(over)
    EncodeBatcher.reset_learning()
    return EncodeBatcher(conf)


def _reset(be):
    """Forget every mesh the variable built: the module caches, the
    backend's resolved mesh (a changed conf makes it probe again) and
    its mesh_build records, and the batcher's per-shape learner."""
    pmesh.reset()
    be.configure_mesh(1, 0)
    be.configure_mesh(0, 0)
    be.mesh_events.clear()
    EncodeBatcher.reset_learning()


@pytest.fixture
def backend(monkeypatch):
    """The shared CPU TorchBackend over 8 logical devices, its mesh reset
    to auto before AND after each test; the variable comes and goes with
    the test (monkeypatch), so the rest of the worker never sees it."""
    monkeypatch.setenv(pmesh.FORCE_DEVICE_COUNT, "8")
    be = gpu.shared_backend("cpu")
    _reset(be)
    yield be
    _reset(be)


def submit_and_wait(bat, codec, sinfo, data):
    got, ev = {}, threading.Event()
    try:
        bat.submit(codec, sinfo, data,
                   lambda ch: (got.update(ch or {}), ev.set()))
        assert ev.wait(120)
    finally:
        bat.stop()
    return got


# ---------------------------------------------------------------------
# mesh resolution
# ---------------------------------------------------------------------
def test_mesh_active_by_default_on_8_devices(backend):
    info = backend.mesh_info()
    assert info is not None
    assert info["dp"] == 4 and info["sp"] == 2
    assert info["n_devices"] == 8
    assert info["device_ids"] == list(range(8))
    assert any(ev.get("event") == "mesh_build"
               for ev in backend.mesh_events)


def test_single_device_mesh_is_no_mesh(backend):
    """n=1 resolves to no mesh: mesh_info is None and dispatch takes the
    single-device path, byte-identical to the mesh path and the oracle.
    (The JAX package's twin compares the synchronous encode_batch, which
    never shards; here the async entry, which does.)"""
    assert pmesh.resolve_mesh(1, device="cpu") is None
    codec = make_codec(4, 2)
    data = np.random.default_rng(3).integers(0, 256, (5, 4, 512),
                                             dtype=np.uint8)
    backend.configure_mesh(0, 0)
    ab = codec.encode_batch_async(data)
    mesh_out = ab.wait()
    assert len(ab.ledgers) == 8
    backend.configure_mesh(1, 0)
    assert backend.mesh_info() is None
    ab = codec.encode_batch_async(data)
    single_out = ab.wait()
    assert ab.ledgers is None
    assert np.array_equal(mesh_out, single_out)
    assert np.array_equal(codec.encode_batch(data), single_out)
    assert np.array_equal(single_out, oracle(4, 2, data))


def test_forced_device_count_clamps_to_visible(backend):
    backend.configure_mesh(64, 0)
    info = backend.mesh_info()
    assert info is not None and info["n_devices"] == 8


def test_bad_explicit_sp_raises_at_prewarm_not_dispatch(backend):
    # sp=3 does not divide 8 devices: the mesh itself cannot build
    backend.configure_mesh(8, 3)
    with pytest.raises(ValueError, match="ec_tpu_mesh"):
        backend.prewarm_geometry(8, 4096, batches=(4,))
    # sp=5 divides a forced 5-device mesh but not the padded chunk
    # (multiples of 128): caught at prewarm with the conf knob named
    backend.configure_mesh(5, 5)
    with pytest.raises(ValueError, match="ec_tpu_mesh_sp"):
        backend.prewarm_geometry(8, 4096, batches=(4,))


def test_auto_sp_that_cannot_split_serves_single_device(backend,
                                                       monkeypatch):
    """An auto sp that cannot split the padded chunk serves that
    dispatch unsharded (the JAX backend's one route change), a length it
    splits rides the mesh, and packet codes never stage through it."""
    monkeypatch.setenv(pmesh.FORCE_DEVICE_COUNT, "9")
    backend.configure_mesh(9, 0)            # 9 devices: dp=3 x sp=3
    assert (backend.mesh_info()["dp"], backend.mesh_info()["sp"]) == (3, 3)
    codec = make_codec(2, 1)
    rng = np.random.default_rng(9)
    for L, lanes in ((200, None), (384, 9)):   # padded 256, 384
        data = rng.integers(0, 256, (4, 2, L), dtype=np.uint8)
        ab = codec.encode_batch_async(data)
        assert np.array_equal(ab.wait(), oracle(2, 1, data))
        assert (ab.ledgers and len(ab.ledgers)) == lanes
        backend.prewarm_geometry(2, L, batches=(4,))   # auto: no raise
    pcodec = ecreg.instance().factory("gpu", {
        "k": "4", "m": "2", "technique": "cauchy_good",
        "packetsize": "32", "device": "cpu"})
    pdata = rng.integers(0, 256, (4, 4, 768), dtype=np.uint8)
    ab = pcodec.encode_batch_async(pdata)
    assert np.array_equal(ab.wait(), pcodec.encode_batch(pdata))
    assert ab.ledgers is None


# ---------------------------------------------------------------------
# batcher-routed bit-exactness through the mesh
# ---------------------------------------------------------------------
@pytest.mark.parametrize("k,m", [(8, 4), (4, 2), (2, 1)])
@pytest.mark.parametrize("stripes", [1, 3, 5, 16])
def test_batcher_encode_bit_exact_with_dp_padding(backend, k, m,
                                                  stripes):
    codec = make_codec(k, m)
    assert backend.mesh_info() is not None
    L = 512
    sinfo = ecutil.StripeInfo(k, k * L)
    rng = np.random.default_rng(100 + stripes)
    data = rng.integers(0, 256, (stripes, k, L),
                        dtype=np.uint8).tobytes()
    got = submit_and_wait(make_batcher(ec_tpu_min_device_bytes=1), codec,
                          sinfo, data)
    ref = ecutil.encode(sinfo, make_cpu(k, m), data)
    assert set(got) == set(ref)
    for s in ref:
        assert bytes(got[s]) == bytes(ref[s]), \
            f"k={k} m={m} stripes={stripes} shard {s}"


@pytest.mark.parametrize("k,m", [(8, 4), (4, 2)])
def test_mesh_decode_bit_exact_every_signature(backend, k, m):
    codec = make_codec(k, m)
    assert backend.mesh_info() is not None
    cs = 256
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (5, k, cs), dtype=np.uint8)
    parity = codec.encode_batch(data)
    shards = {i: data[:, i] for i in range(k)}
    shards.update({k + e: parity[:, e] for e in range(m)})
    n = k + m
    sigs = [frozenset(c) for c in itertools.combinations(range(n), 1)]
    sigs += [frozenset(c) for c in itertools.combinations(range(n), 2)]
    for erased in sigs:
        present = {i: shards[i] for i in range(n) if i not in erased}
        h = codec.decode_batch_async(present, cs)
        rec = h.wait()
        assert len(h.ledgers) == 8
        for e in sorted(erased):
            assert np.array_equal(rec[e], shards[e]), \
                f"k={k} m={m} erased={sorted(erased)} shard {e}"


@pytest.mark.parametrize("stripes", [1, 3])
def test_mesh_decode_of_small_batches_equals_jax_package(backend, stripes):
    """Batches of 1 and 3 stripes (dp padding of 3 and 1 rows): every 1-
    and 2-erasure decode through the mesh equals jerasure and the JAX
    package's decode through its own dp=4 x sp=2 mesh."""
    k, m, cs = 4, 2, 256
    codec = make_codec(k, m)
    jcodec = jax_registry.instance().factory(
        "tpu", {"k": str(k), "m": str(m), "technique": "reed_sol_van"})
    assert jcodec.core.backend.mesh_info() == backend.mesh_info()
    data = np.random.default_rng(stripes).integers(
        0, 256, (stripes, k, cs), dtype=np.uint8)
    parity = oracle(k, m, data)
    shards = {i: data[:, i] for i in range(k)}
    shards.update({k + e: parity[:, e] for e in range(m)})
    n = k + m
    for r in (1, 2):
        for erased in itertools.combinations(range(n), r):
            present = {i: shards[i] for i in range(n) if i not in erased}
            rec = codec.decode_batch_async(present, cs).wait()
            jrec = jcodec.decode_batch_async(present, cs).wait()
            for e in erased:
                assert np.array_equal(rec[e], shards[e]), (erased, e)
                assert np.array_equal(rec[e], np.asarray(jrec[e]))


def test_mesh_vs_single_chip_decode_identical(backend):
    codec = make_codec(8, 4)
    cs = 512
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, (6, 8, cs), dtype=np.uint8)
    parity = codec.encode_batch(data)
    shards = {i: data[:, i] for i in range(8)}
    shards.update({8 + e: parity[:, e] for e in range(4)})
    present = {i: shards[i] for i in range(12) if i not in (0, 9)}
    backend.configure_mesh(0, 0)
    rec_mesh = codec.decode_batch_async(present, cs).wait()
    backend.configure_mesh(1, 0)
    rec_one = codec.decode_batch_async(present, cs).wait()
    for e in (0, 9):
        assert np.array_equal(rec_mesh[e], rec_one[e])
        assert np.array_equal(rec_mesh[e], shards[e])


def test_async_entries_equal_jax_package(backend):
    """Encode, the 4-erasure decode and the 2-column delta through both
    packages' meshes: the same bytes and one ledger lane per device."""
    codec = make_codec(8, 4)
    jcodec = jax_registry.instance().factory(
        "tpu", {"k": "8", "m": "4", "technique": "reed_sol_van"})
    rng = np.random.default_rng(23)
    data = rng.integers(0, 256, (5, 8, 640), dtype=np.uint8)
    ab, jab = codec.encode_batch_async(data), jcodec.encode_batch_async(data)
    parity = ab.wait()
    assert np.array_equal(parity, np.asarray(jab.wait()))
    assert [led["device"] for led in ab.ledgers] == \
        [led["device"] for led in jab.ledgers] == list(range(8))
    assert sum(led["bytes"] for led in ab.ledgers) == parity.nbytes
    present = {i: (data[:, i] if i < 8 else parity[:, i - 8])
               for i in range(12) if i not in (1, 5, 9, 11)}
    rec = codec.decode_batch_async(present, 640).wait()
    jrec = jcodec.decode_batch_async(present, 640).wait()
    for e in (1, 5, 9, 11):
        assert np.array_equal(rec[e], np.asarray(jrec[e]))
    delta = rng.integers(0, 256, (5, 2, 640), dtype=np.uint8)
    dpar = codec.delta_encode_batch_async(delta, (2, 6)).wait()
    assert np.array_equal(dpar, np.asarray(
        jcodec.delta_encode_batch_async(delta, (2, 6)).wait()))
    changed = data.copy()
    changed[:, [2, 6]] ^= delta
    assert np.array_equal(parity ^ dpar, codec.encode_batch(changed))


# ---------------------------------------------------------------------
# per-device observability
# ---------------------------------------------------------------------
def test_per_device_ledger_lanes_and_dump(backend):
    from ceph_tpu_torch.utils.perf import PerfCountersCollection
    codec = make_codec(8, 4)
    assert backend.mesh_info() is not None
    L = 512
    sinfo = ecutil.StripeInfo(8, 8 * L)
    coll = PerfCountersCollection()
    EncodeBatcher.reset_learning()
    bat = EncodeBatcher({"ec_tpu_batch_stripes": 1024,
                         "ec_tpu_queue_window_us": 1000,
                         "ec_tpu_min_device_bytes": 1},
                        perf_coll=coll)
    rng = np.random.default_rng(13)
    data = rng.integers(0, 256, (8, 8, L), dtype=np.uint8).tobytes()
    got, ev = {}, threading.Event()
    try:
        bat.submit(codec, sinfo, data,
                   lambda ch: (got.update(ch or {}), ev.set()))
        assert ev.wait(120)
        recent = bat.ledger_accum.recent()
        lanes = sorted({int(led.get("device", -1)) for led in recent
                        if int(led.get("device", -1)) >= 0})
        assert lanes == list(range(8)), lanes
        dump = bat.device_dump()
        assert dump["mesh"] is not None
        assert dump["mesh"]["dp"] == 4 and dump["mesh"]["sp"] == 2
        assert sorted(dump["ledger"]["overlap"]["devices"]) == \
            list(range(8))
        dp = bat.dperf
        assert dp.get("mesh_dp") == 4 and dp.get("mesh_sp") == 2
        assert dp.get("mesh_devices") == 8
        sys.path.insert(0, REPO)
        from tools.trace_export import export_bundles
        trace = export_bundles([{"daemon": "osd.0",
                                 "device": bat.device_trace_block()}])
        names = {e["args"]["name"]
                 for e in trace["traceEvents"]
                 if e.get("ph") == "M" and e["name"] == "thread_name"}
        for d in range(8):
            assert any(n.startswith(f"device{d} ") for n in names), \
                f"no device{d} lane in {sorted(names)}"
    finally:
        bat.stop()


def test_per_mesh_shape_learner_keying():
    EncodeBatcher.reset_learning()
    EncodeBatcher._rekey_mesh((4, 2))
    EncodeBatcher._h2d_bps = 123.0
    EncodeBatcher._min_device_bytes = 456.0
    EncodeBatcher._rekey_mesh(None)          # to single-device: fresh
    assert EncodeBatcher._mesh_key is None
    EncodeBatcher._h2d_bps = 7.0
    EncodeBatcher._rekey_mesh((4, 2))        # back: restored
    assert EncodeBatcher._h2d_bps == 123.0
    assert EncodeBatcher._min_device_bytes == 456.0
    EncodeBatcher._rekey_mesh(None)
    assert EncodeBatcher._h2d_bps == 7.0
    EncodeBatcher.reset_learning()
    assert EncodeBatcher._mesh_state == {}


# ---------------------------------------------------------------------
# twin of tests/test_batcher.py::test_dispatch_rides_mesh_on_multidevice_host
# ---------------------------------------------------------------------
def test_dispatch_rides_mesh_on_multidevice_host(backend):
    """On a host of 8 (logical) devices the batcher's production dispatch
    shards over the mesh inside the backend, byte-exact with the
    synchronous path, batches needing dp padding included, and wait()
    fans the phase ledger out into one lane a device."""
    codec = make_codec(2, 1)
    assert codec.core.backend is backend
    info = backend.mesh_info()
    assert info is not None, "multi-device host must resolve a mesh"
    assert info["dp"] * info["sp"] == info["n_devices"] == 8
    probe = np.zeros((5, 2, 256), dtype=np.uint8)
    ab = codec.encode_batch_async(probe)
    assert ab._mesh_device_ids == info["device_ids"]
    ab.wait()
    assert ab.ledgers is not None and len(ab.ledgers) == 8
    assert sorted(led["device"] for led in ab.ledgers) == \
        info["device_ids"]
    sinfo = ecutil.StripeInfo(2, 2 * 256)
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (5, 2, 256), dtype=np.uint8).tobytes()
    got = submit_and_wait(make_batcher(), codec, sinfo, data)
    assert got == ecutil.encode(sinfo, codec, data)


# ---------------------------------------------------------------------
# the explicit-variable subprocess recipe
# ---------------------------------------------------------------------
def test_mesh_recipe_in_explicit_subprocess():
    """The README recipe stands alone: a fresh interpreter that sets
    CEPH_TPU_TORCH_FORCE_DEVICE_COUNT=8 itself gets a dp=4 x sp=2 mesh
    and a byte-exact batcher-routed encode, in a subprocess so this
    worker's device count is untouched."""
    code = (
        "import os\n"
        "os.environ['CEPH_TPU_TORCH_FORCE_DEVICE_COUNT'] = '8'\n"
        f"import sys; sys.path.insert(0, {REPO!r})\n"
        "import numpy as np, threading\n"
        "from ceph_tpu_torch.ec import registry as ecreg\n"
        "from ceph_tpu_torch.osd import ecutil\n"
        "from ceph_tpu_torch.osd.batcher import EncodeBatcher\n"
        "codec = ecreg.instance().factory('gpu', {'k': '8', 'm': '4',"
        " 'device': 'cpu'})\n"
        "info = codec.core.backend.mesh_info()\n"
        "assert info and info['dp'] == 4 and info['sp'] == 2, info\n"
        "data = np.random.default_rng(1).integers(\n"
        "    0, 256, (5, 8, 512), dtype=np.uint8).tobytes()\n"
        "sinfo = ecutil.StripeInfo(8, 8 * 512)\n"
        "bat = EncodeBatcher({'ec_tpu_min_device_bytes': 1})\n"
        "got, ev = {}, threading.Event()\n"
        "bat.submit(codec, sinfo, data,\n"
        "           lambda ch: (got.update(ch or {}), ev.set()))\n"
        "assert ev.wait(120); bat.stop()\n"
        "cpu = ecreg.instance().factory('jerasure',"
        " {'k': '8', 'm': '4'})\n"
        "ref = ecutil.encode(sinfo, cpu, data)\n"
        "assert all(bytes(got[s]) == bytes(ref[s]) for s in ref)\n"
        "print('MESH_RECIPE_OK', info['n_devices'])\n")
    env = dict(os.environ)
    env.pop(pmesh.FORCE_DEVICE_COUNT, None)     # the child sets its own
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=280)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "MESH_RECIPE_OK 8" in proc.stdout

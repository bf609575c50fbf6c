"""The port's other codec plugins (ceph_tpu_torch.ec.plugins: lrc, clay,
shec, isa and the registry's test plugins) against the JAX package's.

* Twins of the JAX package's plugin suites, tests/test_clay.py,
  tests/test_lrc_shec_isa.py, tests/test_registry.py and
  tests/test_jerasure_plugin.py, on the port's registry: every ``tpu``
  inner code becomes ``gpu`` with ``device=cpu``, the device-resident LRC
  encode takes a CPU torch tensor, and the 7-OSD CLAY recovery runs on
  the port's Cluster.
* The same inputs, made from one numpy seed, through both packages: LRC
  (kml and explicit layers; ``inner=tpu`` there, ``inner=gpu
  device=cpu`` here), CLAY at three geometries and two techniques
  (``scalar_mds=tpu`` there, ``scalar_mds=gpu device=cpu`` here), SHEC
  and ISA.  Outputs must be byte-equal.
* The committed corpus vectors of the four plugins: encode, and every
  decode of one and two lost chunks that the codec declares recoverable
  (the JAX package's own sweep).
* The daemon-start preload registers all five plugins its default names,
  and a ``gpu`` inner code without ``device`` means CUDA.
"""
import itertools
import json
import os

import numpy as np
import pytest
import torch

from ceph_tpu.ec import registry as ref_registry
from ceph_tpu.tools.ec_non_regression import payload
from ceph_tpu_torch.ec import registry as ecreg
from ceph_tpu_torch.ec.interface import ErasureCodeValidationError
from ceph_tpu_torch.utils.config import default_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
reg = ecreg.instance


def make(profile):
    return reg().factory("clay", profile)


# ============================================== twins of tests/test_clay.py
def roundtrip_all(codec, erasures, size=None, seed=0):
    k = codec.get_data_chunk_count()
    n = codec.get_chunk_count()
    if size is None:
        size = codec.get_chunk_size(1) * k * 2 + 13
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    encoded = codec.encode(set(range(n)), data)
    assert len(encoded) == n
    chunk_size = len(encoded[0])
    assert all(len(c) == chunk_size for c in encoded.values())
    avail = {i: encoded[i] for i in range(n) if i not in erasures}
    decoded = codec.decode(set(range(n)), avail, chunk_size)
    for i in range(n):
        assert decoded[i] == encoded[i], f"chunk {i} mismatch"
    assert b"".join(decoded[i] for i in range(k))[:len(data)] == data


class TestClayGeometry:
    def test_sub_chunk_count(self):
        c = make({"k": "4", "m": "2"})
        assert c.get_sub_chunk_count() == 8
        assert c.get_chunk_count() == 6
        cs = c.get_chunk_size(4096)
        assert cs % c.get_sub_chunk_count() == 0

    def test_shortening_nu(self):
        c = make({"k": "4", "m": "3", "d": "6"})
        assert c.nu == 2
        assert c.get_sub_chunk_count() == 27

    def test_d_validation(self):
        with pytest.raises(ErasureCodeValidationError):
            make({"k": "4", "m": "2", "d": "7"})
        with pytest.raises(ErasureCodeValidationError):
            make({"k": "4", "m": "2", "d": "3"})

    def test_bad_scalar_mds(self):
        with pytest.raises(ErasureCodeValidationError):
            make({"k": "4", "m": "2", "scalar_mds": "nope"})
        # the JAX package's device code is not a plugin of the port
        with pytest.raises(ErasureCodeValidationError):
            make({"k": "4", "m": "2", "scalar_mds": "tpu"})


class TestClayRoundTrip:
    @pytest.mark.parametrize("erasures", [
        set(), {0}, {3}, {4}, {5}, {0, 1}, {0, 5}, {4, 5}])
    def test_k4_m2(self, erasures):
        roundtrip_all(make({"k": "4", "m": "2"}), erasures)

    @pytest.mark.parametrize("erasures", [{0}, {2}, {1, 3}, {3, 4}])
    def test_k3_m2_d4(self, erasures):
        c = make({"k": "3", "m": "2", "d": "4"})
        assert c.nu == 1
        roundtrip_all(c, erasures)

    @pytest.mark.parametrize("erasures", [{0}, {5}, {0, 4, 6}, {1, 2, 3}])
    def test_k4_m3_d6(self, erasures):
        roundtrip_all(make({"k": "4", "m": "3", "d": "6"}), erasures)

    def test_inner_gpu(self):
        # the framework extension: the inner MDS code on the gpu plugin
        roundtrip_all(make({"k": "4", "m": "2", "scalar_mds": "gpu",
                            "device": "cpu"}), {1, 4})


class TestClayRepair:
    def test_minimum_to_decode_repair(self):
        c = make({"k": "4", "m": "2"})
        n = c.get_chunk_count()
        want = {1}
        avail = set(range(n)) - want
        minimum = c.minimum_to_decode(want, avail)
        assert len(minimum) == c.d == 5
        for runs in minimum.values():
            assert sum(cnt for _, cnt in runs) == \
                c.get_sub_chunk_count() // c.q

    def test_repair_sub_chunk_count(self):
        c = make({"k": "4", "m": "2"})
        assert c.get_repair_sub_chunk_count({0}) == 4

    @pytest.mark.parametrize("lost", [0, 1, 3, 4, 5])
    def test_repair_single_chunk(self, lost):
        c = make({"k": "4", "m": "2"})
        n = c.get_chunk_count()
        k = c.get_data_chunk_count()
        rng = np.random.default_rng(lost)
        size = c.get_chunk_size(1) * k * 3
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        encoded = c.encode(set(range(n)), data)
        chunk_size = len(encoded[0])
        helper_chunks = repair_helpers(c, encoded, lost)
        total = sum(len(b) for b in helper_chunks.values())
        assert total == c.d * chunk_size // c.q
        out = c.decode({lost}, helper_chunks, chunk_size)
        assert out[lost] == encoded[lost]

    def test_is_repair_requires_column(self):
        c = make({"k": "4", "m": "2"})
        n = c.get_chunk_count()
        lost = 0
        col = {c._chunk_of_node((c._node_of_chunk(lost) // c.q) * c.q + x)
               for x in range(c.q)} - {lost}
        avail = set(range(n)) - {lost} - {next(iter(col))}
        assert not c.is_repair({lost}, avail)


def repair_helpers(codec, encoded, lost):
    """What each helper sends for a repair of ``lost``: its repair
    sub-chunks, concatenated."""
    n = codec.get_chunk_count()
    sc = len(encoded[0]) // codec.get_sub_chunk_count()
    minimum = codec.minimum_to_decode({lost}, set(range(n)) - {lost})
    return {i: b"".join(encoded[i][off * sc:(off + cnt) * sc]
                        for off, cnt in runs)
            for i, runs in minimum.items()}


def test_clay_subchunk_recovery_saves_bandwidth():
    """Single-shard recovery on a CLAY pool of the port's cluster reads
    only the repair sub-chunks (d helpers x q^(t-1) planes), not whole
    chunks from k shards; the inner codes on the gpu plugin (CPU)."""
    from ceph_tpu_torch.cluster import Cluster

    from test_torch_cluster import make_conf

    with Cluster(n_osds=7, conf=make_conf()) as c:
        for i in range(7):
            c.wait_for_osd_up(i, 30)
        c.create_ec_profile("clayp", plugin="clay", k="4", m="2",
                            scalar_mds="gpu", device="cpu")
        c.create_pool("claypool", "erasure",
                      erasure_code_profile="clayp")
        io = c.rados().open_ioctx("claypool")
        blobs = {f"cl{i}": os.urandom(96 << 10) for i in range(6)}
        for k, v in blobs.items():
            io.write_full(k, v)
        c.wait_for_clean(30)

        c.kill_osd(2, lose_data=True)
        c.wait_for_osd_down(2)
        c.revive_osd(2)
        c.wait_for_osd_up(2)
        c.wait_for_clean(120)

        repairs = whole = took = 0
        for osd in c.osds.values():
            if osd is None:
                continue
            for pg in osd.pgs.values():
                be = pg.backend
                if hasattr(be, "subchunk_repairs"):
                    repairs += be.subchunk_repairs
                    took += be.repair_read_bytes
                    whole += be.repair_whole_bytes
        assert repairs > 0, "no CLAY sub-chunk repair was taken"
        assert took < 0.8 * whole, \
            f"repair read {took}B, whole-chunk would be {whole}B"
        for k, v in blobs.items():
            assert io.read(k) == v, "recovered data diverged"


# ======================================= twins of tests/test_lrc_shec_isa.py
def roundtrip(codec, data, lose):
    n = codec.get_chunk_count()
    encoded = codec.encode(set(range(n)), data)
    chunks = {i: c for i, c in encoded.items() if i not in lose}
    decoded = codec.decode(set(lose), chunks)
    for e in lose:
        assert decoded[e] == encoded[e], f"chunk {e} mismatch losing {lose}"
    return encoded


def test_lrc_kml_form():
    codec = reg().factory("lrc", {"k": "4", "m": "2", "l": "3"})
    assert codec.get_chunk_count() == 8
    assert codec.get_data_chunk_count() == 4
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, 20000, dtype=np.uint8).tobytes()
    encoded = codec.encode(set(range(8)), data)
    assert codec.decode_concat(encoded)[:len(data)] == data
    for lose in range(8):
        roundtrip(codec, data, (lose,))


def test_lrc_local_recovery_reads_fewer():
    codec = reg().factory("lrc", {"k": "4", "m": "2", "l": "3"})
    minimum = codec.minimum_to_decode({0}, set(range(1, 8)))
    assert set(minimum) <= {1, 2, 3}, sorted(minimum)


def test_lrc_explicit_layers():
    profile = {
        "mapping": "DD__DD__",
        "layers": '[["DDc_DDc_", ""], ["DDDc____", ""], ["____DDDc", ""]]',
    }
    codec = reg().factory("lrc", dict(profile))
    assert codec.get_chunk_count() == 8
    assert codec.get_data_chunk_count() == 4
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 8192, dtype=np.uint8).tobytes()
    for lose in ([0], [4], [1, 5]):
        roundtrip(codec, data, tuple(lose))


def test_lrc_inner_gpu_plugin():
    """BASELINE config 4: LRC layered over the gpu inner plugin, zero LRC
    changes; ``device`` reaches the layer's profile."""
    layers_for = '[["DDcDDcDDc", "plugin=%s technique=reed_sol_van"]]'
    base = {"mapping": "DD_DD_DD_"}
    mixed = reg().factory("lrc", dict(base, layers=layers_for % "gpu",
                                      device="cpu"))
    assert mixed.layers[0].profile["plugin"] == "gpu"
    assert mixed.layers[0].profile["device"] == "cpu"
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, 6000, dtype=np.uint8).tobytes()
    roundtrip(mixed, data, (0,))
    cpu = reg().factory("lrc", dict(base, layers=layers_for % "jerasure"))
    d2 = rng.integers(0, 256, 6000, dtype=np.uint8).tobytes()
    e_cpu = cpu.encode(set(range(9)), d2)
    e_gpu = mixed.encode(set(range(9)), d2)
    assert e_cpu == e_gpu


def test_lrc_validation():
    with pytest.raises(ErasureCodeValidationError):
        reg().factory("lrc", {"k": "4", "m": "2", "l": "5"})
    with pytest.raises(ErasureCodeValidationError):
        reg().factory("lrc", {"k": "4", "m": "2"})
    with pytest.raises(ErasureCodeValidationError):
        reg().factory("lrc", {"mapping": "DD_",
                              "layers": '[["DDc", ""], ["DD", ""]]'})


@pytest.mark.parametrize("technique", ["single", "multiple"])
def test_shec_roundtrip(technique):
    codec = reg().factory("shec", {"k": "6", "m": "3", "c": "2",
                                   "technique": technique})
    assert codec.get_chunk_count() == 9
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, 30000, dtype=np.uint8).tobytes()
    encoded = codec.encode(set(range(9)), data)
    assert codec.decode_concat(encoded)[:len(data)] == data
    for lose in itertools.combinations(range(9), 2):
        roundtrip(codec, data, lose)


def test_shec_minimum_smaller_than_k():
    codec = reg().factory("shec", {"k": "8", "m": "4", "c": "3"})
    minimum = codec.minimum_to_decode({0}, set(range(1, 12)))
    assert len(minimum) < 8, sorted(minimum)


def test_shec_defaults_and_validation():
    codec = reg().factory("shec", {})
    assert (codec.k, codec.m, codec.c) == (4, 3, 2)
    for bad in ({"k": "6", "m": "3"},
                {"k": "6", "m": "3", "c": "4"},
                {"k": "13", "m": "3", "c": "2"},
                {"k": "3", "m": "4", "c": "2"}):
        with pytest.raises(ErasureCodeValidationError):
            reg().factory("shec", dict(bad))


def test_shec_unrecoverable_returns_error():
    codec = reg().factory("shec", {"k": "6", "m": "3", "c": "2"})
    rng = np.random.default_rng(6)
    data = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    encoded = codec.encode(set(range(9)), data)
    lose = (0, 1, 2, 6)
    chunks = {i: c for i, c in encoded.items() if i not in lose}
    with pytest.raises(IOError):
        codec.decode(set(lose), chunks)


@pytest.mark.parametrize("technique,profile", [
    ("reed_sol_van", {"k": "7", "m": "3"}),
    ("reed_sol_van", {"k": "8", "m": "4"}),
    ("cauchy", {"k": "7", "m": "3"}),
])
def test_isa_roundtrip(technique, profile):
    p = dict(profile)
    p["technique"] = technique
    codec = reg().factory("isa", p)
    k, m = int(profile["k"]), int(profile["m"])
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 10000, dtype=np.uint8).tobytes()
    codec.encode(set(range(k + m)), data)
    for nerasures in (1, m):
        for lose in list(itertools.combinations(range(k + m),
                                                nerasures))[:20]:
            roundtrip(codec, data, lose)


def test_isa_chunk_size_per_chunk_aligned():
    codec = reg().factory("isa", {"k": "7", "m": "3"})
    for size in (1, 100, 4096, 1000001):
        cs = codec.get_chunk_size(size)
        assert cs % 32 == 0 and cs * 7 >= size


def test_isa_validation():
    with pytest.raises(ErasureCodeValidationError):
        reg().factory("isa", {"k": "33", "m": "3"})
    with pytest.raises(ErasureCodeValidationError):
        reg().factory("isa", {"k": "8", "m": "5"})
    with pytest.raises(ErasureCodeValidationError):
        reg().factory("isa", {"technique": "liberation"})


def test_lrc_encode_batch_matches_per_object():
    """The batched layer walk (one inner call per layer per batch) is
    byte-identical to the per-object encode, for both inner plugins."""
    for inner in (None, "gpu"):
        prof = {"k": "4", "m": "2", "l": "3"}
        if inner:
            prof.update(inner=inner, device="cpu")
        codec = reg().factory("lrc", dict(prof))
        k = codec.get_data_chunk_count()
        n = codec.get_chunk_count()
        L = codec.get_chunk_size(4096 * k)
        rng = np.random.default_rng(5)
        batch = rng.integers(0, 256, (5, k, L), dtype=np.uint8)
        out = codec.encode_batch(batch)
        assert out.shape == (5, n - k, L)
        for b in range(5):
            obj = batch[b].tobytes()
            ref = codec.encode(set(range(n)), obj)
            for i in range(k, n):
                assert out[b, i - k].tobytes() == \
                    ref[codec.chunk_index(i)], \
                    f"inner={inner} obj {b} chunk {i} mismatch"


def test_lrc_encode_batch_device_bit_exact():
    """Device-resident layered encode (a CPU torch tensor here) equals
    the host batched walk."""
    codec = reg().factory("lrc", {"k": "4", "m": "2", "l": "3",
                                  "inner": "gpu", "device": "cpu"})
    k = codec.get_data_chunk_count()
    L = codec.get_chunk_size(4096 * k)
    rng = np.random.default_rng(6)
    batch = rng.integers(0, 256, (3, k, L), dtype=np.uint8)
    dev = codec.encode_batch_device(torch.from_numpy(batch)).numpy()
    host = codec.encode_batch(batch)
    assert np.array_equal(dev, host)


# =========================================== twins of tests/test_registry.py
@pytest.fixture
def registry():
    return ecreg.instance()


class TestRegistryLifecycle:
    def test_load_unknown(self, registry):
        with pytest.raises(KeyError):
            registry.load("no_such_plugin_xyz")

    def test_fail_to_initialize(self, registry):
        with pytest.raises(RuntimeError):
            registry.load("fail_to_initialize")
        assert registry.get("fail_to_initialize") is None

    def test_fail_to_register(self, registry):
        with pytest.raises(KeyError):
            registry.load("fail_to_register")

    def test_missing_entry_point(self, registry):
        with pytest.raises(KeyError, match="entry point"):
            registry.load("missing_entry_point")

    def test_missing_version(self, registry):
        with pytest.raises(KeyError, match="version"):
            registry.load("missing_version")
        assert registry.get("missing_version") is None

    def test_double_add_rejected(self, registry):
        registry.load("example")
        with pytest.raises(KeyError):
            registry.add("example", registry.get("example"))

    def test_preload(self, registry):
        registry.preload("example, jerasure")
        assert registry.get("example") is not None
        assert registry.get("jerasure") is not None


class TestExamplePlugin:
    def test_round_trip(self, registry):
        codec = registry.factory("example", {})
        data = bytes(range(100)) * 3
        encoded = codec.encode({0, 1, 2}, data)
        parity = np.bitwise_xor(
            np.frombuffer(encoded[0], dtype=np.uint8),
            np.frombuffer(encoded[1], dtype=np.uint8)).tobytes()
        assert encoded[2] == parity
        for lost in (0, 1, 2):
            avail = {i: encoded[i] for i in range(3) if i != lost}
            out = codec.decode({lost}, avail, len(encoded[0]))
            assert out[lost] == encoded[lost]

    def test_minimum_with_cost(self, registry):
        codec = registry.factory("example", {})
        assert codec.minimum_to_decode_with_cost(
            {0, 1}, {0: 1, 1: 9, 2: 2}) == {0, 2}


# ==================================== twins of tests/test_jerasure_plugin.py
TECHNIQUES = [
    ("reed_sol_van", {"k": "4", "m": "2"}),
    ("reed_sol_van", {"k": "8", "m": "4"}),
    ("reed_sol_van", {"k": "3", "m": "2", "w": "16"}),
    ("reed_sol_van", {"k": "3", "m": "2", "w": "32"}),
    ("reed_sol_r6_op", {"k": "4", "m": "2", "w": "32"}),
    ("reed_sol_r6_op", {"k": "4", "m": "2"}),
    ("cauchy_orig", {"k": "4", "m": "2", "packetsize": "32"}),
    ("cauchy_good", {"k": "4", "m": "2", "packetsize": "32"}),
    ("cauchy_good", {"k": "7", "m": "3", "packetsize": "8"}),
    ("liberation", {"k": "4", "m": "2", "w": "7", "packetsize": "32"}),
    ("blaum_roth", {"k": "4", "m": "2", "w": "7", "packetsize": "32"}),
    ("liber8tion", {"k": "4", "m": "2", "w": "8", "packetsize": "32"}),
]


def make_codec(technique, profile):
    p = {"plugin": "jerasure", "technique": technique}
    p.update(profile)
    return reg().factory("jerasure", p)


@pytest.mark.parametrize("technique,profile", TECHNIQUES)
def test_roundtrip_no_erasure(technique, profile):
    codec = make_codec(technique, profile)
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, 1237, dtype=np.uint8).tobytes()
    n = codec.get_chunk_count()
    encoded = codec.encode(set(range(n)), data)
    assert len(encoded) == n
    assert len({len(c) for c in encoded.values()}) == 1
    assert codec.decode_concat(encoded)[:len(data)] == data


@pytest.mark.parametrize("technique,profile", TECHNIQUES)
def test_all_erasure_patterns(technique, profile):
    codec = make_codec(technique, profile)
    k = codec.get_data_chunk_count()
    m = codec.get_coding_chunk_count()
    n = k + m
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    encoded = codec.encode(set(range(n)), data)
    for nerasures in range(1, m + 1):
        for erased in itertools.combinations(range(n), nerasures):
            chunks = {i: c for i, c in encoded.items() if i not in erased}
            decoded = codec.decode(set(erased), chunks)
            for e in erased:
                assert decoded[e] == encoded[e], \
                    f"erasure {erased} chunk {e} mismatch"


@pytest.mark.parametrize("technique,profile", TECHNIQUES)
def test_decode_concat_after_data_loss(technique, profile):
    codec = make_codec(technique, profile)
    n = codec.get_chunk_count()
    m = codec.get_coding_chunk_count()
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 10000, dtype=np.uint8).tobytes()
    encoded = codec.encode(set(range(n)), data)
    for e in range(min(m, codec.get_data_chunk_count())):
        chunks = {i: c for i, c in encoded.items() if i != e}
        assert codec.decode_concat(chunks)[:len(data)] == data


def test_minimum_to_decode():
    codec = make_codec("reed_sol_van", {"k": "4", "m": "2"})
    minimum = codec.minimum_to_decode({0, 1}, {0, 1, 2, 3, 4, 5})
    assert set(minimum) == {0, 1}
    assert minimum[0] == [(0, 1)]
    minimum = codec.minimum_to_decode({0, 1, 2, 3}, {0, 2, 3, 4, 5})
    assert set(minimum) == {0, 2, 3, 4}
    with pytest.raises(IOError):
        codec.minimum_to_decode({0}, {2, 3, 4})
    assert codec.minimum_to_decode_with_cost(
        {0, 1, 2, 3}, {i: 1 for i in (0, 2, 3, 4, 5)}) == {0, 2, 3, 4}


def test_chunk_mapping():
    codec = make_codec("reed_sol_van",
                       {"k": "2", "m": "2", "mapping": "_DD_"})
    assert codec.get_chunk_mapping() == [1, 2, 0, 3]
    rng = np.random.default_rng(17)
    data = rng.integers(0, 256, 2048, dtype=np.uint8).tobytes()
    n = codec.get_chunk_count()
    encoded = codec.encode(set(range(n)), data)
    assert codec.decode_concat(encoded)[:len(data)] == data
    for lost in range(n):
        chunks = {i: c for i, c in encoded.items() if i != lost}
        assert codec.decode_concat(chunks)[:len(data)] == data
        assert codec.decode({lost}, chunks)[lost] == encoded[lost]


def test_chunk_size_padding():
    codec = make_codec("reed_sol_van", {"k": "4", "m": "2"})
    cs = codec.get_chunk_size(1)
    assert cs * 4 >= 1 and cs % 8 == 0
    for size in (1, 31, 4096, 100000, 1 << 20):
        assert codec.get_chunk_size(size) * 4 >= size


def test_small_object_padding_roundtrip():
    codec = make_codec("reed_sol_van", {"k": "4", "m": "2"})
    n = codec.get_chunk_count()
    for size in (1, 3, 100, 1000):
        data = bytes(range(size % 256)) * (size // max(1, size % 256) + 1)
        data = data[:size]
        encoded = codec.encode(set(range(n)), data)
        assert codec.decode_concat(encoded)[:size] == data


def test_validation_errors():
    with pytest.raises(ErasureCodeValidationError):
        make_codec("reed_sol_van", {"k": "1", "m": "1"})
    with pytest.raises(ErasureCodeValidationError):
        make_codec("reed_sol_van", {"k": "4", "m": "2", "w": "9"})
    with pytest.raises(ErasureCodeValidationError):
        make_codec("reed_sol_r6_op", {"k": "4", "m": "3"})
    with pytest.raises(ErasureCodeValidationError):
        make_codec("liberation", {"k": "4", "m": "2", "w": "8"})
    with pytest.raises(ErasureCodeValidationError):
        make_codec("no_such_technique", {})


def test_registry_lifecycle():
    r = reg()
    with pytest.raises(KeyError):
        r.load("does_not_exist")
    r.preload("jerasure")
    assert r.get("jerasure") is not None
    with pytest.raises(KeyError):
        r.add("jerasure", r.get("jerasure"))


def test_want_to_encode_subset():
    codec = make_codec("reed_sol_van", {"k": "4", "m": "2"})
    out = codec.encode({0, 5}, bytes(1000))
    assert set(out) == {0, 5}


# ================================== the same inputs through both packages
def pair(name, profile, inner_key=None):
    """(port codec, JAX package codec) of one profile; ``inner_key``
    names the profile key whose ``gpu`` is ``tpu`` in the JAX package."""
    port = dict(profile)
    ref = dict(profile)
    if inner_key is not None and profile.get(inner_key) == "gpu":
        port["device"] = "cpu"
        ref[inner_key] = "tpu"
    return (reg().factory(name, port),
            ref_registry.instance().factory(name, ref))


def losses(n, most=2):
    return [s for r in range(1, most + 1)
            for s in itertools.combinations(range(n), r)]


def decode_both(port, ref, encoded, erased, chunk_size=0):
    """Both packages decode one loss: equal chunks, or both refuse."""
    avail = {i: c for i, c in encoded.items() if i not in erased}
    try:
        want = ref.decode(set(erased), avail, chunk_size)
    except IOError:
        with pytest.raises(IOError):
            port.decode(set(erased), avail, chunk_size)
        return False
    got = port.decode(set(erased), avail, chunk_size)
    for e in erased:
        assert got[e] == want[e] == encoded[e], (erased, e)
    return True


LRC_PROFILES = {
    "kml": {"k": "4", "m": "2", "l": "3", "inner": "gpu"},
    "explicit": {"mapping": "DD__DD__", "inner": "gpu",
                 "layers": '[["DDc_DDc_", ""], ["DDDc____", ""], '
                           '["____DDDc", ""]]'},
}


@pytest.mark.parametrize("form", sorted(LRC_PROFILES))
def test_lrc_matches_jax_package(form):
    port, ref = pair("lrc", LRC_PROFILES[form], "inner")
    assert port.layers[0].profile["plugin"] == "gpu"
    assert ref.layers[0].profile["plugin"] == "tpu"
    n = port.get_chunk_count()
    k = port.get_data_chunk_count()
    assert port.get_chunk_mapping() == ref.get_chunk_mapping()
    rng = np.random.default_rng(4100 + len(form))
    data = rng.integers(0, 256, 23456, dtype=np.uint8).tobytes()
    encoded = ref.encode(set(range(n)), data)
    assert port.encode(set(range(n)), data) == encoded
    L = port.get_chunk_size(4096 * k)
    batch = rng.integers(0, 256, (4, k, L), dtype=np.uint8)
    want = ref.encode_batch(batch)
    assert np.array_equal(port.encode_batch(batch), want)
    assert np.array_equal(
        port.encode_batch_device(torch.from_numpy(batch)).numpy(), want)
    recovered = [s for s in losses(n) if decode_both(port, ref, encoded, s)]
    assert all((lost,) in recovered for lost in range(n))
    for lost in range(n):
        avail = set(range(n)) - {lost}
        assert set(port.minimum_to_decode({lost}, avail)) == \
            set(ref.minimum_to_decode({lost}, avail))


CLAY_GEOMETRIES = [(4, 2, 5), (3, 2, 4), (4, 3, 6)]


@pytest.mark.parametrize("technique", ["reed_sol_van", "cauchy_good"])
@pytest.mark.parametrize("k,m,d", CLAY_GEOMETRIES)
def test_clay_matches_jax_package(k, m, d, technique):
    prof = {"k": str(k), "m": str(m), "d": str(d),
            "technique": technique, "scalar_mds": "gpu"}
    port, ref = pair("clay", prof, "scalar_mds")
    assert port.get_sub_chunk_count() == ref.get_sub_chunk_count()
    n = k + m
    size = ref.get_chunk_size(1) * k
    assert port.get_chunk_size(size) == ref.get_chunk_size(size)
    rng = np.random.default_rng(k * 100 + m * 10 + d)
    data = rng.integers(0, 256, size - 7, dtype=np.uint8).tobytes()
    encoded = ref.encode(set(range(n)), data)
    assert port.encode(set(range(n)), data) == encoded
    cs = len(encoded[0])
    for erased in losses(n):
        assert decode_both(port, ref, encoded, erased, cs)
    for lost in range(n):
        avail = set(range(n)) - {lost}
        runs = ref.minimum_to_decode({lost}, avail)
        assert port.minimum_to_decode({lost}, avail) == runs
        helpers = repair_helpers(ref, encoded, lost)
        got = port.repair({lost}, helpers, cs)
        assert got == ref.repair({lost}, helpers, cs)
        assert got[lost] == encoded[lost]


@pytest.mark.parametrize("technique", ["single", "multiple"])
def test_shec_matches_jax_package(technique):
    prof = {"k": "6", "m": "3", "c": "2", "technique": technique}
    port, ref = pair("shec", prof)
    assert np.array_equal(port.matrix, ref.matrix)
    rng = np.random.default_rng(4300 + len(technique))
    data = rng.integers(0, 256, 30011, dtype=np.uint8).tobytes()
    encoded = ref.encode(set(range(9)), data)
    assert port.encode(set(range(9)), data) == encoded
    for erased in losses(9, 3):
        decode_both(port, ref, encoded, erased)
    for lost in range(9):
        avail = set(range(9)) - {lost}
        assert port.minimum_to_decode({lost}, avail) == \
            ref.minimum_to_decode({lost}, avail)


@pytest.mark.parametrize("technique", ["reed_sol_van", "cauchy"])
def test_isa_matches_jax_package(technique):
    port, ref = pair("isa", {"k": "8", "m": "4", "technique": technique})
    rng = np.random.default_rng(4400 + len(technique))
    data = rng.integers(0, 256, 54321, dtype=np.uint8).tobytes()
    encoded = ref.encode(set(range(12)), data)
    assert port.encode(set(range(12)), data) == encoded
    for erased in losses(12):
        assert decode_both(port, ref, encoded, erased)
    assert port.get_chunk_size(54321) == ref.get_chunk_size(54321)


# the device plugin's profile key of each corpus vector that has an inner
# code: it runs on the gpu plugin (CPU) here
CORPUS_INNER = {"lrc_layered": {"inner": "gpu", "device": "cpu"},
                "clay_k=4_m=2": {"scalar_mds": "gpu", "device": "cpu"},
                "shec_c=2_k=4_m=3": {}, "isa_k=4_m=2": {}}


@pytest.mark.parametrize("name", sorted(CORPUS_INNER))
def test_corpus_vectors(name):
    d = os.path.join(REPO, "corpus", name)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    codec = reg().factory(manifest["plugin"],
                          dict(manifest["profile"], **CORPUS_INNER[name]))
    n = manifest["chunk_count"]
    stored = {}
    for i in range(n):
        with open(os.path.join(d, f"chunk.{i}"), "rb") as f:
            stored[i] = f.read()
    assert len(payload()) == manifest["payload_size"]
    fresh = codec.encode(set(range(n)), payload())
    assert all(fresh[i] == stored[i] for i in range(n))
    # the JAX package's sweep (tools/ec_non_regression.py): a loss that
    # minimum_to_decode rejects is skipped (LRC's locality configs and
    # SHEC declare some unrecoverable), the rest decode from the minimum
    decoded = 0
    for erased in losses(n):
        avail = set(range(n)) - set(erased)
        try:
            need = codec.minimum_to_decode(set(erased), avail)
        except IOError:
            continue
        dec = codec.decode(set(erased), {i: stored[i] for i in need},
                           len(stored[0]))
        assert all(dec[e] == stored[e] for e in erased), erased
        decoded += 1
    assert decoded >= n


# ============================================== preload and the device key
def test_preload_from_conf_registers_every_default_plugin():
    """Daemon start preloads every plugin osd_erasure_code_plugins names;
    the port's device plugin, gpu, stands where the JAX package's tpu
    stands."""
    conf = default_config()
    r = ecreg.ErasureCodePluginRegistry()
    r.preload_from_conf(conf)
    assert sorted(r.plugins) == ["gpu", "isa", "jerasure", "lrc", "shec"]
    assert sorted(conf["osd_erasure_code_plugins"].split()) == \
        sorted(r.plugins)


@pytest.mark.parametrize("name,profile", [
    ("lrc", {"k": "4", "m": "2", "l": "3", "inner": "gpu"}),
    ("clay", {"k": "4", "m": "2", "scalar_mds": "gpu"}),
])
def test_gpu_inner_without_device_means_cuda(name, profile):
    """With no ``device`` key the inner gpu codes mean CUDA: without a
    card the codec raises, it never runs quietly on the CPU."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            reg().factory(name, dict(profile))
        return
    codec = reg().factory(name, dict(profile))
    inner = [codec.mds, codec.pft] if name == "clay" else \
        [layer.erasure_code for layer in codec.layers]
    assert all(c.core.backend.is_cuda for c in inner)

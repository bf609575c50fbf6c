"""The port's non-regression corpus tool, CRC32C and bench sweep
(ceph_tpu_torch.tools.ec_non_regression, ceph_tpu_torch.utils.crc,
ceph_tpu_torch.tools.bench_sweep).

Port twins of the 8 tests of tests/test_corpus_crc.py, the `gpu` plugin
on the CPU (``--device cpu``) where the reference names its `tpu`
plugin.  The committed corpus is read, never written: the `gpu` entry
reads the k=8 m=4 vectors the corpus holds under ``tpu_k=8_m=4``.

Then both tools held against the JAX package's: ``create`` into a
scratch base writes every config's chunk files byte-equal to the JAX
package's ``create``, and the sweep gives a row, with the same keys, for
every combination the JAX package's sweep gives.  Last, the sweep skips
only a profile that the plugin's factory refuses: an error raised in an
encode ends the sweep non-zero."""
import json
import os

import pytest

from ceph_tpu_torch.tools import bench_sweep, ec_non_regression
from ceph_tpu_torch.utils.crc import (available_native, crc32c,
                                      _py_crc32c)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "corpus")


def corpus_files():
    """(path, size, mtime) of every file under corpus/."""
    return sorted((os.path.join(d, f), os.path.getsize(os.path.join(d, f)),
                   os.path.getmtime(os.path.join(d, f)))
                  for d, _, fs in os.walk(CORPUS) for f in fs)


def test_committed_corpus_is_bit_exact(capsys):
    """THE compatibility gate: every codec must reproduce the
    committed chunks byte-for-byte and decode every recoverable 1-
    and 2-erasure pattern back to them."""
    before = corpus_files()
    assert ec_non_regression.check(CORPUS, verbose=True, device="cpu") == 0
    out = capsys.readouterr().out
    assert "corpus ok: 9 configs" in out
    # the gpu entry read the committed tpu vectors, and nothing was
    # written under corpus/
    assert f"ok {os.path.join(CORPUS, 'tpu_k=8_m=4')} " in out
    assert corpus_files() == before
    assert not any(n.startswith("gpu") for n in os.listdir(CORPUS))


def test_corpus_detects_divergence(tmp_path):
    """A corrupted stored chunk must fail the check (the check is
    real, not vacuous)."""
    base = str(tmp_path / "c")
    assert ec_non_regression.create(base, device="cpu") == 0
    victim_dir = ec_non_regression.config_dir(
        base, "jerasure", {"k": "2", "m": "1",
                           "technique": "reed_sol_van"})
    path = os.path.join(victim_dir, "chunk.0")
    blob = bytearray(open(path, "rb").read())
    blob[100] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    assert ec_non_regression.check(base, device="cpu") == 1


def test_payload_is_deterministic():
    assert ec_non_regression.payload() == ec_non_regression.payload()
    assert len(ec_non_regression.payload()) == \
        ec_non_regression.PAYLOAD_SIZE


# ---------------------------------------------------------------- crc


def test_crc32c_rfc3720_vector():
    # RFC 3720 B.4: crc32c("123456789") == 0xE3069283
    assert crc32c(b"123456789") == 0xE3069283
    assert _py_crc32c(b"123456789", 0) == 0xE3069283


def test_crc32c_chaining_and_native_parity():
    data = os.urandom(100_000)
    whole = crc32c(data)
    part = crc32c(data[50_000:], crc32c(data[:50_000]))
    assert whole == part
    assert _py_crc32c(data, 0) == whole  # python == native
    assert crc32c(b"") == 0


def test_native_crc_kernel_builds():
    """The image ships g++; the native kernel must actually build
    (the pure-python fallback is for compilerless environments)."""
    assert available_native()


# -------------------------------------------------------------- sweep


def test_bench_sweep_rows(capsys):
    assert bench_sweep.main(["--plugins", "jerasure", "--km", "2/1",
                             "--techniques", "reed_sol_van",
                             "--size", str(64 << 10), "-i", "1",
                             "--workloads", "encode"]) == 0
    rows = [json.loads(ln) for ln in
            capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(rows) == 1
    r = rows[0]
    assert r["plugin"] == "jerasure" and r["k"] == 2 and r["gbps"] > 0


def test_bench_sweep_html(tmp_path, capsys):
    out = str(tmp_path / "sweep.html")
    assert bench_sweep.main(["--plugins", "jerasure", "--km", "2/1",
                             "--techniques", "reed_sol_van",
                             "--size", str(64 << 10), "-i", "1",
                             "--workloads", "encode",
                             "--html", out]) == 0
    capsys.readouterr()
    html = open(out).read()
    assert "GB/s" in html and "jerasure" in html


# ------------------------------------- the tools against the JAX package


def chunk_files(base):
    """{config directory: {chunk file: bytes}} of a created corpus."""
    return {os.path.relpath(d, base): {f: open(os.path.join(d, f), "rb").read()
                                      for f in fs if f.startswith("chunk.")}
            for d, _, fs in os.walk(base) if fs}


def test_created_corpus_equals_jax_package(tmp_path, capsys):
    """Byte equality, config by config: every chunk file that the port's
    create writes into a scratch base equals the JAX package's, the
    `gpu` config's under the name of the JAX package's `tpu` one; and
    the port's check of that base agrees with it."""
    from ceph_tpu.tools import ec_non_regression as ref
    port_base, ref_base = str(tmp_path / "port"), str(tmp_path / "ref")
    assert ec_non_regression.create(port_base, device="cpu") == 0
    assert ref.create(ref_base) == 0
    port, jax_ = chunk_files(port_base), chunk_files(ref_base)
    assert sorted(port) == sorted(jax_) and len(port) == 9
    assert "tpu_k=8_m=4" in port
    for tag in port:
        assert port[tag] == jax_[tag], tag
        assert len(port[tag]) >= 3
    assert ec_non_regression.check(port_base, device="cpu") == 0
    assert ec_non_regression.payload() == ref.payload()


def sweep_rows(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.strip()]


def test_bench_sweep_rows_equal_jax_package(capsys):
    """The port's sweep over jerasure, isa and gpu (on the CPU) gives a
    row for every combination that the JAX package's sweep over
    jerasure, isa and tpu gives, with the same keys and KiB."""
    from ceph_tpu.tools import bench_sweep as ref
    args = ["--size", str(16 << 10), "-i", "1",
            "--techniques", "reed_sol_van,cauchy_good,liberation"]
    port = sweep_rows(bench_sweep.main, ["--device", "cpu", *args], capsys)
    jax_ = sweep_rows(ref.main, ["--plugins", "jerasure,isa,tpu", *args],
                      capsys)

    def key(r, plugin=None):
        return (plugin or r["plugin"], r["k"], r["m"], r["technique"],
                r["workload"], r["kib"])
    assert sorted(key(r) for r in port) == sorted(
        key(r, "gpu" if r["plugin"] == "tpu" else None) for r in jax_)
    assert all(sorted(r) == sorted(jax_[0]) for r in port)
    # 6 k/m pairs x 2 workloads: jerasure's two techniques and isa and
    # gpu in full, liberation where k <= w = 7
    assert len(port) == 5 * 12 - 2 * 2


def test_bench_sweep_skips_a_profile_the_factory_refuses(capsys):
    assert bench_sweep.main(["--plugins", "jerasure,gpu", "--device", "cpu",
                             "--km", "10/4", "--techniques", "liberation",
                             "--size", str(16 << 10), "-i", "1",
                             "--workloads", "encode"]) == 0
    out, err = capsys.readouterr()
    rows = [json.loads(ln) for ln in out.splitlines() if ln.strip()]
    assert [r["plugin"] for r in rows] == ["gpu"]
    assert "# skip jerasure liberation 10/4 encode" in err


def test_bench_sweep_exits_non_zero_when_an_encode_raises(monkeypatch,
                                                          capsys):
    """A kernel that fails in encode does not vanish from the sweep: its
    error propagates, with no row and no skip line."""
    from ceph_tpu_torch.ec import registry as ecreg

    def broken(self, want, data):
        raise RuntimeError("kernel launch failed")

    codec_cls = type(ecreg.instance().factory(
        "gpu", {"k": "2", "m": "1", "device": "cpu"}))
    monkeypatch.setattr(codec_cls, "encode", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        bench_sweep.main(["--plugins", "jerasure,gpu", "--device", "cpu",
                          "--km", "2/1", "--techniques", "reed_sol_van",
                          "--size", str(16 << 10), "-i", "1",
                          "--workloads", "encode"])
    out, err = capsys.readouterr()
    assert [json.loads(ln)["plugin"] for ln in out.splitlines()] == \
        ["jerasure"]
    assert "# skip" not in err
    # and without the device the gpu codec cannot be built on a host
    # with no card: that error propagates too, it is no refused profile
    monkeypatch.undo()
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench_sweep.main(["--plugins", "gpu", "--km", "2/1",
                              "--size", str(16 << 10), "-i", "1",
                              "--workloads", "encode"])

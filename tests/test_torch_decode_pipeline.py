"""Port twins of tests/test_decode_pipeline.py: the device decode route.

Reconstruction through the `gpu` plugin's combined recovery rows
(``decode_batch_async``, one B1 apply a signature; its plain version on
the CPU), the PG-activation decode prewarm, degraded client reads
through the OSD batcher on both OSD models, and the deep-scrub syndrome
compare, each with ``device="cpu"`` and the reference's sizes and seeds.
Where the reference checks a value the JAX package computes (parity,
recovery rows), the twin computes it with ``ceph_tpu`` too and holds the
port byte-equal to it.

Reference tests not twinned here:

- ``test_decode_group_rides_device_with_full_ledger``,
  ``test_decode_pin_routes_to_twin_with_reason``,
  ``test_decode_crossover_seeds_from_encode_ewma`` and
  ``test_breaker_open_decode_falls_to_twin_without_errors``: the tests of
  the same names in tests/test_torch_batcher.py.
- ``test_crclinear_bit_exact_vs_crc32c_kernel``,
  ``test_crclinear_backend_apply_matches_host`` and
  ``test_crclinear_syndrome_partials_cancel_on_codeword``: the tests of
  the same names in tests/test_torch_crclinear.py.
- ``test_decode_route_note_overhead_within_budget`` waits: it is a
  timing guard, and its kin in tests/test_perf_guard.py are red in the
  full runs of the suite on a shared CPU.
- ``test_perf_trend_rebuild_floor_and_collapse`` waits: it needs the
  perf-trend tool, which comes to the port with its benchmark.
"""
import itertools
import os
import time

import numpy as np
import pytest

from ceph_tpu.ec import registry as ref_registry
from ceph_tpu_torch.cluster import Cluster
from ceph_tpu_torch.cluster import test_config as make_conf
from ceph_tpu_torch.ec import registry as ecreg


def make_codec(k, m):
    return ecreg.instance().factory(
        "gpu", {"k": str(k), "m": str(m), "technique": "reed_sol_van",
                "device": "cpu"})


def ref_codec(k, m):
    return ref_registry.instance().factory(
        "tpu", {"k": str(k), "m": str(m), "technique": "reed_sol_van"})


# ---------------------------------------------------------------------
# codec boundary: batched Vandermonde-inverse recovery
# ---------------------------------------------------------------------
@pytest.mark.parametrize("k,m", [(8, 4), (4, 2)])
def test_device_decode_bit_exact_every_signature(k, m):
    """Every 1- and 2-erasure signature reconstructs bit-exact through
    decode_batch_async (combined data+parity recovery rows, ONE kernel
    apply per signature) to the chunks the JAX package's `tpu` encoded,
    and each handle carries a full seven-phase ledger."""
    from ceph_tpu_torch.utils.device_ledger import PHASE_ORDER

    codec = make_codec(k, m)
    assert codec.decode_async_supported()
    cs = 256
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (3, k, cs), dtype=np.uint8)
    parity = codec.encode_batch(data)
    assert np.array_equal(parity, ref_codec(k, m).encode_batch(data))
    shards = {i: data[:, i] for i in range(k)}
    shards.update({k + e: parity[:, e] for e in range(m)})
    n = k + m
    sigs = [frozenset(c) for c in itertools.combinations(range(n), 1)]
    sigs += [frozenset(c) for c in itertools.combinations(range(n), 2)]
    for erased in sigs:
        present = {i: shards[i] for i in range(n) if i not in erased}
        h = codec.decode_batch_async(present, cs)
        rec = h.wait()
        for e in sorted(erased):
            assert np.array_equal(rec[e], shards[e]), \
                f"k={k} m={m} erased={sorted(erased)} shard {e}"
        led = h.ledger
        assert led is not None
        missing = [p for p in PHASE_ORDER if led.get(p) is None]
        assert not missing, \
            f"signature {sorted(erased)} ledger lacks {missing}"


@pytest.mark.parametrize("k,m", [(8, 4), (4, 2)])
def test_prewarm_decode_caches_single_erasure_rows(k, m):
    """PG-activation decode prewarm: every single-erasure signature's
    recovery rows land in the signature cache ahead of traffic, equal to
    the JAX package's rows, and the warm is idempotent per (geometry,
    chunk) shape."""
    from ceph_tpu_torch.ec.plugins import gpu as gpu_plugin

    codec = make_codec(k, m)
    core = codec.core
    ref_core = ref_codec(k, m).core
    codec.prewarm_decode(1024)
    n = k + m
    for e in range(n):
        chosen = tuple(i for i in range(n) if i != e)[:k]
        assert ("rec", chosen, (e,)) in core._decode_cache, \
            f"single-erasure signature {e} not prewarmed"
        rows_gf, rows_bits = core._decode_cache[("rec", chosen, (e,))]
        want_gf, want_bits = ref_core._recovery_rows(chosen, (e,))
        assert np.array_equal(rows_gf, want_gf)
        assert np.array_equal(rows_bits, want_bits)
    marks = {key for key in gpu_plugin._PREWARMED_SHAPES
             if key and key[0] == "dec"}
    codec.prewarm_decode(1024)       # second call must be a no-op
    assert {key for key in gpu_plugin._PREWARMED_SHAPES
            if key and key[0] == "dec"} == marks


# ---------------------------------------------------------------------
# degraded client reads through the batcher
# ---------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["classic", "crimson"])
def test_degraded_read_reconstructs_through_batcher(backend):
    """One OSD down: client reads return reconstructed bytes bit-exact,
    the reconstruction rides the OSD batcher's decode pipeline
    (dec_reqs > 0) instead of the inline CPU loop, and the client's read
    ledger still carries the decode_dispatch / decode_complete hops —
    under BOTH OSD execution models."""
    with Cluster(n_osds=4,
                 conf=make_conf(osd_backend=backend,
                                ec_tpu_queue_window_us=2000)) as c:
        for i in range(4):
            c.wait_for_osd_up(i, 20)
        c.create_ec_profile("ddp", plugin="gpu", k="2", m="1",
                            device="cpu")
        c.create_pool("ddpp", "erasure", erasure_code_profile="ddp")
        rad = c.rados(timeout=60)
        io = rad.open_ioctx("ddpp")
        blobs = {f"d{i}": os.urandom(32768) for i in range(8)}
        for oid, blob in blobs.items():
            io.write_full(oid, blob)
        c.wait_for_clean(30)
        c.kill_osd(3)
        c.wait_for_osd_down(3, 30)
        for oid, blob in blobs.items():
            assert io.read(oid) == blob, f"{oid} degraded read wrong"
        dec_reqs = sum(o.encode_batcher.dec_reqs
                       for o in c.osds.values() if o is not None)
        assert dec_reqs > 0, \
            "degraded reads bypassed the decode batcher"
        hops = rad.objecter.hops_read.dump()
        assert {"decode_dispatch", "decode_complete"} <= \
            set(hops["hop_counts"])


# ---------------------------------------------------------------------
# deep scrub: syndrome compare
# ---------------------------------------------------------------------
def test_scrub_syndrome_clean_pool_and_counters():
    """Live cluster with osd_deep_scrub_syndrome on: a clean pool
    deep-scrubs with ZERO errors and ZERO syndrome errors, the backends
    checksum through the windowed batched path, and the scrubber dump
    exports the syndrome counter."""
    with Cluster(n_osds=3,
                 conf=make_conf(osd_deep_scrub_syndrome=True)) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        c.create_ec_profile("syn", plugin="gpu", k="2", m="1",
                            device="cpu")
        c.create_pool("synp", "erasure", erasure_code_profile="syn")
        io = c.rados().open_ioctx("synp")
        for i in range(4):
            io.write_full(f"y{i}", os.urandom(16384))
        c.wait_for_clean(30)
        ret, _, out = c.mon_command({"prefix": "pg dump"})
        assert ret == 0
        pgids = sorted(out["pg_stats"])
        for pgid in pgids:
            ret, rs, _ = c.mon_command({"prefix": "pg deep-scrub",
                                        "pgid": pgid})
            assert ret == 0, rs
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            ret, _, out = c.mon_command({"prefix": "pg dump"})
            stats = out["pg_stats"]
            if all(stats.get(p, {}).get("last_deep_scrub", 0) > 0
                   for p in pgids):
                break
            time.sleep(0.2)
        else:
            raise TimeoutError("deep scrub never completed")
        for p in pgids:
            assert stats[p].get("num_scrub_errors", 0) == 0
        windows = syndrome = 0
        for osd in c.osds.values():
            for pg in osd.pgs.values():
                windows += getattr(pg.backend, "scrub_windows", 0)
                sc = getattr(pg, "scrubber", None)
                syndrome += getattr(sc, "syndrome_errors", 0)
                if sc is not None:
                    assert "syndrome_errors" in sc.dump()
        assert windows > 0, "deep scrub never used the windowed path"
        assert syndrome == 0, \
            "clean pool must not raise syndrome errors"


def test_scrub_syndrome_flags_unlocalizable_inconsistency():
    """The syndrome compare itself: per-shard CRCs all clean but the
    cross-shard partials XOR nonzero -> ONE unlocalizable syndrome
    error, no shard blamed, no auto-repair queued — the port's Scrubber
    and the JAX package's give the same verdicts on the same maps."""
    from ceph_tpu.osd.scrub import Scrubber as RefScrubber
    from ceph_tpu_torch.osd.scrub import Scrubber

    base = {"size": 100, "hinfo_ok": True}
    for cls in (Scrubber, RefScrubber):
        sc = cls.__new__(cls)
        sc.maps = {
            0: {"o": dict(base, syndrome_partials=[3])},
            1: {"o": dict(base, syndrome_partials=[5])},
            2: {"o": dict(base, syndrome_partials=[9])},
        }
        sc.syndrome_errors = 0
        out = {}
        sc._compare_ec(out)
        assert out == {}, \
            "syndrome inconsistency must not blame a shard"
        assert sc.syndrome_errors == 1
        # consistent partials (XOR zero) raise nothing
        sc.maps[2]["o"]["syndrome_partials"] = [3 ^ 5]
        sc.syndrome_errors = 0
        sc._compare_ec({})
        assert sc.syndrome_errors == 0

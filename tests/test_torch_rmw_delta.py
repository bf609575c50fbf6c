"""Port twins of tests/test_rmw_delta.py: the parity-delta route.

The delta overwrite path rests on GF(2^8) linearity:
``new_parity = old_parity ^ M[:, dirty]·(new ^ old)``.  These twins hold
the port's codec core, the `gpu` plugin's async delta (B1 on the
per-pool operand; its plain version on the CPU) and every store's
``xor_write`` to the full re-encode oracle, with the reference's
geometries, sizes and seeds; each delta is also held byte-equal to the
JAX package's on the same inputs.

Reference tests not twinned here:

- ``test_batcher_delta_device_route_bit_exact``,
  ``test_batcher_delta_twin_route_bit_exact`` and
  ``test_batcher_delta_inline_fallback_after_stop``: the tests of the
  same names in tests/test_torch_batcher.py.
- ``test_cluster_delta_rmw_bit_exact_and_counted`` and
  ``test_cluster_truncate_below_write_in_one_op``: the tests of the same
  names in tests/test_torch_cluster_ec.py.
"""
import os

import numpy as np
import pytest

from ceph_tpu.ec import registry as ref_registry
from ceph_tpu_torch.ec import registry as ecreg

GEOMETRIES = [(8, 4), (4, 2), (2, 1)]
CS = 4096


def _factory(plugin, k, m):
    prof = {"k": str(k), "m": str(m), "technique": "reed_sol_van",
            "w": "8"}
    if plugin == "gpu":
        prof["device"] = "cpu"
    return ecreg.instance().factory(plugin, prof)


def _ref_tpu(k, m):
    return ref_registry.instance().factory(
        "tpu", {"k": str(k), "m": str(m), "technique": "reed_sol_van",
                "w": "8"})


def _oracle_delta(jer, old, new):
    """Full re-encode oracle: Δparity == P(new) ^ P(old)."""
    return jer.core.encode_batch(old) ^ jer.core.encode_batch(new)


def _dirty_subsets(k):
    subs = [(0,), (k - 1,), tuple(range(k // 2))]
    if k > 2:
        subs.append((1, k - 2))
    return [tuple(sorted(set(s))) for s in subs]


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_core_delta_parity_matches_full_reencode(k, m):
    """CodecCore.delta_parity vs the full-encode oracle across dirty
    subsets and batch sizes, both plugins' cores, and equal to the JAX
    package's `tpu` core on the same inputs."""
    rng = np.random.default_rng(0xD417A + k)
    jer = _factory("jerasure", k, m)
    port = _factory("gpu", k, m)
    ref = _ref_tpu(k, m)
    for cols in _dirty_subsets(k):
        for nst in (1, 3, 17):
            old = rng.integers(0, 256, (nst, k, CS), dtype=np.uint8)
            new = old.copy()
            new[:, list(cols), :] = rng.integers(
                0, 256, (nst, len(cols), CS), dtype=np.uint8)
            delta = (old ^ new)[:, list(cols), :]
            want = _oracle_delta(jer, old, new)
            for core in (jer.core, port.core):
                got = core.delta_parity(delta, cols)
                assert got.shape == (nst, m, CS)
                assert np.array_equal(got, want), \
                    f"core delta diverged k={k} m={m} cols={cols}"
            assert np.array_equal(ref.core.delta_parity(delta, cols),
                                  want)


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_plugin_async_delta_matches_oracle(k, m):
    """`gpu` plugin delta_encode_batch_async (raw AsyncBatch) and the
    sync delta_encode_batch twin, vs the oracle and the JAX package's
    `tpu` async delta."""
    port = _factory("gpu", k, m)
    jer = _factory("jerasure", k, m)
    ref = _ref_tpu(k, m)
    assert port.delta_async_supported()
    rng = np.random.default_rng(0xA51C + k)
    for cols in _dirty_subsets(k):
        old = rng.integers(0, 256, (5, k, CS), dtype=np.uint8)
        new = old.copy()
        new[:, list(cols), :] ^= rng.integers(
            1, 256, (5, len(cols), CS), dtype=np.uint8)
        delta = (old ^ new)[:, list(cols), :]
        want = _oracle_delta(jer, old, new)
        got = np.asarray(port.delta_encode_batch_async(
            delta, cols).wait())
        assert np.array_equal(got, want)
        assert np.array_equal(port.delta_encode_batch(delta, cols),
                              want)
        assert np.array_equal(np.asarray(ref.delta_encode_batch_async(
            delta, cols).wait()), got)


@pytest.mark.parametrize("kind", ["mem", "file", "block", "bluestore"])
def test_store_xor_write_backends(kind, tmp_path):
    """xor_write applies X ^= D at offset on every store backend,
    zero-extending past EOF — the parity-shard apply the delta
    sub-write rides on."""
    from ceph_tpu_torch.store import (BlockStore, BlueStore, FileStore,
                                      GHObject, MemStore, Transaction)
    C = "1.0s0"
    mk = {"mem": lambda: MemStore(),
          "file": lambda: FileStore(str(tmp_path / "st")),
          "block": lambda: BlockStore(str(tmp_path / "st")),
          "bluestore": lambda: BlueStore(str(tmp_path / "st"))}[kind]
    st = mk()
    st.mkfs()
    st.mount()
    try:
        o = GHObject("o", 0)
        base = bytes(range(256)) * 16              # 4096 B
        t = Transaction().create_collection(C)
        t.write(C, o, 0, base)
        st.queue_transactions([t])
        patch = os.urandom(1024)
        tail = os.urandom(100)
        t2 = Transaction().xor_write(C, o, 512, patch)
        # past EOF: zero-extend means the plain bytes land verbatim
        t2.xor_write(C, o, 8000, tail)
        st.queue_transactions([t2])
        got = st.read(C, o, 0, 8100)
        want = bytearray(8100)
        want[:4096] = base
        for i in range(1024):
            want[512 + i] ^= patch[i]
        want[8000:8100] = tail
        assert got == bytes(want), f"xor_write diverged on {kind}"
    finally:
        st.umount()


def test_bluestore_xor_write_survives_remount(tmp_path):
    """xor_write rides BlueStore's WAL: the XOR result must survive a
    umount/remount exactly once (replay idempotent)."""
    from ceph_tpu_torch.store import BlueStore, GHObject, Transaction
    C = "1.0s0"
    path = str(tmp_path / "blue")
    st = BlueStore(path)
    st.mkfs()
    st.mount()
    o = GHObject("o", 0)
    base = os.urandom(4096)
    t = Transaction().create_collection(C)
    t.write(C, o, 0, base)
    st.queue_transactions([t])
    patch = os.urandom(4096)
    st.queue_transactions([Transaction().xor_write(C, o, 0, patch)])
    want = bytes(a ^ b for a, b in zip(base, patch))
    assert st.read(C, o, 0, 4096) == want
    st.umount()
    st2 = BlueStore(path)
    st2.mount()
    try:
        assert st2.read(C, o, 0, 4096) == want
    finally:
        st2.umount()

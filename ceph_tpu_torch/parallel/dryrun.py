"""Standalone smoke run of the sharded erasure-code step.

The port's counterpart of the entry points of the JAX package's
`__graft_entry__.py`:

entry(device)            -> (fn, example_args): the flagship k=8 m=4
                            reed_sol_van encode (fn(bitmatrix, data) ->
                            parity, one B1 launch) on ``device``.
dryrun_multichip(n, dev) -> builds an n-device dp x sp mesh (mesh.py),
                            runs the sharded encode with its integrity
                            digest, the sharded gf8 fast path, a degraded
                            decode of chunks (0, 5) and a batcher encode
                            through the mesh, each checked byte for byte
                            against the jerasure oracle.  With fewer
                            than n visible devices it runs itself in a
                            child process with CEPH_TPU_TORCH_FORCE_DEVICE_
                            COUNT=n (n logical devices on ``dev``).

    python -m ceph_tpu_torch.parallel.dryrun N [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import threading

import numpy as np
import torch

from ..ec import registry
from ..ops.carry import bitmatrix_operand
from ..ops.gf8_kernel import gf8_apply
from ..ops.matrix import (make_decoding_matrix, matrix_to_bitmatrix,
                          reed_sol_vandermonde_coding_matrix)
from ..ops.torch_engine import resolve_device
from . import mesh as pmesh

K, M, W = 8, 4, 8
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def entry(device="cuda"):
    """The flagship encode and an example batch [4, 8, 512] on
    ``device``: fn(bitmatrix, data) -> parity [4, 4, 512] through B1."""
    bitmatrix = matrix_to_bitmatrix(
        reed_sol_vandermonde_coding_matrix(K, M, W), W)

    def forward(bitmatrix, data: torch.Tensor) -> torch.Tensor:
        """data uint8 [batch, k, L] -> parity uint8 [batch, m, L]."""
        return gf8_apply(bitmatrix_operand(bitmatrix, K, data.device), data)

    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.integers(0, 256, (4, K, 512),
                                         dtype=np.uint8))
    return forward, (bitmatrix, data.to(resolve_device(device)))


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One sharded EC step on an n-device mesh, checked against the
    jerasure oracle; raises AssertionError on any difference."""
    if len(pmesh.visible_devices(device)) < n_devices:
        _dryrun_in_subprocess(n_devices, device)
        return
    mesh = pmesh.make_mesh(n_devices, device=device)
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]

    Mgf = reed_sol_vandermonde_coding_matrix(K, M, W)
    B = matrix_to_bitmatrix(Mgf, W)
    rng = np.random.default_rng(7)
    batch = 2 * dp
    L = 128 * sp
    data = rng.integers(0, 256, (batch, K, L), dtype=np.uint8)

    # full step: sharded encode + the integrity digest over every block
    parity, digest = pmesh.sharded_encode_fn(mesh, W)(
        B, pmesh.shard_batch(mesh, data))
    parity = np.asarray(parity)
    cpu = registry.instance().factory("jerasure", {"k": str(K),
                                                   "m": str(M)})
    ref = np.stack([cpu.core.encode(data[b]) for b in range(batch)])
    if not np.array_equal(parity, ref):
        raise AssertionError("sharded encode diverged from jerasure")

    # the sharded w=8 fast path must agree byte for byte too
    fast, _ = pmesh.sharded_encode_gf8_fn(mesh, Mgf)(
        pmesh.shard_batch(mesh, data))
    if not np.array_equal(np.asarray(fast), ref):
        raise AssertionError("sharded gf8 fast path diverged")

    # degraded read: lose chunks 0 and 5, decode on the same mesh with
    # the erasure signature's inverse rows
    avail = [1, 2, 3, 4, 6, 7, 8, 9]
    R = make_decoding_matrix(Mgf, W, avail)[[0, 5]]
    full = np.concatenate([data, parity], axis=1)
    rec, _ = pmesh.sharded_encode_fn(mesh, W)(
        matrix_to_bitmatrix(R, W), pmesh.shard_batch(mesh, full[:, avail]))
    rec = np.asarray(rec)
    if not (np.array_equal(rec[:, 0], data[:, 0])
            and np.array_equal(rec[:, 1], data[:, 5])):
        raise AssertionError("sharded degraded decode diverged")

    # the production path: the OSD's batcher dispatches through the
    # backend's mesh, one block a logical device
    from ..osd import ecutil
    from ..osd.batcher import EncodeBatcher
    codec = registry.instance().factory(
        "gpu", {"k": str(K), "m": str(M), "device": str(device)})
    if pmesh.shared_encoder(codec) is None:
        raise AssertionError("mesh encoder inactive on a multi-device host")
    sinfo = ecutil.StripeInfo(K, K * L)
    EncodeBatcher.reset_learning()
    bat = EncodeBatcher({"ec_tpu_min_device_bytes": 1,
                         "ec_tpu_fallback_cpu": False})
    got: dict = {}
    ev = threading.Event()
    try:
        bat.submit(codec, sinfo, data.tobytes(),
                   lambda ch: (got.update(ch or {}), ev.set()))
        if not ev.wait(120):
            raise AssertionError("batcher encode timed out")
        lanes = sorted({int(led["device"])
                        for led in bat.ledger_accum.recent()})
    finally:
        bat.stop()
    for j in range(M):
        want = np.ascontiguousarray(ref[:, j]).tobytes()
        if bytes(got[K + j]) != want:
            raise AssertionError(f"batcher parity shard {j} diverged")
    if lanes != mesh.device_ids:
        raise AssertionError(f"batcher dispatch lanes {lanes}, mesh "
                             f"{mesh.device_ids}")

    print(f"dryrun_multichip OK: mesh dp={dp} sp={sp} on "
          f"{mesh.physical_devices}, batch={batch}, L={L}, "
          f"digest={int(digest)}, batcher-via-mesh verified")


def _dryrun_in_subprocess(n_devices: int, device) -> None:
    """Run the dryrun in a fresh interpreter that sees ``n_devices``
    logical devices on ``device``, and propagate its verdict."""
    if os.environ.get(pmesh.FORCE_DEVICE_COUNT):
        raise AssertionError(
            f"the child still sees too few devices (wanted {n_devices}, "
            f"{pmesh.FORCE_DEVICE_COUNT}="
            f"{os.environ[pmesh.FORCE_DEVICE_COUNT]})")
    env = dict(os.environ, PYTHONPATH=_REPO)
    env[pmesh.FORCE_DEVICE_COUNT] = str(n_devices)
    cmd = [sys.executable, "-m", "ceph_tpu_torch.parallel.dryrun",
           str(n_devices), "--device", str(device)]
    try:
        proc = subprocess.run(cmd, env=env, cwd=_REPO, capture_output=True,
                              text=True, timeout=600)
    except subprocess.TimeoutExpired as e:
        err = e.stderr or b""
        if isinstance(err, bytes):
            err = err.decode(errors="replace")
        raise AssertionError(
            f"dryrun_multichip({n_devices}) timed out in its child after "
            f"600 s:\n{err[-2000:]}") from None
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(
            f"dryrun_multichip({n_devices}) failed in its child "
            f"(rc={proc.returncode}):\n{proc.stderr[-2000:]}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ceph_tpu_torch.parallel.dryrun",
        description="one sharded EC step on an N-device mesh, checked "
                    "against jerasure")
    p.add_argument("n_devices", nargs="?", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="torch device of the mesh (default cuda)")
    args = p.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Build a kernel source from csrc/ with nvcc and bind it with ctypes.

Each kernel module (gf8_kernel, packet_kernel, packet_xor_kernel) holds
one ``KernelLibrary``: its ``.cu`` source is compiled for sm_90a at first
use into build/kernels/ at the repo root, as a shared library with a
plain C entry point, and loaded with ctypes.  A missing nvcc or a failed
build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def nvcc() -> str:
    cand = shutil.which("nvcc")
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    if cand is None and os.path.exists(os.path.join(home, "bin", "nvcc")):
        cand = os.path.join(home, "bin", "nvcc")
    if cand is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return cand


class KernelLibrary:
    """One csrc/ source, its shared library and its C entry point."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = os.path.join(CSRC, source)
        self.path = os.path.join(
            BUILD_DIR, "lib" + os.path.splitext(source)[0] + ".so")
        self.symbol = symbol
        self.argtypes = argtypes
        self._fn = None
        self._lock = threading.Lock()

    def _newest_input(self) -> float:
        # the source and the headers it may include
        return max(os.path.getmtime(p) for p in
                   [self.source, *glob.glob(os.path.join(CSRC, "*.cuh"))])

    def build(self, verbose: bool = False) -> str:
        """Compile the source into a shared library (skipped when the
        library is newer than its inputs).  Returns the library path;
        raises on any build failure."""
        if (os.path.exists(self.path)
                and os.path.getmtime(self.path) >= self._newest_input()):
            return self.path
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{self.path}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, self.source]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {self.source}:\n{res.stderr}")
        if verbose:
            print(res.stderr.strip())
        os.replace(tmp, self.path)
        return self.path

    def fn(self):
        """The C entry point, building and loading the library once."""
        with self._lock:
            if self._fn is None:
                fn = getattr(ctypes.CDLL(self.build()), self.symbol)
                fn.restype = ctypes.c_int
                fn.argtypes = self.argtypes
                self._fn = fn
            return self._fn


def launch(lib: KernelLibrary, device, *args) -> None:
    """Call ``lib``'s entry point on ``device``'s current stream (passed
    last); raise if the launch was refused."""
    fn = lib.fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"{lib.symbol} launch failed: CUDA error {err}")

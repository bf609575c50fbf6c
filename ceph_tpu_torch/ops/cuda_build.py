"""Build a kernel source from csrc/ with nvcc and bind it with ctypes.

Each kernel module (gf8_kernel, packet_kernel, packet_xor_kernel) holds
one ``KernelLibrary``: its ``.cu`` source is compiled for sm_90a at first
use into build/kernels/ at the repo root, as a shared library with a
plain C entry point, and loaded with ctypes.  A missing nvcc or a failed
build raises; nothing falls back.  ``sass_opcodes`` counts a compiled
kernel's instructions (with the toolkit's cuobjdump), for reports.
"""
from __future__ import annotations

import collections
import ctypes
import glob
import os
import re
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

    def __init__(self, source: str, symbol: str, argtypes: list,
                 extra: dict | None = None):
        self.source = os.path.join(CSRC, source)
        self.path = os.path.join(
            BUILD_DIR, "lib" + os.path.splitext(source)[0] + ".so")
        self.symbol = symbol
        # every C function the library exports: name -> argtypes
        self.entries = {symbol: argtypes, **(extra or {})}
        self._cdll = None
        self._fns = {}
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

    def fn(self, name: str | None = None):
        """A C function of the library (the entry point by default),
        building and loading the library once."""
        name = name or self.symbol
        with self._lock:
            if name not in self._fns:
                if self._cdll is None:
                    self._cdll = ctypes.CDLL(self.build())
                fn = getattr(self._cdll, name)
                fn.restype = ctypes.c_int
                fn.argtypes = self.entries[name]
                self._fns[name] = fn
            return self._fns[name]


_SASS_LINE = re.compile(r"^\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                        r"([A-Z][A-Z0-9]*)\S*\s*([^;]*)")


def count_sass(text: str, function: str) -> dict:
    """Static opcode counts (without modifiers) in a cuobjdump -sass
    listing, over the functions whose mangled name contains ``function``:
    {"all": counts, "loop": counts of the innermost loop body (the span of
    a backward branch holding no other) with the most PRMTs}."""
    code, inside = [], False      # (address, opcode, operands)
    for line in text.splitlines():
        if "Function :" in line:
            inside = function in line
        elif inside and (m := _SASS_LINE.match(line)):
            code.append((int(m.group(1), 16), m.group(2), m.group(3)))
    spans = []                    # (first, last) address of each loop
    for addr, op, args in code:
        target = re.match(r"\s*(0x[0-9a-f]+)", args) if op == "BRA" else None
        if target and int(target.group(1), 16) < addr:
            spans.append((int(target.group(1), 16), addr))
    inner = [(a, b) for a, b in spans if not any(
        a <= c and d < b for c, d in spans if (c, d) != (a, b))]
    loops = [[o for x, o, _ in code if a <= x <= b] for a, b in inner]
    hot = max(loops, key=lambda ops: ops.count("PRMT"), default=[])
    return {"all": dict(collections.Counter(op for _, op, _ in code)),
            "loop": dict(collections.Counter(hot))}


def sass_opcodes(lib: KernelLibrary, function: str) -> dict | None:
    """``count_sass`` of ``lib``'s compiled code, read with the toolkit's
    cuobjdump; None when there is no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    res = subprocess.run([tool, "-sass", lib.build()], capture_output=True,
                         text=True, check=True)
    return count_sass(res.stdout, function)


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

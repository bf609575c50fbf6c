"""ceph_tpu_torch — the PyTorch and CUDA port of ceph_tpu, for one NVIDIA H100.

It sits beside the JAX package, mirrors its module names, and shares no
code with it: the JAX package stays the reference the port is held
against.  Ported so far, from the codec up:
  ceph_tpu_torch.ops    - GF(2^w) tables, coding matrices, CodecCore, the
                          torch engine and kernel B1 (csrc/gf8_bitplane.cu)
  ceph_tpu_torch.ec     - erasure-code interface, plugin registry, the CPU
                          `jerasure` plugin and the flagship `gpu` plugin
  ceph_tpu_torch.osd    - ecutil: stripe algebra, batched object encode and
                          decode, HashInfo CRCs; batcher: one OSD's
                          EncodeBatcher, coalescing writes, degraded reads
                          and overwrites into one device call per geometry
  ceph_tpu_torch.utils  - crc32c, and what the batcher stands on: config,
                          perf counters, flight recorder, device ledger,
                          faults, tuner, locks, lockdep, op tracker

Entry points run on CUDA unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

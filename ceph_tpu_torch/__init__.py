"""ceph_tpu_torch — the PyTorch and CUDA port of ceph_tpu, for one NVIDIA H100.

It sits beside the JAX package, mirrors its module names, and shares no
code with it: the JAX package stays the reference the port is held
against.  Every module of the JAX package has its counterpart here,
from the codec up:
  ceph_tpu_torch.ops    - GF(2^w) tables, coding matrices, CodecCore, the
                          torch engine, kernels B1, B2 and B3 (csrc/) and
                          crclinear, CRC32C as a bitmatrix apply
  ceph_tpu_torch.ec     - erasure-code interface, plugin registry, the CPU
                          `jerasure` plugin and the flagship `gpu` plugin
  ceph_tpu_torch.osd    - ecutil: stripe algebra, batched object encode and
                          decode, HashInfo CRCs; batcher: one OSD's
                          EncodeBatcher, coalescing writes, degraded reads
                          and overwrites into one device call per geometry;
                          the PG backends (ecbackend, replicatedbackend,
                          backend), pglog, snaps and osdmap; the daemon
                          side: pg, the classic OSD, the op scheduler and
                          the scrubber
  ceph_tpu_torch.store  - ObjectStore, MemStore, FileStore, BlockStore and
                          BlueStore, whose checksums run on B1 (crclinear)
  ceph_tpu_torch.msg    - Message, the type registry, the frame codec,
                          every message type and the TCP Messenger
  ceph_tpu_torch.mon    - the monitor (maps, pools, profiles, failures),
                          Paxos quorum and MonClient
  ceph_tpu_torch.client - librados-style Rados, IoCtx and the objecter
  ceph_tpu_torch.cluster - the in-process vstart: Cluster, test_config
  ceph_tpu_torch.crush  - CRUSH mapper and wrapper (placement)
  ceph_tpu_torch.compressor - the compressor registry (frames, BlueStore)
  ceph_tpu_torch.auth, .mgr - the keyring; the SLO and health helpers
  ceph_tpu_torch.parallel - the dp x sp device mesh the backend shards
                          byte-code batches over (B1 on every block) and
                          its dryrun; one device means no mesh
  ceph_tpu_torch.utils  - crc32c, and what the batcher and the daemons
                          stand on: config, logging, perf counters, flight
                          recorder, device ledger, faults, tuner, locks,
                          lockdep, op tracker, hops, timer wheel, tracer,
                          critical path, sampler, admin socket, machine
                          factor

Entry points run on CUDA unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

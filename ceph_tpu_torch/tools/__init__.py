"""CLI tooling (reference ``src/ceph.in`` + ``src/tools/``, §2.6).

Each module is runnable as ``python -m ceph_tpu_torch.tools.<name>``:

- ``ceph_cli``          — cluster admin CLI (``ceph``)
- ``rados_cli``         — object CLI + ``bench`` (``rados``)
- ``ec_tool``           — offline encode/decode (``ceph-erasure-code-tool``)
- ``ec_benchmark``      — codec microbench (``ceph_erasure_code_benchmark``)
- ``crushtool``         — CRUSH build/test (``crushtool``)
- ``osdmaptool``        — OSDMap inspection (``osdmaptool``)
- ``objectstore_tool``  — offline store access (``ceph-objectstore-tool``)
- ``vstart``            — standalone dev cluster (``vstart.sh``)
"""

"""``vstart`` — run a development cluster as a standalone process.

Reference analog: ``src/vstart.sh`` (1,573 lines of bash spinning
mon+mgr+osd from a build tree; ``-e`` pre-creates an EC pool at
``:210``).  Here the daemons are the framework's own Monitor/OSD
objects in one process; the monitor address is printed (and written to
``--out-conf``) so the ``ceph``/``rados`` tools in other processes can
reach it over TCP.

    python -m ceph_tpu_torch.tools.vstart -n 3 -d /tmp/ctpu --ec-pool
    CEPH_TPU_MON=$(cat /tmp/ctpu/mon.addr) python -m ceph_tpu_torch.tools.ceph_cli status
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import time
from typing import List


def main(argv: List[str] = None) -> int:
    p = argparse.ArgumentParser(prog="vstart",
                                description=__doc__.splitlines()[0])
    p.add_argument("-n", "--num-osds", type=int, default=3)
    p.add_argument("--num-mons", type=int, default=1,
                   help="monitor quorum size (paxos replication)")
    p.add_argument("--mgr", action="store_true",
                   help="start a manager (perf aggregation + "
                        "prometheus /metrics endpoint)")
    p.add_argument("--rgw", action="store_true",
                   help="start an S3 gateway on pool '.rgw' "
                        "(created if absent)")
    p.add_argument("-d", "--data-dir",
                   help="FileStore-backed daemons (default: MemStore)")
    p.add_argument("--objectstore", choices=("file", "block"),
                   default="file",
                   help="store backend with -d (block = BlueStore-"
                        "style raw block space + allocator)")
    p.add_argument("-e", "--ec-pool", action="store_true",
                   help="pre-create EC profile 'gpuprof' (plugin=gpu "
                   "k=2 m=1) + pool 'ecpool' (vstart.sh -e)")
    p.add_argument("--ec-k", type=int, default=2)
    p.add_argument("--ec-m", type=int, default=1)
    p.add_argument("--ec-plugin", default="gpu")
    p.add_argument("--device", default="cuda",
                   help="device of a gpu EC profile (cpu: run its codec "
                        "on the CPU)")
    p.add_argument("--osd-backend", choices=("classic", "crimson"),
                   default="crimson",
                   help="OSD execution model (default crimson since "
                        "the shard-per-core flip): crimson runs N "
                        "reactor shards with PGs partitioned by "
                        "hash(pgid) %% N; classic keeps the sharded "
                        "thread pools; use --crimson-osds for a "
                        "mixed cluster")
    p.add_argument("--crimson-osds", default="",
                   help="comma-separated OSD ids to run crimson while "
                        "the rest follow --osd-backend (side-by-side "
                        "compare, e.g. with --osd-backend classic)")
    p.add_argument("--out-conf", help="file to write the mon address to "
                   "(default <data-dir>/mon.addr)")
    ns = p.parse_args(argv)

    from ..cluster import Cluster, test_config

    conf = test_config(osd_backend=ns.osd_backend)
    cluster = Cluster(n_osds=ns.num_osds, data_dir=ns.data_dir,
                      conf=conf, n_mons=ns.num_mons, with_mgr=ns.mgr,
                      store_kind=ns.objectstore)
    # mixed-backend cluster: the listed ids boot crimson, others follow
    # --osd-backend (overrides are sticky across kill/revive)
    for tok in ns.crimson_osds.split(","):
        if tok.strip():
            cluster.backend_overrides[int(tok)] = "crimson"
    cluster.start()
    host, port = cluster.mon_addr
    addr = f"{host}:{port}"
    if ns.ec_pool:
        extra = {"device": ns.device} if (ns.ec_plugin == "gpu"
                                          and ns.device != "cuda") else {}
        cluster.create_ec_profile("gpuprof", plugin=ns.ec_plugin,
                                  k=str(ns.ec_k), m=str(ns.ec_m), **extra)
        cluster.create_pool("ecpool", "erasure",
                            erasure_code_profile="gpuprof")
    out_conf = ns.out_conf or (os.path.join(ns.data_dir, "mon.addr")
                               if ns.data_dir else None)
    if out_conf:
        with open(out_conf, "w") as f:
            f.write(addr + "\n")
    print(f"vstart: {ns.num_osds} osds up, "
          f"{ns.num_mons} mon(s), mon.0 at {addr}")
    if cluster.mgr is not None:
        mh, mp = cluster.mgr.http_addr
        print(f"mgr metrics: http://{mh}:{mp}/metrics")
    rgw_srv = None
    if ns.rgw:
        from ..rgw.server import RGWServer
        cluster.create_pool(".rgw", "replicated",
                            size=min(2, ns.num_osds))
        rgw_client = cluster.rados()
        rgw_srv = RGWServer(rgw_client.open_ioctx(".rgw")).start()
        rh, rp = rgw_srv.addr
        print(f"rgw S3 endpoint: http://{rh}:{rp}/")
    print(f"export CEPH_TPU_MON={addr}")
    sys.stdout.flush()

    stop = []
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    try:
        while not stop:
            time.sleep(0.2)
    finally:
        if rgw_srv is not None:
            rgw_srv.shutdown()
        cluster.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())

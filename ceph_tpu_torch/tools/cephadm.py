"""cephadm-style deployment: spec-driven cluster bootstrap + service
management.

Python-native equivalent of the reference's orchestration layer
(reference ``src/cephadm/`` + the ``ceph orch`` mgr module) collapsed
to what a single-host (or test-host) deployment needs:

* a **service spec** (JSON) names the daemons to run — mons, osds
  (with store kind + data paths), mgr, rgw, mds — like cephadm's
  service specs;
* ``bootstrap`` brings the cluster up from the spec: mon quorum
  first, then OSDs (creating their data dirs/stores), then the
  service daemons, writing a ``cluster.json`` handle with addresses;
* ``orch ls / ps / apply / daemon stop|start`` manage the running
  set, mirroring the ``ceph orch`` verbs.

Daemons run as threads of this process (the framework's daemons are
in-process objects; the reference runs containers — the management
surface is what's mirrored, not the container runtime).

CLI::

    python -m ceph_tpu_torch.tools.cephadm bootstrap --spec spec.json --shell
    # then, at the orch> prompt: orch ls | orch ps |
    #   daemon stop osd.1 | daemon start osd.1 | orch apply osd 4
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

DEFAULT_SPEC = {
    "mon": {"count": 1},
    "osd": {"count": 3, "store": "mem"},
    "mgr": {"count": 0},
    "rgw": {"count": 0, "pool": "rgw"},
    "mds": {"count": 0, "meta_pool": "fsmeta", "data_pool": "fsdata"},
}


class CephAdm:
    """One deployed cluster under management (reference cephadm shell
    + orchestrator state)."""

    def __init__(self, spec: Optional[dict] = None,
                 data_dir: str = ""):
        self.spec = {**DEFAULT_SPEC, **(spec or {})}
        for k, v in DEFAULT_SPEC.items():
            if isinstance(v, dict):
                self.spec[k] = {**v, **self.spec.get(k, {})}
        self.data_dir = data_dir
        self.cluster = None
        self.services: Dict[str, object] = {}   # name -> daemon obj
        # how to (re)create each service daemon: restartable stop/start
        self._factories: Dict[str, object] = {}

    # -- bootstrap (reference cephadm bootstrap) -----------------------
    def bootstrap(self):
        try:
            return self._bootstrap()
        except Exception:
            # partial bring-up must not leak daemon threads/ports: the
            # caller never receives the handle, so clean up here
            self.shutdown()
            raise

    def _bootstrap(self):
        from ..cluster import Cluster, test_config
        osd_spec = self.spec["osd"]
        self.cluster = Cluster(
            n_osds=osd_spec.get("count", 3),
            n_mons=self.spec["mon"].get("count", 1),
            data_dir=self.data_dir or None,
            store_kind=osd_spec.get("store", "mem"),
            conf=test_config(**self.spec.get("conf", {})))
        self.cluster.__enter__()
        for i in range(osd_spec.get("count", 3)):
            self.cluster.wait_for_osd_up(i, 60)
        if self.spec["mgr"].get("count"):
            from ..mgr.manager import Manager

            def mk_mgr():
                return Manager(self.cluster.client_mon_addrs(),
                               conf=self.cluster.conf).start()
            self._factories["mgr.x"] = mk_mgr
            self.services["mgr.x"] = mk_mgr()
        if self.spec["rgw"].get("count"):
            pool = self.spec["rgw"].get("pool", "rgw")
            self.cluster.create_pool(pool, "replicated",
                                     size=min(2, len(
                                         self.cluster.osds)))
            from ..rgw.server import RGWServer

            def mk_rgw():
                io = self.cluster.rados().open_ioctx(pool)
                return RGWServer(io).start()
            self._factories["rgw.x"] = mk_rgw
            self.services["rgw.x"] = mk_rgw()
        if self.spec["mds"].get("count"):
            meta = self.spec["mds"].get("meta_pool", "fsmeta")
            data = self.spec["mds"].get("data_pool", "fsdata")
            for p in (meta, data):
                self.cluster.create_pool(p, "replicated",
                                         size=min(2, len(
                                             self.cluster.osds)))
            from ..mds import MDSDaemon

            def mk_mds():
                return MDSDaemon(self.cluster.client_mon_addrs(), meta,
                                 data,
                                 conf=self.cluster.conf).start()
            self._factories["mds.a"] = mk_mds
            self.services["mds.a"] = mk_mds()
        return self

    def shutdown(self):
        for name, svc in list(self.services.items()):
            try:
                svc.shutdown()
            except Exception:
                pass
        if self.cluster is not None:
            self.cluster.__exit__(None, None, None)

    # -- orch verbs (reference `ceph orch`) ----------------------------
    def orch_ls(self) -> List[dict]:
        out = [{"service": "mon",
                "running": len([m for m in self.cluster.mons.values()
                                if m is not None])},
               {"service": "osd",
                "running": len([o for o in self.cluster.osds.values()
                                if o is not None])}]
        for kind in ("mgr", "rgw", "mds"):
            known = [s for s in self._factories if s.startswith(kind)]
            if known:
                out.append({"service": kind,
                            "running": len([s for s in known
                                            if s in self.services])})
        return out

    def orch_ps(self) -> List[dict]:
        rows = []
        for r, m in sorted(self.cluster.mons.items()):
            rows.append({"daemon": f"mon.{r}",
                         "status": "running" if m else "stopped",
                         "addr": list(m.my_addr) if m else None})
        for i, o in sorted(self.cluster.osds.items()):
            rows.append({"daemon": f"osd.{i}",
                         "status": "running" if o else "stopped",
                         "addr": list(o.my_addr) if o else None})
        for name in sorted(self._factories):
            svc = self.services.get(name)
            addr = (getattr(svc, "my_addr", None)
                    or getattr(svc, "addr", None)) if svc else None
            rows.append({"daemon": name,
                         "status": "running" if svc else "stopped",
                         "addr": list(addr) if addr else None})
        return rows

    def daemon_stop(self, name: str) -> None:
        kind, _, ident = name.partition(".")
        if kind == "osd":
            self.cluster.kill_osd(int(ident))
        elif kind == "mon":
            self.cluster.kill_mon(int(ident))
        elif name in self.services:
            self.services.pop(name).shutdown()
        else:
            raise KeyError(name)

    def daemon_start(self, name: str) -> None:
        kind, _, ident = name.partition(".")
        if kind == "osd":
            self.cluster.revive_osd(int(ident))
        elif kind == "mon":
            self.cluster.revive_mon(int(ident))
        elif name in self._factories:
            if name not in self.services:
                self.services[name] = self._factories[name]()
        else:
            raise KeyError(name)

    def orch_apply_osd(self, count: int) -> int:
        """Scale the OSD service up (reference `ceph orch apply osd`);
        -> number of new daemons."""
        started = 0
        # declarative: count DEPLOYED daemons (a stopped daemon is
        # still deployed — replacing it would over-provision CRUSH)
        while len(self.cluster.osds) < count:
            new_id = max(self.cluster.osds, default=-1) + 1
            self.cluster.start_osd(new_id)
            self.cluster.wait_for_osd_up(new_id, 60)
            started += 1
        return started


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cephadm",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("bootstrap")
    b.add_argument("--spec", help="service spec JSON file")
    b.add_argument("--data-dir", default="")
    b.add_argument("--seconds", type=float, default=5.0,
                   help="keep the cluster up this long (demo mode)")
    b.add_argument("--shell", action="store_true",
                   help="interactive orch shell on stdin")
    ns = p.parse_args(argv)
    if ns.cmd == "bootstrap":
        spec = json.loads(open(ns.spec).read()) if ns.spec else {}
        adm = CephAdm(spec, data_dir=ns.data_dir).bootstrap()
        try:
            print(json.dumps({"services": adm.orch_ls(),
                              "daemons": adm.orch_ps()}, indent=1))
            if ns.shell:
                _shell(adm)
            else:
                time.sleep(ns.seconds)
        finally:
            adm.shutdown()
        return 0
    return 2


def _shell(adm: CephAdm, stdin=None) -> None:
    """`ceph orch`-verb REPL over a live deployment."""
    stdin = stdin or sys.stdin
    sys.stdout.write("orch> ")
    sys.stdout.flush()
    for line in stdin:
        words = line.split()
        try:
            if words[:2] == ["orch", "ls"]:
                print(json.dumps(adm.orch_ls()))
            elif words[:2] == ["orch", "ps"]:
                print(json.dumps(adm.orch_ps()))
            elif words[:2] == ["daemon", "stop"]:
                adm.daemon_stop(words[2])
                print("stopped", words[2])
            elif words[:2] == ["daemon", "start"]:
                adm.daemon_start(words[2])
                print("started", words[2])
            elif words[:3][:2] == ["orch", "apply"] and \
                    words[2] == "osd":
                print("started", adm.orch_apply_osd(int(words[3])))
            elif words == ["exit"] or words == ["quit"]:
                return
            elif words:
                print("? orch ls|ps, daemon stop|start <name>, "
                      "orch apply osd <n>, exit")
        except Exception as e:       # keep the shell alive
            print(f"error: {e!r}")
        sys.stdout.write("orch> ")
        sys.stdout.flush()


if __name__ == "__main__":
    sys.exit(main())

"""prometheus mgr module: /metrics text exposition.

Reference analog: ``src/pybind/mgr/prometheus/module.py`` — every
aggregated perf counter plus cluster gauges in the Prometheus text
format, served through the mgr's HTTP frontend.

Histogram counter sets (PerfCounters.add_histogram — e.g. the OSD
``ec_batcher`` subsystem's queue_wait_us / batch_stripes /
dispatch_ms) render in the native Prometheus histogram convention:
cumulative ``_bucket{le=...}`` samples ending at ``le="+Inf"`` plus a
``_count``, all contiguous under one ``# TYPE ... histogram`` line,
and derived p50/p95/p99 gauges interpolated from the raw buckets
(same math as PromQL histogram_quantile).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from . import MgrModule

_QUANTILES = ((0.50, "p50"), (0.95, "p95"), (0.99, "p99"))

# Perf dumps carry values, not counter kinds, so level-style metrics
# (TYPE_U64 set_ gauges) are recognised by naming convention — the
# ec_device subsystem's *_now / *_bps / *_hwm occupancy gauges and
# the staging-pool level samples must not be typed "counter" or
# rate() over them is nonsense.
_GAUGE_SUFFIXES = ("_now", "_bps", "_hwm", "_in_flight", "_slots",
                   # memory-accounting + pipeline-efficiency gauges
                   # (ec_device: staging ring peak bytes, compile
                   # cache occupancy, overlap engine verdict)
                   "_peak", "_entries", "_frac")


def _scalar_type(metric: str) -> str:
    return "gauge" if metric.endswith(_GAUGE_SUFFIXES) else "counter"


def _histogram_percentile(bounds: List[float], buckets: List[int],
                          q: float) -> float:
    """The q-quantile of a (bounds, buckets) histogram as dumped by
    PerfCounters (len(buckets) == len(bounds) + 1; the last bucket is
    the overflow).  Linear interpolation inside the landing bucket,
    clamped to the last finite bound for the overflow bucket —
    exactly PromQL's histogram_quantile."""
    total = sum(buckets)
    if total <= 0 or not bounds:
        return 0.0
    target = q * total
    cum = 0.0
    for i, count in enumerate(buckets):
        if cum + count >= target and count > 0:
            if i >= len(bounds):        # overflow bucket
                return float(bounds[-1])
            lo = float(bounds[i - 1]) if i > 0 else 0.0
            hi = float(bounds[i])
            return lo + (hi - lo) * (target - cum) / count
        cum += count
    return float(bounds[-1])


def render(osdmap, perf: Dict[str, dict]) -> str:
    lines: List[str] = []
    n_up = sum(1 for i in osdmap.osds.values() if i.up)
    n_in = sum(1 for i in osdmap.osds.values() if i.weight > 0)
    lines.append("# TYPE ceph_osd_up gauge")
    lines.append(f"ceph_osd_up {n_up}")
    lines.append("# TYPE ceph_osd_in gauge")
    lines.append(f"ceph_osd_in {n_in}")
    lines.append("# TYPE ceph_osdmap_epoch counter")
    lines.append(f"ceph_osdmap_epoch {osdmap.epoch}")
    lines.append("# TYPE ceph_pool_count gauge")
    lines.append(f"ceph_pool_count {len(osdmap.pools)}")
    # metric-major grouping: the exposition format requires all
    # samples of one family to be contiguous under its # TYPE line
    families: Dict[str, List[Tuple[str, float]]] = {}
    ftypes: Dict[str, str] = {}
    hists: Dict[str, List[Tuple[str, List[float], List[int]]]] = {}
    # fault-injection sites (utils/faults.py counters riding the OSD
    # perf dump): site names carry dots, so they become a label —
    # ceph_fault_site_trips{daemon=...,site="device.dispatch"}
    fault_samples: List[Tuple[str, str, dict]] = []
    for daemon in sorted(perf):
        for subsys, counters in perf[daemon].items():
            if subsys == "faults":
                for site, c in sorted(counters.items()):
                    if isinstance(c, dict):
                        fault_samples.append((daemon, site, c))
                continue
            for cname, val in counters.items():
                metric = f"ceph_{subsys}_{cname}"
                if isinstance(val, dict) and "buckets" in val:
                    bounds = list(val.get("bounds", []))
                    buckets = list(val["buckets"])
                    hists.setdefault(metric, []).append(
                        (daemon, bounds, buckets))
                    for q, sfx in _QUANTILES:
                        pm = f"{metric}_{sfx}"
                        ftypes[pm] = "gauge"
                        families.setdefault(pm, []).append(
                            (daemon,
                             _histogram_percentile(bounds, buckets,
                                                   q)))
                elif isinstance(val, dict):        # timeavg
                    for part, sfx in (("sum", "total"),
                                      ("avgcount", "count")):
                        if part in val:
                            families.setdefault(
                                f"{metric}_{sfx}", []).append(
                                (daemon, val[part]))
                elif isinstance(val, (int, float)):
                    families.setdefault(metric, []).append(
                        (daemon, val))
    for metric in sorted(families):
        lines.append(
            f"# TYPE {metric} {ftypes.get(metric) or _scalar_type(metric)}")
        for daemon, val in families[metric]:
            lines.append(f'{metric}{{daemon="{daemon}"}} {val}')
    for metric in sorted(hists):
        lines.append(f"# TYPE {metric} histogram")
        for daemon, bounds, buckets in hists[metric]:
            cum = 0
            for bound, count in zip(bounds, buckets):
                cum += count
                lines.append(
                    f'{metric}_bucket{{daemon="{daemon}",'
                    f'le="{bound}"}} {cum}')
            cum += buckets[len(bounds)] if len(buckets) > len(bounds) \
                else 0
            lines.append(
                f'{metric}_bucket{{daemon="{daemon}",'
                f'le="+Inf"}} {cum}')
            lines.append(f'{metric}_count{{daemon="{daemon}"}} {cum}')
    for cname, ftype in (("hits", "counter"), ("trips", "counter"),
                         ("armed", "gauge")):
        if not fault_samples:
            break
        metric = f"ceph_fault_site_{cname}"
        lines.append(f"# TYPE {metric} {ftype}")
        for daemon, site, c in fault_samples:
            lines.append(f'{metric}{{daemon="{daemon}",'
                         f'site="{site}"}} {int(c.get(cname, 0))}')
    return "\n".join(lines) + "\n"


class Module(MgrModule):
    NAME = "prometheus"

    def _metrics(self):
        body = render(self.get_osdmap(),
                      self.get("perf_counters")).encode()
        return "text/plain; version=0.0.4", body

    def http_routes(self):
        return {"/metrics": self._metrics, "": self._metrics}

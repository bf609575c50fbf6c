"""CrushWrapper — the administrative shell around the mapper.

Python-native equivalent of the reference's CrushWrapper (reference
src/crush/CrushWrapper.cc, 4.2k LoC): named types and buckets, tree
building (``add_bucket``/``insert_item``/``move``), simple-rule
construction for replicated and erasure pools (reference
CrushWrapper::add_simple_rule), device classes implemented as per-class
shadow hierarchies (reference CrushWrapper::populate_classes /
device_class_clone), and the ``do_rule`` entry the OSDMap calls
(reference osd/OSDMap.cc:2403-2415).

Default type hierarchy mirrors the reference's default map:
0=osd 1=host 2=chassis 3=rack ... 10=root (crush/CrushWrapper.h types).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .mapper import CRUSH_ITEM_NONE, Bucket, CrushMap, Rule

DEFAULT_TYPES = {
    0: "osd", 1: "host", 2: "chassis", 3: "rack", 4: "row", 5: "pdu",
    6: "pod", 7: "room", 8: "datacenter", 9: "zone", 10: "region",
    11: "root",
}


def weight_to_fixed(w: float) -> int:
    return max(0, int(round(w * 0x10000)))


class CrushWrapper:
    def __init__(self) -> None:
        self.map = CrushMap()
        self.types: Dict[int, str] = dict(DEFAULT_TYPES)
        self.bucket_names: Dict[int, str] = {}   # bucket id -> name
        self.name_ids: Dict[str, int] = {}       # name -> id (devices too)
        self.device_classes: Dict[int, str] = {}  # osd id -> class name
        # class shadow trees: (bucket_id, class) -> shadow bucket id
        self._class_shadow: Dict[Tuple[int, str], int] = {}
        self.rule_max_size: Dict[int, int] = {}

    # -- types -------------------------------------------------------------
    def type_id(self, name: str) -> int:
        for tid, tname in self.types.items():
            if tname == name:
                return tid
        raise KeyError(f"unknown crush type {name!r}")

    # -- buckets / items ---------------------------------------------------
    def add_bucket(self, name: str, type_name: str,
                   alg: str = "straw2") -> int:
        if name in self.name_ids:
            raise KeyError(f"bucket {name!r} exists")
        bid = self.map.new_bucket_id()
        bucket = Bucket(bid, self.type_id(type_name), alg)
        self.map.add_bucket(bucket)
        self.bucket_names[bid] = name
        self.name_ids[name] = bid
        return bid

    def get_bucket(self, name: str) -> Bucket:
        return self.map.buckets[self.name_ids[name]]

    def insert_item(self, item_id: int, weight: float, name: str,
                    parent: str, device_class: str = "") -> None:
        """Add a device (item_id >= 0) or link a bucket (< 0) under
        ``parent``, updating ancestor weights (reference
        CrushWrapper::insert_item)."""
        fixed = weight_to_fixed(weight)
        self.get_bucket(parent).add_item(item_id, fixed)
        if item_id >= 0:
            self.map.note_device(item_id)
            self.name_ids[f"osd.{item_id}"] = item_id
            if device_class:
                self.device_classes[item_id] = device_class
        self._adjust_ancestor_weights(parent)
        self._invalidate_shadows()

    def move_bucket(self, name: str, new_parent: str) -> None:
        bid = self.name_ids[name]
        old_parents = []
        for b in self.map.buckets.values():
            if bid in b.items:
                b.remove_item(bid)
                old_parents.append(b.id)
        self.get_bucket(new_parent).add_item(
            bid, self.map.buckets[bid].weight)
        for pid in old_parents:
            pname = self.bucket_names.get(pid)
            if pname:
                self._adjust_ancestor_weights(pname)
        self._adjust_ancestor_weights(new_parent)
        self._invalidate_shadows()

    def adjust_item_weight(self, item_id: int, weight: float) -> None:
        fixed = weight_to_fixed(weight)
        for b in self.map.buckets.values():
            if item_id in b.items:
                b.adjust_item_weight(item_id, fixed)
                parent = self.bucket_names.get(b.id)
                if parent:
                    self._adjust_ancestor_weights(parent)
        self._invalidate_shadows()

    def remove_item(self, item_id: int) -> None:
        parents = []
        for b in self.map.buckets.values():
            if item_id in b.items:
                b.remove_item(item_id)
                parents.append(b.id)
        self.device_classes.pop(item_id, None)
        for pid in parents:
            pname = self.bucket_names.get(pid)
            if pname:
                self._adjust_ancestor_weights(pname)
        self._invalidate_shadows()

    def ancestor_of(self, name: str, type_name: str) -> str:
        """Name of the ``type_name``-level ancestor containing ``name``
        (reference CrushWrapper::get_parent_of_type, used by the
        monitor's reporter-subtree failure heuristic)."""
        want = self.type_id(type_name)
        cur = self.name_ids[name]
        while True:
            if cur < 0 and self.map.buckets[cur].type == want:
                return self.bucket_names[cur]
            parent = next((b.id for b in self.map.buckets.values()
                           if cur in b.items and b.id not in
                           self._class_shadow.values()), None)
            if parent is None:
                raise KeyError(f"no {type_name} ancestor of {name}")
            cur = parent

    def _adjust_ancestor_weights(self, name: str) -> None:
        bid = self.name_ids[name]
        new_weight = self.map.buckets[bid].weight
        for b in self.map.buckets.values():
            if bid in b.items:
                b.adjust_item_weight(bid, new_weight)
                parent = self.bucket_names.get(b.id)
                if parent:
                    self._adjust_ancestor_weights(parent)

    # -- device classes (reference CrushWrapper::device_class_clone) ------
    def _invalidate_shadows(self) -> None:
        """Topology changed: refresh every shadow bucket's contents in
        place.  Shadow ids are stable so existing rules' take steps stay
        valid (the reference likewise rebuilds shadow trees under the
        same ids on map changes)."""
        refreshed = set()

        def refresh(bid: int, cls: str) -> int:
            key = (bid, cls)
            if key not in self._class_shadow:
                return self._clone_for_class(bid, cls)  # fresh build
            sid = self._class_shadow[key]
            if key in refreshed:
                return sid
            refreshed.add(key)
            src = self.map.buckets[bid]
            shadow = self.map.buckets[sid]
            shadow.items = []
            shadow.weights = []
            for item, w in zip(src.items, src.weights):
                if item >= 0:
                    if self.device_classes.get(item) == cls:
                        shadow.add_item(item, w)
                else:
                    child = refresh(item, cls)
                    cw = self.map.buckets[child].weight
                    if cw > 0:
                        shadow.add_item(child, cw)
            return sid

        for (bid, cls) in list(self._class_shadow):
            refresh(bid, cls)

    def class_shadow_root(self, root: str, device_class: str) -> int:
        """Clone ``root``'s subtree keeping only devices of
        ``device_class`` (empty class keeps everything)."""
        if not device_class:
            return self.name_ids[root]
        return self._clone_for_class(self.name_ids[root], device_class)

    def _clone_for_class(self, bid: int, cls: str) -> int:
        key = (bid, cls)
        if key in self._class_shadow:
            return self._class_shadow[key]
        src = self.map.buckets[bid]
        sid = self.map.new_bucket_id()
        shadow = Bucket(sid, src.type, src.alg)
        self.map.add_bucket(shadow)
        self._class_shadow[key] = sid
        for item, w in zip(src.items, src.weights):
            if item >= 0:
                if self.device_classes.get(item) == cls:
                    shadow.add_item(item, w)
            else:
                child = self._clone_for_class(item, cls)
                cw = self.map.buckets[child].weight
                if cw > 0:
                    shadow.add_item(child, cw)
        return sid

    # -- rules -------------------------------------------------------------
    def add_simple_rule(self, name: str, root: str, failure_domain: str,
                        device_class: str = "", mode: str = "firstn",
                        pool_type: str = "replicated") -> int:
        """Build take→chooseleaf→emit (reference
        CrushWrapper::add_simple_rule_at).  ``mode`` 'indep' gives EC
        hole semantics; choose n = result_max (n=0)."""
        if any(r.name == name for r in self.map.rules):
            raise KeyError(f"rule {name!r} exists")
        take_id = self.class_shadow_root(root, device_class)
        steps: List[tuple] = [("take", take_id)]
        if mode == "indep":
            steps.append(("set_chooseleaf_tries", 5))  # reference :83
        domain_type = self.type_id(failure_domain)
        if domain_type == 0:
            steps.append((f"choose_{mode}", 0, 0))
        else:
            steps.append((f"chooseleaf_{mode}", 0, domain_type))
        steps.append(("emit",))
        rule = Rule(name, steps, pool_type)
        self.map.rules.append(rule)
        return len(self.map.rules) - 1

    def rule_id(self, name: str) -> int:
        for i, r in enumerate(self.map.rules):
            if r.name == name:
                return i
        raise KeyError(f"unknown rule {name!r}")

    def set_rule_mask_max_size(self, ruleid: int, size: int) -> None:
        self.rule_max_size[ruleid] = size
        self.map.rules[ruleid].max_size = size

    # -- mapping -----------------------------------------------------------
    def do_rule(self, ruleno: int, x: int, result_max: int,
                osd_weights: Sequence[int]) -> List[int]:
        """reference crush_do_rule via OSDMap::_pg_to_raw_osds."""
        return self.map.do_rule(ruleno, x, result_max, osd_weights)

    # -- wire form (reference CrushWrapper::encode/decode) ----------------
    def to_wire_dict(self) -> Dict:
        """Full-fidelity serialization (shadow buckets included) so the
        monitor can ship the map in MOSDMap and clients rebuild an
        identical mapper."""
        return {
            "types": {str(k): v for k, v in self.types.items()},
            "max_devices": self.map.max_devices,
            "buckets": [
                {"id": b.id, "type": b.type, "alg": b.alg,
                 "items": list(b.items), "weights": list(b.weights)}
                for b in self.map.buckets.values()],
            "bucket_names": {str(k): v
                             for k, v in self.bucket_names.items()},
            "name_ids": dict(self.name_ids),
            "device_classes": {str(k): v
                               for k, v in self.device_classes.items()},
            "class_shadow": [[bid, cls, sid] for (bid, cls), sid
                             in self._class_shadow.items()],
            "rules": [
                {"name": r.name, "steps": [list(s) for s in r.steps],
                 "rule_type": r.rule_type,
                 "max_size": getattr(r, "max_size", 0)}
                for r in self.map.rules],
            "rule_max_size": {str(k): v
                              for k, v in self.rule_max_size.items()},
        }

    @classmethod
    def from_wire_dict(cls, d: Dict) -> "CrushWrapper":
        crush = cls()
        crush.types = {int(k): v for k, v in d["types"].items()}
        crush.map.max_devices = d["max_devices"]
        for bd in d["buckets"]:
            bucket = Bucket(bd["id"], bd["type"], bd["alg"],
                            items=bd["items"], weights=bd["weights"])
            crush.map.add_bucket(bucket)
        crush.bucket_names = {int(k): v
                              for k, v in d["bucket_names"].items()}
        crush.name_ids = dict(d["name_ids"])
        crush.device_classes = {int(k): v
                                for k, v in d["device_classes"].items()}
        crush._class_shadow = {(bid, cls): sid
                               for bid, cls, sid in d["class_shadow"]}
        for rd in d["rules"]:
            rule = Rule(rd["name"], [tuple(s) for s in rd["steps"]],
                        rd["rule_type"])
            if rd.get("max_size"):
                rule.max_size = rd["max_size"]
            crush.map.rules.append(rule)
        crush.rule_max_size = {int(k): v
                               for k, v in d["rule_max_size"].items()}
        return crush

    # -- dump (crushtool -d style) ----------------------------------------
    def dump(self) -> Dict:
        return {
            "devices": [{"id": d, "class": self.device_classes.get(d, "")}
                        for d in range(self.map.max_devices)],
            "buckets": [
                {"id": b.id,
                 "name": self.bucket_names.get(b.id, f"shadow{b.id}"),
                 "type": self.types.get(b.type, str(b.type)),
                 "alg": b.alg,
                 "weight": b.weight,
                 "items": [{"id": i, "weight": w}
                           for i, w in zip(b.items, b.weights)]}
                for b in sorted(self.map.buckets.values(), key=lambda b: -b.id)
                if b.id in self.bucket_names],
            "rules": [{"id": i, "name": r.name, "type": r.rule_type,
                       "steps": [list(s) for s in r.steps]}
                      for i, r in enumerate(self.map.rules)],
        }


def build_flat_map(n_osds: int, osds_per_host: int = 1,
                   device_class: str = "") -> CrushWrapper:
    """Convenience: root -> host-per-group -> osds, the vstart-style
    development topology (reference vstart.sh builds the same shape)."""
    crush = CrushWrapper()
    crush.add_bucket("default", "root")
    for osd in range(n_osds):
        hostname = f"host{osd // osds_per_host}"
        if hostname not in crush.name_ids:
            crush.add_bucket(hostname, "host")
            crush.insert_item(crush.name_ids[hostname], 0, hostname,
                              "default")
        crush.insert_item(osd, 1.0, f"osd.{osd}", hostname,
                          device_class=device_class)
    return crush

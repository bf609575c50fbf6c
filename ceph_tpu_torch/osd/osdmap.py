"""OSDMap — the cluster's authoritative placement state.

Python-native equivalent of the reference's OSDMap (reference
src/osd/OSDMap.{h,cc}): an epoch-versioned snapshot of OSD up/in
state, pools, erasure-code profiles and the CRUSH map, plus the
object→PG→OSD mapping pipeline
(``object_locator_to_pg`` → ``pg_to_up_acting_osds`` →
``crush.do_rule``; reference osd/OSDMap.cc:2403-2415).

Replicated pools prune down OSDs and shift survivors left; erasure
pools keep per-position holes (``None``) because EC acting-set
positions are *not interchangeable* (reference
doc/dev/osd_internals/erasure_coding/ecbackend.rst, "Distinguished
acting set positions").

Maps advance by applying ``Incremental`` deltas committed by the
monitor (reference OSDMap::Incremental, apply_incremental).
"""
from __future__ import annotations

import copy
import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..crush.mapper import CRUSH_ITEM_NONE, crush_hash32_2
from ..crush.wrapper import CrushWrapper

POOL_TYPE_REPLICATED = "replicated"
POOL_TYPE_ERASURE = "erasure"


def ceph_str_hash_rjenkins(s: bytes) -> int:
    """Jenkins one-at-a-time style string hash over 12-byte blocks
    (behavioral port of the published rjenkins string hash the
    reference uses for object names, common/ceph_hash.cc)."""
    M32 = 0xFFFFFFFF
    a, b = 0x9E3779B9, 0x9E3779B9
    c = 0  # the hash
    i, length = 0, len(s)

    def mix(a, b, c):
        a = (a - b - c) & M32; a ^= c >> 13
        b = (b - c - a) & M32; b ^= (a << 8) & M32
        c = (c - a - b) & M32; c ^= b >> 13
        a = (a - b - c) & M32; a ^= c >> 12
        b = (b - c - a) & M32; b ^= (a << 16) & M32
        c = (c - a - b) & M32; c ^= b >> 5
        a = (a - b - c) & M32; a ^= c >> 3
        b = (b - c - a) & M32; b ^= (a << 10) & M32
        c = (c - a - b) & M32; c ^= b >> 15
        return a, b, c

    while length - i >= 12:
        a = (a + int.from_bytes(s[i:i + 4], "little")) & M32
        b = (b + int.from_bytes(s[i + 4:i + 8], "little")) & M32
        c = (c + int.from_bytes(s[i + 8:i + 12], "little")) & M32
        a, b, c = mix(a, b, c)
        i += 12
    tail = s[i:]
    c = (c + length) & M32
    pad = tail + b"\x00" * (12 - len(tail))
    a = (a + int.from_bytes(pad[0:4], "little")) & M32
    b = (b + int.from_bytes(pad[4:8], "little")) & M32
    # skip the low byte of the last word, as the original does (length
    # already folded into c)
    c = (c + (int.from_bytes(pad[8:12], "little") << 8 & M32)) & M32
    a, b, c = mix(a, b, c)
    return c


def ceph_stable_mod(x: int, b: int, bmask: int) -> int:
    """Stable modulo: doubling b reassigns at most half the inputs
    (reference include/ceph_hash.h ceph_stable_mod)."""
    if (x & bmask) < b:
        return x & bmask
    return x & (bmask >> 1)


def pg_num_mask(pg_num: int) -> int:
    m = 1
    while m < pg_num:
        m <<= 1
    return m - 1


def pg_split_parent(seed: int) -> int:
    """Structural split parent of a child PG seed: the seed with its
    top bit cleared.  Algebraic consequence of ceph_stable_mod: for any
    old/new pg_num pair with old <= seed < new, the objects that land
    in child ``seed`` previously hashed to exactly this parent
    (reference pg_t::parent_of / is_split, osd/osd_types.h)."""
    assert seed > 0
    return seed & ~(1 << (seed.bit_length() - 1))


def pg_split_ancestors(seed: int, created_pg_num: int) -> List[int]:
    """Ancestor chain of a split child down to (and including) the
    first seed that existed at pool creation — the framework's
    map-history-free stand-in for the reference's past_intervals: data
    for a split child can only ever live with its structural
    ancestors' holders."""
    out = []
    while seed >= max(created_pg_num, 1):
        seed = pg_split_parent(seed)
        out.append(seed)
    return out


def pg_split_source(seed: int, old_pg_num: int) -> int:
    """The pre-growth PG (< old_pg_num) that holds the objects of
    child ``seed``: walk the structural parent chain down below
    old_pg_num."""
    while seed >= old_pg_num:
        seed = pg_split_parent(seed)
    return seed


def pg_split_children(seed: int, old_pg_num: int,
                      new_pg_num: int) -> List[int]:
    """Child seeds whose objects PG ``seed`` holds when pg_num grows
    old -> new (reference pg_t::is_split, osd/osd_types.h)."""
    return [c for c in range(old_pg_num, new_pg_num)
            if pg_split_source(c, old_pg_num) == seed]


@dataclass(frozen=True, order=True)
class PGid:
    """(pool id, placement seed) — reference pg_t."""
    pool: int
    seed: int

    def __str__(self) -> str:
        return f"{self.pool}.{self.seed:x}"

    @classmethod
    def parse(cls, s: str) -> "PGid":
        pool, seed = s.split(".")
        return cls(int(pool), int(seed, 16))


@dataclass(frozen=True, order=True)
class SPGid:
    """Shard-qualified pg id (reference spg_t): EC shard identity."""
    pgid: PGid
    shard: int = -1  # -1 = NO_SHARD (replicated)

    def __str__(self) -> str:
        if self.shard < 0:
            return str(self.pgid)
        return f"{self.pgid}s{self.shard}"


@dataclass
class PGPool:
    """reference pg_pool_t (osd/osd_types.h)."""
    name: str
    pool_id: int
    type: str = POOL_TYPE_REPLICATED
    size: int = 3
    min_size: int = 2
    pg_num: int = 32
    created_pg_num: int = 0      # pg_num at pool creation (split anchor)
    crush_rule: int = 0
    erasure_code_profile: str = ""
    stripe_width: int = 0
    ec_overwrites: bool = False   # allows_ecoverwrites, osd_types.h:1600
    fast_read: bool = False       # EC read-all-reconstruct-first-k
                                  # (reference pg_pool_t FLAG_EC_FAST_READ)
    # snapshots (reference pg_pool_t snap fields, osd/osd_types.h):
    snap_seq: int = 0                  # newest allocated snap id
    removed_snaps: List[int] = field(default_factory=list)
    pool_snaps: Dict[str, int] = field(default_factory=dict)  # name->id
    # cache tiering (reference pg_pool_t tier fields, osd/osd_types.h:
    # tier_of / read_tier / write_tier / cache_mode; applied by
    # PrimaryLogPG::maybe_handle_cache_detail, PrimaryLogPG.cc:2700)
    pg_num_epoch: int = 0              # epoch of the last pg_num
                                       # change (merge rebase anchor)
    tier_of: int = -1                  # base pool this pool caches
    read_tier: int = -1                # on the BASE pool: overlay tier
    write_tier: int = -1
    cache_mode: str = "none"           # none | writeback | readonly
    target_max_objects: int = 0        # tier agent evict thresholds
    target_max_bytes: int = 0
    cache_target_dirty_ratio: float = 0.4

    def is_erasure(self) -> bool:
        return self.type == POOL_TYPE_ERASURE

    def is_tier(self) -> bool:
        return self.tier_of >= 0

    def has_tiers(self) -> bool:
        return self.read_tier >= 0 or self.write_tier >= 0

    def raw_pg_to_pps(self, seed: int) -> int:
        """Placement seed for CRUSH input (reference
        pg_pool_t::raw_pg_to_pps HASHPSPOOL path)."""
        return crush_hash32_2(
            ceph_stable_mod(seed, self.pg_num, pg_num_mask(self.pg_num)),
            self.pool_id)


@dataclass
class OSDInfo:
    up: bool = False
    weight: int = 0          # in/out: 16.16 fixed, 0 = out
    addr: Optional[Tuple[str, int]] = None
    up_from: int = 0
    down_at: int = 0


class Incremental:
    """Delta between consecutive epochs (reference OSDMap::Incremental)."""

    def __init__(self, epoch: int):
        self.epoch = epoch
        self.new_up: Dict[int, Tuple[str, int]] = {}    # osd -> addr
        self.new_down: List[int] = []
        self.new_weight: Dict[int, int] = {}            # osd -> 16.16
        self.new_pools: Dict[int, PGPool] = {}
        self.old_pools: List[int] = []
        self.new_profiles: Dict[str, dict] = {}
        self.old_profiles: List[str] = []
        self.new_crush: Optional[CrushWrapper] = None
        self.new_max_osd: Optional[int] = None
        # central config deltas (reference ConfigMonitor collapsed
        # into the map: overrides ride map publication to daemons)
        self.new_config: Dict[str, str] = {}
        self.old_config: List[str] = []


#: CRUSH's raw placement of a PG depends only on the crush map, the
#: pool's rule and size, the PG's pps and the OSD weights, not on which
#: OSDs are up.  Every OSD of a process decodes its own map each epoch
#: and places every PG of it again, in pure Python (about 5 ms a k=8
#: m=4 PG), so the placements are kept here by those inputs and each one
#: is computed once for the process while they hold.
_RAW_PLACEMENTS: Dict[tuple, Tuple[int, ...]] = {}
_RAW_PLACEMENTS_MAX = 1 << 16


class OSDMap:
    def __init__(self) -> None:
        self.epoch = 0
        self.fsid = ""
        self.max_osd = 0
        self.osds: Dict[int, OSDInfo] = {}
        self.pools: Dict[int, PGPool] = {}
        self.pool_name_to_id: Dict[str, int] = {}
        self.erasure_code_profiles: Dict[str, dict] = {
            "default": {"plugin": "jerasure", "technique": "reed_sol_van",
                        "k": "2", "m": "1"}}
        self.crush = CrushWrapper()
        self._next_pool_id = 1
        # cluster-wide config overrides (name -> raw string value);
        # daemons apply them on every map publish (observers fire)
        self.cluster_config: Dict[str, str] = {}

    # -- state queries ----------------------------------------------------
    def is_up(self, osd: int) -> bool:
        return osd in self.osds and self.osds[osd].up

    def is_in(self, osd: int) -> bool:
        return osd in self.osds and self.osds[osd].weight > 0

    def get_addr(self, osd: int) -> Optional[Tuple[str, int]]:
        info = self.osds.get(osd)
        return info.addr if info else None

    def osd_weights(self) -> List[int]:
        return [self.osds[o].weight if o in self.osds else 0
                for o in range(self.max_osd)]

    def get_pool(self, name_or_id) -> Optional[PGPool]:
        if isinstance(name_or_id, str):
            pid = self.pool_name_to_id.get(name_or_id)
            return self.pools.get(pid) if pid is not None else None
        return self.pools.get(name_or_id)

    # -- object -> pg -> osds pipeline ------------------------------------
    def object_locator_to_pg(self, oid: str, pool_id: int) -> PGid:
        """reference Objecter's object_locator_to_pg
        (osdc/Objecter.cc:2820 → OSDMap::object_locator_to_pg)."""
        pool = self.pools[pool_id]
        ps = ceph_str_hash_rjenkins(oid.encode())
        return PGid(pool_id, ceph_stable_mod(ps, pool.pg_num,
                                             pg_num_mask(pool.pg_num)))

    def pg_to_raw_osds(self, pgid: PGid) -> List[Optional[int]]:
        """CRUSH mapping with EC holes as None (reference
        _pg_to_raw_osds, OSDMap.cc:2403)."""
        pool = self.pools[pgid.pool]
        pps = pool.raw_pg_to_pps(pgid.seed)
        weights = self.osd_weights()
        key = (self._crush_digest(), pool.crush_rule, pps, pool.size,
               tuple(weights))
        raw = _RAW_PLACEMENTS.get(key)
        if raw is None:
            raw = tuple(self.crush.do_rule(pool.crush_rule, pps,
                                           pool.size, weights))
            if len(_RAW_PLACEMENTS) >= _RAW_PLACEMENTS_MAX:
                _RAW_PLACEMENTS.clear()
            _RAW_PLACEMENTS[key] = raw
        return [None if o == CRUSH_ITEM_NONE else o for o in raw]

    def _crush_digest(self) -> bytes:
        """The crush map's content as a key of _RAW_PLACEMENTS, taken
        once a map instance; a new crush map comes only by incremental
        (apply_incremental drops it)."""
        digest = self.__dict__.get("_crush_key")
        if digest is None:
            digest = hashlib.sha1(json.dumps(
                self.crush.to_wire_dict(), sort_keys=True).encode()
            ).digest()
            self._crush_key = digest
        return digest

    def pg_to_up_acting_osds(self, pgid: PGid
                             ) -> Tuple[List[Optional[int]], Optional[int],
                                        List[Optional[int]], Optional[int]]:
        """-> (up, up_primary, acting, acting_primary) (reference
        OSDMap::pg_to_up_acting_osds).  Without pg_temp, up == acting
        after down-filtering."""
        pool = self.pools[pgid.pool]
        raw = self.pg_to_raw_osds(pgid)
        if pool.is_erasure():
            up: List[Optional[int]] = [
                o if o is not None and self.is_up(o) else None for o in raw]
        else:
            up = [o for o in raw if o is not None and self.is_up(o)]
        primary = next((o for o in up if o is not None), None)
        acting = list(up)
        return up, primary, acting, primary

    def pg_shard_osd(self, pgid: PGid, shard: int) -> Optional[int]:
        up, _, _, _ = self.pg_to_up_acting_osds(pgid)
        if 0 <= shard < len(up):
            return up[shard]
        return None

    def pgs_for_pool(self, pool_id: int) -> List[PGid]:
        pool = self.pools[pool_id]
        return [PGid(pool_id, s) for s in range(pool.pg_num)]

    # -- mutation (monitor side) ------------------------------------------
    def apply_incremental(self, inc: Incremental) -> None:
        assert inc.epoch == self.epoch + 1, \
            f"incremental {inc.epoch} does not follow epoch {self.epoch}"
        if inc.new_crush is not None:
            self.crush = inc.new_crush
            self.__dict__.pop("_crush_key", None)
        if inc.new_max_osd is not None:
            self.max_osd = inc.new_max_osd
        for osd, addr in inc.new_up.items():
            brand_new = osd not in self.osds
            info = self.osds.setdefault(osd, OSDInfo())
            info.up = True
            info.addr = addr
            info.up_from = inc.epoch
            if brand_new and info.weight == 0:
                # first-ever boot starts in; a REJOINING out OSD's
                # weight is the monitor's call (mon_osd_auto_mark_in
                # rides inc.new_weight), not an automatic side effect
                info.weight = 0x10000
            self.max_osd = max(self.max_osd, osd + 1)
        for osd in inc.new_down:
            if osd in self.osds:
                self.osds[osd].up = False
                self.osds[osd].down_at = inc.epoch
        for osd, w in inc.new_weight.items():
            self.osds.setdefault(osd, OSDInfo()).weight = w
        self.cluster_config.update(inc.new_config)
        for name in inc.old_config:
            self.cluster_config.pop(name, None)
        for pid, pool in inc.new_pools.items():
            self.pools[pid] = pool
            self.pool_name_to_id[pool.name] = pid
            self._next_pool_id = max(self._next_pool_id, pid + 1)
        for pid in inc.old_pools:
            pool = self.pools.pop(pid, None)
            if pool:
                self.pool_name_to_id.pop(pool.name, None)
        for name, profile in inc.new_profiles.items():
            self.erasure_code_profiles[name] = dict(profile)
        for name in inc.old_profiles:
            self.erasure_code_profiles.pop(name, None)
        self.epoch = inc.epoch

    def clone(self) -> "OSDMap":
        return copy.deepcopy(self)

    # -- wire form (reference OSDMap::encode/decode, shipped in MOSDMap) --
    def to_wire_dict(self) -> Dict:
        return {
            "epoch": self.epoch,
            "fsid": self.fsid,
            "max_osd": self.max_osd,
            "osds": {str(o): {"up": i.up, "weight": i.weight,
                              "addr": list(i.addr) if i.addr else None,
                              "up_from": i.up_from, "down_at": i.down_at}
                     for o, i in self.osds.items()},
            "pools": {str(p.pool_id): {
                "name": p.name, "type": p.type, "size": p.size,
                "min_size": p.min_size, "pg_num": p.pg_num,
                "created_pg_num": p.created_pg_num,
                "crush_rule": p.crush_rule,
                "erasure_code_profile": p.erasure_code_profile,
                "stripe_width": p.stripe_width,
                "ec_overwrites": p.ec_overwrites,
                "fast_read": p.fast_read,
                "snap_seq": p.snap_seq,
                "removed_snaps": p.removed_snaps,
                "pool_snaps": p.pool_snaps,
                "pg_num_epoch": p.pg_num_epoch,
                "tier_of": p.tier_of,
                "read_tier": p.read_tier,
                "write_tier": p.write_tier,
                "cache_mode": p.cache_mode,
                "target_max_objects": p.target_max_objects,
                "target_max_bytes": p.target_max_bytes,
                "cache_target_dirty_ratio": p.cache_target_dirty_ratio}
                for p in self.pools.values()},
            "erasure_code_profiles": self.erasure_code_profiles,
            "cluster_config": dict(self.cluster_config),
            "crush": self.crush.to_wire_dict(),
        }

    @classmethod
    def from_wire_dict(cls, d: Dict) -> "OSDMap":
        m = cls()
        m.epoch = d["epoch"]
        m.fsid = d["fsid"]
        m.max_osd = d["max_osd"]
        for o, i in d["osds"].items():
            m.osds[int(o)] = OSDInfo(
                up=i["up"], weight=i["weight"],
                addr=tuple(i["addr"]) if i["addr"] else None,
                up_from=i["up_from"], down_at=i["down_at"])
        for pid, p in d["pools"].items():
            pool = PGPool(name=p["name"], pool_id=int(pid), type=p["type"],
                          size=p["size"], min_size=p["min_size"],
                          pg_num=p["pg_num"],
                          created_pg_num=p.get("created_pg_num",
                                               p["pg_num"]),
                          crush_rule=p["crush_rule"],
                          erasure_code_profile=p["erasure_code_profile"],
                          stripe_width=p["stripe_width"],
                          ec_overwrites=p.get("ec_overwrites", False),
                          fast_read=p.get("fast_read", False),
                          snap_seq=p.get("snap_seq", 0),
                          removed_snaps=list(p.get("removed_snaps", [])),
                          pool_snaps=dict(p.get("pool_snaps", {})),
                          pg_num_epoch=p.get("pg_num_epoch", 0),
                          tier_of=p.get("tier_of", -1),
                          read_tier=p.get("read_tier", -1),
                          write_tier=p.get("write_tier", -1),
                          cache_mode=p.get("cache_mode", "none"),
                          target_max_objects=p.get(
                              "target_max_objects", 0),
                          target_max_bytes=p.get("target_max_bytes", 0),
                          cache_target_dirty_ratio=p.get(
                              "cache_target_dirty_ratio", 0.4))
            m.pools[int(pid)] = pool
            m.pool_name_to_id[pool.name] = int(pid)
            m._next_pool_id = max(m._next_pool_id, int(pid) + 1)
        m.erasure_code_profiles = {
            k: dict(v) for k, v in d["erasure_code_profiles"].items()}
        m.cluster_config = dict(d.get("cluster_config", {}))
        m.crush = CrushWrapper.from_wire_dict(d["crush"])
        return m

    # -- dump --------------------------------------------------------------
    def dump(self) -> Dict:
        return {
            "epoch": self.epoch,
            "max_osd": self.max_osd,
            "osds": [{"osd": o, "up": int(i.up),
                      "in": int(i.weight > 0),
                      "weight": i.weight / 0x10000,
                      "addr": list(i.addr) if i.addr else None}
                     for o, i in sorted(self.osds.items())],
            "pools": [{"pool": p.pool_id, "name": p.name, "type": p.type,
                       "size": p.size, "min_size": p.min_size,
                       "pg_num": p.pg_num, "crush_rule": p.crush_rule,
                       "erasure_code_profile": p.erasure_code_profile,
                       "stripe_width": p.stripe_width}
                      for p in sorted(self.pools.values(),
                                      key=lambda p: p.pool_id)],
            "erasure_code_profiles": self.erasure_code_profiles,
        }

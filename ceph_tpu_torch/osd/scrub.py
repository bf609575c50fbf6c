"""PG scrub: cross-shard consistency checking + repair.

Python-native equivalent of the reference's scrub machinery (reference
``src/osd/PG.cc`` chunky_scrub, ``src/osd/ScrubStore.cc``, and the
backend comparison hooks ``be_compare_scrubmaps`` /
``ReplicatedBackend::be_deep_scrub`` :614 / ``ECBackend::be_deep_scrub``
:2475): the primary gathers a ScrubMap from every acting shard
(``MRepScrub`` → ``MRepScrubMap``, reference MOSDRepScrub.h), compares,
records inconsistencies, and — on ``repair`` — marks the bad copies
missing and lets the normal recovery path rebuild them (reference
repair_object, PrimaryLogPG.cc).

Comparison rules:
- replicated: the authoritative copy is the majority by (size,
  data_crc, omap_crc, attrs_crc); shards disagreeing with it (or
  missing the object) are inconsistent.  Ties break toward the
  primary, like the reference's be_select_auth_object preference.
- EC: every shard self-checks its bytes against the HashInfo CRC
  (``hinfo_ok``); a False means that shard is corrupt.  Shard sizes
  must also match ``object_size_to_shard_size`` of the object size.

Scrub runs whole-PG in one pass (our PGs are test-scale; the
reference chunks the object range with scrubber.start/end and blocks
writes per chunk).  Write exclusion: new client writes queue on the
primary for the duration of the round and the snapshot waits for the
in-flight pipeline to drain (``kick``), so every shard's map
describes the same committed state."""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from ..msg.messages import MRepScrub, MRepScrubMap
from ..utils.log import Dout

logger = Dout("scrub")


class Scrubber:
    """Per-PG scrub state machine (reference PG::Scrubber struct)."""

    def __init__(self, pg) -> None:
        self.pg = pg
        self.active = False
        self.started_at = 0.0
        self.deep = False
        self.repair = False
        self.tid = 0
        self._collected = False
        self.waiting_on: Dict[int, int] = {}     # shard -> osd
        self.maps: Dict[int, Dict[str, dict]] = {}   # shard -> scrub map
        # results of the last completed scrub
        self.last_scrub: float = 0.0
        self.last_deep_scrub: float = 0.0
        self.errors = 0
        self.inconsistent: Dict[str, List[int]] = {}  # oid -> bad shards

    # ---------------------------------------------------------------- #
    # primary side
    # ---------------------------------------------------------------- #
    def start(self, deep: bool, repair: bool) -> bool:
        """Kick off a scrub round (primary only, PG lock held).
        Refuses while the PG is degraded or recovering: a shard that
        hasn't been pushed its objects yet would read as inconsistent
        (the reference queues scrub behind recovery the same way)."""
        pg = self.pg
        if self.active or not pg.is_primary():
            return False
        if pg.num_missing() > 0 or None in pg.acting or \
                len([o for o in pg.acting if o is not None]) < \
                pg.pool.min_size:
            return False
        self.active = True
        self.started_at = time.monotonic()
        # wall-clock twin of started_at: ledger stamps are absolute
        # wall time (cross-daemon alignable), monotonic is not
        self._started_wall = time.time()
        self.deep = deep
        self.repair = repair
        self.tid += 1
        self.maps = {}
        self.waiting_on = {}
        self._collected = False
        # snapshots must all describe the same committed state: new
        # writes are blocked (write_blocked -> PG queues them) and the
        # map collection waits until in-flight writes drain (the
        # reference blocks writes on the scrubbed chunk range)
        self.kick()
        return True

    def write_blocked(self) -> bool:
        """Client writes queue while a scrub round is running."""
        return self.active

    def kick(self) -> None:
        """Collect the maps once the write pipeline is empty (called
        from start, write completions, and the OSD tick)."""
        pg = self.pg
        if not self.active or self._collected:
            return
        if pg.backend.inflight_writes() > 0:
            return
        self._collected = True
        # replicated PGs carry own_shard=-1 but appear in acting_shards
        # under their acting index — key the local map consistently so
        # compare/repair can resolve it back to an OSD
        own = pg.own_shard
        if own < 0:
            for shard, osd in pg.acting_shards():
                if osd == pg.whoami:
                    own = shard
                    break
        self._own_key = own
        self.maps[own] = pg.backend.build_scrub_map(self.deep)
        for shard, osd in pg.acting_shards():
            if osd is None or osd == pg.whoami:
                continue
            self.waiting_on[shard] = osd
            pg.send_shard(osd, MRepScrub(
                pgid=pg.pgid_str, shard=shard, from_osd=pg.whoami,
                tid=self.tid, epoch=pg.epoch, deep=self.deep))
        if not self.waiting_on:
            self._finish()

    def reset(self) -> None:
        """Abort an in-flight round (interval change / peer loss);
        results of completed rounds are kept."""
        self.active = False
        self.waiting_on = {}
        self.maps = {}
        self.pg.requeue_scrub_waiters()

    def maybe_abort_stuck(self, timeout: float = 30.0) -> bool:
        """A replica that died mid-round never sends its map; without
        this the scrubber would stay active forever and block every
        future scrub (reference scrub_reserve timeouts)."""
        if self.active and \
                time.monotonic() - self.started_at > timeout:
            logger.dwarn("%s scrub round timed out waiting on %s",
                         self.pg.pgid_str, dict(self.waiting_on))
            self.reset()
            return True
        return False

    def handle_rep_scrub_map(self, msg: MRepScrubMap) -> None:
        """A shard's map arrived (primary side, PG lock held)."""
        if not self.active or msg.tid != self.tid:
            return
        if msg.shard in self.waiting_on:
            del self.waiting_on[msg.shard]
            self.maps[msg.shard] = msg.scrub_map
        if not self.waiting_on:
            self._finish()

    # ---------------------------------------------------------------- #
    # replica side
    # ---------------------------------------------------------------- #
    def handle_rep_scrub(self, msg: MRepScrub) -> None:
        """Build and return the local map (replica, PG lock held)."""
        pg = self.pg
        smap = pg.backend.build_scrub_map(msg.deep)
        pg.send_shard(msg.from_osd, MRepScrubMap(
            pgid=pg.pgid_str, shard=msg.shard, from_osd=pg.whoami,
            tid=msg.tid, scrub_map=smap))

    # ---------------------------------------------------------------- #
    # compare + repair
    # ---------------------------------------------------------------- #
    def _finish(self) -> None:
        pg = self.pg
        inconsistent: Dict[str, List[int]] = {}
        self.syndrome_errors = 0     # per-round (see _compare_ec)
        if pg.pool.is_erasure():
            self._compare_ec(inconsistent)
        else:
            self._compare_replicated(inconsistent)
        self.inconsistent = inconsistent
        self.errors = sum(len(v) for v in inconsistent.values()) \
            + self.syndrome_errors
        now = time.time()
        self.last_scrub = now
        if self.deep:
            self.last_deep_scrub = now
        self.active = False
        if inconsistent:
            logger.dwarn("%s scrub found %d errors on %d objects",
                         pg.pgid_str, self.errors, len(inconsistent))
        auto = False
        try:
            auto = bool(pg.conf["osd_scrub_auto_repair"])
        except Exception:
            pass
        if (self.repair or auto) and inconsistent:
            # reference osd_scrub_auto_repair: scrub-found errors go
            # straight to repair without an operator `pg repair`
            self._repair(inconsistent)
        # the whole round as one synthetic ledger interval: pg_locked
        # (round start) -> scrub_window (compare done), charged to the
        # recovery-class accumulator + scrub SLO class
        t0 = getattr(self, "_started_wall", 0.0)
        if t0:
            obs = getattr(pg, "observe_hops", None)
            if obs is not None:
                obs({"pg_locked": t0, "scrub_window": now},
                    kind="recovery")
            slo = getattr(pg.service, "slo", None)
            if slo is not None:
                slo.observe("scrub", max(0.0, now - t0),
                            ok=(self.errors == 0))
        pg.requeue_scrub_waiters()
        pg.service.kick_recovery(pg)

    def _all_oids(self) -> List[str]:
        oids = set()
        for smap in self.maps.values():
            oids.update(smap)
        return sorted(oids)

    def _compare_replicated(self, out: Dict[str, List[int]]) -> None:
        """Majority-authoritative compare (reference
        be_compare_scrubmaps; keys mirror be_select_auth_object)."""
        keys = ["size"]
        if self.deep:
            keys += ["data_crc", "omap_crc", "attrs_crc"]
        own = getattr(self, "_own_key", self.pg.own_shard)
        for oid in self._all_oids():
            sigs: Dict[int, Optional[Tuple]] = {}
            for shard, smap in self.maps.items():
                e = smap.get(oid)
                if e is None or "error" in e:
                    sigs[shard] = None
                else:
                    sigs[shard] = tuple(e.get(k) for k in keys)
            # majority signature; primary wins ties
            counts: Dict[Tuple, int] = {}
            for s in sigs.values():
                if s is not None:
                    counts[s] = counts.get(s, 0) + 1
            if not counts:
                continue
            best = max(counts.items(),
                       key=lambda kv: (kv[1], kv[0] == sigs.get(own)))[0]
            bad = [sh for sh, s in sigs.items() if s != best]
            if bad:
                out[oid] = sorted(bad)

    def _compare_ec(self, out: Dict[str, List[int]]) -> None:
        """EC shards self-check vs HashInfo; sizes must match the
        object size's shard footprint (reference ECBackend.cc:2475).

        With ``osd_deep_scrub_syndrome`` each deep map also carries
        per-object GF-syndrome CRC partials (ecbackend
        _scrub_fill_crcs): XORing them across the full shard set is
        the linear CRC of the whole code word's syndrome vector —
        nonzero means the stripe is inconsistent even when every
        shard's own CRC matches its HashInfo (e.g. a stale-but-
        self-consistent shard).  The check cannot LOCALIZE the bad
        shard, so a syndrome hit on an object with no per-shard
        culprits counts as an error without scheduling repair."""
        for oid in self._all_oids():
            bad: List[int] = []
            syn: Optional[List[int]] = None
            nsyn = 0
            for shard, smap in self.maps.items():
                e = smap.get(oid)
                if e is None or "error" in e:
                    bad.append(shard)
                    continue
                if e.get("hinfo_ok") is False:
                    bad.append(shard)
                    continue
                expect = e.get("expect_size")
                if expect is not None and e.get("size") != expect:
                    bad.append(shard)
                    continue
                parts = e.get("syndrome_partials")
                if parts:
                    nsyn += 1
                    if syn is None:
                        syn = list(parts)
                    else:
                        syn = [a ^ b for a, b in zip(syn, parts)]
            if bad:
                out[oid] = sorted(bad)
            elif syn is not None and nsyn == len(self.maps) and \
                    any(syn):
                # full shard set, every per-shard check clean, but
                # the whole-code-word syndrome is nonzero: count the
                # inconsistency (unlocalizable -> no shard listed,
                # no auto-repair)
                self.syndrome_errors = getattr(
                    self, "syndrome_errors", 0) + 1

    def _repair(self, inconsistent: Dict[str, List[int]]) -> None:
        """Mark bad copies missing so recovery rebuilds them from the
        authoritative/surviving copies (reference repair_object +
        recovery)."""
        pg = self.pg
        shard_osd = dict(pg.acting_shards())
        for oid, bad_shards in inconsistent.items():
            # version to recover to: any good shard's oi_version
            version = None
            for shard, smap in self.maps.items():
                if shard in bad_shards:
                    continue
                e = smap.get(oid)
                if e and e.get("oi_version"):
                    version = tuple(e["oi_version"])
                    break
            if version is None:
                logger.dwarn("%s repair: no authoritative copy of %s",
                             pg.pgid_str, oid)
                continue
            for shard in bad_shards:
                osd = shard_osd.get(shard)
                if osd is None:
                    continue
                if osd == pg.whoami and not pg.pool.is_erasure():
                    # the primary's own replica is the corrupt one:
                    # drop it so recovery takes the pull path from a
                    # good replica instead of re-pushing bad bytes
                    # (reference recover_primary pull)
                    from ..store.objectstore import GHObject, Transaction
                    obj = GHObject(oid, pg.own_shard)
                    if pg.store.exists(pg.coll, obj):
                        txn = Transaction()
                        txn.remove(pg.coll, obj)
                        pg.store.queue_transactions([txn],
                                                    op="scrub_repair")
                pg.mark_shard_missing(oid, version, shard, osd)

    def dump(self) -> Dict:
        return {
            "active": self.active,
            "errors": self.errors,
            "syndrome_errors": getattr(self, "syndrome_errors", 0),
            "inconsistent": dict(self.inconsistent),
            "last_scrub": self.last_scrub,
            "last_deep_scrub": self.last_deep_scrub,
        }

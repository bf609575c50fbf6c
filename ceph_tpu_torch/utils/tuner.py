"""Closed-loop autotuner core: guarded hill-climb over Option-bounded
knobs.

The control plane over the attribution stack (overlap engine, hop
waterfalls, contention stalls, SLO burn): without it the system
"measures everything and adjusts nothing" — every hot-path knob is a
static conf value hand-picked on one box.  This module is the
generic feedback controller that closes the loop: the mClock move
(Gulati et al., OSDI 2010) extended toward self-driving-system
territory (Pavlo et al., CIDR 2017), where measured signals walk the
knobs instead of an operator.

The control law is a guarded hill-climb with AIMD-style steps:

* **knob universe** — enumerated from the machine-readable
  ``Option.tunable`` marker (utils/config.py), never a hand-kept
  list; every tunable option carries finite ``min``/``max`` bounds,
  so no controller step can leave the safe range.  Operators opt a
  knob out by naming it in ``osd_tuner_pin``.
* **probe** — when the system is active (objective > 0) and no guard
  signal is tripped, pick the next knob round-robin, step it in its
  preferred direction (multiplicative up, divided down; at least
  ±1 for ints; ``seed`` jumps a 0-means-auto knob to a real value),
  and remember the pre-step objective as the baseline.
* **verdict** — after ``cooldown_ticks`` of settling, compare the
  objective against the baseline with a relative **hysteresis**
  deadband: improved beyond it → *kept* (direction momentum: the
  same knob/direction is climbed again); regressed beyond it, or any
  guard signal tripped → *rolled back* (the old value is restored
  and the (knob, direction) pair is **blacklisted** for
  ``blacklist_ticks``); inside the deadband → *neutral* (quietly
  reverted, no blacklist — a noisy plateau must not cause a walk).

Every decision is flight-recorded as a ``tune_step`` event (signal
snapshot, knob, old→new, verdict) and counted in the ``tuner`` perf
subsystem; :meth:`Tuner.dump` backs the ``dump_tuner`` admin command,
so every move the controller ever makes is auditable in the Perfetto
trace and the admin socket.

The core is deliberately host-agnostic: knobs are (get, set)
callables, the objective and guard are computed by the caller (the
OSD tick feeds encode throughput + overlap/SLO guards; tests feed
synthetic signals), and ``step()`` is cheap enough for a perf guard
(≤20 µs/op).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional

# step() verdicts (flight-recorded + perf-counted)
VERDICT_PROBE = "probe"
VERDICT_KEPT = "kept"
VERDICT_ROLLED_BACK = "rolled_back"
VERDICT_NEUTRAL = "neutral"


class KnobSpec:
    """One tunable knob: bounds from the Option spec + live accessors.

    ``get``/``set`` are the live-application seam — the OSD builds
    them over ``Config.get``/``Config.set(source="runtime")`` so the
    config observers push new values into the running
    EncodeBatcher/StagingPool/OpScheduler without a restart.  ``seed``
    is the first value proposed when stepping UP from a 0-means-auto
    knob (multiplying zero goes nowhere)."""

    __slots__ = ("name", "lo", "hi", "is_int", "get", "set", "seed",
                 "pinned")

    def __init__(self, name: str, lo: float, hi: float, is_int: bool,
                 get: Callable[[], Any], set: Callable[[Any], None],
                 seed: Optional[float] = None, pinned: bool = False):
        self.name = name
        self.lo = lo
        self.hi = hi
        self.is_int = bool(is_int)
        self.get = get
        self.set = set
        self.seed = seed
        self.pinned = bool(pinned)


def knobs_from_config(conf, appliers: Dict[str, Dict],
                      pinned=()) -> List[KnobSpec]:
    """Build the knob list from the config schema's ``tunable``
    markers: one KnobSpec per tunable Option named in ``appliers``
    (the caller's map of option name -> {"seed": ...} extras).
    Values are read/written through the Config layers, so
    ``conf.set(..., source="runtime")`` fires the registered change
    observers — that is what makes the step land live."""
    pinned = set(_split_pin(pinned)) if isinstance(pinned, str) \
        else set(pinned)
    knobs: List[KnobSpec] = []
    for opt in conf.tunables():
        extra = appliers.get(opt.name)
        if extra is None:
            continue
        if opt.min is None or opt.max is None:
            # a tunable option without finite bounds is a schema bug;
            # refuse to walk it rather than walk it off a cliff
            continue
        name = opt.name
        knobs.append(KnobSpec(
            name, opt.min, opt.max, opt.type is int,
            get=(lambda n=name: conf.get(n)),
            set=(lambda v, n=name: conf.set(n, v, source="runtime")),
            seed=extra.get("seed"),
            pinned=name in pinned))
    return knobs


def _split_pin(raw: str) -> List[str]:
    """``osd_tuner_pin`` accepts space- or comma-joined names."""
    return [t for t in raw.replace(",", " ").split() if t]


class Tuner:
    """Guarded hill-climb controller over a set of :class:`KnobSpec`.

    Drive it with one :meth:`step` call per controller tick, passing
    the current objective (higher = better; ≤0 means idle — the
    controller holds still) and an optional ``guard`` trip reason
    (caller-evaluated SLO/overlap signal; any non-None value during a
    probe forces a rollback).  Thread-safe: the OSD tick, the admin
    socket's ``dump_tuner`` and tests may interleave."""

    def __init__(self, name: str, knobs: List[KnobSpec], *,
                 hysteresis: float = 0.05, cooldown_ticks: int = 1,
                 blacklist_ticks: int = 8, step_frac: float = 0.25,
                 recorder=None, perf_coll=None, steps_keep: int = 64):
        self.name = name
        self.knobs = list(knobs)
        self.hysteresis = max(0.0, float(hysteresis))
        self.cooldown_ticks = max(0, int(cooldown_ticks))
        self.blacklist_ticks = max(1, int(blacklist_ticks))
        self.step_frac = max(1e-6, float(step_frac))
        self.recorder = recorder
        self._lock = threading.Lock()
        self._tick = 0
        self._cooldown = 0
        self._rr = 0                 # round-robin knob cursor
        self._probe: Optional[Dict] = None
        self._dir: Dict[str, int] = {}        # knob -> preferred dir
        self._blacklist: Dict[tuple, int] = {}  # (knob, dir) -> expiry
        self._steps: "deque" = deque(maxlen=max(1, int(steps_keep)))
        self.counts = {VERDICT_PROBE: 0, VERDICT_KEPT: 0,
                       VERDICT_ROLLED_BACK: 0, VERDICT_NEUTRAL: 0,
                       "guard_trips": 0}
        self.perf = None
        if perf_coll is not None:
            tp = perf_coll.create("tuner")
            if "steps" not in tp._types:
                from .perf import TYPE_U64
                tp.add("steps",
                       description="knob probes applied")
                tp.add("kept",
                       description="probes the objective confirmed")
                tp.add("rolled_back",
                       description="probes reverted on regression or "
                                   "guard trip")
                tp.add("neutral",
                       description="probes reverted inside the "
                                   "hysteresis deadband")
                tp.add("guard_trips",
                       description="rollbacks forced by a tripped "
                                   "SLO/overlap guard signal")
                tp.add("knobs_now", TYPE_U64,
                       "tunable knobs under control")
                tp.add("blacklist_now", TYPE_U64,
                       "(knob, direction) pairs currently "
                       "blacklisted after a rollback")
                tp.add("probing_now", TYPE_U64,
                       "1 while a probe awaits its verdict")
                tp.add("objective_now", TYPE_U64,
                       "last objective sample fed to the controller "
                       "(integerized)")
            tp.set("knobs_now",
                   sum(1 for k in self.knobs if not k.pinned))
            self.perf = tp

    # -- control law -------------------------------------------------
    def step(self, objective: float,
             signals: Optional[Dict[str, Any]] = None,
             guard: Optional[str] = None) -> Optional[Dict]:
        """One controller tick.  Returns the ``tune_step`` record when
        a decision was made (probe applied or verdict rendered), else
        None (cooldown / idle / nothing steppable)."""
        with self._lock:
            self._tick += 1
            tick = self._tick
            p = self.perf
            if p is not None:
                p.set("objective_now", int(max(0, objective)))
            if self._blacklist:
                for key in [k for k, exp in self._blacklist.items()
                            if exp <= tick]:
                    del self._blacklist[key]
                if p is not None:
                    p.set("blacklist_now", len(self._blacklist))
            if self._probe is not None:
                # settle for cooldown_ticks before judging the probe
                # (a guard trip is judged immediately — no reason to
                # keep a harmful step live while "settling")
                if self._cooldown > 0 and guard is None:
                    self._cooldown -= 1
                    return None
                return self._verdict(objective, signals, guard)
            if self._cooldown > 0:
                self._cooldown -= 1
                return None
            if guard is not None or objective <= 0:
                # tripped or idle: never start walking knobs blind
                return None
            return self._start_probe(objective, signals)

    def _start_probe(self, objective: float,
                     signals: Optional[Dict]) -> Optional[Dict]:
        n = len(self.knobs)
        for i in range(n):
            k = self.knobs[(self._rr + i) % n]
            if k.pinned:
                continue
            try:
                cur = k.get()
            except Exception:
                continue
            pref = self._dir.get(k.name, +1)
            for d in (pref, -pref):
                if self._blacklist.get((k.name, d)) is not None:
                    continue
                new = self._propose(k, cur, d)
                if new is None:
                    continue
                try:
                    k.set(new)
                except Exception:
                    continue        # validation refused: not a step
                self._rr = (self._rr + i) % n
                self._probe = {"knob": k.name, "dir": d, "old": cur,
                               "new": new, "baseline": objective,
                               "spec": k}
                self._cooldown = self.cooldown_ticks
                return self._record(VERDICT_PROBE, k.name, d, cur,
                                    new, objective, objective,
                                    signals, None)
        return None

    def _verdict(self, objective: float, signals: Optional[Dict],
                 guard: Optional[str]) -> Dict:
        pr = self._probe
        self._probe = None
        k: KnobSpec = pr["spec"]
        base = pr["baseline"]
        band = abs(base) * self.hysteresis
        if guard is not None:
            verdict = VERDICT_ROLLED_BACK
            self.counts["guard_trips"] += 1
            if self.perf is not None:
                self.perf.inc("guard_trips")
        elif objective > base + band:
            verdict = VERDICT_KEPT
        elif objective < base - band:
            verdict = VERDICT_ROLLED_BACK
        else:
            verdict = VERDICT_NEUTRAL
        if verdict == VERDICT_KEPT:
            # momentum: climb the same knob/direction again next time
            self._dir[k.name] = pr["dir"]
        else:
            try:
                k.set(pr["old"])
            except Exception:
                pass
            if verdict == VERDICT_ROLLED_BACK:
                self._blacklist[(k.name, pr["dir"])] = \
                    self._tick + self.blacklist_ticks
                self._dir[k.name] = -pr["dir"]
                if self.perf is not None:
                    self.perf.set("blacklist_now",
                                  len(self._blacklist))
            # move on: this knob/direction is not paying off here
            self._rr = (self._rr + 1) % max(1, len(self.knobs))
        self._cooldown = self.cooldown_ticks
        return self._record(verdict, k.name, pr["dir"], pr["old"],
                            pr["new"], base, objective, signals,
                            guard)

    def _propose(self, k: KnobSpec, cur, d: int):
        """Bounded AIMD-flavoured step: multiplicative up, divided
        down, at least ±1 for ints; 0-valued (auto) knobs jump to
        ``seed`` going up and cannot go down.  Returns None when the
        step cannot move inside [lo, hi]."""
        try:
            cur = float(cur)
        except (TypeError, ValueError):
            return None
        if cur <= 0:
            if d < 0:
                return None
            new = k.seed if k.seed is not None else max(k.lo, 1.0)
        elif d > 0:
            new = cur * (1.0 + self.step_frac)
            if k.is_int:
                new = max(cur + 1, new)
        else:
            new = cur / (1.0 + self.step_frac)
            if k.is_int:
                new = min(cur - 1, new)
        new = min(k.hi, max(k.lo, new))
        if k.is_int:
            new = int(round(new))
            cur = int(cur)
        if new == cur:
            return None
        return new

    # -- audit trail -------------------------------------------------
    def _record(self, verdict: str, knob: str, d: int, old, new,
                baseline: float, objective: float,
                signals: Optional[Dict],
                guard: Optional[str]) -> Dict:
        self.counts[verdict] += 1
        p = self.perf
        if p is not None:
            if verdict == VERDICT_PROBE:
                p.inc("steps")
                p.set("probing_now", 1)
            else:
                p.inc(verdict)
                p.set("probing_now", 0)
        rec = {"tick": self._tick, "verdict": verdict, "knob": knob,
               "dir": d, "old": old, "new": new,
               "baseline": round(baseline, 4),
               "objective": round(objective, 4)}
        if guard is not None:
            rec["guard"] = guard
        if signals:
            rec["signals"] = dict(signals)
        self._steps.append(rec)
        fr = self.recorder
        if fr is not None:
            fields = {"tuner": self.name, "knob": knob, "dir": d,
                      "old": old, "new": new,
                      "verdict": verdict,
                      "objective": round(objective, 4)}
            if guard is not None:
                fields["guard"] = guard
            if signals:
                fields.update({k: v for k, v in signals.items()
                               if isinstance(v, (int, float, str))})
            fr.note("tune_step", **fields)
        return rec

    # -- dump surfaces -----------------------------------------------
    def dump(self) -> Dict:
        """``dump_tuner`` admin-command payload: knob states, the
        probe/cooldown/blacklist machinery, counters and the recent
        decision ring."""
        with self._lock:
            knobs = []
            for k in self.knobs:
                try:
                    val = k.get()
                except Exception:
                    val = None
                knobs.append({"name": k.name, "value": val,
                              "min": k.lo, "max": k.hi,
                              "pinned": k.pinned,
                              "dir": self._dir.get(k.name, +1)})
            probe = None
            if self._probe is not None:
                probe = {kk: vv for kk, vv in self._probe.items()
                         if kk != "spec"}
            return {
                "name": self.name,
                "tick": self._tick,
                "cooldown": self._cooldown,
                "hysteresis": self.hysteresis,
                "cooldown_ticks": self.cooldown_ticks,
                "blacklist_ticks": self.blacklist_ticks,
                "knobs": knobs,
                "probe": probe,
                "blacklist": [{"knob": kk, "dir": dd,
                               "until_tick": exp}
                              for (kk, dd), exp in
                              sorted(self._blacklist.items())],
                "counts": dict(self.counts),
                "steps": list(self._steps),
            }

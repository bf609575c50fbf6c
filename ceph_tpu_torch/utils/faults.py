"""Process-wide fault-injection registry.

Every hardening path in this tree needs the same thing to be testable:
a way to make a specific layer fail, stall or corrupt ON DEMAND,
deterministically, without monkey-patching internals from tests.  The
reference scatters this ability across ad-hoc conf options
(``ms_inject_socket_failures``, ``filestore_debug_inject_read_err``,
...); here there is ONE registry of named injection points that every
layer consults, and the ad-hoc options route through it so their trip
counts surface in the same place.

Injection points (``SITES``):

* ``device.dispatch``    — EncodeBatcher handing a stripe batch to the
                           device codec (encode AND decode dispatch).
* ``device.completion``  — the async handle ``.wait()`` that fences a
                           dispatched device call.
* ``store.apply``        — ObjectStore.queue_transactions admission;
                           corruption mode bit-flips write payloads
                           (how the scrub/repair tests plant EC shard
                           bit rot).
* ``msg.send``           — messenger frame write (classic and crimson
                           share this site; the legacy
                           ``ms_inject_socket_failures`` conf rides it
                           so its trips are counted here too).
* ``msg.recv``           — messenger frame read.
* ``ec.subwrite_ack``    — delivery of MOSDECSubOpWriteReply to the
                           primary (drops exercise the sub-write
                           deadline/re-request machinery).

Each site is configurable by probability (``one_in``), period
(``every``) or ``one_shot``, with mode ``error`` (raise
``InjectedError``), ``stall`` (sleep ``stall_s`` in place) or
``corrupt`` (bit-flip a payload at corruption-capable sites).  Sites
draw from their own ``random.Random`` seeded from (global seed, site
name), so a seeded chaos run trips the same faults in the same order
every time regardless of scheduling.  Per-site hit/trip counters are
exported through the OSD "perf dump" (subsystem ``faults``) and from
there scraped by the mgr prometheus module.

Config: ``fault_injection`` holds a spec string —
``site:mode:1inN|everyN|once[:stall_ms]`` clauses joined by ``,`` —
and ``fault_injection_seed`` the deterministic seed, e.g.::

    fault_injection = "device.dispatch:error:1in20,store.apply:stall:1in10:50"
"""
from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, List, Optional

DEVICE_DISPATCH = "device.dispatch"
DEVICE_COMPLETION = "device.completion"
STORE_APPLY = "store.apply"
MSG_SEND = "msg.send"
MSG_RECV = "msg.recv"
EC_SUBWRITE_ACK = "ec.subwrite_ack"

SITES = (DEVICE_DISPATCH, DEVICE_COMPLETION, STORE_APPLY,
         MSG_SEND, MSG_RECV, EC_SUBWRITE_ACK)

MODES = ("error", "stall", "corrupt")


class InjectedError(ConnectionError):
    """Raised by an ``error``-mode trip.  ConnectionError so messenger
    call sites treat it exactly like a peer socket death."""

    def __init__(self, site: str):
        super().__init__(f"injected fault at {site}")
        self.site = site


class _Site:
    """One injection point: arming policy + counters.  All mutation
    happens under the registry lock; ``hits``/``trips`` are plain ints
    read without the lock for counter dumps (torn reads are fine)."""

    def __init__(self, name: str):
        self.name = name
        self.hits = 0                # checks while armed
        self.trips = 0               # faults actually delivered
        self.armed = False
        self.mode = "error"
        self.one_in = 0
        self.every = 0
        self.one_shot = False
        self.stall_s = 0.0
        self.max_trips: Optional[int] = None
        self.match: Optional[Callable] = None
        self.rng = random.Random((0, name).__repr__())

    def arm(self, mode: str, one_in: int = 0, every: int = 0,
            one_shot: bool = False, stall_s: float = 0.05,
            max_trips: Optional[int] = None,
            match: Optional[Callable] = None,
            seed: Optional[int] = None) -> None:
        if mode not in MODES:
            raise ValueError(f"unknown fault mode {mode!r}")
        self.mode = mode
        self.one_in = int(one_in)
        self.every = int(every)
        self.one_shot = bool(one_shot)
        self.stall_s = float(stall_s)
        self.max_trips = max_trips
        self.match = match
        self.armed = True
        if seed is not None:
            self.rng = random.Random((seed, self.name).__repr__())

    def disarm(self) -> None:
        self.armed = False
        self.match = None

    def should_trip(self, ctx=None) -> bool:
        """Decide (and count) one check at this site.  Caller holds
        the registry lock."""
        if not self.armed:
            return False
        if self.match is not None and not self.match(ctx):
            return False
        self.hits += 1
        if self.max_trips is not None and self.trips >= self.max_trips:
            return False
        if self.one_shot:
            fire = True
            self.armed = False
        elif self.every > 0:
            fire = self.hits % self.every == 0
        elif self.one_in > 0:
            fire = self.rng.randrange(self.one_in) == 0
        else:
            fire = False
        if fire:
            self.trips += 1
        return fire


class FaultRegistry:
    """The process-wide set of injection points.  Fast path: when no
    site is armed, ``hit()`` is a single attribute check."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sites: Dict[str, _Site] = {n: _Site(n) for n in SITES}
        self._armed_any = False      # lock-free fast-path gate
        self._seed = 0
        self._last_spec: Optional[str] = None

    # -- arming ----------------------------------------------------------
    def site(self, name: str) -> _Site:
        with self._lock:
            s = self._sites.get(name)
            if s is None:
                s = self._sites[name] = _Site(name)
            return s

    def arm(self, name: str, mode: str = "error", one_in: int = 0,
            every: int = 0, one_shot: bool = False,
            stall_s: float = 0.05, max_trips: Optional[int] = None,
            match: Optional[Callable] = None,
            seed: Optional[int] = None) -> None:
        s = self.site(name)
        with self._lock:
            s.arm(mode, one_in=one_in, every=every, one_shot=one_shot,
                  stall_s=stall_s, max_trips=max_trips, match=match,
                  seed=self._seed if seed is None else seed)
            self._refresh_gate()

    def disarm(self, name: str) -> None:
        with self._lock:
            s = self._sites.get(name)
            if s is not None:
                s.disarm()
            self._refresh_gate()

    def reset(self) -> None:
        """Disarm every site and zero all counters (tests)."""
        with self._lock:
            self._sites = {n: _Site(n) for n in SITES}
            self._armed_any = False
            self._last_spec = None

    def seed_all(self, seed: int) -> None:
        """Deterministic seeding: each site draws from its own RNG
        keyed by (seed, site name), so one site's trip pattern never
        depends on how often the others were checked."""
        with self._lock:
            self._seed = int(seed)
            for s in self._sites.values():
                s.rng = random.Random((self._seed, s.name).__repr__())

    def _refresh_gate(self) -> None:
        self._armed_any = any(s.armed for s in self._sites.values())

    # -- config ----------------------------------------------------------
    def configure(self, spec: str, seed: int = 0) -> None:
        """Arm sites from a ``fault_injection`` spec string (see
        module docstring).  Idempotent for an unchanged (spec, seed):
        an OSD restarting mid-run must not reset site RNGs."""
        key = f"{seed}|{spec}"
        with self._lock:
            if self._last_spec == key:
                return
        self.seed_all(seed)
        for clause in (spec or "").split(","):
            clause = clause.strip()
            if not clause:
                continue
            parts = clause.split(":")
            if len(parts) < 3:
                raise ValueError(f"bad fault clause {clause!r} "
                                 "(want site:mode:rate[:stall_ms])")
            name, mode, rate = parts[0], parts[1], parts[2]
            kw = {}
            if rate == "once":
                kw["one_shot"] = True
            elif rate.startswith("1in"):
                kw["one_in"] = int(rate[3:])
            elif rate.startswith("every"):
                kw["every"] = int(rate[5:])
            else:
                raise ValueError(f"bad fault rate {rate!r} in "
                                 f"{clause!r}")
            if len(parts) > 3:
                kw["stall_s"] = float(parts[3]) / 1e3
            self.arm(name, mode=mode, **kw)
        with self._lock:
            self._last_spec = key

    # -- check points ----------------------------------------------------
    def hit(self, name: str, ctx=None) -> None:
        """Consult one site.  error -> raise InjectedError; stall ->
        sleep in place; corrupt -> no-op here (data-carrying sites use
        corrupt_bytes/corrupt_txns)."""
        if not self._armed_any:
            return
        with self._lock:
            s = self._sites.get(name)
            if s is None or not s.should_trip(ctx):
                return
            mode, stall = s.mode, s.stall_s
            self._refresh_gate()     # one_shot may have disarmed
        if mode == "error":
            raise InjectedError(name)
        if mode == "stall":
            time.sleep(stall)

    def check_drop(self, name: str, ctx=None) -> bool:
        """Like hit(), but an error-mode trip returns True instead of
        raising — for call sites that model the fault as 'drop this
        and move on' (socket death, ack loss)."""
        if not self._armed_any:
            return False
        with self._lock:
            s = self._sites.get(name)
            if s is None or not s.should_trip(ctx):
                return False
            mode, stall = s.mode, s.stall_s
            self._refresh_gate()
        if mode == "stall":
            time.sleep(stall)
            return False
        return True

    def check_send(self, name: str, conf_one_in: int = 0) -> bool:
        """msg.send/recv gate for the messengers: the legacy
        ``ms_inject_socket_failures`` conf (one in N frame writes
        fails) rides the absorbing registry site — same counters,
        same seeded RNG — ORed with whatever policy is armed on the
        site itself.  True = treat the socket as dead."""
        if conf_one_in > 0:
            with self._lock:
                s = self._sites.get(name)
                if s is None:
                    s = self._sites[name] = _Site(name)
                s.hits += 1
                if s.rng.randrange(conf_one_in) == 0:
                    s.trips += 1
                    return True
        return self.check_drop(name)

    def corrupt_bytes(self, name: str, data, ctx=None):
        """Corruption-capable check: when the site trips in corrupt
        mode, return ``data`` with one bit flipped (a copy — inputs
        may be read-only views); error/stall trips behave like
        hit().  Returns ``data`` unchanged when nothing trips."""
        if not self._armed_any:
            return data
        with self._lock:
            s = self._sites.get(name)
            if s is None or not s.should_trip(ctx):
                return data
            mode, stall = s.mode, s.stall_s
            if mode == "corrupt":
                pos = s.rng.randrange(max(1, len(data)))
            self._refresh_gate()
        if mode == "error":
            raise InjectedError(name)
        if mode == "stall":
            time.sleep(stall)
            return data
        buf = bytearray(data)
        if buf:
            buf[pos] ^= 0x40
        return bytes(buf)

    def store_apply(self, txns) -> None:
        """``store.apply`` gate (ObjectStore.queue_transactions):
        error raises before any mutation, stall sleeps in place (a
        wedged disk), corrupt bit-flips one byte of one write payload
        — the planted bit rot that deep scrub must catch via hinfo.
        ``txns`` is passed to the site's ``match`` predicate so tests
        can target one object/shard."""
        if not self._armed_any:
            return
        with self._lock:
            s = self._sites.get(STORE_APPLY)
            if s is None or not s.should_trip(txns):
                return
            mode, stall, rng = s.mode, s.stall_s, s.rng
            self._refresh_gate()
        if mode == "error":
            raise InjectedError(STORE_APPLY)
        if mode == "stall":
            time.sleep(stall)
            return
        writes = [(t, i) for t in txns for i, op in enumerate(t.ops)
                  if op[0] == "write" and len(op[4]) > 0]
        if not writes:
            return
        t, i = writes[rng.randrange(len(writes))]
        op = t.ops[i]
        buf = bytearray(op[4])       # payloads may be read-only views
        buf[rng.randrange(len(buf))] ^= 0x40
        t.ops[i] = (op[0], op[1], op[2], op[3], bytes(buf))

    # -- export ----------------------------------------------------------
    def counters(self) -> Dict[str, Dict[str, int]]:
        """{site: {hits, trips, armed}} for sites that saw traffic or
        are armed — merged into the OSD perf dump as the ``faults``
        subsystem and rendered by mgr prometheus."""
        out: Dict[str, Dict[str, int]] = {}
        for name, s in self._sites.items():
            if s.hits or s.trips or s.armed:
                out[name] = {"hits": s.hits, "trips": s.trips,
                             "armed": int(s.armed)}
        return out

    def trips(self, name: str) -> int:
        s = self._sites.get(name)
        return s.trips if s is not None else 0

    def armed_sites(self) -> List[str]:
        return [n for n, s in self._sites.items() if s.armed]


_REGISTRY = FaultRegistry()


def registry() -> FaultRegistry:
    return _REGISTRY


def configure_from(conf) -> None:
    """Arm the process registry from a Config (daemon/cluster boot).
    Missing options (bare dict-like confs in unit tests) are
    ignored."""
    try:
        spec = conf["fault_injection"]
        seed = conf["fault_injection_seed"]
    except (KeyError, TypeError, AttributeError):
        return
    if spec:
        _REGISTRY.configure(spec, seed=seed)

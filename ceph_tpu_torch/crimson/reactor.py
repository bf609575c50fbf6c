"""Single-threaded event loop driving a crimson OSD.

The reactor owns one thread and three sources of work:

  * **IO readiness** — sockets registered via :meth:`Reactor.register`
    get their ``on_readable`` / ``on_writable`` callbacks invoked from
    the loop (``selectors``-based, level-triggered).
  * **Ready callbacks** — :meth:`call_soon` from any thread appends to
    a run queue drained once per tick; a socketpair wakes the selector
    so cross-thread scheduling has no polling latency.
  * **Timers** — :meth:`call_later` / :meth:`call_every` replace the
    classic OSD's heartbeat/tick/recovery threads.

One *tick* = one selector wait + IO callbacks + due timers + a full
drain of the ready queue, then the **tick hooks** run.  The hooks are
the coalescing barrier the EC batcher exploits: every op processed
this tick has already submitted its stripes, so the hook can cut the
batching window immediately instead of sleeping it out
(:meth:`EncodeBatcher.tick_flush`).

No locks guard reactor-owned state beyond the ready-queue mutex;
everything else is touched only from the loop thread — that is the
point of the design (reference: Seastar's shared-nothing reactor,
crimson/common/).

**Shard groups**: reactors peer into a fixed group
(:meth:`attach_peers`), one shard id each, and cross-shard work moves
by :meth:`submit_to` — modeled on seastar's ``smp::submit_to`` — over
lock-free SPSC mailboxes.  Each reactor owns one inbound mailbox per
peer shard; a mailbox has exactly one producer (the source reactor's
thread) and one consumer (the owner's loop), so a plain ``deque``
append/popleft pair is a correct lock-free ring under the GIL.  The
producer wakes the target's selector only on the empty→non-empty
transition, keeping the enqueue cost a couple of attribute loads plus
at most one ``send()``.
"""
from __future__ import annotations

import heapq
import selectors
import socket
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple


class Future:
    """Minimal completion token for reactor continuation chains.

    Callbacks never run synchronously from :meth:`set_result` — they
    are scheduled on the reactor (asyncio semantics), so resolving a
    future from within a callback cannot reenter the continuation
    under held locks.  :meth:`then` chains: the mapper's return value
    resolves the next future, and a returned ``Future`` splices in.
    """

    __slots__ = ("_reactor", "_done", "_result", "_exc", "_cbs")

    def __init__(self, reactor: "Reactor"):
        self._reactor = reactor
        self._done = False
        self._result: Any = None
        self._exc: Optional[BaseException] = None
        self._cbs: List[Callable[["Future"], None]] = []

    def done(self) -> bool:
        return self._done

    def result(self) -> Any:
        if not self._done:
            raise RuntimeError("future not resolved")
        if self._exc is not None:
            raise self._exc
        return self._result

    def exception(self) -> Optional[BaseException]:
        return self._exc

    def set_result(self, value: Any = None) -> None:
        self._resolve(value, None)

    def set_exception(self, exc: BaseException) -> None:
        self._resolve(None, exc)

    def _resolve(self, value: Any, exc: Optional[BaseException]) -> None:
        if self._done:
            raise RuntimeError("future already resolved")
        self._done = True
        self._result = value
        self._exc = exc
        cbs, self._cbs = self._cbs, []
        for cb in cbs:
            self._reactor.call_soon(cb, self)

    def add_done_callback(self, fn: Callable[["Future"], None]) -> None:
        if self._done:
            self._reactor.call_soon(fn, self)
        else:
            self._cbs.append(fn)

    def then(self, fn: Callable[[Any], Any]) -> "Future":
        nxt = Future(self._reactor)

        def _step(fut: "Future") -> None:
            if fut._exc is not None:
                nxt.set_exception(fut._exc)
                return
            try:
                out = fn(fut._result)
            except BaseException as e:  # noqa: BLE001 — propagate to chain
                nxt.set_exception(e)
                return
            if isinstance(out, Future):
                out.add_done_callback(
                    lambda f: nxt._resolve(f._result, f._exc))
            else:
                nxt.set_result(out)

        self.add_done_callback(_step)
        return nxt


def _resolve_quiet(fut: Future, value: Any,
                   exc: Optional[BaseException]) -> None:
    # runs on the future's own reactor; a shutdown race may have
    # resolved it already, which is not worth killing the loop over
    try:
        fut._resolve(value, exc)
    except RuntimeError:
        pass


class _Timer:
    __slots__ = ("when", "seq", "fn", "args", "cancelled")

    def __init__(self, when: float, seq: int, fn, args):
        self.when = when
        self.seq = seq
        self.fn = fn
        self.args = args
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True

    def __lt__(self, other: "_Timer") -> bool:
        return (self.when, self.seq) < (other.when, other.seq)


class Reactor:
    """The event loop.  Start with :meth:`start`, stop with :meth:`stop`."""

    #: selector wait cap when idle; keeps stop() latency bounded even
    #: if the wake pipe were to fail.
    _IDLE_WAIT = 0.05

    def __init__(self, name: str = "reactor"):
        self._name = name
        self._sel = selectors.DefaultSelector()
        self._ready: List[Tuple[Callable, tuple]] = []
        self._ready_lock = threading.Lock()
        self._timers: List[_Timer] = []
        self._timer_seq = 0
        self._tick_hooks: List[Callable[[], None]] = []
        self._handlers: Dict[int, Tuple[Any, Optional[Callable],
                                        Optional[Callable]]] = {}
        self._interest: Dict[int, int] = {}   # fd -> selector events
        self._stop_flag = False
        self._thread: Optional[threading.Thread] = None
        # self-wake pipe: writing one byte pops the selector out of its
        # wait so call_soon from foreign threads takes effect at once
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)
        # shard group: a lone reactor is shard 0 of itself;
        # attach_peers() re-wires these for the N-reactor OSD
        self.shard = 0
        self._peers: List["Reactor"] = [self]
        self._mailboxes: List[deque] = []
        # telemetry sinks, wired by the OSD (utils/locks.py
        # ContentionStats); None keeps the drain path dependency-free
        self.contention = None
        self.mailbox_site: Optional[str] = None
        # stats surfaced by tests / admin socket
        self.ticks = 0
        self.callbacks_run = 0
        self.xshard_in = 0           # mailbox items this reactor ran
        self.xshard_out = 0          # items this reactor sent away
        self.mailbox_hwm = 0         # max inbound depth seen at drain
        # per-shard utilization telemetry (dump_trace counter tracks):
        # busy_s accumulates non-wait loop time; every
        # _UTIL_SAMPLE_TICKS ticks one (wall_ts, util, loop_lag_s)
        # sample lands in a bounded ring, so whether multi-shard
        # scaling is real reads straight off these
        self.busy_s = 0.0
        self.loop_lag_s = 0.0        # latest wait overshoot observed
        self.util_samples: deque = deque(maxlen=512)

    # ------------------------------------------------------------- threads
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name=self._name, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop_flag = True
        self._wake()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)

    def in_reactor(self) -> bool:
        return threading.current_thread() is self._thread

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"\0")
        except OSError:
            pass

    # ---------------------------------------------------------- scheduling
    def call_soon(self, fn: Callable, *args) -> None:
        """Run ``fn(*args)`` on the reactor thread; threadsafe.

        Batched wake: the wake byte is sent only on the
        empty→non-empty transition — same contract as the SPSC
        mailboxes — so a fan-in burst of N callbacks costs one
        ``send()`` instead of N.  A non-empty queue means an earlier
        producer's wake is still pending (or the loop has already
        seen the work via ``_next_timeout``), so the byte is
        redundant."""
        with self._ready_lock:
            was_empty = not self._ready
            self._ready.append((fn, args))
        if was_empty and not self.in_reactor():
            self._wake()

    def call_later(self, delay: float, fn: Callable, *args) -> _Timer:
        """One-shot timer; returns a handle with ``.cancel()``."""
        self._timer_seq += 1
        t = _Timer(time.monotonic() + max(0.0, delay), self._timer_seq,
                   fn, args)
        # the heap itself is only mutated under the ready lock so the
        # loop and foreign threads (call_later from timers is reactor-
        # side, but OSD code may arm timers before start()) stay safe
        with self._ready_lock:
            heapq.heappush(self._timers, t)
        if not self.in_reactor():
            self._wake()
        return t

    def call_every(self, interval: float, fn: Callable, *args) -> _Timer:
        """Periodic timer; rearms after each run until cancelled."""
        interval = max(interval, 1e-3)
        holder: List[_Timer] = []

        def _fire() -> None:
            try:
                fn(*args)
            finally:
                if not self._stop_flag and not holder[0].cancelled:
                    nxt = self.call_later(interval, _fire)
                    nxt.cancelled = holder[0].cancelled
                    holder[0] = nxt

        first = self.call_later(interval, _fire)
        holder.append(first)

        class _Periodic:
            def cancel(self_inner) -> None:
                holder[0].cancel()

        return _Periodic()  # type: ignore[return-value]

    # ------------------------------------------------------- shard group
    @classmethod
    def group(cls, n: int, name: str = "reactor") -> List["Reactor"]:
        """Build ``n`` peered reactors named ``{name}-r{i}``."""
        peers = [cls(name=f"{name}-r{i}") for i in range(max(1, n))]
        for r in peers:
            r.attach_peers(peers)
        return peers

    def attach_peers(self, peers: List["Reactor"]) -> None:
        """Join a shard group; this reactor's shard id is its index.
        Must run before start() — mailboxes are not resizable live."""
        self._peers = list(peers)
        self.shard = self._peers.index(self)
        self._mailboxes = [deque() for _ in self._peers]

    def bind_contention(self, stats, site: str) -> None:
        """Export mailbox depth (``{site}_depth_now/_hwm``) and
        cross-shard handoff latency (``xshard_handoff_wait_us``)
        through a ContentionStats sink."""
        self.contention = stats
        self.mailbox_site = site

    def submit_to(self, shard: int, fn: Callable, *args) -> Future:
        """Run ``fn(*args)`` on ``shard``'s reactor; seastar's
        ``smp::submit_to``.  The returned future resolves on THIS
        reactor with the call's result (or exception), so round-trip
        continuations stay shard-local at both ends.

        Fast path (calling thread IS this reactor): one lock-free
        SPSC mailbox append + at most one wake byte.  Same-shard and
        foreign-thread callers fall back to the locked ready queue —
        correctness is identical, only the lock-freedom differs."""
        fut = Future(self)
        peers = self._peers
        target = peers[shard] if 0 <= shard < len(peers) else self
        if target is self:
            self.call_soon(self._run_submitted, fn, args, fut)
            return fut
        if not self.in_reactor():
            # mailboxes are SPSC — one producer per source shard; a
            # foreign thread is not that producer
            target.call_soon(target._run_submitted, fn, args, fut)
            return fut
        mb = target._mailboxes[self.shard]
        was_empty = not mb
        mb.append((fn, args, fut, time.monotonic()))
        self.xshard_out += 1
        if was_empty:
            target._wake()
        return fut

    def _run_submitted(self, fn, args, fut: Future) -> None:
        # target-shard half of submit_to: run, then resolve the reply
        # future on the CALLER's reactor (its loop runs the chained
        # callbacks; call_soon is the threadsafe edge)
        try:
            res = fn(*args)
        except BaseException as e:  # noqa: BLE001 — ship to the caller
            fut._reactor.call_soon(_resolve_quiet, fut, None, e)
            return
        fut._reactor.call_soon(_resolve_quiet, fut, res, None)

    def _drain_mailboxes(self) -> None:
        boxes = self._mailboxes
        if not boxes:
            return
        depth = 0
        for mb in boxes:
            depth += len(mb)
        if not depth:
            return
        if depth > self.mailbox_hwm:
            self.mailbox_hwm = depth
        stats = self.contention
        if stats is not None and self.mailbox_site is not None:
            stats.note_queue_depth(self.mailbox_site, depth)
        now = time.monotonic()
        for mb in boxes:
            # bound the drain to the items present at entry; anything
            # a producer appends mid-drain waits one tick
            for _ in range(len(mb)):
                try:
                    fn, args, fut, t_enq = mb.popleft()
                except IndexError:      # pragma: no cover — SPSC
                    break
                self.xshard_in += 1
                if stats is not None:
                    stats.on_wait("xshard_handoff", now - t_enq)
                self._run_submitted(fn, args, fut)

    def future(self) -> Future:
        return Future(self)

    def resolved(self, value: Any = None) -> Future:
        f = Future(self)
        f.set_result(value)
        return f

    def add_tick_hook(self, fn: Callable[[], None]) -> None:
        """Run ``fn()`` at the end of every tick (reactor thread)."""
        self._tick_hooks.append(fn)

    # ------------------------------------------------------------------ IO
    def register(self, sock, on_readable: Optional[Callable[[], None]],
                 on_writable: Optional[Callable[[], None]] = None) -> None:
        """Watch ``sock`` for readability (and, via :meth:`want_write`
        / :meth:`want_read`, toggled interest).  Must be invoked on
        the reactor thread."""
        fd = sock.fileno()
        if fd < 0:
            return
        self._handlers[fd] = (sock, on_readable, on_writable)
        self._interest[fd] = selectors.EVENT_READ
        try:
            self._sel.register(sock, selectors.EVENT_READ, fd)
        except KeyError:
            self._sel.modify(sock, selectors.EVENT_READ, fd)

    def _set_interest(self, sock, fd: int, events: int) -> None:
        # selectors refuses events=0, so "no interest" means
        # unregistering from the selector while the handler entry
        # (and _interest bookkeeping) stays — re-adding an event
        # re-registers
        try:
            if events:
                try:
                    self._sel.modify(sock, events, fd)
                except KeyError:
                    self._sel.register(sock, events, fd)
            else:
                self._sel.unregister(sock)
        except (KeyError, ValueError, OSError):
            pass

    def want_write(self, sock, flag: bool) -> None:
        """Toggle EVENT_WRITE interest for a registered socket."""
        fd = sock.fileno()
        if fd < 0 or fd not in self._handlers:
            return
        ev = self._interest.get(fd, selectors.EVENT_READ)
        ev = (ev | selectors.EVENT_WRITE) if flag \
            else (ev & ~selectors.EVENT_WRITE)
        self._interest[fd] = ev
        self._set_interest(sock, fd, ev)

    def want_read(self, sock, flag: bool) -> None:
        """Toggle EVENT_READ interest (admission backpressure: a
        paused client socket queues bytes in the kernel — and
        eventually the peer's send window — instead of the shard's
        op queue)."""
        fd = sock.fileno()
        if fd < 0 or fd not in self._handlers:
            return
        ev = self._interest.get(fd, selectors.EVENT_READ)
        ev = (ev | selectors.EVENT_READ) if flag \
            else (ev & ~selectors.EVENT_READ)
        self._interest[fd] = ev
        self._set_interest(sock, fd, ev)

    def unregister(self, sock) -> None:
        """Forget a socket; tolerant of sockets already closed."""
        try:
            key = self._sel.get_key(sock)
            self._handlers.pop(key.data, None)
            self._interest.pop(key.data, None)
            self._sel.unregister(sock)
            return
        except (KeyError, ValueError, OSError):
            pass
        # closed socket: fileno() is -1, look it up by identity
        for fd, (s, _r, _w) in list(self._handlers.items()):
            if s is sock:
                self._handlers.pop(fd, None)
                self._interest.pop(fd, None)
                for key in list(self._sel.get_map().values()):
                    if key.fileobj is sock:
                        try:
                            self._sel.unregister(key.fileobj)
                        except (KeyError, ValueError, OSError):
                            pass
                break

    def util_dump(self) -> List[Dict[str, float]]:
        """Snapshot of the utilization ring (any thread; the reactor
        appends concurrently, so retry the racy iteration)."""
        snap: List[Tuple[float, float, float]] = []
        for _ in range(3):
            try:
                snap = list(self.util_samples)
                break
            except RuntimeError:
                continue
        return [{"ts": ts, "util": u, "loop_lag_s": lag}
                for ts, u, lag in snap]

    # ---------------------------------------------------------------- loop
    _UTIL_SAMPLE_TICKS = 64

    def _next_timeout(self) -> float:
        for mb in self._mailboxes:
            if mb:
                return 0.0
        with self._ready_lock:
            if self._ready:
                return 0.0
            while self._timers and self._timers[0].cancelled:
                heapq.heappop(self._timers)
            if self._timers:
                return max(0.0,
                           min(self._IDLE_WAIT,
                               self._timers[0].when - time.monotonic()))
        return self._IDLE_WAIT

    def _run(self) -> None:
        win_t0 = time.monotonic()
        win_busy = 0.0
        while not self._stop_flag:
            timeout = self._next_timeout()
            t_wait = time.monotonic()
            try:
                events = self._sel.select(timeout)
            except OSError:
                # a watched fd died outside unregister(); purge and retry
                self._purge_dead()
                continue
            t_work = time.monotonic()
            # loop lag: how far past the requested wait the selector
            # returned — GIL/scheduler pressure, not IO latency
            self.loop_lag_s = max(0.0, (t_work - t_wait) - timeout)
            for key, mask in events:
                if key.fileobj is self._wake_r:
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                    continue
                ent = self._handlers.get(key.data)
                if ent is None:
                    continue
                _sock, on_r, on_w = ent
                try:
                    if (mask & selectors.EVENT_READ) and on_r is not None:
                        on_r()
                    if (mask & selectors.EVENT_WRITE) and on_w is not None:
                        # handler may have unregistered in on_r()
                        if key.data in self._handlers:
                            on_w()
                except Exception:  # noqa: BLE001 — a conn dying must not
                    pass           # take the whole reactor with it

            self._drain_mailboxes()
            self._run_timers()
            self._drain_ready()
            for hook in self._tick_hooks:
                try:
                    hook()
                except Exception:  # noqa: BLE001
                    pass
            self.ticks += 1
            t_end = time.monotonic()
            busy = t_end - t_work
            self.busy_s += busy
            win_busy += busy
            if not (self.ticks % self._UTIL_SAMPLE_TICKS):
                wall = t_end - win_t0
                if wall > 0:
                    self.util_samples.append(
                        (time.time(), min(1.0, win_busy / wall),
                         self.loop_lag_s))
                win_t0, win_busy = t_end, 0.0
        # drop whatever is left; the OSD is shutting down
        try:
            self._sel.close()
        except OSError:
            pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass

    def _run_timers(self) -> None:
        now = time.monotonic()
        while True:
            with self._ready_lock:
                if not self._timers or self._timers[0].when > now:
                    return
                t = heapq.heappop(self._timers)
            if t.cancelled:
                continue
            try:
                t.fn(*t.args)
            except Exception:  # noqa: BLE001
                pass

    def _drain_ready(self) -> None:
        # drain until empty so continuations scheduled by this tick's
        # ops (encode submits, commit chains) still land in the same
        # tick and see the tick-hook flush; bounded to break livelock
        # if a callback perpetually reschedules itself
        done = 0
        for _ in range(100):
            with self._ready_lock:
                batch, self._ready = self._ready, []
            if not batch:
                return
            for fn, args in batch:
                self.callbacks_run += 1
                try:
                    fn(*args)
                except Exception:  # noqa: BLE001
                    pass
                # timers must not wait out the whole drain: heartbeats
                # and stats reports are reactor timers now, and under a
                # write flood a single drain can run seconds of encode
                # continuations — enough for the mon to declare a LIVE
                # osd silent and mark it down.  Interleave due timers
                # every few callbacks so daemon liveness is bounded by
                # one callback, not one tick.  The unlocked peek at
                # _timers[0] races only with heappush from call_later
                # (pops happen on this thread); a stale read just means
                # one extra or one skipped check.
                done += 1
                if not (done & 15) and self._timers and \
                        self._timers[0].when <= time.monotonic():
                    self._run_timers()

    def _purge_dead(self) -> None:
        for key in list(self._sel.get_map().values()):
            sock = key.fileobj
            if sock is self._wake_r:
                continue
            try:
                dead = sock.fileno() < 0
            except OSError:
                dead = True
            if dead:
                self._handlers.pop(key.data, None)
                self._interest.pop(key.data, None)
                try:
                    self._sel.unregister(sock)
                except (KeyError, ValueError, OSError):
                    pass

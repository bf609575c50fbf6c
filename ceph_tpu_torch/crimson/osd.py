"""CrimsonOSD — the classic OSD's logic on a shard-per-core data path.

Same PG/pglog/backend/scrub/recovery code, different execution model
(reference crimson-osd reuses the osd-side protocol while replacing
the threading): no sharded op queues, no per-shard worker threads, no
heartbeat/tick/recovery threads.  N reactor threads
(``crimson_num_reactors``, default min(cores, 4)) split the daemon
seastar-style:

  * **PG partitioning** — every PG is statically owned by shard
    ``hash(pgid) % N``; its client ops, sub-ops, peering, scrub and
    recovery work all execute on that reactor, so per-PG state is
    effectively single-threaded and the PG lock is never contended on
    the data path (it remains as the guard for the cross-shard
    maintenance walkers: map advance, tick stats, log trim);
  * **cross-shard handoff** — a message that lands on the wrong
    reactor (connections are pinned round-robin) hops to the owner
    via :meth:`Reactor.submit_to` over a lock-free SPSC mailbox and
    stamps the ``xshard_handoff`` hop; sub-op dispatch, commit fanout
    and heartbeats never take a cross-shard lock;
  * **one shared EncodeBatcher** — all shards feed the per-OSD
    batcher through an MPSC front (:class:`ReactorBatcher` buffers
    each shard's submissions on its own reactor-local queue and
    flushes them at tick end), so coalescing windows fill from every
    PG on the daemon and the window is cut only when every shard has
    drained — cluster traffic reaches the batched device path instead
    of fragmenting into per-reactor singleton twin calls;
  * maintenance as timers on shard 0: ``_heartbeat_once`` /
    ``_tick_once`` / ``_recovery_scan`` are the SAME methods the
    classic threads call, so heartbeats, mon boot/failure reporting
    and thrash recovery behave identically by construction.

Blocking work keeps its classic helper threads: handshakes/reconnect
(messenger control plane), copy-from / cache promote / flush fetches
(internal objecter), the batcher's collector, and the store's own
machinery.  They were built for a multithreaded OSD and stay safe —
PG state is still lock-protected.
"""
from __future__ import annotations

import os
from collections import deque
from typing import List, Optional, Tuple

from ..msg.messages import (MOSDOp, MOSDPGRemove, MOSDScrub, MRepScrub,
                            MRepScrubMap)
from ..msg.messenger import Connection, Messenger
from ..osd.osd import _BACKEND_MSGS, _PEERING_MSGS, OSD
from ..osd.pg import PG, PGid
from ..store.objectstore import ObjectStore
from ..utils.config import Config, default_config
from .net import CrimsonMessenger
from .reactor import Reactor


class ReactorBatcher:
    """MPSC front for the shared per-OSD batcher.

    Every reactor shard buffers its tick's encode/decode submissions
    on a reactor-local queue (producer and consumer are the SAME
    thread — submission during the tick, :meth:`shard_tick` at its
    end), then flushes them into the shared ``EncodeBatcher`` in one
    burst.  The window cut (``tick_flush``) fires only when no OTHER
    shard still holds buffered stripes, so a group forming across
    shards is not chopped by the first shard to finish its tick.

    Completion callbacks re-enter PG code, so each is marshalled back
    onto the SUBMITTING shard's reactor — the continuation stays on
    the PG's owning shard whether the encode completed on the
    collector thread, the device callback, or inline."""

    def __init__(self, inner, reactors: List[Reactor]):
        self._inner = inner
        self._reactors = list(reactors)
        self._pending: List[deque] = [deque() for _ in self._reactors]

    def _current_shard(self) -> int:
        for i, r in enumerate(self._reactors):
            if r.in_reactor():
                return i
        return -1

    def _marshal(self, cb, shard: int):
        r = self._reactors[shard if shard >= 0 else 0]

        def done(result):
            r.call_soon(cb, result)
        return done

    def submit(self, ec_impl, sinfo, data, cb, tracked=None) -> None:
        shard = self._current_shard()
        if shard < 0:
            # foreign thread (tests, recovery helpers): straight in
            self._inner.submit(ec_impl, sinfo, data,
                               self._marshal(cb, 0), tracked=tracked)
            return
        self._pending[shard].append(
            ("enc", (ec_impl, sinfo, data,
                     self._marshal(cb, shard), tracked)))

    def submit_decode(self, ec_impl, sinfo, have, want, cb) -> None:
        shard = self._current_shard()
        if shard < 0:
            self._inner.submit_decode(ec_impl, sinfo, have, want,
                                      self._marshal(cb, 0))
            return
        self._pending[shard].append(
            ("dec", (ec_impl, sinfo, have, want,
                     self._marshal(cb, shard))))

    def submit_delta(self, ec_impl, sinfo, delta, dirty_cols, cb,
                     tracked=None) -> None:
        # parity-delta RMW lane: same shard-buffered front as encode —
        # the Δparity continuation re-enters ECBackend, so it must
        # land back on the PG's owning reactor
        shard = self._current_shard()
        if shard < 0:
            self._inner.submit_delta(ec_impl, sinfo, delta, dirty_cols,
                                     self._marshal(cb, 0),
                                     tracked=tracked)
            return
        self._pending[shard].append(
            ("delta", (ec_impl, sinfo, delta, dirty_cols,
                       self._marshal(cb, shard), tracked)))

    def shard_tick(self, shard: int) -> None:
        """Tick hook for ``shard``'s reactor: flush its buffered
        submissions, then cut the coalescing window iff every shard
        has drained."""
        q = self._pending[shard]
        if q:
            inner = self._inner
            while True:
                try:
                    kind, a = q.popleft()
                except IndexError:
                    break               # shutdown flush raced us
                if kind == "enc":
                    inner.submit(a[0], a[1], a[2], a[3], tracked=a[4])
                elif kind == "delta":
                    inner.submit_delta(a[0], a[1], a[2], a[3], a[4],
                                       tracked=a[5])
                else:
                    inner.submit_decode(*a)
        for other in self._pending:
            if other:
                return
        self._inner.tick_flush()

    def flush_pending(self) -> None:
        """Drain every shard's buffer from the caller's thread
        (shutdown: the reactors may already be winding down)."""
        for q in self._pending:
            while True:
                try:
                    kind, a = q.popleft()
                except IndexError:
                    break
                if kind == "enc":
                    self._inner.submit(a[0], a[1], a[2], a[3],
                                       tracked=a[4])
                elif kind == "delta":
                    self._inner.submit_delta(a[0], a[1], a[2], a[3],
                                             a[4], tracked=a[5])
                else:
                    self._inner.submit_decode(*a)

    def stop(self, drain: float = 30.0) -> None:
        self.flush_pending()
        self._inner.stop(drain=drain)

    def __getattr__(self, name):
        # prewarm / prefer_cpu / tick_flush / counters — and the
        # device-waterfall surface (device_dump / device_trace_block /
        # ledger_accum, consumed by dump_device and the trace bundle)
        # — pass straight through to the shared batcher: the phase
        # ledger is stamped on the collector/device threads, so the
        # shard front adds nothing to observe
        return getattr(self._inner, name)


#: message types whose handling mutates one PG's state — these route
#: to the PG's owning shard before the base dispatch logic runs
_PG_ROUTED = _BACKEND_MSGS + _PEERING_MSGS + (
    MOSDPGRemove, MOSDScrub, MRepScrub, MRepScrubMap)


class CrimsonOSD(OSD):
    """Drop-in OSD selected by ``osd_backend=crimson`` (the default).

    Runs in the same cluster as classic OSDs: wire protocol, maps,
    heartbeats and recovery are identical — only the intra-daemon
    execution model differs."""

    #: recovery scan cadence; matches the classic thread's kick wait
    _RECOVERY_TICK = 0.2

    def __init__(self, whoami: int, store: ObjectStore,
                 mon_addr: Tuple[str, int],
                 conf: Optional[Config] = None,
                 addr: Tuple[str, int] = ("127.0.0.1", 0)):
        conf = conf or default_config()
        n = conf["crimson_num_reactors"] or min(os.cpu_count() or 1, 4)
        # the reactors must exist before super().__init__ calls
        # _make_messenger
        self.reactors = Reactor.group(n, name=f"crimson-osd{whoami}")
        self.reactor = self.reactors[0]      # shard 0: maintenance +
        self.n_reactors = n                  # single-reactor compat
        super().__init__(whoami, store, mon_addr, conf=conf, addr=addr)
        # mClock QoS on the reactor data path: one
        # OpScheduler per reactor shard replaces the classic
        # osd_op_num_shards queues the base built — PG-addressed work
        # (client ops, recovery items, scrub rounds) enqueues
        # class-tagged on the owning shard and the reactor drains it
        # through the same reservation/weight/limit arbitration the
        # classic workers use
        from ..osd.scheduler import OpScheduler, qos_from_conf
        fifo = self.conf["osd_op_queue"] == "fifo"
        qos = {} if fifo else qos_from_conf(self.conf)
        hard = any(lim > 0 for _, _, lim in qos.values())
        for q in self._shard_queues:
            q.close()
        self._n_shards = n
        self._shard_queues = [
            OpScheduler(qos, hard_limits=hard, fifo=fifo)
            for _ in range(n)]
        # admission backpressure: the messenger consults the owning
        # shard's queue depth before reading more client bytes
        self.msgr.admission_gate = self._admission_overloaded
        self.encode_batcher = ReactorBatcher(self.encode_batcher,
                                             self.reactors)
        # mailbox depth + cross-shard handoff latency ride the
        # contention subsystem (mailbox_rN_depth_now/_hwm,
        # xshard_handoff_acquires/_wait_us)
        self.contention.register_site("xshard_handoff")
        for r in self.reactors:
            site = f"mailbox_r{r.shard}"
            self.contention.register_queue(site)
            r.bind_contention(self.contention, site)
        # reactor-native deferred apply: a BlueStore-class backend
        # schedules its apply batches as tasks on the LAST shard
        # (shard 0 carries maintenance timers) instead of spinning a
        # thread the reactor model doesn't own; blocked readers still
        # work-steal, so a shard reading its own pending write makes
        # progress without waiting on the apply shard.  Only worth it
        # with a spare shard: on a single-reactor OSD the apply
        # batches would block the one event loop that carries the
        # whole data path (measured: 0.67x jerasure on the 1-core
        # k8m4 run vs 2x+ with the applier thread), so N=1 keeps the
        # store's own daemon thread.
        if hasattr(self.store, "bind_apply_reactor") \
                and len(self.reactors) > 1:
            self.store.bind_apply_reactor(self.reactors[-1])

    def _make_messenger(self) -> Messenger:
        return CrimsonMessenger(f"osd.{self.whoami}", conf=self.conf,
                                reactor=self.reactor,
                                reactors=self.reactors)

    def _call_later(self, delay: float, fn):
        # same per-OSD hashed timer wheel as the classic backend, but
        # the fire is marshalled onto a reactor so re-request/report
        # continuations run on a reactor thread like every other PG
        # continuation (no extra timer threads, no cross-thread PG
        # state access from the wheel)
        return self.timer_wheel.call_later(
            delay, lambda: self.reactor.call_soon(fn))

    # -- shard routing -----------------------------------------------------
    def _shard_of(self, pgid: PGid) -> int:
        return hash(pgid) % self.n_reactors

    def _current_reactor(self) -> Optional[Reactor]:
        for r in self.reactors:
            if r.in_reactor():
                return r
        return None

    def _pg_created(self, pg: PG) -> None:
        pg.home_shard = self._shard_of(pg.pgid)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._sampler_retain()
        for r in self.reactors:
            r.start()
        self.msgr.start()
        # maintenance runs as shard-0 timers on the SAME methods the
        # classic threads drive, so cross-backend behavior is
        # identical; per-PG work they queue is routed to owner shards
        self.reactor.call_every(self.conf["osd_heartbeat_interval"],
                                self._heartbeat_once)
        # _tick_once carries the closed-loop tuner tick too
        # (_maybe_tuner_tick): on crimson the controller runs as this
        # shard-0 reactor timer, on classic as the tick thread — the
        # same guarded hill-climb either way
        self.reactor.call_every(self.conf["osd_tick_interval"],
                                self._tick_once)
        self.reactor.call_every(self._RECOVERY_TICK,
                                self._drain_recovery_kick)
        # per-shard QoS drain first (queued ops run inside this tick,
        # their stripes reach the MPSC buffer), then the coalescing
        # barrier: flush each shard's buffer and cut the batch window
        # once ALL shards have drained
        for r in self.reactors:
            r.add_tick_hook(
                lambda i=r.shard: self._qos_tick(i))
            r.add_tick_hook(
                lambda i=r.shard: self.encode_batcher.shard_tick(i))
            # admission backpressure: re-admit paused client sockets
            # once this shard's queue has drained below half the HWM
            r.add_tick_hook(
                lambda i=r.shard: self._admission_resume_tick(i))
        self.monc.subscribe_osdmap()
        self.monc.send_boot(self.whoami, self.my_addr)
        if self.admin_socket is not None:
            self.admin_socket.start()
        self.log.dout(1, f"booted (crimson, {self.n_reactors} "
                         f"reactor shards), addr {self.my_addr}")

    def shutdown(self) -> None:
        self._stop.set()
        if self.admin_socket is not None:
            self.admin_socket.stop()
        # drain before stopping the reactors: encode completions
        # marshal onto them and commit chains still send over the msgr
        self.encode_batcher.stop(
            drain=self.conf["osd_batcher_drain_timeout"])
        for q in self._shard_queues:
            q.close()                    # stop admitting scheduler work
        if self._int_client is not None:
            try:
                self._int_client.shutdown()
            except Exception:
                pass
        self.msgr.shutdown()
        self.timer_wheel.stop()
        # unbind the apply shard BEFORE the reactors die so umount's
        # inline drain doesn't schedule onto a stopped reactor
        if hasattr(self.store, "bind_apply_reactor"):
            self.store.bind_apply_reactor(None)
        for r in self.reactors:
            r.stop()
        self._sampler_release()
        try:
            self.store.umount()
        except Exception:
            pass

    # -- data path ---------------------------------------------------------
    def ms_dispatch(self, conn: Connection, msg) -> bool:
        # PG-targeted messages run on the PG's owning shard.  MOSDOp
        # routes via _enqueue_op below; everything else that mutates
        # one PG hops here.  Heartbeats, commands and maps stay on
        # whichever reactor received them — none touch PG state.
        if self.n_reactors > 1 and isinstance(msg, _PG_ROUTED):
            shard = self._shard_of(PGid.parse(msg.pgid))
            cur = self._current_reactor()
            if cur is None or cur.shard != shard:
                # stamp before the hop so the ledger stays monotone
                # (base dispatch re-stamps are first-stamp-wins no-ops)
                msg.stamp_hop("dispatch_queued")
                src = cur or self.reactors[shard]
                src.submit_to(shard, self._dispatch_handoff, conn,
                              msg, cur is not None)
                return True
        return super().ms_dispatch(conn, msg)

    def _dispatch_handoff(self, conn, msg, crossed: bool) -> None:
        if crossed:
            msg.stamp_hop("xshard_handoff")
        OSD.ms_dispatch(self, conn, msg)

    def _enqueue_op(self, conn: Connection, msg: MOSDOp) -> None:
        pgid = PGid(msg.pool, msg.pgid_seed)
        msg.tracked = self.op_tracker.create(
            f"osd_op({msg.client}.{msg.tid} {pgid} {msg.oid} "
            f"{'+'.join(op.op for op in msg.ops)})")
        # class tag consumed by SLOEngine.observe_op at retirement
        # (same contract as the classic OSD's _enqueue_op)
        msg.tracked.slo_class = "client_write" \
            if any(PG._op_is_write(op) for op in msg.ops) \
            else "client_read"
        msg.tracked.mark_event("queued_for_pg")
        msg.stamp_hop("pg_queued")
        shard = self._shard_of(pgid)
        cur = self._current_reactor()
        # connection-to-shard affinity: vote for the op's owning
        # shard; a sustained majority re-pins the connection's pumps
        # there so subsequent ops skip the cross-shard handoff
        if self.conf["crimson_conn_affinity"] and \
                hasattr(conn, "note_shard_vote"):
            conn.note_shard_vote(shard)
        if cur is not None and cur.shard != shard:
            msg._crossed_shard = True    # stamped at owner dequeue
        # class-tagged into the owning shard's mClock scheduler; the
        # kick rides the mailbox so the owner drains it this tick (the
        # scheduler may serve a HIGHER-priority class first — that is
        # the point)
        self._shard_queues[shard].enqueue("client", (conn, msg))
        self._kick_shard(shard, cur)

    def _kick_shard(self, shard: int,
                    cur: Optional[Reactor] = None) -> None:
        """Schedule one scheduler drain on ``shard``'s reactor."""
        (cur or self.reactors[shard]).submit_to(
            shard, self._qos_drain, shard)

    def _qos_drain(self, shard: int) -> None:
        out = self._shard_queues[shard].dequeue_nowait()
        if out is not None:
            self._run_sched_item(*out)

    def _qos_tick(self, shard: int) -> None:
        """Tick hook: serve whatever the per-kick drains left behind
        (token-gated classes waiting out a refill, kicks lost to
        shutdown races).  Bounded so one tick cannot run unbounded
        backlog."""
        q = self._shard_queues[shard]
        for _ in range(128):
            out = q.dequeue_nowait()
            if out is None:
                return
            self._run_sched_item(*out)

    def _admission_overloaded(self, conn) -> bool:
        """Messenger admission gate: pause reading a client socket
        while its reactor's shard queue is past the high-water mark.
        Daemon peers (osd./mon.) are never gated — stalling sub-op
        replies under client load would deadlock the very commits
        that drain the queue."""
        hwm = self.conf["crimson_admission_hwm"]
        if not hwm:
            return False
        peer = getattr(conn, "peer_name", "") or ""
        if peer.startswith(("osd.", "mon.", "mgr.")):
            return False
        shard = getattr(conn, "reactor", self.reactor).shard
        if shard >= len(self._shard_queues):
            return False
        return self._shard_queues[shard].queued() >= hwm

    def _admission_resume_tick(self, shard: int) -> None:
        hwm = self.conf["crimson_admission_hwm"]
        if not hwm:
            return
        if shard < len(self._shard_queues) and \
                self._shard_queues[shard].queued() <= hwm // 2:
            self.msgr.resume_paused(self.reactors[shard])

    def queue_recovery_item(self, pg: PG) -> None:
        with pg.lock:
            if getattr(pg, "_recovery_queued", False):
                return
            pg._recovery_queued = True
        shard = self._shard_of(pg.pgid)
        self._shard_queues[shard].enqueue("recovery", pg)
        self._kick_shard(shard, self._current_reactor())

    def _queue_scrub(self, pg: PG, deep: bool) -> None:
        shard = self._shard_of(pg.pgid)
        self._shard_queues[shard].enqueue(
            "scrub", lambda p=pg, d=deep: self._start_scrub(p, d))
        self._kick_shard(shard, self._current_reactor())

    def kick_recovery(self) -> None:
        # peering events may kick from foreign threads (mon dispatch
        # runs on a reactor, store completions may not)
        self.reactor.call_soon(self._recovery_scan)

    def _drain_recovery_kick(self) -> None:
        # classic parity: the 0.2s timer doubles as the kick-event
        # consumer for any base-class code setting _recovery_kick
        self._recovery_kick.clear()
        self._recovery_scan()

"""Reactor-driven messenger: the epoll rewrite of the data plane.

``CrimsonConnection`` keeps every *session* rule of the threaded
``Connection`` it subclasses — lossless seq stamping, the unacked
resend queue, MAck trimming, duplicate drop by ``in_seq``, the ack
cadence, socket-generation fencing, fault injection — but replaces the
blocking reader/writer thread pair with non-blocking pumps run by the
reactor.  Frames are parsed out of a byte buffer and dispatched
*inline* on the reactor thread, so a client op goes

    readable socket -> frame decode -> PG dispatch -> encode submit

with zero queue hops and zero thread wakeups (reference
crimson/net/SocketConnection vs msg/async's worker handoff).

Control plane stays on short-lived threads: banner/auth handshakes,
reconnect backoff, and the accept loop all block briefly off-reactor,
then hand the finished socket to the reactor via ``_attach``.  That
mirrors the reference split where crimson reuses ProtocolV2 framing
but drives it from the reactor.
"""
from __future__ import annotations

import socket
import threading
from typing import List, Optional

from collections import deque

from ..msg.message import (CRC_LEN, HEADER_LEN, decode_frame_body,
                           decode_frame_header, encode_frame_parts)
from ..msg.messages import MAck
from ..msg.messenger import (ACK_EVERY_BYTES, ACK_EVERY_MSGS, MAX_FRAME,
                             _IOV_BATCH, Connection, Messenger)
from ..utils.encoding import DecodeError
from .reactor import Reactor

# recv chunk per call; level-triggered readiness re-arms anything left
_RECV_CHUNK = 1 << 18
# at most this many recv() calls per readiness event, so one firehose
# peer cannot monopolize a tick
_RECV_ROUNDS = 64
# connection-to-shard affinity: every client op votes for
# its PG's owning shard; after this many votes a strict majority for a
# foreign shard re-pins the connection's pumps there
_VOTE_WINDOW = 32


class CrimsonConnection(Connection):
    """A ``Connection`` whose pumps are reactor callbacks, not threads.

    Reactor-owned fields (``_reg_sock``, ``_rbuf``, ``_wq``,
    ``_wants_write``) are touched only on the reactor thread; shared
    session state (queues, seqs, state) stays under the inherited lock
    because handshake/control threads still mutate it.

    The write queue is a deque of frame-part buffers (iovecs) drained
    by scatter-gather ``sendmsg`` — large payload views ride from the
    encoder to the kernel without being copied into a staging buffer."""

    def __init__(self, msgr: "CrimsonMessenger", peer_addr, lossless,
                 connector):
        super().__init__(msgr, peer_addr, lossless, connector)
        # the base spawns its reader/writer threads on first _attach
        # unless they are already "started"; they never start here
        self._pumps_started = True
        self._reg_sock: Optional[socket.socket] = None
        self._reg_gen = 0
        self._rbuf = bytearray()
        self._wq: deque = deque()       # pending iovecs (memoryviews)
        self._wants_write = False
        # write coalescing: replies generated within one
        # tick share a single scatter-gather flush scheduled at most
        # once per batch
        self._flush_scheduled = False
        # admission backpressure: reads paused while the owning
        # shard's op queue is past its high-water mark
        self._read_paused = False
        # shard-affinity vote window (reactor-thread only)
        self._shard_votes: dict = {}
        self._vote_n = 0
        self._migrating = False
        # shard-per-core: each connection starts on a
        # round-robin reactor; with crimson_conn_affinity its pumps
        # later re-pin to the shard owning most of its ops, so inline
        # dispatch lands on the PG's home shard with no mailbox hop
        self._reactor = msgr.pick_reactor()

    @property
    def reactor(self) -> Reactor:
        return self._reactor

    # -- attach / detach ---------------------------------------------------
    def _attach(self, sock, peer_name, peer_nonce, peer_in_seq):
        super()._attach(sock, peer_name, peer_nonce, peer_in_seq)
        with self.lock:
            if self.sock is not sock or self.state != "open":
                return                  # closed or replaced mid-attach
            gen = self.gen
        sock.setblocking(False)
        self.reactor.call_soon(self._register, sock, gen)

    def _register(self, sock, gen) -> None:
        # reactor thread: adopt the socket the handshake produced
        if self._reg_sock is not None and self._reg_sock is not sock:
            self.reactor.unregister(self._reg_sock)
        with self.lock:
            if self.sock is not sock or self.gen != gen \
                    or self.state != "open":
                return                  # raced with death/replace
        self._reg_sock = sock
        self._reg_gen = gen
        self._rbuf.clear()
        self._wq.clear()
        self._wants_write = False
        self._read_paused = False
        self.reactor.register(sock, self._on_readable, self._on_writable)
        self._pump_writes()             # flush traffic queued meanwhile

    def _detach(self, sock) -> None:
        if self._reg_sock is sock:
            self._reg_sock = None
            self._rbuf.clear()
            self._wq.clear()
            self._wants_write = False
            self._read_paused = False
            self.msgr.forget_paused(self)
        self.reactor.unregister(sock)

    def _io_error(self, sock, gen) -> None:
        self._detach(sock)
        # base machinery: reconnect (lossless connector), wait for
        # redial (lossless acceptor), or reset (lossy)
        self._socket_dead(sock, gen)

    def _close(self, reset: bool) -> None:
        super()._close(reset)
        r = self._reactor
        if r is None:
            return
        if r.in_reactor():
            self._purge_registration()
        else:
            r.call_soon(self._purge_registration)

    def _purge_registration(self) -> None:
        sock = self._reg_sock
        if sock is not None:
            self._detach(sock)

    # -- shard affinity ----------------------------------------------------
    def note_shard_vote(self, shard: int) -> None:
        """One client op's vote for its PG's owning shard.  Called
        from inline dispatch, i.e. on this connection's reactor.  A
        strict majority over the vote window re-pins the connection
        to the winning shard's reactor — subsequent ops then skip the
        cross-shard mailbox handoff entirely."""
        votes = self._shard_votes
        votes[shard] = votes.get(shard, 0) + 1
        self._vote_n += 1
        if self._vote_n < _VOTE_WINDOW:
            return
        best = max(votes, key=votes.get)
        n_best = votes[best]
        self._shard_votes = {}
        self._vote_n = 0
        reactors = self.msgr.reactors
        if best >= len(reactors) or self._migrating or \
                n_best * 2 <= _VOTE_WINDOW:
            return
        target = reactors[best]
        if target is self._reactor:
            return
        self._migrating = True
        # defer past the current read pump: migrating mid-parse would
        # hand _rbuf to the new reactor while this one still walks it
        self._reactor.call_soon(self._migrate, target)

    def _migrate(self, target: Reactor) -> None:
        # old reactor thread, outside any pump
        sock = self._reg_sock
        if self._reactor is target:
            self._migrating = False
            return
        if sock is None:
            self._reactor = target
            self._migrating = False
            return
        old = self._reactor
        gen = self._reg_gen
        old.unregister(sock)
        self._reactor = target
        # nothing fires this connection's callbacks between the old
        # shard's unregister and the adopt below, so _rbuf/_wq hand
        # over untouched; stale callbacks left on the old reactor
        # re-route via the in_reactor() guard in _pump_writes
        target.call_soon(self._adopt, sock, gen)

    def _adopt(self, sock, gen) -> None:
        # new reactor thread: re-register the live socket
        self._migrating = False
        with self.lock:
            if self.sock is not sock or self.gen != gen \
                    or self.state != "open":
                return              # died/reconnected mid-migration
        self._reg_sock = sock
        self._reg_gen = gen
        self._reactor.register(sock, self._on_readable,
                               self._on_writable)
        if self._wants_write:
            self._reactor.want_write(sock, True)
        if self._read_paused:
            self._reactor.want_read(sock, False)
        self._pump_writes()

    # -- write pump --------------------------------------------------------
    def send_message(self, msg) -> None:
        super().send_message(msg)       # enqueue under the lock
        self._schedule_pump()

    def _schedule_pump(self) -> None:
        """Coalesced flush: the first sender in a tick schedules one
        pump; everyone else just appends to ``out_q``.  Under 64-way
        fan-in the per-reply ``sendmsg`` calls collapse into one
        scatter-gather burst per tick."""
        if self._flush_scheduled:
            return
        self._flush_scheduled = True
        self.reactor.call_soon(self._flush_coalesced)

    def _flush_coalesced(self) -> None:
        self._flush_scheduled = False
        self._pump_writes()

    def _on_writable(self) -> None:
        self._pump_writes()

    def _pump_writes(self) -> None:
        r = self._reactor
        if not r.in_reactor():
            # connection migrated while this callback sat queued on
            # the previous reactor: re-run on the new home so only
            # one thread ever touches _wq and the socket
            r.call_soon(self._pump_writes)
            return
        sock = self._reg_sock
        gen = self._reg_gen
        if sock is None:
            return
        while True:
            # same per-message session mutation as _writer_main: stamp
            # seq once, remember for resend if lossless
            with self.lock:
                if self.gen != gen or self.state != "open":
                    return
                if not self.out_q:
                    break
                msg = self.out_q.popleft()
                if msg.TYPE != MAck.TYPE:
                    if msg.seq == 0:
                        self.out_seq += 1
                        msg.seq = self.out_seq
                    if self.lossless:
                        self.unacked.append(msg)
            # shared msg.send injection point (same registry site and
            # ms_inject_socket_failures absorption as _writer_main)
            if self._inject_send_fault():
                self._io_error(sock, gen)
                return
            # stamped BEFORE encode so it rides the wire
            msg.stamp_hop("wire_sent")
            for part in encode_frame_parts(
                    msg, compressor=self.msgr.compressor,
                    compress_min=self.msgr.compress_min,
                    crc_data=self.msgr.conf["ms_crc_data"]):
                self._wq.append(part if isinstance(part, memoryview)
                                else memoryview(part))
        try:
            wq = self._wq
            while wq:
                n = sock.sendmsg([wq[i] for i in
                                  range(min(len(wq), _IOV_BATCH))])
                while n > 0 and wq:
                    first = len(wq[0])
                    if n >= first:
                        n -= first
                        wq.popleft()
                    else:
                        wq[0] = wq[0][n:]
                        n = 0
        except (BlockingIOError, InterruptedError):
            pass
        except (OSError, ConnectionError):
            self._io_error(sock, gen)
            return
        want = bool(self._wq)
        if want != self._wants_write:
            self._wants_write = want
            self.reactor.want_write(sock, want)

    # -- read pump ---------------------------------------------------------
    def _on_readable(self) -> None:
        sock = self._reg_sock
        gen = self._reg_gen
        if sock is None:
            return
        # admission backpressure: past the shard's op-queue
        # HWM, stop reading — bytes queue in the kernel buffer and
        # then the client's send window, so overload waits at the
        # edge instead of inflating reactor loop-lag.  The OSD's
        # resume tick re-arms read interest once the queue drains.
        gate = getattr(self.msgr, "admission_gate", None)
        if gate is not None and not self._read_paused:
            try:
                overloaded = gate(self)
            except Exception:  # noqa: BLE001 — gating must not kill IO
                overloaded = False
            if overloaded:
                self._read_paused = True
                self._reactor.want_read(sock, False)
                self.msgr.note_paused(self)
                return
        if self._inject_recv_fault():
            self._io_error(sock, gen)
            return
        self._recv_rounds(sock, gen)

    def resume_reads(self) -> None:
        """Re-arm read interest after an admission pause (runs on
        this connection's reactor, marshalled by the messenger)."""
        if not self._read_paused:
            return
        self._read_paused = False
        sock = self._reg_sock
        if sock is not None:
            # level-triggered: bytes that piled up while paused
            # re-fire the selector on the next tick
            self._reactor.want_read(sock, True)

    def _recv_rounds(self, sock, gen) -> None:
        try:
            for _ in range(_RECV_ROUNDS):
                chunk = sock.recv(_RECV_CHUNK)
                if not chunk:
                    self._io_error(sock, gen)
                    return
                self._rbuf += chunk
                if len(chunk) < _RECV_CHUNK:
                    break
        except (BlockingIOError, InterruptedError):
            pass
        except (OSError, ConnectionError):
            self._io_error(sock, gen)
            return
        self._parse_frames(sock, gen)

    def _parse_frames(self, sock, gen) -> None:
        buf = self._rbuf
        while True:
            if len(buf) < HEADER_LEN:
                return
            head = bytes(buf[:HEADER_LEN])  # copycheck: ok - 18-byte header
            try:
                mtype, seq, plen = decode_frame_header(head)
                if plen > MAX_FRAME:
                    raise DecodeError(f"oversized frame {plen}")
            except DecodeError:
                if self.msgr.conf["ms_die_on_bad_msg"]:
                    raise
                self._io_error(sock, gen)
                return
            total = HEADER_LEN + plen + CRC_LEN
            if len(buf) < total:
                return
            # single-copy extraction through a view (a bytearray slice
            # would copy once into a bytearray and again into bytes);
            # the view must be released before the bytearray resizes
            view = memoryview(buf)
            payload = bytes(view[HEADER_LEN:HEADER_LEN + plen])  # copycheck: ok - rx reassembly into immutable frame
            crc = bytes(view[HEADER_LEN + plen:total])  # copycheck: ok - 4-byte trailer crc
            view.release()
            del buf[:total]
            try:
                msg = decode_frame_body(mtype, seq, head, payload, crc)
                msg.stamp_hop("recv")
            except DecodeError:
                if self.msgr.conf["ms_die_on_bad_msg"]:
                    raise
                self._io_error(sock, gen)
                return
            # session accounting identical to _reader_main
            ack = None
            with self.lock:
                if gen != self.gen or self.state != "open":
                    return              # replaced under us
                if msg.TYPE == MAck.TYPE:
                    while self.unacked and \
                            self.unacked[0].seq <= msg.acked_seq:
                        self.unacked.popleft()
                    continue
                if msg.seq <= self.in_seq:
                    continue            # duplicate after reconnect
                self.in_seq = msg.seq
                if self.lossless:
                    self._recv_since_ack += 1
                    self._recv_bytes_since_ack += plen
                    if (self._recv_since_ack >= ACK_EVERY_MSGS or
                            self._recv_bytes_since_ack >=
                            ACK_EVERY_BYTES):
                        ack = MAck(acked_seq=self.in_seq)
                        self._recv_since_ack = 0
                        self._recv_bytes_since_ack = 0
                if ack is not None:
                    self.out_q.append(ack)
            if ack is not None:
                self._schedule_pump()
            msg.connection = self
            # inline dispatch: THE crimson fast path — the op runs on
            # the reactor right out of the frame parser
            self.msgr._dispatch(self, msg)


class CrimsonMessenger(Messenger):
    """``Messenger`` whose connections pump on the OSD's reactors.

    Accept/handshake/reconnect threads are inherited unchanged — they
    are rare, bounded, and blocking by nature; only the steady-state
    per-connection pumps move onto the event loops.  With a shard
    group (``reactors``), new connections are spread round-robin so
    the frame parsing and write pumping load shares across shards;
    each connection stays pinned to its reactor for life."""

    conn_class = CrimsonConnection

    def __init__(self, name: str, nonce: Optional[int] = None,
                 conf=None, reactor: Optional[Reactor] = None,
                 reactors: Optional[List[Reactor]] = None):
        super().__init__(name, nonce=nonce, conf=conf)
        if reactor is None and not reactors:
            raise ValueError("CrimsonMessenger needs a reactor")
        if self.secure_mode:
            raise ValueError(
                "osd_backend=crimson does not support ms_secure_mode: "
                "the AES-GCM record layer reads whole records with "
                "blocking recv and cannot drive a non-blocking pump")
        self.reactors: List[Reactor] = (
            list(reactors) if reactors else [reactor])
        self.reactor = self.reactors[0]
        self._rr = 0
        # admission backpressure: the OSD installs a gate
        # callable; connections it judges overloaded pause their read
        # pump and park here until the owning shard drains
        self.admission_gate = None
        self._paused_lock = threading.Lock()
        self._paused: set = set()

    def note_paused(self, conn) -> None:
        with self._paused_lock:
            self._paused.add(conn)

    def forget_paused(self, conn) -> None:
        with self._paused_lock:
            self._paused.discard(conn)

    def resume_paused(self, reactor: Optional[Reactor] = None) -> None:
        """Re-admit paused connections (all, or only those pinned to
        ``reactor``); callable from any thread."""
        with self._paused_lock:
            if not self._paused:
                return
            conns = [c for c in self._paused
                     if reactor is None or c._reactor is reactor]
            for c in conns:
                self._paused.discard(c)
        for c in conns:
            c._reactor.call_soon(c.resume_reads)

    def pick_reactor(self) -> Reactor:
        """Round-robin shard assignment for a new connection.  The
        counter bump is GIL-atomic enough — a rare double-assignment
        only skews the balance by one connection."""
        r = self.reactors[self._rr % len(self.reactors)]
        self._rr += 1
        return r

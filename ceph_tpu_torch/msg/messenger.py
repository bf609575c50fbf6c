"""Async TCP messenger.

Python-native equivalent of the reference's messenger layer (reference
src/msg/Messenger.h, msg/async/AsyncMessenger.cc): entity-named
endpoints exchanging typed messages over persistent connections, with

* dispatcher fan-out (reference Dispatcher.h): ms_dispatch /
  ms_handle_connect / ms_handle_reset;
* lossless peer policy (reference Policy.h): the connecting side
  reconnects with backoff, unacknowledged messages are resent, and
  receivers drop duplicates by message seq — the reconnect/replace
  semantics of ProtocolV2 (reference msg/async/ProtocolV2.cc) reduced
  to a seq-exchange handshake;
* lossy policy for clients: a dead connection just resets, the Objecter
  layer resends ops itself (reference Objecter resend-on-reset);
* CRC framing per message (msg/message.py);
* socket fault injection via config ``ms_inject_socket_failures``
  (reference common/options.cc:1075), the hook the thrash tests use.

Threads: one acceptor per bound messenger, one reader + one writer per
connection.  The reference multiplexes epoll event loops
(msg/async/AsyncMessenger.cc) with O(cores) worker threads; this
messenger is deliberately thread-per-connection, with the measured
justification: a 12-OSD in-process cluster runs 473 threads
total, 304 of them connection reader/writer pairs — ~8 KiB of kernel
stack each (~4 MiB), all blocked in recv() where they cost no
scheduler time, and CPython's GIL serializes protocol work regardless
of the IO model, so a selector rewrite changes memory shape, not
throughput, at this scale.  The full thrash/cluster suite (incl. the
13-daemon north-star test) passes at these counts.  The selector
rewrite exists as crimson/net.py: the crimson OSD
(osd_backend=crimson) subclasses Connection/Messenger via the
``conn_class`` hook below and drives the same session rules from a
reactor with non-blocking pumps, no reader/writer threads.
"""
from __future__ import annotations

import random
import socket
import struct
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from ..utils import copytrack
from ..utils import faults as faultlib
from ..utils.config import Config, default_config
from ..utils.encoding import DecodeError
from .message import (CRC_LEN, HEADER_LEN, Message, decode_frame_body,
                      decode_frame_header, encode_frame_parts)
from .messages import MAck

# ack cadence: trim the peer's resend queue at least this often
ACK_EVERY_MSGS = 32
ACK_EVERY_BYTES = 1 << 20

BANNER_MAGIC = 0x43455032  # "CEP2"
_BANNER = struct.Struct("<IQQB")  # magic, nonce, in_seq, lossless flag

MAX_FRAME = 256 << 20


class Dispatcher:
    """Receiver interface (reference msg/Dispatcher.h)."""

    def ms_dispatch(self, conn: "Connection", msg: Message) -> bool:
        """Return True if the message was handled."""
        return False

    def ms_handle_connect(self, conn: "Connection") -> None:
        pass

    def ms_handle_reset(self, conn: "Connection") -> None:
        """A lossy connection died, or a lossless one gave up."""


def _read_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly n bytes into one preallocated buffer (recv_into —
    no per-chunk concatenation); the final bytes() is the single
    receive-side reassembly copy."""
    if n == 0:
        return b""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:])
        if not r:
            raise ConnectionError("peer closed")
        got += r
    return bytes(buf)  # copycheck: ok - rx reassembly into immutable frame


_IOV_BATCH = 64     # iovecs per sendmsg call (well under Linux IOV_MAX)


def _sendmsg_all(sock, parts) -> None:
    """sendall for an iovec list: scatter-gather ``sendmsg`` with
    partial-send advance, so header+payload+crc leave the process
    without ever being joined.  _SecureSocket provides its own
    ``sendmsg`` that encrypts the gather as one segment."""
    bufs = [p if isinstance(p, memoryview) else memoryview(p)
            for p in parts]
    while bufs:
        n = sock.sendmsg(bufs[:_IOV_BATCH])
        while n > 0 and bufs:
            first = len(bufs[0])
            if n >= first:
                n -= first
                bufs.pop(0)
            else:
                bufs[0] = bufs[0][n:]
                n = 0


def _send_banner(sock: socket.socket, name: str, nonce: int,
                 in_seq: int, lossless: bool) -> None:
    nb = name.encode()
    sock.sendall(_BANNER.pack(BANNER_MAGIC, nonce, in_seq,
                              1 if lossless else 0) +
                 struct.pack("<H", len(nb)) + nb)


def _recv_banner(sock: socket.socket) -> Tuple[str, int, int, bool]:
    magic, nonce, in_seq, lossless = _BANNER.unpack(
        _read_exact(sock, _BANNER.size))
    if magic != BANNER_MAGIC:
        raise ConnectionError(f"bad banner magic {magic:#x}")
    (nlen,) = struct.unpack("<H", _read_exact(sock, 2))
    name = _read_exact(sock, nlen).decode()
    return name, nonce, in_seq, bool(lossless)


class _SecureSocket:
    """AES-GCM transport wrapper (reference ProtocolV2 secure mode,
    msg/async/ProtocolV2.cc): every ``sendall`` becomes one
    ``[u32 len][ciphertext+16B tag]`` segment under a per-direction
    counter nonce; ``recv`` serves decrypted plaintext.  Tampering or
    truncation surfaces as ConnectionError (GCM tag failure), which
    kills the socket exactly like a CRC-corrupt stream."""

    def __init__(self, sock: socket.socket, key: bytes,
                 send_prefix: bytes, recv_prefix: bytes):
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM
        self._sock = sock
        self._aes = AESGCM(key)
        self._send_prefix = send_prefix      # 4 bytes, per direction
        self._recv_prefix = recv_prefix
        self._send_ctr = 0
        self._recv_ctr = 0
        self._rbuf = b""
        self._send_lock = threading.Lock()

    def sendall(self, data) -> None:
        self.sendmsg([data])

    def sendmsg(self, parts) -> int:
        """Encrypt the gathered parts as ONE segment and emit
        [lenhdr][ct] as two iovecs — the old ``lenhdr + ct``
        concatenation copied every ciphertext frame."""
        with self._send_lock:
            nonce = self._send_prefix + \
                self._send_ctr.to_bytes(8, "little")
            self._send_ctr += 1
            if len(parts) == 1:
                pt = parts[0]
            else:
                pt = b"".join(parts)  # copycheck: ok - AEAD needs one contiguous plaintext
                copytrack.note_copy(len(pt), "secure.plaintext_join")
            if not isinstance(pt, bytes):
                # AESGCM wants an immutable buffer; this is the
                # encryption materialisation, inherent to secure mode
                pt = bytes(pt)  # copycheck: ok - AEAD input materialisation
            ct = self._aes.encrypt(nonce, pt, None)
            _sendmsg_all(self._sock,
                         [struct.pack("<I", len(ct)), ct])
            return len(pt)

    def recv_into(self, view) -> int:
        """Serve decrypted plaintext into the caller's buffer (must be
        explicit: __getattr__ would leak recv_into to the raw socket
        and bypass decryption)."""
        data = self.recv(len(view))
        view[:len(data)] = data
        return len(data)

    def recv(self, n: int) -> bytes:
        if not self._rbuf:
            (ln,) = struct.unpack("<I", _read_exact(self._sock, 4))
            if ln > MAX_FRAME + (1 << 16):
                raise ConnectionError(f"oversized secure segment {ln}")
            ct = _read_exact(self._sock, ln)
            nonce = self._recv_prefix + \
                self._recv_ctr.to_bytes(8, "little")
            self._recv_ctr += 1
            try:
                self._rbuf = self._aes.decrypt(nonce, ct, None)
            except Exception as e:
                raise ConnectionError(
                    f"secure frame authentication failed: {e!r}")
        out, self._rbuf = self._rbuf[:n], self._rbuf[n:]
        return out

    def __getattr__(self, name):
        return getattr(self._sock, name)


def _secure_negotiate(sock: socket.socket, key: bytes,
                      c_chal: bytes, a_chal: bytes,
                      acceptor: bool, want_secure: bool):
    """Post-auth crypto negotiation (reference ProtocolV2 con-mode
    negotiation): both sides state their mode; a mismatch is a clear
    error rather than a garbled stream.  In secure mode the session
    key derives from the auth secret and BOTH handshake challenges,
    so every connection gets a fresh key without extra round trips."""
    import hmac as _hmac
    sock.sendall(b"\x01" if want_secure else b"\x00")
    peer_secure = _read_exact(sock, 1) == b"\x01"
    if peer_secure != want_secure:
        verb = "requires" if peer_secure else "refuses"
        raise ConnectionError(
            f"ms_secure_mode mismatch: peer {verb} encryption")
    if not want_secure:
        return sock
    session_key = _hmac.new(key, b"secure-session" + c_chal + a_chal,
                            "sha256").digest()
    my_prefix, peer_prefix = (b"ACPT", b"CNCT") if acceptor \
        else (b"CNCT", b"ACPT")
    return _SecureSocket(sock, session_key, my_prefix, peer_prefix)


def _auth_exchange(sock: socket.socket, key: bytes,
                   acceptor: bool) -> Tuple[bytes, bytes]:
    """Mutual shared-secret proof (reference cephx's
    challenge/authenticator flow, collapsed to one round).  Each proof
    is HMAC-SHA256(key, role_tag || connector_challenge ||
    acceptor_challenge): covering BOTH challenges with a per-role tag
    defeats reflection — a digest harvested from a second session
    toward the same daemon carries the wrong role tag and the wrong
    challenge pair.  Both sides send-first, so no deadlock.  Raises
    ConnectionError on mismatch; runs BEFORE any session state is
    touched so an unauthenticated dial cannot disturb live sessions."""
    import hmac as _hmac
    import os as _os
    my_chal = _os.urandom(16)
    sock.sendall(my_chal)
    peer_chal = _read_exact(sock, 16)
    c_chal, a_chal = (peer_chal, my_chal) if acceptor \
        else (my_chal, peer_chal)
    my_tag = b"S" if acceptor else b"C"
    peer_tag = b"C" if acceptor else b"S"
    sock.sendall(_hmac.new(key, my_tag + c_chal + a_chal,
                           "sha256").digest())
    proof = _read_exact(sock, 32)
    want = _hmac.new(key, peer_tag + c_chal + a_chal,
                     "sha256").digest()
    if not _hmac.compare_digest(proof, want):
        raise ConnectionError("cephx: bad authenticator")
    return c_chal, a_chal


def _shutdown_close(sock: Optional[socket.socket]) -> None:
    """shutdown() then close(): shutdown wakes any thread blocked in
    recv/send on the socket (close alone does not on Linux)."""
    if sock is None:
        return
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class Connection:
    """One logical session with a peer (reference msg/Connection.h).
    Survives socket deaths when lossless: the session (seq counters,
    unacked messages) lives here; sockets come and go.

    One persistent reader and one persistent writer thread pump
    whichever socket generation is current — sockets are replaced on
    reconnect, threads are not (the reference's event-loop workers are
    likewise long-lived while connections churn)."""

    def __init__(self, msgr: "Messenger", peer_addr: Tuple[str, int],
                 lossless: bool, connector: bool):
        self.msgr = msgr
        self.peer_addr = peer_addr
        self.peer_name = ""            # known after handshake
        self.lossless = lossless
        self.connector = connector     # we dial; else we accepted
        self.lock = threading.RLock()
        self.send_cond = threading.Condition(self.lock)
        self.out_q: deque = deque()    # Messages to send
        self.unacked: deque = deque()  # sent, possibly undelivered
        self.out_seq = 0
        self.in_seq = 0
        self.sock: Optional[socket.socket] = None
        self.state = "connecting"      # connecting|open|closed
        # socket generation: every attach bumps it; pump loops carry
        # their generation so a stale pump can never mutate the session
        # after a replace (reference ProtocolV2 connection race handling)
        self.gen = 0
        self._reconnecting = False     # at most one reconnect thread
        self._pumps_started = False
        self.peer_nonce: Optional[int] = None
        self.intended_peer = ""        # who connect_to() meant to reach
        self._recv_since_ack = 0
        self._recv_bytes_since_ack = 0

    # -- public API --------------------------------------------------------
    def send_message(self, msg: Message) -> None:
        msg.stamp_hop("msgr_enqueue")
        with self.lock:
            if self.state == "closed":
                return                 # dropped, like the reference's
                                       # sends on a closed lossy conn
            self.out_q.append(msg)
            depth = len(self.out_q)
            self.send_cond.notify_all()
        st = getattr(self.msgr, "contention", None)
        if st is not None:
            st.note_queue_depth("msgr_sendq", depth)

    def mark_down(self) -> None:
        """Tear down now; no reset callback (reference mark_down)."""
        self._close(reset=False)

    def is_connected(self) -> bool:
        with self.lock:
            return self.state == "open"

    def __repr__(self) -> str:
        return (f"<Connection to {self.peer_name or self.peer_addr} "
                f"{self.state}>")

    # -- internals ---------------------------------------------------------
    def _attach(self, sock: socket.socket, peer_name: str,
                peer_nonce: int, peer_in_seq: int) -> None:
        """Socket ready (post-handshake): replace any live socket, trim
        acked, requeue unacked, wake the pumps."""
        with self.lock:
            if self.state == "closed":
                _shutdown_close(sock)
                return
            old, self.sock = self.sock, None
            self.peer_name = peer_name
            if self.peer_nonce is not None \
                    and self.peer_nonce != peer_nonce:
                # peer restarted (reincarnation, detected by nonce as
                # the reference does): its seqs restart at 1, so our
                # dedup floor must reset or we'd drop everything
                self.in_seq = 0
            self.peer_nonce = peer_nonce
            # drop messages the peer already received
            while self.unacked and self.unacked[0].seq <= peer_in_seq:
                self.unacked.popleft()
            # resend the rest ahead of new traffic
            for msg in reversed(self.unacked):
                self.out_q.appendleft(msg)
            self.unacked.clear()
            self.sock = sock
            self.state = "open"
            self.gen += 1
            if not self._pumps_started:
                self._pumps_started = True
                threading.Thread(target=self._writer_main,
                                 name=f"msgr-w-{peer_name}",
                                 daemon=True).start()
                threading.Thread(target=self._reader_main,
                                 name=f"msgr-r-{peer_name}",
                                 daemon=True).start()
            self.send_cond.notify_all()
        _shutdown_close(old)
        for d in self.msgr.dispatchers:
            d.ms_handle_connect(self)

    def _socket_dead(self, sock: socket.socket, gen: int) -> None:
        _shutdown_close(sock)
        with self.lock:
            if gen != self.gen or self.state != "open":
                return                 # stale generation or already
                                       # handled by the other pump
            self.sock = None
            if self.lossless and self.connector:
                self.state = "connecting"
                self._spawn_reconnect_locked()
                return
            if self.lossless:
                # acceptor keeps session state and waits for the peer
                # to redial (reference replace semantics)
                self.state = "connecting"
                return
        self._close(reset=True)

    def _spawn_reconnect_locked(self) -> None:
        """Start the (single) reconnect thread; caller holds the lock."""
        if self._reconnecting:
            return
        self._reconnecting = True
        threading.Thread(target=self.msgr._reconnect, args=(self,),
                         daemon=True).start()

    def _close(self, reset: bool) -> None:
        with self.lock:
            if self.state == "closed":
                return
            self.state = "closed"
            sock, self.sock = self.sock, None
            self.send_cond.notify_all()
        _shutdown_close(sock)
        self.msgr._conn_closed(self)
        if reset:
            for d in self.msgr.dispatchers:
                d.ms_handle_reset(self)

    def _inject_send_fault(self) -> bool:
        """Shared ``msg.send`` injection point — classic and crimson
        writers consult this before every frame write.  The legacy
        ``ms_inject_socket_failures`` conf (one in N sends fails) is
        absorbed by the registry site: its trips are counted there
        and, under a seeded registry, deterministic.  True = kill the
        socket (the lossless session reconnects and resends)."""
        return faultlib.registry().check_send(
            faultlib.MSG_SEND,
            self.msgr.conf["ms_inject_socket_failures"])

    def _inject_recv_fault(self) -> bool:
        """Registry ``msg.recv`` injection point (no legacy conf)."""
        return faultlib.registry().check_drop(faultlib.MSG_RECV)

    # -- pumps -------------------------------------------------------------
    def _current_socket(self):
        """Block until there's an open socket (or the session closes);
        -> (sock, gen) or (None, 0)."""
        with self.lock:
            while self.state == "connecting" or \
                    (self.state == "open" and self.sock is None):
                self.send_cond.wait()
            if self.state == "closed":
                return None, 0
            return self.sock, self.gen

    def _writer_main(self) -> None:
        while True:
            sock, gen = self._current_socket()
            if sock is None:
                return
            while True:
                with self.lock:
                    while (not self.out_q and gen == self.gen
                           and self.state == "open"):
                        self.send_cond.wait()
                    if gen != self.gen or self.state != "open":
                        break          # pick up the next generation
                    msg = self.out_q.popleft()
                    if msg.TYPE != MAck.TYPE:
                        if msg.seq == 0:
                            self.out_seq += 1
                            msg.seq = self.out_seq
                        if self.lossless:
                            self.unacked.append(msg)
                try:
                    if self._inject_send_fault():
                        raise ConnectionError("injected socket failure")
                    # stamped BEFORE encode so it rides the wire
                    msg.stamp_hop("wire_sent")
                    _sendmsg_all(sock, encode_frame_parts(
                        msg, compressor=self.msgr.compressor,
                        compress_min=self.msgr.compress_min,
                        crc_data=self.msgr.conf["ms_crc_data"]))
                except (OSError, ConnectionError):
                    self._socket_dead(sock, gen)
                    break

    def _reader_main(self) -> None:
        while True:
            sock, gen = self._current_socket()
            if sock is None:
                return
            while True:
                try:
                    if self._inject_recv_fault():
                        raise ConnectionError("injected recv fault")
                    head = _read_exact(sock, HEADER_LEN)
                    mtype, seq, plen = decode_frame_header(head)
                    if plen > MAX_FRAME:
                        raise DecodeError(f"oversized frame {plen}")
                    payload = _read_exact(sock, plen)
                    crc = _read_exact(sock, CRC_LEN)
                    msg = decode_frame_body(mtype, seq, head, payload,
                                            crc)
                    msg.stamp_hop("recv")
                except (OSError, ConnectionError, DecodeError) as e:
                    if isinstance(e, DecodeError) and \
                            self.msgr.conf["ms_die_on_bad_msg"]:
                        # reference ms_die_on_bad_msg: fail loudly in
                        # debugging runs instead of resetting quietly
                        raise
                    # dead or corrupt stream: kill the socket; a
                    # lossless session reconnects and resends
                    self._socket_dead(sock, gen)
                    break
                with self.lock:
                    if gen != self.gen or self.state != "open":
                        break          # replaced under us: stop
                                       # dispatching from a stale socket
                    if msg.TYPE == MAck.TYPE:
                        # transport control: trim the resend queue
                        while self.unacked and \
                                self.unacked[0].seq <= msg.acked_seq:
                            self.unacked.popleft()
                        continue
                    if msg.seq <= self.in_seq:
                        continue       # duplicate after reconnect
                    self.in_seq = msg.seq
                    ack = None
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
                        self.send_cond.notify_all()
                msg.connection = self
                self.msgr._dispatch(self, msg)


class Messenger:
    """Entity-named endpoint (reference Messenger::create).  ``name``
    is "type.id" — osd.3, mon.0, client.17."""

    # connection factory: subclasses substitute their own Connection
    # (the crimson messenger swaps in a reactor-driven, non-blocking
    # connection while reusing every session/handshake rule here)
    conn_class = Connection

    def __init__(self, name: str, nonce: Optional[int] = None,
                 conf: Optional[Config] = None):
        self.name = name
        self.nonce = nonce if nonce is not None \
            else random.getrandbits(64)
        self.conf = conf or default_config()
        self.dispatchers: List[Dispatcher] = []
        self.lock = threading.RLock()
        self.listen_sock: Optional[socket.socket] = None
        self.my_addr: Optional[Tuple[str, int]] = None
        self.conns_by_name: Dict[str, Connection] = {}
        self.conns: List[Connection] = []
        self._accept_thread: Optional[threading.Thread] = None
        self._stopping = False
        # frame compression (reference msgr2 compression; conf
        # ms_compress_mode names a registry codec, "" = off)
        self.compressor = None
        self.compress_min = self.conf["ms_compress_min_size"]
        mode = self.conf["ms_compress_mode"]
        if mode:
            # wire frames must decode on ANY peer: only the stdlib
            # codecs are allowed on the wire (an optional codec the
            # receiver lacks would read as a corrupt stream and
            # kill/reconnect the session forever)
            if mode not in ("zlib", "bz2", "lzma"):
                raise ValueError(
                    f"ms_compress_mode {mode!r}: wire compression "
                    f"supports zlib/bz2/lzma only")
            from ..compressor import registry as _creg
            self.compressor = _creg().create(mode, conf=self.conf)
        # cluster auth (reference auth_cluster_required=cephx): a
        # shared-secret mutual challenge-response at session accept
        self.auth_required = "cephx" in (
            self.conf["auth_cluster_required"],
            self.conf["auth_service_required"],
            self.conf["auth_client_required"])
        self.auth_key = self.conf["auth_key"].encode()
        if self.auth_required and not self.auth_key:
            raise ValueError(
                "auth_cluster_required=cephx needs a non-empty "
                "auth_key (an empty HMAC secret protects nothing)")
        # wire encryption (reference msgr2 secure mode): needs the
        # cephx secret for session-key derivation
        self.secure_mode = bool(self.conf["ms_secure_mode"])
        if self.secure_mode and not self.auth_required:
            raise ValueError(
                "ms_secure_mode needs auth_cluster_required=cephx "
                "(the session key derives from the auth secret)")
        if self.secure_mode:
            try:
                from cryptography.hazmat.primitives.ciphers.aead \
                    import AESGCM                      # noqa: F401
            except ImportError as e:
                raise ValueError(
                    "ms_secure_mode needs the 'cryptography' "
                    "package for AES-GCM") from e

    # -- lifecycle ---------------------------------------------------------
    def bind(self, addr: Tuple[str, int] = ("127.0.0.1", 0)
             ) -> Tuple[str, int]:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if self.conf["ms_tcp_nodelay"]:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if addr[1] == 0 and self.conf["ms_bind_port_range_enabled"]:
            # reference ms_bind_port_min/max: daemons bind inside the
            # advertised range instead of an ephemeral port
            lo = self.conf["ms_bind_port_min"]
            hi = self.conf["ms_bind_port_max"]
            for port in range(lo, hi + 1):
                try:
                    sock.bind((addr[0], port))
                    break
                except OSError:
                    continue
            else:
                raise OSError(f"no free port in [{lo}, {hi}]")
        else:
            sock.bind(addr)
        sock.listen(self.conf["ms_tcp_listen_backlog"])
        self.listen_sock = sock
        self.my_addr = sock.getsockname()
        return self.my_addr

    def start(self) -> None:
        if self.listen_sock is not None:
            self._accept_thread = threading.Thread(
                target=self._accept_loop, name=f"msgr-accept-{self.name}",
                daemon=True)
            self._accept_thread.start()

    def shutdown(self) -> None:
        with self.lock:
            self._stopping = True
            conns = list(self.conns)
        if self.listen_sock:
            # shutdown() wakes the acceptor blocked in accept(); bare
            # close() would leak that thread
            _shutdown_close(self.listen_sock)
        for conn in conns:
            conn.mark_down()

    def add_dispatcher(self, d: Dispatcher) -> None:
        self.dispatchers.append(d)

    def is_stopping(self) -> bool:
        with self.lock:
            return self._stopping

    # -- connect side ------------------------------------------------------
    def connect_to(self, addr: Tuple[str, int],
                   lossless: bool = True,
                   peer_name: str = "") -> Connection:
        """Get (or create) the connection to the peer at ``addr``.

        ``peer_name`` (when the caller knows who lives there, e.g.
        "osd.3" / "mon.1") makes the session full-duplex: an already-
        accepted connection FROM that peer is reused instead of
        dialing a second, competing session — the accepted conn's
        peer_addr is an ephemeral port, so the addr scan alone can
        never find it (reference msgr keeps one session per entity)."""
        addr = (addr[0], int(addr[1]))
        stale = None
        with self.lock:
            if peer_name:
                conn = self.conns_by_name.get(peer_name)
                if conn is not None and conn.state != "closed":
                    if conn.connector and \
                            tuple(conn.peer_addr) != addr:
                        # the peer moved (restart rebound its port):
                        # this session redials a dead address forever —
                        # replace it with a dial to the current addr.
                        # Unregister NOW, inside the lock: a racing
                        # connect_to must not also find it and spawn a
                        # second competing replacement
                        stale = conn
                        del self.conns_by_name[peer_name]
                    else:
                        return conn
            if stale is None:
                for conn in self.conns:
                    if conn.peer_addr == addr and \
                            conn.state != "closed":
                        return conn
            conn = self.conn_class(self, addr, lossless,
                                   connector=True)
            conn.intended_peer = peer_name
            self.conns.append(conn)
        if stale is not None:
            stale.mark_down()
        with conn.lock:
            conn._spawn_reconnect_locked()
        return conn

    def _reconnect(self, conn: Connection) -> None:
        retry = self.conf["ms_connection_retry_interval"]
        max_backoff = self.conf["ms_max_backoff"]
        try:
            while True:
                with self.lock:
                    if self._stopping:
                        return
                with conn.lock:
                    if conn.state != "connecting":
                        return
                    in_seq = conn.in_seq
                try:
                    sock = socket.create_connection(conn.peer_addr,
                                                    timeout=5.0)
                    sock.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                    rcvbuf = self.conf["ms_tcp_rcvbuf"]
                    if rcvbuf:
                        sock.setsockopt(socket.SOL_SOCKET,
                                        socket.SO_RCVBUF, rcvbuf)
                    _send_banner(sock, self.name, self.nonce, in_seq,
                                 conn.lossless)
                    if self.auth_required:
                        c_chal, a_chal = _auth_exchange(
                            sock, self.auth_key, acceptor=False)
                        sock = _secure_negotiate(
                            sock, self.auth_key, c_chal, a_chal,
                            acceptor=False,
                            want_secure=self.secure_mode)
                    peer_name, peer_nonce, peer_in_seq, _ = \
                        _recv_banner(sock)
                    sock.settimeout(None)
                except (OSError, ConnectionError):
                    if not conn.lossless:
                        conn._close(reset=True)
                        return
                    # if this dial lost a connection race (the peer's
                    # acceptor rejects us because ITS dial won), an
                    # accepted session to the same peer exists: hand
                    # our queued messages to it and retire this conn
                    # instead of redialing forever
                    if conn.intended_peer:
                        with self.lock:
                            winner = self.conns_by_name.get(
                                conn.intended_peer)
                        if winner is not None and winner is not conn \
                                and winner.state == "open":
                            with conn.lock:
                                pending = list(conn.unacked) + \
                                    [m for m in conn.out_q
                                     if m.TYPE != MAck.TYPE]
                                conn.unacked.clear()
                                conn.out_q.clear()
                            conn.mark_down()
                            for m in pending:
                                m.seq = 0
                                winner.send_message(m)
                            return
                    time.sleep(retry)
                    # exponential backoff to ms_max_backoff (reference
                    # ms_initial_backoff/ms_max_backoff): a dead peer
                    # must not eat CPU in a tight redial loop
                    retry = min(retry * 2, max_backoff)
                    continue
                with self.lock:
                    self.conns_by_name[peer_name] = conn
                conn._attach(sock, peer_name, peer_nonce, peer_in_seq)
                return
        finally:
            stopping = self.is_stopping()   # msgr lock, before conn lock
            with conn.lock:
                conn._reconnecting = False
                # a socket may have died while we were attaching; if the
                # session needs another dial, restart
                if conn.state == "connecting" and conn.connector \
                        and conn.lossless and not stopping:
                    conn._spawn_reconnect_locked()

    # -- accept side -------------------------------------------------------
    def _accept_loop(self) -> None:
        while True:
            try:
                sock, _ = self.listen_sock.accept()
                if self.conf["ms_tcp_nodelay"]:
                    sock.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                rcvbuf = self.conf["ms_tcp_rcvbuf"]
                if rcvbuf:
                    sock.setsockopt(socket.SOL_SOCKET,
                                    socket.SO_RCVBUF, rcvbuf)
            except OSError:
                return                 # shut down
            threading.Thread(target=self._handle_accept, args=(sock,),
                             daemon=True).start()

    def _handle_accept(self, sock: socket.socket) -> None:
        try:
            sock.settimeout(5.0)
            peer_name, peer_nonce, peer_in_seq, peer_lossless = \
                _recv_banner(sock)
            if self.auth_required:
                # BEFORE touching session state: an unauthenticated
                # dial must not be able to retire/replace live
                # sessions just by naming them in its banner
                c_chal, a_chal = _auth_exchange(sock, self.auth_key,
                                                acceptor=True)
                sock = _secure_negotiate(
                    sock, self.auth_key, c_chal, a_chal,
                    acceptor=True, want_secure=self.secure_mode)
            stale = None
            with self.lock:
                if not peer_lossless:
                    # lossy dialer: every dial is a fresh session (no
                    # retained seq state, not registered by name) —
                    # reusing a lossless session here would dedup-drop
                    # the new dial's restarted seqs
                    conn = self.conn_class(self, sock.getpeername(),
                                           lossless=False,
                                           connector=False)
                    self.conns.append(conn)
                    in_seq = 0
                else:
                    conn = self.conns_by_name.get(peer_name)
                    if conn is not None and conn.peer_nonce is not None \
                            and conn.peer_nonce != peer_nonce:
                        # same name, different nonce: a NEW incarnation
                        # of the peer (restarted process).  Reusing the
                        # old session would replay its unacked queue —
                        # stale replies delivered to a fresh peer — and
                        # dedup-drop the new session's restarted seqs.
                        # Retire it (reference ProtocolV2 treats
                        # (addr, nonce) as the session identity).
                        stale = conn
                        conn = None
                    elif conn is not None and conn.connector and \
                            self.name < peer_name:
                        # CONNECTION RACE: we dialed them while they
                        # dialed us.  Without a deterministic winner
                        # each attach keeps killing the other side's
                        # socket in a loop.  Rule: the dial FROM the
                        # lexicographically smaller name wins
                        # (reference ProtocolV2 reuses existing vs
                        # replace by address comparison) — ours does:
                        # reject their dial; they adopt ours when our
                        # banner lands on their acceptor.
                        _shutdown_close(sock)
                        return
                    if conn is None or conn.state == "closed" \
                            or not conn.lossless:
                        conn = self.conn_class(self, sock.getpeername(),
                                               lossless=True,
                                               connector=False)
                        self.conns.append(conn)
                        self.conns_by_name[peer_name] = conn
                    in_seq = conn.in_seq
            if peer_lossless and stale is not None:
                # outside the messenger lock: _close takes conn.lock
                # and re-enters the messenger via _conn_closed
                stale._close(reset=True)
            _send_banner(sock, self.name, self.nonce, in_seq,
                         peer_lossless)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(None)
        except (OSError, ConnectionError, UnicodeDecodeError):
            try:
                sock.close()
            except OSError:
                pass
            return
        # _attach replaces (and closes) any old socket on the session
        # (reference ProtocolV2 "replace" on reconnect)
        conn._attach(sock, peer_name, peer_nonce, peer_in_seq)

    # -- plumbing ----------------------------------------------------------
    def _dispatch(self, conn: Connection, msg: Message) -> None:
        for d in self.dispatchers:
            try:
                if d.ms_dispatch(conn, msg):
                    return
            except Exception:
                import traceback
                traceback.print_exc()
                return

    def _conn_closed(self, conn: Connection) -> None:
        with self.lock:
            if conn in self.conns:
                self.conns.remove(conn)
            if self.conns_by_name.get(conn.peer_name) is conn:
                del self.conns_by_name[conn.peer_name]

"""MonClient — every daemon's and client's line to the monitor.

Python-native equivalent of the reference's MonClient (reference
src/mon/MonClient.{h,cc}): maintains the session to the monitor,
subscribes to map streams (reference MMonSubscribe / sub_want), runs
synchronous CLI-style commands (reference MonCommand + tid matching),
and carries the OSD-side control traffic — boot, failure reports, PG
stats (reference OSD::_send_boot, send_failures, MPGStats).

Map delivery: incoming MOSDMap frames invoke ``map_cb`` outside the
client lock; consumers (OSD daemon, Objecter) re-enter their own
locking from there.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Tuple

from ..msg.messages import (MMonCommand, MMonCommandAck, MMonSubscribe,
                            MOSDBoot, MOSDFailure, MOSDMap, MPGStats)
from ..msg.messenger import Connection, Dispatcher, Messenger
from ..utils.log import Dout


class CommandTimeout(Exception):
    pass


class MonClient(Dispatcher):
    """One session to the monitor (reference mon/MonClient.h).  The
    hosting entity passes its own messenger; the monclient owns only
    the mon connection."""

    def __init__(self, msgr: Messenger, mon_addr,
                 map_cb: Optional[Callable[[dict], None]] = None):
        """``mon_addr``: one (host, port) or a list of them (the
        monmap).  With several, the client hunts: failed sessions
        rotate to the next mon (reference MonClient::_reopen_session
        hunting)."""
        self.msgr = msgr
        if mon_addr and isinstance(mon_addr[0], (tuple, list)):
            self.mon_addrs = [tuple(a) for a in mon_addr]
        else:
            self.mon_addrs = [tuple(mon_addr)]
        self._addr_idx = 0
        self.map_cb = map_cb
        self.log = Dout("mon", f"monc({msgr.name}) ")
        self.lock = threading.RLock()
        self.conn: Optional[Connection] = None
        self._next_tid = 0
        self._cmd_events: Dict[int, threading.Event] = {}
        self._cmd_acks: Dict[int, MMonCommandAck] = {}
        self._latest_epoch = 0
        self._sub_epoch: Optional[int] = None
        msgr.add_dispatcher(self)

    @property
    def mon_addr(self) -> Tuple[str, int]:
        return self.mon_addrs[self._addr_idx % len(self.mon_addrs)]

    # ------------------------------------------------------------------
    def connect(self) -> None:
        # lossy, like the reference's client->mon policy: a dead mon
        # resets the session immediately so hunting can move on,
        # instead of a lossless reconnect loop pinning us to a corpse
        with self.lock:
            # "closed", not "not open": a conn mid-handshake is the
            # same session, and treating it as dead would re-send the
            # subscription below on every call until the handshake
            # lands — each one costing the mon a full-map publish
            rebuilt = self.conn is None or self.conn.state == "closed"
            if rebuilt:
                self.conn = self.msgr.connect_to(self.mon_addr,
                                                 lossless=False)
            conn, sub = self.conn, self._sub_epoch
        if rebuilt and sub is not None:
            # a rebuilt session has no server-side state: renew the
            # map subscription (reference MonClient resubscribes on
            # session open), or a daemon whose mon link died
            # transiently — e.g. an injected socket fault — silently
            # stops receiving maps and reports PG stats at a stale
            # epoch forever
            conn.send_message(
                MMonSubscribe(what={"osdmap": self._latest_epoch + 1}))

    def _mon_conn(self) -> Connection:
        self.connect()
        return self.conn

    def _retarget(self, addr: Tuple[str, int]) -> None:
        """Point the session at a specific mon (leader redirect or
        hunting)."""
        with self.lock:
            addr = (addr[0], int(addr[1]))
            if addr not in self.mon_addrs:
                self.mon_addrs.append(addr)
            self._addr_idx = self.mon_addrs.index(addr)
            old, self.conn = self.conn, None
        if old is not None:
            old.mark_down()
        self.connect()
        with self.lock:
            sub = self._sub_epoch
        if sub is not None:
            self.subscribe_osdmap(self._latest_epoch + 1)

    def ms_handle_reset(self, conn: Connection) -> None:
        """Session died (mon crashed): hunt to the next mon and renew
        subscriptions (reference MonClient hunting)."""
        with self.lock:
            if conn is not self.conn or len(self.mon_addrs) == 1:
                return
            self._addr_idx = (self._addr_idx + 1) % len(self.mon_addrs)
            self.conn = None
            sub = self._sub_epoch
        self.log.dout(1, f"mon session reset, hunting to "
                      f"{self.mon_addr}")
        # pace the hunt: with every mon down, back-to-back ECONNREFUSED
        # resets would otherwise spin through the monmap at full speed
        time.sleep(0.2)
        if self.msgr.is_stopping():
            return
        try:
            self.connect()
            if sub is not None:
                self.subscribe_osdmap(self._latest_epoch + 1)
        except Exception:
            pass

    def ms_dispatch(self, conn: Connection, msg) -> bool:
        if isinstance(msg, MMonCommandAck):
            with self.lock:
                ev = self._cmd_events.get(msg.tid)
                if ev is not None:
                    self._cmd_acks[msg.tid] = msg
                    ev.set()
            return True
        if isinstance(msg, MOSDMap) and conn is self.conn:
            best = None
            with self.lock:
                for epoch in sorted(msg.maps):
                    if epoch > self._latest_epoch:
                        self._latest_epoch = epoch
                        best = msg.maps[epoch]
            if best is not None and self.map_cb is not None:
                self.map_cb(best)
            return True
        return False

    # ------------------------------------------------------------------
    # subscriptions (reference MonClient::sub_want + renew)
    # ------------------------------------------------------------------
    def subscribe_osdmap(self, since_epoch: int = 0) -> None:
        with self.lock:
            self._sub_epoch = since_epoch
        self._mon_conn().send_message(
            MMonSubscribe(what={"osdmap": since_epoch}))

    # ------------------------------------------------------------------
    # commands (reference MonClient::start_mon_command)
    # ------------------------------------------------------------------
    REDIRECT_RETCODE = -301          # monitor.py REDIRECT_RETCODE

    def command(self, cmd: dict, timeout: float = 30.0
                ) -> Tuple[int, str, dict]:
        """Synchronous monitor command; -> (retcode, status, out).
        Follows peon->leader redirects and hunts to another mon on
        timeout (reference MonClient resends commands on session
        change; peon forwarding becomes an explicit redirect here)."""
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise CommandTimeout(
                    f"mon command {cmd.get('prefix')!r} unresolved "
                    f"within {timeout}s")
            try:
                ret, rs, out = self._command_once(
                    cmd, min(5.0, max(0.5, remaining)))
            except CommandTimeout:
                if time.monotonic() >= deadline:
                    raise
                with self.lock:          # hunt to the next mon
                    if len(self.mon_addrs) > 1:
                        self._addr_idx = (self._addr_idx + 1) % \
                            len(self.mon_addrs)
                        old, self.conn = self.conn, None
                    else:
                        old = None
                    sub = self._sub_epoch
                if old is not None:
                    old.mark_down()
                if old is not None and sub is not None:
                    # the new mon knows nothing of our subscription
                    try:
                        self.subscribe_osdmap(self._latest_epoch + 1)
                    except Exception:
                        pass
                continue
            if ret == self.REDIRECT_RETCODE and "leader" in out:
                self._retarget(tuple(out["leader"]))
                continue
            if ret == -11 and "electing" in rs:
                time.sleep(0.5)          # quorum forming: retry
                continue
            return ret, rs, out

    def _command_once(self, cmd: dict, timeout: float
                      ) -> Tuple[int, str, dict]:
        with self.lock:
            self._next_tid += 1
            tid = self._next_tid
            ev = threading.Event()
            self._cmd_events[tid] = ev
        try:
            self._mon_conn().send_message(MMonCommand(tid=tid, cmd=cmd))
            if not ev.wait(timeout):
                raise CommandTimeout(
                    f"mon command {cmd.get('prefix')!r} timed out")
            with self.lock:
                ack = self._cmd_acks.pop(tid)
            return ack.retcode, ack.rs, ack.out
        finally:
            with self.lock:
                self._cmd_events.pop(tid, None)
                self._cmd_acks.pop(tid, None)

    # ------------------------------------------------------------------
    # OSD control traffic
    # ------------------------------------------------------------------
    def send_boot(self, osd: int, addr: Tuple[str, int]) -> None:
        self._mon_conn().send_message(MOSDBoot(osd=osd, addr=addr))

    def report_failure(self, target_osd: int, from_osd: int,
                       failed_for: float, epoch: int) -> None:
        self._mon_conn().send_message(
            MOSDFailure(target_osd=target_osd, from_osd=from_osd,
                        failed_for=failed_for, epoch=epoch))

    def send_pg_stats(self, from_osd: int, epoch: int,
                      pg_stats: Dict[str, dict],
                      osd_stat: Optional[dict] = None) -> None:
        self._mon_conn().send_message(
            MPGStats(from_osd=from_osd, epoch=epoch, pg_stats=pg_stats,
                     osd_stat=osd_stat))

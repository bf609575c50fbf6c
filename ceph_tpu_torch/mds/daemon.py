"""MDS daemon: the filesystem's metadata authority.

Python-native equivalent of the reference's metadata server (reference
``src/mds/`` 86.6k LoC: MDSDaemon/MDSRank + Server request handling +
MDLog journaling + Locker capabilities) reduced to the duties that
give CephFS its semantics:

* **per-subtree metadata authority**: every namespace mutation
  (mkdir, create, unlink, rename, setattr...) executes at the RANK
  authoritative for its dentry's parent directory, serialized there,
  so multi-client races resolve in one place (reference Server::
  handle_client_request) — clients talk to the MDS over the ordinary
  messenger; file DATA still flows client -> OSD directly (striped to
  the data pool), exactly like the reference.  Multi-MDS scaling is
  static subtree pinning (reference ``max_mds`` + ``ceph.dir.pin`` /
  Migrator subtree auth, mds/Migrator.cc, mds/MDBalancer.cc): the
  monitor's pin table maps subtrees to ranks, each rank journals to
  its own objects and fences them on takeover, mismatched requests
  get a forward verdict the client follows, and cross-subtree
  renames run a journal-backed master/slave 2-phase (prepare ->
  peer link -> commit, resumed from the journal after a crash —
  the Migrator/MMDSSlaveRequest protocol reduced to its rename
  essentials);
* **journaling** (reference MDLog/LogEvent + EMetaBlob): each
  mutation appends a low-level, idempotent record to a RADOS-backed
  journal BEFORE touching the backing metadata objects; a restart
  replays the tail past the last checkpoint, so a crash between
  journal and multi-object apply cannot leave the namespace torn —
  restart is resume;
* **client capabilities** (reference Locker + MClientCaps, collapsed
  to the exclusive-writer case): a client opening for write is
  granted a cap that lets it buffer size/mtime locally while
  streaming data to the OSDs; any conflicting access (another open,
  a stat) RECALLS the cap — the holder flushes its buffered
  attributes back and degrades to sync-through mode — so every
  observer sees coherent metadata.  A dead holder's caps are revoked
  when its session resets, and recalls time out rather than wedge.

The backing store is the same on-RADOS layout as fs/filesystem.py
(dir omaps + inode records + striped data), so the library-mode
FileSystem and the daemon interoperate on the same pools.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..client.rados import Rados, RadosError
from ..fs.filesystem import (DIR_TYPE, FILE_TYPE, FSError, FileSystem,
                             ROOT_INO, _data_soid, _dir_oid, _ino_oid,
                             parent_path, pin_rank_of)
from ..msg.messages import MMDSCapRecall, MMDSOp, MMDSOpReply
from ..msg.messenger import Connection, Dispatcher, Messenger
from ..utils.config import Config, default_config
from ..utils.lockdep import make_lock
from ..utils.log import Dout

JOURNAL_OID = "mds.journal"          # reference MDLog journal objects
JOURNAL_HEAD = "mds.journal.head"    # checkpoint: applied-through seq
# journal trim cadence + forced-recall timeout come from conf
# (mds_journal_checkpoint_interval / mds_recall_timeout)


def rank_journal_oids(rank: int) -> Tuple[str, str]:
    """Journal object names for a rank (reference: one MDLog per
    MDSRank, journal inodes 0x200+rank).  Rank 0 keeps the legacy
    names so solo deployments and pre-multi-MDS journals replay."""
    if rank <= 0:
        return JOURNAL_OID, JOURNAL_HEAD
    return f"{JOURNAL_OID}.r{rank}", f"{JOURNAL_HEAD}.r{rank}"


class _Cap:
    def __init__(self, cap_id: int, client: str, conn: Connection):
        self.cap_id = cap_id
        self.client = client
        self.conn = conn


class MDSDaemon(Dispatcher):
    """One active metadata server (reference MDSRank)."""

    def __init__(self, mon_addr: Tuple[str, int], meta_pool: str,
                 data_pool: Optional[str] = None,
                 conf: Optional[Config] = None,
                 addr: Tuple[str, int] = ("127.0.0.1", 0),
                 name: str = "mds.a"):
        self.name = name
        self.conf = conf or default_config()
        self.log = Dout("mds", f"{name} ")
        self.lock = make_lock("mds")
        self.rados = Rados(mon_addr, conf=self.conf).connect()
        self.meta = self.rados.open_ioctx(meta_pool)
        data = self.rados.open_ioctx(data_pool) if data_pool \
            else self.meta
        self.fs = FileSystem(self.meta, data)
        # journal state
        self._seq = 0
        self._applied = 0
        self._since_checkpoint = 0
        # caps: ino -> _Cap (exclusive writer)
        self.caps: Dict[int, _Cap] = {}
        self._next_cap = 0
        # parked requests waiting on a recall: ino -> [(msg, conn)]
        self._waiting_recall: Dict[int, List[Tuple]] = {}
        self._recall_started: Dict[int, float] = {}
        # exactly-once for retried client mutations (failover resend):
        # (client, tid) -> reply out; rebuilt from the journal window
        # on replay, so a new active can suppress duplicates too
        self._reqids: Dict[Tuple[str, int], dict] = {}
        # role (reference MDSMap states collapsed to active/standby):
        # assigned by the monitor via beacons; True until told
        # otherwise so solo deployments without mds-aware monitors
        # keep working
        self.active = True
        # multi-MDS (reference MDSRank + static subtree pinning):
        # rank assigned by the monitor, journal objects per rank
        # (rank 0 keeps the legacy names so solo deployments and old
        # journals keep working), subtree pin table + peer addrs from
        # the beacon reply for request routing
        self.rank = 0
        self._joid = JOURNAL_OID
        self._jhead = JOURNAL_HEAD
        self._pins: Dict[str, int] = {}
        self._peer_addrs: Dict[str, Tuple[str, int]] = {}
        # peer-op RPC state (cross-rank rename slave requests):
        # tid -> Event/reply, guarded by _peer_lock, NOT self.lock —
        # peer replies must land while a handler thread is blocked
        self._peer_lock = threading.Lock()
        # serializes outbound slave requests (one in flight per
        # daemon: makes the constant slave tid unambiguous)
        self._peer_rpc_mutex = threading.Lock()
        self._peer_tid = 0
        self._peer_waiting: Dict[int, threading.Event] = {}
        self._peer_replies: Dict[int, object] = {}
        # unresolved cross-rank rename prepares (prep id -> record):
        # rebuilt on replay, resolved by the tick until commit/abort
        self._pending_renames: Dict[str, dict] = {}
        self._last_beacon = 0.0
        self._checkpoint_every = \
            self.conf["mds_journal_checkpoint_interval"]
        self._recall_timeout = self.conf["mds_recall_timeout"]
        # mdsmap epoch we last held a role at: stamps every journal
        # append (cls_fence guard) so a deposed active's writes are
        # rejected atomically inside the OSD — the reference fences
        # via OSDMap blocklist before promoting a standby
        self._epoch = 0
        self._replay_journal()
        self.msgr = Messenger(name, conf=self.conf)
        self.my_addr = self.msgr.bind(addr)
        self.msgr.add_dispatcher(self)
        self._stop = threading.Event()
        self._ticker = threading.Thread(target=self._tick_loop,
                                        name=f"{name}-tick",
                                        daemon=True)

    def start(self) -> "MDSDaemon":
        self._send_beacon()              # learn our role BEFORE serving
        self.msgr.start()
        self._ticker.start()
        self.log.dout(1, f"mds up at {self.my_addr} "
                      f"({'active' if self.active else 'standby'})")
        return self

    # ------------------------------------------------------------------
    # beacons + role (reference MDSMap/MDSMonitor + MDSRank states,
    # collapsed to active|standby with replay-on-takeover)
    # ------------------------------------------------------------------
    def _send_beacon(self) -> None:
        self._last_beacon = time.monotonic()
        try:
            ret, role, out = self.rados.mon_command(
                {"prefix": "mds beacon", "name": self.name,
                 "addr": list(self.my_addr)}, timeout=5.0)
        except Exception:
            return                       # mon unreachable: keep role
        if ret != 0:
            return                       # mds-unaware monitor: solo
        if not getattr(self, "_role_initialized", False):
            # a monitor IS assigning roles: our constructor's
            # solo-friendly active=True must not short-circuit the
            # promotion branch — a replacement process started over a
            # live zombie (same name, wedged original) has to take the
            # full fence+replay takeover path, or neither process ever
            # raises the fence and both append at epoch 0
            self._role_initialized = True
            with self.lock:
                self.active = False
        want_active = out.get("role") == "active"
        try:
            new_epoch = int(out.get("epoch", 0))
        except (TypeError, ValueError):
            new_epoch = 0
        # routing state rides every beacon reply: the pin table and
        # the other actives' addrs (multi-MDS request forwarding +
        # cross-rank rename slave requests)
        with self.lock:
            if "pins" in out:
                self._pins = {("/" + p.strip("/")): int(r)
                              for p, r in out["pins"].items()}
            if "actives" in out:
                self._peer_addrs = {
                    k: tuple(v) for k, v in out["actives"].items()
                    if v is not None}
        new_rank = out.get("rank")
        if want_active and self.active and new_rank is not None \
                and new_rank != self.rank:
            # reassigned to a different rank: drop the old role state
            # first, then take the new rank through the full
            # fence+replay takeover below
            with self.lock:
                self._demote(f"reassigned rank {self.rank} -> "
                             f"{new_rank}")
        if want_active and not self.active:
            with self.lock:
                # TAKEOVER: adopt the epoch ONLY here, under the lock
                # — a zombie must never learn the successor's epoch
                # (adopting it on a standby reply would let an
                # in-flight append slip past the fence stamped with
                # the new epoch before the demotion branch runs).
                # Then fence FIRST — raising the journal fence to our
                # epoch atomically rejects any in-flight append from
                # the deposed active (it was assigned at an older
                # epoch), so the replay below observes the journal's
                # final state.  Only then adopt what the dead active
                # journaled (reference standby-replay + MDSRank rejoin
                # collapsed to a fresh tail replay — the journal is
                # small by the checkpoint cadence).
                self._epoch = max(self._epoch, new_epoch)
                if new_rank is not None:
                    self.rank = int(new_rank)
                    self._joid, self._jhead = \
                        rank_journal_oids(self.rank)
                if not self._fence_journal():
                    return               # stale/unreachable: next
                                         # beacon retries promotion
                self._reqids.clear()
                self._pending_renames.clear()
                self._replay_journal()
                self.active = True
            self.log.dout(1, f"promoted to active rank {self.rank} "
                          f"(journal fenced at e{self._epoch}, "
                          f"adopted)")
        elif not want_active and self.active:
            with self.lock:
                self._demote("monitor reassigned active")

    def shutdown(self) -> None:
        self._stop.set()
        self.msgr.shutdown()
        self.rados.shutdown()

    # ------------------------------------------------------------------
    # journal (reference MDLog; records are low-level + idempotent)
    # ------------------------------------------------------------------
    def _replay_journal(self) -> None:
        try:
            head = json.loads(self.meta.read(self._jhead).decode())
        except (RadosError, ValueError):
            head = {"applied": 0}
        self._applied = head["applied"]
        # seq numbering continues PAST the checkpoint watermark: a
        # truncated journal must never hand out seqs at or below
        # ``applied``, or post-checkpoint WAL entries would be
        # skipped as already-applied on the next replay
        self._seq = self._applied
        try:
            raw = self.meta.read(self._joid)
        except RadosError:
            raw = b""
        replayed = 0
        for line in raw.splitlines():
            if not line.strip():
                continue
            ent = json.loads(line.decode())
            self._seq = max(self._seq, ent["seq"])
            if ent.get("reqid"):
                self._reqids[tuple(ent["reqid"])] = \
                    {"ino": ent["ino"]} if "ino" in ent else {}
            # cross-rank rename 2-phase bookkeeping: a prepare with
            # no commit/abort is an interrupted master — the tick
            # re-drives the slave link and commits (reference
            # Migrator resolve after mds failure)
            if ent["op"] == "rename_out_prepare":
                self._pending_renames[ent["prep"]] = ent
            elif ent["op"] in ("rename_out_commit",
                               "rename_out_abort"):
                self._pending_renames.pop(ent.get("prep"), None)
            if ent["seq"] <= self._applied:
                continue
            self._apply(ent)
            replayed += 1
        self._applied = self._seq
        if replayed:
            self.log.dout(1, f"journal replayed {replayed} entries")
            try:
                self._checkpoint()
            except RadosError as e:
                if e.errno != 116:
                    raise
                # fenced out mid-replay (we restarted with a stale
                # epoch while a successor holds the fence): the
                # replayed applies were idempotent no-ops; stay
                # standby and leave the journal to the real active

    def _demote(self, why: str) -> None:
        """Drop the active role and every bit of active-only state
        (used by both the beacon demotion and the fenced-out path —
        they must never diverge)."""
        self.active = False
        self.caps.clear()
        self._waiting_recall.clear()
        self._recall_started.clear()
        self.log.dout(1, f"demoted to standby: {why}")

    def _fence_journal(self) -> bool:
        """Raise the fence on the journal AND its head watermark to
        our mdsmap epoch (cls_fence); True on success.  ENOTSUP
        (cls-less pool, e.g. EC meta) keeps the pre-fencing behavior
        rather than bricking the filesystem."""
        try:
            payload = json.dumps({"epoch": self._epoch}).encode()
            self.meta.exec_cls(self._joid, "fence", "set", payload)
            self.meta.exec_cls(self._jhead, "fence", "set", payload)
            return True
        except RadosError as e:
            if e.errno == 95:            # EOPNOTSUPP: unfenced pool
                self._fence_unsupported = True
                return True
            self.log.dout(1, f"journal fence at e{self._epoch} "
                          f"refused: {e}")
            return False
        except Exception as e:
            self.log.dout(1, f"journal fence unreachable: {e}")
            return False

    def _guarded(self, oid: str, method: str, plain, **req) -> None:
        """One epoch-guarded journal mutation.  A fence raised past us
        (a standby was promoted while we still thought we were active)
        rejects the op inside the OSD: demote on the spot and fail the
        client op ESTALE so it re-resolves the active."""
        if getattr(self, "_fence_unsupported", False):
            plain()                      # latched: skip the doomed RPC
            return
        try:
            self.meta.exec_cls(
                oid, "fence", method,
                json.dumps(dict(req, epoch=self._epoch)).encode())
            return
        except RadosError as e:
            if e.errno == 95:            # EOPNOTSUPP: unfenced pool —
                # latch it so later mutations skip the wasted round
                # trip (the pool's type cannot change under us)
                self._fence_unsupported = True
                plain()
                return
            if e.errno != 1:             # not a fence rejection
                raise
        self._demote("journal op fenced out (a standby was promoted "
                     "over us)")
        raise RadosError(116, "fenced: no longer the active mds")

    def _fenced_append(self, line: bytes) -> None:
        self._guarded(self._joid, "guarded_append",
                      lambda: self.meta.append(self._joid, line),
                      data=line.decode("utf-8"))

    def _journal(self, ent: dict) -> int:
        """Append one record durably (epoch-fenced), then apply it
        (WAL order).  Stamps the requesting client's reqid for
        duplicate suppression across failovers."""
        self._seq += 1
        ent["seq"] = self._seq
        reqid = getattr(self, "_cur_reqid", None)
        if reqid is not None:
            ent["reqid"] = list(reqid)
        try:
            self._fenced_append(json.dumps(ent).encode() + b"\n")
        except RadosError as e:
            if e.errno == 116:           # fence rejection: DEFINITELY
                self._seq -= 1           # not committed — reuse seq
            # anything else (timeout, connection loss) is
            # indeterminate: the append may yet commit, so the seq is
            # burned — two different records must never share one
            raise
        if reqid is not None:
            self._reqids[reqid] = \
                {"ino": ent["ino"]} if "ino" in ent else {}
        self._apply(ent)
        self._applied = ent["seq"]
        self._since_checkpoint += 1
        if self._since_checkpoint >= self._checkpoint_every:
            self._checkpoint()
        return ent["seq"]

    def _checkpoint(self) -> None:
        """Backing store has absorbed everything applied: record the
        watermark and trim the journal — both epoch-guarded, or a
        zombie's checkpoint would regress the successor's watermark
        and its trim would erase the successor's entries (reference
        MDLog trim, safe there because the old active is blocklisted
        before promotion)."""
        if self._pending_renames:
            # an unresolved cross-rank rename prepare lives ONLY in
            # the journal tail; trimming now would lose the intent a
            # crash needs to resume (the tick resolves these fast)
            return
        head = json.dumps({"applied": self._applied})
        self._guarded(self._jhead, "guarded_write_full",
                      lambda: self.meta.write_full(self._jhead,
                                                   head.encode()),
                      data=head)
        try:
            self._guarded(self._joid, "guarded_truncate",
                          lambda: self.meta.truncate(self._joid, 0),
                          size=0)
        except RadosError as e:
            if e.errno != 2:             # ENOENT: nothing to trim
                raise
        self._since_checkpoint = 0

    def _apply(self, ent: dict) -> None:
        """Idempotent low-level mutation application (replay-safe:
        every record carries absolute state, including pre-assigned
        inode numbers)."""
        op = ent["op"]
        fs = self.fs
        if op == "mkdir":
            fs._write_inode(ent["ino"], DIR_TYPE, 0)
            try:
                self.meta.create(_dir_oid(ent["ino"]))
            except RadosError:
                pass
            fs._link(ent["parent"], ent["name"], ent["ino"], DIR_TYPE)
        elif op == "create":
            fs._write_inode(ent["ino"], FILE_TYPE, 0)
            fs._link(ent["parent"], ent["name"], ent["ino"],
                     FILE_TYPE)
        elif op == "unlink":
            fs._unlink(ent["parent"], ent["name"])
            try:
                fs.striper.remove(_data_soid(ent["ino"]))
            except RadosError:
                pass
            fs._remove_oid(_ino_oid(ent["ino"]))
        elif op == "rmdir":
            fs._unlink(ent["parent"], ent["name"])
            fs._remove_oid(_dir_oid(ent["ino"]))
            fs._remove_oid(_ino_oid(ent["ino"]))
        elif op == "rename":
            fs._link(ent["nparent"], ent["nname"], ent["ino"],
                     ent["type"])
            fs._unlink(ent["oparent"], ent["oname"])
            if ent.get("unlink_ino"):
                try:
                    fs.striper.remove(_data_soid(ent["unlink_ino"]))
                except RadosError:
                    pass
                fs._remove_oid(_ino_oid(ent["unlink_ino"]))
        elif op == "setattr":
            fs._write_inode(ent["ino"], ent["type"], ent["size"],
                            ent.get("mode", 0o644))
        elif op == "rename_out_prepare":
            pass     # intent marker only: replay bookkeeping resumes
                     # the slave link + commit (no namespace effect)
        elif op == "rename_out_commit":
            # master side of a cross-rank rename: the slave already
            # linked the dentry at the destination rank; drop ours
            fs._unlink(ent["oparent"], ent["oname"])
        elif op == "rename_out_abort":
            pass     # slave refused: nothing ever changed
        elif op == "link":
            # slave side of a cross-rank rename (reference
            # MMDSSlaveRequest OP_LINKPREP collapsed to one journaled
            # insert): adopt the inode's dentry under our subtree,
            # replacing a same-name file target like a local rename
            fs._link(ent["parent"], ent["name"], ent["ino"],
                     ent["type"])
            if ent.get("unlink_ino"):
                try:
                    fs.striper.remove(_data_soid(ent["unlink_ino"]))
                except RadosError:
                    pass
                fs._remove_oid(_ino_oid(ent["unlink_ino"]))

    # ------------------------------------------------------------------
    # capabilities (reference Locker, exclusive-writer collapse)
    # ------------------------------------------------------------------
    def _grant_cap(self, ino: int, client: str,
                   conn: Connection) -> int:
        self._next_cap += 1
        self.caps[ino] = _Cap(self._next_cap, client, conn)
        return self._next_cap

    def _needs_recall(self, ino: int, client: str) -> bool:
        """ANY live cap must flush before a coherence-point op — the
        holder's own stat included (write-then-stat visibility), and
        a re-open recalls the prior handle cleanly."""
        return self.caps.get(ino) is not None

    def _start_recall(self, ino: int, msg, conn) -> None:
        """Park the request; ask the holder to flush+drop."""
        self._waiting_recall.setdefault(ino, []).append((msg, conn))
        if ino not in self._recall_started:
            self._recall_started[ino] = time.monotonic()
            cap = self.caps[ino]
            try:
                cap.conn.send_message(MMDSCapRecall(
                    ino=ino, cap_id=cap.cap_id, rank=self.rank))
            except Exception:
                self._revoke(ino)        # dead session: drop now

    def _revoke(self, ino: int) -> None:
        """Forcefully drop a cap (timeout / dead holder) and resume
        parked requests; the holder's unflushed attrs are lost — the
        same durability contract as the reference when a client dies
        holding dirty caps."""
        self.caps.pop(ino, None)
        self._recall_started.pop(ino, None)
        for msg, conn in self._waiting_recall.pop(ino, []):
            self._handle_op(msg, conn)

    def _cap_release(self, client: str, args: dict) -> None:
        ino = args["ino"]
        cap = self.caps.get(ino)
        # match the EXACT capability: a stale handle's release must
        # not revoke a newer cap (same client reopening included)
        if cap is None or cap.client != client \
                or cap.cap_id != args.get("cap_id"):
            return
        if "size" in args:
            try:
                node = self.fs._read_inode(ino)
            except FSError:
                node = None          # unlinked under the cap: drop
            if node is not None:
                self._journal({"op": "setattr", "ino": ino,
                               "type": node["type"],
                               "size": int(args["size"]),
                               "mode": node.get("mode", 0o644)})
        self._revoke(ino)

    def _tick_loop(self) -> None:
        interval = self.conf["mds_beacon_interval"]
        while not self._stop.wait(0.25):
            if time.monotonic() - self._last_beacon >= interval:
                self._send_beacon()
            with self.lock:
                now = time.monotonic()
                stale = [ino for ino, t0 in
                         self._recall_started.items()
                         if now - t0 > self._recall_timeout]
                for ino in stale:
                    self.log.dout(1, f"recall timeout ino {ino}")
                    self._revoke(ino)
                # re-drive cross-rank rename prepares whose first
                # attempt went indeterminate (or that a crash left in
                # the journal): the slave's reqid table makes the
                # retried link exactly-once
                retries = [p for p, rec in
                           self._pending_renames.items()
                           if self.active
                           and now - rec.get("t0", 0) > 10.0]
                for prep in retries:
                    self._pending_renames[prep]["t0"] = now
                    threading.Thread(
                        target=self._drive_cross_rename,
                        args=(prep, None),
                        name=f"{self.name}-xrename-retry",
                        daemon=True).start()

    # ------------------------------------------------------------------
    # multi-MDS routing (static subtree pinning: the reference's
    # Migrator/MDBalancer subtree auth reduced to a monitor-held pin
    # table; every rank reads the shared backing store but MUTATES
    # only the subtrees pinned to it, so dir omaps have one writer)
    # ------------------------------------------------------------------
    _parent_path = staticmethod(parent_path)

    def _rank_of_path(self, path: str) -> int:
        return pin_rank_of(self._pins, path)

    def _route_rank(self, op: str, a: dict):
        """Authoritative rank for an op, or None when routing does
        not apply.  Namespace mutations and lookups route by the
        DENTRY'S PARENT directory (the dentry lives in the parent's
        omap — reference: a subtree bound's dentry belongs to the
        parent subtree); listdir routes by the directory itself;
        cap_release and slave requests are rank-local."""
        if not self._pins:
            return None
        if op in ("cap_release", "peer_link"):
            return None
        if op == "listdir":
            return self._rank_of_path(a.get("path", "/"))
        if op == "rename":
            return self._rank_of_path(
                self._parent_path(a.get("old", "/")))
        return self._rank_of_path(
            self._parent_path(a.get("path", "/")))

    def _peer_request(self, rank: int, op: str, args: dict,
                      prep: str, timeout: float = 20.0):
        """One blocking slave request to another rank (reference
        MMDSSlaveRequest).  Serialized per daemon so the constant
        slave tid is unambiguous; the client name carries the prep id
        so the peer's journal-backed reqid table makes retries (in-
        session or post-crash) exactly-once.  Callers must NOT hold
        self.lock — the peer may be sending us a slave request of its
        own at the same moment.  Raises TimeoutError when the outcome
        is indeterminate (never on a definite refusal)."""
        addr = self._peer_addrs.get(str(rank))
        if addr is None:
            raise TimeoutError(f"no address for mds rank {rank}")
        with self._peer_rpc_mutex:
            with self._peer_lock:
                self._peer_tid += 1
                tid = self._peer_tid
                ev = threading.Event()
                self._peer_waiting[tid] = ev
            try:
                conn = self.msgr.connect_to(tuple(addr),
                                            lossless=False)
                conn.send_message(MMDSOp(
                    client=f"mdspeer:{prep}", tid=1, op=op,
                    args=dict(args, reply_tid=tid)))
                if not ev.wait(timeout):
                    raise TimeoutError(f"peer rank {rank} silent")
            finally:
                with self._peer_lock:
                    self._peer_waiting.pop(tid, None)
                    reply = self._peer_replies.pop(tid, None)
            if reply is None:
                raise TimeoutError(f"peer rank {rank} silent")
            return reply

    # ------------------------------------------------------------------
    # request handling (reference Server::handle_client_request)
    # ------------------------------------------------------------------
    def ms_dispatch(self, conn: Connection, msg) -> bool:
        if isinstance(msg, MMDSOpReply):
            # a slave request's answer (peer ops echo our reply_tid)
            rtid = (msg.out or {}).get("reply_tid", msg.tid)
            with self._peer_lock:
                self._peer_replies[rtid] = msg
                ev = self._peer_waiting.pop(rtid, None)
            if ev:
                ev.set()
            return True
        if not isinstance(msg, MMDSOp):
            return False
        with self.lock:
            self._handle_op(msg, conn)
        return True

    def ms_handle_reset(self, conn: Connection) -> None:
        with self.lock:
            dead = [ino for ino, cap in self.caps.items()
                    if cap.conn is conn]
            for ino in dead:
                self._revoke(ino)

    def _reply(self, conn, msg, result: int = 0,
               out: Optional[dict] = None) -> None:
        out = dict(out or {})
        # slave requests carry the master's correlation id; echo it in
        # EVERY reply shape (including reqid-dedup hits) so the master
        # never mis-matches a late reply to the wrong request
        try:
            rt = msg.args.get("reply_tid")
        except AttributeError:
            rt = None
        if rt is not None:
            out["reply_tid"] = rt
        try:
            conn.send_message(MMDSOpReply(tid=msg.tid, result=result,
                                          out=out))
        except Exception:
            pass

    def _handle_op(self, msg: MMDSOp, conn) -> None:
        a = msg.args
        fs = self.fs
        if not self.active:
            # standby: the client must re-resolve the active MDS
            # (reference CEPH_MDS_STATE checks -> ESTALE resends)
            self._reply(conn, msg, -116)
            return
        hit = self._reqids.get((msg.client, msg.tid))
        if hit is not None:
            # duplicate of an already-journaled mutation (client
            # resent across a failover): re-reply, don't re-execute.
            # Checked BEFORE the routing verdict: a pin change between
            # first try and resend must not forward the resend to a
            # rank that never saw the reqid (it would re-execute or
            # mis-error an op that already succeeded here)
            self._reply(conn, msg, 0, dict(hit))
            return
        target = self._route_rank(msg.op, a)
        if target is not None and target != self.rank:
            # another rank's subtree: forward verdict (reference
            # Server forwards via mdsmap; here the client re-sends to
            # out["rank"] itself)
            self._reply(conn, msg, -108, {"rank": target})
            return
        self._cur_reqid = (msg.client, msg.tid)
        try:
            if msg.op == "cap_release":
                self._cap_release(msg.client, a)
                self._reply(conn, msg)
                return
            if msg.op in ("open", "stat", "truncate", "setattr",
                          "unlink", "rename", "peer_link"):
                # coherence point: these must observe (or take over)
                # any writer's buffered attributes — including the
                # namespace ops that destroy the target
                paths = [a["old"], a["new"]] if msg.op == "rename" \
                    else [a["path"]]
                for pth in paths:
                    try:
                        ino, _ = fs._resolve(pth)
                    except FSError:
                        continue
                    if self._needs_recall(ino, msg.client):
                        self._start_recall(ino, msg, conn)
                        return           # parked; resumes on release
            if msg.op == "mkdir":
                parent, name = fs._resolve_parent(a["path"])
                if fs._lookup(parent, name) is not None:
                    raise FSError(17, a["path"])
                ino = fs._alloc_ino()
                self._journal({"op": "mkdir", "parent": parent,
                               "name": name, "ino": ino})
                self._reply(conn, msg, out={"ino": ino})
            elif msg.op == "create":
                parent, name = fs._resolve_parent(a["path"])
                ent = fs._lookup(parent, name)
                if ent is not None:
                    if ent["type"] != FILE_TYPE:
                        raise FSError(21, a["path"])
                    self._reply(conn, msg, out={"ino": ent["ino"]})
                    return
                ino = fs._alloc_ino()
                self._journal({"op": "create", "parent": parent,
                               "name": name, "ino": ino})
                self._reply(conn, msg, out={"ino": ino})
            elif msg.op == "open":
                mode = a.get("mode", "r")
                if mode == "w":
                    parent, name = fs._resolve_parent(a["path"])
                    ent = fs._lookup(parent, name)
                    if ent is None:
                        ino = fs._alloc_ino()
                        self._journal({"op": "create",
                                       "parent": parent,
                                       "name": name, "ino": ino})
                    elif ent["type"] != FILE_TYPE:
                        raise FSError(21, a["path"])
                    else:
                        ino = ent["ino"]
                    if ino in self.caps:
                        # raced grant (parked re-entry): recall first
                        self._start_recall(ino, msg, conn)
                        return
                    cap_id = self._grant_cap(ino, msg.client, conn)
                    node = fs._read_inode(ino)
                    self._reply(conn, msg, out={
                        "ino": ino, "cap_id": cap_id,
                        "size": node["size"]})
                else:
                    ino, ent = fs._resolve(a["path"])
                    if ent["type"] != FILE_TYPE:
                        raise FSError(21, a["path"])
                    node = fs._read_inode(ino)
                    self._reply(conn, msg, out={
                        "ino": ino, "size": node["size"]})
            elif msg.op == "stat":
                self._reply(conn, msg, out=fs.stat(a["path"]))
            elif msg.op == "listdir":
                self._reply(conn, msg,
                            out={"entries": fs.listdir(a["path"])})
            elif msg.op == "unlink":
                parent, name = fs._resolve_parent(a["path"])
                ent = fs._lookup(parent, name)
                if ent is None:
                    raise FSError(2, a["path"])
                if ent["type"] == DIR_TYPE:
                    raise FSError(21, a["path"])
                self._journal({"op": "unlink", "parent": parent,
                               "name": name, "ino": ent["ino"]})
                if ent["ino"] in self.caps:
                    self._revoke(ent["ino"])
                self._reply(conn, msg)
            elif msg.op == "rmdir":
                parent, name = fs._resolve_parent(a["path"])
                ent = fs._lookup(parent, name)
                if ent is None:
                    raise FSError(2, a["path"])
                if ent["type"] != DIR_TYPE:
                    raise FSError(20, a["path"])
                if self.meta.omap_get(_dir_oid(ent["ino"])):
                    raise FSError(39, a["path"])
                self._journal({"op": "rmdir", "parent": parent,
                               "name": name, "ino": ent["ino"]})
                self._reply(conn, msg)
            elif msg.op == "rename":
                self._rename(msg, conn, a["old"], a["new"])
            elif msg.op == "peer_link":
                # slave side of a cross-rank rename (reference
                # MMDSSlaveRequest): adopt the inode under our
                # subtree; rename-over-file semantics match _rename
                nparent, nname = fs._resolve_parent(a["path"])
                target = fs._lookup(nparent, nname)
                unlink_ino = None
                if target is not None:
                    if target["ino"] == a["ino"]:
                        self._reply(conn, msg)   # already linked
                        return
                    if target["type"] == DIR_TYPE:
                        raise FSError(21, a["path"])
                    if a["type"] == DIR_TYPE:
                        raise FSError(20, a["path"])
                    unlink_ino = target["ino"]
                self._journal({"op": "link", "parent": nparent,
                               "name": nname, "ino": a["ino"],
                               "type": a["type"],
                               "unlink_ino": unlink_ino})
                if unlink_ino is not None and unlink_ino in self.caps:
                    self._revoke(unlink_ino)
                self._reply(conn, msg)
            elif msg.op in ("truncate", "setattr"):
                ino, ent = fs._resolve(a["path"])
                node = fs._read_inode(ino)
                size = int(a.get("size", node["size"]))
                if msg.op == "truncate":
                    try:
                        fs.striper.truncate(_data_soid(ino), size)
                    except RadosError:
                        if size:
                            raise
                else:
                    # size grows monotonically under sync-through
                    # writers racing each other
                    size = max(size, node["size"]) \
                        if a.get("grow_only") else size
                self._journal({"op": "setattr", "ino": ino,
                               "type": node["type"], "size": size,
                               "mode": a.get("mode",
                                             node.get("mode",
                                                      0o644))})
                self._reply(conn, msg, out={"size": size})
            else:
                self._reply(conn, msg, result=-95)
        except FSError as e:
            self._reply(conn, msg, result=-(e.errno or 5))
        except RadosError as e:
            self._reply(conn, msg, result=-(e.errno or 5))
        finally:
            # internal journal writers (recall-timeout revokes) must
            # not inherit a client's reqid stamp
            self._cur_reqid = None

    def _rename(self, msg, conn, old: str, new: str) -> None:
        fs = self.fs
        oparts = fs._parts(old)
        nparts = fs._parts(new)
        oparent, oname = fs._resolve_parent(old)
        ent = fs._lookup(oparent, oname)
        if ent is None:
            raise FSError(2, old)
        if oparts == nparts:
            self._reply(conn, msg)
            return
        if ent["type"] == DIR_TYPE and nparts[:len(oparts)] == oparts:
            raise FSError(22, old)
        dst_rank = self._rank_of_path(self._parent_path(new)) \
            if self._pins else self.rank
        if dst_rank != self.rank:
            self._start_cross_rename(msg, conn, ent, oparent, oname,
                                     new, dst_rank)
            return
        nparent, nname = fs._resolve_parent(new)
        target = fs._lookup(nparent, nname)
        unlink_ino = None
        if target is not None:
            if target["type"] == DIR_TYPE:
                raise FSError(21, new)
            if ent["type"] == DIR_TYPE:
                raise FSError(20, new)
            unlink_ino = target["ino"]
        self._journal({"op": "rename", "oparent": oparent,
                       "oname": oname, "nparent": nparent,
                       "nname": nname, "ino": ent["ino"],
                       "type": ent["type"],
                       "unlink_ino": unlink_ino})
        if unlink_ino is not None and unlink_ino in self.caps:
            self._revoke(unlink_ino)
        self._reply(conn, msg)

    # ------------------------------------------------------------------
    # cross-rank rename: 2-phase master (reference Migrator +
    # MMDSSlaveRequest, collapsed to prepare -> slave link -> commit
    # with journal-backed resume on either side's crash)
    # ------------------------------------------------------------------
    def _start_cross_rename(self, msg, conn, ent, oparent: int,
                            oname: str, new: str,
                            dst_rank: int) -> None:
        """Journal the master intent under self.lock, then drive the
        blocking slave request off-thread (holding the MDS lock
        across a network round trip would deadlock two masters
        renaming into each other's subtrees)."""
        prep = f"{self.name}.e{self._epoch}.{self._seq + 1}"
        saved = self._cur_reqid
        self._cur_reqid = None       # the COMMIT carries the client
        try:                         # reqid: a resend must not get a
                                     # dup-hit before the dest exists
            # ... but the prepare record still CARRIES it (under a
            # key _replay_journal does not register) so a tick retry
            # or crash replay can stamp the eventual commit with it —
            # otherwise a client resend after EAGAIN re-executes and
            # hits ENOENT on the already-moved source
            self._journal({"op": "rename_out_prepare",
                           "oparent": oparent, "oname": oname,
                           "ino": ent["ino"], "type": ent["type"],
                           "new": new, "peer_rank": dst_rank,
                           "prep": prep,
                           "client_reqid":
                               list(saved) if saved else None})
        finally:
            self._cur_reqid = saved
        self._pending_renames[prep] = {
            "oparent": oparent, "oname": oname, "ino": ent["ino"],
            "type": ent["type"], "new": new, "peer_rank": dst_rank,
            "prep": prep, "t0": time.monotonic(),
            "client_reqid": list(saved) if saved else None}
        threading.Thread(
            target=self._drive_cross_rename,
            args=(prep, self._cur_reqid, msg, conn),
            name=f"{self.name}-xrename", daemon=True).start()

    def _drive_cross_rename(self, prep: str, reqid, msg=None,
                            conn=None) -> None:
        """Slave link + local commit/abort for one prepared
        cross-rank rename.  Runs WITHOUT self.lock around the peer
        round trip; also re-driven by the tick for prepares found in
        the journal after a crash (msg=None: nobody to answer)."""
        with self.lock:
            rec = self._pending_renames.get(prep)
        if rec is None:
            if msg is not None:
                self._reply(conn, msg)   # already resolved
            return
        if reqid is None:
            # tick retry / crash replay: recover the client reqid the
            # prepare record journaled, so the commit still lands it
            # in the dedup table and a client resend gets a dup-hit
            # instead of re-executing
            cr = rec.get("client_reqid")
            reqid = tuple(cr) if cr else None
        try:
            reply = self._peer_request(
                rec["peer_rank"], "peer_link",
                {"path": rec["new"], "ino": rec["ino"],
                 "type": rec["type"]}, prep)
        except TimeoutError:
            # indeterminate: keep the prepare; the tick retries (the
            # slave's reqid table absorbs the duplicate) — the client
            # gets EAGAIN and may resend
            if msg is not None:
                self._reply(conn, msg, -11)
            return
        ok = reply.result == 0
        with self.lock:
            if prep not in self._pending_renames:
                return
            self._cur_reqid = reqid if ok else None
            try:
                self._journal({
                    "op": "rename_out_commit" if ok
                    else "rename_out_abort",
                    "oparent": rec["oparent"], "oname": rec["oname"],
                    "ino": rec["ino"], "prep": prep})
            except Exception:
                self._cur_reqid = None
                if msg is not None:
                    self._reply(conn, msg, -11)
                return
            self._cur_reqid = None
            self._pending_renames.pop(prep, None)
            # the inode now lives under another rank's authority: any
            # cap we granted on it must not linger here
            if ok and rec["ino"] in self.caps:
                self._revoke(rec["ino"])
        if msg is not None:
            self._reply(conn, msg, 0 if ok else reply.result)

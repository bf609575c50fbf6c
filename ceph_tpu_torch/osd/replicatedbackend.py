"""Replicated PG backend.

Python-native equivalent of the reference's ReplicatedBackend
(reference src/osd/ReplicatedBackend.{h,cc}, 2.4k LoC), the EC
backend's twin for ``TYPE_REPLICATED`` pools: the primary lowers the
logical mutation to ONE store transaction, applies it locally and ships
the identical transaction to every replica inside an MOSDRepOp
(reference ReplicatedBackend::submit_transaction -> issue_op); commit
replies gather into on_all_commit.  Reads are plain local reads on the
primary; recovery pushes the whole object (data + attrs + omap) with
MOSDPGPush (reference prep_push / handle_push).

Replicated pools support the full mutation vocabulary including omap
and truncate (contrast ECBackend's restrictions).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set, Tuple

from ..msg.messages import (MOSDPGPull, MOSDPGPush, MOSDPGPushReply,
                            MOSDRepOp, MOSDRepOpReply, PushOp)
from ..store.objectstore import GHObject, Transaction
from .backend import OI_ATTR, Mutation, ObjectInfo, PGBackend, PGHost
from .pglog import Eversion, LogEntry


class _RepOp:
    def __init__(self, tid: int, on_all_commit: Callable[[int], None]):
        self.tid = tid
        self.on_all_commit = on_all_commit
        self.pending: Set[int] = set()       # osd ids awaiting commit


class _RecOp:
    def __init__(self, oid: str, cb: Callable[[int], None]):
        self.oid = oid
        self.cb = cb
        self.pending: Set[int] = set()
        self.version: Eversion = (0, 0)
        self.push_after_pull: List[Tuple[int, int]] = []


class ReplicatedBackend(PGBackend):
    def __init__(self, host: PGHost):
        super().__init__(host)
        self.in_flight: Dict[int, _RepOp] = {}
        self.recovery_ops: Dict[str, _RecOp] = {}
        self._pull_attempts: Dict[str, int] = {}  # holder rotation

    # ------------------------------------------------------------------
    # write path
    # ------------------------------------------------------------------
    def submit_transaction(self, oid: str, mutation: Mutation,
                           at_version: Eversion,
                           log_entries: List[LogEntry],
                           on_all_commit: Callable[[int], None]) -> None:
        # object info read once; stores apply mutations synchronously at
        # queue time, so this reflects every previously submitted op
        info = self.get_object_info(oid)
        if mutation.create and info is not None:
            on_all_commit(-17)           # -EEXIST: exclusive create
            return
        txn = self._lower(oid, mutation, at_version, info)
        wire_entries = [e.to_dict() for e in log_entries]
        op = _RepOp(self.new_tid(), on_all_commit)
        self.in_flight[op.tid] = op
        replicas = [(s, o) for s, o in self.host.acting_shards()
                    if o is not None]
        for shard, osd in replicas:
            op.pending.add(osd)
        enc = txn.encode()
        for shard, osd in replicas:
            if osd == self.host.whoami:
                continue
            rep = MOSDRepOp(
                pgid=self.host.pgid_str, from_osd=self.host.whoami,
                tid=op.tid, epoch=self.host.epoch, txn=enc,
                log_entries=wire_entries, at_version=at_version,
                trace_id=mutation.trace_id,
                parent_span_id=mutation.parent_span_id)
            rep.stamp_hop("client_send")
            self.host.send_shard(osd, rep)
        tid = op.tid
        cmsg = mutation.client_msg

        def _local_committed(t=tid, m=cmsg):
            if m is not None:
                # local store commit: the client waterfall's
                # store_apply ends here; the replica ack wait that
                # follows charges to peer_ack_wait
                m.stamp_hop("store_apply")
            self._committed(t, self.host.whoami)
        self._apply_local(txn, wire_entries, _local_committed)

    def _lower(self, oid: str, mut: Mutation, at_version: Eversion,
               info: Optional[ObjectInfo]) -> Transaction:
        """Logical mutation -> one store transaction, applied identically
        on every replica (collection names match on all OSDs)."""
        from .snaps import SS_ATTR
        coll = self.host.coll
        obj = GHObject(oid, -1)
        txn = Transaction()
        if mut.clone_to is not None:
            # COW the pre-write head into the snapshot clone (reference
            # make_writeable's clone step) — store-level clone, the
            # store's COW machinery does the copying
            cobj = GHObject(mut.clone_to, -1)
            txn.clone(coll, obj, cobj)
            txn.rmattr(coll, cobj, SS_ATTR)   # clones carry no SnapSet
            if mut.clone_attrs:
                txn.setattrs(coll, cobj, mut.clone_attrs)
        for aux in mut.aux_remove:
            txn.remove(coll, GHObject(aux, -1))
        if mut.delete:
            txn.remove(coll, obj)
            if mut.snapdir_set is not None:
                # clones survive the head: SnapSet moves to the snapdir
                # companion (reference pre-octopus snapdir objects)
                sd_oid, ss, sd_oi = mut.snapdir_set
                sd = GHObject(sd_oid, -1)
                txn.touch(coll, sd)
                txn.setattr(coll, sd, SS_ATTR, ss)
                txn.setattr(coll, sd, OI_ATTR, sd_oi)
            return txn
        info = info or ObjectInfo()
        new_size = info.size
        if mut.rollback_from is not None:
            # head becomes the clone's content (reference rollback's
            # _rollback_to): wipe, then store-clone back
            txn.remove(coll, obj)
            txn.clone(coll, GHObject(mut.rollback_from, -1), obj)
            new_size = mut.rollback_size
        txn.touch(coll, obj)
        for off, data in mut.writes:
            txn.write(coll, obj, off, data)
            new_size = max(new_size, off + len(data))
        if mut.truncate is not None:
            txn.truncate(coll, obj, mut.truncate)
            new_size = mut.truncate
        if mut.snapset is not None:
            txn.setattr(coll, obj, SS_ATTR, mut.snapset)
        txn.setattr(coll, obj, OI_ATTR,
                    ObjectInfo(size=new_size,
                               version=at_version).encode())
        for name, value in mut.attrs.items():
            if value is None:
                txn.rmattr(coll, obj, "u_" + name)
            else:
                txn.setattr(coll, obj, "u_" + name, value)
        if mut.omap_clear:
            txn.omap_clear(coll, obj)
        if mut.omap_set:
            txn.omap_setkeys(coll, obj, mut.omap_set)
        if mut.omap_rm:
            txn.omap_rmkeys(coll, obj, mut.omap_rm)
        return txn

    def _apply_local(self, txn: Transaction, wire_entries: List[dict],
                     on_commit: Callable[[], None]) -> None:
        self.host.prepare_log_txn(txn, wire_entries)
        txn.register_on_commit(
            lambda: self.host.on_local_commit(on_commit))
        self.host.store.queue_transactions([txn], op="client_write")

    def _committed(self, tid: int, osd: int) -> None:
        op = self.in_flight.get(tid)
        if op is None:
            return
        op.pending.discard(osd)
        if not op.pending:
            del self.in_flight[tid]
            op.on_all_commit(0)

    # ------------------------------------------------------------------
    # read path: local, the primary holds a full copy
    # ------------------------------------------------------------------
    def objects_read(self, oid: str, offset: int, length: int,
                     cb: Callable[[int, bytes], None],
                     trace=(0, 0), hop_msg=None) -> None:
        if hop_msg is not None:
            hop_msg.stamp_hop("read_queued")
        obj = GHObject(oid, -1)
        try:
            data = self.host.store.read(self.host.coll, obj, offset,
                                        length)
        except FileNotFoundError:
            cb(-2, b"")
            return
        except OSError:
            # store-level csum mismatch (BlockStore EIO): surface it
            # — scrub repair-via-recovery re-homes a good replica
            cb(-5, b"")
            return
        if hop_msg is not None:
            # replicated reads are local: the store call above IS the
            # shard read (no sub-op round trip, no decode window)
            hop_msg.stamp_hop("shard_read")
        cb(0, data)

    # ------------------------------------------------------------------
    # recovery: push the full object
    # ------------------------------------------------------------------
    def recover_object(self, oid: str, version: Eversion,
                       missing_on: List[Tuple[int, int]],
                       cb: Callable[[int], None]) -> None:
        if oid in self.recovery_ops:
            cb(-16)
            return
        rec = _RecOp(oid, cb)
        rec.version = version
        obj = GHObject(oid, -1)
        # a primary that ITSELF needs the object must not source from
        # its own store — any local copy is a stale prior version and
        # self-"recovery" from it would silently resurrect old bytes
        self_missing = any(o == self.host.whoami
                           for _, o in missing_on)
        have_local = False
        if not self_missing:
            try:
                data = self.host.store.read(self.host.coll, obj)
                attrs = self.host.store.getattrs(self.host.coll, obj)
                omap = self.host.store.omap_get(self.host.coll, obj)
                have_local = True
            except OSError:
                # missing OR store-csum EIO (BlockStore bitrot): our
                # copy cannot source the push — pull from a holder
                pass
        if not have_local:
            # pull from a surviving holder (reference
            # prep_object_replica_pushes -> recover_primary pull path,
            # MOSDPGPull).  Rotate holders across retries: a holder
            # that silently lacks the data (lost disk) never answers,
            # and re-asking it forever wedges recovery.
            missing_osds = {o for _, o in missing_on}
            holders = [(s, o) for s, o in self.host.acting_shards()
                       if o is not None and o != self.host.whoami
                       and o not in missing_osds]
            # post-split strays / migrated-away copies can serve too
            for s, o in self.host.extra_recovery_sources(oid):
                if o != self.host.whoami and o not in missing_osds \
                        and all(o != ho for _, ho in holders):
                    holders.append((s, o))
            if not holders:
                self._pull_attempts.pop(oid, None)
                cb(-5)                   # nobody has it
                return
            attempt = self._pull_attempts.get(oid, 0)
            self._pull_attempts[oid] = attempt + 1
            self.recovery_ops[oid] = rec
            rec.push_after_pull = [
                (s, o) for s, o in missing_on
                if o is not None and o != self.host.whoami]
            shard, osd = holders[attempt % len(holders)]
            self.host.send_shard(osd, MOSDPGPull(
                pgid=self.host.pgid_str, shard=shard,
                from_osd=self.host.whoami, epoch=self.host.epoch,
                oids=[oid]))
            return
        self.recovery_ops[oid] = rec
        self._pull_attempts.pop(oid, None)   # completed via local copy
        self._push_to(rec, data, attrs, omap,
                      [(s, o) for s, o in missing_on
                       if o is not None and o != self.host.whoami])

    def _push_to(self, rec: _RecOp, data: bytes,
                 attrs: Dict[str, bytes], omap: Dict[str, bytes],
                 targets: List[Tuple[int, int]]) -> None:
        if not targets:
            self.recovery_ops.pop(rec.oid, None)
            rec.cb(0)
            return
        for shard, osd in targets:
            rec.pending.add(osd)
        for shard, osd in targets:
            self.host.send_shard(osd, MOSDPGPush(
                pgid=self.host.pgid_str, shard=shard,
                from_osd=self.host.whoami, epoch=self.host.epoch,
                pushes=[PushOp(oid=rec.oid, data=data, attrs=attrs,
                               omap=omap, version=rec.version)]))

    def _pulled(self, push: PushOp) -> None:
        """A pull answer landed and committed locally: forward the
        object to the remaining missing replicas."""
        rec = self.recovery_ops.get(push.oid)
        if rec is None:
            return
        self._pull_attempts.pop(push.oid, None)
        self._push_to(rec, push.data, dict(push.attrs),
                      dict(push.omap), rec.push_after_pull)

    def _apply_push(self, push: PushOp,
                    on_commit: Callable[[], None]) -> None:
        coll = self.host.coll
        obj = GHObject(push.oid, -1)
        # a LATE answer to an abandoned/rotated pull can arrive after
        # the object already advanced: never let an older version
        # overwrite newer bytes (strictly-newer check only — an
        # equal-version push is a scrub repair of corrupt data and
        # must apply)
        info = self.get_object_info(push.oid)
        if info is not None and \
                tuple(info.version) > tuple(push.version):
            on_commit()
            return
        txn = Transaction()
        # remove-then-recreate so stale attrs/omap don't survive
        txn.remove(coll, obj)
        txn.touch(coll, obj)
        if push.data:
            txn.write(coll, obj, 0, push.data)
        if push.attrs:
            txn.setattrs(coll, obj, push.attrs)
        if push.omap:
            txn.omap_setkeys(coll, obj, push.omap)

        def committed() -> None:
            self.host.note_object_recovered(push.oid, push.version)
            on_commit()
        txn.register_on_commit(
            lambda: self.host.on_local_commit(committed))
        self.host.store.queue_transactions([txn], op="recovery_push")

    def _push_acked(self, oid: str, osd: int) -> None:
        rec = self.recovery_ops.get(oid)
        if rec is None:
            return
        rec.pending.discard(osd)
        if not rec.pending:
            del self.recovery_ops[oid]
            rec.cb(0)

    # ------------------------------------------------------------------
    # message dispatch
    # ------------------------------------------------------------------
    def handle_message(self, msg) -> bool:
        if isinstance(msg, MOSDRepOp):
            span = self.host.trace_span(
                "rep_sub_write", msg.trace_id,
                getattr(msg, "parent_span_id", 0))
            if span is not None:
                span.tag("pgid", msg.pgid).tag("from",
                                               msg.from_osd).finish()
            txn = Transaction.decode(msg.txn)

            def _applied(m=msg):
                m.stamp_hop("store_apply")
                reply = MOSDRepOpReply(
                    pgid=self.host.pgid_str,
                    from_osd=self.host.whoami, tid=m.tid,
                    epoch=self.host.epoch)
                # ledger rides the round trip back to the primary
                if m.hops:
                    reply.hops = dict(m.hops)
                reply.stamp_hop("commit_sent")
                self.host.send_shard(m.from_osd, reply)
            self._apply_local(txn, msg.log_entries, _applied)
            return True
        if isinstance(msg, MOSDRepOpReply):
            # replica round-trip waterfall closes at the primary
            msg.stamp_hop("client_complete")
            _obs = getattr(self.host, "observe_hops", None)
            if _obs is not None:
                _obs(msg.hops)
            self._committed(msg.tid, msg.from_osd)
            return True
        if isinstance(msg, MOSDPGPush):
            for push in msg.pushes:
                rec = self.recovery_ops.get(push.oid)
                if rec is not None and not rec.pending:
                    # answer to our pull: apply locally, then fan out
                    self._apply_push(
                        push, lambda p=push: self._pulled(p))
                else:
                    self._apply_push(
                        push,
                        lambda p=push: self.host.send_shard(
                            msg.from_osd, MOSDPGPushReply(
                                pgid=self.host.pgid_str,
                                shard=msg.shard,
                                from_osd=self.host.whoami,
                                epoch=self.host.epoch, oids=[p.oid])))
            return True
        if isinstance(msg, MOSDPGPushReply):
            for oid in msg.oids:
                self._push_acked(oid, msg.from_osd)
            return True
        if isinstance(msg, MOSDPGPull):
            for oid in msg.oids:
                obj = GHObject(oid, -1)
                try:
                    data = self.host.store.read(self.host.coll, obj)
                    attrs = self.host.store.getattrs(self.host.coll,
                                                     obj)
                    omap = self.host.store.omap_get(self.host.coll,
                                                    obj)
                    info = self.get_object_info(oid)
                    ver = info.version if info else (0, 0)
                except OSError:
                    # missing or csum-EIO copy: either way we cannot
                    # serve it; silence lets the puller rotate to
                    # another holder
                    continue
                self.host.send_shard(msg.from_osd, MOSDPGPush(
                    pgid=self.host.pgid_str, shard=msg.shard,
                    from_osd=self.host.whoami, epoch=self.host.epoch,
                    pushes=[PushOp(oid=oid, data=data, attrs=attrs,
                                   omap=omap, version=ver)]))
            return True
        return False

    def inflight_writes(self) -> int:
        return len(self.in_flight)

    def build_scrub_map(self, deep: bool) -> Dict[str, dict]:
        """Full-object snapshot (reference be_scan_list; deep CRCs per
        ReplicatedBackend::be_deep_scrub, ReplicatedBackend.cc:614 —
        whole-object data hash, omap hash, attr hash)."""
        from ..utils.crc import crc32c
        out: Dict[str, dict] = {}
        store = self.host.store
        coll = self.host.coll
        conf = getattr(self.host, "conf", None)
        stride = conf["osd_deep_scrub_stride"] if conf else 512 << 10
        for obj in store.collection_list(coll):
            if obj.oid.startswith("_pgmeta"):
                continue
            try:
                st = store.stat(coll, obj)
                entry: Dict[str, object] = {"size": st.size}
                info = self.get_object_info(obj.oid)
                entry["oi_version"] = list(info.version) if info else None
                if deep:
                    # stride-wise CRC: bounded read buffer on huge
                    # objects (reference osd_deep_scrub_stride)
                    dc = 0
                    off = 0
                    while off < st.size:
                        dc = crc32c(store.read(coll, obj, off,
                                               stride), dc)
                        off += stride
                    entry["data_crc"] = dc
                    oc = 0
                    omap = store.omap_get(coll, obj)
                    for k in sorted(omap):
                        oc = crc32c(k.encode() + b"\0" + omap[k],
                                    oc)
                    entry["omap_crc"] = oc
                    ac = 0
                    attrs = store.getattrs(coll, obj)
                    for k in sorted(attrs):
                        ac = crc32c(k.encode() + b"\0" + attrs[k],
                                    ac)
                    entry["attrs_crc"] = ac
            except OSError:
                # missing OR store-csum EIO (BlockStore verify): both
                # scrub as read_error and repair via recovery
                entry = {"error": "read_error"}
            out[obj.oid] = entry
        return out

    def on_change(self) -> None:
        self.in_flight.clear()
        self.recovery_ops.clear()
        self._pull_attempts.clear()

"""Block images over RADOS objects: striping, snapshots, clones.

Python-native equivalent of the reference's librbd core (reference
``src/librbd/`` 85.7k LoC): images are a header object plus data
objects of ``2^order`` bytes (reference rbd_header.<id> +
rbd_data.<id>.<objectno>, ImageCtx::get_object_name), with snapshots
and copy-on-write clones.

Snapshots build on RADOS **selfmanaged snaps** exactly like the
reference (librbd snapshots ARE librados snap contexts resolved
inside the OSD): ``snap_create`` allocates a pool snap id and the
image's writes carry a SnapContext of its live snap ids, so the OSD
clones objects copy-on-write; snapshot reads set the read snap;
``snap_rollback`` rolls each data object back through the OSD's
rollback op; ``snap_rm`` releases the id and the OSD trimmer reclaims
the clones.  (An earlier iteration of this file implemented private
generation-based COW client-side; that predated the framework's RADOS
snapshot machinery.)

A clone records (parent image, snap); unwritten extents fall through
to the parent's snapshot view exactly like the reference's parent
overlap reads (librbd/io/ReadResult parent fallback), and ``flatten``
copies the parent data in and severs the link.

Header: ``rbd_header.<name>`` holds a JSON body (works on EC pools,
which have no omap) with size/order/snaps/parent.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from ..client.rados import IoCtx, RadosError

DEFAULT_ORDER = 22                    # 4 MiB objects, reference default
RBD_DIRECTORY = "rbd_directory"       # reference rbd_directory object


class ImageNotFound(RadosError):
    def __init__(self, name: str):
        super().__init__(2, f"image {name!r} not found")


def _header_oid(name: str) -> str:
    return f"rbd_header.{name}"


def _journal_oid(name: str) -> str:
    return f"rbd_journal.{name}"


def _journal_head_oid(name: str) -> str:
    return f"rbd_journal.{name}.head"


def _data_oid(name: str, objectno: int) -> str:
    return f"rbd_data.{name}.{objectno:016x}"


def _mirror_peer_oid(name: str) -> str:
    """Peer journal position at the PRIMARY site (reference: the
    rbd-mirror peer registers as a journal client and its committed
    position gates local trimming, journal/JournalTrimmer).  Lives
    outside the header so the mirror daemon's updates never race the
    lock holder's header saves."""
    return f"rbd_mirror.{name}.peer"


def _mirror_pos_oid(name: str) -> str:
    """Sync position at the SECONDARY site: highest primary journal
    seq already applied here."""
    return f"rbd_mirror.{name}.pos"


def _omap_oid(name: str, snap_id: Optional[int] = None) -> str:
    """Object-map object (reference rbd_object_map.<id> and
    rbd_object_map.<id>.<snapid>, librbd/object_map/)."""
    base = f"rbd_object_map.{name}"
    return base if snap_id is None else f"{base}.{snap_id}"


# object-map states, 2 bits per data object (reference
# cls/rbd/cls_rbd_types OBJECT_*): EXISTS means written since the
# last snapshot (the dirty bit fast-diff reads), EXISTS_CLEAN means
# present but untouched since then
OM_NONEXISTENT = 0
OM_EXISTS = 1
OM_EXISTS_CLEAN = 3


class RBD:
    """Pool-level image operations (reference librbd.h RBD class)."""

    def __init__(self, ioctx: IoCtx):
        self.ioctx = ioctx

    # -- directory (reference cls_rbd rbd_directory) -------------------
    def _dir(self) -> List[str]:
        try:
            raw = self.ioctx.read(RBD_DIRECTORY)
            return json.loads(raw.decode()) if raw else []
        except RadosError:
            return []

    def _dir_update(self, names: List[str]) -> None:
        self.ioctx.write_full(RBD_DIRECTORY,
                              json.dumps(sorted(names)).encode())

    def list(self) -> List[str]:
        return self._dir()

    def create(self, name: str, size: Optional[int] = None,
               order: Optional[int] = None,
               features: Optional[Tuple[str, ...]] = None) -> None:
        try:
            conf = self.ioctx.rados.conf     # the cluster's config
        except AttributeError:
            from ..utils.config import default_config
            conf = default_config()
        if size is None:
            size = conf["rbd_default_size"]
        if order is None:                # reference rbd_default_order
            order = conf["rbd_default_order"]
        if not 12 <= order <= 26:
            raise ValueError("order must be in [12, 26]")
        if conf["rbd_validate_names"] and (
                not name or any(c in name for c in "/@\0")):
            raise ValueError(f"invalid image name {name!r}")
        feats = set(features or ("layering",))
        if "fast-diff" in feats:
            feats.add("object-map")      # reference: fast-diff is an
                                         # object-map annotation
        if "object-map" in feats:
            # reference requires exclusive-lock under the object map;
            # this implementation additionally requires journaling —
            # the post-crash journal replay is what re-marks the
            # dirty bits an apply crash could lose, keeping fast-diff
            # exact without the reference's detained-update machinery
            if not {"exclusive-lock", "journaling"} <= feats:
                raise ValueError("object-map requires exclusive-lock "
                                 "+ journaling")
        features = tuple(sorted(feats))
        names = self._dir()
        if name in names:
            raise RadosError(17, f"image {name!r} exists")  # EEXIST
        header = {"size": size, "order": order, "snaps": {},
                  "parent": None, "hwm": size,
                  # reference image features (RBD_FEATURE_*):
                  # exclusive-lock gates writers through cls_lock;
                  # journaling WALs every data write for crash-
                  # consistent replay (librbd/exclusive_lock/ +
                  # librbd/journal/)
                  "features": list(features or ("layering",)),
                  "lock_gen": 0}
        self.ioctx.write_full(_header_oid(name),
                              json.dumps(header).encode())
        self._dir_update(names + [name])

    def remove(self, name: str) -> None:
        img = Image(self.ioctx, name)
        if img.header["snaps"]:
            raise RadosError(39, "image has snapshots")  # ENOTEMPTY
        img._remove_all_data()
        for oid in (_journal_oid(name), _journal_head_oid(name),
                    _omap_oid(name), _mirror_peer_oid(name),
                    _mirror_pos_oid(name)):
            try:
                self.ioctx.remove(oid)
            except RadosError:
                pass
        self.ioctx.remove(_header_oid(name))
        self._dir_update([n for n in self._dir() if n != name])

    def clone(self, parent_name: str, snap_name: str,
              child_name: str) -> None:
        """COW child of parent@snap (reference librbd clone: requires
        a protected snapshot; 'protected' here = we refuse snap
        removal while children exist, checked at snap_rm)."""
        parent = Image(self.ioctx, parent_name)
        snap = parent.header["snaps"].get(snap_name)
        if snap is None:
            raise RadosError(2, f"no snap {snap_name!r}")
        names = self._dir()
        if child_name in names:
            raise RadosError(17, f"image {child_name!r} exists")
        header = {"size": snap["size"], "order": parent.header["order"],
                  "snaps": {},
                  "parent": {"image": parent_name, "snap": snap_name},
                  "hwm": snap["size"]}
        self.ioctx.write_full(_header_oid(child_name),
                              json.dumps(header).encode())
        self._dir_update(names + [child_name])

    def children(self, parent_name: str, snap_name: str) -> List[str]:
        out = []
        for name in self._dir():
            try:
                p = Image(self.ioctx, name).header.get("parent")
            except ImageNotFound:
                continue
            if p and p["image"] == parent_name \
                    and p["snap"] == snap_name:
                out.append(name)
        return out


class Image:
    """One open image (reference librbd::Image / ImageCtx).
    ``snap_name`` opens a read-only snapshot view.

    Every image holds its OWN IoCtx (``dup``) so its SnapContext —
    derived from the header's live snaps, exactly the reference's
    ImageCtx::snapc — never races other images on the pool."""

    JOURNAL_TRIM_EVERY = 32

    def __init__(self, ioctx: IoCtx, name: str,
                 snap_name: Optional[str] = None):
        self.ioctx = ioctx.dup()
        self.name = name
        self.snap_name = snap_name
        self.header = self._load_header()
        if snap_name is not None and \
                snap_name not in self.header["snaps"]:
            raise RadosError(2, f"no snap {snap_name!r}")
        self._apply_snap_state()
        # exclusive lock state (reference librbd/exclusive_lock/):
        # acquired lazily on the first write when the feature is on
        import secrets
        self._lock_cookie = f"{secrets.randbits(48):x}"
        self._lock_held = False
        self._lock_gen = 0
        self._journal_seq = 0
        self._journal_uncommitted = 0
        # test hook: crash between the journal append and the data
        # apply (the window the WAL exists for)
        self._inject_crash_after_journal = False

    # -- features / exclusive lock (reference librbd/exclusive_lock/,
    #    built on cls_lock exactly like the reference) ----------------
    def has_feature(self, f: str) -> bool:
        return f in self.header.get("features", [])

    @property
    def _owner(self) -> str:
        return self.ioctx.rados.msgr.name

    def lock_info(self) -> Dict:
        import json as _json
        out = self.ioctx.exec_cls(
            _header_oid(self.name), "lock", "get_info",
            _json.dumps({"name": "rbd_lock"}).encode())
        return _json.loads(out.decode()) if out else {}

    def acquire_lock(self, force: bool = False) -> None:
        """Take the image's exclusive lock (reference
        ExclusiveLock<I>::acquire_lock): bumps the lock GENERATION in
        the header and fences the journal at it, so a previous
        holder's in-flight journal appends are rejected inside the
        OSD (cls_fence — the same primitive that fences a zombie
        MDS).  ``force`` breaks a dead holder's lock first (reference
        break-lock on client eviction), then REPLAYS its journal so
        no acked write is lost."""
        import json as _json
        if self._lock_held:
            return
        hoid = _header_oid(self.name)
        req = {"name": "rbd_lock", "type": "exclusive",
               "owner": self._owner, "cookie": self._lock_cookie,
               "tag": "rbd"}
        try:
            self.ioctx.exec_cls(hoid, "lock", "lock",
                                _json.dumps(req).encode())
        except RadosError as e:
            if e.errno not in (16, 17):  # not a lock conflict:
                raise                    # surface the real error
            if not force:
                raise RadosError(16, f"image {self.name} is locked "
                                 f"by another client")
            info = self.lock_info()
            for locker in list(info.get("lockers", {})):
                owner, _, cookie = locker.partition(" ")
                self.ioctx.exec_cls(
                    hoid, "lock", "break_lock",
                    _json.dumps({"name": "rbd_lock",
                                 "locker_owner": owner,
                                 "locker_cookie": cookie}).encode())
            self.ioctx.exec_cls(hoid, "lock", "lock",
                                _json.dumps(req).encode())
        # generation bump under the lock; persists before any write
        self.header = self._load_header()
        self._lock_gen = self.header.get("lock_gen", 0) + 1
        self.header["lock_gen"] = self._lock_gen
        self._save_header()
        self._lock_held = True
        if self.has_feature("journaling"):
            self.ioctx.exec_cls(
                _journal_oid(self.name), "fence", "set",
                _json.dumps({"epoch": self._lock_gen}).encode())
            self._replay_journal()

    def _assert_lock_owned(self) -> None:
        info = self.lock_info()
        key = f"{self._owner} {self._lock_cookie}"
        if key not in info.get("lockers", {}):
            self._lock_held = False
            raise RadosError(108, f"image {self.name}: exclusive "
                             f"lock lost (another client broke it)")

    def release_lock(self) -> None:
        if not self._lock_held:
            return
        import json as _json
        if self.has_feature("journaling"):
            try:
                self._journal_commit()   # clean handoff: empty journal
            except RadosError:
                pass                     # evicted: successor owns it
        try:
            self.ioctx.exec_cls(
                _header_oid(self.name), "lock", "unlock",
                _json.dumps({"name": "rbd_lock",
                             "owner": self._owner,
                             "cookie": self._lock_cookie}).encode())
        except RadosError:
            pass                         # broken by a successor: fine
        self._lock_held = False

    def close(self) -> None:
        self.release_lock()

    def __enter__(self) -> "Image":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- journaling (reference librbd/journal/: WAL before data) ------
    def _journal_append(self, offset: int, data: bytes) -> None:
        import base64
        self._journal_event({"off": offset,
                             "data": base64.b64encode(data).decode()})

    def _journal_event(self, ev: dict) -> None:
        import json as _json
        self._journal_seq += 1
        line = _json.dumps(dict(ev, seq=self._journal_seq)) + "\n"
        try:
            self.ioctx.exec_cls(
                _journal_oid(self.name), "fence", "guarded_append",
                _json.dumps({"epoch": self._lock_gen,
                             "data": line}).encode())
        except RadosError as e:
            if e.errno == 1:             # EPERM: fenced — lock lost
                self._lock_held = False
                raise RadosError(
                    108, f"image {self.name}: exclusive lock lost "
                    f"(another client acquired it)")
            raise

    def _journal_commit(self) -> None:
        """Data writes up to the current seq are durable: advance the
        committed watermark and trim (reference journal commit +
        trim).  With mirroring enabled, trimming additionally waits
        for the peer's committed position (reference: journal clients
        gate trimming, journal/JournalTrimmer) — the journal IS the
        replication stream, so entries the peer has not consumed are
        retained."""
        import json as _json
        head = _json.dumps({"committed": self._journal_seq})
        mirror = self.header.get("mirror") or {}
        trim = True
        if mirror.get("enabled"):
            try:
                peer = _json.loads(self.ioctx.read(
                    _mirror_peer_oid(self.name)).decode())
            except (RadosError, ValueError):
                peer = {"committed": 0}
            trim = peer.get("committed", 0) >= self._journal_seq
        try:
            self.ioctx.exec_cls(
                _journal_head_oid(self.name), "fence",
                "guarded_write_full",
                _json.dumps({"epoch": self._lock_gen,
                             "data": head}).encode())
            if trim:
                self.ioctx.exec_cls(
                    _journal_oid(self.name), "fence",
                    "guarded_truncate",
                    _json.dumps({"epoch": self._lock_gen,
                                 "size": 0}).encode())
        except RadosError as e:
            if e.errno == 1:
                self._lock_held = False
                raise RadosError(108, "exclusive lock lost")
            if e.errno != 2:
                raise
        self._journal_uncommitted = 0

    def _replay_journal(self) -> None:
        """Apply journal events past the committed watermark to the
        data objects (reference librbd journal replay on open): a
        holder that died between append and apply loses nothing."""
        import base64
        import json as _json
        try:
            head = _json.loads(self.ioctx.read(
                _journal_head_oid(self.name)).decode())
        except (RadosError, ValueError):
            head = {"committed": 0}
        committed = head.get("committed", 0)
        try:
            raw = self.ioctx.read(_journal_oid(self.name))
        except RadosError:
            raw = b""
        replayed = 0
        top = committed
        for line in raw.splitlines():
            if not line.strip():
                continue
            try:
                ev = _json.loads(line.decode())
            except ValueError:
                continue
            top = max(top, ev["seq"])
            if ev["seq"] <= committed:
                continue
            if "resize" in ev:
                self._apply_resize(ev["resize"])
            else:
                self._apply_write(ev["off"],
                                  base64.b64decode(ev["data"]))
            replayed += 1
        self._journal_seq = top
        if replayed:
            self._journal_commit()

    # -- header --------------------------------------------------------
    def _load_header(self) -> Dict:
        try:
            return json.loads(self.ioctx.read(
                _header_oid(self.name)).decode())
        except RadosError:
            raise ImageNotFound(self.name)

    def _save_header(self) -> None:
        self.ioctx.write_full(_header_oid(self.name),
                              json.dumps(self.header).encode())

    def _apply_snap_state(self) -> None:
        """Install the image's write SnapContext + read snap on its
        private ioctx (reference ImageCtx::snapc / snap_id)."""
        sids = sorted((s["id"] for s in
                       self.header["snaps"].values()), reverse=True)
        self.ioctx.set_snap_context(sids[0] if sids else 0, sids)
        if self.snap_name is not None:
            self.ioctx.snap_set_read(
                self.header["snaps"][self.snap_name]["id"])
        else:
            self.ioctx.snap_set_read(0)

    @property
    def object_size(self) -> int:
        return 1 << self.header["order"]

    def size(self) -> int:
        if self.snap_name is not None:
            return self.header["snaps"][self.snap_name]["size"]
        return self.header["size"]

    def stat(self) -> Dict:
        return {"size": self.size(), "order": self.header["order"],
                "object_size": self.object_size,
                "num_objs": (self.size() + self.object_size - 1)
                // self.object_size,
                "snapshot_count": len(self.header["snaps"]),
                "parent": self.header.get("parent")}

    def _n_objs(self, size: Optional[int] = None) -> int:
        s = self.header["size"] if size is None else size
        return (s + self.object_size - 1) // self.object_size

    # -- object resolution ---------------------------------------------
    def _read_object(self, objectno: int) -> bytes:
        """This view's content of one data object; falls through to
        the parent snapshot view when cloned and the child object does
        not exist at this view (reference parent overlap read)."""
        try:
            return self.ioctx.read(_data_oid(self.name, objectno))
        except RadosError:
            pass
        parent = self.header.get("parent")
        if parent is not None:
            try:
                pimg = Image(self.ioctx, parent["image"],
                             snap_name=parent["snap"])
            except RadosError:
                return b""
            off = objectno * self.object_size
            plen = min(self.object_size, max(0, pimg.size() - off))
            if plen <= 0:
                return b""
            return pimg.read(off, plen)
        return b""

    def _object_exists(self, objectno: int) -> bool:
        try:
            self.ioctx.stat(_data_oid(self.name, objectno))
            return True
        except RadosError:
            return False

    # -- mirroring control (reference librbd/mirror/ +
    # cls_rbd mirror_image state; the data path lives in
    # rbd/mirror.py's MirrorDaemon) ------------------------------------
    def mirror_enable(self, primary: bool = True) -> None:
        """Mark the image for journal-based mirroring (reference
        rbd mirror image enable, mode journal): requires the
        journaling feature — the journal is the replication
        stream."""
        if not self.has_feature("journaling"):
            raise RadosError(22, "mirroring needs the journaling "
                             "feature")
        self.header["mirror"] = {"enabled": True, "primary": primary}
        self._save_header()

    def mirror_disable(self) -> None:
        self.header.pop("mirror", None)
        self._save_header()
        try:
            self.ioctx.remove(_mirror_peer_oid(self.name))
        except RadosError:
            pass

    def mirror_promote(self) -> None:
        """Make this site's copy the writable primary (reference rbd
        mirror image promote — failover step 2, after demoting or
        losing the old primary)."""
        m = self.header.get("mirror")
        if not m or not m.get("enabled"):
            raise RadosError(22, "mirroring not enabled")
        m["primary"] = True
        self._save_header()

    def mirror_demote(self) -> None:
        """Primary -> non-primary (failover step 1): further writes
        here are refused until promoted again."""
        m = self.header.get("mirror")
        if not m or not m.get("enabled"):
            raise RadosError(22, "mirroring not enabled")
        m["primary"] = False
        self._save_header()

    def mirror_status(self) -> Dict:
        m = dict(self.header.get("mirror") or {})
        import json as _json
        try:
            m["peer_committed"] = _json.loads(self.ioctx.read(
                _mirror_peer_oid(self.name)).decode()).get(
                    "committed", 0)
        except (RadosError, ValueError):
            pass
        m["journal_seq"] = self._journal_seq
        return m

    def _assert_writable(self) -> None:
        m = self.header.get("mirror") or {}
        if m.get("enabled") and not m.get("primary", True):
            raise RadosError(30, f"image {self.name} is a "
                             f"non-primary mirror (promote first)")

    # -- object map (reference librbd/object_map/: 2-bit per-object
    # state under the exclusive lock; dirty bits power fast-diff,
    # existence bits power fast delete/du) -----------------------------
    def _om_load(self, snap_id: Optional[int] = None) -> bytearray:
        try:
            return bytearray(self.ioctx.read(
                _omap_oid(self.name, snap_id)))
        except RadosError:
            return bytearray()

    def _om_save(self, om: bytearray,
                 snap_id: Optional[int] = None) -> None:
        self.ioctx.write_full(_omap_oid(self.name, snap_id),
                              bytes(om))

    @staticmethod
    def _om_get(om: bytearray, objno: int) -> int:
        byte = objno // 4
        if byte >= len(om):
            return OM_NONEXISTENT
        return (om[byte] >> ((objno % 4) * 2)) & 3

    @staticmethod
    def _om_set(om: bytearray, objno: int, state: int) -> None:
        byte = objno // 4
        while len(om) <= byte:
            om.append(0)
        shift = (objno % 4) * 2
        om[byte] = (om[byte] & ~(3 << shift)) | (state << shift)

    def _om_mark(self, objnos, state: int) -> None:
        """Batch state transition, one read-modify-write (single
        writer: the exclusive lock the feature requires)."""
        if not self.has_feature("object-map") \
                or self.snap_name is not None:
            return
        om = self._om_load()
        for objno in objnos:
            self._om_set(om, objno, state)
        self._om_save(om)

    def rebuild_object_map(self) -> None:
        """Re-derive the map from actual object existence (reference
        object_map_rebuild): recovers from any drift; rebuilt objects
        mark EXISTS (dirty) so the next fast-diff over-reports rather
        than misses."""
        om = bytearray()
        hwm = max(self.header.get("hwm", 0), self.header["size"])
        for objno in range(self._n_objs(hwm)):
            try:
                self.ioctx.stat(_data_oid(self.name, objno))
                self._om_set(om, objno, OM_EXISTS)
            except RadosError:
                pass
        self._om_save(om)

    def fast_diff(self, from_snap: str,
                  to_snap: Optional[str] = None) -> List[int]:
        """Data objects possibly changed between two points in time
        (reference fast-diff / DiffIterate with whole-object=true):
        the union of every intermediate snapshot map's dirty bits
        plus the endpoint's — each snap map's EXISTS bits mean
        "written since the PREVIOUS snap", so the union covers the
        whole interval; deletions show as existence flips."""
        if not self.has_feature("object-map"):
            raise RadosError(95, "fast-diff needs the object-map "
                             "feature")
        snaps = self.snap_list()                 # id-ascending
        from_meta = self.header["snaps"].get(from_snap)
        if from_meta is None:
            raise RadosError(2, f"no snap {from_snap!r}")
        if to_snap is not None and \
                to_snap not in self.header["snaps"]:
            raise RadosError(2, f"no snap {to_snap!r}")
        maps = []
        for s in snaps:
            if s["id"] <= from_meta["id"]:
                continue
            if to_snap is not None and \
                    s["id"] > self.header["snaps"][to_snap]["id"]:
                break
            maps.append(self._om_load(s["id"]))
        if to_snap is None:
            maps.append(self._om_load())         # head
        from_map = self._om_load(from_meta["id"])
        end_map = maps[-1] if maps else from_map
        hwm = max(self.header.get("hwm", 0), self.header["size"])
        changed = []
        for objno in range(self._n_objs(hwm)):
            dirty = any(self._om_get(m, objno) == OM_EXISTS
                        for m in maps)
            flipped = (self._om_get(from_map, objno) == 0) != \
                (self._om_get(end_map, objno) == 0)
            if dirty or flipped:
                changed.append(objno)
        return changed

    # -- IO ------------------------------------------------------------
    def read(self, offset: int, length: int) -> bytes:
        size = self.size()
        if offset >= size:
            return b""
        length = min(length, size - offset)
        out = bytearray(length)
        osize = self.object_size
        pos = offset
        while pos < offset + length:
            objectno = pos // osize
            o_off = pos % osize
            run = min(osize - o_off, offset + length - pos)
            data = self._read_object(objectno)
            chunk = data[o_off:o_off + run]
            out[pos - offset:pos - offset + len(chunk)] = chunk
            pos += run
        return bytes(out)

    def write(self, offset: int, data: bytes) -> None:
        if self.snap_name is not None:
            raise RadosError(30, "snapshot views are read-only")
        self._assert_writable()
        size = self.header["size"]
        if offset + len(data) > size:
            raise RadosError(27, "write past image end")  # EFBIG
        if self.has_feature("exclusive-lock") or \
                self.has_feature("journaling"):
            self.acquire_lock()          # lazy auto-acquire
            if not self.has_feature("journaling"):
                # journaled writes are fenced inside the OSD; without
                # journaling the only zombie defense is verifying
                # ownership (the reference blocklists evicted clients
                # at the OSDMap instead)
                self._assert_lock_owned()
        if self.has_feature("journaling"):
            # WAL: the event is durable (and fenced to our lock
            # generation) BEFORE any data object changes
            self._journal_append(offset, data)
            if self._inject_crash_after_journal:
                return                   # test hook: "crash" here
        self._apply_write(offset, data)
        if self.has_feature("journaling"):
            self._journal_uncommitted += 1
            if self._journal_uncommitted >= self.JOURNAL_TRIM_EVERY:
                self._journal_commit()

    def _apply_write(self, offset: int, data: bytes) -> None:
        osize = self.object_size
        pos = offset
        touched = []
        while pos < offset + len(data):
            objectno = pos // osize
            o_off = pos % osize
            run = min(osize - o_off, offset + len(data) - pos)
            oid = _data_oid(self.name, objectno)
            if self.header.get("parent") is not None \
                    and not self._object_exists(objectno):
                # clone COW: promote the parent's content first
                base = self._read_object(objectno)
                if base:
                    self.ioctx.write_full(oid, base)
            # snapshot COW happens INSIDE the OSD: the write carries
            # the image's SnapContext and the object clones itself
            self.ioctx.write(oid, data[pos - offset:pos - offset
                                       + run], o_off)
            touched.append(objectno)
            pos += run
        # object map AFTER the data (journal replay re-marks across
        # an apply crash, so the dirty bits stay exact — the create-
        # time journaling requirement exists for exactly this)
        self._om_mark(touched, OM_EXISTS)

    def resize(self, new_size: int) -> None:
        if self.snap_name is not None:
            raise RadosError(30, "snapshot views are read-only")
        self._assert_writable()
        if self.has_feature("exclusive-lock") or \
                self.has_feature("journaling"):
            self.acquire_lock()
        if self.has_feature("journaling"):
            # resize rides the journal like writes: replay restores
            # it after a crash, and the mirror peer re-applies it at
            # the OBJECT level (a header-only copy would leave the
            # secondary's truncated objects behind and the sites
            # would silently diverge on a shrink-then-grow)
            self._journal_event({"resize": new_size})
        self._apply_resize(new_size)
        if self.has_feature("journaling"):
            self._journal_uncommitted += 1
            if self._journal_uncommitted >= self.JOURNAL_TRIM_EVERY:
                self._journal_commit()

    def _apply_resize(self, new_size: int) -> None:
        old = self.header["size"]
        self.header["size"] = new_size
        # high-water mark: whiteouts from clone shrinks can sit past
        # the current size; removal must scan that far
        self.header["hwm"] = max(self.header.get("hwm", 0), old,
                                 new_size)
        self._save_header()
        if new_size < old:
            # truncates/removes carry the snap context too, so
            # snapshot views keep their bytes (OSD-side clones) while
            # the head sheds them; a later grow re-exposes zeros.
            # CLONES need whiteouts: removing a never-written child
            # object is a no-op and the parent fallthrough would
            # re-expose the parent's bytes after a grow — an empty
            # head object blocks it.
            osize = self.object_size
            parent = self.header.get("parent")
            first_gone = (new_size + osize - 1) // osize
            for objectno in range(first_gone, self._n_objs(old)):
                oid = _data_oid(self.name, objectno)
                try:
                    self.ioctx.remove(oid)
                except RadosError:
                    pass
                if parent is not None:
                    self.ioctx.write_full(oid, b"")   # whiteout
            self._om_mark(range(first_gone, self._n_objs(old)),
                          OM_EXISTS if parent is not None
                          else OM_NONEXISTENT)
            if new_size % osize:
                objectno = new_size // osize
                oid = _data_oid(self.name, objectno)
                if self._object_exists(objectno):
                    try:
                        self.ioctx.truncate(oid, new_size % osize)
                    except RadosError:
                        pass
                elif parent is not None:
                    # materialize the clamped parent content so the
                    # tail past new_size reads zeros after a grow
                    data = self._read_object(objectno)
                    self.ioctx.write_full(oid,
                                          data[:new_size % osize])

    # -- snapshots (reference librbd snap_create/rollback/remove on
    # selfmanaged snaps) ----------------------------------------------
    def snap_create(self, snap_name: str) -> None:
        self._assert_writable()
        if snap_name in self.header["snaps"]:
            raise RadosError(17, f"snap {snap_name!r} exists")
        sid = self.ioctx.selfmanaged_snap_create()
        self.header["snaps"][snap_name] = {
            "id": sid, "size": self.header["size"]}
        if self.has_feature("object-map"):
            # freeze the map at the snap and reset the head's dirty
            # bits: from here on EXISTS means "written since THIS
            # snap" (reference snapshot object maps)
            om = self._om_load()
            self._om_save(om, sid)
            for objno in range(len(om) * 4):
                if self._om_get(om, objno) == OM_EXISTS:
                    self._om_set(om, objno, OM_EXISTS_CLEAN)
            self._om_save(om)
        self._save_header()
        self._apply_snap_state()

    def snap_list(self) -> List[Dict]:
        return [{"name": n, **meta} for n, meta in
                sorted(self.header["snaps"].items(),
                       key=lambda kv: kv[1]["id"])]

    def snap_rm(self, snap_name: str) -> None:
        self._assert_writable()
        snap = self.header["snaps"].get(snap_name)
        if snap is None:
            raise RadosError(2, f"no snap {snap_name!r}")
        children = RBD(self.ioctx).children(self.name, snap_name)
        if children:
            raise RadosError(16, f"snap in use by clones {children}")
        del self.header["snaps"][snap_name]
        self._save_header()
        self._apply_snap_state()
        try:
            self.ioctx.remove(_omap_oid(self.name, snap["id"]))
        except RadosError:
            pass
        # release the id: the OSD snap trimmer reclaims the clones
        self.ioctx.selfmanaged_snap_remove(snap["id"])

    def snap_rollback(self, snap_name: str) -> None:
        """Roll every data object back to the snapshot through the
        OSD's rollback op (reference librbd snap_rollback ->
        rados selfmanaged_snap_rollback per object)."""
        self._assert_writable()
        snap = self.header["snaps"].get(snap_name)
        if snap is None:
            raise RadosError(2, f"no snap {snap_name!r}")
        old_size = self.header["size"]
        self.header["size"] = snap["size"]
        max_objs = self._n_objs(max(snap["size"], old_size))
        for objectno in range(max_objs):
            try:
                self.ioctx.selfmanaged_snap_rollback(
                    _data_oid(self.name, objectno), snap["id"])
            except RadosError:
                pass
        if self.has_feature("object-map"):
            om = self._om_load(snap["id"])
            for objno in range(len(om) * 4):
                if self._om_get(om, objno) == OM_EXISTS_CLEAN:
                    self._om_set(om, objno, OM_EXISTS)  # content moved
            self._om_save(om)
        self._save_header()

    # -- clones --------------------------------------------------------
    def flatten(self) -> None:
        """Copy all parent-provided data in and sever the parent link
        (reference librbd flatten)."""
        self._assert_writable()
        parent = self.header.get("parent")
        if parent is None:
            return
        copied = []
        for objectno in range(self._n_objs()):
            if self._object_exists(objectno):
                continue
            data = self._read_object(objectno)
            if data:
                self.ioctx.write_full(_data_oid(self.name, objectno),
                                      data)
                copied.append(objectno)
        self._om_mark(copied, OM_EXISTS)
        self.header["parent"] = None
        self._save_header()

    # -- maintenance ---------------------------------------------------
    def _remove_all_data(self) -> None:
        # no live snaps by contract (RBD.remove refuses otherwise),
        # so plain removes reclaim everything; scan to the high-water
        # size so shrink-era whiteouts go too
        hwm = max(self.header.get("hwm", 0), self.header["size"])
        for objectno in range(self._n_objs(hwm)):
            try:
                self.ioctx.remove(_data_oid(self.name, objectno))
            except RadosError:
                pass

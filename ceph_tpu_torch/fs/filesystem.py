"""POSIX-style file hierarchy over RADOS.

Python-native equivalent of the reference's file service (reference
``src/mds/`` 86.6k LoC metadata cluster + ``src/client/`` 25.2k LoC),
collapsed to its storage model: CephFS stores directories as RADOS
objects whose omap maps dentry name -> inode (reference CDir backed
by omap in the metadata pool), per-inode metadata, and file DATA as
striped objects named by inode in the data pool (reference
``<ino>.<objectno>`` via file_layout_t — here through the striper).

What the MDS adds on top — client sessions, capability leases,
journaled metadata updates, subtree partitioning for multi-MDS — is
collapsed into direct RADOS access: each metadata mutation is one
atomic omap/object op (per-object ordering from the OSD gives
per-directory serialization), and concurrent conflicting renames
resolve last-writer-wins instead of through cap revocation.  Inode
numbers are allocated through the ``version`` object class as an
atomic counter (reference MDS inotable).

Layout (metadata pool):
  ``fs.inotable``        cls_version counter -> next inode number
  ``dir.<ino>``          directory: omap dentry -> {"ino", "type"}
  ``ino.<ino>``          inode record: JSON {type,size,mtime,mode}
Data pool: striped entity ``data.<ino>`` per regular file.
"""
from __future__ import annotations

import json
import stat as statmod
import time
from typing import Dict, List, Optional, Tuple

from ..client.rados import IoCtx, RadosError
from ..client.striper import Layout, StripedIoCtx

ROOT_INO = 1
DIR_TYPE = "dir"
FILE_TYPE = "file"


class FSError(OSError):
    pass


def _dir_oid(ino: int) -> str:
    return f"dir.{ino}"


def _ino_oid(ino: int) -> str:
    return f"ino.{ino}"


def _data_soid(ino: int) -> str:
    return f"data.{ino}"


def parent_path(path: str) -> str:
    """Parent directory of an absolute path ('/' is its own)."""
    p = "/" + path.strip("/")
    return "/" if p == "/" else (p.rsplit("/", 1)[0] or "/")


def pin_rank_of(pins, path: str) -> int:
    """Longest-prefix subtree-pin match -> authoritative MDS rank
    (default 0).  THE routing rule, shared by the MDS daemon and the
    client so the two can never drift (reference
    Client::choose_target_mds vs the server's subtree auth)."""
    p = "/" + path.strip("/")
    best, rank = -1, 0
    for pin, r in (pins or {}).items():
        pin = "/" + pin.strip("/")
        if (p == pin or p.startswith(pin + "/")) and len(pin) > best:
            best, rank = len(pin), int(r)
    return rank


class FileSystem:
    """One mounted filesystem view (reference libcephfs Client).
    ``meta`` must be a replicated pool (omap); ``data`` may be any
    pool (EC data pools work, like the reference's EC data pools)."""

    def __init__(self, meta: IoCtx, data: Optional[IoCtx] = None,
                 layout: Optional[Layout] = None):
        self.meta = meta
        self.data = data or meta
        if layout is None:
            # fs_default_* options (reference fs_types default layout;
            # stripe_count stays 1 here — the daemonless library mode
            # keeps objects self-contained per stripe unit)
            try:
                conf = meta.rados.conf   # the cluster's config
            except AttributeError:
                from ..utils.config import default_config
                conf = default_config()
            layout = Layout(
                stripe_unit=conf["fs_default_stripe_unit"],
                stripe_count=1,
                object_size=conf["fs_default_object_size"])
        self.striper = StripedIoCtx(self.data, layout)
        self._ensure_root()

    # -- bootstrap -----------------------------------------------------
    def _ensure_root(self) -> None:
        try:
            self.meta.read(_ino_oid(ROOT_INO))
        except RadosError:
            self._write_inode(ROOT_INO, DIR_TYPE, 0)
            self.meta.create(_dir_oid(ROOT_INO))
            self.meta.exec_cls("fs.inotable", "version", "set",
                              json.dumps({"ver": ROOT_INO}).encode())

    def _alloc_ino(self) -> int:
        out = self.meta.exec_cls("fs.inotable", "version", "inc", b"")
        return int(json.loads(out.decode())["ver"])

    # -- inode records -------------------------------------------------
    def _write_inode(self, ino: int, typ: str, size: int,
                     mode: int = 0o644) -> None:
        self.meta.write_full(_ino_oid(ino), json.dumps(
            {"ino": ino, "type": typ, "size": size, "mode": mode,
             "mtime": time.time()}).encode())

    def _read_inode(self, ino: int) -> Dict:
        try:
            return json.loads(self.meta.read(_ino_oid(ino)).decode())
        except RadosError:
            raise FSError(2, f"inode {ino} missing")

    # -- path walking (reference Client::path_walk) --------------------
    @staticmethod
    def _parts(path: str) -> List[str]:
        parts = [p for p in path.split("/") if p]
        for p in parts:
            if p in (".", ".."):
                raise FSError(22, "'.'/'..' not supported")
        return parts

    def _lookup(self, parent_ino: int, name: str) -> Optional[Dict]:
        try:
            raw = self.meta.omap_get_by_key(_dir_oid(parent_ino),
                                            name)
        except RadosError as e:
            if e.errno == 2:             # dir object gone/empty
                return None
            raise
        return json.loads(raw.decode()) if raw is not None else None

    def _resolve(self, path: str) -> Tuple[int, Dict]:
        """path -> (ino, dentry-ish {ino, type}); root is synthetic."""
        cur = {"ino": ROOT_INO, "type": DIR_TYPE}
        for name in self._parts(path):
            if cur["type"] != DIR_TYPE:
                raise FSError(20, f"not a directory: {name}")
            nxt = self._lookup(cur["ino"], name)
            if nxt is None:
                raise FSError(2, f"no such entry: {name!r}")
            cur = nxt
        return cur["ino"], cur

    def _resolve_parent(self, path: str) -> Tuple[int, str]:
        parts = self._parts(path)
        if not parts:
            raise FSError(22, "root has no parent")
        parent = "/".join(parts[:-1])
        ino, ent = self._resolve(parent)
        if ent["type"] != DIR_TYPE:
            raise FSError(20, f"not a directory: {parent!r}")
        return ino, parts[-1]

    # -- directories ---------------------------------------------------
    def mkdir(self, path: str) -> int:
        parent, name = self._resolve_parent(path)
        if self._lookup(parent, name) is not None:
            raise FSError(17, f"exists: {path!r}")
        ino = self._alloc_ino()
        self._write_inode(ino, DIR_TYPE, 0)
        self.meta.create(_dir_oid(ino))
        self._link(parent, name, ino, DIR_TYPE)
        return ino

    def listdir(self, path: str = "/") -> List[Dict]:
        ino, ent = self._resolve(path)
        if ent["type"] != DIR_TYPE:
            raise FSError(20, f"not a directory: {path!r}")
        try:
            omap = self.meta.omap_get(_dir_oid(ino))
        except RadosError:
            return []
        out = []
        for name in sorted(omap):
            d = json.loads(omap[name].decode())
            out.append({"name": name, **d})
        return out

    def rmdir(self, path: str) -> None:
        parent, name = self._resolve_parent(path)
        ent = self._lookup(parent, name)
        if ent is None:
            raise FSError(2, path)
        if ent["type"] != DIR_TYPE:
            raise FSError(20, path)
        try:
            if self.meta.omap_get(_dir_oid(ent["ino"])):
                raise FSError(39, f"directory not empty: {path!r}")
        except RadosError as e:
            if e.errno != 2:
                # transient failure must NOT read as "empty" — that
                # would rmdir a populated directory and orphan its
                # subtree
                raise
        self._unlink(parent, name)
        self._remove_oid(_dir_oid(ent["ino"]))
        self._remove_oid(_ino_oid(ent["ino"]))

    def _link(self, parent: int, name: str, ino: int,
              typ: str) -> None:
        self.meta.omap_set(_dir_oid(parent), {name: json.dumps(
            {"ino": ino, "type": typ}).encode()})

    def _unlink(self, parent: int, name: str) -> None:
        self.meta.omap_rm_keys(_dir_oid(parent), [name])

    def _remove_oid(self, oid: str) -> None:
        try:
            self.meta.remove(oid)
        except RadosError:
            pass

    # -- files ---------------------------------------------------------
    def create(self, path: str) -> int:
        parent, name = self._resolve_parent(path)
        existing = self._lookup(parent, name)
        if existing is not None:
            if existing["type"] != FILE_TYPE:
                raise FSError(21, f"is a directory: {path!r}")
            return existing["ino"]
        ino = self._alloc_ino()
        self._write_inode(ino, FILE_TYPE, 0)
        self._link(parent, name, ino, FILE_TYPE)
        return ino

    def write_file(self, path: str, data: bytes,
                   offset: int = 0) -> None:
        ino = self.create(path)
        self.striper.write(_data_soid(ino), data, offset)
        node = self._read_inode(ino)
        new_size = max(node["size"], offset + len(data))
        self._write_inode(ino, FILE_TYPE, new_size,
                          node.get("mode", 0o644))

    def read_file(self, path: str, length: int = 0,
                  offset: int = 0) -> bytes:
        ino, ent = self._resolve(path)
        if ent["type"] != FILE_TYPE:
            raise FSError(21, f"is a directory: {path!r}")
        node = self._read_inode(ino)
        if node["size"] == 0 or offset >= node["size"]:
            return b""
        try:
            return self.striper.read(_data_soid(ino), length, offset)
        except RadosError:
            return b""                   # created but never written

    def truncate(self, path: str, size: int) -> None:
        ino, ent = self._resolve(path)
        if ent["type"] != FILE_TYPE:
            raise FSError(21, path)
        node = self._read_inode(ino)
        try:
            self.striper.truncate(_data_soid(ino), size)
        except RadosError:
            if size:
                raise
        self._write_inode(ino, FILE_TYPE, size,
                          node.get("mode", 0o644))

    def unlink(self, path: str) -> None:
        parent, name = self._resolve_parent(path)
        ent = self._lookup(parent, name)
        if ent is None:
            raise FSError(2, path)
        if ent["type"] == DIR_TYPE:
            raise FSError(21, f"is a directory: {path!r}")
        self._unlink(parent, name)
        try:
            self.striper.remove(_data_soid(ent["ino"]))
        except RadosError:
            pass
        self._remove_oid(_ino_oid(ent["ino"]))

    def rename(self, old: str, new: str) -> None:
        """reference Server::handle_client_rename, collapsed: relink
        the dentry; overwriting an existing file target unlinks it."""
        oparts = self._parts(old)
        nparts = self._parts(new)
        oparent, oname = self._resolve_parent(old)
        ent = self._lookup(oparent, oname)
        if ent is None:
            raise FSError(2, old)
        if oparts == nparts:
            return                       # POSIX: rename(p, p) no-op
        if ent["type"] == DIR_TYPE and nparts[:len(oparts)] == oparts:
            # moving a directory into its own subtree would orphan it
            raise FSError(22, f"cannot move {old!r} into itself")
        nparent, nname = self._resolve_parent(new)
        target = self._lookup(nparent, nname)
        if target is not None:
            if target["type"] == DIR_TYPE:
                raise FSError(21, f"target is a directory: {new!r}")
            if ent["type"] == DIR_TYPE:
                raise FSError(20, f"cannot overwrite file with dir")
            self.unlink(new)
        self._link(nparent, nname, ent["ino"], ent["type"])
        self._unlink(oparent, oname)

    # -- stat ----------------------------------------------------------
    def stat(self, path: str) -> Dict:
        ino, ent = self._resolve(path)
        node = self._read_inode(ino)
        node["st_mode"] = (statmod.S_IFDIR
                           if node["type"] == DIR_TYPE
                           else statmod.S_IFREG) | node.get("mode",
                                                           0o644)
        return node

    def exists(self, path: str) -> bool:
        try:
            self._resolve(path)
            return True
        except FSError:
            return False

    # -- recursive helpers (CLI convenience) ---------------------------
    def walk(self, path: str = "/"):
        """Yield (dirpath, dirnames, filenames) like os.walk."""
        entries = self.listdir(path)
        dirs = [e["name"] for e in entries if e["type"] == DIR_TYPE]
        files = [e["name"] for e in entries if e["type"] == FILE_TYPE]
        yield path, dirs, files
        for d in dirs:
            sub = path.rstrip("/") + "/" + d
            yield from self.walk(sub)

"""Key/value store abstraction.

Python-native equivalent of the reference's KeyValueDB seam (reference
src/kv/KeyValueDB.h with RocksDB/LevelDB/MemDB backends): sorted
string keys with bytes values, atomic write batches, prefix-range
iteration.  Backends here: MemDB (dict) and LogDB (single append-only
record log with replay-on-open and size-triggered compaction — the
framework's stand-in for the vendored RocksDB submodule, reference
.gitmodules rocksdb).  Used by FileStore for object metadata and by
the monitor's MonitorDBStore equivalent (reference
mon/MonitorDBStore.h:37).
"""
from __future__ import annotations

import abc
import os
import struct
import threading
from typing import Dict, Iterator, List, Optional, Tuple


class WriteBatch:
    """Atomic batch of sets/deletes (reference KeyValueDB::Transaction)."""

    def __init__(self) -> None:
        self.ops: List[Tuple[str, str, bytes]] = []  # (op, key, value)

    def set(self, key: str, value: bytes) -> "WriteBatch":
        self.ops.append(("set", key, bytes(value))); return self

    def rm(self, key: str) -> "WriteBatch":
        self.ops.append(("rm", key, b"")); return self

    def rm_range(self, start: str, end: str) -> "WriteBatch":
        """Delete keys in [start, end) (reference rm_range_keys)."""
        self.ops.append(("rm_range", start, end.encode())); return self

    def rm_prefix(self, prefix: str) -> "WriteBatch":
        """Delete every key starting with ``prefix`` (reference
        rmkeys_by_prefix) — unlike rm_range there is no upper-bound
        sentinel to outgrow, so non-ASCII key tails are covered."""
        self.ops.append(("rm_prefix", prefix, b"")); return self


class KeyValueDB(abc.ABC):
    @abc.abstractmethod
    def open(self) -> None: ...

    @abc.abstractmethod
    def close(self) -> None: ...

    @abc.abstractmethod
    def submit(self, batch: WriteBatch, sync: bool = False) -> None:
        """Apply atomically; sync=True durably (reference
        submit_transaction[_sync])."""

    @abc.abstractmethod
    def get(self, key: str) -> Optional[bytes]: ...

    @abc.abstractmethod
    def iterate(self, prefix: str = "",
                start: str = "") -> Iterator[Tuple[str, bytes]]:
        """Sorted iteration over keys with the given prefix, starting at
        ``start`` (inclusive) if given."""

    def sync(self) -> None:
        """Make previously submitted records durable (reference
        KeyValueDB::submit_transaction_sync's fsync half).  Splitting
        append from fsync lets the store ledger charge WAL write and
        WAL durability as separate phases.  Default: no-op (MemDB has
        no durability to wait for)."""

    def get_prefix(self, prefix: str) -> Dict[str, bytes]:
        return dict(self.iterate(prefix))


def _snapshot_iterate(data: Dict[str, bytes], prefix: str,
                      start: str) -> Iterator[Tuple[str, bytes]]:
    """Sorted snapshot of the matching keys (caller holds the lock)."""
    keys = sorted(k for k in data if k.startswith(prefix) and k >= start)
    return iter([(k, data[k]) for k in keys])


class MemDB(KeyValueDB):
    """Dict-backed (reference kv/MemDB.cc)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._data: Dict[str, bytes] = {}

    def open(self) -> None:
        pass

    def close(self) -> None:
        pass

    def submit(self, batch: WriteBatch, sync: bool = False) -> None:
        with self._lock:
            _apply_batch(self._data, batch)

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._data.get(key)

    def iterate(self, prefix: str = "",
                start: str = "") -> Iterator[Tuple[str, bytes]]:
        with self._lock:
            return _snapshot_iterate(self._data, prefix, start)


def _apply_batch(data: Dict[str, bytes], batch: WriteBatch) -> None:
    for op, key, value in batch.ops:
        if op == "set":
            data[key] = value
        elif op == "rm":
            data.pop(key, None)
        elif op == "rm_range":
            end = value.decode()
            for k in [k for k in data if key <= k < end]:
                del data[k]
        elif op == "rm_prefix":
            for k in [k for k in data if k.startswith(key)]:
                del data[k]


class LogDB(KeyValueDB):
    """Append-only record log with in-memory index.

    Record framing: u32 length + payload, payload = batch of
    (op u8, key, value) entries; a torn tail record is discarded on
    replay (crash atomicity).  Compacts by rewriting the live set when
    the log exceeds ``compact_factor`` times the live size.
    """

    MAGIC = b"CTKV0001"

    def __init__(self, path: str, compact_factor: int = 4):
        self.path = path
        self.compact_factor = compact_factor
        self._lock = threading.RLock()
        self._data: Dict[str, bytes] = {}
        self._fh = None
        self._log_bytes = 0
        # next log size at which to run the O(keys) live-size scan, so
        # submits stay O(batch) between checks
        self._compact_check_at = 8192

    # -- framing -----------------------------------------------------------
    @staticmethod
    def _encode_batch(batch: WriteBatch) -> bytes:
        parts = [struct.pack("<I", len(batch.ops))]
        for op, key, value in batch.ops:
            kb = key.encode()
            code = {"set": 0, "rm": 1, "rm_range": 2, "rm_prefix": 3}[op]
            parts.append(struct.pack("<BI", code, len(kb)))
            parts.append(kb)
            parts.append(struct.pack("<I", len(value)))
            parts.append(value)
        payload = b"".join(parts)
        return struct.pack("<I", len(payload)) + payload

    @staticmethod
    def _decode_batch(payload: bytes) -> WriteBatch:
        batch = WriteBatch()
        pos = 4
        (count,) = struct.unpack_from("<I", payload, 0)
        for _ in range(count):
            code, klen = struct.unpack_from("<BI", payload, pos)
            pos += 5
            key = payload[pos:pos + klen].decode()
            pos += klen
            (vlen,) = struct.unpack_from("<I", payload, pos)
            pos += 4
            value = payload[pos:pos + vlen]
            pos += vlen
            op = {0: "set", 1: "rm", 2: "rm_range", 3: "rm_prefix"}[code]
            batch.ops.append((op, key, bytes(value)))
        return batch

    # -- lifecycle ---------------------------------------------------------
    def open(self) -> None:
        with self._lock:
            if self._fh is not None:
                return
            exists = os.path.exists(self.path)
            if exists:
                self._replay()
            self._fh = open(self.path, "ab")
            if not exists:
                self._fh.write(self.MAGIC)
                self._fh.flush()
                self._log_bytes = len(self.MAGIC)

    def _replay(self) -> None:
        self._data = {}
        with open(self.path, "rb") as fh:
            magic = fh.read(len(self.MAGIC))
            if len(magic) < len(self.MAGIC) \
                    and self.MAGIC.startswith(magic):
                # crash between file creation and the magic flush on the
                # very first open: an empty/torn-magic log is a fresh log
                with open(self.path, "wb") as wfh:
                    wfh.write(self.MAGIC)
                    wfh.flush()
                    os.fsync(wfh.fileno())
                self._log_bytes = len(self.MAGIC)
                return
            if magic != self.MAGIC:
                raise IOError(f"{self.path}: bad magic")
            good_end = fh.tell()
            while True:
                hdr = fh.read(4)
                if len(hdr) < 4:
                    break
                (length,) = struct.unpack("<I", hdr)
                payload = fh.read(length)
                if len(payload) < length:
                    break               # torn tail record: discard
                _apply_batch(self._data, self._decode_batch(payload))
                good_end = fh.tell()
        self._log_bytes = good_end
        if good_end < os.path.getsize(self.path):
            with open(self.path, "r+b") as fh:
                fh.truncate(good_end)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                os.fsync(self._fh.fileno())
                self._fh.close()
                self._fh = None

    # -- access ------------------------------------------------------------
    def submit(self, batch: WriteBatch, sync: bool = False) -> None:
        with self._lock:
            if self._fh is None:
                raise RuntimeError("LogDB not open")
            record = self._encode_batch(batch)
            self._fh.write(record)
            self._fh.flush()
            if sync:
                os.fsync(self._fh.fileno())
            self._log_bytes += len(record)
            _apply_batch(self._data, batch)
            self._maybe_compact()

    def sync(self) -> None:
        with self._lock:
            if self._fh is None:
                raise RuntimeError("LogDB not open")
            os.fsync(self._fh.fileno())

    def _live_bytes(self) -> int:
        return sum(len(k) + len(v) + 13 for k, v in self._data.items())

    def compact(self) -> None:
        """Force a rewrite-to-live compaction now (reference
        KeyValueDB::compact; consumed by mon_compact_on_start).
        Logs already near their live size (< 4 KiB of slack) skip."""
        with self._lock:
            save_at, save_f = self._compact_check_at, self.compact_factor
            self._compact_check_at, self.compact_factor = 0, 0
            try:
                self._maybe_compact()
            finally:
                self._compact_check_at = max(save_at, self._log_bytes)
                self.compact_factor = save_f

    def _maybe_compact(self) -> None:
        if self._log_bytes < self._compact_check_at:
            return
        live = self._live_bytes() + len(self.MAGIC)
        if self._log_bytes <= max(4096, live * self.compact_factor):
            # not worth compacting yet; defer the next scan until the
            # log has grown enough to possibly cross the threshold
            self._compact_check_at = max(
                self._log_bytes * 2, live * self.compact_factor)
            return
        tmp = self.path + ".compact"
        batch = WriteBatch()
        for k in sorted(self._data):
            batch.set(k, self._data[k])
        with open(tmp, "wb") as fh:
            fh.write(self.MAGIC)
            fh.write(self._encode_batch(batch))
            fh.flush()
            os.fsync(fh.fileno())
        self._fh.close()
        os.replace(tmp, self.path)
        self._fh = open(self.path, "ab")
        self._log_bytes = os.path.getsize(self.path)
        self._compact_check_at = max(8192, self._log_bytes * 2)

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._data.get(key)

    def iterate(self, prefix: str = "",
                start: str = "") -> Iterator[Tuple[str, bytes]]:
        with self._lock:
            return _snapshot_iterate(self._data, prefix, start)

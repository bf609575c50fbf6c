"""Local object stores (reference src/os/, src/kv/).

- objectstore: the transactional ObjectStore seam + Transaction
  (reference os/ObjectStore.h)
- memstore: in-RAM test double (reference os/memstore/MemStore.cc)
- filestore: persistent files + LogDB metadata + WAL journal
- blockstore: raw block space + bitmap allocator + KV metadata with
  copy-on-write overwrites (reference os/bluestore/, synchronous)
- bluestore: async BlockStore subclass — WAL group commit, deferred
  apply off the PG-lock path, device-batched checksums (reference
  os/bluestore/ transaction pipeline)
- kv: KeyValueDB abstraction, MemDB/LogDB backends (reference
  src/kv/KeyValueDB.h)
"""
from .objectstore import COLL_META, GHObject, ObjectStat, ObjectStore, \
    Transaction
from .memstore import MemStore
from .filestore import FileStore
from .blockstore import BlockStore
from .bluestore import BlueStore
from .kv import KeyValueDB, LogDB, MemDB, WriteBatch

__all__ = ["COLL_META", "GHObject", "ObjectStat", "ObjectStore",
           "Transaction", "MemStore", "FileStore", "BlockStore",
           "BlueStore", "KeyValueDB",
           "LogDB", "MemDB", "WriteBatch"]

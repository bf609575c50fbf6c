"""Compression plugin registry.

Python-native equivalent of the reference's compressor subsystem
(reference ``src/compressor/`` — ``Compressor::create`` +
``CompressionPluginRegistry``, the second consumer of the same
plugin-registry idiom as erasure-code; backends zlib/snappy/zstd/lz4).
Backends here are the stdlib codecs (zlib, bz2, lzma); snappy/zstd
register only if their modules exist in the image.

Numeric ids are stamped into compressed wire frames so the receiver
picks the right codec (reference compression negotiation in msgr2).
"""
from __future__ import annotations

import abc
from typing import Dict, List, Optional


class Compressor(abc.ABC):
    """reference Compressor interface."""
    name: str = ""
    numeric_id: int = 0

    @abc.abstractmethod
    def compress(self, data: bytes) -> bytes: ...

    @abc.abstractmethod
    def decompress(self, data: bytes) -> bytes: ...


class ZlibCompressor(Compressor):
    name = "zlib"
    numeric_id = 1

    def __init__(self, level: int = 5):
        self.level = level

    def compress(self, data: bytes) -> bytes:
        import zlib
        return zlib.compress(data, self.level)

    def decompress(self, data: bytes) -> bytes:
        import zlib
        return zlib.decompress(data)


class Bz2Compressor(Compressor):
    name = "bz2"
    numeric_id = 2

    def compress(self, data: bytes) -> bytes:
        import bz2
        return bz2.compress(data)

    def decompress(self, data: bytes) -> bytes:
        import bz2
        return bz2.decompress(data)


class LzmaCompressor(Compressor):
    name = "lzma"
    numeric_id = 3

    def compress(self, data: bytes) -> bytes:
        import lzma
        return lzma.compress(data)

    def decompress(self, data: bytes) -> bytes:
        import lzma
        return lzma.decompress(data)


class _Registry:
    """reference CompressionPluginRegistry (singleton like the EC
    registry, ErasureCodePlugin.h:45)."""

    def __init__(self) -> None:
        self._by_name: Dict[str, type] = {}
        self._by_id: Dict[int, type] = {}
        for cls in (ZlibCompressor, Bz2Compressor, LzmaCompressor):
            self.add(cls)
        # optional third-party codecs, present in some images
        try:
            import snappy              # noqa: F401

            class SnappyCompressor(Compressor):
                name = "snappy"
                numeric_id = 4

                def compress(self, data: bytes) -> bytes:
                    return snappy.compress(data)

                def decompress(self, data: bytes) -> bytes:
                    return snappy.decompress(data)

            self.add(SnappyCompressor)
        except ImportError:
            pass
        try:
            import zstandard

            class ZstdCompressor(Compressor):
                name = "zstd"
                numeric_id = 5

                def compress(self, data: bytes) -> bytes:
                    return zstandard.ZstdCompressor().compress(data)

                def decompress(self, data: bytes) -> bytes:
                    return zstandard.ZstdDecompressor().decompress(data)

            self.add(ZstdCompressor)
        except ImportError:
            pass

    def add(self, cls: type) -> None:
        self._by_name[cls.name] = cls
        self._by_id[cls.numeric_id] = cls

    def supported(self) -> List[str]:
        return sorted(self._by_name)

    def create(self, name: str, conf=None) -> Compressor:
        cls = self._by_name.get(name)
        if cls is None:
            raise KeyError(f"no compressor {name!r} "
                           f"(have {self.supported()})")
        if name == "zlib":
            # reference compressor_zlib_level (from the caller's conf
            # so per-cluster overrides apply; global default otherwise)
            try:
                if conf is None:
                    from ..utils.config import default_config
                    conf = default_config()
                return cls(level=conf["compressor_zlib_level"])
            except Exception:
                pass
        return cls()

    def create_by_id(self, numeric_id: int) -> Compressor:
        cls = self._by_id.get(numeric_id)
        if cls is None:
            raise KeyError(f"no compressor id {numeric_id}")
        return cls()


_instance: Optional[_Registry] = None


def registry() -> _Registry:
    global _instance
    if _instance is None:
        _instance = _Registry()
    return _instance

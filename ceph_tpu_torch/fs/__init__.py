"""CephFS-style file layer (reference src/mds/ + src/client/)."""
from .filesystem import FileSystem, FSError  # noqa: F401

"""Deterministic placement (CRUSH): mapper + wrapper (reference
src/crush/)."""
from .mapper import (CRUSH_ITEM_NONE, Bucket, CrushMap, Rule,  # noqa: F401
                     crush_hash32_2, crush_hash32_3)
from .wrapper import CrushWrapper, build_flat_map  # noqa: F401

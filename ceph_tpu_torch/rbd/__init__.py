"""RBD: block images on RADOS (reference src/librbd/, SURVEY §2.6)."""
from .image import RBD, Image, ImageNotFound  # noqa: F401

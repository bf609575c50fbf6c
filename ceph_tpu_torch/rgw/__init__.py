"""RGW: S3-style object gateway (reference src/rgw/, SURVEY §2.6)."""
from .gateway import RGWService, RGWError  # noqa: F401

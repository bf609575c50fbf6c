from .daemon import MDSDaemon  # noqa: F401

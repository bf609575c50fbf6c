"""Per-daemon admin socket.

Python-native equivalent of the reference's AdminSocket (reference
src/common/admin_socket.h:108): a unix-domain socket each daemon listens
on, accepting JSON commands and returning JSON — the transport behind
``ceph daemon <name> perf dump / config show / dump_historic_ops``.

Protocol: one JSON object per connection, newline terminated:
    {"prefix": "perf dump", ...args}
reply: JSON document, connection closed.  (The reference reads a
command string and replies with a 4-byte length + payload; newline
framing is the Python-idiomatic equivalent.)
"""
from __future__ import annotations

import json
import os
import socket
import threading
from typing import Callable, Dict, Optional

Hook = Callable[[Dict], object]


class AdminSocket:
    def __init__(self, path: str):
        self.path = path
        self._hooks: Dict[str, Hook] = {}
        self._lock = threading.Lock()
        self._server: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self.register("help", lambda cmd: sorted(self._hooks))

    def register(self, prefix: str, hook: Hook) -> None:
        """reference AdminSocket::register_command."""
        with self._lock:
            if prefix in self._hooks:
                raise KeyError(f"admin command {prefix!r} already registered")
            self._hooks[prefix] = hook

    def unregister(self, prefix: str) -> None:
        with self._lock:
            self._hooks.pop(prefix, None)

    # -- server ------------------------------------------------------------
    def start(self) -> None:
        if os.path.exists(self.path):
            os.unlink(self.path)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._server.bind(self.path)
        self._server.listen(8)
        self._server.settimeout(0.2)
        self._stopping = False
        self._thread = threading.Thread(target=self._serve,
                                        name=f"admin:{self.path}",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stopping = True
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._server is not None:
            self._server.close()
            self._server = None
        if os.path.exists(self.path):
            try:
                os.unlink(self.path)
            except OSError:
                pass

    def _serve(self) -> None:
        assert self._server is not None
        while not self._stopping:
            try:
                conn, _ = self._server.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                self._handle(conn)
            except Exception:
                pass  # a bad client must not kill the server thread
            finally:
                conn.close()

    def _handle(self, conn: socket.socket) -> None:
        conn.settimeout(5)
        data = b""
        while b"\n" not in data:
            chunk = conn.recv(65536)
            if not chunk:
                break
            data += chunk
        try:
            cmd = json.loads(data.decode() or "{}")
            prefix = cmd.get("prefix", "")
            with self._lock:
                hook = self._hooks.get(prefix)
            if hook is None:
                reply = {"error": f"unknown command {prefix!r}",
                         "commands": sorted(self._hooks)}
            else:
                reply = {"ok": True, "result": hook(cmd)}
        except Exception as e:  # command errors go to the caller
            reply = {"error": f"{type(e).__name__}: {e}"}
        try:
            conn.sendall(json.dumps(reply, default=str).encode() + b"\n")
        except OSError:
            pass


def admin_command(path: str, prefix: str, timeout: float = 5.0,
                  **args) -> object:
    """Client side: send one command to a daemon's admin socket
    (the ``ceph daemon <x> <cmd>`` equivalent)."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(path)
        cmd = {"prefix": prefix}
        cmd.update(args)
        s.sendall(json.dumps(cmd).encode() + b"\n")
        data = b""
        while b"\n" not in data:
            chunk = s.recv(1 << 20)
            if not chunk:
                break
            data += chunk
    reply = json.loads(data.decode())
    if "error" in reply:
        raise RuntimeError(reply["error"])
    return reply["result"]

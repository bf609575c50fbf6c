"""Manager module host — the framework's PyModuleRegistry.

Python-native equivalent of the reference's mgr module runtime
(reference ``src/mgr/PyModuleRegistry.cc`` + ``src/mgr/PyModule.cc``
hosting the ``src/pybind/mgr/*`` modules): modules are discovered in
this package, enabled/disabled AT RUNTIME through the monitor
(``ceph mgr module enable <name>`` rides the central config, so every
standby mgr converges on the same set), and talk to the cluster only
through the :class:`MgrModule` API below (reference ``MgrModule.py``'s
``get()``, ``mon_command``, ``serve``/``shutdown`` contract).

A module provides::

    class Module(MgrModule):
        NAME = "my_module"
        def serve(self):            # optional background loop
            while not self.should_stop.wait(1.0): ...
        def handle_command(self, cmd) -> (rc, outs, outd)
        def http_routes(self) -> {"/path": callable -> (ctype, body)}
        def notify(self, what) -> None   # "osd_map" | "perf"
"""
from __future__ import annotations

import importlib
import pkgutil
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ...utils.log import Dout


class MgrModule:
    """Base class + the ONLY surface modules get (reference
    MgrModule.py: modules never touch mgr internals directly)."""

    NAME = "?"

    def __init__(self, host) -> None:
        self._host = host                # the Manager (opaque)
        self.log = Dout("mgr", f"{self.NAME} ")
        self.should_stop = threading.Event()

    # -- cluster state (reference MgrModule.get / get_osdmap) ----------
    def get_osdmap(self):
        return self._host._module_osdmap()

    def get(self, what: str):
        """Named cluster state blobs (reference MgrModule.get):
        'osd_map' | 'perf_counters' | 'health' | 'config'."""
        return self._host._module_get(what)

    def mon_command(self, cmd: dict) -> Tuple[int, str, dict]:
        """reference MgrModule.mon_command (check_mon_command)."""
        return self._host.monc.command(cmd, 10.0)

    def get_module_option(self, name: str, default=None):
        """Per-module config via the cluster config's option table
        (reference get_module_option)."""
        try:
            return self._host.conf[name]
        except KeyError:
            return default

    # -- lifecycle (reference serve/shutdown) --------------------------
    def serve(self) -> None:             # pragma: no cover - optional
        """Long-running loop; runs in the module's own thread."""

    def shutdown(self) -> None:
        self.should_stop.set()

    # -- integration points --------------------------------------------
    def handle_command(self, cmd: dict) -> Tuple[int, str, dict]:
        """`ceph mgr <module> <args>` (reference handle_command)."""
        return (-95, f"module {self.NAME} has no commands", {})

    def http_routes(self) -> Dict[str, Callable]:
        """path -> fn() -> (content_type, bytes) served by the mgr's
        HTTP frontend (how prometheus/restful expose themselves)."""
        return {}

    def notify(self, what: str) -> None:
        """Cluster state changed (reference MgrModule.notify)."""


def discover() -> Dict[str, type]:
    """All module classes in this package (reference
    PyModuleRegistry::probe_modules scanning the mgr module path)."""
    out: Dict[str, type] = {}
    for info in pkgutil.iter_modules(__path__):
        if info.name.startswith("_"):
            continue
        try:
            mod = importlib.import_module(f".{info.name}", __name__)
        except Exception:
            continue                     # a broken module must not
                                         # take the registry down
        cls = getattr(mod, "Module", None)
        if cls is not None and issubclass(cls, MgrModule):
            out[cls.NAME] = cls
    return out


class ModuleHost:
    """Runtime enable/disable + thread supervision (reference
    PyModuleRegistry active_modules + StandbyPyModules)."""

    def __init__(self, mgr) -> None:
        self.mgr = mgr
        self.log = Dout("mgr", "module-host ")
        self.available = discover()
        self.active: Dict[str, MgrModule] = {}
        self._threads: Dict[str, threading.Thread] = {}
        self._lock = threading.Lock()

    def reconcile(self, enabled: List[str]) -> None:
        """Make the active set match ``enabled`` (called on config
        change + mgr tick): start the missing, stop the removed."""
        want = [n for n in enabled if n in self.available]
        with self._lock:
            for name in [n for n in self.active if n not in want]:
                self._stop_locked(name)
            for name in [n for n in want if n not in self.active]:
                self._start_locked(name)

    def _start_locked(self, name: str) -> None:
        try:
            inst = self.available[name](self.mgr)
        except Exception as e:
            self.log.dwarn("module %s failed to init: %r", name, e)
            return
        self.active[name] = inst
        t = threading.Thread(target=self._run_serve, args=(inst,),
                             name=f"mgr-mod-{name}", daemon=True)
        t.start()
        self._threads[name] = t
        self.log.dout(1, f"module {name} enabled")

    def _run_serve(self, inst: MgrModule) -> None:
        try:
            inst.serve()
        except Exception as e:
            self.log.dwarn("module %s serve() died: %r",
                           inst.NAME, e)

    def _stop_locked(self, name: str) -> None:
        inst = self.active.pop(name, None)
        if inst is None:
            return
        try:
            inst.shutdown()
        except Exception:
            pass
        t = self._threads.pop(name, None)
        if t is not None:
            t.join(timeout=2)
        self.log.dout(1, f"module {name} disabled")

    def shutdown(self) -> None:
        with self._lock:
            for name in list(self.active):
                self._stop_locked(name)

    # -- fan-outs ------------------------------------------------------
    def notify_all(self, what: str) -> None:
        with self._lock:
            mods = list(self.active.values())
        for m in mods:
            try:
                m.notify(what)
            except Exception:
                pass

    def http_route(self, path: str) -> Optional[Callable]:
        with self._lock:
            mods = list(self.active.values())
        for m in mods:
            routes = {}
            try:
                routes = m.http_routes()
            except Exception:
                pass
            fn = routes.get(path)
            if fn is not None:
                return fn
        return None

    def handle_command(self, module: str, cmd: dict
                       ) -> Tuple[int, str, dict]:
        with self._lock:
            inst = self.active.get(module)
        if inst is None:
            return (-2, f"module {module!r} is not enabled "
                    f"(have {sorted(self.active)})", {})
        try:
            return inst.handle_command(cmd)
        except Exception as e:
            return (-5, f"module {module} command failed: {e!r}", {})

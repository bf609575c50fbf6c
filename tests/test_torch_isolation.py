"""The port stands alone: ceph_tpu_torch imports neither jax nor the JAX
package (ceph_tpu), at import time or in any module's source."""
import ast
import os
import pkgutil
import subprocess
import sys

import ceph_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(ceph_tpu_torch.__file__)


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG], prefix="ceph_tpu_torch."))


def test_every_module_imports_with_jax_and_ceph_tpu_blocked():
    mods = port_modules()
    assert "ceph_tpu_torch.ec.plugins.gpu" in mods
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ceph_tpu'] = None\n"
        f"for name in {mods!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'ceph_tpu' or n.startswith('ceph_tpu.')]\n"
        "assert all(sys.modules[n] is None for n in bad), bad\n"
        "from ceph_tpu_torch.ec import registry\n"
        "c = registry.instance().factory('gpu', {'k': '4', 'm': '2',"
        " 'device': 'cpu'})\n"
        "import numpy as np\n"
        "assert c.encode_batch(np.zeros((1, 4, 128), np.uint8)).shape =="
        " (1, 2, 128)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def imported_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_imports_jax_or_ceph_tpu():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 10
    for path in files:
        for name in imported_names(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "ceph_tpu"), (path, name)


# Relative imports of modules the port does not hold yet, each reached
# only when its feature is used: class calls (objclass) and the
# manager's modules and daemon (mgr.modules, mgr.manager).  A slice that
# ports one of them removes it here; none is ever added.
UNPORTED_RELATIVE_TARGETS = frozenset({
    "ceph_tpu_torch.objclass",
    "ceph_tpu_torch.mgr.modules",
    "ceph_tpu_torch.mgr.manager",
})


def _module_name(path):
    rel = os.path.relpath(path, os.path.dirname(PKG))[:-3]
    parts = rel.split(os.sep)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts), path.endswith("__init__.py")


def _resolves(dotted):
    """True when ``dotted`` names a module file or package of the port."""
    base = os.path.join(os.path.dirname(PKG), *dotted.split("."))
    return os.path.isfile(base + ".py") or \
        os.path.isfile(os.path.join(base, "__init__.py"))


def relative_import_targets():
    """(source file, absolute target) of every relative import in the
    port, lazy ones inside functions included."""
    for d, _, fs in os.walk(PKG):
        for f in fs:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            mod, is_pkg = _module_name(path)
            package = mod if is_pkg else mod.rpartition(".")[0]
            tree = ast.parse(open(path).read(), path)
            for node in ast.walk(tree):
                if not isinstance(node, ast.ImportFrom) or node.level == 0:
                    continue
                parts = package.split(".")
                base = parts[:len(parts) - (node.level - 1)]
                if node.module:
                    yield path, ".".join(base + node.module.split("."))
                else:
                    # ``from . import x``: x is a submodule or a name
                    # the package itself defines
                    for a in node.names:
                        sub = ".".join(base + [a.name])
                        yield path, sub if _resolves(sub) else \
                            ".".join(base)


def test_every_relative_import_resolves_inside_the_port():
    targets = list(relative_import_targets())
    assert len(targets) > 200
    assert all(t.startswith("ceph_tpu_torch") for _, t in targets)
    unresolved = {t for _, t in targets if not _resolves(t)}
    assert unresolved == UNPORTED_RELATIVE_TARGETS, sorted(
        (p, t) for p, t in targets if t in
        unresolved ^ UNPORTED_RELATIVE_TARGETS)


def test_unported_list_is_the_four_named_features():
    """The exception list only shrinks: of the four features it first
    named, the crimson OSD is ported, and these three, no other,
    remain."""
    assert UNPORTED_RELATIVE_TARGETS == {
        "ceph_tpu_torch.objclass", "ceph_tpu_torch.mgr.modules",
        "ceph_tpu_torch.mgr.manager"}
    for t in UNPORTED_RELATIVE_TARGETS:
        assert not _resolves(t), f"{t} is ported: remove it from the list"

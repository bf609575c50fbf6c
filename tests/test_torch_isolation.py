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


# Relative imports of modules the port does not hold yet.  The list
# held class calls (objclass) and the manager's modules and daemon
# (mgr.modules, mgr.manager) until they were ported; it only shrinks,
# and it is empty now.
UNPORTED_RELATIVE_TARGETS = frozenset()


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
    named, the crimson OSD, the object classes, the manager's modules
    and the manager daemon are all ported, so it is empty."""
    assert UNPORTED_RELATIVE_TARGETS == frozenset()
    for t in ("ceph_tpu_torch.crimson", "ceph_tpu_torch.objclass",
              "ceph_tpu_torch.mgr.modules", "ceph_tpu_torch.mgr.manager"):
        assert _resolves(t), t


_IMPORTERS = ("import_module", "__import__", "find_spec")


def _leading_text(node):
    """The literal text a string argument starts with: all of a
    constant, or an f-string's parts up to its first placeholder."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        text = ""
        for part in node.values:
            if not isinstance(part, ast.Constant):
                break
            text += part.value
        return text
    return None


def _names_ceph_tpu(text):
    return text == "ceph_tpu" or text.startswith("ceph_tpu.")


def importlib_names(path):
    """(line, module text) of every module name that a source passes
    to importlib (``import_module``, ``__import__``, ``find_spec``),
    a relative one resolved against the ``package`` it is given when
    that is ``__name__`` or ``__package__``."""
    mod, is_pkg = _module_name(path) if path.startswith(PKG) else \
        ("chip_smoke", False)
    own_package = mod if is_pkg else mod.rpartition(".")[0]
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        func = ast.unparse(node.func).rpartition(".")[2]
        if func not in _IMPORTERS:
            continue
        text = _leading_text(node.args[0])
        if text is None:
            continue
        if text.startswith("."):
            package = node.args[1] if len(node.args) > 1 else next(
                (k.value for k in node.keywords if k.arg == "package"),
                None)
            if isinstance(package, ast.Name) and package.id in (
                    "__name__", "__package__"):
                pkg_name = mod if package.id == "__name__" and is_pkg \
                    else own_package
                text = pkg_name + text
        yield node.lineno, text


def _port_and_smoke_sources():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    return files


def test_no_source_passes_a_ceph_tpu_module_name_to_importlib():
    """The relative-import check does not see a module named by a
    string, as ``mgr.modules.discover`` and the codec registry load
    theirs: every such name must be the port's own, and no source holds
    a dotted ``ceph_tpu.`` module name in a string at all."""
    seen = []
    for path in _port_and_smoke_sources():
        for line, text in importlib_names(path):
            seen.append((path, line, text))
            assert not _names_ceph_tpu(text), (path, line, text)
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            text = _leading_text(node) if isinstance(
                node, (ast.Constant, ast.JoinedStr)) else None
            assert text is None or not _names_ceph_tpu(text), (
                path, node.lineno, text)
    # the two loaders by name, each resolved to the port's package
    by_file = {os.path.relpath(p, PKG): t for p, _, t in seen}
    assert by_file["mgr/modules/__init__.py"].startswith(
        "ceph_tpu_torch.mgr.modules."), by_file
    assert by_file["ec/registry.py"].startswith(
        "ceph_tpu_torch.ec.plugins."), by_file


def test_importlib_name_check_sees_the_reference_loader(tmp_path):
    """The check above flags the reference's own ``discover``, which
    names its package in an f-string and an absolute import."""
    ref = os.path.join(REPO, "ceph_tpu", "mgr", "modules", "__init__.py")
    src = tmp_path / "discover.py"
    src.write_text(open(ref).read())
    names = [t for _, t in importlib_names(str(src))]
    assert any(_names_ceph_tpu(t) for t in names), names


# Modules of the JAX package that the port does not hold, as paths
# under the package.  The list only shrinks: the client services
# (rbd/, rgw/, fs/, mds/), the command-line tools (tools/) and last the
# device mesh (parallel/) left it when they were ported, so it is empty.
UNPORTED_MODULES = frozenset()
TOOLS = ("__init__", "bench_sweep", "ceph_cli", "cephadm", "cephfs_cli",
         "common", "crushtool", "ec_benchmark", "ec_non_regression",
         "ec_tool", "objectstore_tool", "osdmaptool", "rados_cli",
         "rbd_cli", "thrash", "vstart")
# the JAX package's modules that the port replaces with its own
REPLACED_MODULES = {"ops/jax_engine.py": "ops/torch_engine.py",
                    "ec/plugins/tpu.py": "ec/plugins/gpu.py"}


def _py_files(root):
    return {os.path.relpath(os.path.join(d, f), root).replace(os.sep, "/")
            for d, _, fs in os.walk(root) for f in fs if f.endswith(".py")}


def test_unported_modules_are_the_frozen_list():
    """The JAX package's modules that the port lacks are exactly the
    replaced modules, each replacement present: the unported list is
    empty, and the device mesh imports with ``jax`` and ``ceph_tpu``
    blocked."""
    ref = _py_files(os.path.join(REPO, "ceph_tpu"))
    port = _py_files(PKG)
    assert UNPORTED_MODULES == frozenset()
    assert ref - port == UNPORTED_MODULES | set(REPLACED_MODULES)
    assert set(REPLACED_MODULES.values()) <= port
    for pkg in ("rbd", "rgw", "fs", "mds", "tools", "parallel"):
        assert {m for m in ref if m.startswith(pkg + "/")} <= port, pkg
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ceph_tpu'] = None\n"
        "from ceph_tpu_torch.parallel import dryrun, mesh\n"
        "assert mesh.resolve_mesh(device='cpu') is None\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'ceph_tpu' or n.startswith('ceph_tpu.')]\n"
        "assert all(sys.modules[n] is None for n in bad), bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("CEPH_TPU_TORCH_FORCE_DEVICE_COUNT", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_every_tool_imports_with_jax_and_ceph_tpu_blocked():
    """The 16 modules of tools/ import with ``jax`` and ``ceph_tpu``
    blocked, leave neither loaded, and every tool's usage text names
    the port's package."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ceph_tpu'] = None\n"
        f"for name in {TOOLS!r}:\n"
        "    mod = importlib.import_module('ceph_tpu_torch.tools' + ("
        "'' if name == '__init__' else '.' + name))\n"
        "    assert 'ceph_tpu.tools' not in (mod.__doc__ or ''), name\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'ceph_tpu' or n.startswith('ceph_tpu.')]\n"
        "assert all(sys.modules[n] is None for n in bad), bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
    tools = os.path.join(PKG, "tools")
    assert {f[:-3] for f in os.listdir(tools) if f.endswith(".py")} == \
        set(TOOLS)
    for name in TOOLS:
        text = open(os.path.join(tools, name + ".py")).read()
        assert "ceph_tpu.tools" not in text, name
        for line in text.splitlines():
            if "python -m " in line:
                assert "python -m ceph_tpu_torch.tools." in line, (
                    name, line)

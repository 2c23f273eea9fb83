"""API parity of velocyto_tpu_torch with the JAX package, by ast.

Walks the JAX package's source with ``ast`` (the JAX package is never
imported here) and holds the port to it, module by module: every module
of ``velocyto_tpu/`` has its counterpart under the same name in
``velocyto_tpu_torch/``, and there

  * every public module-level function and class exists;
  * every public method (and ``__init__``) of every public class exists;
  * every parameter name of those functions and methods is accepted, and
    every literal default keeps its value (a bool default stays a bool);
  * every name an ``__init__.py`` exports (its imports, ``from .x import
    *`` included, and ``__all__``) is an attribute of the port's package.

The port may take more parameters and export more names.  The only
names the port does not take are the TPU knobs of ``SKIPPED``, each with
its reason.  A subprocess then imports the port and every one of its
submodules and checks that neither jax nor matplotlib nor h5py was
loaded.
"""
import ast
import importlib
import inspect
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "velocyto_tpu"
PORT = "velocyto_tpu_torch"
PORT_PKG = ROOT / PORT

# (module, function, parameter) of the JAX package that the port does
# not take, with the reason.  Nothing else may be missing.
SKIPPED = {
    ("ops/coldeltacor.py", "col_delta_cor", "use_pallas"):
        "selects the Pallas TPU kernel or its XLA form; the port has one "
        "hand CUDA kernel for the card and its plain version for the CPU",
    ("ops/coldeltacor.py", "make_dense_sharded", "block"):
        "TPU tile size; the hand kernels pick their own",
    ("ops/knn.py", "make_knn_search_sharded", "use_sort"):
        "works around a TPU compile of lax.top_k; the port always takes "
        "the stable sort",
    ("ops/knn.py", "knn_search", "block"):
        "TPU row-block size of the candidate pass; the port picks its own "
        "by N (ops/knn.py::_candidate_plan)",
    ("ops/knn.py", "knn_search_sharded", "block"):
        "TPU row-block size of the candidate pass; the port picks its own "
        "by N (ops/knn.py::_candidate_plan)",
    ("ops/knn_device.py", "knn_search_dev", "block"):
        "TPU row-block size of the candidate pass; the port picks its own "
        "by N (ops/knn.py::_candidate_plan)",
    ("utils/profiling.py", "trace", "create_perfetto_link"):
        "jax.profiler's Perfetto upload link; torch.profiler writes a "
        "chrome trace and has no such link",
}


def _modules():
    return sorted(p.relative_to(JAX_PKG).as_posix()
                  for p in JAX_PKG.rglob("*.py"))


def _port_name(rel):
    parts = rel[:-3].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join([PORT] + parts)


def _literal(node):
    try:
        return True, ast.literal_eval(node)
    except (ValueError, TypeError, SyntaxError):
        return False, None


def _params(fn):
    """(names, literal defaults, *args, **kwargs) of an ast function."""
    a = fn.args
    pos = [x.arg for x in a.posonlyargs + a.args]
    defaults = {}
    for name, d in zip(pos[len(pos) - len(a.defaults):], a.defaults):
        ok, v = _literal(d)
        if ok:
            defaults[name] = v
    for x, d in zip(a.kwonlyargs, a.kw_defaults):
        if d is not None:
            ok, v = _literal(d)
            if ok:
                defaults[x.arg] = v
    names = [n for n in pos if n not in ("self", "cls")] + \
        [x.arg for x in a.kwonlyargs]
    return names, defaults, a.vararg is not None, a.kwarg is not None


def _surface(rel):
    """{qualified name: ast function or class} of a JAX module's public
    functions, classes and the public methods (and __init__) of its
    classes."""
    tree = ast.parse((JAX_PKG / rel).read_text())
    out = {}
    for node in tree.body:
        if node.name.startswith("_") if hasattr(node, "name") else True:
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            out[node.name] = node
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and (not m.name.startswith("_")
                             or m.name == "__init__"):
                    out[f"{node.name}.{m.name}"] = m
    return out


def _public_names(pkg_root, rel):
    """Names a module defines publicly (for ``import *``)."""
    tree = ast.parse((pkg_root / rel).read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id == "__all__":
            return set(ast.literal_eval(node.value))
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            names.update(t.id for t in targets if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


def _exports(pkg_root, rel):
    """Every name an ``__init__.py`` under pkg_root binds or lists in
    ``__all__``: its imports (``import *`` resolved), definitions and
    assignments."""
    tree = ast.parse((pkg_root / rel).read_text())
    pkg = Path(rel).parent
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            for alias in node.names:
                if alias.name == "*":
                    src = pkg / (node.module.replace(".", "/") + ".py")
                    names |= _public_names(pkg_root, src.as_posix())
                else:
                    names.add(alias.asname or alias.name)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    names |= set(ast.literal_eval(node.value))
                elif isinstance(t, ast.Name):
                    names.add(t.id)
    return {n for n in names if not n.startswith("_") or n == "__version__"}


def _same_default(got, want):
    # the same type too: a default of 0 is met neither by False nor 0.0
    return type(got) is type(want) and got == want


def _resolve(mod, qual):
    obj = mod
    for part in qual.split("."):
        if not hasattr(obj, part):
            return None
        obj = inspect.getattr_static(obj, part) if inspect.isclass(obj) \
            else getattr(obj, part)
    return obj


def _problems(rel):
    mod = importlib.import_module(_port_name(rel))
    problems = []
    for qual, node in _surface(rel).items():
        ours = _resolve(mod, qual)
        if ours is None:
            problems.append(f"{rel}::{qual}: missing")
            continue
        if isinstance(node, ast.ClassDef):
            if not inspect.isclass(ours):
                problems.append(f"{rel}::{qual}: not a class")
            continue
        if isinstance(ours, property):
            continue
        if isinstance(ours, (staticmethod, classmethod)):
            ours = ours.__func__
        if type(ours).__module__.startswith("click."):
            ours = ours.callback        # a CLI command: its function
        if not callable(ours):
            problems.append(f"{rel}::{qual}: not callable")
            continue
        names, defaults, vararg, kwarg = _params(node)
        params = inspect.signature(ours).parameters
        kinds = {p.kind for p in params.values()}
        if vararg and inspect.Parameter.VAR_POSITIONAL not in kinds:
            problems.append(f"{rel}::{qual}: takes no *args")
        if kwarg and inspect.Parameter.VAR_KEYWORD not in kinds:
            problems.append(f"{rel}::{qual}: takes no **kwargs")
        fname = qual.split(".")[-1]
        for name in names:
            if (rel, fname, name) in SKIPPED:
                continue
            if name not in params:
                problems.append(f"{rel}::{qual}: parameter {name!r} missing")
                continue
            if name in defaults:
                got = params[name].default
                if got is inspect.Parameter.empty or \
                        not _same_default(got, defaults[name]):
                    problems.append(
                        f"{rel}::{qual}({name}=...): default {got!r} != "
                        f"{defaults[name]!r}")
    if rel.endswith("__init__.py"):
        # bound by the port's own __init__.py (not only set as a side
        # effect of importing a submodule elsewhere) and resolvable
        ours = _exports(PORT_PKG, rel)
        for name in sorted(_exports(JAX_PKG, rel)):
            if name not in ours or not hasattr(mod, name):
                problems.append(f"{rel}: export {name!r} missing")
    return problems


def test_every_module_has_a_counterpart():
    missing = [rel for rel in _modules()
               if importlib.util.find_spec(_port_name(rel)) is None]
    assert not missing, missing


@pytest.mark.parametrize("rel", _modules())
def test_module_surface(rel):
    problems = _problems(rel)
    assert not problems, "\n".join(problems)


def test_skip_list_names_only_real_parameters():
    """Each skipped knob is a parameter of the JAX function and is indeed
    absent from the port's, so the list cannot go stale."""
    for (rel, fname, param), reason in SKIPPED.items():
        assert reason
        node = _surface(rel)[fname]
        assert param in _params(node)[0], (rel, fname, param)
        ours = getattr(importlib.import_module(_port_name(rel)), fname)
        assert param not in inspect.signature(ours).parameters, \
            (rel, fname, param)


def test_port_imports_without_jax_matplotlib_h5py():
    code = (
        "import importlib, json, pkgutil, sys\n"
        f"import {PORT} as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "heavy = sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'matplotlib', 'h5py', 'velocyto_tpu'})\n"
        "print(json.dumps({'n': len(names), 'heavy': heavy}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["n"] >= len(_modules()), res
    assert res["heavy"] == [], res

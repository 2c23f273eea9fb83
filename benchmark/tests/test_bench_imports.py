"""What the benchmark's modules import, read from their source."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]
MODULES = sorted(BENCH.rglob("*.py"))


def _top_names(path):
    """Top-level names of every module that `path` imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax_import(path):
    assert not _top_names(path) & set(harness.FORBIDDEN)


YARDSTICK = [BENCH / n for n in ("reference.py", "compare.py", "roofline.py",
                                  "synth.py")] + sorted(
    (BENCH / "stages").glob("*.py"))


@pytest.mark.parametrize("path", YARDSTICK, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "velocyto_tpu_torch" not in _top_names(path)


def test_reference_loads_nothing_of_the_program():
    """Loading the reference and every stage module loads no module of
    the program (a stage drives the program only through the loom it is
    handed)."""
    code = ("import sys; from benchmark import reference, pipeline; "
            "[pipeline.stage_module(p.stem) for p in "
            "(pipeline.HERE / 'stages').glob('*.py')]; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] == 'velocyto_tpu_torch'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_top_names_compared_whole():
    # the port's name begins with the JAX package's, and is allowed
    assert "velocyto_tpu_torch".split(".")[0] not in harness.FORBIDDEN

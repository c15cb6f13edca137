"""Nothing under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the program: each module's import statements
are read from its source, and a process that imports every module of the
harness and the program's modules that the drivers load is searched for
them, all compared by whole top-level name (the program's name begins with
the JAX package's)."""

import ast
import subprocess
import sys

import pytest

from portbench.core.spec import BENCH_DIR

JAX = {"jax", "jaxlib", "flax", "multimodal_dmm_tpu"}
PROGRAM = "multimodal_dmm_tpu_torch"


def imported(path):
    """Top-level names of every module the file's import statements
    name."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH_DIR.rglob("*.py"))
REFERENCE = sorted((BENCH_DIR / "reference").rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH_DIR)))
def test_no_jax(path):
    assert not imported(path) & JAX


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    names = imported(path)
    assert PROGRAM not in names
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.level == 1, "the reference imports only itself"


def test_the_check_sees_a_planted_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom multimodal_dmm_tpu."
                   "models import dmm\n")
    assert imported(bad) == {"jax", "multimodal_dmm_tpu"}
    ok = tmp_path / "ok.py"
    ok.write_text("import multimodal_dmm_tpu_torch.models\n")
    assert not imported(ok) & JAX


def test_run_refuses_loaded_jax(monkeypatch):
    import types
    from portbench import run
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "multimodal_dmm_tpu_torch.x",
                        types.ModuleType("y"))
    assert run.forbidden_modules() == ["jax"]


def test_a_run_process_loads_no_jax():
    code = """
import importlib, pathlib, sys
sys.path.insert(0, %r)
from portbench.core import program
from portbench.core.spec import driver, reader, BENCH_DIR
import portbench.run
for p in sorted((BENCH_DIR / "drivers").glob("[a-z]*.py")):
    driver(p.stem)
for app in ("weizmann", "vidtimit"):
    program.trainer_class(app)
for p in sorted((BENCH_DIR / "metrics").glob("*.py")):
    reader(p.stem)
importlib.import_module(program.PACKAGE + ".training.device_loader")
print(portbench.run.forbidden_modules())
""" % str(BENCH_DIR.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"

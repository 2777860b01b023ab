"""No module that the benchmark reaches imports JAX or the JAX package:
every import in ``twbench/`` by its top-level name, and the modules a whole
run (on the CPU, at a tiny cut) leaves loaded. Names are compared whole
before the first dot, so ``traceweaver_tpu_torch`` is allowed."""

import ast
import os
import subprocess
import sys

from twbench import spec
from twbench.run import FORBIDDEN

PROBE = """
import sys
from twbench import calibrate, run, spec
from twbench.tests.conftest import tiny_cell
from twbench import harness
cell = tiny_cell()
reading = harness.run_cell(cell, 3, 0.2, True, device="cpu")
for m in cell.end_to_end + cell.per_layer:
    spec.reader(m["name"])(reading)
print("forbidden:" + ",".join(run.forbidden_modules()))
"""


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_source_imports_jax():
    bad = []
    for dirpath, _, files in os.walk(spec.HERE):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                bad += [(path, m) for m in _imports(path)
                        if m.split(".", 1)[0] in FORBIDDEN]
    assert not bad


def test_a_run_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=spec.ROOT)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=spec.ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "forbidden:"


def test_forbidden_names_are_whole(monkeypatch):
    from types import ModuleType

    from twbench import run

    for name in ("traceweaver_tpu_torch.x", "jaxlib_like", "jax.numpy", "traceweaver_tpu.y"):
        monkeypatch.setitem(sys.modules, name, ModuleType(name))
    found = run.forbidden_modules()
    assert "jax.numpy" in found and "traceweaver_tpu.y" in found
    assert "traceweaver_tpu_torch.x" not in found and "jaxlib_like" not in found

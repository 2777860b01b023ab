"""The PyTorch port stands alone: no module of ``traceweaver_tpu_torch``
and not ``chip_smoke.py`` loads ``jax`` or any ``traceweaver_tpu``
module, and the solver refuses to run without a card unless asked for
the CPU."""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    import traceweaver_tpu_torch

    names = ["traceweaver_tpu_torch"]
    for info in pkgutil.walk_packages(traceweaver_tpu_torch.__path__,
                                      "traceweaver_tpu_torch."):
        names.append(info.name)
    return names


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "traceweaver_tpu" or name.startswith("traceweaver_tpu."))


def test_port_modules_import_without_jax():
    mods = _port_modules()
    assert "traceweaver_tpu_torch.algorithms.weaver_torch" in mods
    assert "traceweaver_tpu_torch.ops.cuda_sinkhorn" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded if _forbidden(m)]
    assert "traceweaver_tpu_torch.algorithms.weaver_torch" in loaded


@pytest.mark.parametrize("path", ["chip_smoke.py", "traceweaver_tpu_torch"])
def test_no_jax_imports_in_source(path):
    """AST check over the smoke script and every port source file."""
    full = os.path.join(REPO, path)
    files = [full] if full.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(full) for f in fs
        if f.endswith(".py")]
    assert files
    for f in files:
        tree = ast.parse(open(f).read(), f)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not [n for n in names if _forbidden(n)], (f, names)


def test_weaver_torch_without_card_raises(monkeypatch):
    from traceweaver_tpu_torch.algorithms.weaver_torch import WeaverTorch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        WeaverTorch({}, {})
    assert WeaverTorch({}, {}, device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_without_card():
    """No card: non-zero exit and no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_bf16_refused():
    from traceweaver_tpu_torch.ops.precision import validate_precision

    assert validate_precision("float32") == "f32"
    with pytest.raises(NotImplementedError, match="later slice"):
        validate_precision("bf16")
    with pytest.raises(ValueError):
        validate_precision("bf61")

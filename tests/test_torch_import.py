"""The PyTorch port stands alone: no module of ``traceweaver_tpu_torch``
and not ``chip_smoke.py`` loads ``jax``, ``networkx`` or any
``traceweaver_tpu`` module, the port reads no ``TW_*`` environment
variable, and the solver refuses to run without a card unless asked for
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
    return any(name == top or name.startswith(top + ".")
               for top in ("jax", "networkx", "traceweaver_tpu"))


#: modules of the port and the JAX module each mirrors
MIRRORS = {
    "traceweaver_tpu_torch.algorithms.weaver_torch": "traceweaver_tpu/algorithms/weaver_tpu.py",
    "traceweaver_tpu_torch.ops.cuda_sinkhorn": "traceweaver_tpu/ops/pallas_sinkhorn.py",
    "traceweaver_tpu_torch.algorithms.fleet": "traceweaver_tpu/algorithms/fleet.py",
    "traceweaver_tpu_torch.runtime.faults": "traceweaver_tpu/runtime/faults.py",
    "traceweaver_tpu_torch.synth.transforms": "traceweaver_tpu/synth/transforms.py",
    "traceweaver_tpu_torch.metrics.synth": "traceweaver_tpu/metrics/scorecard.py",
    "traceweaver_tpu_torch.algorithms.plancache": "traceweaver_tpu/algorithms/plancache.py",
    "traceweaver_tpu_torch.algorithms.packed_layout":
        "traceweaver_tpu/algorithms/packed_layout.py",
    "traceweaver_tpu_torch.obs.quality": "traceweaver_tpu/obs/quality.py",
    "traceweaver_tpu_torch.spans": "traceweaver_tpu/spans.py",
    "traceweaver_tpu_torch.metrics": "traceweaver_tpu/metrics",
    "traceweaver_tpu_torch.metrics.accuracy": "traceweaver_tpu/metrics/accuracy.py",
    "traceweaver_tpu_torch.synth": "traceweaver_tpu/synth",
    "traceweaver_tpu_torch.ingest": "traceweaver_tpu/ingest",
    "traceweaver_tpu_torch.ingest.repair": "traceweaver_tpu/ingest/repair.py",
    "traceweaver_tpu_torch.ingest.jaeger": "traceweaver_tpu/ingest/jaeger.py",
    "traceweaver_tpu_torch.ingest.partition": "traceweaver_tpu/ingest/partition.py",
    "traceweaver_tpu_torch.ingest.order": "traceweaver_tpu/ingest/order.py",
    "traceweaver_tpu_torch.algorithms": "traceweaver_tpu/algorithms",
    "traceweaver_tpu_torch.algorithms.fcfs": "traceweaver_tpu/algorithms/fcfs.py",
    "traceweaver_tpu_torch.algorithms.arrival_order":
        "traceweaver_tpu/algorithms/arrival_order.py",
    "traceweaver_tpu_torch.algorithms.vpath": "traceweaver_tpu/algorithms/vpath.py",
    "traceweaver_tpu_torch.algorithms.wap5": "traceweaver_tpu/algorithms/wap5.py",
    "traceweaver_tpu_torch.algorithms.mwis": "traceweaver_tpu/algorithms/mwis.py",
    "traceweaver_tpu_torch.algorithms.weaver_exact":
        "traceweaver_tpu/algorithms/weaver_exact.py",
    "traceweaver_tpu_torch.alibaba": "traceweaver_tpu/alibaba",
    "traceweaver_tpu_torch.alibaba.schema": "traceweaver_tpu/alibaba/schema.py",
    "traceweaver_tpu_torch.alibaba.convert": "traceweaver_tpu/alibaba/convert.py",
    "traceweaver_tpu_torch.alibaba.grouping": "traceweaver_tpu/alibaba/grouping.py",
    "traceweaver_tpu_torch.alibaba.synthesize": "traceweaver_tpu/alibaba/synthesize.py",
    "traceweaver_tpu_torch.alibaba.preprocess": "traceweaver_tpu/alibaba/preprocess.py",
    "traceweaver_tpu_torch.runtime.executor": "traceweaver_tpu/runtime/executor.py",
    "traceweaver_tpu_torch.runtime.cli": "traceweaver_tpu/runtime/cli.py",
    "traceweaver_tpu_torch.native": "traceweaver_tpu/native/__init__.py",
    "traceweaver_tpu_torch.obs.registry": "traceweaver_tpu/obs/registry.py",
    "traceweaver_tpu_torch.obs.exposition": "traceweaver_tpu/obs/exposition.py",
    "traceweaver_tpu_torch.obs.events": "traceweaver_tpu/obs/events.py",
    "traceweaver_tpu_torch.obs.profile": "traceweaver_tpu/obs/profile.py",
    "traceweaver_tpu_torch.query": "traceweaver_tpu/query",
    "traceweaver_tpu_torch.query.delay_culprit": "traceweaver_tpu/query/delay_culprit.py",
    "traceweaver_tpu_torch.metrics.scorecard": "traceweaver_tpu/metrics/scorecard.py",
    "traceweaver_tpu_torch.ops.scores": "traceweaver_tpu/ops/scores.py",
    "traceweaver_tpu_torch.ops.precision": "traceweaver_tpu/ops/precision.py",
    "traceweaver_tpu_torch.ops.sinkhorn": "traceweaver_tpu/ops/sinkhorn.py",
    "traceweaver_tpu_torch.runtime.ladder": "exps/exp5/run_experiment.sh",
    "traceweaver_tpu_torch.obs.selftrace": "traceweaver_tpu/obs/selftrace.py",
    "traceweaver_tpu_torch.stream": "traceweaver_tpu/stream",
    "traceweaver_tpu_torch.stream.watermark": "traceweaver_tpu/stream/watermark.py",
    "traceweaver_tpu_torch.stream.window": "traceweaver_tpu/stream/window.py",
    "traceweaver_tpu_torch.stream.sources": "traceweaver_tpu/stream/sources.py",
    "traceweaver_tpu_torch.stream.state": "traceweaver_tpu/stream/state.py",
    "traceweaver_tpu_torch.stream.scheduler": "traceweaver_tpu/stream/scheduler.py",
    "traceweaver_tpu_torch.stream.checkpoint": "traceweaver_tpu/stream/checkpoint.py",
    "traceweaver_tpu_torch.stream.service": "traceweaver_tpu/stream/service.py",
    "traceweaver_tpu_torch.stream.wal": "traceweaver_tpu/stream/wal.py",
    "traceweaver_tpu_torch.ops.devcols": "traceweaver_tpu/ops/devcols.py",
    "traceweaver_tpu_torch.ingest.wire": "traceweaver_tpu/ingest/wire.py",
    "traceweaver_tpu_torch.serve": "traceweaver_tpu/serve",
    "traceweaver_tpu_torch.serve.ring": "traceweaver_tpu/serve/ring.py",
    "traceweaver_tpu_torch.serve.tenancy": "traceweaver_tpu/serve/tenancy.py",
    "traceweaver_tpu_torch.serve.continuous": "traceweaver_tpu/serve/continuous.py",
    "traceweaver_tpu_torch.serve.http": "traceweaver_tpu/serve/http.py",
    "traceweaver_tpu_torch.collector": "traceweaver_tpu/collector/__init__.py",
    "traceweaver_tpu_torch.collector._rfc7541": "traceweaver_tpu/collector/_rfc7541.py",
    "traceweaver_tpu_torch.collector.hpack": "traceweaver_tpu/collector/hpack.py",
    "traceweaver_tpu_torch.collector.http2": "traceweaver_tpu/collector/http2.py",
    "traceweaver_tpu_torch.collector.strace": "traceweaver_tpu/collector/strace.py",
    "traceweaver_tpu_torch.collector.threading_model":
        "traceweaver_tpu/collector/threading_model.py",
    "traceweaver_tpu_torch.collector.skew": "traceweaver_tpu/collector/skew.py",
    "traceweaver_tpu_torch.collector.source": "traceweaver_tpu/collector/source.py",
    "traceweaver_tpu_torch.collector.ebpf": "traceweaver_tpu/collector/ebpf.py",
    "traceweaver_tpu_torch.collector.strace_runner":
        "traceweaver_tpu/collector/strace_runner.py",
    "traceweaver_tpu_torch.adapt": "traceweaver_tpu/adapt/__init__.py",
    "traceweaver_tpu_torch.adapt.controller": "traceweaver_tpu/adapt/controller.py",
    "traceweaver_tpu_torch.adapt.refit": "traceweaver_tpu/adapt/refit.py",
    "traceweaver_tpu_torch.synth.capture": "bench.py",
    "traceweaver_tpu_torch.campaign": "traceweaver_tpu/campaign",
    "traceweaver_tpu_torch.campaign.ledger": "traceweaver_tpu/campaign/ledger.py",
    "traceweaver_tpu_torch.campaign.compare": "traceweaver_tpu/campaign/compare.py",
    "traceweaver_tpu_torch.campaign.plan": "traceweaver_tpu/campaign/plan.py",
    "traceweaver_tpu_torch.campaign.corpus": "traceweaver_tpu/campaign/corpus.py",
    "traceweaver_tpu_torch.campaign.runner": "traceweaver_tpu/campaign/runner.py",
    "traceweaver_tpu_torch.parallel": "traceweaver_tpu/parallel",
    "traceweaver_tpu_torch.parallel.mesh": "traceweaver_tpu/parallel/mesh.py",
    "traceweaver_tpu_torch.parallel.multislice": "traceweaver_tpu/parallel/multislice.py",
    "traceweaver_tpu_torch.ops.gmm": "traceweaver_tpu/ops/gmm.py",
    "traceweaver_tpu_torch.fleet_serve": "traceweaver_tpu/fleet_serve/__init__.py",
    "traceweaver_tpu_torch.fleet_serve.router": "traceweaver_tpu/fleet_serve/router.py",
    "traceweaver_tpu_torch.fleet_serve.manager": "traceweaver_tpu/fleet_serve/manager.py",
    "traceweaver_tpu_torch.fleet_serve.campaign": "traceweaver_tpu/fleet_serve/campaign.py",
}


def test_port_modules_import_without_jax():
    mods = _port_modules()
    assert set(MIRRORS) <= set(mods)
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
    assert set(MIRRORS) <= set(loaded)


@pytest.mark.parametrize("module", sorted(MIRRORS))
def test_module_names_the_jax_module_it_mirrors(module):
    import importlib

    doc = importlib.import_module(module).__doc__ or ""
    assert MIRRORS[module] in " ".join(doc.split()).replace("``", "")


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


@pytest.mark.parametrize("path", ["chip_smoke.py", "traceweaver_tpu_torch"])
def test_no_tw_environment_knobs(path):
    """Every JAX knob is an argument or a flag in the port."""
    full = os.path.join(REPO, path)
    files = [full] if full.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(full) for f in fs
        if f.endswith(".py")]
    for f in files:
        tree = ast.parse(open(f).read(), f)
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                    "get", "getenv", "setdefault") and node.args and isinstance(
                    node.args[0], ast.Constant) and str(node.args[0].value).startswith("TW_"):
                raise AssertionError(f"{f}: reads {node.args[0].value}")
            if isinstance(node, ast.Subscript) and isinstance(node.slice, ast.Constant) \
                    and str(node.slice.value).startswith("TW_"):
                raise AssertionError(f"{f}: reads {node.slice.value}")


def test_fleet_tier_imports_no_torch():
    """The fleet's router, manager and campaign, the campaign ledger and
    compare, and the ``fleet`` subcommand's parsing load no torch (so no
    CUDA): the replicas own the card."""
    code = (
        "import json, sys\n"
        "import traceweaver_tpu_torch.fleet_serve.campaign\n"
        "import traceweaver_tpu_torch.campaign\n"
        "from traceweaver_tpu_torch.runtime import cli\n"
        "assert cli.main(['fleet', 'serve', '--replicas', '0', '--state-dir', 'x']) == 2\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "torch" not in loaded and not [m for m in loaded if _forbidden(m)]


def test_weaver_torch_without_card_raises(monkeypatch):
    from traceweaver_tpu_torch.algorithms.weaver_torch import WeaverTorch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        WeaverTorch({}, {})
    assert WeaverTorch({}, {}, device="cpu").device.type == "cpu"


def test_entry_points_without_card_raise(monkeypatch, tmp_path):
    """``make_predictors``, ``run_experiment`` and the CLI raise (or exit
    non-zero) with no card and no device, before reading any data."""
    from traceweaver_tpu_torch.algorithms import make_predictors
    from traceweaver_tpu_torch.runtime import cli, executor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_predictors({}, {})
    assert [m for m, _ in make_predictors({}, {}, device="cpu")][8:] == [
        "MaxScoreBatchParallelWithoutIterations", "MaxScoreBatchParallel",
        "MaxScoreBatchSubsetWithSkips"]
    missing = str(tmp_path / "absent")
    with pytest.raises(RuntimeError, match="CUDA"):
        executor.run_experiment(executor.ExecutorConfig(
            data_path=missing, results_directory="", fix=5))
    assert cli.main(["--absolute_path", missing, "--fix", "5", "--cache_rate", "0",
                     "--results_directory", str(tmp_path / "out")]) != 0
    assert not (tmp_path / "out").exists()


def test_chip_smoke_refuses_without_card():
    """No card: non-zero exit and no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_bf16_refused():
    """Only a misspelt precision is refused; bf16 is a precision of the
    port (it was refused until the bf16 score path came)."""
    from traceweaver_tpu_torch.ops.precision import validate_precision

    assert validate_precision("float32") == "f32"
    assert validate_precision("bf16") == "bf16"
    with pytest.raises(ValueError):
        validate_precision("bf61")


def test_known_event_kinds_list_every_kind_the_port_emits():
    """Every ``emit("<kind>", ...)`` of the port's event sink names a kind
    that ``obs/events.py`` ``KNOWN_KINDS`` lists (``cli events --kind``'s
    help)."""
    import re

    from traceweaver_tpu_torch.obs.events import KNOWN_KINDS

    root = os.path.join(REPO, "traceweaver_tpu_torch")
    emitted = set()
    for d, _, fs in os.walk(root):
        for f in fs:
            if f.endswith(".py"):
                text = open(os.path.join(d, f)).read()
                emitted |= set(re.findall(r"\bemit\(\s*\"([a-z_]+)\"", text))
    assert {"fault_injected", "confidence_drift", "serve", "slo_breach",
            "capture_loss", "capture_churn", "clock_skew", "adapt"} <= emitted
    assert emitted <= set(KNOWN_KINDS), emitted - set(KNOWN_KINDS)
    # the fleet's supervisor emits its ladder under a variable kind
    assert "fault_ladder" in KNOWN_KINDS

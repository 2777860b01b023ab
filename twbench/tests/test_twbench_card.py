"""On the card: one short run of the cheapest cell comes out correct, and
the control (the program's bf16 score path) does not. Skips without a
card; run with ``python -m pytest -m gpu twbench/tests``."""

import json
import os
import subprocess
import sys

import pytest

from twbench import spec
from twbench.run import judge


def _cli(module, *args):
    env = dict(os.environ, PYTHONPATH=spec.ROOT)
    out = subprocess.run([sys.executable, "-m", module, *args], cwd=spec.ROOT, env=env,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    return [json.loads(l) for l in out.stdout.splitlines() if l.startswith("{")]


@pytest.mark.gpu
def test_short_run_is_correct(card):
    result = _cli("twbench.run", "--workload", "exp5-steady", "--seed", "4000000001",
                  "--seconds", "2", "--trace", "0")[-1]
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"setup_s", "spans_per_s", "accuracy_pct"}
    assert result["device"]["platform"] == "gpu"


@pytest.mark.gpu
def test_control_is_not_correct(card):
    line = _cli("twbench.calibrate", "--workload", "exp5-steady", "--seeds", "4000000002",
                "--modes", "control", "--seconds", "1")[-1]
    correct, table = judge(line["checks"], spec.limits(spec.load_cell("exp5-steady").config))
    assert not correct, table

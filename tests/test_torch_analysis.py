"""The port's lint (``traceweaver_tpu_torch/analysis``) against the JAX
package's (``traceweaver_tpu/analysis``), and the port's gate.

- engine parity: the same snippets (the suppression tag translated) give
  JAX's suppression tables, fingerprints, baseline parse and baseline
  lines; neither engine reads the other's tag;
- rule parity: the JAX package's own fixtures of TW004 (inline pow2
  bucketing), TW005, TW007, TW008, TW010, TW012 and TW013, each under its
  own package's path, flag the same (rule, line, col) in both;
- the port's idiom: a flagged and a clean case for TW003, TW006, TW009,
  TW101, TW102, TW103 and TW111;
- the gate: the port's tree is clean, ``python -m
  traceweaver_tpu_torch.analysis`` exits 0 without importing torch, and
  ``cli lint --list-rules`` works;
- mutated copies of port files under ``tmp_path`` make the CLI exit 1.

Stdlib ``ast`` only on both sides: no backend work.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from traceweaver_tpu.analysis import engine as jeng
from traceweaver_tpu_torch.analysis import engine as teng
from traceweaver_tpu_torch.analysis.engine import META_RULE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "traceweaver_tpu_torch/"


def lint(src, path="traceweaver_tpu_torch/mod.py"):
    return teng.analyze_sources([(path, textwrap.dedent(src))])


def rules_of(findings):
    return [f.rule for f in findings]


def to_port_tag(text):
    return text.replace("# twlint:", "# twlint-torch:")


# ---------------------------------------------------------------------------
# engine parity
# ---------------------------------------------------------------------------

SUPPRESSION_SNIPPETS = [
    """
    x = 1  # twlint: disable=TW005 — same line
    """,
    """
    # twlint: disable=TW005, TW007 — a comment line covers the next code line

    y = 2
    """,
    """
    # twlint: disable-file=TW012
    z = 3  # twlint: disable=TW999
    """,
    """
    def f():
        # twlint: disable=TW013 -- ascii dash
        return g()  # twlint: disable=TW008: colon reason
    """,
]


@pytest.mark.parametrize("snippet", range(len(SUPPRESSION_SNIPPETS)))
def test_suppression_table_matches_jax(snippet):
    text = textwrap.dedent(SUPPRESSION_SNIPPETS[snippet])
    known = {"TW005", "TW007", "TW008", "TW012", "TW013", META_RULE}
    j = jeng.parse_suppressions(text, known)
    t = teng.parse_suppressions(to_port_tag(text), known)
    assert (t.by_line, t.file_wide, t.bad_ids) == (j.by_line, j.file_wide, j.bad_ids)
    assert j.by_line or j.file_wide


def test_neither_engine_reads_the_others_tag():
    known = {"TW005", META_RULE}
    jax_tag = "x = 1  # twlint: disable=TW005 — reason\n"
    port_tag = "x = 1  # twlint-torch: disable=TW999 — reason\n"
    assert not teng.parse_suppressions(jax_tag, known).by_line
    j = jeng.parse_suppressions(port_tag, known)
    assert not j.by_line and not j.bad_ids


def test_fingerprints_match_jax():
    args = ("TW005", "traceweaver_tpu_torch/x.py", 7, 4, "msg", "    self.d[k] = 0")
    jf, tf = jeng.Finding(*args), teng.Finding(*args)
    assert tf.fingerprint() == jf.fingerprint()
    assert tf.render() == jf.render()
    moved = teng.Finding("TW005", args[1], 90, 4, "msg", "self.d[k] = 0")
    assert moved.fingerprint() == tf.fingerprint()


def test_baseline_parse_and_format_match_jax(tmp_path):
    findings = [("TW005", "traceweaver_tpu_torch/b.py", 3, 0, "second", "y = 2"),
                ("TW007", "traceweaver_tpu_torch/a.py", 9, 2, "first", "x[k] += 1")]
    jtext = jeng.format_baseline([jeng.Finding(*f) for f in findings])
    ttext = teng.format_baseline([teng.Finding(*f) for f in findings])

    def entries(text):
        return [ln for ln in text.splitlines() if ln and not ln.startswith("#")]

    assert entries(ttext) == entries(jtext) and len(entries(ttext)) == 2
    bl = tmp_path / "baseline.txt"
    bl.write_text(ttext.replace("TODO justify", "kept"))
    assert teng.load_baseline(str(bl)) == jeng.load_baseline(str(bl))
    bad = tmp_path / "bad.txt"
    bad.write_text("TW005 traceweaver_tpu_torch/b.py abcdef123456\n")
    with pytest.raises(teng.BaselineError):
        teng.load_baseline(str(bad))
    bad.write_text(f"{META_RULE} traceweaver_tpu_torch/b.py abcdef123456  # no\n")
    with pytest.raises(teng.BaselineError):
        teng.load_baseline(str(bad))


RAW_READ = """
    import os

    def f():
        return os.environ.get("TW_FOO", "1")
"""


def test_suppressions_and_unknown_ids():
    findings, suppressed = lint(RAW_READ)
    assert rules_of(findings) == ["TW101"] and suppressed == 0
    src = RAW_READ.replace('"1")', '"1")  # twlint-torch: disable=TW101 — test')
    assert lint(src) == ([], 1)
    src = "# twlint-torch: disable-file=TW101\n" + textwrap.dedent(RAW_READ)
    assert teng.analyze_sources([("traceweaver_tpu_torch/m.py", src)]) == ([], 1)
    src = RAW_READ.replace('"1")', '"1")  # twlint-torch: disable=TW999')
    assert sorted(rules_of(lint(src)[0])) == [META_RULE, "TW101"]


def test_baseline_roundtrip_and_staleness(tmp_path):
    root = tmp_path / "repo"
    (root / "traceweaver_tpu_torch").mkdir(parents=True)
    mod = root / "traceweaver_tpu_torch" / "mod.py"
    mod.write_text(textwrap.dedent(RAW_READ))
    report = teng.run(root=str(root), baseline_path=None)
    (f,) = report.findings
    bl = tmp_path / "baseline.txt"
    bl.write_text(f"{f.rule} {f.path} {f.fingerprint()}  # grandfathered\n")
    report = teng.run(root=str(root), baseline_path=str(bl))
    assert report.ok and report.baselined == 1
    mod.write_text("def f():\n    return 1\n")
    report = teng.run(root=str(root), baseline_path=str(bl))
    assert rules_of(report.findings) == [META_RULE]
    assert "stale" in report.findings[0].message


def test_default_scan_is_the_port_and_its_smoke(tmp_path):
    for rel in ("traceweaver_tpu_torch/a.py", "traceweaver_tpu_torch/_build/x.py",
                "traceweaver_tpu/b.py", "chip_smoke.py", "other.py"):
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text("x = 1\n")
    assert teng.iter_python_files(str(tmp_path)) == [
        "chip_smoke.py", "traceweaver_tpu_torch/a.py"]


# ---------------------------------------------------------------------------
# rule parity with the JAX package's fixtures
# ---------------------------------------------------------------------------

PARITY = {
    "TW004-inline": ("TW004", "algorithms/timing.py", """
        def pad(n):
            return 1 << (n - 1).bit_length()
    """),
    "TW004-bucketing-module": ("TW004", "runtime/bucketing.py", """
        def pad(n):
            return 1 << (n - 1).bit_length()
    """),
    "TW005-unlocked": ("TW005", "mod.py", """
        import threading

        class Stats:
            def __init__(self):
                self._lock = threading.Lock()
                self.d = {}
                self.events = []

            def add(self, k):
                with self._lock:
                    self.d[k] = self.d.get(k, 0) + 1
                    self.events.append(k)

            def racy(self, k):
                self.d[k] = 0

            def racy_mutator(self, k):
                self.events.append(k)

            def fine(self):
                self.unguarded_elsewhere = 1
    """),
    "TW005-closure": ("TW005", "mod.py", """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.d = {}

            def locked(self, k):
                with self._lock:
                    self.d[k] = 1

                    def cb():
                        self.d[k] = 2
                    return cb
    """),
    "TW007-counters": ("TW007", "algorithms/fleet.py", """
        _COUNTERS = {"hits": 0, "misses": 0}

        def f(stats, key):
            stats[key] += 1

        def g(d, k, v):
            d[k] = d.get(k, 0.0) + v
    """),
    "TW007-sanctioned": ("TW007", "stream/service.py", """
        STAGES = {"pack": "host", "decode": "host"}

        class _Stats:
            def add(self, key, val=1.0):
                self.d[key] = self.d.get(key, 0.0) + val

        class Svc:
            def _bump(self, key, n=1):
                self.stats[key] = self.stats.get(key, 0) + n

            def offer(self):
                self.shed_spilled += 1

            def leak(self, key):
                self.stats[key] += 1
    """),
    "TW008-channels": ("TW008", "algorithms/fleet.py", """
        def decode(o):
            assign = o[..., 0]
            not_best = o[..., 1].astype(bool)
            topk = o[..., 3:]
            tail = o[..., :5]
            extra = o[..., None]
            r0 = o[:, :, 0]
            return assign, not_best, topk, tail, extra, r0
    """),
    "TW008-layout-module": ("TW008", "algorithms/packed_layout.py", """
        def split(block):
            return block[..., 0], block[..., 3:]
    """),
    "TW010-bare": ("TW010", "adapt/refit.py", """
        def sneak_refit(svc, material):
            outs = solve_fleet([material])
            dists = refit_from_assignments({}, {}, None, outs[0][0], {})
            svc.carried.update("svc", dists)

        def execute(svc, ctrl, key, material):
            outs = solve_fleet([material])
            ctrl.refit_done(key, ok=True)
    """),
    "TW010-private": ("TW010", "stream/service.py", """
        def pump(self):
            self.adapt._keys.clear()
            svc.adapt._act("refit", "k")
            self.adapt.observe("k", psi=0.5, low_rate=0.0)
    """),
    "TW012-mutations": ("TW012", "serve/tenancy.py", """
        class TenantService:
            def prune(self, t, buf):
                t.in_flight.remove(buf)

            def reset(self, t):
                t.in_flight.clear()
                t.in_flight[:] = []
                t.in_flight = []
                t.in_flight += [1]

            def submit_admitted(self, plan):
                for t, bufs in plan:
                    t.in_flight.extend(bufs)
    """),
    "TW013-acks": ("TW013", "serve/http.py", """
        class Handler:
            def do_POST(self):
                self._reply(200, self.service.ingest(tid, payload))
                self._reply(200, self.service.ingest_capture(tid, caps))
                self._reply(201, dict(self.service.ingest(tid, payload)))
                self._reply(200, self.service.wal_ingest(tid, payload))
                self._reply(400, {"error": self.service.ingest(tid, p)})
    """),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_rule_parity_with_jax(case):
    rule, rel, src = PARITY[case]
    text = textwrap.dedent(src)
    jf, _ = jeng.analyze_sources([("traceweaver_tpu/" + rel, text)])
    tf, _ = teng.analyze_sources([(PORT + rel, text)])

    def keys(fs):
        return [(f.rule, f.line, f.col) for f in fs if f.rule == rule]

    assert keys(tf) == keys(jf)
    if case in ("TW004-bucketing-module", "TW008-layout-module"):
        assert keys(tf) == []
    else:
        assert keys(tf)


def test_tw013_port_guard_is_the_tenant_wal_field():
    src = """
        class Handler:
            def do_POST(self):
                if self.service.cfg.wal:
                    self._reply(200, self.service.wal_ingest(tid, payload))
                else:
                    self._reply(200, self.service.ingest(tid, payload))
    """
    assert lint(src, PORT + "serve/http.py")[0] == []
    assert lint(src, PORT + "fleet_serve/router.py")[0] == []


# ---------------------------------------------------------------------------
# the port's idiom
# ---------------------------------------------------------------------------

FLEET = PORT + "algorithms/fleet.py"
OPS = PORT + "ops/mod.py"

IDIOM = {
    "TW003": (FLEET, """
        import numpy as np
        import torch

        def f(x):
            out = solve_windows_fleet(x)
            return out.cpu().numpy()

        def g(x, dev):
            t = x.to(dev)
            return t.item(), int(t), float(t.sum())

        def h(xs):
            pending = []
            for x in xs:
                pending.append(fused_assign(x))
            return [np.asarray(p) for p in pending]

        def k():
            torch.cuda.synchronize()
    """, 6, """
        import numpy as np

        def _fetch(t, st, plan):
            return t.cpu().numpy()

        def f(x, st, plan):
            out = solve_windows_fleet(x)
            host = _fetch(out, st, plan)
            return float(host[0]), x.to(torch.float32).sum()

        def g(spans):
            a = np.array([s.start for s in spans])
            return np.asarray(a).tolist()
    """),
    "TW006": (OPS, """
        import torch

        def f(x):
            s = x.to(torch.bfloat16)
            return torch.sum(s)

        def g(x):
            return x.bfloat16().sum()

        def h(a, b):
            return a.to(dtype=torch.bfloat16) @ b

        def k(n):
            z = torch.zeros(n, dtype=torch.bfloat16)
            return torch.logsumexp(z, dim=0), z.cumsum(0)
    """, 5, """
        import torch

        def f(x, b):
            s = x.to(torch.bfloat16)
            return (s.float().sum(), torch.sum(s, dtype=torch.float32),
                    s.to(torch.float32) @ b, torch.einsum("ij,jk->ik", s.float(), b))

        def g(x):
            return x.to(torch.float16).sum()
    """),
    "TW009": (FLEET, """
        import numpy as np

        def dispatch(ring_in, ring_out, idx):
            outs = assemble_resident(ring_in, ring_out, idx)
            return np.asarray(outs[0]), outs[1].cpu()

        def peek(ring):
            buf = ring.buf
            return buf.numpy()
    """, 3, """
        def grab(ring, idx):
            outs = assemble_resident(ring, ring, idx)
            return fetch_resident(ring.buf), fetch_resident(outs[0])
    """),
    "TW101": (PORT + "runtime/cli.py", """
        import os

        def f():
            return (os.environ.get("TW_PRECISION"), os.getenv("TW_FOO"),
                    os.environ["TW_BAR"])
    """, 3, """
        import os

        def f(env):
            os.environ["TW_FOO"] = "1"
            os.environ.setdefault("TW_BAR", "0")
            env["TW_X"] = "1"
            return os.environ.get("CUDA_HOME"), os.environ.get("HOME")
    """),
    "TW102": (PORT + "ops/scores.py", """
        import importlib

        import jax
        import jax.numpy as jnp
        import networkx as nx
        from sklearn import mixture
        from traceweaver_tpu.ops import scores
        import traceweaver_tpu.spans

        def f():
            return importlib.import_module("traceweaver_tpu.algorithms.fleet")
    """, 7, """
        import importlib

        import torch
        import traceweaver_tpu_torch
        from traceweaver_tpu_torch.ops import scores
        from . import gmm

        def f(name):
            return (importlib.import_module("traceweaver_tpu_torch.spans"),
                    importlib.import_module(name))
    """),
    "TW103": (PORT + "ops/cuda_sinkhorn.py", """
        import torch

        def launch(S):
            if torch.cuda.is_available():
                return run(S)
            return None

        def assign(S):
            try:
                return fused_assign_cuda(S)
            except RuntimeError:
                return assign_topk_plain(S)
    """, 2, """
        import torch

        def launch(S):
            if S.device.type == "cpu":
                return assign_topk_plain(S)
            try:
                return fused_assign_cuda(S)
            except RuntimeError as e:
                raise RuntimeError("K1 failed") from e

        def resolve(device):
            # twlint-torch: disable=TW103 — raises with no card
            if not torch.cuda.is_available():
                raise RuntimeError("no card")
    """),
    "TW111": (PORT + "ops/cuda_sinkhorn.py", """
        import ctypes
        import subprocess

        from traceweaver_tpu_torch.ops import cuda_build

        def load(path):
            return ctypes.CDLL(path)

        def build_again(src):
            subprocess.run(["nvcc", "-o", "x.so", src], check=True)
            return cuda_build.nvcc()

        def sinkhorn_cuda(lib, dev):
            with torch.cuda.device(dev):
                return lib.tw_sinkhorn(0)
    """, 4, """
        import ctypes

        def _lib():
            lib = ctypes.CDLL(build())
            lib.tw_sinkhorn.argtypes = []
            return lib

        def sinkhorn_cuda(dev):
            lib = _lib()
            with torch.cuda.device(dev), _launch_lock:
                err = lib.tw_sinkhorn(0)
            return err
    """),
}


@pytest.mark.parametrize("rule", sorted(IDIOM))
def test_port_idiom_flagged_and_clean(rule):
    path, flagged, n, clean = IDIOM[rule]
    findings, _ = lint(flagged, path)
    assert rules_of(findings).count(rule) == n, "\n".join(f.render() for f in findings)
    findings, _ = lint(clean, path)
    assert [f for f in findings if f.rule == rule] == [], \
        "\n".join(f.render() for f in findings)


def test_scope_of_the_path_bound_rules():
    """TW003 reads only the hot modules, TW006 only ``ops/``, TW111's lock
    half only ``ops/cuda_sinkhorn.py``, and the build module may run nvcc."""
    assert lint(IDIOM["TW003"][1], PORT + "parallel/mesh.py")[0] == []
    assert lint(IDIOM["TW006"][1], PORT + "stream/window.py")[0] == []
    assert lint("""
        def f(lib):
            return lib.tw_assemble_block(0)
    """, PORT + "ops/scores.py")[0] == []
    assert lint("""
        import subprocess

        def build(src):
            subprocess.run(["nvcc", src], check=True)
            return nvcc()
    """, PORT + "ops/cuda_build.py")[0] == []


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

def test_port_is_lint_clean():
    report = teng.run()
    assert report.files > 100  # the walk really saw the port
    assert report.ok, "\n" + report.render()
    assert report.baselined == 0


def _py(code, cwd=REPO):
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=cwd, timeout=120)


def test_gate_subprocess_exits_0_without_torch():
    proc = subprocess.run([sys.executable, "-m", "traceweaver_tpu_torch.analysis"],
                          capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout
    for call in ("from traceweaver_tpu_torch.analysis.__main__ import main",
                 "from traceweaver_tpu_torch.runtime.cli import main"):
        args = "[]" if "analysis" in call else "['lint']"
        proc = _py(f"import sys\n{call}\nrc = main({args})\n"
                   "print('LOADED', 'torch' in sys.modules, 'numpy' in sys.modules)\n"
                   "sys.exit(rc)")
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "LOADED False False" in proc.stdout


def test_cli_lint_list_rules(capsys):
    from traceweaver_tpu_torch.analysis.__main__ import main as lint_main
    from traceweaver_tpu_torch.analysis.rules import RULE_CLASSES
    from traceweaver_tpu_torch.runtime import cli

    assert lint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    ids = [cls.id for cls in RULE_CLASSES]
    assert len(set(ids)) == len(ids) == 14
    for rid in ids:
        assert rid in out
    assert cli.main(["lint", "--list-rules"]) == 0
    assert lint_main(["--bogus-flag"]) == 2


MUTATIONS = {
    "import-jax": ("ops/scores.py", "\nimport jax  # noqa: F401\n"),
    "tw-env-read": ("ops/precision.py",
                    "\n\ndef _precision_from_env():\n    import os\n\n"
                    "    return os.environ.get(\"TW_PRECISION\")\n"),
    "unledgered-cpu": ("algorithms/fleet.py",
                       "\n\ndef _peek(x):\n    out = solve_windows_fleet(x)\n"
                       "    return out.cpu()\n"),
    "is-available-gate": ("ops/cuda_sinkhorn.py",
                          "\n\ndef _gate(S):\n    if torch.cuda.is_available():\n"
                          "        return sinkhorn_cuda(S)\n    return None\n"),
    "launch-outside-lock": ("ops/cuda_sinkhorn.py",
                            "\n\ndef _bare():\n    lib = _lib()\n"
                            "    return lib.tw_sinkhorn(0)\n"),
    "control": (None, None),
}


@pytest.mark.parametrize("case", sorted(MUTATIONS))
def test_mutated_copy_exits_1(case, tmp_path):
    rel, tail = MUTATIONS[case]
    files = ("ops/scores.py", "ops/precision.py", "algorithms/fleet.py",
             "ops/cuda_sinkhorn.py")
    for f in files:
        dst = tmp_path / PORT / f
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(os.path.join(REPO, PORT, f), dst)
    if rel is not None:
        with open(tmp_path / PORT / rel, "a") as fh:
            fh.write(tail)
    proc = subprocess.run(
        [sys.executable, "-m", "traceweaver_tpu_torch.analysis", "--root",
         str(tmp_path), "--no-baseline"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == (0 if rel is None else 1), proc.stdout + proc.stderr
    assert f"across {len(files)} file(s)" in proc.stdout

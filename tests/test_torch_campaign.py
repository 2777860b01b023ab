"""The port's campaign runner against the JAX package's (CPU).

- plan validation: every malformed plan the JAX package refuses, the
  port refuses (``PlanError``), and valid plans round-trip; the knob
  profile becomes solve arguments;
- the corpus ladder: the same seed gives a byte-identical corpus in
  both packages, with a manifest equal to the JAX package's (all but
  its ``root``, the directory it was built in), and a second build
  reuses the bytes;
- ``run_campaign(mini_plan(devices=2))`` on the CPU (a two-shard CPU
  mesh): each rung's ``e2e_pct`` within 0.5 pt of the JAX package's mini
  run on two of its virtual devices, the artifact's keys equal JAX's,
  zero kernel builds in the steady rounds, the multislice slices agree;
- the events and ``tw_campaign_*`` metrics of a run equal its artifact;
- the CLI: ``campaign run --mini --device cpu``, ``report`` and a
  self-``compare``; both packages' ``campaign run`` on one small plan
  and ``compare`` in both directions with both packages' ``compare``
  (throughput tolerance 100%: the two implementations' CPU speeds are
  not what is compared); ``run`` without a card refuses before it
  loads anything.
"""

import copy
import json
import os
import random
import subprocess
import sys

import pytest
import torch

from traceweaver_tpu_torch import campaign as tc
from traceweaver_tpu_torch.campaign import ledger as tledger
from traceweaver_tpu_torch.campaign.plan import CampaignPlan, PlanError, RungSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the accuracy rule of the mini run against the JAX package's
E2E_TOL_PT = 0.5
TINY_PLAN = {"name": "tiny", "devices": 2, "slices": 2, "timed_rounds": 1,
             "warmup_max": 2,
             "rungs": [{"name": "tiny-a", "n_graphs": 2, "traces_per_graph": 12,
                        "gap_ms": 600, "seed": 4, "n_services": 8,
                        "source": "synthetic"}]}

torch.set_num_threads(1)  # small tensors; the test workers share the cores


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import traceweaver_tpu.runtime.executor  # noqa: F401  (JAX package import order)
    import traceweaver_tpu.campaign as jc

    return jc


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

BAD_PLANS = [
    ("no rungs", dict(rungs=[])),
    ("duplicate rungs", dict(rungs=[dict(name="a"), dict(name="a")])),
    ("devices not a power of two", dict(rungs=[dict(name="a")], devices=3)),
    ("negative devices", dict(rungs=[dict(name="a")], devices=-1)),
    ("no slices", dict(rungs=[dict(name="a")], slices=0)),
    ("unknown knob", dict(rungs=[dict(name="a")], knobs={"TW_TYPO": "1"})),
    ("unknown plan field", dict(rungs=[dict(name="a")], surprise=1)),
    ("unknown rung field", dict(rungs=[dict(name="a", surprise=1)])),
    ("rung name", dict(rungs=[dict(name="a/b")])),
    ("rung sizes", dict(rungs=[dict(name="a", n_graphs=0)])),
    ("rung gap", dict(rungs=[dict(name="a", gap_ms=0)])),
    ("rung services", dict(rungs=[dict(name="a", n_services=2)])),
    ("rung source", dict(rungs=[dict(name="a", source="elsewhere")])),
    ("timed rounds", dict(rungs=[dict(name="a")], timed_rounds=0)),
    ("warmup", dict(rungs=[dict(name="a")], warmup_max=0)),
]


@pytest.mark.parametrize("raw", [p for _, p in BAD_PLANS], ids=[n for n, _ in BAD_PLANS])
def test_plan_validation_raises_as_jax(raw):
    jc = _jax()
    with pytest.raises(jc.PlanError):
        jc.from_dict(copy.deepcopy(raw))
    with pytest.raises(PlanError):
        tc.from_dict(copy.deepcopy(raw))


def test_plans_round_trip_and_knob_args():
    jc = _jax()
    raw = dict(rungs=[dict(name="a"), dict(name="b", seed=2)], devices=2, slices=2,
               knobs={"TW_COMPACT": "1", "TW_SWEEP_WARM": "3", "TW_CAMPAIGN_ROUNDS": "2"})
    plan = tc.from_dict(raw)
    assert tc.from_dict(plan.to_dict()).to_dict() == plan.to_dict()
    assert plan.to_dict() == jc.from_dict(raw).to_dict()
    assert plan.knob_args() == dict(compaction=True, sweep_warm=3, rounds=2)
    for make in ("alibaba_ladder", "mini_plan"):
        assert getattr(tc, make)().to_dict() == getattr(jc, make)().to_dict()
    with pytest.raises(PlanError):
        tc.from_dict(dict(rungs=[dict(name="a")], knobs={"TW_COMPACT": "maybe"}))


# ---------------------------------------------------------------------------
# the corpus ladder
# ---------------------------------------------------------------------------

def _tree_bytes(root):
    out = {}
    for dirpath, _, filenames in os.walk(root):
        for name in filenames:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_corpus_matches_jax_byte_for_byte(tmp_path):
    jc = _jax()
    from traceweaver_tpu.campaign.corpus import build_rung as j_build
    from traceweaver_tpu.campaign.plan import RungSpec as JRungSpec

    kw = dict(n_graphs=2, traces_per_graph=20, gap_ms=300, seed=5, n_services=10,
              source="synthetic")
    # ``-loop`` service names draw from the global ``random``
    random.seed(0)
    j_corpus = j_build(JRungSpec("inv", **kw), str(tmp_path / "jax"))
    random.seed(0)
    corpus = tc.build_rung(RungSpec("inv", **kw), str(tmp_path / "port"))
    assert jc is not None and corpus.root != j_corpus.root
    j_tree = _tree_bytes(j_corpus.root)
    tree = _tree_bytes(corpus.root)
    assert sorted(tree) == sorted(j_tree)
    assert [k for k in tree if k != "manifest.json" and tree[k] != j_tree[k]] == []
    manifest = {k: v for k, v in corpus.manifest.items() if k != "root"}
    assert manifest == {k: v for k, v in j_corpus.manifest.items() if k != "root"}
    assert manifest["spans"] == sum(len(s.all_spans) for s in corpus.stores)
    assert manifest["services_solvable"] == len(corpus.problems) > 0


def test_corpus_cache_reuse(tmp_path):
    spec = RungSpec("cache", n_graphs=2, traces_per_graph=15, seed=3, n_services=8,
                    source="synthetic")
    first = tc.build_rung(spec, str(tmp_path))
    assert first.cached is False
    trace_file = next(os.path.join(dp, f) for dp, _, fs in os.walk(first.root)
                      for f in fs if f.endswith(".json") and f != "manifest.json")
    mtime = os.path.getmtime(trace_file)
    second = tc.build_rung(spec, str(tmp_path))
    assert second.cached is True and os.path.getmtime(trace_file) == mtime
    assert second.manifest["spans"] == first.manifest["spans"]
    third = tc.build_rung(RungSpec("cache", n_graphs=2, traces_per_graph=15, seed=4,
                                   n_services=8, source="synthetic"), str(tmp_path))
    assert third.cached is False
    with pytest.raises(PlanError):
        tc.build_rung(RungSpec("r", source="real"), str(tmp_path))


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def _keys(d, prefix=""):
    out = set()
    if isinstance(d, dict):
        for k, v in d.items():
            out.add(prefix + "/" + k)
            # per-rung plan-cache, byte and percentile dicts have fixed keys;
            # regime and knob dicts follow the data
            if k not in ("regime_mix", "per_regime", "applied_knobs", "knobs"):
                out |= _keys(v, prefix + "/" + k)
    elif isinstance(d, list):
        for v in d:
            out |= _keys(v, prefix + "[]")
    return out


def test_mini_campaign_matches_jax(tmp_path):
    jc = _jax()
    random.seed(0)
    j_art = jc.run_campaign(jc.mini_plan(devices=2), out_path=str(tmp_path / "j.json"),
                            cache_root=str(tmp_path / "jcache"))
    random.seed(0)
    art = tc.run_campaign(tc.mini_plan(devices=2), out_path=str(tmp_path / "p.json"),
                          cache_root=str(tmp_path / "pcache"), device="cpu")
    assert _keys(art) == _keys(j_art)
    assert (art["backend"], art["devices_visible"]) == ("cpu", 2)
    assert art["plan"]["applied_knobs"] == {"TW_MESH_DEVICES": "2"} \
        == j_art["plan"]["applied_knobs"]
    for r, jr in zip(art["rungs"], j_art["rungs"]):
        assert r["rung"] == jr["rung"]
        assert {k: v for k, v in r["manifest"].items() if k != "root"} == \
            {k: v for k, v in jr["manifest"].items() if k != "root"}
        assert abs(r["accuracy"]["e2e_pct"] - jr["accuracy"]["e2e_pct"]) <= E2E_TOL_PT
        assert r["steady"]["backend_compiles"] == 0 and r["steady"]["aot_misses"] == []
        assert r["warmup"]["backend_compiles"][-1] == 0
        assert r["steady"]["quarantined"] == 0
        # the mesh path ran: padded to a power of two a shard, one flag
        # fetch a pass billed at the padded flags
        fleet, b = r["steady"]["fleet"], r["steady"]["bytes"]
        assert fleet["compact_windows_total"] > 0
        assert fleet["compact_windows_total"] % 2 == 0
        assert b["d2h_bytes_flags"] == fleet["compact_windows_total"]
        assert b["d2h_flag_fetches"] > 0
        assert r["multislice"] == jr["multislice"]
        assert r["multislice"]["agree"]
    assert tc.compare_artifacts(art, art)["ok"]


def test_campaign_events_and_metrics(tmp_path):
    from traceweaver_tpu_torch.obs import events as obs_events
    from traceweaver_tpu_torch.obs.registry import get_registry

    tledger.reset_for_tests()
    sink = tmp_path / "events.jsonl"
    prev = obs_events.install(obs_events.EventLog(str(sink)))
    try:
        plan = CampaignPlan(name="evt", rungs=[RungSpec(
            "only", n_graphs=2, traces_per_graph=12, seed=9, n_services=8,
            source="synthetic")], devices=0, slices=1, timed_rounds=1, warmup_max=2)
        art = tc.run_campaign(plan, out_path=str(tmp_path / "evt.json"),
                              cache_root=str(tmp_path / "cache"), device="cpu")
    finally:
        obs_events.install(prev)
    events = [json.loads(line) for line in sink.read_text().splitlines()]
    camp = [e for e in events if e.get("kind") == "campaign"]
    assert [e["event"] for e in camp] == ["start", "rung", "finish"]
    assert camp[1]["spans_per_s"] == pytest.approx(
        art["rungs"][0]["steady"]["spans_per_s"], rel=0.01)
    snap = get_registry().snapshot(include_collectors=True)
    assert snap['tw_campaign_spans_per_s{rung="only"}'] == \
        art["rungs"][0]["steady"]["spans_per_s"]
    assert snap['tw_campaign_accuracy_e2e{rung="only"}'] == \
        art["rungs"][0]["accuracy"]["e2e_pct"]
    assert snap["tw_campaign_runs_total"] == 1.0
    assert art["devices_visible"] == 1 and art["rungs"][0]["multislice"] is None
    assert art["metrics_scrape"]["total_samples"] > 0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_run_mini_report_and_self_compare(tmp_path, capsys):
    from traceweaver_tpu_torch.runtime import cli

    out = str(tmp_path / "CAMPAIGN_mini.json")
    assert cli.main(["campaign", "run", "--mini", "--device", "cpu", "--out", out,
                     "--cache", str(tmp_path / "cache")]) == 0
    art = tc.load_artifact(out)
    assert [r["rung"] for r in art["rungs"]] == ["mini-a", "mini-b"]
    assert art["plan"]["devices"] == 2 and art["devices_visible"] == 2
    assert cli.main(["campaign", "report", out]) == 0
    assert "mini-b" in capsys.readouterr().out
    assert cli.main(["campaign", "compare", out, out]) == 0
    doctored = copy.deepcopy(art)
    doctored["rungs"][0]["accuracy"]["e2e_pct"] -= 5.0
    bad = str(tmp_path / "bad.json")
    tc.write_artifact(bad, doctored)
    assert cli.main(["campaign", "compare", out, bad]) == 1
    assert "REGRESSION mini-a/accuracy_e2e_pct" in capsys.readouterr().out
    assert cli.main(["campaign"]) == 2
    assert cli.main(["campaign", "frobnicate"]) == 2


def test_cli_compare_across_packages(tmp_path, capsys):
    """Both packages' ``campaign run`` on one plan (the JAX CLI on its CPU
    stand-in of two virtual devices, in a process of its own), then each
    package's ``compare`` on the pair in both directions."""
    jc = _jax()
    from traceweaver_tpu_torch.runtime import cli

    plan = tmp_path / "tiny.json"
    plan.write_text(json.dumps(TINY_PLAN))
    j_out, p_out = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu", TW_BACKEND="cpu", TW_JAX_CACHE="0",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "traceweaver_tpu.runtime.cli", "campaign", "run",
         "--plan", str(plan), "--out", j_out, "--cache", str(tmp_path / "jcache")],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        assert cli.main(["campaign", "run", "--plan", str(plan), "--device", "cpu",
                         "--out", p_out, "--cache", str(tmp_path / "pcache")]) == 0
        log, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log[-2000:]
    j_art, art = tc.load_artifact(j_out), tc.load_artifact(p_out)
    assert (art["backend"], art["devices_visible"]) == \
        (j_art["backend"], j_art["devices_visible"]) == ("cpu", 2)
    for base, cand in ((j_out, p_out), (p_out, j_out)):
        assert cli.main(["campaign", "compare", base, cand, "--tol-pct", "100"]) == 0
        assert jc.main(["compare", base, cand, "--tol-pct", "100"]) == 0
    assert "OK" in capsys.readouterr().out


def test_cli_run_without_card_refuses_before_loading(monkeypatch, tmp_path):
    from traceweaver_tpu_torch.campaign import corpus
    from traceweaver_tpu_torch.runtime import cli

    built = []
    monkeypatch.setattr(corpus, "build_rung", lambda *a, **k: built.append(a))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "c.json"
    assert cli.main(["campaign", "run", "--mini", "--out", str(out)]) != 0
    # a mesh the machine cannot hold refuses too
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert cli.main(["campaign", "run", "--mini", "--devices", "2", "--out",
                     str(out)]) != 0
    assert cli.main(["campaign", "run", "--mini", "--devices", "3", "--device", "cpu",
                     "--out", str(out)]) != 0
    assert not built and not out.exists()

"""Config ``stream-cg-8k`` on the CPU: where the port's stream parts from
the JAX package's.

On the whole stream the port's CPU run reads 96.42333984375 where JAX
reads 96.435546875 (``STREAM_PORT_CPU`` and ``STREAM_JAX`` in
``chip_smoke.py``, which holds the card's CPU rerun to the former). This
test pins why: the first three emitted windows of both sinks assign
alike, and the first solve of the stream (window 0's cold solve) parts
in one solver window only, from equal inputs, at a tie.
"""

import os

import numpy as np
import pytest
import torch

CORPUS = dict(n_graphs=1, traces_per_graph=8192, seed=10, base_gap_ms=20)
QUERY = "fix=5&max_traces=8192&ooo_ms=50&seed=1"
WINDOWS = 3


def _first_call(fleet_mod, calls):
    """Wrap ``fleet_mod.solve_windows_fleet`` so that ``calls`` keeps the
    first call's numpy arguments, keywords and assignment channel;
    returns the real function."""
    real = fleet_mod.solve_windows_fleet

    def keep(*args, **kw):
        out = real(*args, **kw)
        if not calls:
            calls.update(args=[np.asarray(a) for a in args], kw=kw,
                         assign=np.asarray(out[0])[..., 0])
        return out

    fleet_mod.solve_windows_fleet = keep
    return real


def _records(path):
    import json

    with open(path) as f:
        return [json.loads(line) for line in f]


def test_stream_cg8k_parts_from_jax_only_at_a_tie(tmp_path):
    """Both packages' streams, three emitted windows each: the records
    carry the same windows, traces and assignments. In the first
    ``solve_windows_fleet`` call (window 0's cold solve, 9 solver
    windows) JAX's solver on the port's inputs gives JAX's own
    assignments on every window, so the inputs are equivalent (JAX's
    resident columns rebase each window's times by another origin, which
    moves no pick). The port's assignments equal JAX's on all windows
    but one, whose inputs are equal bit for bit. Fed that window's K1
    blocks, the port's Sinkhorn and rounding and JAX's
    (``assign_topk_jnp``) agree on every block up to one where two rows
    swap their two columns: the rows score those columns alike, so the
    two plans, which agree to 2e-6, give the columns equal masses (the
    port's exactly, JAX's within a few parts in a million), and f32
    rounding breaks the tie. The later sweeps and the warm-started
    windows carry the swap to the last bits of the stream's reading."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import traceweaver_tpu.runtime.executor  # noqa: F401  (a cold ingest import is circular)
    import traceweaver_tpu.algorithms.fleet as JF
    import traceweaver_tpu.stream as js
    from traceweaver_tpu.ops.pallas_sinkhorn import assign_topk_jnp
    from traceweaver_tpu.ops.sinkhorn import sinkhorn_log as jax_sinkhorn

    import traceweaver_tpu_torch.algorithms.fleet as PF
    import traceweaver_tpu_torch.algorithms.weaver_torch as wt
    import traceweaver_tpu_torch.stream as ps
    from traceweaver_tpu_torch.alibaba.synthesize import synthesize_corpus
    from traceweaver_tpu_torch.ops.cuda_sinkhorn import assign_topk_plain
    from traceweaver_tpu_torch.ops.sinkhorn import sinkhorn_log

    (d,) = synthesize_corpus(str(tmp_path / "cg"), **CORPUS)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    calls = {}
    try:
        for tag, mod, fleet_mod, kw in (("port", ps, PF, dict(device="cpu")),
                                        ("jax", js, JF, {})):
            calls[tag] = {}
            real = _first_call(fleet_mod, calls[tag])
            try:
                cfg = mod.StreamConfig(window_us=20e6, overlap_us=4e6, ooo_bound_us=2e6,
                                       grace_us=0.0, max_pending=4, verbose=False)
                svc = mod.StreamingReconstructor(
                    mod.parse_source_spec(f"replay:{d}?{QUERY}"), cfg,
                    sink=mod.TraceSink(str(tmp_path / f"{tag}.jsonl")), **kw)
                assert svc.run(max_windows=WINDOWS)["emitted_windows"] == WINDOWS
                svc.sink.close()
            finally:
                fleet_mod.solve_windows_fleet = real

        port, ref = _records(tmp_path / "port.jsonl"), _records(tmp_path / "jax.jsonl")
        assert len(port) == len(ref) == WINDOWS
        for p, j in zip(port, ref):
            for key in ("window", "start_us", "end_us", "traces", "services"):
                assert p[key] == j[key], (p["window"], key)
        assert sum(len(p["traces"]) for p in port) > 1000

        # the first solve: equivalent inputs, one solver window parts
        pa, ja = calls["port"]["args"], calls["jax"]["args"]
        n = pa[0].shape[0]
        assert n == 9 and ja[0].shape[0] >= n
        padded = [np.concatenate([p, j[n:]]) if i < 9 else j
                  for i, (p, j) in enumerate(zip(pa, ja))]
        jax_on_port = np.asarray(JF.solve_windows_fleet(
            *[jnp.asarray(a) for a in padded], **calls["jax"]["kw"])[0])[:n, ..., 0]
        jax_assign = calls["jax"]["assign"][:n]
        np.testing.assert_array_equal(jax_on_port, jax_assign)
        parted = [b for b in range(n) if (calls["port"]["assign"][b] != jax_assign[b]).any()]
        assert len(parted) == 1, parted
        (b,) = parted
        for i in range(8):
            np.testing.assert_array_equal(pa[i][b], ja[i][b])
        p_row, j_row = int(pa[8][b]), int(ja[8][b])
        for i in range(9, len(pa)):
            np.testing.assert_array_equal(pa[i][p_row], ja[i][j_row])

        # that window alone through the port, keeping its K1 blocks
        window = [torch.from_numpy(np.ascontiguousarray(a[b:b + 1] if i < 9 else a))
                  for i, a in enumerate(pa)]
        blocks = []
        assign_topk = wt.assign_topk

        def keep(*args, **kw):
            blocks.append((args, {k: v for k, v in kw.items() if k != "fused"}))
            return assign_topk(*args, **kw)

        wt.assign_topk = keep
        try:
            out, _ = wt.solve_windows_fleet(*window, **calls["port"]["kw"])
        finally:
            wt.assign_topk = assign_topk
        np.testing.assert_array_equal(out[0, ..., 0].numpy(), calls["port"]["assign"][b])
    finally:
        torch.set_num_threads(threads)

    for n_block, ((S, rm, cm, in_v, cv, cap, W), hyper) in enumerate(blocks):
        mine = assign_topk_plain(S, rm, cm, in_v, cv, cap, W, **hyper)[0][0].numpy()
        j = [jnp.asarray(t[0].numpy()) for t in (S, rm, cm, in_v, cv, cap)]
        theirs = np.asarray(assign_topk_jnp(*j, W, **hyper)[0])
        rows = np.nonzero(mine != theirs)[0]
        if len(rows):
            break
    else:
        pytest.fail("no K1 block of the window parts")
    assert n_block > 0 and 0 < len(rows) <= 4, (n_block, rows)
    sink = dict(epsilon=hyper["epsilon"], n_iters=hyper["n_iters"], tol=hyper["tol"])
    p_mine = sinkhorn_log(S, rm, cm, **sink)[0].numpy()
    p_theirs = np.asarray(jax_sinkhorn(j[0], j[1], j[2], **sink))
    assert np.abs(p_mine - p_theirs).max() <= 2e-6
    S0 = S[0].numpy()
    for i in rows:
        a, c = int(mine[i]), int(theirs[i])
        assert a >= 0 and c >= 0
        # the two columns are a swap between two rows that score them alike
        (k,) = [r for r in rows if int(mine[r]) == c and int(theirs[r]) == a]
        assert S0[i, a] == S0[i, c] == S0[k, a] == S0[k, c]
        for plan in (p_mine, p_theirs):
            assert abs(plan[i, a] - plan[i, c]) <= 5e-6 * max(plan[i, a], plan[i, c])
        assert p_mine[i, a] == p_mine[i, c]

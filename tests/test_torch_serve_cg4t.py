"""Config ``serve-cg-4t`` on the CPU: where the port's run of tenant
``t0`` alone under the fixed pump parts from the JAX package's.

The port's CPU run reads 66.50390625 where JAX's host-packed run reads
66.24755859375 (``SERVE_JAX["alone"]`` in ``chip_smoke.py``; the
smoke's CPU rerun is the pump of one window, as this run takes longer
than the smoke has, and the card parts from it the same way). The
two sinks part wholesale in four windows of the first pump's service
``MS_00002`` (windows 1, 3, 5 and 7). This test pins why, on window 1:
the service's cold solve there is one solver window whose inputs are
equal bit for bit in both packages, and fed its K1 blocks the port's
Sinkhorn and rounding and JAX's (``assign_topk_jnp``) agree on the first
block and part on the second, on rows that score the two columns they
pick between exactly alike (most of them identical spans, the others
masked entries of a lifted row: exact-mass ties, ROADMAP C.3). JAX's plan gives the two columns equal masses; the port's parts
from equal in the last bits, and the rounding breaks the tie the other
way. The sweeps then carry the swap through the whole window.
"""

import numpy as np
import pytest
import torch

SERVICE, WINDOW, BODIES = "MS_00002", 1, 8


def _items(mod, bodies, settings, **kw):
    cfg = mod.ServeConfig(verbose=False, **dict(settings, pump_windows=1 << 30))
    svc = mod.TenantService(cfg, **kw)
    for body in bodies:
        svc.ingest("t0", body)
    t = svc.tenant("t0")
    with svc._lock:
        t.flush()
        bufs = {b.k: b for b in t.svc.scheduler.ready()}
    _, items, _ = t.svc.prepare_batch_items([bufs[99999999 + WINDOW]], tenant="t0")
    (item,) = [it for it in items if it.svc == SERVICE]
    return item


def _first_call(fleet_mod, calls):
    real = fleet_mod.solve_windows_fleet

    def keep(*args, **kw):
        out = real(*args, **kw)
        if not calls:
            calls.update(args=[np.asarray(a) for a in args], kw=kw,
                         assign=np.asarray(out[0])[..., 0])
        return out

    fleet_mod.solve_windows_fleet = keep
    return real


def test_serve_t0_alone_parts_from_jax_only_at_exact_ties(tmp_path, monkeypatch):
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import traceweaver_tpu.runtime.executor  # noqa: F401  (a cold ingest import is circular)
    import traceweaver_tpu.algorithms.fleet as JF
    from traceweaver_tpu import serve as jserve
    from traceweaver_tpu.ops.pallas_sinkhorn import assign_topk_jnp
    from traceweaver_tpu.ops.sinkhorn import sinkhorn_log as jax_sinkhorn

    import traceweaver_tpu_torch.algorithms.fleet as PF
    import traceweaver_tpu_torch.algorithms.weaver_torch as wt
    from traceweaver_tpu_torch import serve as pserve
    from traceweaver_tpu_torch.alibaba.synthesize import synthesize_corpus
    from traceweaver_tpu_torch.ops.cuda_sinkhorn import assign_topk_plain
    from traceweaver_tpu_torch.ops.sinkhorn import sinkhorn_log

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    import chip_smoke as CS

    monkeypatch.setenv("TW_DEVCOLS", "0")
    (d,) = synthesize_corpus(str(tmp_path / "cg"), **dict(CS.SERVE_CORPUS, n_graphs=1))
    bodies = CS.serve_bodies(d)[:BODIES]
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    calls = {"port": {}, "jax": {}}
    reals = (_first_call(PF, calls["port"]), _first_call(JF, calls["jax"]))
    blocks = []
    real_k1 = wt.assign_topk

    def keep(*args, **kw):
        blocks.append((args, {k: v for k, v in kw.items() if k != "fused"}))
        return real_k1(*args, **kw)

    wt.assign_topk = keep
    try:
        PF.solve_fleet([_items(pserve, bodies, CS.SERVE_SETTINGS, device="cpu")],
                       device="cpu", pipeline=False, devcols=False)
        wt.assign_topk = real_k1
        JF.solve_fleet([_items(jserve, bodies, CS.SERVE_SETTINGS)])
    finally:
        wt.assign_topk = real_k1
        PF.solve_windows_fleet, JF.solve_windows_fleet = reals
        torch.set_num_threads(threads)

    # the item solves single-pass in one call: its blocks are that call's
    pa, ja = calls["port"]["args"], calls["jax"]["args"]
    assert pa[0].shape[0] == ja[0].shape[0] == 1   # one solver window
    for p, j in zip(pa, ja):
        np.testing.assert_array_equal(p, j)        # equal inputs, tables too
    assert (calls["port"]["assign"] != calls["jax"]["assign"]).any()

    for n_block, ((S, rm, cm, in_v, cv, cap, W), hyper) in enumerate(blocks):
        mine = assign_topk_plain(S, rm, cm, in_v, cv, cap, W, **hyper)[0][0].numpy()
        j = [jnp.asarray(t[0].numpy()) for t in (S, rm, cm, in_v, cv, cap)]
        theirs = np.asarray(assign_topk_jnp(*j, W, **hyper)[0])
        rows = np.nonzero(mine != theirs)[0]
        if len(rows):
            break
    else:
        pytest.fail("no K1 block of the window parts")
    assert n_block == 1 and 0 < len(rows) <= 32, (n_block, rows)
    sink = dict(epsilon=hyper["epsilon"], n_iters=hyper["n_iters"], tol=hyper["tol"])
    p_mine = sinkhorn_log(S, rm, cm, **sink)[0].numpy()
    p_theirs = np.asarray(jax_sinkhorn(j[0], j[1], j[2], **sink))
    assert np.abs(p_mine - p_theirs).max() <= 2e-6
    S0 = S[0].numpy()
    # the greedy rounding takes rows in turn, so a tie broken the other
    # way moves the picks of later rows too; the parting rows hold
    # exact-mass ties: the row scores both columns exactly alike, JAX's
    # plan gives them equal masses, and the port's parts from equal in the
    # last bits
    ties = [i for i in rows
            if S0[i, mine[i]] == S0[i, theirs[i]] > -1e8
            and p_theirs[i, mine[i]] == p_theirs[i, theirs[i]]
            and 0 < abs(p_mine[i, mine[i]] - p_mine[i, theirs[i]])
            <= 2e-6 * p_mine[i, mine[i]]]
    assert len(ties) >= 2, rows

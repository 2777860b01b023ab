"""Config ``serve-cg-4t`` on the CPU: where the port's run of tenant
``t0`` alone under a pump of one window parts from the JAX package's.

The port's CPU run reads 96.56982421875 where JAX's reads 96.4599609375
(``SERVE_PORT_CPU`` and ``SERVE_JAX["alone1"]`` in ``chip_smoke.py``,
which holds the card's CPU rerun to the former; JAX reads the same with
and without its resident columns here). The sinks assign alike in
windows 0-2 and part on a few rows from window 3 on. This test pins why:
after three windows solved alike, the statistics each package carries to
window 3 (refitted on the host from the same assignments) part in the
last bits (a relative 2e-6 at most, the GMM fits' rounding), and window
3's solve of ``MS_00002`` from those tables, its window inputs equal bit
for bit, parts on two rows (ROADMAP C.1: the refit's last bits, as on six
messy ladder calls).
"""

import numpy as np
import torch

SERVICE, WINDOW = "MS_00002", 3


def _to_window(mod, bodies, settings, state, **kw):
    """Ingest until window ``WINDOW`` is sealed, pumping each earlier
    window when its POST seals it (a pump of one window); returns the
    service and the window's fleet item for ``SERVICE``."""
    cfg = mod.ServeConfig(verbose=False, state_dir=state,
                          **dict(settings, pump_windows=1 << 30))
    svc = mod.TenantService(cfg, **kw)
    want = 99999999 + WINDOW
    for body in bodies:
        svc.ingest("t0", body)
        ready = svc.tenant("t0").svc.scheduler.ready()
        if any(b.k == want for b in ready):
            assert len(ready) == 1
            break
        if ready:
            svc.pump()
    t = svc.tenant("t0")
    t.svc.sink.close()
    _, items, _ = t.svc.prepare_batch_items(ready, tenant="t0")
    (item,) = [it for it in items if it.svc == SERVICE]
    return svc, item


def _rows(path):
    """Each emitted window's ``(service, in id, out id)`` rows (endpoint
    names left out: the self-loop services' are random ids)."""
    import json

    with open(path) as f:
        return [(r["window"], sorted((svc, tuple(i), tuple(o))
                                     for svc, eps in r["services"].items()
                                     for rows in eps.values() for i, o in rows))
                for r in map(json.loads, f)]


def _first_call(fleet_mod, calls):
    real = fleet_mod.solve_windows_fleet

    def keep(*args, **kw):
        out = real(*args, **kw)
        if not calls:
            calls.update(args=[np.asarray(a) for a in args],
                         assign=np.asarray(out[0])[..., 0])
        return out

    fleet_mod.solve_windows_fleet = keep
    return real


def test_serve_t0_pump1_parts_from_jax_at_the_refit_last_bits(tmp_path, monkeypatch):
    import os
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    import traceweaver_tpu.runtime.executor  # noqa: F401  (a cold ingest import is circular)
    import traceweaver_tpu.algorithms.fleet as JF
    from traceweaver_tpu import serve as jserve

    import traceweaver_tpu_torch.algorithms.fleet as PF
    from traceweaver_tpu_torch import serve as pserve
    from traceweaver_tpu_torch.alibaba.synthesize import synthesize_corpus

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as CS

    monkeypatch.setenv("TW_DEVCOLS", "0")
    (d,) = synthesize_corpus(str(tmp_path / "cg"), **dict(CS.SERVE_CORPUS, n_graphs=1))
    bodies = CS.serve_bodies(d)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        _, pi = _to_window(pserve, bodies, CS.SERVE_SETTINGS, str(tmp_path / "p"),
                           device="cpu")
        _, ji = _to_window(jserve, bodies, CS.SERVE_SETTINGS, str(tmp_path / "j"))
        # the windows so far assigned alike
        got = _rows(tmp_path / "p" / "t0" / "traces.jsonl")
        assert len(got) == WINDOW and got == _rows(tmp_path / "j" / "t0" / "traces.jsonl")
        # the carried statistics part in the last bits only
        assert set(pi.warm_dists) == set(ji.warm_dists)
        worst = 0.0
        for key, a in pi.warm_dists.items():
            b = ji.warm_dists[key]
            for f in ("weights", "means", "stds"):
                x = np.asarray(getattr(a, f), float)
                y = np.asarray(getattr(b, f), float)
                worst = max(worst, float(np.max(np.abs(x - y) / np.maximum(np.abs(y), 1e-30))))
        assert 0.0 < worst <= 1e-5, worst

        calls = {"port": {}, "jax": {}}
        reals = (_first_call(PF, calls["port"]), _first_call(JF, calls["jax"]))
        try:
            pout = PF.solve_fleet([pi], device="cpu", pipeline=False, devcols=False)
            jout = JF.solve_fleet([ji])
        finally:
            PF.solve_windows_fleet, JF.solve_windows_fleet = reals
    finally:
        torch.set_num_threads(threads)
    pa, ja = calls["port"]["args"], calls["jax"]["args"]
    assert pa[0].shape[0] == ja[0].shape[0] == 1
    for p, j in zip(pa[:9], ja[:9]):
        np.testing.assert_array_equal(p, j)        # the window's inputs
    assert not all(np.array_equal(p, j) for p, j in zip(pa[9:], ja[9:]))  # the tables
    ps, js = pout[0][0], jout[0][0]
    parted = sum(ps[ep][i] != js[ep][i] for ep in ps for i in ps[ep])
    assert 0 < parted <= 4, parted

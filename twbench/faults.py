"""Faults planted in the program under a run, and the control: what the
comparison has to catch.

- ``control``: the program's own lower-precision path, bf16 score blocks
  (``solve_fleet(precision="bf16")``), one step below the f32 that the
  configurations state.
- ``stale``: a step that returns its state unchanged: the EM refit hands
  back its prior mixtures.
- ``half``: half of the batch left out: K1 answers only the first half of
  each launch's windows, the rest read -1 (no answer).
- ``answer``: an answer altered where it is produced: K1's answer for the
  first row of each launch's first window moved to the next column.
- ``decode``: the decode maps a service's first window to the wrong spans:
  every column of it shifted by one, cyclically within the window's own
  spans (the answers stay valid and distinct).

The cells run on one card, so there is no exchange between cards to
leave out. Each fault wraps a function of the program for the duration of
its context (:func:`planted`), beneath the checker's own wrappers.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

FAULTS = ("stale", "half", "answer", "decode")


@contextlib.contextmanager
def planted(name: str) -> Iterator[None]:
    import torch

    import traceweaver_tpu_torch.algorithms.weaver_torch as wt

    if name == "stale":
        real = wt.fit_gmm_in_graph

        def fit(samples, mask, prior_w, prior_mu, prior_sd, **kw):
            return prior_w.clone(), prior_mu.clone(), prior_sd.clone()

        wt.fit_gmm_in_graph = fit
        try:
            yield
        finally:
            wt.fit_gmm_in_graph = real
        return
    if name == "decode":
        real_decode = wt.WeaverTorch._decode

        def decode(packed, assign, topk_cols, all_assignments, all_topk):
            assign = assign.copy()
            for e in range(min(assign.shape[1], len(packed.out_ids))):
                n = int(packed.out_ids[e].count[0])
                a = assign[0, e]
                ok = (a >= 0) & (a < n)
                a[ok] = (a[ok] + 1) % max(n, 1)
            return real_decode(packed, assign, topk_cols, all_assignments, all_topk)

        wt.WeaverTorch._decode = staticmethod(decode)
        try:
            yield
        finally:
            wt.WeaverTorch._decode = staticmethod(real_decode)
        return
    if name not in ("half", "answer"):
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    real = wt.assign_topk

    def assign(S_ot, row_marg, col_marg, in_valid, col_valid, skip_cap, n_rows, **kw):
        a, tk = real(S_ot, row_marg, col_marg, in_valid, col_valid, skip_cap, n_rows, **kw)
        a, tk = a.clone(), tk.clone()
        B = a.shape[0]
        if name == "half":
            a[(B + 1) // 2:] = -1
            tk[(B + 1) // 2:] = -1
        elif B and a.shape[1]:
            a[0, 0] = torch.remainder(a[0, 0] + 1, S_ot.shape[2])
        return a, tk

    wt.assign_topk = assign
    try:
        yield
    finally:
        wt.assign_topk = real


def solve_kw(name: str) -> Dict:
    """The ``solve_fleet`` arguments of the control (none for a fault)."""
    return {"precision": "bf16"} if name == "control" else {}

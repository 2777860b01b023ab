"""The comparison that decides ``correct``, run after the window closes.

The solver's stages are held against the plain reference of
:mod:`twbench.reference` where they happen, by wrapping the solver's own
entry points for the duration of one round (:meth:`Checker.solver_hooks`)
or of the set-up's cold round (:meth:`Checker.fit_hooks`):

- ``block_gap``: every endpoint step's score block, as the assembly kernel
  wrote it, against the reference's f32 assembly of the same step's inputs
  (the windows, the predecessor times and the mixture rows the solver
  gathered). Rows are compared centred at their best feasible score, as
  ``|P - R| / (1 + |R|)`` over the feasible entries of valid rows; a block
  whose feasibility differs from the reference's reads ``MISMATCH``.
- ``k1_rows_diff``: the share of valid rows where K1's answer or top-k
  differs from what the reference's Sinkhorn, rounding and top-k give on
  the reference's block.
- ``k1_gap`` (reported, not compared: the bf16 control leaves it at 0):
  the widest gap, in the reference's block, by which K1's chosen column
  lies below the reference's (``MISMATCH`` for an infeasible or missing
  answer).
- ``decode_diff``: the share of the round's decoded answers (one per
  incoming span and endpoint) where the program's differs from the
  reference's decode of the reference's own K1 answers
  (:mod:`twbench.decode`).
- ``fit_gap``: the EM refit of the cold round against the reference's fit
  of the same delay samples: the widest gap of a row's mixture mean or
  standard deviation, over that standard deviation (at least 1 us). The
  program has no lower-precision refit, so its control
  (``fit_control``) is the reference fit in bf16 put in the program's
  place.

The reference computes on the device the program ran on, one step at a
time under a lock. It counts, for each launch, the Sinkhorn iterations
and rounding rounds these inputs need, and the bytes, operations and
special functions of both kernels (:mod:`twbench.roofline`).
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, List

import torch

from twbench import reference as ref
from twbench import roofline
from twbench.decode import DecodeCheck

#: what a number reads when the program's answer is not one the reference
#: could give at all (another feasibility, an infeasible column)
MISMATCH = 1.0e9


def worst(current: float, reading: float) -> float:
    """The larger of two readings; a reading that is no number (NaN, inf)
    reads MISMATCH."""
    return max(current, reading if math.isfinite(reading) else MISMATCH)


def _centred(x: torch.Tensor, feas: torch.Tensor) -> torch.Tensor:
    best = torch.where(feas, x, torch.full_like(x, -math.inf)).amax(dim=2, keepdim=True)
    best = torch.where(torch.isfinite(best), best, torch.zeros_like(best))
    return x - best


def block_gap(P: torch.Tensor, R: torch.Tensor, in_v: torch.Tensor) -> float:
    """Centred gap of the program's block ``P`` to the reference's ``R``
    over valid rows (the dummy row left out)."""
    W = in_v.shape[1]
    P = P[:, :W].to(torch.float32)
    R = R[:, :W]
    fp, fr = P > ref.NEG / 2, R > ref.NEG / 2
    rows = in_v[:, :, None]
    if bool(((fp != fr) & rows).any()):
        return MISMATCH
    m = fr & rows
    d = (_centred(P, fp) - _centred(R, fr)).abs() / (1.0 + _centred(R, fr).abs())
    return float(torch.where(m, d, torch.zeros_like(d)).amax()) if P.numel() else 0.0


def _chosen(R: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``R[b, i, a[b, i]]``, NEG where ``a`` is no column."""
    C = R.shape[2]
    ok = (a >= 0) & (a < C)
    v = torch.gather(R, 2, torch.clamp(a, 0, C - 1).to(torch.int64)[:, :, None])[:, :, 0]
    return torch.where(ok, v, torch.full_like(v, ref.NEG))


def mixture_moments(w, mu, sd):
    w, mu, sd = (x.double() for x in (w, mu, sd))
    tot = torch.clamp(w.sum(dim=1), min=1e-300)
    m = (w * mu).sum(dim=1) / tot
    var = (w * (sd * sd + mu * mu)).sum(dim=1) / tot - m * m
    return m, torch.sqrt(torch.clamp(var, min=0.0))


class Checker:
    """Holds the readings of one checked round and of the cold round's
    refits."""

    def __init__(self, items=(), fit_control: bool = False):
        self.fit_control = fit_control
        self.decode = DecodeCheck(list(items))
        self.block_gap = 0.0
        self.k1_gap = 0.0
        self.rows = 0
        self.rows_diff = 0
        self.assembly_launches = 0
        self.k1_launches = 0
        self.fit_gap = 0.0
        self.fit_rows = 0
        #: per launch: (bytes, ops, exps) of K1 and of the assembly
        self.k1_counts: List[Dict[str, float]] = []
        self.asm_counts: List[Dict[str, float]] = []
        self._fits: List[tuple] = []
        self._tls = threading.local()
        self._lock = threading.Lock()

    # -- the solver's endpoint steps ----------------------------------------

    @contextlib.contextmanager
    def solver_hooks(self):
        import traceweaver_tpu_torch.algorithms.fleet as fleet
        import traceweaver_tpu_torch.algorithms.weaver_torch as wt

        real_asm, real_assign = wt.assemble_block, wt.assign_topk
        packers = [(mod, name, getattr(mod, name)) for mod, name in (
            (wt, "pack_problem"), (fleet, "pack_problem"), (fleet, "_pack_problem_devcols"))]

        def packer(real):
            def pack(in_spans, *args, **kw):
                packed = real(in_spans, *args, **kw)
                self.decode.packed(in_spans, packed.windows)
                return packed
            return pack

        def assemble(root, preds, succs, ret, in_s, in_e, in_v, o_s, o_e, o_v, t_prev,
                     t_succ, force_skip, precision="f32", gemm=False):
            out = real_asm(root, preds, succs, ret, in_s, in_e, in_v, o_s, o_e, o_v,
                           t_prev, t_succ, force_skip, precision=precision, gemm=gemm)
            with self._lock:
                R, feas_count, _ = ref.assemble_block(
                    root, preds, succs, ret, in_s, in_e, in_v, o_s, o_e, o_v, t_prev,
                    t_succ, force_skip, precision="f32")
                gap = block_gap(out[0], R, in_v)
                B, W = in_v.shape
                M = o_s.shape[1]
                self.block_gap = worst(self.block_gap, gap)
                self.assembly_launches += 1
                self.asm_counts.append(roofline.assembly_counts(
                    [root, *preds, *succs, ret], B, W, M, t_succ is not None, feas_count,
                    out[0].element_size()))
            self._tls.pending = (R, in_v, o_v,
                                 self.decode.rows(in_s, in_e, in_v, o_s, o_e, o_v))
            return out

        def assign(S_ot, row_marg, col_marg, in_valid, col_valid, skip_cap, n_rows, *,
                   epsilon, n_iters, tol, topk, min_topk_mass, fused=True, **kw):
            a, tk = real_assign(S_ot, row_marg, col_marg, in_valid, col_valid, skip_cap,
                                n_rows, epsilon=epsilon, n_iters=n_iters, tol=tol,
                                topk=topk, min_topk_mass=min_topk_mass, fused=fused, **kw)
            pending = getattr(self._tls, "pending", None)
            self._tls.pending = None
            if pending is None:
                raise RuntimeError("an assignment with no assembled block before it")
            R, in_v, o_v, targets = pending
            with self._lock:
                a_r, tk_r, iters, rounds = ref.assign_topk(
                    R, in_v, o_v, skip_cap, n_rows, epsilon=epsilon, n_iters=n_iters,
                    tol=tol, topk=topk, min_topk_mass=min_topk_mass)
                Rw = R[:, :n_rows]
                gap = torch.clamp(_chosen(Rw, a_r) - _chosen(Rw, a), min=0.0)
                gap = torch.where(in_v, gap, torch.zeros_like(gap))
                diff = in_v & ((a != a_r) | (tk != tk_r).any(dim=2))
                B, Rr, C = R.shape
                self.k1_gap = worst(self.k1_gap, min(float(gap.amax()) if B else 0.0,
                                                     MISMATCH))
                self.rows += int(in_v.sum())
                self.rows_diff += int(diff.sum())
                self.k1_launches += 1
                self.k1_counts.append(roofline.k1_counts(
                    B, Rr, C, n_rows, float(iters.sum()), float(rounds.sum()),
                    S_ot.element_size(), topk))
            self.decode.answered(targets, a_r, tk_r, o_v.shape[1])
            return a, tk

        wt.assemble_block, wt.assign_topk = assemble, assign
        for mod, name, real in packers:
            setattr(mod, name, packer(real))
        try:
            yield self
        finally:
            wt.assemble_block, wt.assign_topk = real_asm, real_assign
            for mod, name, real in packers:
                setattr(mod, name, real)

    # -- the refit between the cold round's passes ---------------------------

    @contextlib.contextmanager
    def fit_hooks(self):
        """Keeps, on the host, the inputs and outputs of every EM refit."""
        import traceweaver_tpu_torch.algorithms.weaver_torch as wt

        real = wt.fit_gmm_in_graph

        def fit(samples, mask, prior_w, prior_mu, prior_sd, max_k=5, n_iters=50):
            out = real(samples, mask, prior_w, prior_mu, prior_sd, max_k=max_k,
                       n_iters=n_iters)
            with self._lock:
                self._fits.append(tuple(t.detach().cpu() for t in (
                    samples, mask, prior_w, prior_mu, prior_sd, *out)) + (max_k, n_iters))
            return out

        wt.fit_gmm_in_graph = fit
        try:
            yield self
        finally:
            wt.fit_gmm_in_graph = real

    def compare_fits(self, device) -> None:
        """The reference's fit of each kept refit's samples, against the
        program's."""
        with self._lock:
            fits, self._fits = self._fits, []
        for samples, mask, pw, pmu, psd, w, mu, sd, max_k, n_iters in fits:
            on = [t.to(device) for t in (samples, mask, pw, pmu, psd)]
            rw, rmu, rsd = ref.fit_gmm_in_graph(*on, max_k=max_k, n_iters=n_iters)
            if self.fit_control:
                low = [t.to(torch.bfloat16) if t.is_floating_point() else t for t in on]
                w, mu, sd = (t.float().cpu() for t in ref.fit_gmm_in_graph(
                    *low, max_k=max_k, n_iters=n_iters))
            rows = mask.sum(dim=1) >= 1
            m_p, s_p = mixture_moments(w, mu, sd)
            m_r, s_r = mixture_moments(rw.cpu(), rmu.cpu(), rsd.cpu())
            scale = torch.clamp(s_r, min=1.0)
            g = torch.maximum((m_p - m_r).abs(), (s_p - s_r).abs()) / scale
            g = torch.where(rows, g, torch.zeros_like(g))
            if g.numel():
                self.fit_gap = worst(self.fit_gap, float(g.amax()))
            self.fit_rows += int(rows.sum())

    @property
    def k1_rows_diff(self) -> float:
        return self.rows_diff / max(1, self.rows)

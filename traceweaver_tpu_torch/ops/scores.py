"""Gaussian-mixture delay scores (mirrors ``traceweaver_tpu/ops/scores.py``)
and the solver's score build, with its Hopper kernel.

Mixture parameters ride as ``[..., K]`` rows (weight 0 = padding) and
broadcast against the delays, so one call scores a whole batch of
windows.

- :func:`mixture_logpdf` and :func:`pair_scores`: the elementwise form,
  the plain version of the score build. It stays what the CPU runs and
  keeps the port equal to the JAX package bit for bit there.
- :func:`mixture_logpdf_gemm`: the GEMM form (``TW_SCORE_GEMM`` in the
  JAX package; ``score_gemm=`` in the port), centred quadratic features
  ``[y^2, y, 1] @ C[3, K]``. As in the JAX package the small product is
  a plain matrix product, not a kernel, on either device.
- :func:`score_block`: one endpoint's f32 score block from its mixture
  terms (the incoming-edge term, the predecessor terms, the successor
  terms, the return term). On the CPU it is :func:`score_block_plain`,
  the JAX solver's sums in its grouping (``weaver_tpu.py:224-255``); on
  the card it is :func:`score_block_cuda`, which builds the block from
  all its terms in one launch of the score-build kernel,
  ``csrc/scores.cu score_block_kernel`` (launches counted in
  :data:`LAUNCHES`), and writes it once. That kernel has no TPU
  counterpart: XLA fuses the build there. It repairs the plain build's
  peak memory (every term's f64 temporaries over ``[B, N, M, K]``).

The kernel's ``fmaf`` rounds ``-z/2 * z - log sd`` once, as the FMA that
XLA contracts; the plain :func:`_fma` reaches the same value through
f64 and rounds twice. The kernel sums the terms in the plain build's
grouping, one after another within a group, where ``torch.stack(...)
.sum(0)`` need not add them in that order, and its ``expf``/``logf``
need not round as PyTorch's do. So the two builds may differ in the
last bits of some entries.
"""

from __future__ import annotations

import ctypes
import math
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch

from traceweaver_tpu_torch.ops import cuda_build

LOG_2PI = math.log(2.0 * math.pi)

#: launches of the score-build kernel (one per :func:`score_block_cuda`
#: call of at most :data:`MAX_KERNEL_TERMS` terms)
LAUNCHES: Dict[str, int] = {"score_block": 0}
#: most terms one launch takes (``TWS_MAX_TERMS``)
MAX_KERNEL_TERMS = 32
#: most mixture components the kernel takes (``TWS_MAX_K``)
MAX_KERNEL_COMPONENTS = 8

_lock = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` with the product exact (in f64), as a fused
    multiply-add computes it. XLA contracts this pattern into an FMA;
    matching it keeps the port's scores equal to the reference's where
    a one-ulp difference in a score of ~1e3 would flip a rounding tie."""
    return (a.double() * b.double() + c.double()).to(a.dtype)


def mixture_logpdf(x: torch.Tensor, weights: torch.Tensor,
                   means: torch.Tensor, stds: torch.Tensor) -> torch.Tensor:
    """Log-density of a Gaussian mixture; x: [...], params: [..., K]
    broadcastable against ``x[..., None]``."""
    z = (x[..., None] - means) / stds
    comp = _fma(-0.5 * z, z, -torch.log(stds)) - 0.5 * LOG_2PI
    logw = torch.where(weights > 0,
                       torch.log(torch.clamp(weights, min=1e-30)),
                       torch.full_like(weights, -math.inf))
    return torch.logsumexp(comp + logw, dim=-1)


def mixture_logpdf_gemm(x: torch.Tensor, weights: torch.Tensor,
                        means: torch.Tensor, stds: torch.Tensor,
                        out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The mixture log-density as a product of centred quadratic features
    with per-component coefficients (JAX ``mixture_logpdf_gemm``)::

        comp_k(x) + log w_k = a_k y^2 + b_k y + c_k,  y = x - mu_bar
        a_k = -1/(2 sd_k^2),  b_k = d_k/sd_k^2,  d_k = mu_k - mu_bar
        c_k = -d_k^2/(2 sd_k^2) - log sd_k - log sqrt(2 pi) + log w_k

    centred at the weighted mean of the means, ``mu_bar``, so that the
    features keep their mantissa at microsecond delays. x: [...]; params
    [K] or one row per leading index of x (``[B, 1, ..., 1, K]``).

    ``out_dtype=torch.bfloat16`` feeds the product bf16 operands with an
    f32 accumulator (each bf16 product is exact in f32) and returns the
    block in bf16; the coefficients and the log-sum-exp stay f32.
    """
    var = stds * stds
    wsum = torch.clamp(weights.sum(dim=-1, keepdim=True), min=1e-30)
    mu_bar = (weights * means).sum(dim=-1, keepdim=True) / wsum   # [..., 1]
    d = means - mu_bar
    a = -0.5 / var
    b = d / var
    logw = torch.where(weights > 0, torch.log(torch.clamp(weights, min=1e-30)),
                       torch.full_like(weights, -math.inf))
    c = -0.5 * d * d / var - torch.log(stds) - 0.5 * LOG_2PI + logw
    K = weights.shape[-1]
    groups = weights.shape[0] if weights.dim() > 1 else 1
    coef = torch.stack([a, b, c], dim=-2).reshape(groups, 3, K)  # [G, 3, K]
    y = x - mu_bar[..., 0]
    feats = torch.stack([y * y, y, torch.ones_like(y)], dim=-1)   # [..., 3]
    f = feats.reshape(groups, -1, 3)
    if out_dtype == torch.bfloat16:
        f = f.to(torch.bfloat16).to(torch.float32)
        coef = coef.to(torch.bfloat16).to(torch.float32)
    logits = torch.bmm(f, coef).reshape(*feats.shape[:-1], K)
    out = torch.logsumexp(logits, dim=-1)
    return out if out_dtype is None else out.to(out_dtype)


def pair_scores(t_prev: torch.Tensor, out_start: torch.Tensor,
                weights: torch.Tensor, means: torch.Tensor,
                stds: torch.Tensor) -> torch.Tensor:
    """S[..., i, j] = log p(out_start[..., j] - t_prev[..., i]) under one
    edge's mixture. t_prev: [..., N]; out_start: [..., M]; params:
    [..., K] (one row per leading index)."""
    delta = out_start[..., None, :] - t_prev[..., :, None]      # [..., N, M]
    return mixture_logpdf(delta, weights[..., None, None, :],
                          means[..., None, None, :], stds[..., None, None, :])


# ---------------------------------------------------------------------------
# the score build: one endpoint's block from its mixture terms
# ---------------------------------------------------------------------------

@dataclass
class MixtureTerm:
    """One edge's term of a [B, N, M] score block: the delay of pair
    (i, j) is ``col_t[b, j] - row_t[b, i]``, or ``row_t[b, i] -
    col_t[b, j]`` with ``flip``; it adds the mixture ``wt, mu, sd``
    ([B, K]) where window b is ``active`` ([B] bool) and, when given,
    row i is ``row_ok`` ([B, N] bool), else 0."""

    row_t: torch.Tensor
    col_t: torch.Tensor
    wt: torch.Tensor
    mu: torch.Tensor
    sd: torch.Tensor
    active: torch.Tensor
    row_ok: Optional[torch.Tensor] = None
    flip: bool = False

    def delta(self) -> torch.Tensor:
        if self.flip:
            return self.row_t[:, :, None] - self.col_t[:, None, :]
        return self.col_t[:, None, :] - self.row_t[:, :, None]

    def mask(self) -> torch.Tensor:
        m = self.active[:, None, None]
        return m if self.row_ok is None else m & self.row_ok[:, :, None]

    def values(self, gemm: bool = False) -> torch.Tensor:
        """The masked term [B, N, M], plain PyTorch (0 where masked)."""
        fn = mixture_logpdf_gemm if gemm else mixture_logpdf
        sc = fn(self.delta(), *(p[:, None, None, :] for p in (self.wt, self.mu, self.sd)))
        return torch.where(self.mask(), sc, torch.zeros((), dtype=sc.dtype,
                                                         device=sc.device))


def score_block_plain(root: MixtureTerm, preds: Sequence[MixtureTerm],
                      succs: Sequence[MixtureTerm], ret: MixtureTerm,
                      gemm: bool = False) -> torch.Tensor:
    """The block as the JAX solver sums it: the root term, plus the sum
    of the predecessor terms, plus the sum of the successor terms, plus
    the return term (``gemm``: each term by :func:`mixture_logpdf_gemm`)."""
    S = root.values(gemm)
    S = S + torch.stack([t.values(gemm) for t in preds]).sum(dim=0)
    S = S + torch.stack([t.values(gemm) for t in succs]).sum(dim=0)
    return S + ret.values(gemm)


def score_block_cuda(root: MixtureTerm, preds: Sequence[MixtureTerm],
                     succs: Sequence[MixtureTerm], ret: MixtureTerm) -> torch.Tensor:
    """The block built by the score-build kernel: every term in one
    launch (more than :data:`MAX_KERNEL_TERMS` take one launch each
    such stretch, the later ones adding into the block), the block
    written once."""
    B, N = root.row_t.shape
    M = root.col_t.shape[1]
    _check("row_t", root.row_t, torch.float32, (B, N))
    S = torch.empty(B, N, M, dtype=torch.float32, device=root.row_t.device)
    terms = [(t, g) for g, group in enumerate(([root], preds, succs, [ret]))
             for t in group]
    for at in range(0, len(terms), MAX_KERNEL_TERMS):
        _launch(S, terms[at:at + MAX_KERNEL_TERMS], accumulate=at > 0)
    return S


def score_block(root: MixtureTerm, preds: Sequence[MixtureTerm],
                succs: Sequence[MixtureTerm], ret: MixtureTerm,
                gemm: bool = False) -> torch.Tensor:
    """One endpoint's f32 score block: the kernel for CUDA tensors, the
    plain version on the CPU; ``gemm`` takes the GEMM form on either
    device (plain products, as in the JAX package)."""
    if gemm or root.row_t.device.type == "cpu":
        return score_block_plain(root, preds, succs, ret, gemm=gemm)
    return score_block_cuda(root, preds, succs, ret)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def build(verbose: bool = False) -> str:
    """Compile ``csrc/scores.cu`` (see :func:`cuda_build.build`)."""
    return cuda_build.build("scores.cu", "tw_scores", verbose)


class _Term(ctypes.Structure):
    """``TwsTerm`` of ``csrc/scores.cu``: the term's pointers, their
    batch strides in elements, its orientation and its group."""

    _fields_ = [(name, ctypes.c_void_p) for name in
                ("row_t", "col_t", "wt", "mu", "sd", "active", "row_ok")] + [
        (name, ctypes.c_longlong) for name in
        ("s_row", "s_col", "s_par", "s_act", "s_ok")] + [
        ("flip", ctypes.c_int), ("group", ctypes.c_int)]


def _lib() -> ctypes.CDLL:
    global _LIB
    with _lock:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.tw_score_block.argtypes = [p, p, i, i, i, i, i, i, p]
            lib.tw_score_block.restype = i
            lib.tw_score_term_size.restype = i
            lib.tw_score_max_terms.restype = i
            if (lib.tw_score_term_size() != ctypes.sizeof(_Term)
                    or lib.tw_score_max_terms() != MAX_KERNEL_TERMS):
                raise RuntimeError("csrc/scores.cu and ops/scores.py disagree on "
                                   "the term layout or the most terms a launch")
            _LIB = lib
    return _LIB


def reset_launches() -> None:
    with _lock:
        LAUNCHES["score_block"] = 0


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _rows(name: str, t: torch.Tensor, dtype: torch.dtype, shape, keep: list):
    """Pointer and batch stride of a checked [B, ...] operand whose last
    dimension is contiguous (copied when it is not; ``keep`` holds the
    copy until the launch is queued)."""
    _check(name, t, dtype, shape)
    if len(shape) > 1 and t.stride(-1) != 1:
        t = t.contiguous()
    keep.append(t)
    return t.data_ptr(), t.stride(0)


def _launch(S: torch.Tensor, terms, accumulate: bool) -> None:
    """One launch of the score-build kernel over ``terms`` ([(term,
    group)], at most :data:`MAX_KERNEL_TERMS`): writes their grouped sum
    into ``S`` [B, N, M], or adds it with ``accumulate``."""
    B, N, M = S.shape
    K = terms[0][0].wt.shape[1]
    if K > MAX_KERNEL_COMPONENTS:
        raise ValueError(f"{K} mixture components; the kernel takes at most "
                         f"{MAX_KERNEL_COMPONENTS}")
    keep: list = []
    arr = (_Term * len(terms))()
    for d, (t, group) in zip(arr, terms):
        f32 = torch.float32
        d.row_t, d.s_row = _rows("row_t", t.row_t, f32, (B, N), keep)
        d.col_t, d.s_col = _rows("col_t", t.col_t, f32, (B, M), keep)
        mix = (t.wt, t.mu, t.sd)
        if len({m.stride() for m in mix}) > 1 or mix[0].stride(-1) != 1:
            # the kernel reads the three rows with one stride
            mix = tuple(m.contiguous() for m in mix)
        (d.wt, d.s_par), (d.mu, _), (d.sd, _) = (
            _rows(name, m, f32, (B, K), keep) for name, m in zip(("wt", "mu", "sd"), mix))
        d.active, d.s_act = _rows("active", t.active, torch.bool, (B,), keep)
        if t.row_ok is not None:
            d.row_ok, d.s_ok = _rows("row_ok", t.row_ok, torch.bool, (B, N), keep)
        d.flip, d.group = int(t.flip), group
    lib = _lib()
    with torch.cuda.device(S.device):
        err = lib.tw_score_block(S.data_ptr(), arr, len(terms), K, int(accumulate),
                                 B, N, M, torch.cuda.current_stream(S.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"score_block launch: CUDA error {err}")
    with _lock:
        LAUNCHES["score_block"] += 1

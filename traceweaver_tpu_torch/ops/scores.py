"""Gaussian-mixture delay scores (mirrors ``traceweaver_tpu/ops/scores.py``)
and the solver's block assembly, with its Hopper kernel.

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
- :func:`assemble_block`: one endpoint's whole OT block from its mixture
  terms (the incoming-edge term, the predecessor terms, the successor
  terms, the return term) and its windows' times: the score block,
  masked by feasibility, a skip column, at bf16 each row centred and
  rounded, and a dummy row; with each row's feasible count and argmax.
  On the CPU, and in the GEMM form on either device, it is
  :func:`assemble_block_plain`, the JAX solver's expressions
  (``weaver_tpu.py:224-311``); for CUDA tensors it is
  :func:`assemble_block_cuda`, one launch of the assembly kernel
  ``csrc/scores.cu assemble_block_kernel`` (launches counted in
  :data:`LAUNCHES`), which writes the block once in its final type.
  That kernel has no TPU counterpart: XLA fuses the assembly there.

The kernel's ``fmaf`` rounds ``-z/2 * z - log sd`` once, as the FMA that
XLA contracts; the plain :func:`_fma` reaches the same value through
f64 and rounds twice. The kernel sums the terms in the plain build's
grouping, one after another within a group, where ``torch.stack(...)
.sum(0)`` need not add them in that order, and its ``expf``/``logf``
need not round as PyTorch's do. So the two may differ in the last bits
of some entries.
"""

from __future__ import annotations

import ctypes
import math
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch

from traceweaver_tpu_torch.ops import cuda_build
from traceweaver_tpu_torch.ops.sinkhorn import NEG

LOG_2PI = math.log(2.0 * math.pi)
SKIP_MARGIN = 4.0    # log-space margin a real candidate must beat to avoid skip
SKIP_FLOOR = -60.0   # skip score floor so candidate-less rows still take skip

#: launches of the assembly kernel (one per :func:`assemble_block_cuda`
#: call)
LAUNCHES: Dict[str, int] = {"assemble_block": 0}
#: most term descriptors that ride in the kernel's parameters
#: (``TWA_MAX_TERMS``); a longer list goes to the card as an array
MAX_PARAM_TERMS = 32
#: most mixture components the kernel takes (``TWA_MAX_K``)
MAX_KERNEL_COMPONENTS = 8
#: most columns a block may have (the kernel's column lists are 16-bit)
MAX_KERNEL_COLUMNS = 65535

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


def assemble_block_plain(root: MixtureTerm, preds: Sequence[MixtureTerm],
                         succs: Sequence[MixtureTerm], ret: MixtureTerm,
                         in_s, in_e, in_v, o_s, o_e, o_v, t_prev,
                         t_succ: Optional[torch.Tensor], force_skip,
                         precision: str = "f32", gemm: bool = False):
    """One endpoint's OT block, plain PyTorch (the JAX solver's
    ``weaver_tpu.py:224-311``): the score block from its terms
    (:func:`score_block_plain`), masked by feasibility, a skip column, at
    ``precision="bf16"`` each row centred at its best feasible score and
    rounded to bf16, and a dummy row of zeros.

    Windows ``[B, W]`` (``in_s``, ``in_e``, ``in_v``, ``t_prev``,
    ``t_succ``, ``force_skip``) against columns ``[B, M]`` (``o_s``,
    ``o_e``, ``o_v``); ``t_succ`` is None on a forward sweep. Returns
    ``S_ot`` [B, W+1, M+1] in the score type, ``feas_count`` [B, W]
    int32 and the first-index argmax of each row of ``S_ot[:, :W]``
    [B, W] int32."""
    S = score_block_plain(root, preds, succs, ret, gemm=gemm)
    B, W, M = S.shape
    zero = torch.zeros((), dtype=S.dtype, device=S.device)
    neg = torch.full((), NEG, dtype=S.dtype, device=S.device)

    # --- feasibility --------------------------------------------------
    feas = (in_v[:, :, None] & o_v[:, None, :]
            & (in_s[:, :, None] <= o_s[:, None, :])
            & (o_e[:, None, :] <= in_e[:, :, None])
            & (t_prev[:, :, None] <= o_s[:, None, :])
            & ~force_skip[:, :, None])
    if t_succ is not None:
        feas = feas & (o_e[:, None, :] <= t_succ[:, :, None])
    S = torch.where(feas, S, neg)
    feas_count = feas.sum(dim=2, dtype=torch.int32)

    # --- skip column ----------------------------------------------------
    row_best = S.amax(dim=2)
    skip_score = torch.clamp(row_best - SKIP_MARGIN, min=SKIP_FLOOR)
    skip_score = torch.where(force_skip, zero, skip_score)
    skip_score = torch.where(in_v, skip_score, neg)
    Sfull = torch.cat([S, skip_score[:, :, None]], dim=2)     # [B, W, M+1]
    if precision == "bf16":
        # entropic OT is invariant to a constant per row: centred at
        # its best feasible score, a row keeps its margins in bf16's
        # 8 mantissa bits; masked entries stay NEG (in place on the
        # fresh f32 block: no second f32 copy)
        row_ref = torch.where(row_best > NEG / 2, row_best, zero)
        masked = Sfull <= NEG / 2
        Sfull = Sfull.sub_(row_ref[:, :, None]).masked_fill_(masked, NEG).to(
            torch.bfloat16)
        del masked

    # --- dummy row (absorbs surplus columns) ----------------------------
    S_ot = torch.cat([Sfull, torch.zeros(B, 1, M + 1, dtype=Sfull.dtype,
                                         device=Sfull.device)], dim=1)
    return S_ot, feas_count, Sfull.argmax(dim=2).to(torch.int32)


def assemble_block(root: MixtureTerm, preds: Sequence[MixtureTerm],
                   succs: Sequence[MixtureTerm], ret: MixtureTerm,
                   in_s, in_e, in_v, o_s, o_e, o_v, t_prev,
                   t_succ: Optional[torch.Tensor], force_skip,
                   precision: str = "f32", gemm: bool = False):
    """One endpoint's OT block, its feasible counts and its row argmax
    (see :func:`assemble_block_plain`): the kernel for CUDA tensors, the
    plain version on the CPU; ``gemm`` takes the GEMM form, plain
    products, on either device (as in the JAX package)."""
    args = (root, preds, succs, ret, in_s, in_e, in_v, o_s, o_e, o_v, t_prev, t_succ,
            force_skip)
    if gemm or in_s.device.type == "cpu":
        return assemble_block_plain(*args, precision=precision, gemm=gemm)
    return assemble_block_cuda(*args, precision=precision)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def build(verbose: bool = False) -> str:
    """Compile ``csrc/scores.cu`` (see :func:`cuda_build.build`)."""
    return cuda_build.build("scores.cu", "tw_scores", verbose)


class _Term(ctypes.Structure):
    """``TwaTerm`` of ``csrc/scores.cu``: the term's pointers, their
    batch strides in elements, the column array it reads (0 ``o_s``, 1
    ``o_e``), its orientation and its group."""

    _fields_ = [(name, ctypes.c_void_p) for name in
                ("row_t", "wt", "mu", "sd", "active", "row_ok")] + [
        (name, ctypes.c_longlong) for name in ("s_row", "s_par", "s_act", "s_ok")] + [
        (name, ctypes.c_int) for name in ("col", "flip", "group", "pad")]


class _Block(ctypes.Structure):
    """``TwaBlock`` of ``csrc/scores.cu``: the outputs, the row and column
    operands with their batch strides, the sizes and the score type."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "S_ot", "feas_count", "argmax", "in_s", "in_e", "t_prev", "t_succ", "o_s",
        "o_e", "in_v", "force_skip", "o_v")] + [
        (name, ctypes.c_longlong) for name in (
            "s_in_s", "s_in_e", "s_in_v", "s_t_prev", "s_t_succ", "s_fs", "s_os",
            "s_oe", "s_ov")] + [
        (name, ctypes.c_int) for name in ("B", "W", "M", "K", "n_terms", "bf16")]


def _lib() -> ctypes.CDLL:
    global _LIB
    with _lock:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            p = ctypes.c_void_p
            lib.tw_assemble_block.argtypes = [p, p, p, p]
            lib.tw_assemble_block.restype = ctypes.c_int
            for fn in ("tw_assemble_block_size", "tw_assemble_term_size",
                       "tw_assemble_max_terms"):
                getattr(lib, fn).restype = ctypes.c_int
            if (lib.tw_assemble_block_size() != ctypes.sizeof(_Block)
                    or lib.tw_assemble_term_size() != ctypes.sizeof(_Term)
                    or lib.tw_assemble_max_terms() != MAX_PARAM_TERMS):
                raise RuntimeError("csrc/scores.cu and ops/scores.py disagree on "
                                   "the descriptor layout or the parameter terms")
            _LIB = lib
    return _LIB


def reset_launches() -> None:
    with _lock:
        LAUNCHES["assemble_block"] = 0


def _operand(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> int:
    """Batch stride of a [B, ...] operand of the kernel, after checking
    its type and shape and that its last dimension is contiguous."""
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if len(shape) > 1 and shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: expected a contiguous last dimension, got strides "
                         f"{t.stride()}")
    return t.stride(0) if shape[0] > 1 else 0


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride())


def assemble_block_cuda(root: MixtureTerm, preds: Sequence[MixtureTerm],
                        succs: Sequence[MixtureTerm], ret: MixtureTerm,
                        in_s, in_e, in_v, o_s, o_e, o_v, t_prev,
                        t_succ: Optional[torch.Tensor], force_skip,
                        precision: str = "f32"):
    """:func:`assemble_block_plain` (without the GEMM form) in one launch
    of the assembly kernel. Every term reads its columns from ``o_s`` or
    ``o_e`` (the same tensor); terms of more than
    :data:`MAX_PARAM_TERMS` go to the card as an array of descriptors.
    Raises on what the kernel does not take."""
    B, W = in_s.shape
    M = o_s.shape[1]
    terms = [(t, g) for g, group in enumerate(([root], preds, succs, [ret]))
             for t in group]
    K = root.wt.shape[1]
    if K > MAX_KERNEL_COMPONENTS:
        raise ValueError(f"{K} mixture components; the kernel takes at most "
                         f"{MAX_KERNEL_COMPONENTS}")
    if not 1 <= M <= MAX_KERNEL_COLUMNS or W < 1:
        raise ValueError(f"[{W}, {M}] windows; the kernel takes 1 to "
                         f"{MAX_KERNEL_COLUMNS} columns and at least one row")
    f32, b8 = torch.float32, torch.bool
    blk = _Block(B=B, W=W, M=M, K=K, n_terms=len(terms), bf16=int(precision == "bf16"))
    for name, stride, t, dtype, shape in (
            ("in_s", "s_in_s", in_s, f32, (B, W)), ("in_e", "s_in_e", in_e, f32, (B, W)),
            ("t_prev", "s_t_prev", t_prev, f32, (B, W)),
            ("t_succ", "s_t_succ", t_succ, f32, (B, W)),
            ("in_v", "s_in_v", in_v, b8, (B, W)), ("force_skip", "s_fs", force_skip, b8, (B, W)),
            ("o_s", "s_os", o_s, f32, (B, M)), ("o_e", "s_oe", o_e, f32, (B, M)),
            ("o_v", "s_ov", o_v, b8, (B, M))):
        if t is not None:  # t_succ is None on a forward sweep
            setattr(blk, stride, _operand(name, t, dtype, shape))
            setattr(blk, name, t.data_ptr())
    arr = (_Term * len(terms))()
    for d, (t, group) in zip(arr, terms):
        if _same(t.col_t, o_s) and not t.flip:
            d.col = 0
        elif _same(t.col_t, o_e) and t.flip:
            d.col = 1
        else:
            raise ValueError("the kernel reads an unflipped term's columns from o_s "
                             "and a flipped term's from o_e")
        d.row_t, d.s_row = t.row_t.data_ptr(), _operand("row_t", t.row_t, f32, (B, W))
        d.s_par = _operand("wt", t.wt, f32, (B, K))
        for name in ("mu", "sd"):
            m = getattr(t, name)
            if _operand(name, m, f32, (B, K)) != d.s_par:
                raise ValueError("a term's wt, mu and sd must share one batch stride")
        d.wt, d.mu, d.sd = t.wt.data_ptr(), t.mu.data_ptr(), t.sd.data_ptr()
        d.active, d.s_act = t.active.data_ptr(), _operand("active", t.active, b8, (B,))
        if t.row_ok is not None:
            d.row_ok, d.s_ok = t.row_ok.data_ptr(), _operand("row_ok", t.row_ok, b8, (B, W))
        d.flip, d.group = int(t.flip), group
    dev = in_s.device
    for t in (in_s, in_e, in_v, o_s, o_e, o_v, t_prev, t_succ, force_skip,
              *(x for term, _ in terms for x in (term.row_t, term.wt, term.mu, term.sd,
                                                  term.active, term.row_ok))):
        if t is not None and t.device != dev or dev.type != "cuda":
            raise ValueError(f"expected CUDA tensors on one card, got {dev} and "
                             f"{t.device if t is not None else dev}")
    dtype = torch.bfloat16 if precision == "bf16" else f32
    S_ot = torch.empty(B, W + 1, M + 1, dtype=dtype, device=dev)
    feas_count = torch.empty(B, W, dtype=torch.int32, device=dev)
    argmax = torch.empty(B, W, dtype=torch.int32, device=dev)
    blk.S_ot, blk.feas_count, blk.argmax = (S_ot.data_ptr(), feas_count.data_ptr(),
                                            argmax.data_ptr())
    ext = None
    if len(terms) > MAX_PARAM_TERMS:
        # stream-ordered before the launch; freed to the caching allocator
        # on this stream, so no later allocation reuses it before the kernel
        ext = torch.frombuffer(bytearray(arr), dtype=torch.uint8).to(dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.tw_assemble_block(ctypes.addressof(blk), ctypes.addressof(arr),
                                    ext.data_ptr() if ext is not None else None,
                                    torch.cuda.current_stream(dev).cuda_stream)
    if err == -1:
        raise ValueError(f"[{W}, {M}] windows: one row of {M} columns does not fit "
                         "in the kernel's shared memory")
    if err != 0:
        raise RuntimeError(f"assemble_block launch: CUDA error {err}")
    if B:
        with _lock:
            LAUNCHES["assemble_block"] += 1
    return S_ot, feas_count, argmax

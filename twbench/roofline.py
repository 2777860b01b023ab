"""The card's peaks and the operations and bytes of the two kernels.

Frozen copies of ``chip_smoke.py``: the peaks (lines 1079-1085), the
exponential rate of :func:`exp_rate` (lines 1102-1120), K1's count of
``kernel_timing`` (lines 1426-1453) and the assembly's count of
``assembly_bound`` (lines 1654-1687). Each input byte is read once and each
output byte written once; the exponentials are one an element a
half-iteration of Sinkhorn plus one to form the plan, with the iterations
these inputs need.

The exponential peak is derived, not published: 16 exponentials a clock an
SM (the CUDA programming guide's throughput table for compute capability
9.0) times the SMs times the card's maximum SM clock
(``nvidia-smi clocks.max.sm``).
"""

from __future__ import annotations

import subprocess
from typing import Dict, Optional, Tuple

#: NVIDIA H100 SXM data sheet: HBM bytes a second and f32 operations a
#: second outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
EXP_PER_CLOCK_PER_SM = 16
#: the solver's top-k width (``algorithms/weaver_torch.py DEFAULT_TOPK``)
TOPK = 5


def nvidia_smi(query: str) -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--id=0", f"--query-gpu={query}",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0].strip() if out else None


def exp_rate() -> Tuple[float, float]:
    """Exponentials a second of card 0 at its maximum SM clock, and that
    clock in MHz."""
    import torch

    props = torch.cuda.get_device_properties(0)
    mhz = None
    raw = nvidia_smi("clocks.max.sm")
    try:
        mhz = float(raw) if raw else None
    except ValueError:
        mhz = None
    if not mhz:
        khz = getattr(props, "clock_rate", None)
        mhz = khz / 1e3 if khz else None
    if not mhz:
        raise RuntimeError("cannot read the card's SM clock for the exponential peak")
    return EXP_PER_CLOCK_PER_SM * props.multi_processor_count * mhz * 1e6, mhz


def bound_s(nbytes: float, ops: float, exps: float, rate: float) -> Tuple[float, str]:
    """The least seconds for the counts, and the term that sets it."""
    terms = dict(bytes=nbytes / PEAK_BYTES_PER_S, f32=ops / PEAK_F32_OPS_PER_S,
                 exp=exps / rate)
    term = max(terms, key=terms.get)
    return terms[term], term


def k1_counts(B: int, R: int, C: int, n_rows: int, iters: float, rounds: float,
              itemsize: int, topk: int = TOPK) -> Dict[str, float]:
    """Bytes, f32 operations and exponentials of one K1 launch over
    ``[B, R, C]`` blocks whose Sinkhorn ran ``iters`` iterations and whose
    rounding ran ``rounds`` rounds in all (summed over the blocks)."""
    cells = R * C
    ops = (10.0 * iters * cells + 6.0 * B * cells + 2.0 * rounds * n_rows * C
           + topk * B * n_rows * C)
    exps = 2.0 * iters * cells + B * cells
    nbytes = (itemsize * B * cells + 4.0 * (B * R + B * C) + 4.0 * B
              + 4.0 * B * n_rows * (1 + topk))
    return dict(bytes=nbytes, ops=ops, exps=exps)


def assembly_counts(terms, B: int, W: int, M: int, has_succ: bool, feas_count,
                    itemsize: int) -> Dict[str, float]:
    """Bytes, f32 operations and special functions of one assembly launch:
    ``feas_count`` [B, W] is each row's feasible pairs, ``terms`` the
    mixture terms (``wt`` [B, K], ``active`` [B], ``row_ok`` [B, W] or
    None). A term is active on a feasible pair in a window where it is
    active, on a row it does not mask: 10 operations a live component and
    3 a term, K exponentials and one logarithm; a feasible pair 4 more,
    every pair 7 (and 2 at bf16)."""
    f = feas_count.double()
    nbytes = itemsize * B * (W + 1) * (M + 1) + 8.0 * B * W
    nbytes += B * W * (4.0 * (3 + has_succ) + 2) + B * M * 9.0
    ops = B * W * (M + 1) * (7.0 + 2.0 * (itemsize == 2)) + 4.0 * float(f.sum())
    sfu = 0.0
    for t in terms:
        K = t.wt.shape[1]
        nbytes += B * (4.0 * W + 12.0 * K + 1 + (W if t.row_ok is not None else 0))
        on = t.active[:, None] if t.row_ok is None else t.active[:, None] & t.row_ok
        pairs = (f * on.double()).sum(dim=1)
        k = (t.wt > 0).sum(dim=1).double()
        sfu += float((pairs * (k + 1.0)).sum())
        ops += float((pairs * (10.0 * k + 3.0)).sum())
    return dict(bytes=nbytes, ops=ops, exps=sfu)

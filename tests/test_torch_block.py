"""The port's block assembly (``ops/scores.py assemble_block``) against
the JAX package's solver (CPU), and its kernel against its plain version
(card).

- ``assemble_block_plain`` hands ``assign_topk`` the blocks JAX's solver
  hands it, bit for bit, at f32 and bf16, on a forward and a backward
  sweep, with forced skips, padded rows and an endpoint with no valid
  column; the solver's feasible counts equal JAX's;
- the plain version against a numpy reading of its formula: masked
  entries, the skip column, the dummy row, the feasible counts and the
  first-index argmax;
- ``assemble_block`` takes the plain version for CPU tensors and with
  ``gemm`` on any device, the kernel otherwise;
- the kernel's wrapper refuses CPU tensors, more than 8 mixture
  components, and operands of the wrong shape or type.

``gpu`` tests hold the assembly kernel against the plain version on
every entry at odd shapes, both score types and both sweep directions,
and with a 40-term list in one launch.
"""

import numpy as np
import pytest
import torch

from traceweaver_tpu_torch.algorithms import weaver_torch as tw
from traceweaver_tpu_torch.ops import scores as ts

torch.set_num_threads(1)  # small tensors; the test workers share the cores

NEG = -1.0e9


@pytest.fixture(scope="module")
def jx():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from traceweaver_tpu.algorithms import weaver_tpu

    return weaver_tpu


# ---------------------------------------------------------------------------
# the plain version against JAX's solver
# ---------------------------------------------------------------------------

def _masked_problem(seed, B=2, E=3, W=16, M=16):
    """tests/test_precision.py's consistent windows with the last rows
    padded, forced skips on endpoint 0 and no valid column on endpoint
    2 (its rows all masked)."""
    from test_precision import _consistent_problem

    args = list(_consistent_problem(np.random.default_rng(seed), B=B, E=E, W=W, M=M))
    in_valid = args[2].copy()
    in_valid[:, -3:] = False
    args[2] = in_valid
    out_valid = args[5].copy()
    out_valid[:, 2, :] = False
    args[5] = out_valid
    fskip = args[7].copy()
    fskip[:, 0, :4] = True
    args[7] = fskip
    return args


def _capture_port(monkeypatch):
    blocks, real = [], tw.assign_topk

    def keep(S_ot, *a, **kw):
        blocks.extend(S_ot[b].clone() for b in range(S_ot.shape[0]))
        return real(S_ot, *a, **kw)

    monkeypatch.setattr(tw, "assign_topk", keep)
    return blocks


def _capture_jax(monkeypatch, jx):
    import jax

    blocks, real = [], jx.assign_topk

    def keep(S_ot, *a, **kw):
        jax.debug.callback(lambda s: blocks.append(np.asarray(s)), S_ot)
        return real(S_ot, *a, **kw)

    monkeypatch.setattr(jx, "assign_topk", keep)
    jax.clear_caches()  # trace anew, so the callback is in the program
    return blocks


def _sorted_bits(blocks, itemsize):
    view = np.int16 if itemsize == 2 else np.int32
    out = []
    for b in blocks:
        a = (b.view(torch.int16 if itemsize == 2 else torch.int32).numpy()
             if torch.is_tensor(b) else np.asarray(b).view(view))
        out.extend(x.tobytes() for x in (a if a.ndim == 3 else a[None]))
    return sorted(out)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_plain_assembly_equals_jax_blocks_bit_for_bit(precision, jx, monkeypatch):
    """Every OT block of two sweeps (forward, then backward) of every
    window equals JAX's bit for bit; so do the feasible counts."""
    import jax

    args = _masked_problem(11)
    kw = dict(n_sinkhorn=20, n_sweeps=2, sinkhorn_tol=1e-3, precision=precision)
    calls, real = [], ts.assemble_block_plain

    def spy(*a, **k):
        calls.append(a[11] is not None)
        return real(*a, **k)

    monkeypatch.setattr(ts, "assemble_block_plain", spy)
    port_blocks = _capture_port(monkeypatch)
    port = tw.solve_windows(*(torch.as_tensor(np.asarray(a)) for a in args), **kw)
    jax_blocks = _capture_jax(monkeypatch, jx)
    ref = jx.solve_windows(*args, **kw)
    jax.clear_caches()
    assert calls == [False] * 3 + [True] * 3          # one sweep each way
    itemsize = 2 if precision == "bf16" else 4
    assert all(b.element_size() == itemsize for b in port_blocks)
    assert len(port_blocks) == 2 * 3 * 2
    assert _sorted_bits(port_blocks, itemsize) == _sorted_bits(jax_blocks, itemsize)
    assert np.array_equal(port[3].numpy(), np.asarray(ref[3]))


# ---------------------------------------------------------------------------
# a random block (the card's tests use it too)
# ---------------------------------------------------------------------------

def _mixtures(rng, B, K):
    w = rng.uniform(0.1, 1.0, (B, K)).astype(np.float32)
    w[:, K - 2:] *= rng.random((B, 2)) < 0.5          # some padded components
    w /= w.sum(1, keepdims=True)
    mu = rng.uniform(5.0, 150.0, (B, K)).astype(np.float32)
    sd = rng.uniform(2.0, 40.0, (B, K)).astype(np.float32)
    return w, mu, sd


def _block(seed, B, W, M, backward, n_pred=2, n_succ=1, K=5, device="cpu"):
    """The arguments of one ``assemble_block`` call on seeded windows:
    incoming spans of 50-300 time units, children anywhere in them, some
    rows padded or forced to skip, some columns invalid."""
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def b8(a):
        return torch.as_tensor(np.asarray(a, bool), device=device)

    in_s = np.sort(rng.uniform(0.0, 4.0 * W, (B, W)), axis=1)
    in_e = in_s + rng.uniform(50.0, 300.0, (B, W))
    o_s = rng.uniform(0.0, 4.0 * W + 200.0, (B, M))
    o_e = o_s + rng.uniform(1.0, 100.0, (B, M))
    in_v = rng.random((B, W)) < 0.9
    in_v[:, -1] = False
    fs = rng.random((B, W)) < 0.1
    t_prev = in_s + rng.uniform(-5.0, 30.0, (B, W))
    t_succ = in_e - rng.uniform(0.0, 60.0, (B, W)) if backward else None
    ops = dict(in_s=f32(in_s), in_e=f32(in_e), in_v=b8(in_v), o_s=f32(o_s),
               o_e=f32(o_e), o_v=b8(rng.random((B, M)) < 0.9), t_prev=f32(t_prev),
               t_succ=None if t_succ is None else f32(t_succ), force_skip=b8(fs))

    def term(row_t, flip, row_ok=False):
        w, mu, sd = (f32(a) for a in _mixtures(rng, B, K))
        ok = b8(rng.random((B, W)) < 0.6) if row_ok else None
        return ts.MixtureTerm(row_t, ops["o_e"] if flip else ops["o_s"], w, mu, sd,
                              b8(rng.random(B) < 0.8), row_ok=ok, flip=flip)

    root = term(ops["in_s"], False)
    preds = [term(f32(in_s + rng.uniform(0.0, 40.0, (B, W))), False)
             for _ in range(n_pred)]
    succs = [term(f32(in_e - rng.uniform(0.0, 40.0, (B, W))), True, row_ok=True)
             for _ in range(n_succ)]
    ret = term(ops["in_e"], True)
    return (root, preds, succs, ret, ops["in_s"], ops["in_e"], ops["in_v"], ops["o_s"],
            ops["o_e"], ops["o_v"], ops["t_prev"], ops["t_succ"], ops["force_skip"])


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("backward", [False, True])
def test_plain_assembly_masks_skips_and_pads_as_its_formula(precision, backward):
    args = _block(5, B=3, W=9, M=13, backward=backward)
    S_ot, feas_count, best = ts.assemble_block_plain(*args, precision=precision)
    in_s, in_e, in_v, o_s, o_e, o_v, t_prev, t_succ, fs = (
        None if a is None else a.numpy() for a in args[4:])
    B, W = in_s.shape
    M = o_s.shape[1]
    assert S_ot.shape == (B, W + 1, M + 1)
    assert S_ot.dtype == (torch.bfloat16 if precision == "bf16" else torch.float32)
    feas = (in_v[:, :, None] & o_v[:, None, :] & (in_s[:, :, None] <= o_s[:, None, :])
            & (o_e[:, None, :] <= in_e[:, :, None]) & (t_prev[:, :, None] <= o_s[:, None, :])
            & ~fs[:, :, None])
    if backward:
        feas &= o_e[:, None, :] <= t_succ[:, :, None]
    assert 0 < feas.sum() < feas.size
    S = S_ot.float().numpy()
    neg = torch.tensor(NEG).to(S_ot.dtype).item()                   # NEG, stored
    assert np.array_equal(feas_count.numpy(), feas.sum(axis=2))
    assert np.all(S[:, :W, :M][~feas] == neg)
    assert np.all(S[:, W] == 0.0)                                   # the dummy row
    skip = S[:, :W, M]
    assert np.all(skip[~in_v] == neg)
    assert np.all(skip[in_v & fs] == 0.0)
    raw = ts.score_block_plain(*args[:4]).numpy()
    best_s = np.where(feas, raw, NEG).max(axis=2)
    want = np.maximum(best_s - 4.0, -60.0).astype(np.float32)
    live = in_v & ~fs
    if precision == "bf16":  # centred at the row's best feasible score
        ref = np.where(best_s > NEG / 2, best_s, 0.0).astype(np.float32)
        want = torch.tensor(want - ref).to(torch.bfloat16).float().numpy()
        assert np.all(S[:, :W, :M][feas] <= 0.0)
    else:
        assert np.array_equal(S[:, :W, :M][feas], raw[feas])
    assert np.array_equal(skip[live], want[live])
    assert np.array_equal(best.numpy(), S[:, :W].argmax(axis=2))


# ---------------------------------------------------------------------------
# dispatch and the wrapper's checks
# ---------------------------------------------------------------------------

def _recorders(monkeypatch):
    seen = []

    def record(name):
        def fn(*args, **kw):
            seen.append((name, kw.get("gemm", False)))
            return name
        return fn

    monkeypatch.setattr(ts, "assemble_block_plain", record("plain"))
    monkeypatch.setattr(ts, "assemble_block_cuda", record("kernel"))
    return seen


@pytest.mark.parametrize("device,gemm,want", [
    ("cpu", False, ("plain", False)), ("cpu", True, ("plain", True)),
    ("meta", True, ("plain", True)), ("meta", False, ("kernel", False))])
def test_assemble_block_takes_the_plain_version_on_the_cpu_and_with_gemm(
        device, gemm, want, monkeypatch):
    """CPU tensors and the GEMM form take the plain version; tensors on
    another device (meta: no card here) take the kernel's wrapper."""
    args = _block(2, B=2, W=5, M=6, backward=False, device=device)
    seen = _recorders(monkeypatch)
    assert ts.assemble_block(*args, gemm=gemm) == want[0]
    assert seen == [want]


def _bad(case):
    args = list(_block(3, B=2, W=5, M=6, backward=True))
    if case == "components":
        root = args[0]
        pad = torch.zeros(2, 4)
        args[0] = ts.MixtureTerm(root.row_t, root.col_t, torch.cat([root.wt, pad], 1),
                                 torch.cat([root.mu, pad], 1),
                                 torch.cat([root.sd, pad + 1.0], 1), root.active)
        return args, "at most 8"
    if case == "shape":
        args[10] = args[10][:, :4]
        return args, "shape"
    if case == "dtype":
        args[6] = args[6].to(torch.int32)
        return args, "torch.bool"
    return args, "CUDA tensors"


@pytest.mark.parametrize("case", ["cpu", "components", "shape", "dtype"])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(case):
    args, match = _bad(case)
    before = dict(ts.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        ts.assemble_block_cuda(*args)
    assert ts.LAUNCHES == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card_diff(got, want, precision):
    """(entries differing, entries beyond the tolerance, rows whose
    argmax differs where the plain row's two largest entries are further
    apart than the tolerance): 1e-5 relative plus 1e-4 absolute at f32,
    one bf16 ulp at bf16."""
    S, S0 = got[0].float(), want[0].float()
    if precision == "bf16":
        tol = torch.ldexp(torch.ones_like(S0), torch.frexp(S0)[1] - 8)
    else:
        tol = 1e-4 + 1e-5 * S0.abs()
    same = (S == S0) | (S.isnan() & S0.isnan())
    W = want[1].shape[1]
    top2 = torch.topk(S0[:, :W], 2, dim=2).values
    top_tol = (torch.ldexp(torch.ones_like(top2[..., 0]), torch.frexp(top2[..., 0])[1] - 8)
               if precision == "bf16" else 1e-4 + 1e-5 * top2[..., 0].abs())
    clear = top2[..., 0] - top2[..., 1] > top_tol
    return (int((~same).sum()), int((~same & ~((S - S0).abs() <= tol)).sum()),
            int(((got[2] != want[2]) & clear).sum()))


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("shape", [(3, 7, 11), (2, 1025, 2048), (40, 33, 65)])
def test_assembly_kernel_matches_plain_on_card(shape, backward, precision):
    """One launch against the plain version: feasible counts exactly, the
    argmax exactly where the row's top two are apart by more than the
    tolerance, every entry within it (the count of differing entries in
    the message)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, W, M = shape
    args = _block(sum(shape), B, W, M, backward=backward, device="cuda")
    before = ts.LAUNCHES["assemble_block"]
    got = ts.assemble_block_cuda(*args, precision=precision)
    assert ts.LAUNCHES["assemble_block"] == before + 1
    want = ts.assemble_block_plain(*args, precision=precision)
    torch.cuda.synchronize()
    assert got[0].dtype == want[0].dtype and got[0].shape == want[0].shape
    assert torch.equal(got[1], want[1])
    differ, beyond, argmax = _card_diff(got, want, precision)
    assert beyond == 0 and argmax == 0, (
        f"{differ} of {got[0].numel()} entries differ, {beyond} beyond the tolerance; "
        f"{argmax} argmax rows apart")


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_assembly_kernel_takes_a_40_term_list_in_one_launch_on_card(precision):
    """A list longer than the kernel's parameters hold goes to the card
    as descriptors: one launch, the block still matches the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = list(_block(6, 4, 40, 70, backward=True, n_pred=24, n_succ=14,
                       device="cuda"))
    assert 1 + len(args[1]) + len(args[2]) + 1 == 40
    before = ts.LAUNCHES["assemble_block"]
    got = ts.assemble_block_cuda(*args, precision=precision)
    assert ts.LAUNCHES["assemble_block"] == before + 1
    want = ts.assemble_block_plain(*args, precision=precision)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    differ, beyond, argmax = _card_diff(got, want, precision)
    assert beyond == 0 and argmax == 0, (differ, beyond, argmax)

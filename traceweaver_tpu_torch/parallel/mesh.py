"""Device mesh for the windowed solver (mirrors
``traceweaver_tpu/parallel/mesh.py``).

The natural batch axis is the window axis of perfect-cut segmentation:
windows are independent subproblems, so they shard across devices with
no traffic between them. The JAX package's mesh is single-controller:
one jitted call over arrays placed with a ``NamedSharding`` drives every
device, and XLA SPMD partitions it. Here the mesh is an object in the
process, an ordered tuple of ``torch.device`` and the axis name, and the
same single call (:func:`shard_solve_windows`, ``solve_fleet(mesh=)``,
``WeaverTorch(mesh=)``) launches each shard's solve on its own device.
It is not a set of ``torch.distributed`` ranks: NCCL refuses two ranks
on one card. A device may appear more than once: ``["cpu"] * 8`` is the
CPU tests' counterpart of the JAX package's eight virtual CPU devices,
``["cuda:0"] * 2`` a two-shard mesh on one card.

- :func:`put_sharded` gives each shard its contiguous rows of the
  ``BATCHED`` (window-axis) tensors on its device and a copy of the
  ``REPLICATED`` tables, one per distinct device;
- :func:`coalesce_to_device0` gathers the shards' ``[B]`` convergence
  flags onto the first device, so the host pays one fetch;
- :func:`shard_solve_windows`: data-parallel inference;
- :func:`em_step_sharded`: one EM step, each shard solving its windows
  and taking its slice of every edge's delay samples, with the BIC-GMM
  fit's moment sums (the JAX ``psum``) summed over the shards on the
  first device (:func:`traceweaver_tpu_torch.ops.gmm.fit_gmm_sharded`).

Every shard's kernel launches are planned for the unsharded batch (the
solver's ``plan_b`` argument), so a window's sums run in the order they
run on one device and 1- and N-shard solves are equal. The kernels'
cluster size follows the batch, so on a mesh over several cards a shard
whose own batch would take the larger cluster may launch with the
smaller one: equality costs cluster size there.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from traceweaver_tpu_torch.runtime.bucketing import pow2_bucket

BATCHED = ("in_start", "in_end", "in_valid", "out_start", "out_end",
           "out_valid", "skip_cap", "force_skip")
REPLICATED = ("pred_mask", "root_mask", "is_last",
              "edge_wt", "edge_mu", "edge_sd",
              "in_wt", "in_mu", "in_sd",
              "ret_wt", "ret_mu", "ret_sd")


class Mesh:
    """A 1-D mesh: the devices in shard order and the axis name."""

    def __init__(self, devices: Sequence, axis: str = "data"):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices: Tuple[torch.device, ...] = tuple(torch.device(d) for d in devices)
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis,)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis!r})"


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh over the first ``n_devices`` CUDA devices (all of them when
    None); raises when the machine has fewer. There is no fall-back to
    the CPU (the JAX package falls back to virtual CPU devices): a mesh
    the card cannot hold is an error. ``devices`` names the devices
    instead, in shard order and repeats allowed (``["cpu"] * 8``,
    ``["cuda:0"] * 2``); with ``n_devices`` too, the first that many."""
    if devices is None:
        # twlint-torch: disable=TW103 — counts the cards: a mesh the
        # machine cannot hold raises below
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = count if n_devices is None else int(n_devices)
        if n < 1 or count < n:
            raise RuntimeError(f"cannot assemble a {n}-device mesh: this machine has "
                               f"{count} CUDA device(s)")
        return Mesh([torch.device("cuda", i) for i in range(n)], axis)
    devices = list(devices)
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise RuntimeError(f"cannot assemble a {n_devices}-device mesh from "
                               f"{len(devices)} named device(s)")
        devices = devices[:n_devices]
    return Mesh(devices, axis)


def mesh_for(n_devices: int, device) -> Optional[Mesh]:
    """The mesh of a device count as the ``--mesh_devices`` flag gives it
    (the JAX package's ``TW_MESH_DEVICES``): None for 0, else
    :func:`make_mesh` of the first N cards (raising ``RuntimeError`` when
    the machine has fewer) or, when ``device`` is the CPU, N CPU shards.
    Raises ``ValueError`` unless N is 0 or a power of two."""
    n = int(n_devices)
    if n < 0 or n & (n - 1):
        raise ValueError(f"mesh_devices={n} must be 0 or a positive power of two")
    if n == 0:
        return None
    device = torch.device(device)
    if device.type == "cpu":
        return make_mesh(devices=[device] * n)
    return make_mesh(n)


def bucket_rows_per_shard(n_rows: int, n_shards: int) -> int:
    """Padded batch size of a sharded dispatch: each shard's row count
    rounded up to a power of two, the total a multiple of the mesh.
    ``n_shards=1`` is plain power-of-two bucketing (the single-device
    compaction path). The fleet's ledger (``compact_windows_total``,
    ``d2h_bytes_flags``) counts these padded rows, as the JAX package's
    does."""
    per_shard = -(-max(1, n_rows) // n_shards)  # ceil division
    return pow2_bucket(per_shard) * n_shards


def coalesce_to_device0(shards: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The shards of a window-axis tensor gathered, in shard order, onto
    the mesh's first device: the compaction flag fetch then costs the
    host one transfer, not one a shard."""
    dev0 = mesh.devices[0]
    return torch.cat([s.to(dev0) for s in shards])


def _pad_batch(arrays: Dict[str, np.ndarray],
               multiple: int) -> Tuple[Dict[str, np.ndarray], int]:
    """The ``BATCHED`` arrays padded with all-zero (all-invalid) rows to a
    multiple of ``multiple``; returns them and the true row count."""
    b = arrays["in_start"].shape[0]
    pad = (-b) % multiple
    if pad == 0:
        return arrays, b
    out = dict(arrays)
    for k in BATCHED:
        a = arrays[k]
        out[k] = np.concatenate([a, np.zeros((pad,) + a.shape[1:], dtype=a.dtype)], axis=0)
    return out, b


def shard_slices(n_rows: int, mesh: Mesh) -> List[slice]:
    """Each shard's contiguous rows of a batch of ``n_rows`` (a multiple
    of the mesh size)."""
    if n_rows % mesh.size:
        raise ValueError(f"{n_rows} rows do not divide over {mesh.size} shards")
    per = n_rows // mesh.size
    return [slice(s * per, (s + 1) * per) for s in range(mesh.size)]


def replicate(value, mesh: Mesh) -> List[torch.Tensor]:
    """One tensor a shard, copied once per distinct device."""
    placed: Dict[torch.device, torch.Tensor] = {}
    for dev in mesh.devices:
        if dev not in placed:
            placed[dev] = torch.as_tensor(value, device=dev)
    return [placed[dev] for dev in mesh.devices]


def put_sharded(arrays: Dict[str, np.ndarray], mesh: Mesh) -> Dict[str, List[torch.Tensor]]:
    """Place packed window tensors on the mesh: each ``BATCHED`` key as
    its shards' contiguous rows, each on its shard's device; every other
    key replicated (one copy per distinct device). Values are a list of
    one tensor a shard. The caller pads the batch to a multiple of the
    mesh size (``pack_problem(pad_b=mesh.size)``, :func:`_pad_batch`)."""
    b = next(arrays[k].shape[0] for k in BATCHED if k in arrays)
    slices = shard_slices(b, mesh)
    out = {}
    for k, v in arrays.items():
        if k in BATCHED:
            out[k] = [torch.as_tensor(np.ascontiguousarray(v[sl]), device=dev)
                      for sl, dev in zip(slices, mesh.devices)]
        else:
            out[k] = replicate(v, mesh)
    return out


def shard_solve_windows(arrays: Dict[str, np.ndarray], mesh: Mesh, **kwargs):
    """:func:`~traceweaver_tpu_torch.algorithms.weaver_torch.solve_windows`
    with the window axis sharded over ``mesh``: the batch padded to a
    multiple of the mesh size, each shard solved on its device. Returns
    the four outputs as numpy, trimmed to the true batch."""
    from traceweaver_tpu_torch.algorithms.weaver_torch import ARG_ORDER, solve_windows

    arrays, true_b = _pad_batch(arrays, mesh.size)
    args = put_sharded({k: arrays[k] for k in ARG_ORDER}, mesh)
    outs = [solve_windows(*(args[k][s] for k in ARG_ORDER), plan_b=true_b, **kwargs)
            for s in range(mesh.size)]
    return tuple(np.concatenate([o[i].cpu().numpy() for o in outs])[:true_b]
                 for i in range(4))


def solve_packed_sharded(arrays: Dict[str, np.ndarray], mesh: Mesh, em: bool,
                         plan_b: int, **kw) -> np.ndarray:
    """One packed single-problem dispatch of ``WeaverTorch`` on the mesh
    (the batch already a multiple of the mesh size): the packed block of
    :func:`~traceweaver_tpu_torch.algorithms.weaver_torch.solve_windows_packed`
    or, with ``em``, of both EM passes. ``plan_b`` is the batch the
    unsharded dispatch of the same windows launches: every shard's
    launches are planned for it. The refit sees every shard's windows:
    pass 0's assignments are gathered onto the first device and the
    refit runs there on the first ``plan_b`` rows, the rows the
    single-device refit reads; pass 1 runs sharded on its tables."""
    from traceweaver_tpu_torch.algorithms.weaver_torch import (
        ARG_ORDER,
        em_refit_tables,
        solve_windows,
        solve_windows_packed,
    )

    args = put_sharded({k: arrays[k] for k in ARG_ORDER}, mesh)

    def shard(s, tables=None):
        a = [args[k][s] for k in ARG_ORDER]
        if tables is not None:
            a[11:] = tables
        return a

    kw = dict(kw, plan_b=plan_b)
    if not em:
        return np.concatenate([solve_windows_packed(*shard(s), **kw).cpu().numpy()
                               for s in range(mesh.size)])
    assign0 = coalesce_to_device0(
        [solve_windows(*shard(s), **kw)[0] for s in range(mesh.size)], mesh)
    dev0 = mesh.devices[0]
    windows = [torch.as_tensor(arrays[k][:plan_b], device=dev0)
               for k in ("in_start", "in_end", "in_valid", "out_start", "out_end")]
    tables = em_refit_tables(assign0[:plan_b], *windows,
                             *(args[k][0] for k in REPLICATED))
    per_dev = {dev: tuple(t.to(dev) for t in tables) for dev in set(mesh.devices)}
    return np.concatenate([
        solve_windows_packed(*shard(s, per_dev[dev]), **kw).cpu().numpy()
        for s, dev in enumerate(mesh.devices)])


def em_step_sharded(arrays: Dict[str, np.ndarray], mesh: Mesh,
                    epsilon: float = 1.0, n_sinkhorn: int = 40):
    """One distributed EM step: sharded solve and the BIC-GMM M-step with
    its moment sums reduced over the shards.

    E-step: every shard solves its windows (hard assignments). M-step:
    each shard takes, for every edge of the three refit families (root
    ``(in -> e)``, DAG ``(p -> e)``, return ``(e -> in)``), its slice of
    that edge's delay samples, and
    :func:`~traceweaver_tpu_torch.ops.gmm.fit_gmm_sharded` fits the
    mixtures with every moment sum added over the shards on the first
    device, in shard order (the JAX package's ``psum``).

    Returns ``(assign, dists)``: assign ``[B, E, W]`` (numpy, the true
    batch) and ``dists`` mapping family to ``(w, mu, sd)`` numpy arrays:
    ``"in"``/``"ret"`` ``[E, K]`` each, ``"edge"`` ``[E, E, K]`` indexed
    ``[e, p]``."""
    from traceweaver_tpu_torch.algorithms.weaver_torch import (
        ARG_ORDER,
        em_family_samples,
        solve_windows,
    )
    from traceweaver_tpu_torch.ops.gmm import fit_gmm_sharded

    arrays, true_b = _pad_batch(arrays, mesh.size)
    args = put_sharded({k: arrays[k] for k in ARG_ORDER}, mesh)
    E = arrays["root_mask"].shape[0]
    K = arrays["in_wt"].shape[1]
    assigns, samples, masks = [], [], []
    for s in range(mesh.size):
        a = {k: args[k][s] for k in ARG_ORDER}
        assign = solve_windows(*(a[k] for k in ARG_ORDER), epsilon=epsilon,
                               n_sinkhorn=n_sinkhorn, plan_b=true_b)[0]
        smp, msk = em_family_samples(assign, a["in_start"], a["in_end"],
                                     a["in_valid"], a["out_start"], a["out_end"],
                                     a["pred_mask"], a["root_mask"])
        assigns.append(assign)
        samples.append(smp)
        masks.append(msk)
    w, mu, sd = (t.cpu().numpy() for t in fit_gmm_sharded(
        samples, masks, mesh.devices[0], max_k=K))

    def fam(lo, hi, shape):
        return (w[lo:hi].reshape(shape), mu[lo:hi].reshape(shape),
                sd[lo:hi].reshape(shape))

    dists = {
        "in": fam(0, E, (E, K)),
        "edge": fam(E, E + E * E, (E, E, K)),
        "ret": fam(E + E * E, E + E * E + E, (E, K)),
    }
    assign = np.concatenate([a.cpu().numpy() for a in assigns])[:true_b]
    return assign, dists

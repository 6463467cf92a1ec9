"""Differentiable sparse ops: the SpMM/SDDMM duality (DESIGN.md §9).

Counterpart of ``repro.core.autodiff``.  The backward pass of each sparse
operator is made of the sparse operators themselves:

  SpMM   C = A⟨vals⟩ @ B        dB    = Aᵀ @ G                (transpose SpMM)
                                 dVals = mask ⊙ SDDMM(G, B)
  SDDMM  S = mask ⊙ (Q Kᵀ)      dQ    = A⟨g⟩ @ K             (SpMM)
                                 dK    = Aᵀ⟨g⟩ @ Q            (transpose SpMM)

so a model that aggregates with the hand-written kernels runs the same
kernels backward, on Aᵀ for the transpose SpMMs.  :func:`ad_plan` builds,
on the host, everything these ops need about one pattern:

  * ``fwd``  — A as a :class:`BlockedMEBCRS` (the forward layout),
  * ``bwd``  — Aᵀ blocked (the transpose-SpMM layout; ``MEBCRS.transpose``
    is memoized on the canonical format),
  * ``perm`` — a gather map re-laying ``fwd``-layout values into ``bwd``
    layout (:meth:`ADPlan.transpose_vals`),
  * ``fwd_sched`` / ``bwd_sched`` — the block-parallel schedules of A and
    Aᵀ, present per direction: both for ``impl="cuda_balanced"`` and the
    sharded impls, the directions whose sweep chose the block-parallel
    kernel for ``impl="cuda_tuned"`` (scheduled independently: hub
    columns of A become hub windows of Aᵀ),
  * ``fwd_part`` / ``bwd_part`` / ``fwd_part_wa`` and ``mesh`` — for
    ``impl="cuda_sharded"`` and ``"cuda_sharded_overlap"``, each
    direction's schedule partitioned over the mesh's ``"data"`` dim
    (DESIGN.md §12): cuts inside hub windows allowed for the SpMMs and
    the SDDMM, window-aligned for the attention,

plus the tile parameters each direction runs with.  ``impl="cuda_tuned"``
resolves the autotuner when the plan is built (the forward SpMM, the
transpose SpMM and the SDDMM tuned apart, the SDDMM's ``k_blk`` pinned
to the forward layout), so a step never enters the tuner: each direction
runs the window-parallel kernel, or the block-parallel one when it has a
schedule, at its own ``k_blk`` and column tile.  :func:`spmm_ad`,
:func:`sddmm_ad` and :func:`attention_ad` are ``torch.autograd.Function``s
whose backward dispatches the duality through the registry; a cotangent
that no input needs launches nothing (``ctx.needs_input_grad``).  On a
sharded plan the forward, both duality ops (dB on Aᵀ over ``bwd_part``,
dVals over ``fwd_part``) and the attention's recompute each run one
rank-local launch and their collective inside the explicit backward
call, so autograd never differentiates a collective; every rank holds
the whole operands, outputs and gradients.
:func:`attention_ad` runs the single-pass kernel forward and recomputes
the scores backward (FlashAttention-style), so no score tensor is kept.

The precision axis (DESIGN.md §13): operands in bf16 run the kernels'
bf16 variants as they are (``precision=None``).  A plan built with
``precision="bf16"`` casts fp32 masters to bf16 at every op; one built
with ``"int8"`` quantizes the forward SpMM's values per K-block at each
call (B at bf16) and runs every other op, the backward included, at
bf16 (:func:`_dense_precision`).  Gradients are straight-through and come
back in the masters' dtypes.

Operands follow the batched convention: each may carry a leading head
dimension, a 2-D operand being shared by every head.  The ``cuda`` route
then runs the head-grid kernels (``cuda_batched``), one launch for all
heads; ``cuda_balanced`` and ``blocked`` take heads as they are.  The
gradient of a shared operand is the sum of its heads' gradients.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import dispatch as _dispatch
from .format import (MEBCRS, BlockedMEBCRS, Schedule, blocked_view,
                     resolve_device)
from .quantize import cast_precision, validate_precision
from .sddmm import with_values
from .spmm import apply_precision
from .softmax import sparse_softmax

__all__ = ["ADPlan", "ad_plan", "spmm_ad", "sddmm_ad", "attention_ad"]


@dataclasses.dataclass(frozen=True, eq=False)
class ADPlan:
    """Execution plan for the sparse ops on one sparse pattern."""

    fwd: BlockedMEBCRS    # A, forward layout
    bwd: BlockedMEBCRS    # Aᵀ, transpose-SpMM layout (vals = re-laid A vals)
    perm: torch.Tensor    # (NNZP_T, V) int32 flat indices into fwd-layout vals
    impl: str             # impl the tile parameters below were chosen for
    n_blk: int            # forward SpMM column tile
    n_blk_t: int          # transpose-SpMM (dB / dK) column tile
    # Block-parallel schedules of A and Aᵀ, present per direction: both
    # for impl="cuda_balanced", where the sweep chose the block-parallel
    # kernel for impl="cuda_tuned".
    fwd_sched: Schedule | None = None
    bwd_sched: Schedule | None = None
    # Precision level of every op on the plan (None: operand dtypes as
    # given); "int8" quantizes the forward SpMM's values, every other op
    # runs at bf16.
    precision: Optional[str] = None
    # Non-finite rescue (DESIGN.md §15), armed only at bf16/int8: the
    # forward SpMM re-runs at fp32 when its narrow output is not finite
    # and returns fp32 either way; the backward stays the straight-through
    # duality.
    guard_nonfinite: bool = False
    # Multi-device partitions (DESIGN.md §12) of the sharded impls over
    # the mesh's "data" dim: fwd_part / bwd_part may cut inside hub
    # windows (the reduce adds the partials), fwd_part_wa is the
    # window-aligned one the attention needs.
    fwd_part: Optional[object] = None   # a ShardedSchedule
    bwd_part: Optional[object] = None
    fwd_part_wa: Optional[object] = None
    mesh: Optional[object] = None       # torch DeviceMesh
    # Segment batches per rank of impl="cuda_sharded_overlap" (DESIGN.md
    # §14): the partitions carry this many and every call runs the ring
    # at that depth; 1 elsewhere.
    overlap_batches: int = 1

    @property
    def vals(self) -> torch.Tensor:
        return self.fwd.vals

    @property
    def mask(self) -> torch.Tensor:
        return self.fwd.mask

    @property
    def shape(self) -> Tuple[int, int]:
        return self.fwd.shape

    def transpose_vals(self, vals: torch.Tensor) -> torch.Tensor:
        """Re-lay ``fwd``-layout values ``([H,] NNZP, V)`` into ``bwd``
        layout, head by head.

        Pure gather: sources are mask-true ``fwd`` entries and padding
        targets are zeroed, so junk in masked-off positions never leaks.
        """
        lead = vals.shape[:-2]
        flat = vals.reshape(*lead, -1)[..., self.perm.reshape(-1).long()]
        return flat.reshape(*lead, *self.bwd.vals.shape) * self.bwd.mask


def _blocked_perm(blocked_a: BlockedMEBCRS,
                  blocked_t: BlockedMEBCRS) -> np.ndarray:
    """Gather map: ``perm[t', r']`` = flat index into ``blocked_a`` vals of
    the matrix element stored at ``blocked_t`` entry (t', r'); 0 where the
    target entry is padding/masked-off (zeroed by the mask multiply)."""
    v = blocked_a.vector_size
    _, k = blocked_a.shape

    mask_a = blocked_a.mask.cpu().numpy()
    ta, ra = np.nonzero(mask_a)
    rows_a = blocked_a.block_win.cpu().numpy()[ta // blocked_a.k_blk] * v + ra
    key_a = rows_a.astype(np.int64) * k + blocked_a.cols.cpu().numpy()[ta]
    order = np.argsort(key_a)
    key_sorted = key_a[order]
    flat_sorted = (ta * v + ra)[order]

    mask_t = blocked_t.mask.cpu().numpy()
    tt, rt = np.nonzero(mask_t)
    rows_t = blocked_t.block_win.cpu().numpy()[tt // blocked_t.k_blk] * v + rt
    # entry (rows_t, cols_t) of Aᵀ is element (cols_t, rows_t) of A
    key_t = blocked_t.cols.cpu().numpy()[tt].astype(np.int64) * k + rows_t
    pos = np.searchsorted(key_sorted, key_t)
    if not (pos.size == 0 or np.array_equal(key_sorted[pos], key_t)):
        raise AssertionError("transpose layouts disagree on the sparsity "
                             "pattern (corrupt format?)")
    perm = np.zeros(mask_t.shape, np.int32)
    perm[tt, rt] = flat_sorted[pos]
    return perm


_PLAN_IMPLS = ("blocked", "cuda", "cuda_balanced", "cuda_tuned",
               "cuda_sharded", "cuda_sharded_overlap")
_SHARDED = ("cuda_sharded", "cuda_sharded_overlap")


def _dense_precision(precision: Optional[str]) -> Optional[str]:
    """The precision of every op but the forward SpMM's values: int8
    applies only there (per-K-block scales); its gradient path, SDDMM and
    attention run bf16, straight-through to the masters."""
    return "bf16" if precision == "int8" else precision


# Where a plan's impl does not run an op itself: op -> (the impl for
# one head, the impl for operands with a leading head dimension).  The
# window-parallel ``cuda`` kernels take one head, so heads go to their
# head-grid versions; its attention is the fused kernel, which takes both.
# A ``cuda_tuned`` plan runs a direction with a schedule on
# ``cuda_balanced`` (:func:`_exec_impl`) and one without on these.
_WINDOW_ROUTES = {"spmm": ("cuda", "cuda_batched"),
                  "sddmm": ("cuda", "cuda_batched"),
                  "attention": ("cuda_fused_attn", "cuda_fused_attn")}
_ROUTES = {"cuda": _WINDOW_ROUTES, "cuda_tuned": _WINDOW_ROUTES}


def _routes(op: str, impl: str) -> tuple:
    """``(one head, heads)``: the impls that run ``op`` on a plan of
    ``impl`` (:data:`_ROUTES`, else ``impl`` itself)."""
    return _ROUTES.get(impl, {}).get(op, (impl, impl))


def _exec_impl(impl: str, sched: Schedule | None) -> str:
    """The impl a direction of a plan of ``impl`` runs: a tuned plan fixed
    its route per direction when it was built, the block-parallel kernels
    where that direction has a schedule, else the window-parallel ones."""
    if impl == "cuda_tuned":
        return "cuda" if sched is None else "cuda_balanced"
    return impl


def ad_plan(fmt: MEBCRS, *, impl: str = "blocked", k_blk: int = 8,
            n_blk: int = 128, split_blk: int = 1, n_example: int = 64,
            cache=None, device=None, mesh=None,
            overlap_batches: Optional[int] = None,
            precision: Optional[str] = None,
            guard_nonfinite: bool = False) -> ADPlan:
    """Build (and memoize on ``fmt``) the plan, on ``device`` (the card
    unless ``device`` says otherwise).

    Host-side precompute, like ``block_format``; the plans of one pattern
    share its blocked views (:func:`~repro_torch.core.format.blocked_view`).
    ``impl`` is ``"blocked"`` (plain PyTorch), ``"cuda"`` (the
    window-parallel kernels; attention runs ``"cuda_fused_attn"``),
    ``"cuda_balanced"`` (the block-parallel
    kernels over a :class:`Schedule` of A and one of Aᵀ, each cut into
    segments of at most ``split_blk`` K-blocks; 0 is the unsplit schedule)
    or ``"cuda_tuned"``: the autotuner (``kernels/autotune.py``, its
    ``cache``, by default the port's cache file) picks ``(k_blk, n_blk,
    split_blk)`` for A and for Aᵀ apart, timing dummies of ``n_example``
    feature columns in the format's dtype on ``device``, and the SDDMM's
    sweep is pinned to A's ``k_blk`` (dVals land in the forward layout).
    ``n_blk`` is the column tile of the forward SpMM and of the transpose
    SpMM (``n_blk_t``), which only the tuner sets apart.
    ``impl="cuda_sharded"`` partitions the schedules of A and Aᵀ over
    ``mesh``'s ``"data"`` dim (``mesh`` or the ambient
    :func:`~repro_torch.distributed.ctx.activation_mesh`; a
    ``DeviceMesh`` on ``device``'s type), so the forward and both duality
    ops run one rank-local launch per rank and an ``all_reduce``;
    ``"cuda_sharded_overlap"`` cuts each rank's range into
    ``overlap_batches`` segment batches (default 2) and runs the
    send/recv ring instead.  ``mesh=`` on a single-device impl and
    ``overlap_batches != 1`` on any impl but the overlapped one raise.
    The reference's
    ``f_blk`` has no counterpart: the port's SDDMM kernels walk the whole
    feature dimension in one pass.  ``precision``
    (``None``, ``"fp32"``, ``"bf16"``, ``"int8"``) fixes the level of every
    op on the plan and is checked against the ``precisions`` of every impl
    the plan's ops run (:data:`_ROUTES`: on ``cuda`` the head grids and
    the fused attention too), so a combination a kernel lacks fails
    before a step runs; plans of one pattern at several levels share
    their arrays.

    ``guard_nonfinite=True`` arms the non-finite rescue on a bf16 or int8
    plan: each forward SpMM reads whether its output is finite (one host
    sync) and, when it is not, re-runs at fp32, with the warning, log
    entry and counter of :func:`~repro_torch.core.dispatch.rescue_nonfinite`;
    the guarded forward returns fp32.  The
    flag is dropped on fp32 and ``None`` plans, as the reference's.
    """
    device = resolve_device(device)
    validate_precision(precision)
    if guard_nonfinite and precision in ("bf16", "int8"):
        return dataclasses.replace(
            ad_plan(fmt, impl=impl, k_blk=k_blk, n_blk=n_blk,
                    split_blk=split_blk, n_example=n_example, cache=cache,
                    device=device, mesh=mesh,
                    overlap_batches=overlap_batches, precision=precision),
            guard_nonfinite=True)
    if precision is not None:
        ops = ("spmm", "sddmm") + (("attention",) if impl in _PLAN_IMPLS
                                   else ())
        for op in ops:
            # a tuned plan's block-parallel directions run cuda_balanced
            names = _routes(op, impl) + (
                ("cuda_balanced",) if impl == "cuda_tuned" else ())
            for name in dict.fromkeys(names):
                _dispatch.require(op, name, precision=(
                    precision if op == "spmm"
                    else _dense_precision(precision)))
    if impl not in _PLAN_IMPLS:
        raise NotImplementedError(
            f"ad_plan(impl={impl!r}): the port builds plans for "
            f"{', '.join(map(repr, _PLAN_IMPLS))}")
    if isinstance(fmt, BlockedMEBCRS):
        raise ValueError("ad_plan needs the canonical MEBCRS (it blocks "
                         "both A and its transpose itself)")
    entry = _dispatch.get("spmm", impl)
    if overlap_batches is None:
        overlap_batches = 2 if entry.overlapped else 1
    elif not entry.overlapped and overlap_batches != 1:
        raise ValueError(
            f"ad_plan(overlap_batches={overlap_batches}) needs an "
            f"overlapped impl (got impl={impl!r}); only "
            f"'cuda_sharded_overlap' pipelines segment batches")
    if entry.multi_device:
        from repro_torch.distributed.ctx import _resolve_mesh

        mesh = _resolve_mesh(mesh)
        if mesh.device_type != device.type:
            raise ValueError(f"ad_plan: the mesh is on "
                             f"{mesh.device_type!r}, the plan on "
                             f"{device.type!r}")
    elif mesh is not None:
        raise ValueError(
            f"ad_plan(mesh=...) is only meaningful for a multi-device "
            f"impl like 'cuda_sharded' (got impl={impl!r}); dropping "
            f"the mesh would silently run single-device")
    key = (impl, k_blk, n_blk, int(split_blk), str(device), mesh,
           int(overlap_batches))
    memo = getattr(fmt, "_ad_plans", None)
    if memo is None:
        memo = {}
        object.__setattr__(fmt, "_ad_plans", memo)
    if impl == "cuda_tuned":
        # the winners depend on the example width, the cache file and the
        # precision the sweep is pinned to
        key += (int(n_example), getattr(cache, "path", None), precision)
        if key not in memo:
            memo[key] = _tuned_plan(fmt, n_example, cache, device, precision)
        return memo[key]
    if precision is not None:
        if key + (precision,) not in memo:
            base = ad_plan(fmt, impl=impl, k_blk=k_blk, n_blk=n_blk,
                           split_blk=split_blk, device=device, mesh=mesh,
                           overlap_batches=overlap_batches)
            memo[key + (precision,)] = dataclasses.replace(
                base, precision=precision)
        return memo[key + (precision,)]
    if key in memo:
        return memo[key]

    blocked_f = blocked_view(fmt, k_blk, device)
    blocked_t = blocked_view(fmt.transpose(), k_blk, device)
    perm = torch.from_numpy(_blocked_perm(blocked_f, blocked_t))
    scheds = {}
    if impl == "cuda_balanced" or impl in _SHARDED:
        scheds = {"fwd_sched": blocked_f.schedule(split_blk),
                  "bwd_sched": blocked_t.schedule(split_blk)}
    if impl in _SHARDED:
        scheds.update(_partitions(blocked_f, blocked_t, mesh, split_blk,
                                  n_blk, overlap_batches))
    plan = ADPlan(fwd=blocked_f, bwd=blocked_t, perm=perm.to(device),
                  impl=impl, n_blk=n_blk, n_blk_t=n_blk, **scheds)
    memo[key] = plan
    return plan


def _partitions(blocked_f: BlockedMEBCRS, blocked_t: BlockedMEBCRS, mesh,
                split_blk: int, n_blk: int, n_batches: int) -> dict:
    """A sharded plan's partitions over the mesh's data dim: A's and Aᵀ's
    with cuts inside hub windows allowed, and A's window-aligned one for
    the attention, each with ``n_batches`` segment batches per rank."""
    from repro_torch.distributed.sparse_shard import _axis, sharded_schedule

    ndev = _axis(mesh, "data")
    kw = dict(split_blk=split_blk, n_blk=n_blk, n_batches=n_batches)
    return {"fwd_part": sharded_schedule(blocked_f, ndev, **kw),
            "bwd_part": sharded_schedule(blocked_t, ndev, **kw),
            "fwd_part_wa": sharded_schedule(blocked_f, ndev,
                                            window_split=False, **kw),
            "mesh": mesh, "overlap_batches": n_batches}


def _tuned_plan(fmt: MEBCRS, n_example: int, cache, device,
                precision: Optional[str]) -> ADPlan:
    """The ``cuda_tuned`` plan: A and Aᵀ each blocked at the ``k_blk`` its
    sweep picked, with its column tile and, where the sweep chose the
    block-parallel kernel, its schedule; the sweeps pinned to the plan's
    precision (the SDDMM's to its dense level), as the reference's."""
    from repro_torch.kernels import autotune

    fmt_t = fmt.transpose()
    m, k = fmt.shape
    dt = fmt.values.dtype
    b_ex = torch.zeros((k, n_example), dtype=dt, device=device)
    g_ex = torch.zeros((m, n_example), dtype=dt, device=device)
    pk = {} if precision is None else {"precisions": (precision,)}
    pk_d = ({} if precision is None
            else {"precisions": (_dense_precision(precision),)})
    cfg_f = autotune.tune_spmm(fmt, b_ex, cache=cache, **pk)
    cfg_t = autotune.tune_spmm(fmt_t, g_ex, cache=cache, **pk)
    # dVals must land in the forward value layout: pin the SDDMM's k_blk
    autotune.tune_sddmm(fmt, g_ex, b_ex, k_blks=(cfg_f.k_blk,), cache=cache,
                        **pk_d)
    blocked_f = blocked_view(fmt, cfg_f.k_blk, device)
    blocked_t = blocked_view(fmt_t, cfg_t.k_blk, device)
    perm = torch.from_numpy(_blocked_perm(blocked_f, blocked_t))
    return ADPlan(
        fwd=blocked_f, bwd=blocked_t, perm=perm.to(device),
        impl="cuda_tuned", n_blk=cfg_f.n_blk, n_blk_t=cfg_t.n_blk,
        fwd_sched=(blocked_f.schedule(cfg_f.split_blk)
                   if cfg_f.split_blk else None),
        bwd_sched=(blocked_t.schedule(cfg_t.split_blk)
                   if cfg_t.split_blk else None),
        precision=precision)


def forward_only(name: str, **tensors) -> None:
    """Raise if an input needs a gradient.  The one home of the rule: the
    kernel wrappers call it, and the bare-format route reaches them
    without a plan; only the autograd Functions below call them with
    gradients off."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors.values()):
        raise RuntimeError(
            f"{name} is forward-only: an input requires grad.  Train "
            "through an ADPlan (spmm_ad, sddmm_ad, attention_ad run the "
            "kernels backward), or call it under torch.inference_mode() "
            "or torch.no_grad()")


# ---------------------------------------------------------------------------
# Direction routing: every op of the duality through the registry.
# ---------------------------------------------------------------------------


def _head_impl(op: str, impl: str, *operands) -> str:
    """The impl that runs ``op`` on a plan of ``impl`` on these operands
    (:func:`_routes`); the one that takes a leading head dimension, in
    one launch for every head, must be flagged ``batched``."""
    one, heads = _routes(op, impl)
    if not any(t.dim() == 3 for t in operands):
        return one
    _dispatch.require(op, heads, batched=True)
    return heads


def _run_spmm(impl: str, plan: ADPlan, vals, b, *, transposed: bool,
              precision: Optional[str] = None):
    """``A⟨vals⟩ @ B`` (or ``Aᵀ⟨vals⟩ @ B`` on ``plan.bwd``) at
    ``precision``; ``vals`` are already masked and in that direction's
    layout."""
    blocked = plan.bwd if transposed else plan.fwd
    sched = plan.bwd_sched if transposed else plan.fwd_sched
    impl = _exec_impl(impl, sched)
    kwargs = {"k_blk": blocked.k_blk,
              "n_blk": plan.n_blk_t if transposed else plan.n_blk}
    if impl == "cuda_balanced":
        # this direction's own schedule: Aᵀ's skew differs from A's
        kwargs["schedule"] = sched
    elif impl in _SHARDED:
        # this direction's own partition: dB runs on Aᵀ's
        kwargs.update(schedule=sched, mesh=plan.mesh,
                      part=plan.bwd_part if transposed else plan.fwd_part)
    name = _head_impl("spmm", impl, vals, b)
    _dispatch.require("spmm", name, precision=precision)
    blocked, b = apply_precision(with_values(blocked, vals.contiguous()), b,
                                 precision)
    return _dispatch.dispatch("spmm", name, blocked, b.contiguous(), **kwargs)


def _run_sddmm(impl: str, plan: ADPlan, q, k,
               precision: Optional[str] = None):
    """``mask ⊙ (Q Kᵀ)`` in the forward layout at ``precision`` (SDDMM
    samples A's pattern, so it walks the forward schedule)."""
    kwargs = {"k_blk": plan.fwd.k_blk}
    impl = _exec_impl(impl, plan.fwd_sched)
    if impl == "cuda_balanced":
        kwargs["schedule"] = plan.fwd_sched
    elif impl in _SHARDED:
        kwargs.update(schedule=plan.fwd_sched, mesh=plan.mesh,
                      part=plan.fwd_part)
    name = _head_impl("sddmm", impl, q, k)
    precision = _dense_precision(precision)
    _dispatch.require("sddmm", name, precision=precision)
    q, k = cast_precision(precision, q, k)
    return _dispatch.dispatch("sddmm", name, plan.fwd, q.contiguous(),
                              k.contiguous(), **kwargs)


def _sum_heads(grad, operand):
    """The gradient of ``operand`` from per-head gradients: a shared (2-D)
    operand's is the sum over the heads."""
    if grad is not None and grad.dim() > operand.dim():
        return grad.sum(dim=0)
    return grad


def _as(grad, operand):
    """A gradient in its operand's (master) dtype."""
    return None if grad is None else grad.to(operand.dtype)


def _spmm_vjp(impl: str, plan: ADPlan, vals, b, g, need_vals: bool,
              need_b: bool):
    """``(dVals, dB)`` of ``C = A⟨vals⟩ @ B`` for the cotangent ``g``, at
    the plan's dense precision (never quantized) and in the operands'
    dtypes; a gradient nobody needs is ``None`` and launches nothing."""
    prec = _dense_precision(plan.precision)
    dvals = db = None
    if need_b:      # dB = Aᵀ G — transpose SpMM through the registry
        db = _run_spmm(impl, plan, plan.transpose_vals(vals * plan.fwd.mask),
                       g, transposed=True, precision=prec)
    if need_vals:   # dVals = mask ⊙ SDDMM(G, B) (the kernels mask)
        dvals = _run_sddmm(impl, plan, g, b, precision=prec)
    return _as(_sum_heads(dvals, vals), vals), _as(_sum_heads(db, b), b)


class _SpmmAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, impl, plan, vals, b):
        ctx.impl, ctx.plan = impl, plan
        ctx.save_for_backward(vals, b)
        # masked entries are structural zeros
        vals_m = vals * plan.fwd.mask
        out = _run_spmm(impl, plan, vals_m, b, transposed=False,
                        precision=plan.precision)
        if not plan.guard_nonfinite:
            return out
        return _dispatch.rescue_nonfinite(
            "spmm", impl, plan.precision, out,
            lambda: _run_spmm(impl, plan, vals_m, b, transposed=False,
                              precision="fp32"))

    @staticmethod
    def backward(ctx, g):
        vals, b = ctx.saved_tensors
        dvals, db = _spmm_vjp(ctx.impl, ctx.plan, vals, b, g,
                              ctx.needs_input_grad[2], ctx.needs_input_grad[3])
        return None, None, dvals, db


class _SddmmAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, impl, plan, q, k):
        ctx.impl, ctx.plan = impl, plan
        ctx.save_for_backward(q, k)
        return _run_sddmm(impl, plan, q, k, precision=plan.precision)

    @staticmethod
    def backward(ctx, g):
        q, k = ctx.saved_tensors
        impl, plan = ctx.impl, ctx.plan
        prec = _dense_precision(plan.precision)  # never quantize cotangents
        gm = g * plan.fwd.mask
        dq = dk = None
        if ctx.needs_input_grad[2]:     # dQ = A⟨g⟩ @ K
            dq = _run_spmm(impl, plan, gm, k, transposed=False,
                           precision=prec)
        if ctx.needs_input_grad[3]:     # dK = Aᵀ⟨g⟩ @ Q
            dk = _run_spmm(impl, plan, plan.transpose_vals(gm), q,
                           transposed=True, precision=prec)
        return (None, None, _as(_sum_heads(dq, q), q),
                _as(_sum_heads(dk, k), k))


def _attention_kernel(impl: str, plan: ADPlan, q, k, v, scale):
    """The single-pass kernel of ``impl`` at the plan's precision:
    window-parallel for ``cuda``, over the forward schedule for
    ``cuda_balanced`` (and ``cuda_tuned`` where A's sweep chose it), over
    the window-aligned partition for the sharded impls."""
    impl = _exec_impl(impl, plan.fwd_sched)
    extra = {"schedule": plan.fwd_sched} if impl == "cuda_balanced" else {}
    if impl in _SHARDED:
        extra = {"schedule": plan.fwd_sched, "mesh": plan.mesh,
                 "part": plan.fwd_part_wa}
    name = _head_impl("attention", impl, q, k, v)
    _dispatch.require("attention", name, precision=plan.precision)
    q, k, v = cast_precision(plan.precision, q, k, v)
    return _dispatch.dispatch("attention", name, plan.fwd, q, k, v,
                              scale=scale, k_blk=plan.fwd.k_blk, **extra)


def _softmax_probs(impl: str, plan: ADPlan, q, k, scale):
    """The staged composition's scores → probabilities, differentiable.
    The scaled scores take the type the reference promotes bf16 scores
    times an fp32 scale to (fp32)."""
    scores = _SddmmAD.apply(impl, plan, q, k)
    scores = scores.to(torch.promote_types(scores.dtype, scale.dtype))
    return sparse_softmax(plan.fwd, scores * scale)


class _AttentionAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, impl, plan, q, k, v, scale):
        ctx.impl, ctx.plan = impl, plan
        ctx.save_for_backward(q, k, v, scale)
        return _attention_kernel(impl, plan, q.contiguous(), k.contiguous(),
                                 v.contiguous(), scale)

    @staticmethod
    def backward(ctx, g):
        # FlashAttention-style recompute: the scores and probabilities are
        # re-derived through the staged composition (its backward is the
        # dispatched duality), so the forward kernel keeps no residual.
        # The forward SpMM of the composition is not re-run: only its
        # vjp is needed.
        q, k, v, scale = ctx.saved_tensors
        impl, plan = ctx.impl, ctx.plan
        need_q, need_k, need_v, need_s = ctx.needs_input_grad[2:6]
        need_p = need_q or need_k or need_s
        leaves = [t.detach().requires_grad_(n)
                  for t, n in ((q, need_q), (k, need_k), (scale, need_s))]
        with torch.enable_grad():
            probs = _softmax_probs(impl, plan, *leaves)
        dprobs, dv = _spmm_vjp(impl, plan, probs.detach().to(v.dtype), v, g,
                               need_p, need_v)
        grads = [None, None, None]
        if need_p:
            wanted = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad(probs, wanted,
                                           dprobs.to(probs.dtype)))
            grads = [next(got) if t.requires_grad else None for t in leaves]
        dq, dk, dscale = grads
        return None, None, dq, dk, dv, dscale


def spmm_ad(plan: ADPlan, vals: torch.Tensor, b: torch.Tensor, *,
            impl: str | None = None) -> torch.Tensor:
    """Differentiable SpMM ``C = A⟨vals⟩ @ B`` on ``plan``'s pattern.

    ``vals``: (NNZP, V) forward-layout values; ``b``: (K, N); either may
    carry a leading head dimension H, and then the result is (H, M, N).
    Gradients flow to both: dVals through the masked SDDMM, dB through the
    transpose SpMM on ``plan.bwd``, each dispatched through the registry.
    Masked-off and padding ``vals`` entries are structural zeros.
    """
    impl = impl or plan.impl
    _dispatch.require("spmm", impl, differentiable=True)
    return _SpmmAD.apply(impl, plan, vals, b)


def sddmm_ad(plan: ADPlan, q: torch.Tensor, k: torch.Tensor, *,
             impl: str | None = None) -> torch.Tensor:
    """Differentiable SDDMM → forward-layout values (NNZP, V) of ``plan``.

    ``q``: (M, F); ``k``: (Mc, F); either may carry a leading head
    dimension H, and then the result is (H, NNZP, V).  Always a bare value
    array in the plan's layout, so SDDMM → sparse softmax → SpMM compose
    without re-blocking.  Backward: dQ = A⟨g⟩ K and dK = Aᵀ⟨g⟩ Q, two
    dispatched SpMMs.
    """
    impl = impl or plan.impl
    _dispatch.require("sddmm", impl, differentiable=True)
    return _SddmmAD.apply(impl, plan, q, k)


def attention_ad(plan: ADPlan, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, *, scale=None,
                 impl: str | None = None) -> torch.Tensor:
    """Differentiable block-sparse attention on ``plan``'s pattern.

    ``q (M, F)``, ``k (Mc, F)``, ``v (Mc, FV)``, each optionally with a
    leading head dimension H (any mix of per-head and shared operands);
    ``scale`` (default ``1/sqrt(F)``) is one scalar for every head and may
    be a 0-d tensor such as AGNN's learned β, and then receives a
    gradient.  ``impl="cuda"`` runs the single-pass kernel
    (``"cuda_fused_attn"``) and ``"cuda_balanced"`` its block-parallel
    version over the forward schedule, ``"cuda_tuned"`` the one its plan
    chose for A, the sharded impls the block-parallel one per rank over
    the window-aligned partition; all keep the scores out of device
    memory and recompute them backward.  ``"blocked"`` runs the staged
    SDDMM → sparse softmax → SpMM composition.  Attention has no int8
    level: an int8 plan runs all of it, the recompute backward included,
    at bf16.
    """
    impl = impl or plan.impl
    _dispatch.require("spmm", impl, differentiable=True)
    _dispatch.require("sddmm", impl, differentiable=True)
    if plan.precision == "int8":
        plan = dataclasses.replace(plan, precision="bf16")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scale = torch.as_tensor(scale, dtype=torch.float32, device=q.device)
    if impl in ("cuda", "cuda_balanced", "cuda_tuned") + _SHARDED:
        return _AttentionAD.apply(impl, plan, q, k, v, scale)
    probs = _softmax_probs(impl, plan, q, k, scale)
    return _SpmmAD.apply(impl, plan, probs.to(v.dtype), v)

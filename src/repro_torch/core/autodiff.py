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
    Aᵀ for ``impl="cuda_balanced"`` (scheduled independently: hub columns
    of A become hub windows of Aᵀ),

plus the tile parameters each direction runs with.  :func:`spmm_ad`,
:func:`sddmm_ad` and :func:`attention_ad` are ``torch.autograd.Function``s
whose backward dispatches the duality through the registry; a cotangent
that no input needs launches nothing (``ctx.needs_input_grad``).
:func:`attention_ad` runs the single-pass kernel forward and recomputes
the scores backward (FlashAttention-style), so no score tensor is kept.

Operands are 2-D; the leading-head (3-D) path is ROADMAP.md queue 1
item 8.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from . import dispatch as _dispatch
from .format import (MEBCRS, BlockedMEBCRS, Schedule, block_format,
                     resolve_device)
from .sddmm import with_values
from .softmax import sparse_softmax

__all__ = ["ADPlan", "ad_plan", "spmm_ad", "sddmm_ad", "attention_ad"]


@dataclasses.dataclass(frozen=True, eq=False)
class ADPlan:
    """Execution plan for the sparse ops on one sparse pattern."""

    fwd: BlockedMEBCRS    # A, forward layout
    bwd: BlockedMEBCRS    # Aᵀ, transpose-SpMM layout (vals = re-laid A vals)
    perm: torch.Tensor    # (NNZP_T, V) int32 flat indices into fwd-layout vals
    impl: str             # impl the tile parameters below were chosen for
    n_blk: int            # SpMM column tile, both directions
    # Block-parallel schedules of A and Aᵀ (impl="cuda_balanced").
    fwd_sched: Schedule | None = None
    bwd_sched: Schedule | None = None

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
        """Re-lay ``fwd``-layout values (NNZP, V) into ``bwd`` layout.

        Pure gather: sources are mask-true ``fwd`` entries and padding
        targets are zeroed, so junk in masked-off positions never leaks.
        """
        flat = vals.reshape(-1)[self.perm.reshape(-1).long()]
        return flat.reshape(self.bwd.vals.shape) * self.bwd.mask


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


_PLAN_IMPLS = ("blocked", "cuda", "cuda_balanced")


def ad_plan(fmt: MEBCRS, *, impl: str = "blocked", k_blk: int = 8,
            n_blk: int = 128, split_blk: int = 1, device=None) -> ADPlan:
    """Build (and memoize on ``fmt``) the plan, on ``device`` (the card
    unless ``device`` says otherwise).

    Host-side precompute, like ``block_format``.  ``impl`` is ``"blocked"``
    (plain PyTorch), ``"cuda"`` (the window-parallel kernels; attention
    runs ``"cuda_fused_attn"``) or ``"cuda_balanced"`` (the block-parallel
    kernels over a :class:`Schedule` of A and one of Aᵀ, each cut into
    segments of at most ``split_blk`` K-blocks; 0 is the unsplit schedule).
    ``n_blk`` is the column tile of the SpMM kernels in both directions;
    the JAX plan's separate transpose tile waits for the tuner (ROADMAP.md
    queue 1 item 11).  Its ``f_blk`` has no counterpart: the port's SDDMM
    kernels walk the whole feature dimension in one pass.
    """
    device = resolve_device(device)
    if impl not in _PLAN_IMPLS:
        raise NotImplementedError(
            f"ad_plan(impl={impl!r}): the port builds plans for "
            f"{', '.join(map(repr, _PLAN_IMPLS))}; tuned and sharded plans "
            "are ROADMAP.md queue 1 items 11 and 15")
    if isinstance(fmt, BlockedMEBCRS):
        raise ValueError("ad_plan needs the canonical MEBCRS (it blocks "
                         "both A and its transpose itself)")
    key = (impl, k_blk, n_blk, int(split_blk), str(device))
    memo = getattr(fmt, "_ad_plans", None)
    if memo is None:
        memo = {}
        object.__setattr__(fmt, "_ad_plans", memo)
    if key in memo:
        return memo[key]

    blocked_f = block_format(fmt, k_blk, device="cpu")
    blocked_t = block_format(fmt.transpose(), k_blk, device="cpu")
    perm = torch.from_numpy(_blocked_perm(blocked_f, blocked_t))
    scheds = {}
    if impl == "cuda_balanced":
        scheds = {"fwd_sched": blocked_f.schedule(split_blk).to(device),
                  "bwd_sched": blocked_t.schedule(split_blk).to(device)}
    plan = ADPlan(fwd=blocked_f.to(device), bwd=blocked_t.to(device),
                  perm=perm.to(device), impl=impl, n_blk=n_blk, **scheds)
    memo[key] = plan
    return plan


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


def _two_d(name: str, *tensors) -> None:
    if any(t.dim() != 2 for t in tensors):
        raise NotImplementedError(
            f"{name}: operands with a leading head dimension wait for the "
            "batched head grids (ROADMAP.md queue 1 item 8); pass 2-D "
            "operands")


# ---------------------------------------------------------------------------
# Direction routing: every op of the duality through the registry.
# ---------------------------------------------------------------------------


def _run_spmm(impl: str, plan: ADPlan, vals, b, *, transposed: bool):
    """``A⟨vals⟩ @ B`` (or ``Aᵀ⟨vals⟩ @ B`` on ``plan.bwd``); ``vals`` are
    already masked and in that direction's layout."""
    blocked = plan.bwd if transposed else plan.fwd
    kwargs = {"k_blk": blocked.k_blk, "n_blk": plan.n_blk}
    if impl == "cuda_balanced":
        # this direction's own schedule: Aᵀ's skew differs from A's
        kwargs["schedule"] = plan.bwd_sched if transposed else plan.fwd_sched
    return _dispatch.dispatch("spmm", impl, with_values(blocked, vals),
                              b.contiguous(), **kwargs)


def _run_sddmm(impl: str, plan: ADPlan, q, k):
    """``mask ⊙ (Q Kᵀ)`` in the forward layout (SDDMM samples A's
    pattern, so it walks the forward schedule)."""
    kwargs = {"k_blk": plan.fwd.k_blk}
    if impl == "cuda_balanced":
        kwargs["schedule"] = plan.fwd_sched
    return _dispatch.dispatch("sddmm", impl, plan.fwd, q.contiguous(),
                              k.contiguous(), **kwargs)


def _spmm_vjp(impl: str, plan: ADPlan, vals, b, g, need_vals: bool,
              need_b: bool):
    """``(dVals, dB)`` of ``C = A⟨vals⟩ @ B`` for the cotangent ``g``; a
    gradient nobody needs is ``None`` and launches nothing."""
    dvals = db = None
    if need_b:      # dB = Aᵀ G — transpose SpMM through the registry
        db = _run_spmm(impl, plan, plan.transpose_vals(vals * plan.fwd.mask),
                       g, transposed=True)
    if need_vals:   # dVals = mask ⊙ SDDMM(G, B) (the kernels mask)
        dvals = _run_sddmm(impl, plan, g, b)
    return dvals, db


class _SpmmAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, impl, plan, vals, b):
        ctx.impl, ctx.plan = impl, plan
        ctx.save_for_backward(vals, b)
        # masked entries are structural zeros
        return _run_spmm(impl, plan, vals * plan.fwd.mask, b,
                         transposed=False)

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
        return _run_sddmm(impl, plan, q, k)

    @staticmethod
    def backward(ctx, g):
        q, k = ctx.saved_tensors
        impl, plan = ctx.impl, ctx.plan
        gm = g * plan.fwd.mask
        dq = dk = None
        if ctx.needs_input_grad[2]:     # dQ = A⟨g⟩ @ K
            dq = _run_spmm(impl, plan, gm, k, transposed=False)
        if ctx.needs_input_grad[3]:     # dK = Aᵀ⟨g⟩ @ Q
            dk = _run_spmm(impl, plan, plan.transpose_vals(gm), q,
                           transposed=True)
        return None, None, dq, dk


def _attention_kernel(impl: str, plan: ADPlan, q, k, v, scale):
    """The single-pass kernel of ``impl``: window-parallel for ``cuda``,
    over the forward schedule for ``cuda_balanced``."""
    if impl == "cuda_balanced":
        return _dispatch.dispatch("attention", "cuda_balanced", plan.fwd, q,
                                  k, v, scale=scale, k_blk=plan.fwd.k_blk,
                                  schedule=plan.fwd_sched)
    return _dispatch.dispatch("attention", "cuda_fused_attn", plan.fwd, q, k,
                              v, scale=scale, k_blk=plan.fwd.k_blk)


def _softmax_probs(impl: str, plan: ADPlan, q, k, scale):
    """The staged composition's scores → probabilities, differentiable."""
    scores = _SddmmAD.apply(impl, plan, q, k)
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
            got = iter(torch.autograd.grad(probs, wanted, dprobs))
            grads = [next(got) if t.requires_grad else None for t in leaves]
        dq, dk, dscale = grads
        return None, None, dq, dk, dv, dscale


def spmm_ad(plan: ADPlan, vals: torch.Tensor, b: torch.Tensor, *,
            impl: str | None = None) -> torch.Tensor:
    """Differentiable SpMM ``C = A⟨vals⟩ @ B`` on ``plan``'s pattern.

    ``vals``: (NNZP, V) forward-layout values; ``b``: (K, N).  Gradients
    flow to both: dVals through the masked SDDMM, dB through the transpose
    SpMM on ``plan.bwd``, each dispatched through the registry.
    Masked-off and padding ``vals`` entries are structural zeros.
    """
    impl = impl or plan.impl
    _dispatch.require("spmm", impl, differentiable=True)
    _two_d("spmm_ad", vals, b)
    return _SpmmAD.apply(impl, plan, vals, b)


def sddmm_ad(plan: ADPlan, q: torch.Tensor, k: torch.Tensor, *,
             impl: str | None = None) -> torch.Tensor:
    """Differentiable SDDMM → forward-layout values (NNZP, V) of ``plan``.

    ``q``: (M, F); ``k``: (Mc, F).  Always a bare value array in the plan's
    layout, so SDDMM → sparse softmax → SpMM compose without re-blocking.
    Backward: dQ = A⟨g⟩ K and dK = Aᵀ⟨g⟩ Q, two dispatched SpMMs.
    """
    impl = impl or plan.impl
    _dispatch.require("sddmm", impl, differentiable=True)
    _two_d("sddmm_ad", q, k)
    return _SddmmAD.apply(impl, plan, q, k)


def attention_ad(plan: ADPlan, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, *, scale=None,
                 impl: str | None = None) -> torch.Tensor:
    """Differentiable block-sparse attention on ``plan``'s pattern.

    ``q (M, F)``, ``k (Mc, F)``, ``v (Mc, FV)``; ``scale`` (default
    ``1/sqrt(F)``) may be a 0-d tensor such as AGNN's learned β, and then
    receives a gradient.  ``impl="cuda"`` runs the single-pass kernel
    (``"cuda_fused_attn"``) and ``"cuda_balanced"`` its block-parallel
    version over the forward schedule; both keep the scores out of device
    memory and recompute them backward.  ``"blocked"`` runs the staged
    SDDMM → sparse softmax → SpMM composition.
    """
    impl = impl or plan.impl
    _dispatch.require("spmm", impl, differentiable=True)
    _dispatch.require("sddmm", impl, differentiable=True)
    _two_d("attention_ad", q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scale = torch.as_tensor(scale, dtype=torch.float32, device=q.device)
    if impl in ("cuda", "cuda_balanced"):
        return _AttentionAD.apply(impl, plan, q, k, v, scale)
    probs = _softmax_probs(impl, plan, q, k, scale)
    return _SpmmAD.apply(impl, plan, probs.to(v.dtype), v)

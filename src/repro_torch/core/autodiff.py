"""Sparse ops on an autodiff plan: ``ADPlan`` and the forward passes.

Counterpart of ``repro.core.autodiff``.  :func:`ad_plan` builds, on the
host, everything a differentiable sparse op needs about one pattern:

  * ``fwd``  — A as a :class:`BlockedMEBCRS` (the forward layout),
  * ``bwd``  — Aᵀ blocked (the transpose-SpMM layout of the backward
    duality; ``MEBCRS.transpose`` is memoized on the canonical format),
  * ``perm`` — a gather map re-laying ``fwd``-layout values into ``bwd``
    layout (:meth:`ADPlan.transpose_vals`),

plus the tile parameters each direction runs with.  :func:`spmm_ad`,
:func:`sddmm_ad` and :func:`attention_ad` run the forward passes through
the dispatch registry.  They are plain functions for now and raise if an
input needs a gradient: the duality backward (dB = AᵀG, dVals = masked
SDDMM) as ``torch.autograd.Function``s is ROADMAP.md queue 1 item 5.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from . import dispatch as _dispatch
from .format import MEBCRS, BlockedMEBCRS, block_format, resolve_device
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
    n_blk: int            # forward SpMM column tile
    n_blk_t: int          # transpose-SpMM (dB / dK) column tile
    f_blk: int            # SDDMM feature tile

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


_PLAN_IMPLS = ("blocked", "cuda")


def ad_plan(fmt: MEBCRS, *, impl: str = "blocked", k_blk: int = 8,
            n_blk: int = 128, f_blk: int = 128, device=None) -> ADPlan:
    """Build (and memoize on ``fmt``) the plan, on ``device`` (the card
    unless ``device`` says otherwise).

    Host-side precompute, like ``block_format``.  ``impl`` is ``"blocked"``
    (plain PyTorch) or ``"cuda"`` (the hand-written kernels; attention runs
    ``"cuda_fused_attn"``).  ``n_blk`` is the SpMM kernel's column tile.
    ``f_blk`` and the plan's ``n_blk_t`` mirror the JAX plan but change
    nothing yet: no port kernel tiles features, and the transpose SpMM
    waits for the backward port (ROADMAP.md queue 1 item 5).
    """
    device = resolve_device(device)
    if impl not in _PLAN_IMPLS:
        raise NotImplementedError(
            f"ad_plan(impl={impl!r}): the port builds plans for "
            f"{', '.join(map(repr, _PLAN_IMPLS))}; balanced, tuned and "
            "sharded plans are ROADMAP.md queue 1 items 9, 11 and 15")
    if isinstance(fmt, BlockedMEBCRS):
        raise ValueError("ad_plan needs the canonical MEBCRS (it blocks "
                         "both A and its transpose itself)")
    key = (impl, k_blk, n_blk, f_blk, str(device))
    memo = getattr(fmt, "_ad_plans", None)
    if memo is None:
        memo = {}
        object.__setattr__(fmt, "_ad_plans", memo)
    if key in memo:
        return memo[key]

    blocked_f = block_format(fmt, k_blk, device="cpu")
    blocked_t = block_format(fmt.transpose(), k_blk, device="cpu")
    perm = torch.from_numpy(_blocked_perm(blocked_f, blocked_t))
    plan = ADPlan(fwd=blocked_f.to(device), bwd=blocked_t.to(device),
                  perm=perm.to(device), impl=impl, n_blk=n_blk,
                  n_blk_t=n_blk, f_blk=f_blk)
    memo[key] = plan
    return plan


def forward_only(name: str, **tensors) -> None:
    """Raise if an input needs a gradient.  The one home of the rule: the
    ``*_ad`` functions and the kernel wrappers (which the bare-format
    route reaches without a plan) both call it."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors.values()):
        raise RuntimeError(
            f"{name} is forward-only: an input requires grad, and the "
            "autograd duality backward is ROADMAP.md queue 1 item 5; call "
            "it under torch.inference_mode() or torch.no_grad()")


def _spmm_fwd(impl: str, plan: ADPlan, vals, b):
    vals_m = vals * plan.fwd.mask  # masked entries are structural zeros
    return _dispatch.dispatch("spmm", impl, with_values(plan.fwd, vals_m), b,
                              k_blk=plan.fwd.k_blk, n_blk=plan.n_blk)


def _sddmm_fwd(impl: str, plan: ADPlan, q, k):
    return _dispatch.dispatch("sddmm", impl, plan.fwd, q, k,
                              k_blk=plan.fwd.k_blk, f_blk=plan.f_blk)


def spmm_ad(plan: ADPlan, vals: torch.Tensor, b: torch.Tensor, *,
            impl: str | None = None) -> torch.Tensor:
    """SpMM ``C = A⟨vals⟩ @ B`` on ``plan``'s pattern (forward).

    ``vals``: (NNZP, V) forward-layout values; ``b``: (K, N).  Masked-off
    and padding ``vals`` entries are structural zeros.
    """
    forward_only("spmm_ad", vals=vals, b=b)
    return _spmm_fwd(impl or plan.impl, plan, vals, b)


def sddmm_ad(plan: ADPlan, q: torch.Tensor, k: torch.Tensor, *,
             impl: str | None = None) -> torch.Tensor:
    """SDDMM → forward-layout values (NNZP, V) of ``plan`` (forward).

    ``q``: (M, F); ``k``: (Mc, F).  Always a bare value array in the plan's
    layout, so SDDMM → sparse softmax → SpMM compose without re-blocking.
    """
    forward_only("sddmm_ad", q=q, k=k)
    return _sddmm_fwd(impl or plan.impl, plan, q, k)


def attention_ad(plan: ADPlan, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, *, scale=None,
                 impl: str | None = None) -> torch.Tensor:
    """Block-sparse attention on ``plan``'s pattern (forward).

    ``q (M, F)``, ``k (Mc, F)``, ``v (Mc, FV)``; ``scale`` (default
    ``1/sqrt(F)``) may be a 0-d tensor such as AGNN's learned β.
    ``impl="cuda"`` runs the single-pass fused kernel
    (``"cuda_fused_attn"``), whose scores never reach device memory; the
    plain impl runs SDDMM → sparse softmax → SpMM.
    """
    impl = impl or plan.impl
    forward_only("attention_ad", q=q, k=k, v=v, scale=scale)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scale = torch.as_tensor(scale, dtype=torch.float32, device=q.device)
    if impl == "cuda":
        return _dispatch.dispatch("attention", "cuda_fused_attn", plan.fwd,
                                  q, k, v, scale=scale, k_blk=plan.fwd.k_blk)
    scores = _sddmm_fwd(impl, plan, q, k)
    probs = sparse_softmax(plan.fwd, scores * scale)
    return _spmm_fwd(impl, plan, probs.to(v.dtype), v)

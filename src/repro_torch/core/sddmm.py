"""SDDMM on ME-BCRS: C_sparse = mask ∘ (Q @ Kᵀ) sampled at A's pattern.

Counterpart of ``repro.core.sddmm``.  The result stays in the blocked
layout, values (NNZP, V) vector-major, so it feeds the following SpMM
through :func:`with_values` with no re-translation (the paper's "output
splitting for subsequent SpMM", §3.4, at format level).

Also the ``attention`` entry point (SDDMM → sparse softmax → SpMM) and
its plain ``blocked`` implementation.  ``precision=`` (``"fp32"`` or
``"bf16"``) casts the dense operands before the impl runs
(:func:`~repro_torch.core.quantize.cast_precision`); the impls accumulate
in fp32 and return Q's (SDDMM) or V's (attention) dtype.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import dispatch as _dispatch
from . import validate as _validate
from .format import BlockedMEBCRS, block_format, to_coo
from .quantize import cast_precision
from .softmax import sparse_softmax
from .spmm import _optional, _robust, _spmm_blocked_impl

__all__ = ["sddmm", "sddmm_blocked", "sddmm_dense_ref", "sddmm_coo",
           "attention", "with_values"]


def sddmm_dense_ref(a_mask_dense: torch.Tensor, q: torch.Tensor,
                    k: torch.Tensor) -> torch.Tensor:
    """Dense oracle: (Q @ Kᵀ) ∘ mask, full (M, Mc) output."""
    scores = q.float() @ k.float().T
    return (scores * (a_mask_dense != 0)).to(q.dtype)


def _sddmm_blocked_impl(blocked: BlockedMEBCRS, q: torch.Tensor,
                        k: torch.Tensor) -> torch.Tensor:
    q3 = q if q.dim() == 3 else q[None]
    k3 = k if k.dim() == 3 else k[None]
    h = max(q3.shape[0], k3.shape[0])
    v = blocked.vector_size
    nb = blocked.num_blocks
    w = blocked.num_windows
    f = q3.shape[-1]
    # Pad Q rows up to W*V (last window residue).
    qpad = torch.zeros((q3.shape[0], w * v, f), dtype=torch.float32,
                       device=q.device)
    qpad[:, : q3.shape[1]] = q3
    kg = k3.float()[:, blocked.cols.long()].reshape(k3.shape[0], nb,
                                                    blocked.k_blk, f)
    qg = qpad.reshape(q3.shape[0], w, v, f)[:, blocked.block_win.long()]
    # a shared operand (leading 1) broadcasts over the heads
    scores = torch.einsum("hbkf,hbvf->hbkv", kg.expand(h, -1, -1, -1),
                          qg.expand(h, -1, -1, -1)).reshape(h, -1, v)
    out = (scores * blocked.mask).to(q.dtype)
    return out if (q.dim() == 3 or k.dim() == 3) else out[0]


def sddmm_blocked(fmt, q: torch.Tensor, k: torch.Tensor,
                  k_blk: int = 8) -> torch.Tensor:
    """Plain-PyTorch SDDMM → values (NNZP, V) in the blocked view's layout.

    ``q`` may be ``(H, M, F)`` and ``k`` ``(H, Mc, F)``; a 2-D operand is
    shared by every head, and 2-D in gives 2-D out, else ``(H, NNZP, V)``.
    """
    blocked = (fmt if isinstance(fmt, BlockedMEBCRS)
               else block_format(fmt, k_blk, device=q.device))
    return _sddmm_blocked_impl(blocked, q, k)


def sddmm_coo(rows: torch.Tensor, cols: torch.Tensor, q: torch.Tensor,
              k: torch.Tensor) -> torch.Tensor:
    """Edge-wise SDDMM (CUDA-core-class baseline): e_ij = <Q_i, K_j>."""
    return (q[rows.long()] * k[cols.long()]).sum(-1)


def sddmm(fmt, q: torch.Tensor, k: torch.Tensor, impl: str = "blocked",
          k_blk: int = 8, f_blk: int | None = None,
          split_blk: int | None = None, schedule=None, mesh=None,
          part=None, n_batches: int | None = None,
          precision: str | None = None, check: str | None = None,
          strict: bool | None = None, guard_nonfinite: bool = False):
    """SDDMM dispatch through the registry → blocked-layout values.

    Compose with SpMM by rebinding the values (:func:`with_values`).
    ``split_blk``/``schedule`` go to the block-parallel ``cuda_balanced``
    kernel, ``mesh``/``part``/``n_batches`` to the multi-device
    ``cuda_sharded*`` impls; ``precision`` (``"fp32"``/``"bf16"``) casts
    Q and K first.
    The tuned impl (``cuda_tuned``, ``returns_format``) takes the
    canonical format and returns the blocked view at its tuned ``k_blk``
    with the scores bound as its values.  ``check``, ``strict`` and
    ``guard_nonfinite`` as in :func:`~repro_torch.core.spmm.spmm` (Q and
    K guarded).
    """
    _validate.guard_call(check, fmt, q=q, k=k)
    kwargs = _optional(f_blk=f_blk, split_blk=split_blk, schedule=schedule,
                       mesh=mesh, part=part, n_batches=n_batches)
    if strict is not None or guard_nonfinite:
        return _robust("sddmm", impl, (fmt, q, k),
                       dict(k_blk=k_blk, **kwargs), precision, strict,
                       guard_nonfinite)
    entry = _dispatch.require("sddmm", impl, precision=precision)
    if entry.needs_canonical:       # the impl applies the level itself
        kwargs.update(_optional(precision=precision))
    else:
        q, k = cast_precision(precision, q, k)
    return _dispatch.dispatch("sddmm", impl, fmt, q, k, k_blk=k_blk, **kwargs)


def attention(fmt, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              impl: str = "blocked", *, scale=None, k_blk: int = 8,
              split_blk: int | None = None, schedule=None, mesh=None,
              part=None, n_batches: int | None = None,
              n_blk: int | None = None, precision: str | None = None,
              check: str | None = None, strict: bool | None = None,
              guard_nonfinite: bool = False):
    """Sparse attention ``softmax_sparse(scale · mask ⊙ QKᵀ) @ V`` through
    the registry (``dispatch.impls("attention")``).  ``scale`` defaults to
    ``1/sqrt(F)`` and may be a 0-d tensor; ``split_blk``/``schedule`` go to
    the block-parallel ``cuda_balanced`` kernel, ``mesh``/``part``/
    ``n_batches`` to the multi-device ``cuda_sharded*`` impls (a
    window-aligned partition), ``n_blk`` to the SpMM of
    the three-pass ``cuda_staged``; ``precision`` (``"fp32"``/``"bf16"``)
    casts Q, K and V first.  ``"blocked"`` is the plain three-pass
    composition, the last rung of the fallback ladder.  ``check``,
    ``strict`` and ``guard_nonfinite`` as in
    :func:`~repro_torch.core.spmm.spmm` (Q, K and V guarded)."""
    _validate.guard_call(check, fmt, q=q, k=k, v=v)
    kwargs = _optional(scale=scale, split_blk=split_blk, schedule=schedule,
                       mesh=mesh, part=part, n_batches=n_batches, n_blk=n_blk)
    if strict is not None or guard_nonfinite:
        return _robust("attention", impl, (fmt, q, k, v),
                       dict(k_blk=k_blk, **kwargs), precision, strict,
                       guard_nonfinite)
    entry = _dispatch.require("attention", impl, precision=precision)
    if entry.needs_canonical:       # the impl applies the level itself
        kwargs.update(_optional(precision=precision))
    else:
        q, k, v = cast_precision(precision, q, k, v)
    return _dispatch.dispatch("attention", impl, fmt, q, k, v, k_blk=k_blk,
                              **kwargs)


def with_values(blocked: BlockedMEBCRS, new_vals: torch.Tensor) -> BlockedMEBCRS:
    """Rebind values (e.g. SDDMM output → SpMM input), keeping the pattern."""
    return dataclasses.replace(blocked, vals=new_vals)


def attention_staged(blocked: BlockedMEBCRS, q, k, v, scale=None):
    """Plain SDDMM → sparse softmax → plain SpMM: the sparse-attention
    function computed in three passes, scores through device memory.
    ``q``, ``k`` and ``v`` may each carry a leading head dimension (a 2-D
    operand is shared by every head); all 2-D in gives ``(M, DV)`` out."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = _sddmm_blocked_impl(blocked, q, k)
    probs = sparse_softmax(blocked, scores * scale)
    return _spmm_blocked_impl(with_values(blocked, probs.to(v.dtype)), v)


# ---------------------------------------------------------------------------
# Registry adapters: uniform (fmt_or_blocked, q, k, *, k_blk, f_blk).
# ---------------------------------------------------------------------------


def _sddmm_blocked_adapter(fmt, q, k, *, k_blk: int = 8,
                           f_blk: int | None = None):
    del f_blk  # no feature tiling in the plain path
    return sddmm_blocked(fmt, q, k, k_blk)


def _sddmm_coo_adapter(fmt, q, k, *, k_blk: int = 8, f_blk: int | None = None):
    """Edge-wise oracle via host-side COO conversion → (NNZ,) edge values."""
    del k_blk, f_blk
    rows, cols, _ = to_coo(fmt)
    return sddmm_coo(torch.from_numpy(rows).to(q.device),
                     torch.from_numpy(cols).to(q.device), q, k)


def _attention_blocked_adapter(fmt, q, k, v, *, scale=None, k_blk: int = 8):
    blocked = (fmt if isinstance(fmt, BlockedMEBCRS)
               else block_format(fmt, k_blk, device=q.device))
    return attention_staged(blocked, q, k, v, scale)


_dispatch.register("sddmm", "blocked", _sddmm_blocked_adapter,
                   differentiable=True, batched=True,
                   precisions=("fp32", "bf16"))
_dispatch.register("sddmm", "coo", _sddmm_coo_adapter)
_dispatch.register("attention", "blocked", _attention_blocked_adapter,
                   differentiable=True, batched=True,
                   precisions=("fp32", "bf16"))


def _dense_at_precision(args, precision: str, k_blk: int):
    """``(fmt, *dense)`` with the dense operands cast to ``precision``, as
    :func:`sddmm` and :func:`attention` cast them (the fallback ladder's
    hook)."""
    del k_blk  # the format is not touched
    return (args[0], *cast_precision(precision, *args[1:]))


_dispatch.register_precision("sddmm", _dense_at_precision)
_dispatch.register_precision("attention", _dense_at_precision)

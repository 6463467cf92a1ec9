"""SDDMM on ME-BCRS: C_sparse = mask ∘ (Q @ Kᵀ) sampled at A's pattern.

Counterpart of ``repro.core.sddmm``.  The result stays in the blocked
layout, values (NNZP, V) vector-major, so it feeds the following SpMM
through :func:`with_values` with no re-translation (the paper's "output
splitting for subsequent SpMM", §3.4, at format level).

Also the ``attention`` entry point (SDDMM → sparse softmax → SpMM) and
its plain ``blocked`` implementation.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import dispatch as _dispatch
from .format import BlockedMEBCRS, block_format, to_coo
from .softmax import sparse_softmax
from .spmm import _optional, _spmm_blocked_impl

__all__ = ["sddmm", "sddmm_blocked", "sddmm_dense_ref", "sddmm_coo",
           "attention", "with_values"]


def sddmm_dense_ref(a_mask_dense: torch.Tensor, q: torch.Tensor,
                    k: torch.Tensor) -> torch.Tensor:
    """Dense oracle: (Q @ Kᵀ) ∘ mask, full (M, Mc) output."""
    scores = q.float() @ k.float().T
    return (scores * (a_mask_dense != 0)).to(q.dtype)


def _sddmm_blocked_impl(blocked: BlockedMEBCRS, q: torch.Tensor,
                        k: torch.Tensor) -> torch.Tensor:
    v = blocked.vector_size
    nb = blocked.num_blocks
    w = blocked.num_windows
    # Pad Q rows up to W*V (last window residue).
    qpad = torch.zeros((w * v, q.shape[1]), dtype=torch.float32,
                       device=q.device)
    qpad[: q.shape[0]] = q
    kg = k.float()[blocked.cols.long()].reshape(nb, blocked.k_blk, -1)
    qg = qpad.reshape(w, v, -1)[blocked.block_win.long()]      # (NB, V, F)
    scores = torch.einsum("bkf,bvf->bkv", kg, qg).reshape(nb * blocked.k_blk, v)
    return (scores * blocked.mask).to(q.dtype)


def sddmm_blocked(fmt, q: torch.Tensor, k: torch.Tensor,
                  k_blk: int = 8) -> torch.Tensor:
    """Plain-PyTorch SDDMM → values (NNZP, V) in the blocked view's layout."""
    blocked = (fmt if isinstance(fmt, BlockedMEBCRS)
               else block_format(fmt, k_blk, device=q.device))
    return _sddmm_blocked_impl(blocked, q, k)


def sddmm_coo(rows: torch.Tensor, cols: torch.Tensor, q: torch.Tensor,
              k: torch.Tensor) -> torch.Tensor:
    """Edge-wise SDDMM (CUDA-core-class baseline): e_ij = <Q_i, K_j>."""
    return (q[rows.long()] * k[cols.long()]).sum(-1)


def sddmm(fmt, q: torch.Tensor, k: torch.Tensor, impl: str = "blocked",
          k_blk: int = 8, f_blk: int | None = None,
          split_blk: int | None = None, schedule=None):
    """SDDMM dispatch through the registry → blocked-layout values.

    Compose with SpMM by rebinding the values (:func:`with_values`).
    ``split_blk``/``schedule`` go to the block-parallel ``cuda_balanced``
    kernel.
    """
    return _dispatch.dispatch("sddmm", impl, fmt, q, k, k_blk=k_blk,
                              **_optional(f_blk=f_blk, split_blk=split_blk,
                                          schedule=schedule))


def attention(fmt, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              impl: str = "blocked", *, scale=None, k_blk: int = 8,
              split_blk: int | None = None, schedule=None):
    """Sparse attention ``softmax_sparse(scale · mask ⊙ QKᵀ) @ V`` through
    the registry (``dispatch.impls("attention")``).  ``scale`` defaults to
    ``1/sqrt(F)`` and may be a 0-d tensor; ``split_blk``/``schedule`` go to
    the block-parallel ``cuda_balanced`` kernel."""
    return _dispatch.dispatch("attention", impl, fmt, q, k, v, k_blk=k_blk,
                              **_optional(scale=scale, split_blk=split_blk,
                                          schedule=schedule))


def with_values(blocked: BlockedMEBCRS, new_vals: torch.Tensor) -> BlockedMEBCRS:
    """Rebind values (e.g. SDDMM output → SpMM input), keeping the pattern."""
    return dataclasses.replace(blocked, vals=new_vals)


def attention_staged(blocked: BlockedMEBCRS, q, k, v, scale=None):
    """Plain SDDMM → sparse softmax → plain SpMM: the sparse-attention
    function computed in three passes, scores through device memory."""
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
                   differentiable=True)
_dispatch.register("sddmm", "coo", _sddmm_coo_adapter)
_dispatch.register("attention", "blocked", _attention_blocked_adapter,
                   differentiable=True)

"""Element-wise oracles for the kernels (independent data flow).

Counterpart of ``repro.kernels.ref``.  These avoid the blocked-einsum
formulation of ``repro_torch.core``: they rebuild each contribution from
the blocked arrays vector by vector, so kernel, core impl and oracle are
three independent computations of the same result.  At every precision
they take the kernels' arithmetic: operands upcast to fp32 (int8 values
times their K-block's scale), products and sums in fp32, one cast to the
output dtype at the end.
"""

from __future__ import annotations

import torch

__all__ = ["spmm_ref", "sddmm_ref"]


def _win_of_vec(blocked) -> torch.Tensor:
    return blocked.block_win.long().repeat_interleave(blocked.k_blk)


def _values(blocked) -> torch.Tensor:
    """fp32 values of a blocked view: int8 values times their K-block's
    scale, anything else upcast."""
    vals = blocked.vals.float()
    if blocked.scales is not None and blocked.vals.dtype == torch.int8:
        vals = vals * blocked.scales.repeat_interleave(blocked.k_blk)[:, None]
    return vals


def spmm_ref(blocked, b_dense: torch.Tensor) -> torch.Tensor:
    """Oracle SpMM: per-vector outer products scatter-added into windows.
    ``vals`` and ``b_dense`` may carry a leading head dimension (a 2-D
    operand is shared by every head); 2-D in gives 2-D out, in B's
    dtype."""
    v = blocked.vector_size
    w = blocked.num_windows
    vals = _values(blocked)
    vals3 = vals if vals.dim() == 3 else vals[None]
    b3 = (b_dense if b_dense.dim() == 3 else b_dense[None]).float()
    bg = b3[:, blocked.cols.long()]                                 # (H, NNZP, N)
    contrib = vals3[..., None] * bg[:, :, None, :]                  # (H, NNZP, V, N)
    c_win = torch.zeros((contrib.shape[0], w) + contrib.shape[2:],
                        dtype=contrib.dtype, device=contrib.device)
    c_win.index_add_(1, _win_of_vec(blocked), contrib)
    out = c_win.reshape(c_win.shape[0], w * v, -1)[:, : blocked.shape[0]]
    out = out.to(b_dense.dtype)
    return out if (blocked.vals.dim() == 3 or b_dense.dim() == 3) else out[0]


def sddmm_ref(blocked, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Oracle SDDMM: per-vector dot products, masked.  ``q`` and ``k`` may
    carry a leading head dimension (a 2-D operand is shared by every
    head); 2-D in gives 2-D out."""
    v = blocked.vector_size
    w = blocked.num_windows
    q3 = (q if q.dim() == 3 else q[None]).float()
    k3 = (k if k.dim() == 3 else k[None]).float()
    qpad = torch.zeros((q3.shape[0], w * v, q3.shape[-1]),
                       device=q.device)
    qpad[:, : q3.shape[1]] = q3
    qwin = qpad.reshape(q3.shape[0], w, v, -1)[:, _win_of_vec(blocked)]
    kg = k3[:, blocked.cols.long()]                                 # (H, NNZP, F)
    scores = (qwin * kg[:, :, None, :]).sum(-1)                     # (H, NNZP, V)
    out = (scores * blocked.mask).to(q.dtype)
    return out if (q.dim() == 3 or k.dim() == 3) else out[0]

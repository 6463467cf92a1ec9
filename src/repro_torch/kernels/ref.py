"""Element-wise oracles for the kernels (independent data flow).

Counterpart of ``repro.kernels.ref``.  These avoid the blocked-einsum
formulation of ``repro_torch.core``: they rebuild each contribution from
the blocked arrays vector by vector, so kernel, core impl and oracle are
three independent computations of the same result.
"""

from __future__ import annotations

import torch

__all__ = ["spmm_ref", "sddmm_ref"]


def _win_of_vec(blocked) -> torch.Tensor:
    return blocked.block_win.long().repeat_interleave(blocked.k_blk)


def spmm_ref(blocked, b_dense: torch.Tensor) -> torch.Tensor:
    """Oracle SpMM: per-vector outer products scatter-added into windows."""
    v = blocked.vector_size
    w = blocked.num_windows
    bg = b_dense[blocked.cols.long()]                               # (NNZP, N)
    contrib = blocked.vals[:, :, None] * bg[:, None, :]             # (NNZP, V, N)
    c_win = torch.zeros((w,) + contrib.shape[1:], dtype=contrib.dtype,
                        device=contrib.device)
    c_win.index_add_(0, _win_of_vec(blocked), contrib)
    out = c_win.reshape(w * v, -1)[: blocked.shape[0]]
    return out.to(b_dense.dtype)


def sddmm_ref(blocked, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Oracle SDDMM: per-vector dot products, masked."""
    v = blocked.vector_size
    w = blocked.num_windows
    qpad = torch.zeros((w * v, q.shape[1]), dtype=q.dtype, device=q.device)
    qpad[: q.shape[0]] = q
    qwin = qpad.reshape(w, v, -1)[_win_of_vec(blocked)]             # (NNZP, V, F)
    kg = k[blocked.cols.long()]                                     # (NNZP, F)
    scores = (qwin * kg[:, None, :]).sum(-1)                        # (NNZP, V)
    return (scores * blocked.mask).to(q.dtype)

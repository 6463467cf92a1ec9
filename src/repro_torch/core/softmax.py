"""Row-wise sparse softmax over blocked ME-BCRS values.

Counterpart of ``repro.core.softmax``.  Attention GNNs (AGNN/GAT) run
SDDMM scores → per-row softmax → SpMM without leaving the blocked layout.
A sparse row (window w, lane r) is spread over all K-blocks of window w at
vector position r, so the reduction is a masked segment max/sum keyed by
``block_win``.  The JAX package computes it with XLA outside any Pallas
kernel, so plain PyTorch is its port.
"""

from __future__ import annotations

import torch

from .format import BlockedMEBCRS

__all__ = ["sparse_softmax"]


def sparse_softmax(blocked: BlockedMEBCRS, scores: torch.Tensor) -> torch.Tensor:
    """Numerically stable softmax per sparse row.

    ``scores``: (NNZP, V) blocked-layout values (e.g. SDDMM output).
    Returns probabilities in the same layout and dtype; masked and padding
    entries are 0, and rows without entries stay 0.
    """
    v = blocked.vector_size
    nb = blocked.num_blocks
    w = blocked.num_windows
    mask = blocked.mask
    bw = blocked.block_win.long()

    neg = torch.finfo(torch.float32).min
    s = torch.where(mask, scores.float(), neg).reshape(nb, blocked.k_blk, v)

    block_max = s.amax(dim=1)                                          # (NB, V)
    # Initial value ``neg`` keeps empty windows finite, as the reference's
    # ``maximum(segment_max, neg)`` does.
    row_max = torch.full((w, v), neg, device=s.device).scatter_reduce(
        0, bw[:, None].expand(-1, v), block_max, "amax")               # (W, V)
    e = torch.exp(s - row_max[bw][:, None, :])
    e = e * mask.reshape(nb, blocked.k_blk, v)
    row_sum = torch.zeros((w, v), device=s.device).index_add_(
        0, bw, e.sum(dim=1))                                           # (W, V)
    denom = torch.clamp(row_sum, min=1e-20)
    p = e / denom[bw][:, None, :]
    return p.reshape(nb * blocked.k_blk, v).to(scores.dtype)

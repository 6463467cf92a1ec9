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

    ``scores``: (NNZP, V) blocked-layout values (e.g. SDDMM output), or
    (H, NNZP, V) with a leading head dimension (per-head sparse attention),
    reduced per row per head in one pass.  Returns probabilities in the
    same layout and dtype; masked and padding entries are 0, and rows
    without entries stay 0.
    """
    v = blocked.vector_size
    nb = blocked.num_blocks
    w = blocked.num_windows
    k_blk = blocked.k_blk
    mask = blocked.mask.reshape(nb, k_blk, v)
    bw = blocked.block_win.long()
    s3 = scores if scores.dim() == 3 else scores[None]
    h = s3.shape[0]

    neg = torch.finfo(torch.float32).min
    s = torch.where(mask, s3.float().reshape(h, nb, k_blk, v), neg)

    # The row maximum only keeps exp() in range: the softmax does not
    # depend on it in exact arithmetic, so it is taken without a gradient
    # (which also avoids amax's tie rule in the backward).
    block_max = s.detach().amax(dim=2)                              # (H, NB, V)
    # Initial value ``neg`` keeps empty windows finite, as the reference's
    # ``maximum(segment_max, neg)`` does.
    row_max = torch.full((h, w, v), neg, device=s.device).scatter_reduce(
        1, bw[None, :, None].expand(h, -1, v), block_max, "amax")   # (H, W, V)
    e = torch.exp(s - row_max[:, bw, None, :]) * mask
    row_sum = torch.zeros((h, w, v), device=s.device).index_add_(
        1, bw, e.sum(dim=2))                                        # (H, W, V)
    denom = torch.clamp(row_sum, min=1e-20)
    p = (e / denom[:, bw, None, :]).reshape(h, nb * k_blk, v).to(scores.dtype)
    return p if scores.dim() == 3 else p[0]

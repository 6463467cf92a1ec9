"""Load-balanced SpMM kernel: ``spmm_balanced_cuda``
(``csrc/spmm_balanced.cu``) and its plain version.

Counterpart of ``repro.kernels.spmm_pallas.spmm_pallas_balanced``, which
launches ``_balanced_spmm_kernel``: the work of a blocked view mapped onto
a :class:`~repro_torch.core.format.Schedule`'s segments of at most
``split_blk`` K-blocks, so a hub window no longer serialises the grid.
``spmm_balanced_cuda`` launches the hand-written kernel on CUDA tensors
and counts each launch in ``spmm_balanced_cuda.launches``; on CPU tensors
it runs :func:`spmm_balanced_plain`, which sums each segment, then each
window's segments in segment order, as the kernel does.

Operands follow the batched convention of the reference: ``vals`` may be
``(NNZP, V)`` or ``(H, NNZP, V)`` and ``b`` ``(K, N)`` or ``(H, K, N)``;
a 2-D operand is shared by every head, and 2-D in gives 2-D out.
"""

from __future__ import annotations

import torch

from repro_torch.core.format import BlockedMEBCRS, Schedule

from . import _build, _checks
from ._combine import combine_tree

__all__ = ["spmm_balanced_cuda", "spmm_balanced_plain", "segment_blocks"]


def segment_blocks(schedule: Schedule) -> tuple:
    """``(blk, blk_seg)``: the scheduled K-blocks in segment order and the
    segment of each, as int64 tensors on the schedule's device."""
    meta = schedule.seg_meta.long()
    length = meta[:, 1]
    blk_seg = torch.repeat_interleave(
        torch.arange(schedule.num_segments, device=meta.device), length)
    start = torch.cumsum(length, 0) - length
    rank = torch.arange(blk_seg.shape[0], device=meta.device) - start[blk_seg]
    return meta[blk_seg, 0] + rank, blk_seg


def _block_rows(blk: torch.Tensor, k_blk: int) -> torch.Tensor:
    return (blk[:, None] * k_blk
            + torch.arange(k_blk, device=blk.device)).reshape(-1)


def spmm_balanced_plain(blocked: BlockedMEBCRS, b: torch.Tensor,
                        schedule: Schedule) -> torch.Tensor:
    """Plain PyTorch version of the kernel: per-segment fp32 sums of the
    scheduled blocks' contractions, then each window's segments summed in
    fp64."""
    vals3 = blocked.vals if blocked.vals.dim() == 3 else blocked.vals[None]
    b3 = b if b.dim() == 3 else b[None]
    h = max(vals3.shape[0], b3.shape[0])
    v, k_blk, w = blocked.vector_size, blocked.k_blk, blocked.num_windows
    n = b3.shape[-1]
    blk, blk_seg = segment_blocks(schedule)
    rows = _block_rows(blk, k_blk)
    nsb = blk.shape[0]
    vg = vals3.float()[:, rows].reshape(
        vals3.shape[0], nsb, k_blk, v).expand(h, -1, -1, -1)
    bg = b3.float()[:, blocked.cols.long()[rows]].reshape(
        b3.shape[0], nsb, k_blk, n).expand(h, -1, -1, -1)
    contrib = torch.einsum("hbkv,hbkn->hbvn", vg, bg)
    seg = torch.zeros((h, schedule.num_segments, v, n), dtype=torch.float32,
                      device=b.device).index_add_(1, blk_seg, contrib)
    # the window sums over segments in fp64, as the kernel's combine pass
    win = torch.zeros((h, w, v, n), dtype=torch.float64,
                      device=b.device).index_add_(1, schedule.seg_win.long(),
                                                  seg.double())
    out = win.reshape(h, w * v, n)[:, : blocked.shape[0]].to(b.dtype)
    return out if (blocked.vals.dim() == 3 or b.dim() == 3) else out[0]


def spmm_balanced_cuda(blocked: BlockedMEBCRS, b: torch.Tensor, *,
                       schedule: Schedule | None = None, split_blk: int = 1,
                       n_blk: int = 128) -> torch.Tensor:
    """``C = A @ B`` over ``blocked`` in fp32, block-parallel over
    ``schedule`` (built from ``blocked`` with ``split_blk`` when omitted);
    ``n_blk`` is the column tile (threads per block, a multiple of 32 up
    to 1024)."""
    op = "spmm_balanced_cuda"
    if schedule is None:
        schedule = blocked.schedule(split_blk)
    _checks.forward_inputs(op, vals=blocked.vals, b=b)
    h, batched = _checks.heads(op, vals=(blocked.vals, 2), b=(b, 2))
    if _checks.on_cpu(op, seg_win=schedule.seg_win,
                      seg_meta=schedule.seg_meta, cols=blocked.cols,
                      vals=blocked.vals, b=b):
        return spmm_balanced_plain(blocked, b, schedule)
    tree = combine_tree(op, schedule, blocked.num_windows)
    _checks.kernel_inputs(
        op, {"seg_win": schedule.seg_win, "seg_meta": schedule.seg_meta,
             "tree_meta": tree.meta, "cols": blocked.cols},
        {"vals": blocked.vals, "b": b})
    m, k = blocked.shape
    v = blocked.vector_size
    ns = schedule.num_segments
    if v not in (8, 16):
        raise ValueError(f"{op}: vector_size {v} not in (8, 16)")
    if b.shape[-2] != k:
        raise ValueError(f"{op}: b must be ([H,] {k}, N), got {tuple(b.shape)}")
    if not (n_blk % 32 == 0 and 32 <= n_blk <= 1024):
        raise ValueError(f"{op}: n_blk={n_blk} must be a multiple of 32 in "
                         "[32, 1024]")
    n = b.shape[-1]
    n_tile = min(n_blk, max(32, -(-n // 32) * 32))
    if (max(m, n, ns) > _checks.int32_max or -(-n // n_tile) > 65535
            or h > 65535):
        raise ValueError(f"{op}: shape too large for the kernel's grid")
    c = torch.empty((h, m, n), dtype=torch.float32, device=b.device)
    if m == 0 or n == 0:
        return c if batched else c[0]
    # Scratch of the combine tree: the segments' fp32 partials and the fp64
    # entries of its upper levels (none when no window is split).
    part = part2 = None
    if tree.splits_windows:
        part = torch.empty((h, ns, v, n), dtype=torch.float32,
                           device=b.device)
    if tree.entries:
        part2 = torch.empty((h, tree.entries, v, n), dtype=torch.float64,
                            device=b.device)
    err = _build.library("spmm_balanced").spmm_balanced_f32(
        schedule.seg_win.data_ptr(), schedule.seg_meta.data_ptr(),
        tree.meta.data_ptr(), blocked.cols.data_ptr(),
        blocked.vals.data_ptr(), b.data_ptr(), c.data_ptr(),
        None if part is None else part.data_ptr(),
        None if part2 is None else part2.data_ptr(), m, n, ns, h, v,
        blocked.k_blk, n_tile, _checks.head_stride(blocked.vals, 2),
        _checks.head_stride(b, 2), _build.host_ints(tree.level_ints()),
        len(tree.levels), tree.entries,
        torch.cuda.current_stream(b.device).cuda_stream)
    _build.check_launch("spmm_balanced", err)
    spmm_balanced_cuda.launches += 1
    return c if batched else c[0]


spmm_balanced_cuda.launches = 0

"""Load-balanced SpMM kernel: ``spmm_balanced_cuda``
(``csrc/spmm_balanced.cu``) and its plain version.

Counterpart of ``repro.kernels.spmm_pallas.spmm_pallas_balanced``, which
launches ``_balanced_spmm_kernel``: the work of a blocked view mapped onto
a :class:`~repro_torch.core.format.Schedule`'s segments of at most
``split_blk`` K-blocks, so a hub window no longer serialises the grid.
The kernel carries each window's sum across the segments of a run (a
:class:`~repro_torch.kernels._combine.RunPlan` of about ``RUN_BLK``
K-blocks) and leaves partials only at run edges.
``spmm_balanced_cuda`` launches the hand-written kernel on CUDA tensors
and counts each launch in ``spmm_balanced_cuda.launches``; on CPU tensors
it runs :func:`spmm_balanced_plain`, which sums each (run, window) piece
in fp64 from fp32 block products, rounds it to fp32 as the kernel's
partial, and then sums each window's pieces in fp64, as the kernel does.

Operands follow the batched convention of the reference: ``vals`` may be
``(NNZP, V)`` or ``(H, NNZP, V)`` and ``b`` ``(K, N)`` or ``(H, K, N)``;
a 2-D operand is shared by every head, and 2-D in gives 2-D out.

The kernel's variants are ``spmm_cuda``'s (:data:`~repro_torch.kernels.
spmm_cuda.VARIANTS`): fp32, bf16, or int8 values (shared by every head)
with the view's per-K-block scales and fp32 or bf16 B.  Every operand is
widened to fp32 as it is read and the sums are those of the fp32 kernel,
so C is that kernel's result on the widened (int8: ``q · scale``)
operands, rounded once to B's dtype;
``spmm_balanced_cuda.variant_launches`` counts each variant's launches.
"""

from __future__ import annotations

import torch

from repro_torch.core.format import BlockedMEBCRS, Schedule
from repro_torch.core.spmm import dequantized

from . import _build, _checks
from ._combine import RunPlan, run_plan
from .spmm_cuda import _variant_inputs

__all__ = ["RUN_BLK", "piece_blocks", "spmm_balanced_cuda",
           "spmm_balanced_plain"]

# K-blocks per run of the kernel (chip_smoke.py phase 5 sweeps it).
RUN_BLK = 32
MAX_TILE = 256  # threads per block: the kernel's __launch_bounds__


def piece_blocks(plan: RunPlan) -> tuple:
    """``(blk, blk_piece)``: the scheduled K-blocks in run order and the
    piece of each, as int64 tensors on the plan's device."""
    pieces = plan.pieces.long()
    length = pieces[:, 2]
    blk_piece = torch.repeat_interleave(
        torch.arange(pieces.shape[0], device=pieces.device), length)
    start = torch.cumsum(length, 0) - length
    rank = (torch.arange(blk_piece.shape[0], device=pieces.device)
            - start[blk_piece])
    return pieces[blk_piece, 1] + rank, blk_piece


def _block_rows(blk: torch.Tensor, k_blk: int) -> torch.Tensor:
    return (blk[:, None] * k_blk
            + torch.arange(k_blk, device=blk.device)).reshape(-1)


def spmm_balanced_plain(blocked: BlockedMEBCRS, b: torch.Tensor,
                        schedule: Schedule,
                        run_blk: int = RUN_BLK) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the scheduled blocks' fp32
    contractions (int8 values dequantized, narrow operands widened) summed
    per (run, window) piece in fp64 and rounded to fp32 (the kernel folds
    fp32 sums of at most 32 products into fp64 and writes an fp32
    partial), then each window's pieces summed in fp64, rounded to fp32
    and then to B's dtype."""
    blocked = dequantized(blocked)
    vals3 = blocked.vals if blocked.vals.dim() == 3 else blocked.vals[None]
    b3 = b if b.dim() == 3 else b[None]
    h = max(vals3.shape[0], b3.shape[0])
    v, k_blk, w = blocked.vector_size, blocked.k_blk, blocked.num_windows
    n = b3.shape[-1]
    plan = run_plan("spmm_balanced_plain", schedule, w, run_blk)
    blk, blk_piece = piece_blocks(plan)
    rows = _block_rows(blk, k_blk)
    nsb = blk.shape[0]
    vg = vals3.float()[:, rows].reshape(
        vals3.shape[0], nsb, k_blk, v).expand(h, -1, -1, -1)
    bg = b3.float()[:, blocked.cols.long()[rows]].reshape(
        b3.shape[0], nsb, k_blk, n).expand(h, -1, -1, -1)
    contrib = torch.einsum("hbkv,hbkn->hbvn", vg, bg)
    piece = torch.zeros((h, plan.num_pieces, v, n), dtype=torch.float64,
                        device=b.device).index_add_(1, blk_piece,
                                                    contrib.double()).float()
    # the window sums over pieces in fp64, as the kernel's combine tree
    win = torch.zeros((h, w, v, n), dtype=torch.float64,
                      device=b.device).index_add_(
        1, plan.pieces[:, 0].long(), piece.double())
    out = win.reshape(h, w * v, n)[:, : blocked.shape[0]].float().to(b.dtype)
    return out if (blocked.vals.dim() == 3 or b.dim() == 3) else out[0]


def spmm_balanced_cuda(blocked: BlockedMEBCRS, b: torch.Tensor, *,
                       schedule: Schedule | None = None, split_blk: int = 1,
                       n_blk: int = 128,
                       run_blk: int = RUN_BLK) -> torch.Tensor:
    """``C = A @ B`` over ``blocked`` (the variants of ``spmm_cuda``), C in
    B's dtype, block-parallel over ``schedule`` (built from ``blocked``
    with ``split_blk`` when omitted) in runs of about ``run_blk``
    K-blocks; ``n_blk`` is the column tile (threads per block, a multiple
    of 32 up to 256).  Over a rank-local schedule C is the rank's
    partial: its windows' rows, zeros elsewhere."""
    op = "spmm_balanced_cuda"
    if schedule is None:
        schedule = blocked.schedule(split_blk)
    scales = _variant_inputs(op, blocked, b)
    h, batched = _checks.heads(op, vals=(blocked.vals, 2), b=(b, 2))
    m, k = blocked.shape
    v = _checks.vector_size(op, blocked)
    if b.shape[-2] != k:
        raise ValueError(f"{op}: b must be ([H,] {k}, N), got {tuple(b.shape)}")
    _checks.column_tile(op, n_blk, MAX_TILE)
    # raises when the schedule is another view's (memoized on it)
    plan = run_plan(op, schedule, blocked.num_windows, run_blk)
    _checks.schedule_owner(op, schedule, blocked)
    n = b.shape[-1]
    n_tile = min(n_blk, max(32, -(-n // 32) * 32))
    if (max(m, n, plan.num_runs) > _checks.int32_max
            or -(-n // n_tile) > 65535 or h > 65535):
        raise ValueError(f"{op}: shape too large for the kernel's grid")
    tensors = dict(seg_win=schedule.seg_win, seg_meta=schedule.seg_meta,
                   cols=blocked.cols, vals=blocked.vals, b=b)
    if scales is not None:
        tensors["scales"] = scales
    if _checks.on_cpu(op, **tensors):
        return spmm_balanced_plain(blocked, b, schedule, run_blk)
    tree = plan.tree
    _checks.kernel_inputs(
        op, {"run_ptr": plan.run_ptr, "pieces": plan.pieces,
             "tree_meta": tree.meta, "cols": blocked.cols},
        {k_: t for k_, t in tensors.items()
         if k_ in ("vals", "b", "scales")})
    loc = schedule.local
    if loc is not None and plan.num_runs == 0:   # a store-only rank
        c = torch.zeros((h, m, n), dtype=b.dtype, device=b.device)
        return c if batched else c[0]
    c = torch.empty((h, m, n), dtype=b.dtype, device=b.device)
    if m == 0 or n == 0:
        return c if batched else c[0]
    if loc is not None:
        _checks.zero_outside(c, loc.win_lo * v, loc.win_hi * v)
    # Scratch of the combine tree: the run edges' fp32 partials and the
    # fp64 entries of its upper levels (none when no run cuts a window).
    part = part2 = None
    if plan.entries:
        part = torch.empty((h, plan.entries, v, n), dtype=torch.float32,
                           device=b.device)
    if tree.entries:
        part2 = torch.empty((h, tree.entries, v, n), dtype=torch.float64,
                            device=b.device)
    err = _build.library("spmm_balanced").spmm_balanced_launch(
        plan.run_ptr.data_ptr(), plan.pieces.data_ptr(),
        tree.meta.data_ptr(), blocked.cols.data_ptr(),
        blocked.vals.data_ptr(), None if scales is None else scales.data_ptr(),
        b.data_ptr(), c.data_ptr(),
        None if part is None else part.data_ptr(),
        None if part2 is None else part2.data_ptr(), m, n, plan.num_runs, h,
        v, blocked.k_blk, n_tile, _checks.head_stride(blocked.vals, 2),
        _checks.head_stride(b, 2), _build.host_ints(tree.level_ints()),
        len(tree.levels), plan.entries, tree.entries,
        _checks.dtype_code(blocked.vals), _checks.dtype_code(b),
        torch.cuda.current_stream(b.device).cuda_stream)
    _build.check_launch("spmm_balanced", err)
    spmm_balanced_cuda.launches += 1
    spmm_balanced_cuda.variant_launches[_checks.variant(blocked.vals)] += 1
    return c if batched else c[0]


spmm_balanced_cuda.launches = 0
spmm_balanced_cuda.variant_launches = {"fp32": 0, "bf16": 0, "int8": 0}

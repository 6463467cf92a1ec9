"""SpMM kernel: ``spmm_cuda`` (``csrc/spmm.cu``) and its plain version.

Counterpart of ``repro.kernels.spmm_pallas.spmm_pallas``, which launches
``_fused_spmm_kernel``.  ``spmm_cuda`` launches the hand-written kernel on
CUDA tensors and counts each launch in ``spmm_cuda.launches``; on CPU
tensors it runs :func:`spmm_plain`, the gather-einsum-``index_add_`` of
``core.spmm.spmm_blocked``.  Windows of more than ``SPLIT_BLK`` K-blocks
are cut into slices over the groups of a block or of a thread-block
cluster by a window plan (``kernels/_window.py``).
"""

from __future__ import annotations

import torch

from repro_torch.core.format import BlockedMEBCRS
from repro_torch.core.spmm import _spmm_blocked_impl

from . import _build, _checks
from ._window import MAX_THREADS, SPLIT_BLK, window_plan

__all__ = ["spmm_cuda", "spmm_plain"]


def spmm_plain(blocked: BlockedMEBCRS, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``C (M, N) = A @ B``."""
    return _spmm_blocked_impl(blocked, b)


def spmm_cuda(blocked: BlockedMEBCRS, b: torch.Tensor, *,
              n_blk: int = 128) -> torch.Tensor:
    """``C (M, N) = A @ B`` over ``blocked`` in fp32; ``n_blk`` is the
    column tile (threads per slice group, a multiple of 32 up to 512), and
    windows of more than ``SPLIT_BLK`` K-blocks are split."""
    op = "spmm_cuda"
    _checks.forward_inputs(op, vals=blocked.vals, b=b)
    tensors = dict(win_ptr=blocked.win_ptr, cols=blocked.cols,
                   vals=blocked.vals, b=b)
    if _checks.on_cpu(op, **tensors):
        return spmm_plain(blocked, b)
    _checks.kernel_inputs(op, {"win_ptr": blocked.win_ptr, "cols": blocked.cols},
                          {"vals": blocked.vals, "b": b})
    m, k = blocked.shape
    v = blocked.vector_size
    if v not in (8, 16):
        raise ValueError(f"{op}: vector_size {v} not in (8, 16)")
    if b.dim() != 2 or b.shape[0] != k:
        raise ValueError(f"{op}: b must be ({k}, N), got {tuple(b.shape)}")
    if not (n_blk % 32 == 0 and 32 <= n_blk <= MAX_THREADS):
        raise ValueError(f"{op}: n_blk={n_blk} must be a multiple of 32 in "
                         f"[32, {MAX_THREADS}]")
    n = b.shape[1]
    n_tile = min(n_blk, max(32, -(-n // 32) * 32))
    # one head's B (K x N) and vals (NNZP x V) are indexed in 32 bits
    if (max(m, n, k * n, blocked.vals.shape[-2] * v) > _checks.int32_max
            or -(-n // n_tile) > 65535):
        raise ValueError(f"{op}: shape too large for the kernel's grid")
    c = torch.empty((m, n), dtype=torch.float32, device=b.device)
    if m == 0 or n == 0:
        return c
    plan = window_plan(op, blocked.win_ptr, SPLIT_BLK, n_tile)
    err = _build.library("spmm").spmm_f32(
        blocked.win_ptr.data_ptr(), blocked.cols.data_ptr(),
        blocked.vals.data_ptr(), b.data_ptr(), c.data_ptr(),
        plan.split_ids.data_ptr(), m, n, plan.num_windows, v, blocked.k_blk,
        n_tile, plan.groups, plan.cluster, plan.split_blk, plan.num_long,
        plan.num_medium, torch.cuda.current_stream(b.device).cuda_stream)
    _build.check_launch("spmm", err)
    spmm_cuda.launches += 1
    return c


spmm_cuda.launches = 0

"""Staged-gather SpMM kernel: ``spmm_staged_cuda`` (``csrc/spmm_staged.cu``)
and its plain version.

Counterpart of ``repro.kernels.spmm_pallas.spmm_pallas_staged``, which
launches ``_staged_spmm_kernel``: the pre-fusion baseline that gathers
``B[cols]`` into an ``(NNZP, N)`` buffer in device memory, runs a
block-indexed grid over it, and zeroes the windows no K-block visits in a
post-pass (``_zero_unvisited``).  The gather and the post-pass are plain
PyTorch, as in the reference they are XLA outside the kernel.
``spmm_staged_cuda`` launches the kernel on CUDA tensors and counts each
launch in ``spmm_staged_cuda.launches``; on CPU tensors it runs
:func:`spmm_staged_plain`.  Operands are 2-D and fp32 (the precision axis
is ROADMAP.md queue 1 item 10).
"""

from __future__ import annotations

import torch

from repro_torch.core.format import BlockedMEBCRS
from repro_torch.core.spmm import _spmm_blocked_impl

from . import _build, _checks

__all__ = ["spmm_staged_cuda", "spmm_staged_plain", "zero_unvisited"]


def spmm_staged_plain(blocked: BlockedMEBCRS, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``C (M, N) = A @ B`` from the
    gathered rows, unvisited windows zero."""
    return _spmm_blocked_impl(blocked, b)


def zero_unvisited(out: torch.Tensor, blocked: BlockedMEBCRS) -> torch.Tensor:
    """The reference's ``_zero_unvisited``: rows of windows that no K-block
    belongs to are never written by the block-indexed grid; zero them
    (a ``where``, so whatever the allocation held, NaN included, goes)."""
    visited = torch.zeros(blocked.num_windows, dtype=torch.bool,
                          device=out.device)
    visited[blocked.block_win.long()] = True
    rows = visited.repeat_interleave(blocked.vector_size)[: out.shape[0]]
    return torch.where(rows[:, None], out, 0.0)


def spmm_staged_cuda(blocked: BlockedMEBCRS, b: torch.Tensor, *,
                     n_blk: int = 128) -> torch.Tensor:
    """``C (M, N) = A @ B`` over ``blocked`` in fp32 through a staged
    ``B[cols]`` gather; ``n_blk`` is the column tile (threads per block, a
    multiple of 32 up to 1024)."""
    op = "spmm_staged_cuda"
    _checks.forward_inputs(op, vals=blocked.vals, b=b)
    m, k = blocked.shape
    if blocked.vals.dim() != 2 or b.dim() != 2 or b.shape[0] != k:
        raise ValueError(f"{op}: need vals (NNZP, V) and b ({k}, N), got "
                         f"{tuple(blocked.vals.shape)} and {tuple(b.shape)}")
    if _checks.on_cpu(op, block_win=blocked.block_win, cols=blocked.cols,
                      vals=blocked.vals, b=b):
        return spmm_staged_plain(blocked, b)
    _checks.kernel_inputs(op, {"block_win": blocked.block_win,
                               "cols": blocked.cols},
                          {"vals": blocked.vals, "b": b})
    v = blocked.vector_size
    if v not in (8, 16):
        raise ValueError(f"{op}: vector_size {v} not in (8, 16)")
    if not (n_blk % 32 == 0 and 32 <= n_blk <= 1024):
        raise ValueError(f"{op}: n_blk={n_blk} must be a multiple of 32 in "
                         "[32, 1024]")
    n = b.shape[1]
    n_tile = min(n_blk, max(32, -(-n // 32) * 32))
    if (max(m, n, blocked.num_blocks) > _checks.int32_max
            or -(-n // n_tile) > 65535):
        raise ValueError(f"{op}: shape too large for the kernel's grid")
    if m == 0 or n == 0:
        return torch.zeros((m, n), dtype=torch.float32, device=b.device)
    gath = b[blocked.cols.long()]                  # the staged gather
    c = torch.empty((m, n), dtype=torch.float32, device=b.device)
    err = _build.library("spmm_staged").spmm_staged_f32(
        blocked.block_win.data_ptr(), blocked.vals.data_ptr(),
        gath.data_ptr(), c.data_ptr(), m, n, blocked.num_blocks, v,
        blocked.k_blk, n_tile, torch.cuda.current_stream(b.device).cuda_stream)
    _build.check_launch("spmm_staged", err)
    spmm_staged_cuda.launches += 1
    return zero_unvisited(c, blocked)


spmm_staged_cuda.launches = 0

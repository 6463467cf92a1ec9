"""Staged-gather SpMM kernel: ``spmm_staged_cuda`` (``csrc/spmm_staged.cu``)
and its plain version.

Counterpart of ``repro.kernels.spmm_pallas.spmm_pallas_staged``, which
launches ``_staged_spmm_kernel``: the pre-fusion baseline that gathers
``B[cols]`` into an ``(NNZP, N)`` buffer in device memory, runs a
block-indexed grid over it, and zeroes the windows no K-block visits in a
post-pass (``_zero_unvisited``).  The gather and the post-pass are plain
PyTorch, as in the reference they are XLA outside the kernel.
``spmm_staged_cuda`` launches the kernel on CUDA tensors and counts each
launch in ``spmm_staged_cuda.launches`` (and per variant in
``variant_launches``); on CPU tensors it runs :func:`spmm_staged_plain`.
Operands are 2-D.

Its variants (:data:`VARIANTS`) are the reference's levels: fp32 values
and B, or bf16 values and B, whose staged copy is then bf16 (half the
bytes); the kernel sums in fp32 into an fp32 C, the post-pass zeroes it,
and one cast gives B's dtype.  The reference has no int8 path here
(``spmm_pallas.py:678``): int8 values raise ``ValueError``, as there.
"""

from __future__ import annotations

import torch

from repro_torch.core.format import BlockedMEBCRS
from repro_torch.core.spmm import _spmm_blocked_impl

from . import _build, _checks

__all__ = ["spmm_staged_cuda", "spmm_staged_plain", "zero_unvisited",
           "VARIANTS"]

# (vals, B) dtypes of the kernel's variants
VARIANTS = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16))


def spmm_staged_plain(blocked: BlockedMEBCRS, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``C (M, N) = A @ B`` from the
    gathered rows, unvisited windows zero, sums in fp32, C in B's
    dtype."""
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
    """``C (M, N) = A @ B`` over ``blocked`` (fp32 or bf16 values and B,
    :data:`VARIANTS`) through a staged ``B[cols]`` gather, C in B's dtype;
    ``n_blk`` is the column tile (threads per block, a multiple of 32 up
    to 1024)."""
    op = "spmm_staged_cuda"
    if blocked.vals.dtype == torch.int8:
        raise ValueError(f"{op} has no int8 path (no per-block scales in "
                         "the staged grid, as spmm_pallas_staged); use the "
                         "fused or balanced impls")
    _checks.forward_inputs(op, VARIANTS, vals=blocked.vals, b=b)
    m, k = blocked.shape
    if blocked.vals.dim() != 2 or b.dim() != 2 or b.shape[0] != k:
        raise ValueError(f"{op}: need vals (NNZP, V) and b ({k}, N), got "
                         f"{tuple(blocked.vals.shape)} and {tuple(b.shape)}")
    v = _checks.vector_size(op, blocked)
    _checks.column_tile(op, n_blk, 1024)
    n = b.shape[1]
    n_tile = min(n_blk, max(32, -(-n // 32) * 32))
    if (max(m, n, blocked.num_blocks) > _checks.int32_max
            or -(-n // n_tile) > 65535):
        raise ValueError(f"{op}: shape too large for the kernel's grid")
    if _checks.on_cpu(op, block_win=blocked.block_win, cols=blocked.cols,
                      vals=blocked.vals, b=b):
        return spmm_staged_plain(blocked, b)
    _checks.kernel_inputs(op, {"block_win": blocked.block_win,
                               "cols": blocked.cols},
                          {"vals": blocked.vals, "b": b})
    if m == 0 or n == 0:
        return torch.zeros((m, n), dtype=b.dtype, device=b.device)
    gath = b[blocked.cols.long()]                  # the staged gather
    c = torch.empty((m, n), dtype=torch.float32, device=b.device)
    err = _build.library("spmm_staged").spmm_staged_launch(
        blocked.block_win.data_ptr(), blocked.vals.data_ptr(),
        gath.data_ptr(), c.data_ptr(), m, n, blocked.num_blocks, v,
        blocked.k_blk, n_tile, _checks.dtype_code(b),
        torch.cuda.current_stream(b.device).cuda_stream)
    _build.check_launch("spmm_staged", err)
    spmm_staged_cuda.launches += 1
    spmm_staged_cuda.variant_launches[_checks.variant(blocked.vals)] += 1
    return zero_unvisited(c, blocked).to(b.dtype)


spmm_staged_cuda.launches = 0
spmm_staged_cuda.variant_launches = {"fp32": 0, "bf16": 0}

"""Staged-gather SpMM kernel: ``spmm_staged_cuda`` (``csrc/spmm_staged.cu``)
and its plain version.

Counterpart of ``repro.kernels.spmm_pallas.spmm_pallas_staged``, which
launches ``_staged_spmm_kernel``: the pre-fusion baseline that gathers
``B[cols]`` into an ``(NNZP, N)`` buffer in device memory, reads it back in
its SpMM kernel into an fp32 output, zeroes the windows no K-block visits
in a post-pass (``_zero_unvisited``) and casts to B's dtype once.  The
stages stay separate passes here, since they are what the baseline
measures: :func:`staged_gather` (the gather kernel, where the reference
has ``jnp.take``), :func:`staged_window_spmm` (``spmm_cuda``'s
window-parallel kernel reading row ``t`` of the staged copy where
``spmm_cuda`` reads row ``cols[t]`` of B, into fp32), then
:func:`zero_unvisited` and the cast, plain PyTorch as the reference's are
XLA.  So this baseline and ``spmm_cuda`` differ in the staged copy and
its passes alone, and give the same bits on every window (bf16: one
rounding of the same fp32 sum).  ``spmm_staged_cuda`` runs the stages on
CUDA tensors; the SpMM kernel counts each launch in
``spmm_staged_cuda.launches`` (and per variant in ``variant_launches``),
the gather kernel in ``staged_gather.launches``.  On CPU tensors it runs
:func:`spmm_staged_plain`.  Operands are 2-D.

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
from ._window import MAX_THREADS, SPLIT_BLK, window_plan
from .spmm_cuda import wide_index

__all__ = ["spmm_staged_cuda", "spmm_staged_plain", "staged_gather",
           "staged_gather_plain", "staged_window_spmm", "zero_unvisited",
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
    (a ``where``, so whatever the allocation held, NaN included, goes).
    The row mask is a property of the pattern: built once per
    ``block_win`` tensor and memoized on it, as the window plans are."""
    rows = getattr(blocked.block_win, "_visited_rows", None)
    if rows is None or rows.shape[0] != out.shape[0]:
        visited = torch.zeros(blocked.num_windows, dtype=torch.bool,
                              device=out.device)
        visited[blocked.block_win.long()] = True
        rows = visited.repeat_interleave(blocked.vector_size)[: out.shape[0]]
        blocked.block_win._visited_rows = rows
    return torch.where(rows[:, None], out, 0.0)


def staged_gather_plain(blocked: BlockedMEBCRS,
                        b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the gather kernel: ``B[cols]``."""
    return b[blocked.cols.long()]


def staged_gather(blocked: BlockedMEBCRS, b: torch.Tensor) -> torch.Tensor:
    """The staged copy ``G = B[cols]`` (NNZP, N) in B's dtype, written to
    device memory by the gather kernel on CUDA tensors (each launch
    counted in ``staged_gather.launches``); on CPU tensors
    :func:`staged_gather_plain`."""
    op = "staged_gather"
    _checks.forward_inputs(op, ((torch.float32,), (torch.bfloat16,)), b=b)
    if b.dim() != 2 or b.shape[0] != blocked.shape[1]:
        raise ValueError(f"{op}: need b ({blocked.shape[1]}, N), got "
                         f"{tuple(b.shape)}")
    if _checks.on_cpu(op, cols=blocked.cols, b=b):
        return staged_gather_plain(blocked, b)
    _checks.kernel_inputs(op, {"cols": blocked.cols}, {"b": b})
    rows, n = blocked.cols.shape[0], b.shape[1]
    gath = torch.empty((rows, n), dtype=b.dtype, device=b.device)
    if rows == 0 or n == 0:
        return gath
    err = _build.library("spmm_gather").spmm_gather_launch(
        blocked.cols.data_ptr(), b.data_ptr(), gath.data_ptr(), rows, n,
        _checks.dtype_code(b), torch.cuda.current_stream(b.device).cuda_stream)
    _build.check_launch("spmm_gather", err)
    staged_gather.launches += 1
    staged_gather.variant_launches[_checks.variant(b)] += 1
    return gath


def staged_window_spmm(blocked: BlockedMEBCRS, gath: torch.Tensor,
                       n_tile: int = 128) -> torch.Tensor:
    """The SpMM kernel of the staged baseline on CUDA tensors: the fp32
    ``C (M, N)`` from the staged copy ``gath`` (:func:`staged_gather`),
    every window stored, over ``spmm_cuda``'s window plan at column tile
    ``n_tile`` (a multiple of 32 up to 512); each launch counted in
    ``spmm_staged_cuda.launches``."""
    op = "spmm_staged_cuda"
    m, _ = blocked.shape
    nnzp, n = gath.shape
    v = blocked.vector_size
    c = torch.empty((m, n), dtype=torch.float32, device=gath.device)
    plan = window_plan(op, blocked.win_ptr, SPLIT_BLK, n_tile)
    err = _build.library("spmm_staged").spmm_staged_launch(
        blocked.win_ptr.data_ptr(), blocked.vals.data_ptr(), gath.data_ptr(),
        c.data_ptr(), plan.split_ids.data_ptr(), m, n, plan.num_windows, v,
        blocked.k_blk, n_tile, plan.groups, plan.cluster, plan.split_blk,
        plan.num_long, plan.num_medium, _checks.dtype_code(gath),
        int(wide_index(nnzp * n, nnzp * v)),
        torch.cuda.current_stream(gath.device).cuda_stream)
    _build.check_launch("spmm_staged", err)
    spmm_staged_cuda.launches += 1
    spmm_staged_cuda.variant_launches[_checks.variant(blocked.vals)] += 1
    return c


def spmm_staged_cuda(blocked: BlockedMEBCRS, b: torch.Tensor, *,
                     n_blk: int = 128) -> torch.Tensor:
    """``C (M, N) = A @ B`` over ``blocked`` (fp32 or bf16 values and B,
    :data:`VARIANTS`) through a staged ``B[cols]`` gather, C in B's dtype;
    ``n_blk`` is the column tile of the SpMM kernel (a multiple of 32 up
    to 512, as ``spmm_cuda``'s)."""
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
    _checks.vector_size(op, blocked)
    _checks.column_tile(op, n_blk, MAX_THREADS)
    n = b.shape[1]
    n_tile = min(n_blk, max(32, -(-n // 32) * 32))
    if (max(m, n, blocked.num_blocks) > _checks.int32_max
            or -(-n // n_tile) > 65535):
        raise ValueError(f"{op}: shape too large for the kernel's grid")
    if _checks.on_cpu(op, win_ptr=blocked.win_ptr, block_win=blocked.block_win,
                      cols=blocked.cols, vals=blocked.vals, b=b):
        return spmm_staged_plain(blocked, b)
    _checks.kernel_inputs(op, {"win_ptr": blocked.win_ptr,
                               "block_win": blocked.block_win,
                               "cols": blocked.cols},
                          {"vals": blocked.vals, "b": b})
    if m == 0 or n == 0:
        return torch.zeros((m, n), dtype=b.dtype, device=b.device)
    gath = staged_gather(blocked, b)             # 1. the staged copy
    c = staged_window_spmm(blocked, gath, n_tile)  # 2. read back, fp32 C
    return zero_unvisited(c, blocked).to(b.dtype)  # 3. post-pass, one cast


spmm_staged_cuda.launches = 0
spmm_staged_cuda.variant_launches = {"fp32": 0, "bf16": 0}
staged_gather.launches = 0
staged_gather.variant_launches = {"fp32": 0, "bf16": 0}

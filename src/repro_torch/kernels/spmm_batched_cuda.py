"""Batched SpMM kernel: ``spmm_batched_cuda`` (``csrc/spmm_batched.cu``) and
its plain version.

Counterpart of ``repro.kernels.spmm_pallas.spmm_pallas_batched``, which
launches ``_batched_spmm_kernel``: the window-parallel SpMM over a grid
of H heads, one launch for every head, bitwise-equal to H launches of
``spmm_cuda``.  ``spmm_batched_cuda`` launches the hand-written kernel on
CUDA tensors and counts each launch in ``spmm_batched_cuda.launches``; on
CPU tensors it runs :func:`spmm_batched_plain`.

Operands follow the batched convention of the reference: ``vals`` may be
``(NNZP, V)`` or ``(H, NNZP, V)`` and ``b`` ``(K, N)`` or ``(H, K, N)``;
a 2-D operand is shared by every head (read from its one copy), and the
result is ``(H, M, N)``.  With neither operand batched it is the
single-head :func:`~repro_torch.kernels.spmm_cuda.spmm_cuda`, as the
reference falls through to ``spmm_pallas``.

The kernel's variants are ``spmm_cuda``'s (:data:`~repro_torch.kernels.
spmm_cuda.VARIANTS`): fp32, bf16, or int8 values with the view's
per-K-block scales and fp32 or bf16 B; int8 values must be shared by
every head (2-D), as the reference requires (``spmm_pallas.py:407``).  C
comes back in B's dtype, and ``spmm_batched_cuda.variant_launches``
counts the launches of each variant.
"""

from __future__ import annotations

import torch

from repro_torch.core.format import BlockedMEBCRS
from repro_torch.core.spmm import _spmm_blocked_impl

from . import _build, _checks
from ._window import MAX_THREADS, SPLIT_BLK, window_plan
from .spmm_cuda import _variant_inputs, spmm_cuda, wide_index

__all__ = ["spmm_batched_cuda", "spmm_batched_plain"]


def spmm_batched_plain(blocked: BlockedMEBCRS, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``C[h] = A[h] @ B[h]``."""
    return _spmm_blocked_impl(blocked, b)


def spmm_batched_cuda(blocked: BlockedMEBCRS, b: torch.Tensor, *,
                      n_blk: int = 128) -> torch.Tensor:
    """``C[h] (M, N) = A[h] @ B[h]`` over ``blocked`` for every head in one
    launch (the variants of ``spmm_cuda``), C in B's dtype, sums in fp32;
    ``n_blk`` as in :func:`~repro_torch.kernels.spmm_cuda.spmm_cuda`."""
    op = "spmm_batched_cuda"
    h, batched = _checks.heads(op, vals=(blocked.vals, 2), b=(b, 2))
    if not batched:
        return spmm_cuda(blocked, b, n_blk=n_blk)
    scales = _variant_inputs(op, blocked, b)
    tensors = dict(win_ptr=blocked.win_ptr, cols=blocked.cols,
                   vals=blocked.vals, b=b)
    if scales is not None:
        tensors["scales"] = scales
    if _checks.on_cpu(op, **tensors):
        return spmm_batched_plain(blocked, b)
    _checks.kernel_inputs(op, {"win_ptr": blocked.win_ptr, "cols": blocked.cols},
                          {k_: t for k_, t in tensors.items()
                           if k_ not in ("win_ptr", "cols")})
    m, k = blocked.shape
    v = blocked.vector_size
    if v not in (8, 16):
        raise ValueError(f"{op}: vector_size {v} not in (8, 16)")
    if b.shape[-2] != k:
        raise ValueError(f"{op}: b must be ([H,] {k}, N), got {tuple(b.shape)}")
    if not (n_blk % 32 == 0 and 32 <= n_blk <= MAX_THREADS):
        raise ValueError(f"{op}: n_blk={n_blk} must be a multiple of 32 in "
                         f"[32, {MAX_THREADS}]")
    n = b.shape[-1]
    n_tile = min(n_blk, max(32, -(-n // 32) * 32))
    if (max(m, n) > _checks.int32_max or -(-n // n_tile) > 65535
            or h > 65535):
        raise ValueError(f"{op}: shape too large for the kernel's grid")
    c = torch.empty((h, m, n), dtype=b.dtype, device=b.device)
    if m == 0 or n == 0:
        return c
    plan = window_plan(op, blocked.win_ptr, SPLIT_BLK, n_tile)
    err = _build.library("spmm_batched").spmm_batched_launch(
        blocked.win_ptr.data_ptr(), blocked.cols.data_ptr(),
        blocked.vals.data_ptr(), 0 if scales is None else scales.data_ptr(),
        b.data_ptr(), c.data_ptr(), plan.split_ids.data_ptr(), m, n,
        plan.num_windows, h, v, blocked.k_blk, n_tile, plan.groups,
        plan.cluster, plan.split_blk, plan.num_long, plan.num_medium,
        _checks.head_stride(blocked.vals, 2), _checks.head_stride(b, 2),
        _checks.dtype_code(blocked.vals), _checks.dtype_code(b),
        int(wide_index(k * n, blocked.vals.shape[-2] * v)),
        torch.cuda.current_stream(b.device).cuda_stream)
    _build.check_launch("spmm_batched", err)
    spmm_batched_cuda.launches += 1
    spmm_batched_cuda.variant_launches[_checks.variant(blocked.vals)] += 1
    return c


spmm_batched_cuda.launches = 0
spmm_batched_cuda.variant_launches = {"fp32": 0, "bf16": 0, "int8": 0}

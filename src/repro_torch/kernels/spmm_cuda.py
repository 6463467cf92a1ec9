"""SpMM kernel: ``spmm_cuda`` (``csrc/spmm.cu``) and its plain version.

Counterpart of ``repro.kernels.spmm_pallas.spmm_pallas``, which launches
``_fused_spmm_kernel``.  ``spmm_cuda`` launches the hand-written kernel on
CUDA tensors and counts each launch in ``spmm_cuda.launches``; on CPU
tensors it runs :func:`spmm_plain`, the gather-einsum-``index_add_`` of
``core.spmm.spmm_blocked``.  Windows of more than ``SPLIT_BLK`` K-blocks
are cut into slices over the groups of a block or of a thread-block
cluster by a window plan (``kernels/_window.py``).

The kernel's variants are the reference's precisions (DESIGN.md §13):
fp32 values and B, bf16 values and B, or int8 values with the view's
per-K-block fp32 ``scales`` and fp32 or bf16 B; C comes back in B's
dtype, summed in fp32.  One head's B or values of 2^31 elements or more
take the kernel's 64-bit-index instantiation (:func:`wide_index`).
``spmm_cuda.variant_launches`` counts the launches of each variant
(``"fp32"``, ``"bf16"``, ``"int8"``) beside the total in ``launches``.
"""

from __future__ import annotations

import torch

from repro_torch.core.format import BlockedMEBCRS
from repro_torch.core.spmm import _spmm_blocked_impl

from . import _build, _checks
from ._window import MAX_THREADS, SPLIT_BLK, window_plan

__all__ = ["spmm_cuda", "spmm_plain", "VARIANTS", "wide_index"]

# (vals, B) dtypes of the kernel's variants; int8 values come with the
# view's fp32 per-K-block scales
_F32, _BF16, _I8 = torch.float32, torch.bfloat16, torch.int8
VARIANTS = ((_F32, _F32), (_BF16, _BF16), (_I8, _F32), (_I8, _BF16))


def wide_index(*counts: int) -> bool:
    """Whether one head's operands need the 64-bit-index instantiation:
    one of ``counts`` (K·N, NNZP·V) reaches 2^31 elements."""
    return max(counts) > _checks.int32_max


def spmm_plain(blocked: BlockedMEBCRS, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``C (M, N) = A @ B``, int8
    values dequantized, sums in fp32, C in B's dtype."""
    return _spmm_blocked_impl(blocked, b)


def _variant_inputs(op: str, blocked: BlockedMEBCRS, b: torch.Tensor):
    """Check ``(vals, b)`` against :data:`VARIANTS` (and that nothing
    needs a gradient); returns the scales the kernel reads, ``None`` for
    float values.  int8 values carry one scale per K-block for every head,
    so they must be 2-D (shared by the heads), as the reference requires
    (``spmm_pallas.py:407``)."""
    _checks.forward_inputs(op, VARIANTS, vals=blocked.vals, b=b)
    if blocked.vals.dtype != torch.int8:
        return None
    scales = blocked.scales
    if (scales is None or scales.dtype != torch.float32
            or scales.shape != (blocked.num_blocks,)):
        raise TypeError(f"{op}: int8 values need the view's fp32 per-K-block "
                        f"scales ({blocked.num_blocks},) (quantize_format)")
    if blocked.vals.dim() != 2:
        raise ValueError(f"{op}: int8 values must be shared by every head "
                         "(2-D, one scale per K-block); quantize before "
                         "stacking heads")
    return scales


def spmm_cuda(blocked: BlockedMEBCRS, b: torch.Tensor, *,
              n_blk: int = 128) -> torch.Tensor:
    """``C (M, N) = A @ B`` over ``blocked`` (fp32, bf16 or int8 values,
    see :data:`VARIANTS`), C in B's dtype, sums in fp32; ``n_blk`` is the
    column tile (columns per slice group, a multiple of 32 up to 512: a
    thread each, or for bf16 B where no window is split two adjacent
    columns a thread), and windows of more than ``SPLIT_BLK`` K-blocks are
    split."""
    op = "spmm_cuda"
    scales = _variant_inputs(op, blocked, b)
    tensors = dict(win_ptr=blocked.win_ptr, cols=blocked.cols,
                   vals=blocked.vals, b=b)
    if scales is not None:
        tensors["scales"] = scales
    if _checks.on_cpu(op, **tensors):
        return spmm_plain(blocked, b)
    _checks.kernel_inputs(op, {"win_ptr": blocked.win_ptr, "cols": blocked.cols},
                          {k: t for k, t in tensors.items()
                           if k not in ("win_ptr", "cols")})
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
    if max(m, n) > _checks.int32_max or -(-n // n_tile) > 65535:
        raise ValueError(f"{op}: shape too large for the kernel's grid")
    c = torch.empty((m, n), dtype=b.dtype, device=b.device)
    if m == 0 or n == 0:
        return c
    plan = window_plan(op, blocked.win_ptr, SPLIT_BLK, n_tile)
    err = _build.library("spmm").spmm_launch(
        blocked.win_ptr.data_ptr(), blocked.cols.data_ptr(),
        blocked.vals.data_ptr(), 0 if scales is None else scales.data_ptr(),
        b.data_ptr(), c.data_ptr(), plan.split_ids.data_ptr(), m, n,
        plan.num_windows, v, blocked.k_blk, n_tile, plan.groups,
        plan.cluster, plan.split_blk, plan.num_long, plan.num_medium,
        _checks.dtype_code(blocked.vals), _checks.dtype_code(b),
        int(wide_index(k * n, blocked.vals.shape[-2] * v)),
        torch.cuda.current_stream(b.device).cuda_stream)
    _build.check_launch("spmm", err)
    spmm_cuda.launches += 1
    spmm_cuda.variant_launches[_checks.variant(blocked.vals)] += 1
    return c


spmm_cuda.launches = 0
spmm_cuda.variant_launches = {"fp32": 0, "bf16": 0, "int8": 0}

"""Batched SDDMM kernel: ``sddmm_batched_cuda`` (``csrc/sddmm_batched.cu``)
and its plain version.

Counterpart of ``repro.kernels.sddmm_pallas.sddmm_pallas_batched``, which
launches ``_batched_sddmm_kernel``: the tensor-core SDDMM tile over a grid
of H heads, one launch for every head, bitwise-equal to H launches of
``sddmm_cuda``.  ``sddmm_batched_cuda`` launches the hand-written kernel
on CUDA tensors and counts each launch in ``sddmm_batched_cuda.launches``;
on CPU tensors it runs :func:`sddmm_batched_plain`.

``q`` may be ``(M, F)`` or ``(H, M, F)`` and ``k`` ``(Mc, F)`` or
``(H, Mc, F)``; a 2-D operand is shared by every head (read from its one
copy), and the result is ``(H, NNZP, V)``.  With neither operand batched
it is the single-head :func:`~repro_torch.kernels.sddmm_cuda.sddmm_cuda`,
as the reference falls through to ``sddmm_pallas``.  Q and K are both
float32 or both bfloat16 (``sddmm_cuda``'s variants): fp32 dots, S in Q's
dtype; ``sddmm_batched_cuda.variant_launches`` counts each variant's
launches.
"""

from __future__ import annotations

import torch

from repro_torch.core.format import BlockedMEBCRS
from repro_torch.core.sddmm import _sddmm_blocked_impl

from . import _build, _checks
from .sddmm_cuda import VARIANTS, sddmm_cuda

__all__ = ["sddmm_batched_cuda", "sddmm_batched_plain"]


def sddmm_batched_plain(blocked: BlockedMEBCRS, q: torch.Tensor,
                        k: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``mask ⊙ (Q[h] K[h]ᵀ)`` in the
    blocked layout, per head."""
    return _sddmm_blocked_impl(blocked, q, k)


def sddmm_batched_cuda(blocked: BlockedMEBCRS, q: torch.Tensor,
                       k: torch.Tensor) -> torch.Tensor:
    """Sampled ``Q[h] Kᵀ[h]`` at ``blocked``'s pattern (fp32 or bf16
    operands, fp32 dots) for every head in one launch, as blocked-layout
    values ``(H, NNZP, V)`` in Q's dtype."""
    op = "sddmm_batched_cuda"
    _checks.forward_inputs(op, VARIANTS, q=q, k=k)
    h, batched = _checks.heads(op, q=(q, 2), k=(k, 2))
    if not batched:
        return sddmm_cuda(blocked, q, k)
    tensors = dict(block_win=blocked.block_win, cols=blocked.cols,
                   mask=blocked.mask, q=q, k=k)
    if _checks.on_cpu(op, **tensors):
        return sddmm_batched_plain(blocked, q, k)
    _checks.kernel_inputs(op, {"block_win": blocked.block_win,
                               "cols": blocked.cols},
                          {"mask": blocked.mask, "q": q, "k": k})
    m, mc = blocked.shape
    v = blocked.vector_size
    if v not in (8, 16):
        raise ValueError(f"{op}: vector_size {v} not in (8, 16)")
    if blocked.mask.dtype != torch.bool:
        raise TypeError(f"{op}: mask must be bool, got {blocked.mask.dtype}")
    if q.shape[-2] != m or k.shape[-2] != mc or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"{op}: need q ([H,] {m}, F) and k ([H,] {mc}, F), "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    nnzp = blocked.cols.shape[0]
    if (max(m, mc, q.shape[-1], blocked.num_blocks) > _checks.int32_max
            or h > 65535):
        raise ValueError(f"{op}: shape too large for the kernel's grid")
    out = torch.empty((h, nnzp, v), dtype=q.dtype, device=q.device)
    err = _build.library("sddmm_batched").sddmm_batched_launch(
        blocked.block_win.data_ptr(), blocked.cols.data_ptr(), q.data_ptr(),
        k.data_ptr(), blocked.mask.data_ptr(), out.data_ptr(), m, q.shape[-1],
        blocked.num_blocks, h, v, blocked.k_blk, _checks.head_stride(q, 2),
        _checks.head_stride(k, 2), _checks.dtype_code(q),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch("sddmm_batched", err)
    sddmm_batched_cuda.launches += 1
    sddmm_batched_cuda.variant_launches[_checks.variant(q)] += 1
    return out


sddmm_batched_cuda.launches = 0
sddmm_batched_cuda.variant_launches = {"fp32": 0, "bf16": 0}

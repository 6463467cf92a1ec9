"""SDDMM kernel: ``sddmm_cuda`` (``csrc/sddmm.cu``) and its plain version.

Counterpart of ``repro.kernels.sddmm_pallas.sddmm_pallas``, which launches
``_fused_sddmm_kernel``.  ``sddmm_cuda`` launches the hand-written kernel
on CUDA tensors and counts each launch in ``sddmm_cuda.launches``; on CPU
tensors it runs :func:`sddmm_plain`, ``core.sddmm.sddmm_blocked``'s
gather-einsum.  Q and K are both float32 or both bfloat16 (the
reference's bf16 path): the kernel takes the dots on the TF32 tensor
cores, 3xTF32 for fp32 operands and exact for bf16 ones, with fp32 sums,
and the result comes back in Q's dtype.  ``sddmm_cuda.variant_launches`` counts the launches of each
variant (``"fp32"``, ``"bf16"``) beside the total in ``launches``.
"""

from __future__ import annotations

import torch

from repro_torch.core.format import BlockedMEBCRS
from repro_torch.core.sddmm import _sddmm_blocked_impl

from . import _build, _checks

__all__ = ["sddmm_cuda", "sddmm_plain", "VARIANTS"]

# (Q, K) dtypes of the kernel's variants; S comes back in Q's
VARIANTS = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16))


def sddmm_plain(blocked: BlockedMEBCRS, q: torch.Tensor,
                k: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``mask ⊙ (Q Kᵀ)`` in the
    blocked (NNZP, V) layout."""
    return _sddmm_blocked_impl(blocked, q, k)


def sddmm_cuda(blocked: BlockedMEBCRS, q: torch.Tensor,
               k: torch.Tensor) -> torch.Tensor:
    """Sampled ``Q (M, F) @ K (Mc, F)ᵀ`` at ``blocked``'s pattern (fp32 or
    bf16 operands, fp32 dots), returned as blocked-layout values
    ``(NNZP, V)`` in Q's dtype."""
    op = "sddmm_cuda"
    _checks.forward_inputs(op, VARIANTS, q=q, k=k)
    m, mc = blocked.shape
    v = _checks.vector_size(op, blocked)
    if blocked.mask.dtype != torch.bool:
        raise TypeError(f"{op}: mask must be bool, got {blocked.mask.dtype}")
    if q.dim() != 2 or k.dim() != 2 or q.shape[0] != m or k.shape[0] != mc \
            or q.shape[1] != k.shape[1]:
        raise ValueError(f"{op}: need q ({m}, F) and k ({mc}, F), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    if max(m, mc, q.shape[1], blocked.num_blocks) > _checks.int32_max:
        raise ValueError(f"{op}: shape too large for the kernel's grid")
    tensors = dict(block_win=blocked.block_win, cols=blocked.cols,
                   mask=blocked.mask, q=q, k=k)
    if _checks.on_cpu(op, **tensors):
        return sddmm_plain(blocked, q, k)
    _checks.kernel_inputs(op, {"block_win": blocked.block_win,
                               "cols": blocked.cols},
                          {"mask": blocked.mask, "q": q, "k": k})
    nnzp = blocked.cols.shape[0]
    out = torch.empty((nnzp, v), dtype=q.dtype, device=q.device)
    err = _build.library("sddmm").sddmm_launch(
        blocked.block_win.data_ptr(), blocked.cols.data_ptr(), q.data_ptr(),
        k.data_ptr(), blocked.mask.data_ptr(), out.data_ptr(), m, q.shape[1],
        blocked.num_blocks, v, blocked.k_blk, _checks.dtype_code(q),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch("sddmm", err)
    sddmm_cuda.launches += 1
    sddmm_cuda.variant_launches[_checks.variant(q)] += 1
    return out


sddmm_cuda.launches = 0
sddmm_cuda.variant_launches = {"fp32": 0, "bf16": 0}

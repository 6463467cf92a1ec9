"""Fused sparse-attention kernel: ``attention_cuda`` (``csrc/attention.cu``)
and its plain version.

Counterpart of ``repro.kernels.attention_pallas.attention_pallas``, which
launches ``_fused_attn_kernel``: SDDMM → row softmax → SpMM in one pass
per window, the scores never reaching device memory.  ``attention_cuda``
launches the hand-written kernel on CUDA tensors and counts each launch in
``attention_cuda.launches``; on CPU tensors it runs
:func:`attention_plain`, the same function in three passes (plain SDDMM →
``sparse_softmax`` → plain SpMM).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.format import BlockedMEBCRS
from repro_torch.core.sddmm import attention_staged

from . import _build, _checks

__all__ = ["attention_cuda", "attention_plain"]


def attention_plain(blocked: BlockedMEBCRS, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, scale=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel."""
    return attention_staged(blocked, q, k, v, scale)


def attention_cuda(blocked: BlockedMEBCRS, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, *, scale=None) -> torch.Tensor:
    """``softmax_rows(scale · mask ⊙ Q Kᵀ) @ V`` over ``blocked``'s pattern:
    ``q (M, D)``, ``k (Mc, D)``, ``v (Mc, DV)`` → ``(M, DV)``, fp32.

    ``scale`` (default ``1/sqrt(D)``) may be a 0-d tensor such as AGNN's
    learned β; it is folded into Q before the launch, as the reference
    does, and never read back to the host.
    """
    op = "attention_cuda"
    scale_t = {"scale": scale} if isinstance(scale, torch.Tensor) else {}
    _checks.forward_inputs(op, q=q, k=k, v=v, **scale_t)
    tensors = dict(win_ptr=blocked.win_ptr, cols=blocked.cols,
                   mask=blocked.mask, q=q, k=k, v=v)
    if _checks.on_cpu(op, **tensors):
        return attention_plain(blocked, q, k, v, scale)
    m, mc = blocked.shape
    vsz = blocked.vector_size
    if vsz not in (8, 16):
        raise ValueError(f"{op}: vector_size {vsz} not in (8, 16)")
    if blocked.mask.dtype != torch.bool:
        raise TypeError(f"{op}: mask must be bool, got {blocked.mask.dtype}")
    if q.dim() != 2 or k.dim() != 2 or v.dim() != 2 or q.shape[0] != m \
            or k.shape[0] != mc or v.shape[0] != mc or k.shape[1] != q.shape[1]:
        raise ValueError(f"{op}: need q ({m}, D), k ({mc}, D), v ({mc}, DV); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    d, dv, k_blk = q.shape[1], v.shape[1], blocked.k_blk
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qs = (q.float() * scale).to(q.dtype)
    _checks.kernel_inputs(op, {"win_ptr": blocked.win_ptr, "cols": blocked.cols},
                          {"mask": blocked.mask, "q": qs, "k": k, "v": v})
    out = torch.empty((m, dv), dtype=torch.float32, device=q.device)
    if m == 0 or dv == 0:
        return out
    err = _build.library("attention").attention_f32(
        blocked.win_ptr.data_ptr(), blocked.cols.data_ptr(), qs.data_ptr(),
        k.data_ptr(), v.data_ptr(), blocked.mask.data_ptr(), out.data_ptr(),
        m, d, dv, blocked.num_windows, vsz, k_blk,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch("attention", err)
    attention_cuda.launches += 1
    return out


attention_cuda.launches = 0

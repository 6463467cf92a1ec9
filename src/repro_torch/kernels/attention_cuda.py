"""Fused sparse-attention kernel: ``attention_cuda`` (``csrc/attention.cu``)
and its plain version, plus the staged composition ``attention_cuda_staged``.

Counterpart of ``repro.kernels.attention_pallas.attention_pallas``, which
launches ``_fused_attn_kernel``: SDDMM → row softmax → SpMM in one pass
per (head, window), the scores never reaching device memory, one launch
for every head.  Both products run on the tensor cores (``mma.sync``
m16n8k8 in 3xTF32, the window's rows on the n side), so ``DV`` is at most
128 (the accumulator lives in registers).  ``attention_cuda`` launches the
hand-written kernel on CUDA tensors and counts each launch in
``attention_cuda.launches``; on CPU tensors it runs
:func:`attention_plain`, the same function in three passes (plain SDDMM →
``sparse_softmax`` → plain SpMM).

``attention_cuda_staged`` is the counterpart of
``attention_pallas_staged``: the batched SDDMM kernel → ``sparse_softmax``
→ the batched SpMM kernel, the scores through device memory.  It has no
kernel of its own.

``q``, ``k`` and ``v`` may each carry a leading head dimension; a 2-D
operand is shared by every head, and all 2-D in gives ``(M, DV)`` out.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.format import BlockedMEBCRS
from repro_torch.core.sddmm import attention_staged, with_values
from repro_torch.core.softmax import sparse_softmax

from . import _build, _checks
from .sddmm_batched_cuda import sddmm_batched_cuda
from .spmm_batched_cuda import spmm_batched_cuda

__all__ = ["attention_cuda", "attention_plain", "attention_cuda_staged"]

# Chunks of 32 vectors a warp walks: 8 windows a warp for the Amazon
# replica's A (1.1 chunks a window), 2 for the 12-head attention pattern
# (4.3 chunks a window).
CHUNKS_PER_WARP = 9


def windows_per_warp(num_windows: int, nnzp: int, heads: int) -> int:
    """Windows each warp of the kernel walks: about ``CHUNKS_PER_WARP``
    chunks of 32 vectors (a warp's prefetch runs across its windows, which
    pays where windows are short), at most 16, and at least 2,048 warps in
    all."""
    chunks = max(nnzp, 1) / 32 / max(num_windows, 1)
    wpw = round(CHUNKS_PER_WARP / max(chunks, 1.0))
    return max(1, min(16, wpw, num_windows * heads // 2048))


def attention_plain(blocked: BlockedMEBCRS, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, scale=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel."""
    return attention_staged(blocked, q, k, v, scale)


def attention_cuda(blocked: BlockedMEBCRS, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, *, scale=None) -> torch.Tensor:
    """``softmax_rows(scale · mask ⊙ Q Kᵀ) @ V`` over ``blocked``'s pattern:
    ``q ([H,] M, D)``, ``k ([H,] Mc, D)``, ``v ([H,] Mc, DV)`` →
    ``([H,] M, DV)``, fp32, one launch for every head.

    ``scale`` (default ``1/sqrt(D)``) is one scalar for every head and may
    be a 0-d tensor such as AGNN's learned β; it is folded into Q before
    the launch, as the reference does, and never read back to the host.
    """
    op = "attention_cuda"
    scale_t = {"scale": scale} if isinstance(scale, torch.Tensor) else {}
    _checks.forward_inputs(op, q=q, k=k, v=v, **scale_t)
    h, batched = _checks.heads(op, q=(q, 2), k=(k, 2), v=(v, 2))
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
    if (q.shape[-2] != m or k.shape[-2] != mc or v.shape[-2] != mc
            or k.shape[-1] != q.shape[-1]):
        raise ValueError(f"{op}: need q ([H,] {m}, D), k ([H,] {mc}, D), "
                         f"v ([H,] {mc}, DV); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if h > 65535:
        raise ValueError(f"{op}: {h} heads, the kernel's grid takes 65,535")
    d, dv, k_blk = q.shape[-1], v.shape[-1], blocked.k_blk
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qs = (q.float() * scale).to(q.dtype)
    _checks.kernel_inputs(op, {"win_ptr": blocked.win_ptr, "cols": blocked.cols},
                          {"mask": blocked.mask, "q": qs, "k": k, "v": v})
    out = torch.empty((h, m, dv), dtype=torch.float32, device=q.device)
    if m == 0 or dv == 0:
        return out if batched else out[0]
    err = _build.library("attention").attention_f32(
        blocked.win_ptr.data_ptr(), blocked.cols.data_ptr(), qs.data_ptr(),
        k.data_ptr(), v.data_ptr(), blocked.mask.data_ptr(), out.data_ptr(),
        m, d, dv, blocked.num_windows, h, vsz, k_blk,
        windows_per_warp(blocked.num_windows, blocked.cols.shape[0], h),
        _checks.head_stride(qs, 2), _checks.head_stride(k, 2),
        _checks.head_stride(v, 2),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch("attention", err)
    attention_cuda.launches += 1
    return out if batched else out[0]


attention_cuda.launches = 0


def attention_cuda_staged(blocked: BlockedMEBCRS, q: torch.Tensor,
                          k: torch.Tensor, v: torch.Tensor, *,
                          scale=None) -> torch.Tensor:
    """The three-pass attention of the kernels: the batched SDDMM, the
    sparse softmax (plain PyTorch, as the reference's is XLA), then the
    batched SpMM, one launch each for every head; operands and result as
    :func:`attention_cuda`.  The (``[H,]`` NNZP, V) scores and
    probabilities pass through device memory: the traffic the fused kernel
    keeps on chip."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = sddmm_batched_cuda(blocked, q, k)
    probs = sparse_softmax(blocked, scores * scale)
    return spmm_batched_cuda(with_values(blocked, probs.to(v.dtype)), v)

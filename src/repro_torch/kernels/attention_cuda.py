"""Fused sparse-attention kernel: ``attention_cuda`` (``csrc/attention.cu``)
and its plain version, plus the staged composition ``attention_cuda_staged``.

Counterpart of ``repro.kernels.attention_pallas.attention_pallas``, which
launches ``_fused_attn_kernel``: SDDMM → row softmax → SpMM in one pass
per (head, window), the scores never reaching device memory, one launch
for every head.  Both products run on the tensor cores (``mma.sync``
m16n8k8 in 3xTF32, the window's rows on the n side).  Q, K and V are all
float32 or all bfloat16 (the reference's bf16 path: fp32 scores, softmax
and sums, one rounding of the output).  ``attention_cuda`` launches the
hand-written kernel on CUDA tensors and counts each launch in
``attention_cuda.launches``; on CPU tensors it runs
:func:`attention_plain`, the same function in three passes (plain SDDMM →
``sparse_softmax`` → plain SpMM, in fp32).

The accumulator of a launch lives in registers, so a launch covers a band
of at most ``DV_BAND`` = 128 value columns: a wider V takes one launch per
band (:func:`value_bands`), each recomputing the scores.  A D whose K and
Q rings do not fit the card's shared memory (above about 712 fp32 or 1,420
bf16 columns at V = 8) runs the composition of the SDDMM and SpMM kernels
instead (:func:`rings_fit`): scores through device memory, in fp32, which
launches those kernels (and counts there) and not this one.

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

__all__ = ["attention_cuda", "attention_plain", "attention_cuda_staged",
           "VARIANTS", "DV_BAND", "value_bands", "rings_fit"]

# (Q, K, V) dtypes of the kernel's variants; the output comes in V's
VARIANTS = ((torch.float32,) * 3, (torch.bfloat16,) * 3)
DV_BAND = 128           # value columns of one launch (registers)
SMEM_OPTIN = 232448     # shared memory a block may opt in to on sm_90


def value_bands(dv: int) -> list:
    """The ``(first column, width)`` bands of ``DV_BAND`` columns or fewer
    that cover ``dv`` value columns, one launch each."""
    return [(c, min(DV_BAND, dv - c)) for c in range(0, dv, DV_BAND)]


def rings_fit(vsz: int, d: int, dtype: torch.dtype) -> bool:
    """Whether the kernel's K and Q rings (and P, the mask and barriers)
    for window size ``vsz`` and width ``d`` of ``dtype`` fit one block's
    shared memory (the kernel library states its layout's bytes)."""
    elt = torch.empty((), dtype=dtype).element_size()
    return (_build.library("attention").attention_smem_bytes(vsz, d, elt)
            <= SMEM_OPTIN)

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
    """Plain PyTorch version of the kernel.  For bf16 operands it takes the
    kernel's arithmetic: Q scaled in fp32 and rounded to bf16, then the
    scores, the softmax, P and P·V in fp32, and one rounding of the
    output to bf16."""
    if q.dtype == torch.float32:
        return attention_staged(blocked, q, k, v, scale)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qs = (q.float() * scale).to(q.dtype)
    return attention_staged(blocked, qs.float(), k.float(), v.float(),
                            1.0).to(v.dtype)


def attention_cuda(blocked: BlockedMEBCRS, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, *, scale=None) -> torch.Tensor:
    """``softmax_rows(scale · mask ⊙ Q Kᵀ) @ V`` over ``blocked``'s pattern:
    ``q ([H,] M, D)``, ``k ([H,] Mc, D)``, ``v ([H,] Mc, DV)`` →
    ``([H,] M, DV)`` in V's dtype (fp32 or bf16 operands), one launch for
    every head and band of ``DV_BAND`` value columns.

    ``scale`` (default ``1/sqrt(D)``) is one scalar for every head and may
    be a 0-d tensor such as AGNN's learned β; it is folded into Q before
    the launch, in fp32 and rounded to Q's dtype, as the reference does,
    and never read back to the host.
    """
    op = "attention_cuda"
    if isinstance(scale, torch.Tensor):
        _checks.forward_inputs(op, tuple(x + (scale.dtype,) for x in VARIANTS),
                               q=q, k=k, v=v, scale=scale)
    else:
        _checks.forward_inputs(op, VARIANTS, q=q, k=k, v=v)
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
    if not rings_fit(vsz, d, q.dtype):
        # scores and probabilities in fp32 whatever the operands' dtype
        return attention_cuda_staged(blocked, qs.float(), k.float(),
                                     v.float(), scale=1.0).to(v.dtype)
    out = torch.empty((h, m, dv), dtype=v.dtype, device=q.device)
    if m == 0 or dv == 0:
        return out if batched else out[0]
    elt = v.element_size()
    for c0, width in value_bands(dv):
        err = _build.library("attention").attention_launch(
            blocked.win_ptr.data_ptr(), blocked.cols.data_ptr(),
            qs.data_ptr(), k.data_ptr(), v.data_ptr() + c0 * elt,
            blocked.mask.data_ptr(), out.data_ptr() + c0 * elt, m, d, width,
            dv, dv, blocked.num_windows, h, vsz, k_blk,
            windows_per_warp(blocked.num_windows, blocked.cols.shape[0], h),
            _checks.head_stride(qs, 2), _checks.head_stride(k, 2),
            _checks.head_stride(v, 2), _checks.dtype_code(v),
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check_launch("attention", err)
        attention_cuda.launches += 1
        attention_cuda.variant_launches[_checks.variant(v)] += 1
    return out if batched else out[0]


attention_cuda.launches = 0
attention_cuda.variant_launches = {"fp32": 0, "bf16": 0}


def attention_cuda_staged(blocked: BlockedMEBCRS, q: torch.Tensor,
                          k: torch.Tensor, v: torch.Tensor, *,
                          scale=None) -> torch.Tensor:
    """The three-pass attention of the kernels: the batched SDDMM, the
    sparse softmax (plain PyTorch, as the reference's is XLA), then the
    batched SpMM, one launch each for every head; operands and result as
    :func:`attention_cuda`.  The (``[H,]`` NNZP, V) scores and
    probabilities pass through device memory: the traffic the fused kernel
    keeps on chip.  bf16 operands run the kernels' bf16 variants; the
    softmax runs in fp32 and the probabilities go to V's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = sddmm_batched_cuda(blocked, q, k)
    # the softmax in fp32 whatever the scores' dtype, as the reference's
    # (attention_pallas.py:443); the probabilities in V's
    probs = sparse_softmax(blocked, scores.float() * scale)
    return spmm_batched_cuda(with_values(blocked, probs.to(v.dtype)), v)

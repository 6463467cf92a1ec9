"""Non-coalesced SpMM kernel: ``spmm_noncoalesced_cuda``
(``csrc/spmm_noncoalesced.cu``) and its plain version.

Counterpart of ``repro.kernels.spmm_pallas.spmm_pallas_noncoalesced``,
which launches ``_fused_spmm_kernel`` with serialised per-row fetches: the
baseline of the paper's coalescing ablation (Fig. 15).  The kernel puts
the lanes of a warp on neighbouring windows at one column, so they read B
from different rows, where ``spmm_cuda`` puts them on neighbouring columns
of one row; its output is bitwise-equal to ``spmm_cuda``'s.
``spmm_noncoalesced_cuda`` launches it on CUDA tensors and counts each
launch in ``spmm_noncoalesced_cuda.launches``; on CPU tensors it runs
:func:`spmm_noncoalesced_plain`.  Operands are 2-D, as the reference's.
"""

from __future__ import annotations

import torch

from repro_torch.core.format import BlockedMEBCRS
from repro_torch.core.spmm import _spmm_blocked_impl

from . import _build, _checks

__all__ = ["spmm_noncoalesced_cuda", "spmm_noncoalesced_plain"]


def spmm_noncoalesced_plain(blocked: BlockedMEBCRS,
                            b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``C (M, N) = A @ B``."""
    return _spmm_blocked_impl(blocked, b)


def spmm_noncoalesced_cuda(blocked: BlockedMEBCRS,
                           b: torch.Tensor) -> torch.Tensor:
    """``C (M, N) = A @ B`` over ``blocked`` in fp32 with the non-coalesced
    thread mapping (the lanes of a warp on 32 windows at one column)."""
    op = "spmm_noncoalesced_cuda"
    _checks.forward_inputs(op, vals=blocked.vals, b=b)
    m, k = blocked.shape
    if blocked.vals.dim() != 2 or b.dim() != 2 or b.shape[0] != k:
        raise ValueError(f"{op}: need vals (NNZP, V) and b ({k}, N), got "
                         f"{tuple(blocked.vals.shape)} and {tuple(b.shape)}")
    if _checks.on_cpu(op, win_ptr=blocked.win_ptr, cols=blocked.cols,
                      vals=blocked.vals, b=b):
        return spmm_noncoalesced_plain(blocked, b)
    _checks.kernel_inputs(op, {"win_ptr": blocked.win_ptr, "cols": blocked.cols},
                          {"vals": blocked.vals, "b": b})
    v = blocked.vector_size
    if v not in (8, 16):
        raise ValueError(f"{op}: vector_size {v} not in (8, 16)")
    n = b.shape[1]
    if max(m, n) > _checks.int32_max or -(-n // 4) > 65535:
        raise ValueError(f"{op}: shape too large for the kernel's grid")
    c = torch.empty((m, n), dtype=torch.float32, device=b.device)
    if m == 0 or n == 0:
        return c
    err = _build.library("spmm_noncoalesced").spmm_noncoalesced_f32(
        blocked.win_ptr.data_ptr(), blocked.cols.data_ptr(),
        blocked.vals.data_ptr(), b.data_ptr(), c.data_ptr(), m, n,
        blocked.num_windows, v, blocked.k_blk,
        torch.cuda.current_stream(b.device).cuda_stream)
    _build.check_launch("spmm_noncoalesced", err)
    spmm_noncoalesced_cuda.launches += 1
    return c


spmm_noncoalesced_cuda.launches = 0

"""Non-coalesced SpMM kernel: ``spmm_noncoalesced_cuda``
(``csrc/spmm_noncoalesced.cu``) and its plain version.

Counterpart of ``repro.kernels.spmm_pallas.spmm_pallas_noncoalesced``,
which launches ``_fused_spmm_kernel`` with serialised per-row fetches: the
baseline of the paper's coalescing ablation (Fig. 15).  The kernel puts
the 32 lanes of a warp on 32 slices of windows at one column, so one load
instruction reads B from 32 different rows, where ``spmm_cuda`` puts them
on neighbouring columns of one row.  Everything else is ``spmm_cuda``'s:
the slices of its window plan (a lane plan, ``kernels/_window.py``
:func:`~repro_torch.kernels._window.lane_plan`, windows of more than
``SPLIT_BLK`` K-blocks cut into slices), values and column ids staged in
shared memory, 8 gathers in flight.  On the windows ``spmm_cuda`` does not
split its output is bitwise-equal to ``spmm_cuda``'s, at every precision;
a split window's slice sums are added in a fixed order (a segmented scan
over the lanes, then fp32 partials in run order), so two launches give
the same bits.  ``spmm_noncoalesced_cuda`` launches it on CUDA tensors and
counts each launch in ``spmm_noncoalesced_cuda.launches`` (and per
variant in ``variant_launches``); on CPU tensors it runs
:func:`spmm_noncoalesced_plain`.  Operands are 2-D, as the reference's.

Its variants are ``spmm_cuda``'s (:data:`VARIANTS`): fp32 values and B,
bf16 values and B, or int8 values with the view's per-K-block fp32
``scales`` and fp32 or bf16 B; C comes back in B's dtype, summed in fp32.
"""

from __future__ import annotations

import torch

from repro_torch.core.format import BlockedMEBCRS
from repro_torch.core.spmm import _spmm_blocked_impl

from . import _build, _checks
from ._window import SPLIT_BLK, lane_plan
from .spmm_cuda import VARIANTS, _variant_inputs, wide_index

__all__ = ["spmm_noncoalesced_cuda", "spmm_noncoalesced_plain", "VARIANTS"]


def spmm_noncoalesced_plain(blocked: BlockedMEBCRS,
                            b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``C (M, N) = A @ B``, int8
    values dequantized, sums in fp32, C in B's dtype."""
    return _spmm_blocked_impl(blocked, b)


def spmm_noncoalesced_cuda(blocked: BlockedMEBCRS,
                           b: torch.Tensor) -> torch.Tensor:
    """``C (M, N) = A @ B`` over ``blocked`` (fp32, bf16 or int8 values,
    see :data:`VARIANTS`), C in B's dtype, sums in fp32, with the
    non-coalesced thread mapping (the lanes of a warp on 32 slices at one
    column); windows of more than ``SPLIT_BLK`` K-blocks are split into
    slices, as by ``spmm_cuda``."""
    op = "spmm_noncoalesced_cuda"
    scales = _variant_inputs(op, blocked, b)
    m, k = blocked.shape
    if blocked.vals.dim() != 2 or b.dim() != 2 or b.shape[0] != k:
        raise ValueError(f"{op}: need vals (NNZP, V) and b ({k}, N), got "
                         f"{tuple(blocked.vals.shape)} and {tuple(b.shape)}")
    v = _checks.vector_size(op, blocked)
    n = b.shape[1]
    if max(m, n) > _checks.int32_max or -(-n // 128) > 65535:
        raise ValueError(f"{op}: shape too large for the kernel's grid")
    tensors = dict(win_ptr=blocked.win_ptr, cols=blocked.cols,
                   vals=blocked.vals, b=b)
    if scales is not None:
        tensors["scales"] = scales
    if _checks.on_cpu(op, **tensors):
        return spmm_noncoalesced_plain(blocked, b)
    _checks.kernel_inputs(op, {"win_ptr": blocked.win_ptr, "cols": blocked.cols},
                          {k_: t for k_, t in tensors.items()
                           if k_ not in ("win_ptr", "cols")})
    c = torch.empty((m, n), dtype=b.dtype, device=b.device)
    if m == 0 or n == 0:
        return c
    plan = lane_plan(op, blocked.win_ptr, SPLIT_BLK)
    part = torch.empty((plan.num_partials, v, n), dtype=torch.float32,
                       device=b.device)              # split windows' runs
    err = _build.library("spmm_noncoalesced").spmm_noncoalesced_launch(
        plan.slice_ptr.data_ptr(), plan.slice_win.data_ptr(),
        plan.slice_out.data_ptr(), blocked.cols.data_ptr(),
        blocked.vals.data_ptr(), 0 if scales is None else scales.data_ptr(),
        b.data_ptr(), c.data_ptr(), part.data_ptr() if part.numel() else 0,
        plan.part_win.data_ptr(), plan.part_ptr.data_ptr(), m, n,
        plan.num_slices, plan.num_part_windows, v, blocked.k_blk,
        _checks.dtype_code(blocked.vals), _checks.dtype_code(b),
        int(wide_index(k * n, blocked.vals.shape[-2] * v)),
        torch.cuda.current_stream(b.device).cuda_stream)
    _build.check_launch("spmm_noncoalesced", err)
    spmm_noncoalesced_cuda.launches += 1
    spmm_noncoalesced_cuda.variant_launches[_checks.variant(blocked.vals)] += 1
    return c


spmm_noncoalesced_cuda.launches = 0
spmm_noncoalesced_cuda.variant_launches = {"fp32": 0, "bf16": 0, "int8": 0}

"""Schedule-driven SDDMM kernel: ``sddmm_balanced_cuda``
(``csrc/sddmm_balanced.cu``) and its plain version.

Counterpart of ``repro.kernels.sddmm_pallas.sddmm_pallas_balanced``, which
launches ``_balanced_sddmm_kernel``: SDDMM over the
:class:`~repro_torch.core.format.Schedule`'s block list, so a zero-block
schedule (the all-empty matrix) returns zeros without a launch.
``sddmm_balanced_cuda`` launches the hand-written kernel on CUDA tensors
and counts each launch in ``sddmm_balanced_cuda.launches``; on CPU tensors
it runs :func:`sddmm_balanced_plain`.

``q`` may be ``(M, F)`` or ``(H, M, F)`` and ``k`` ``(Mc, F)`` or
``(H, Mc, F)``; a 2-D operand is shared by every head, and 2-D in gives
``(NNZP, V)`` out, else ``(H, NNZP, V)``.  Q and K are both float32 or
both bfloat16 (``sddmm_cuda``'s variants): fp32 dots, S in Q's dtype;
``sddmm_balanced_cuda.variant_launches`` counts each variant's launches.
"""

from __future__ import annotations

import torch

from repro_torch.core.format import BlockedMEBCRS, Schedule

from . import _build, _checks
from .sddmm_cuda import VARIANTS

__all__ = ["sddmm_balanced_cuda", "sddmm_balanced_plain"]


def sddmm_balanced_plain(blocked: BlockedMEBCRS, q: torch.Tensor,
                         k: torch.Tensor, schedule: Schedule) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``mask ⊙ (Q Kᵀ)`` at the
    scheduled blocks, zeros elsewhere, in the blocked layout; narrow
    operands widened, fp32 dots, S in Q's dtype."""
    q3 = q if q.dim() == 3 else q[None]
    k3 = k if k.dim() == 3 else k[None]
    h = max(q3.shape[0], k3.shape[0])
    v, k_blk, w = blocked.vector_size, blocked.k_blk, blocked.num_windows
    f = q3.shape[-1]
    out = torch.zeros((h, blocked.cols.shape[0], v), dtype=torch.float32,
                      device=q.device)
    if schedule.num_blocks:
        blk = schedule.blk_id.long()
        nsb = blk.shape[0]
        rows = (blk[:, None] * k_blk
                + torch.arange(k_blk, device=blk.device)).reshape(-1)
        qpad = torch.zeros((q3.shape[0], w * v, f), dtype=torch.float32,
                           device=q.device)
        qpad[:, : q3.shape[1]] = q3
        kg = k3.float()[:, blocked.cols.long()[rows]].reshape(
            k3.shape[0], nsb, k_blk, f).expand(h, -1, -1, -1)
        qg = qpad.reshape(q3.shape[0], w, v, f)[
            :, schedule.blk_win.long()].expand(h, -1, -1, -1)
        scores = torch.einsum("hbkf,hbvf->hbkv", kg, qg).reshape(h, -1, v)
        out[:, rows] = scores * blocked.mask[rows]
    out = out.to(q.dtype)
    return out if (q.dim() == 3 or k.dim() == 3) else out[0]


def sddmm_balanced_cuda(blocked: BlockedMEBCRS, q: torch.Tensor,
                        k: torch.Tensor, *, schedule: Schedule | None = None,
                        split_blk: int = 1) -> torch.Tensor:
    """Sampled ``Q Kᵀ`` at ``blocked``'s pattern over ``schedule``'s block
    list (built with ``split_blk`` when omitted), fp32 or bf16 operands
    with fp32 dots, as blocked-layout values in Q's dtype."""
    op = "sddmm_balanced_cuda"
    if schedule is None:
        schedule = blocked.schedule(split_blk)
    _checks.forward_inputs(op, VARIANTS, q=q, k=k)
    h, batched = _checks.heads(op, q=(q, 2), k=(k, 2))
    if schedule.num_blocks == 0:
        # A zero-block schedule (the all-empty matrix): zeros without a
        # launch, as the reference.
        out = torch.zeros((h, blocked.cols.shape[0], blocked.vector_size),
                          dtype=q.dtype, device=q.device)
        return out if batched else out[0]
    tensors = dict(blk_id=schedule.blk_id, blk_win=schedule.blk_win,
                   cols=blocked.cols, mask=blocked.mask, q=q, k=k)
    if _checks.on_cpu(op, **tensors):
        return sddmm_balanced_plain(blocked, q, k, schedule)
    _checks.kernel_inputs(
        op, {k_: tensors[k_] for k_ in ("blk_id", "blk_win", "cols")},
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
    if max(m, mc, q.shape[-1], schedule.num_blocks) > _checks.int32_max \
            or h > 65535:
        raise ValueError(f"{op}: shape too large for the kernel's grid")
    if schedule.num_blocks != blocked.num_blocks:
        raise ValueError(f"{op}: the schedule is not this view's "
                         f"({schedule.num_blocks} scheduled blocks, "
                         f"{blocked.num_blocks} in the view)")
    # every block of a non-empty view is scheduled, so every row is written
    out = torch.empty((h, nnzp, v), dtype=q.dtype, device=q.device)
    err = _build.library("sddmm_balanced").sddmm_balanced_launch(
        schedule.blk_id.data_ptr(), schedule.blk_win.data_ptr(),
        blocked.cols.data_ptr(), q.data_ptr(), k.data_ptr(),
        blocked.mask.data_ptr(), out.data_ptr(), m, q.shape[-1],
        schedule.num_blocks, h, v, blocked.k_blk, _checks.head_stride(q, 2),
        _checks.head_stride(k, 2), nnzp * v, _checks.dtype_code(q),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch("sddmm_balanced", err)
    sddmm_balanced_cuda.launches += 1
    sddmm_balanced_cuda.variant_launches[_checks.variant(q)] += 1
    return out if batched else out[0]


sddmm_balanced_cuda.launches = 0
sddmm_balanced_cuda.variant_launches = {"fp32": 0, "bf16": 0}

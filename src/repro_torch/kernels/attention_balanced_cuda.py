"""Load-balanced fused sparse-attention kernel: ``attention_balanced_cuda``
(``csrc/attention_balanced.cu``) and its plain version.

Counterpart of ``repro.kernels.attention_pallas.attention_pallas_balanced``,
which launches ``_balanced_attn_kernel``: the single-pass SDDMM → online
softmax → SpMM of ``attention_cuda`` over a
:class:`~repro_torch.core.format.Schedule`'s segments.  The kernel
carries a window's softmax state across the segments of a run (a
:class:`~repro_torch.kernels._combine.RunPlan` of about ``RUN_BLK``
K-blocks) and merges the pieces of a window that runs cut by log-sum-exp.
``attention_balanced_cuda`` launches the hand-written kernel on CUDA
tensors and counts each launch in ``attention_balanced_cuda.launches``; on
CPU tensors it runs :func:`attention_balanced_plain`, which computes each
(run, window) piece's row maxima, row sums and unnormalised output and
merges them per window as the kernel does.

``q``, ``k`` and ``v`` may each carry a leading head dimension; a 2-D
operand is shared by every head, and all 2-D in gives ``(M, DV)`` out.
Q, K and V are all float32 or all bfloat16 (``attention_cuda``'s
variants; the reference's bf16 path): Q is scaled in fp32 and rounded to
its dtype before the launch, the scores, the softmax statistics and every
sum are the fp32 kernel's, and the output is rounded once to V's dtype;
``attention_balanced_cuda.variant_launches`` counts each variant's
launches.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.format import BlockedMEBCRS, Schedule

from . import _build, _checks
from ._combine import run_plan
from .attention_cuda import VARIANTS
from .spmm_balanced_cuda import piece_blocks

__all__ = ["RUN_BLK", "attention_balanced_cuda", "attention_balanced_plain"]

# K-blocks per run of the kernel (chip_smoke.py phase 5 sweeps it).
RUN_BLK = 16


def attention_balanced_plain(blocked: BlockedMEBCRS, q: torch.Tensor,
                             k: torch.Tensor, v: torch.Tensor,
                             schedule: Schedule, scale=None,
                             run_blk: int = RUN_BLK) -> torch.Tensor:
    """Plain PyTorch version of the kernel: Q scaled in fp32 and rounded to
    its dtype, then per (run, window) piece the row maxima, row sums and
    unnormalised output in fp32, then each window's pieces merged by
    log-sum-exp with the sums in fp64, the output in V's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    q3, k3, v3 = (t if t.dim() == 3 else t[None] for t in (q, k, v))
    h = max(q3.shape[0], k3.shape[0], v3.shape[0])
    vsz, k_blk, w = blocked.vector_size, blocked.k_blk, blocked.num_windows
    d, dv = q3.shape[-1], v3.shape[-1]
    dev = q.device
    neg = torch.finfo(torch.float32).min
    plan = run_plan("attention_balanced_plain", schedule, w, run_blk)
    npc = plan.num_pieces
    blk, blk_piece = piece_blocks(plan)
    piece_win = plan.pieces[:, 0].long()
    nsb = blk.shape[0]
    rows = (blk[:, None] * k_blk + torch.arange(k_blk, device=dev)).reshape(-1)
    cols = blocked.cols.long()[rows]
    qpad = torch.zeros((q3.shape[0], w * vsz, d), dtype=torch.float32,
                       device=dev)
    qpad[:, : q3.shape[1]] = (q3.float() * scale).to(q.dtype)
    qg = qpad.reshape(q3.shape[0], w, vsz, d)[:, piece_win[blk_piece]]
    kg = k3.float()[:, cols].reshape(k3.shape[0], nsb, k_blk, d)
    vg = v3.float()[:, cols].reshape(
        v3.shape[0], nsb, k_blk, dv).expand(h, -1, -1, -1)
    mask = blocked.mask[rows].reshape(nsb, k_blk, vsz)
    s = torch.einsum("hbkd,hbvd->hbkv", kg.expand(h, -1, -1, -1),
                     qg.expand(h, -1, -1, -1))
    s = torch.where(mask, s, neg)
    # Per piece: row maxima, row sums and the unnormalised output.
    idx = blk_piece[None, :, None].expand(h, -1, vsz)
    m_pc = torch.full((h, npc, vsz), neg, device=dev).scatter_reduce(
        1, idx, s.amax(dim=2), "amax")
    p = torch.exp(s - m_pc[:, blk_piece][:, :, None, :]) * mask
    l_pc = torch.zeros((h, npc, vsz), device=dev).index_add_(1, blk_piece,
                                                             p.sum(dim=2))
    acc_pc = torch.zeros((h, npc, vsz, dv), device=dev).index_add_(
        1, blk_piece, torch.einsum("hbkv,hbkd->hbvd", p, vg))
    # Per window: the log-sum-exp merge of its pieces, summed in fp64 as
    # the kernel's combine tree.
    m_win = torch.full((h, w, vsz), neg, device=dev).scatter_reduce(
        1, piece_win[None, :, None].expand(h, -1, vsz), m_pc, "amax")
    e = torch.exp(m_pc - m_win[:, piece_win]).double()
    l_win = torch.zeros((h, w, vsz), dtype=torch.float64,
                        device=dev).index_add_(1, piece_win, l_pc * e)
    acc_win = torch.zeros((h, w, vsz, dv), dtype=torch.float64,
                          device=dev).index_add_(1, piece_win,
                                                 acc_pc * e[..., None])
    out = (acc_win.float()
           / torch.clamp(l_win.float(), min=1e-20)[..., None])
    out = out.reshape(h, w * vsz, dv)[:, : blocked.shape[0]].to(v.dtype)
    return out if (q.dim() == 3 or k.dim() == 3 or v.dim() == 3) else out[0]


def attention_balanced_cuda(blocked: BlockedMEBCRS, q: torch.Tensor,
                            k: torch.Tensor, v: torch.Tensor, *, scale=None,
                            schedule: Schedule | None = None,
                            split_blk: int = 1,
                            run_blk: int = RUN_BLK) -> torch.Tensor:
    """``softmax_rows(scale · mask ⊙ Q Kᵀ) @ V`` over ``blocked``'s pattern,
    block-parallel over ``schedule`` (built with ``split_blk`` when
    omitted) in runs of about ``run_blk`` K-blocks: ``q ([H,] M, D)``,
    ``k ([H,] Mc, D)``, ``v ([H,] Mc, DV)`` → ``([H,] M, DV)`` in V's
    dtype (fp32 or bf16 operands).  ``scale`` (default ``1/sqrt(D)``) may
    be a 0-d tensor; it is folded into Q before the launch, in fp32 and
    rounded to Q's dtype."""
    op = "attention_balanced_cuda"
    if schedule is None:
        schedule = blocked.schedule(split_blk)
    if isinstance(scale, torch.Tensor):
        _checks.forward_inputs(op, tuple(x + (scale.dtype,) for x in VARIANTS),
                               q=q, k=k, v=v, scale=scale)
    else:
        _checks.forward_inputs(op, VARIANTS, q=q, k=k, v=v)
    h, batched = _checks.heads(op, q=(q, 2), k=(k, 2), v=(v, 2))
    if _checks.on_cpu(op, seg_win=schedule.seg_win,
                      seg_meta=schedule.seg_meta, cols=blocked.cols,
                      mask=blocked.mask, q=q, k=k, v=v):
        return attention_balanced_plain(blocked, q, k, v, schedule, scale,
                                        run_blk)
    plan = run_plan(op, schedule, blocked.num_windows, run_blk)
    tree = plan.tree
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
    if max(m, plan.num_runs) > _checks.int32_max or h > 65535:
        raise ValueError(f"{op}: shape too large for the kernel's grid")
    d, dv = q.shape[-1], v.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qs = (q.float() * scale).to(q.dtype)
    _checks.kernel_inputs(
        op, {"run_ptr": plan.run_ptr, "pieces": plan.pieces,
             "tree_meta": tree.meta, "cols": blocked.cols},
        {"mask": blocked.mask, "q": qs, "k": k, "v": v})
    out = torch.empty((h, m, dv), dtype=v.dtype, device=q.device)
    if m == 0 or dv == 0:
        return out if batched else out[0]
    # Scratch of the combine tree: each run edge's (acc, m, l) in fp32, and
    # the entries of its upper levels with acc and l in fp64 (none when no
    # run cuts a window).
    scratch = []
    for entries, dtype in ((plan.entries, torch.float32),
                           (tree.entries, torch.float64)):
        scratch += ([torch.empty(shape, dtype=dt, device=q.device)
                     for shape, dt in (((h, entries, vsz, dv), dtype),
                                       ((h, entries, vsz), torch.float32),
                                       ((h, entries, vsz), dtype))]
                    if entries else [None] * 3)
    ptrs = [None if t is None else t.data_ptr() for t in scratch]
    err = _build.library("attention_balanced").attention_balanced_launch(
        plan.run_ptr.data_ptr(), plan.pieces.data_ptr(),
        tree.meta.data_ptr(), blocked.cols.data_ptr(),
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), blocked.mask.data_ptr(),
        out.data_ptr(), *ptrs, m, d, dv, plan.num_runs, h, vsz,
        blocked.k_blk, _checks.head_stride(qs, 2), _checks.head_stride(k, 2),
        _checks.head_stride(v, 2), _build.host_ints(tree.level_ints()),
        len(tree.levels), plan.entries, tree.entries, _checks.dtype_code(v),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch("attention_balanced", err)
    attention_balanced_cuda.launches += 1
    attention_balanced_cuda.variant_launches[_checks.variant(v)] += 1
    return out if batched else out[0]


attention_balanced_cuda.launches = 0
attention_balanced_cuda.variant_launches = {"fp32": 0, "bf16": 0}

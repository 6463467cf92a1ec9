"""Overlapped multi-device sparse ops: segment batches on a send/recv ring.

Counterpart of ``repro.distributed.sparse_shard_overlap`` (DESIGN.md
§14).  ``cuda_sharded`` (:mod:`.sparse_shard`) finishes a rank's whole
launch before one ``all_reduce`` reassembles the output, so the
collective sits on the critical path.  ``cuda_sharded_overlap`` hides it:

  * each rank's segment range is cut into ``n_batches`` cost-balanced
    segment batches (``partition_schedule(..., n_batches=)``), one
    balanced launch per batch over the batch's rank-local schedule;
  * each batch's **compact partial**, only the rows its windows own with
    their global row ids, travels the data group's ring
    (:func:`~repro_torch.distributed.overlap.ring_scatter_pipeline`)
    while the next batch computes, and is scatter-added on arrival;
  * every rank folds every (origin rank, batch) partial once, so the
    result is the bulk op's up to fp32 summation order.

Attention batches are window-aligned (``window_split=False`` partitions
only), so a window's online softmax never crosses a step.  The model-dim
modes are the bulk ops'; the ring runs over the data group only.  Narrow
partials travel in their dtype and are summed into an fp32 accumulator,
rounded once.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core import dispatch as _dispatch
from repro_torch.core.format import Schedule
from repro_torch.core.quantize import cast_precision
from repro_torch.core.spmm import apply_precision

from .overlap import ring_scatter_pipeline
from .sparse_shard import (ShardedSchedule, _attention_mode, _data_rank,
                           _dense_model_split, _model_join, _prepare,
                           _reduce, _sddmm_mode, _spmm_mode,
                           _spmm_model_split, sharded_schedule)

__all__ = [
    "spmm_sharded_overlap",
    "sddmm_sharded_overlap",
    "attention_sharded_overlap",
]


def _check_batched(part: ShardedSchedule) -> None:
    if part.bseg_win is None:
        raise ValueError(
            "overlap ops need a segment-batched partition: rebuild it via "
            "partition_schedule(..., n_batches=...) / sharded_schedule")


def _gather_rows(out: torch.Tensor, idx: torch.Tensor,
                 n_rows: int) -> torch.Tensor:
    """Compact ``(H, R, C)`` slice of ``out``'s rows listed in ``idx``;
    pad entries (``idx == n_rows``) come out zero, so the buffer can be
    sent and scatter-added blindly."""
    valid = idx < n_rows
    g = out[:, idx.clamp(max=max(n_rows - 1, 0)).long()]
    return torch.where(valid[None, :, None], g, torch.zeros((), dtype=g.dtype,
                                                            device=g.device))


def _scatter_rows(acc: torch.Tensor, buf: torch.Tensor,
                  idx: torch.Tensor) -> torch.Tensor:
    """Scatter-add a compact partial into ``acc`` (fp32 or the partial's
    dtype); pads (zero rows) land harmlessly on the last row."""
    safe = idx.clamp(max=acc.shape[1] - 1).long()
    return acc.index_add_(1, safe, buf.to(acc.dtype))


def _ring(compute, acc_shape, dtype, device, mesh, n_batches):
    """Run the ring over the data group into an fp32 accumulator (the
    partials' own dtype when fp32) and return it in ``dtype``."""
    acc = torch.zeros(acc_shape, dtype=torch.float32, device=device)
    acc = ring_scatter_pipeline(compute, _scatter_rows, acc,
                                group=mesh.get_group("data"),
                                n_batches=n_batches)
    return acc.to(dtype)


def _three(x: torch.Tensor) -> torch.Tensor:
    return x if x.dim() == 3 else x[None]


def spmm_sharded_overlap(fmt, b: torch.Tensor, *,
                         mesh: Optional[DeviceMesh] = None,
                         part: Optional[ShardedSchedule] = None,
                         schedule: Optional[Schedule] = None,
                         split_blk: int = 1, k_blk: int = 8,
                         n_blk: int = 128, n_batches: int = 2,
                         precision: Optional[str] = None) -> torch.Tensor:
    """Overlapped multi-rank SpMM: a balanced launch per segment batch and
    the ring in place of the ``all_reduce``.  The contract of
    :func:`~repro_torch.distributed.sparse_shard.spmm_sharded`;
    ``n_batches`` is the pipeline depth when ``part`` is not given (else
    the partition's own)."""
    from repro_torch.kernels.spmm_balanced_cuda import spmm_balanced_cuda

    blocked, mesh, part = _prepare(
        "spmm_sharded_overlap", fmt, mesh, part, k_blk, b.device,
        lambda bl, d: sharded_schedule(bl, d, split_blk=split_blk,
                                       n_blk=n_blk, n_batches=n_batches,
                                       schedule=schedule), b)
    _check_batched(part)
    blocked, b = apply_precision(blocked, b, precision)
    mode = _spmm_mode(mesh, blocked.vals, b)
    blocked, b = _spmm_model_split(mesh, blocked, b, mode)
    b = b.contiguous()
    rank, m = _data_rank(mesh), blocked.shape[0]
    batched = blocked.vals.dim() == 3 or b.dim() == 3
    h = max(_three(blocked.vals).shape[0], _three(b).shape[0])

    def compute(t):
        out = spmm_balanced_cuda(blocked, b,
                                 schedule=part.local_batch(rank, t),
                                 n_blk=n_blk)
        idx = part.brow_idx[rank, t]
        return _gather_rows(_three(out), idx, m), idx

    out = _ring(compute, (h, m, b.shape[-1]), b.dtype, b.device, mesh,
                part.n_batches)
    return _model_join(out if batched else out[0], mesh, mode)


def sddmm_sharded_overlap(fmt, q: torch.Tensor, k: torch.Tensor, *,
                          mesh: Optional[DeviceMesh] = None,
                          part: Optional[ShardedSchedule] = None,
                          schedule: Optional[Schedule] = None,
                          split_blk: int = 1, k_blk: int = 8,
                          f_blk: int = 128, n_batches: int = 2,
                          precision: Optional[str] = None) -> torch.Tensor:
    """Overlapped multi-rank SDDMM → blocked values ``([H,] NNZP, V)``.
    Value rows belong to one (rank, batch) each, so the ring's
    scatter-adds place each once; the ``feat`` mode still sums the
    partial products over the model group after the ring."""
    from repro_torch.kernels.sddmm_balanced_cuda import sddmm_balanced_cuda

    q, k = cast_precision(precision, q, k)
    blocked, mesh, part = _prepare(
        "sddmm_sharded_overlap", fmt, mesh, part, k_blk, q.device,
        lambda bl, d: sharded_schedule(bl, d, split_blk=split_blk,
                                       n_blk=f_blk, n_batches=n_batches,
                                       schedule=schedule), q, k)
    _check_batched(part)
    batched = q.dim() == 3 or k.dim() == 3
    h = max(_three(q).shape[0], _three(k).shape[0])
    nnzp, v = blocked.cols.shape[0], blocked.vector_size
    if part.num_blocks == 0:                     # all-empty pattern
        out = torch.zeros((h, nnzp, v), dtype=q.dtype, device=q.device)
        return out if batched else out[0]
    mode = _sddmm_mode(mesh, q, k)
    q_l, k_l = _dense_model_split(mesh, mode, q, k)
    rank = _data_rank(mesh)
    h_l = max(_three(q_l).shape[0], _three(k_l).shape[0])

    def compute(t):
        out = sddmm_balanced_cuda(blocked, q_l, k_l,
                                  schedule=part.local_batch(rank, t))
        idx = part.bval_idx[rank, t]
        return _gather_rows(_three(out), idx, nnzp), idx

    out = _ring(compute, (h_l, nnzp, v), q.dtype, q.device, mesh,
                part.n_batches)
    out = out if batched else out[0]
    if mode == "feat":
        return _reduce(out, mesh.get_group("model"))
    return _model_join(out, mesh, mode)


def attention_sharded_overlap(fmt, q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *,
                              mesh: Optional[DeviceMesh] = None,
                              part: Optional[ShardedSchedule] = None,
                              schedule: Optional[Schedule] = None,
                              split_blk: int = 1, k_blk: int = 8,
                              scale=None, n_batches: int = 2,
                              precision: Optional[str] = None
                              ) -> torch.Tensor:
    """Overlapped multi-rank fused attention on a window-aligned
    partition: each batch's windows hold whole softmax rows, so the
    ring's scatter places rows, it sums nothing."""
    from repro_torch.kernels.attention_balanced_cuda import (
        attention_balanced_cuda)

    q, k, v = cast_precision(precision, q, k, v)
    blocked, mesh, part = _prepare(
        "attention_sharded_overlap", fmt, mesh, part, k_blk, q.device,
        lambda bl, d: sharded_schedule(bl, d, split_blk=split_blk,
                                       window_split=False,
                                       n_batches=n_batches,
                                       schedule=schedule), q, k, v,
        window_aligned=True)
    _check_batched(part)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    mode = _attention_mode(mesh, q, k, v)
    q_l, k_l, v_l = _dense_model_split(mesh, mode, q, k, v)
    rank, m = _data_rank(mesh), blocked.shape[0]
    batched = any(x.dim() == 3 for x in (q, k, v))
    h = max(_three(x).shape[0] for x in (q_l, k_l, v_l))

    def compute(t):
        out = attention_balanced_cuda(blocked, q_l, k_l, v_l, scale=scale,
                                      schedule=part.local_batch(rank, t))
        idx = part.brow_idx[rank, t]
        return _gather_rows(_three(out), idx, m), idx

    out = _ring(compute, (h, m, v.shape[-1]), v.dtype, v.device, mesh,
                part.n_batches)
    return _model_join(out if batched else out[0], mesh, mode)


# ---------------------------------------------------------------------------
# Registry adapters: impl "cuda_sharded_overlap" (the overlapped flag on
# top of cuda_sharded's).  The autodiff layer passes each direction's
# batched partition; ``n_batches`` matters only when the partition is
# built here.
# ---------------------------------------------------------------------------


def _spmm_overlap_adapter(fmt, b, *, k_blk=8, n_blk=128, split_blk=1,
                          schedule=None, mesh=None, part=None, n_batches=2):
    return spmm_sharded_overlap(fmt, b, mesh=mesh, part=part,
                                schedule=schedule, split_blk=split_blk,
                                k_blk=k_blk, n_blk=n_blk,
                                n_batches=n_batches)


def _sddmm_overlap_adapter(fmt, q, k, *, k_blk=8, f_blk=128, split_blk=1,
                           schedule=None, mesh=None, part=None, n_batches=2):
    return sddmm_sharded_overlap(fmt, q, k, mesh=mesh, part=part,
                                 schedule=schedule, split_blk=split_blk,
                                 k_blk=k_blk, f_blk=f_blk or 128,
                                 n_batches=n_batches)


def _attention_overlap_adapter(fmt, q, k, v, *, scale=None, k_blk=8,
                               split_blk=1, schedule=None, mesh=None,
                               part=None, n_batches=2):
    return attention_sharded_overlap(fmt, q, k, v, mesh=mesh, part=part,
                                     schedule=schedule, split_blk=split_blk,
                                     k_blk=k_blk, scale=scale,
                                     n_batches=n_batches)


_dispatch.register("spmm", "cuda_sharded_overlap", _spmm_overlap_adapter,
                   differentiable=True, batched=True, load_balanced=True,
                   multi_device=True, overlapped=True,
                   precisions=("fp32", "bf16", "int8"))
_dispatch.register("sddmm", "cuda_sharded_overlap", _sddmm_overlap_adapter,
                   differentiable=True, batched=True, load_balanced=True,
                   multi_device=True, overlapped=True,
                   precisions=("fp32", "bf16"))
_dispatch.register("attention", "cuda_sharded_overlap",
                   _attention_overlap_adapter,
                   differentiable=True, batched=True, load_balanced=True,
                   multi_device=True, overlapped=True,
                   precisions=("fp32", "bf16"))

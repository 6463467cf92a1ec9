"""Communication/compute overlap for the sharded sparse path.

Counterpart of ``repro.distributed.overlap``'s ``ring_scatter_pipeline``
(DESIGN.md §14), with the reference's ``ppermute`` ring as point-to-point
sends and receives (``torch.distributed.batch_isend_irecv``) to the next
rank of a process group.  (The reference's dense collective-matmul demo
belongs to its LM stack.)
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.distributed as dist

__all__ = ["ring_scatter_pipeline"]


def _hop(part: Tuple[torch.Tensor, ...], nxt: int, prv: int, group):
    """Start one ring hop of ``part``: each tensor goes to rank ``nxt``
    while a buffer of its shape fills from rank ``prv``.  Returns the
    receive buffers and the requests to wait on."""
    recv = tuple(torch.empty_like(x) for x in part)
    ops = [op for x, r in zip(part, recv)
           for op in (dist.P2POp(dist.isend, x, nxt, group),
                      dist.P2POp(dist.irecv, r, prv, group))]
    return recv, dist.batch_isend_irecv(ops)


def ring_scatter_pipeline(compute: Callable[[int], Tuple[torch.Tensor, ...]],
                          scatter: Callable[..., torch.Tensor],
                          acc: torch.Tensor, *, group=None,
                          n_batches: int) -> torch.Tensor:
    """Pipelined ring scatter-accumulate over ``n_batches`` local batches.

    ``compute(b)`` gives this rank's compact partial of batch ``b``, a
    tuple of tensors of one shape on every rank (a row buffer and its row
    index); ``scatter(acc, *partial)`` folds one partial, computed here
    or just arrived, into the accumulator.  Each step computes one batch
    while the partials sent in the step before travel one hop (the sends
    are issued before the next batch's compute and waited on after it:
    two live buffers), and every partial makes ``group size - 1`` hops,
    so each rank folds each (origin, batch) partial exactly once: the
    result equals the bulk ``all_reduce`` up to fp32 summation order.
    A one-rank ``group`` (or none) is a plain local loop.
    """
    if n_batches < 1:
        raise ValueError(f"n_batches must be >= 1, got {n_batches}")
    size = 1 if group is None else dist.get_world_size(group)
    if size > 1:
        ranks = dist.get_process_group_ranks(group)
        me = dist.get_rank(group)
        nxt, prv = ranks[(me + 1) % size], ranks[(me - 1) % size]
    inflight = []    # [(receive buffers, requests, hops once arrived)]
    step = 0
    while step < n_batches or inflight:
        fresh = None
        if step < n_batches:
            fresh = tuple(compute(step))
            acc = scatter(acc, *fresh)
        live = []
        for recv, reqs, hops in inflight:
            for req in reqs:
                req.wait()
            acc = scatter(acc, *recv)
            if hops < size - 1:
                live.append((recv, hops))
        if fresh is not None and size > 1:
            live.append((fresh, 0))
        inflight = [(*_hop(part, nxt, prv, group), hops + 1)
                    for part, hops in live]
        step += 1
    return acc

"""Communication/compute overlap primitives.

Counterpart of ``repro.distributed.overlap``, with the reference's
``ppermute`` ring as point-to-point sends and receives
(``torch.distributed.batch_isend_irecv``) between neighbouring ranks of
a process group:

  * :func:`ring_scatter_pipeline`, the ring that the overlapped sparse
    ops (``sparse_shard_overlap``) use in place of a bulk all-reduce
    (DESIGN.md §14);
  * :func:`ring_allgather_matmul` / :func:`collective_matmul`, the dense
    demo of the pattern (a ring all-gather of the contracted shards
    overlapped with the partial products); ``distributed/
    collective_matmul.py`` re-exports them.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["ring_scatter_pipeline", "ring_allgather_matmul",
           "ring_matmul_step", "collective_matmul"]


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


# ---------------------------------------------------------------------------
# Dense demo: ring all-gather overlapped with partial matmuls (Wang et al.,
# ASPLOS'23 style).
# ---------------------------------------------------------------------------


def ring_matmul_step(acc: torch.Tensor, chunk: torch.Tensor,
                     w: torch.Tensor, src: int) -> torch.Tensor:
    """One step of :func:`ring_allgather_matmul`: ``acc`` plus ``chunk``
    (the contracted shard of rank ``src``, (..., K/n)) times its rows of
    ``w`` (K, N/n), products and sum in fp32."""
    k = chunk.shape[-1]
    return acc + chunk.float() @ w[src * k:(src + 1) * k].float()


def ring_allgather_matmul(x_shard: torch.Tensor, w: torch.Tensor,
                          group=None) -> torch.Tensor:
    """Per-rank body: x logically (..., K) split on K over the ranks of
    ``group`` (``x_shard`` is this rank's), ``w`` (K, N/n) resident.  At
    step s the rank holds the shard of rank ``(me + s) % n`` and adds its
    product (:func:`ring_matmul_step`); the hop that brings the next
    shard (each rank sends to the rank before it) is started before the
    product and waited on after it.  Returns (..., N/n) in ``x``'s dtype.
    Not differentiable (the hops are point-to-point sends)."""
    n = 1 if group is None else dist.get_world_size(group)
    me = 0 if group is None else dist.get_rank(group)
    if n > 1:
        ranks = dist.get_process_group_ranks(group)
        nxt, prv = ranks[(me + 1) % n], ranks[(me - 1) % n]
    acc = torch.zeros(x_shard.shape[:-1] + (w.shape[1],),
                      dtype=torch.float32, device=x_shard.device)
    chunk = x_shard.contiguous()
    for s in range(n):
        hop = _hop((chunk,), prv, nxt, group) if s < n - 1 else None
        acc = ring_matmul_step(acc, chunk, w, (me + s) % n)
        if hop is not None:
            (chunk,), reqs = hop
            for req in reqs:
                req.wait()
    return acc.to(x_shard.dtype)


def collective_matmul(x: torch.Tensor, w: torch.Tensor, mesh,
                      contract_axis: str = "data",
                      out_axis: Optional[str] = "model") -> torch.Tensor:
    """y = x @ w with a ring-overlapped gather of x's contracted shards.

    x: (..., K), laid out (..., contract_axis); w: (K, N), laid out
    (None, out_axis); both DTensors on ``mesh`` (plain tensors are taken
    as replicated).  Returns y (..., N), a DTensor laid out (...,
    out_axis).  A contract axis of size 1 is a plain product, in fp32,
    cast to x's dtype.
    """
    from torch.distributed.tensor import DTensor, Replicate

    from .sharding import placements

    names = list(mesh.mesh_dim_names)
    n = mesh.size(names.index(contract_axis))
    if n == 1:
        return (x.float() @ w.float()).to(x.dtype)

    def local(t, spec):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, placements(spec, mesh)).to_local()

    lead = (None,) * (x.dim() - 1)
    y = ring_allgather_matmul(local(x, lead + (contract_axis,)),
                              local(w, (None, out_axis)),
                              group=mesh.get_group(contract_axis))
    return DTensor.from_local(y, mesh, placements(lead + (out_axis,), mesh),
                              run_check=False)

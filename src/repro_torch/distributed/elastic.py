"""Elastic resharding: re-lay a train state onto a different mesh.

Counterpart of ``repro.distributed.elastic``.  When ranks fail, the job
restarts on whatever mesh is still healthy; growing is the same
operation.  Checkpoints hold global arrays (``train/checkpoint.py``: a
sharded state is saved through ``DTensor.full_tensor()``), so resuming
is: load the global tensors, compute the specs for the *new* mesh with
the same logical rules, and lay each leaf out by them.  Nothing here
depends on the old mesh's shape.

A leaf that is a ``DTensor`` on another mesh is first made whole
(a collective of the old mesh's ranks, and a broadcast when the new mesh
has ranks the old one lacks: every rank of the process group calls
:func:`reshard_state`), then each rank keeps its own slice of the whole
value, with no further communication (``distribute_tensor(...,
src_data_rank=None)``).  A rank outside the new mesh keeps an empty
local shard, as DTensor does.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.pytree import leaf_paths, unflatten

from .sharding import (param_shardings, placements, shardings_like,
                       spec_paths)

__all__ = ["reshard_state", "reshard_tree", "whole"]

_MOMENTS = ("m", "v", "m_scale", "v_scale")


def whole(t: torch.Tensor) -> torch.Tensor:
    """The global value of ``t``: ``full_tensor()`` of a DTensor (a
    collective over its mesh), ``t`` itself otherwise."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _global(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t``'s global value on every rank of ``mesh``.  When ``mesh`` has
    ranks outside ``t``'s own mesh (growing), the value is broadcast from
    the first rank of ``t``'s mesh over the process group, whose ranks
    all call."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t
    old = t.device_mesh
    inside = old.get_coordinate() is not None
    full = t.full_tensor() if inside else None
    if set(mesh.mesh.flatten().tolist()) <= set(old.mesh.flatten().tolist()):
        return full if inside else t.to_local()
    if full is None:
        full = torch.empty(t.shape, dtype=t.dtype,
                           device=t.to_local().device)
    dist.broadcast(full, int(old.mesh.flatten()[0]))
    return full


def _place(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """``t`` laid out by ``spec`` on ``mesh``, its local shard a compact
    copy: it shares no storage with ``t`` (the train step updates the
    state in place) and holds no more than the shard."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    pl = placements(spec, mesh)
    dt = distribute_tensor(_global(t, mesh).detach(), mesh, pl,
                           src_data_rank=None)
    if mesh.get_coordinate() is None:        # outside the mesh: no shard
        return dt
    return DTensor.from_local(dt.to_local().clone(), mesh, pl,
                              run_check=False, shape=dt.shape,
                              stride=dt.stride())


def reshard_tree(tree: Any, specs: Any, mesh) -> Any:
    """Every leaf of ``tree`` laid out on ``mesh`` by its spec (a tree of
    specs of the same structure, from :mod:`.sharding`)."""
    flat = leaf_paths(tree)
    flat_s = [s for _, s in spec_paths(specs)]
    if len(flat) != len(flat_s):
        raise ValueError(f"{len(flat_s)} specs for {len(flat)} leaves")
    return unflatten(tree, [_place(t, s, mesh)
                            for (_, t), s in zip(flat, flat_s)])


def _replicate(tree: Any, mesh) -> Any:
    return unflatten(tree, [_place(t, (), mesh) for _, t in leaf_paths(tree)])


def reshard_state(state: Any, new_mesh, rules: Optional[dict] = None) -> Any:
    """Re-lay a train state ``{"params", "opt", "step", ["err"]}`` onto
    ``new_mesh``: params by :func:`~.sharding.param_shardings` (stacked
    layout), the AdamW moments, their 8-bit scales and the compression
    error buffers by :func:`~.sharding.shardings_like` of the params'
    specs, every other leaf (the counters) replicated.  Returns a new
    state of DTensors; ``state`` is left as it was."""
    p_specs = param_shardings(state["params"], new_mesh, rules)

    def like(tree):
        return reshard_tree(tree, shardings_like(p_specs, tree, new_mesh),
                            new_mesh)

    out = {}
    for key, val in state.items():
        if key == "params":
            out[key] = reshard_tree(val, p_specs, new_mesh)
        elif key == "err" and val is not None:
            out[key] = like(val)
        elif key == "opt" and val is not None:
            out[key] = {k: (like(v) if k in _MOMENTS and v is not None
                            else _replicate(v, new_mesh))
                        for k, v in val.items()}
        else:
            out[key] = _replicate(val, new_mesh)
    return out

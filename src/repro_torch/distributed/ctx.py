"""The ambient mesh: of the sharded sparse ops and of the sharded LM.

Counterpart of ``repro.distributed.ctx``.  ``with activation_mesh(mesh):``
makes ``mesh`` the one that the sharded sparse ops use when they are
given none, and the one that :func:`constrain` lays activations out on
inside model code:

    x = constrain(x, "act_batch", None, None)

Without an ambient mesh, or on a plain tensor, ``constrain`` returns its
input itself, so every single-device path is unchanged bit for bit.  On
a ``DTensor`` it redistributes to the placements the logical axes fit
(:data:`ACT_RULES`); the values never change.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from .sharding import LOGICAL_AXIS_RULES, fit_pspec, placements

__all__ = ["ACT_RULES", "activation_mesh", "constrain", "current_mesh"]

_STATE = threading.local()

# activation logical axes (extends the weight rules)
ACT_RULES = dict(
    LOGICAL_AXIS_RULES,
    act_batch=("pod", "data"),
    act_vocab=("model",),
    act_heads=("model",),
    act_ffn=("model",),
    act_seq=("model",),
)


def current_mesh() -> Optional[DeviceMesh]:
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def activation_mesh(mesh: Optional[DeviceMesh]):
    prev = current_mesh()
    _STATE.mesh = mesh
    try:
        yield
    finally:
        _STATE.mesh = prev


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """``x`` laid out by logical axis names on the ambient mesh (the
    reference's ``with_sharding_constraint``); ``x`` itself without a
    mesh or when ``x`` is not a ``DTensor``."""
    from torch.distributed.tensor import DTensor

    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    logical = tuple(logical) + (None,) * (x.dim() - len(logical))
    spec = fit_pspec(logical, x.shape, mesh, rules=ACT_RULES)
    want = placements(spec, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def _resolve_mesh(mesh: Optional[DeviceMesh]) -> DeviceMesh:
    """``mesh``, else the ambient one; raises unless it has a ``data``
    dim."""
    if mesh is None:
        mesh = current_mesh()
    if mesh is None:
        raise ValueError(
            "sharded sparse ops need a mesh with a 'data' axis: pass "
            "mesh=..., enter `with activation_mesh(mesh):`, or build one "
            "with repro_torch.launch.mesh.make_mesh(data, model)")
    if "data" not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh must have a 'data' axis, got "
                         f"{mesh.mesh_dim_names}")
    return mesh

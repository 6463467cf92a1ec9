"""The ambient mesh of the sharded sparse ops.

Counterpart of ``repro.distributed.ctx``'s ``activation_mesh`` and
``current_mesh``: ``with activation_mesh(mesh):`` makes ``mesh`` the one
that the sharded ops use when they are given none.  (The reference's
``constrain`` belongs to its LM stack.)
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

from torch.distributed.device_mesh import DeviceMesh

__all__ = ["activation_mesh", "current_mesh"]

_STATE = threading.local()


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

"""Device meshes for the sharded sparse ops.

Counterpart of ``repro.launch.mesh``.  A mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` with the dims
``("data", "model")`` over the ranks of the default process group: NCCL
on the card, gloo on the CPU.  Several ranks come from ``torchrun`` (or
any ``init_process_group`` the caller makes); a one-rank mesh starts its
own one-rank group from a ``FileStore`` in a temporary directory when
none is running, so a single process needs no launcher.

The production meshes (:func:`make_production_mesh`) are the reference's
pods: ``(16, 16)`` over ``("data", "model")``, or ``(2, 16, 16)`` over
``("pod", "data", "model")``, where the "pod" axis carries only batch.
A *function*, so importing this module starts no process group.  The
dry-run builds them over :func:`fake_group`, a process group of n ranks
in one process that communicates nothing (the reference forces 512 host
devices for the same purpose).
"""

from __future__ import annotations

import contextlib
import math
import os
import shutil
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.core.format import resolve_device

__all__ = ["AXES", "make_mesh", "make_host_mesh", "make_production_mesh",
           "fake_group", "mesh_from_arg", "one_rank_mesh"]

AXES = ("data", "model")
_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _start_one_rank_group(device_type: str) -> str:
    """Start a one-rank default group over ``device_type``'s backend from
    a ``FileStore``; returns the store's directory."""
    path = tempfile.mkdtemp(prefix="repro_torch_pg_")
    store = dist.FileStore(f"{path}/store", 1)
    dist.init_process_group(_BACKEND[device_type], store=store, rank=0,
                            world_size=1)
    return path


def make_mesh(data: int = 1, model: int = 1, *, device=None) -> DeviceMesh:
    """A ``(data, model)`` mesh on ``device``'s type: the card (NCCL)
    unless ``device`` says ``"cpu"`` (gloo).

    The default group must have ``data * model`` ranks and a backend for
    that device type.  When none is running, ranks that torchrun started
    join theirs (its environment), and a one-rank mesh starts a one-rank
    group.
    """
    device_type = resolve_device(device).type
    if device_type not in _BACKEND:
        raise ValueError(f"no mesh on device type {device_type!r}")
    need = data * model
    if data < 1 or model < 1:
        raise ValueError(f"mesh ({data}, {model}) needs positive sizes")
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:      # the ranks torchrun started
            dist.init_process_group(_BACKEND[device_type])
        elif need == 1:
            _start_one_rank_group(device_type)
        else:
            raise RuntimeError(
                f"a ({data}, {model}) mesh needs {need} ranks: start them "
                "with torchrun (or init_process_group) first")
    world = dist.get_world_size()
    if world != need:
        raise RuntimeError(f"mesh ({data}, {model}) needs {need} ranks, the "
                           f"process group has {world}")
    backend = str(dist.get_backend())
    if _BACKEND[device_type] not in backend:
        raise ValueError(f"a {device_type} mesh needs the "
                         f"{_BACKEND[device_type]} backend; the process "
                         f"group runs {backend}")
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return init_device_mesh(device_type, (data, model), mesh_dim_names=AXES)


def make_host_mesh(data: int = 1, model: int = 1) -> DeviceMesh:
    """A ``(data, model)`` mesh over gloo on the CPU."""
    return make_mesh(data, model, device="cpu")


@contextlib.contextmanager
def one_rank_mesh(device=None):
    """A ``(1, 1)`` mesh on ``device`` for the span of the context; the
    one-rank group it starts, if it starts one, is destroyed on exit, so
    no process group outlives the caller."""
    started = not dist.is_initialized()
    path = _start_one_rank_group(resolve_device(device).type) \
        if started else None
    try:
        yield make_mesh(1, 1, device=device)
    finally:
        if started:
            dist.destroy_process_group()
            shutil.rmtree(path, ignore_errors=True)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The single-pod ``(16, 16)`` ``("data", "model")`` mesh, or the
    multi-pod ``(2, 16, 16)`` ``("pod", "data", "model")`` one, over the
    ranks of the default process group (its device type is the group's:
    the card under NCCL, the CPU otherwise)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else AXES
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} ranks, the process group has "
            f"{have} — run under launch/dryrun.py (which starts a fake "
            "group of 512 ranks) or on that many cards")
    device_type = "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
    return DeviceMesh(device_type,
                      torch.arange(need).reshape(shape),
                      mesh_dim_names=axes)


@contextlib.contextmanager
def fake_group(world_size: int):
    """A default process group of ``world_size`` ranks in this process,
    this process rank 0, for the span of the context: torch's ``"fake"``
    backend, whose collectives return at once and move nothing, so a
    step traced on ``meta`` tensors over a mesh of its ranks shows one
    rank's shapes and collectives.  Refuses to start while another
    default group is live; destroys its own on exit."""
    # torch's own testing backend: importing it registers "fake"
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group is already running; "
                           "the fake group needs none")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_from_arg(spec: str, *, device=None,
                  verbose: bool = True) -> DeviceMesh:
    """Parse a ``--mesh DATA,MODEL`` CLI value (e.g. ``"4,1"``) into a
    mesh on ``device``; run several ranks under
    ``torchrun --nproc_per_node=DATA*MODEL``."""
    try:
        data, model = (int(x) for x in spec.split(","))
    except ValueError as e:
        raise ValueError(
            f"--mesh expects DATA,MODEL (e.g. 4,1), got {spec!r}") from e
    mesh = make_mesh(data, model, device=device)
    if verbose and dist.get_rank() == 0:
        print(f"mesh: data={data} model={model} ({data * model} ranks, "
              f"{mesh.device_type})")
    return mesh

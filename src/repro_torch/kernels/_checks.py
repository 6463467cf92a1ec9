"""Input checks shared by the kernel wrappers.

A wrapper runs its plain PyTorch version when every tensor lies on the
CPU, launches its kernel when every tensor lies on one CUDA device, and
raises on anything the kernel does not take: another dtype than float32
(the kernels never cast), non-contiguous tensors, non-int32 indices, or
mixed devices.
"""

from __future__ import annotations

import torch

from repro_torch.core.autodiff import forward_only

__all__ = ["on_cpu", "forward_inputs", "kernel_inputs", "heads",
           "head_stride", "int32_max"]

int32_max = 2**31 - 1


def forward_inputs(op: str, **tensors: torch.Tensor) -> None:
    """Raise ``TypeError`` unless every tensor is float32, and
    ``RuntimeError`` if one needs a gradient (:func:`forward_only`): a
    launch would silently cut the graph.  The autograd Functions of
    ``core/autodiff.py`` call the wrappers with gradients off."""
    for label, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{op}: {label} is {t.dtype}; this kernel takes "
                            "float32 only and never casts")
    forward_only(op, **tensors)


def on_cpu(op: str, **tensors: torch.Tensor) -> bool:
    """True when every tensor is on the CPU, False when all are on one
    CUDA device; raises otherwise."""
    devices = {t.device for t in tensors.values()}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{op}: tensors must all be on the CPU or all on "
                         f"one CUDA device, got "
                         f"{ {k: str(t.device) for k, t in tensors.items()} }")
    return False


def kernel_inputs(op: str, indices: dict, dense: dict) -> None:
    """Raise unless the index tensors are contiguous int32 and the dense
    tensors contiguous (their dtype is checked by :func:`float32`)."""
    for label, t in indices.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{op}: {label} must be int32, got {t.dtype}")
    for label, t in {**indices, **dense}.items():
        if not t.is_contiguous():
            raise ValueError(f"{op}: {label} must be contiguous")


def heads(op: str, **operands: tuple) -> tuple:
    """``(H, batched)`` of operands given as ``label=(tensor, ndim)``: each
    tensor has ``ndim`` dimensions, or one more for a leading head
    dimension; the heads of all 3-D operands agree, and ``H`` is 1 when
    none has one."""
    hs = set()
    for label, (t, ndim) in operands.items():
        if t.dim() == ndim + 1:
            hs.add(t.shape[0])
        elif t.dim() != ndim:
            raise ValueError(f"{op}: {label} must have {ndim} or {ndim + 1} "
                             f"dimensions, got {tuple(t.shape)}")
    if len(hs) > 1:
        raise ValueError(f"{op}: operands disagree on the head count "
                         f"{sorted(hs)}")
    return (next(iter(hs)) if hs else 1), bool(hs)


def head_stride(t: torch.Tensor, ndim: int) -> int:
    """Elements between heads of a per-head operand, 0 for a shared one
    (every head reads slice 0)."""
    return t[0].numel() if t.dim() == ndim + 1 else 0

"""Input checks shared by the kernel wrappers.

A wrapper runs its plain PyTorch version when every tensor lies on the
CPU, launches its kernel when every tensor lies on one CUDA device, and
raises on anything the kernel does not take: a combination of dtypes that
is not one of its variants (the kernels never cast), non-contiguous
tensors, non-int32 indices, or mixed devices.  Every wrapper takes
float32; the window, head-grid and balanced SpMMs, SDDMMs and attentions
also take bfloat16 operands, and the SpMMs int8 values with fp32
per-K-block scales (DESIGN.md §13).  The two SpMM baselines, staged and
non-coalesced, take float32 only.
"""

from __future__ import annotations

import torch

from repro_torch.core.autodiff import forward_only

__all__ = ["on_cpu", "forward_inputs", "kernel_inputs", "heads",
           "head_stride", "int32_max", "dtype_code", "variant"]

int32_max = 2**31 - 1

# Element types of the kernels' C entry points.
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def dtype_code(t: torch.Tensor) -> int:
    """The C entry points' code of ``t``'s element type (0 float32,
    1 bfloat16, 2 int8)."""
    return _DTYPE_CODES[t.dtype]


def variant(t: torch.Tensor) -> str:
    """The precision variant a launch on ``t`` (values, Q or V) runs."""
    return {torch.float32: "fp32", torch.bfloat16: "bf16",
            torch.int8: "int8"}[t.dtype]


def forward_inputs(op: str, variants=None, **tensors: torch.Tensor) -> None:
    """Raise ``TypeError`` unless the tensors' dtypes, in keyword order,
    are one of ``variants`` (tuples of dtypes; by default all float32),
    and ``RuntimeError`` if one needs a gradient (:func:`forward_only`): a
    launch would silently cut the graph.  The autograd Functions of
    ``core/autodiff.py`` call the wrappers with gradients off."""
    got = tuple(t.dtype for t in tensors.values())
    if variants is None:
        for label, t in tensors.items():
            if t.dtype != torch.float32:
                raise TypeError(
                    f"{op}: {label} is {t.dtype}; this kernel takes float32 "
                    "only and never casts (its bf16/int8 variants are "
                    "ROADMAP.md queue 2)")
    elif got not in variants:
        names = ", ".join(f"{k}={t.dtype}" for k, t in tensors.items())
        raise TypeError(f"{op}: {names} is not one of the kernel's variants "
                        f"{[tuple(str(d) for d in v) for v in variants]}; it "
                        "never casts")
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

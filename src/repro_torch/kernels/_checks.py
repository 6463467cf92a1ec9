"""Input checks shared by the kernel wrappers.

A wrapper checks its arguments first (vector size, operand ranks and
shapes, column tile, head count and grid limits, the schedule's owner),
so the CPU and the card refuse the same arguments with the same message.
Then it runs its plain PyTorch version when every tensor lies on the
CPU, launches its kernel when every tensor lies on one CUDA device, and
raises on anything else the kernel does not take: a combination of dtypes that
is not one of its variants (the kernels never cast), non-contiguous
tensors, non-int32 indices, or mixed devices.  Every wrapper takes
float32 and bfloat16 operands, and every SpMM but the staged baseline
int8 values with fp32 per-K-block scales (DESIGN.md §13), as the
reference's kernels do; each wrapper lists its combinations in a
``VARIANTS`` tuple.
"""

from __future__ import annotations

import torch

from repro_torch.core.autodiff import forward_only

__all__ = ["on_cpu", "forward_inputs", "kernel_inputs", "heads",
           "head_stride", "int32_max", "dtype_code", "variant",
           "vector_size", "column_tile", "zero_outside"]

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


def forward_inputs(op: str, variants, **tensors: torch.Tensor) -> None:
    """Raise ``TypeError`` unless the tensors' dtypes, in keyword order,
    are one of ``variants`` (the wrapper's ``VARIANTS``: tuples of
    dtypes), and ``RuntimeError`` if one needs a gradient
    (:func:`forward_only`): a launch would silently cut the graph.  The
    autograd Functions of ``core/autodiff.py`` call the wrappers with
    gradients off."""
    got = tuple(t.dtype for t in tensors.values())
    if got not in variants:
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


def vector_size(op: str, blocked) -> int:
    """``blocked``'s vector size V, raising unless the kernels take it
    (8 or 16)."""
    v = blocked.vector_size
    if v not in (8, 16):
        raise ValueError(f"{op}: vector_size {v} not in (8, 16)")
    return v


def schedule_owner(op: str, schedule, blocked) -> None:
    """Raise unless ``schedule`` schedules ``blocked``'s blocks: as many
    as the view holds, or none for the all-empty view, whose one dummy
    block no window owns (told apart from a one-block view by one read of
    ``win_ptr``, made only for a zero-block schedule).  A rank-local
    schedule is held to the full schedule it was cut from, by the block
    count its ``local`` range records."""
    nb = blocked.num_blocks
    total = (schedule.num_blocks if schedule.local is None
             else schedule.local.view_blocks)
    if total == nb or (total == 0 and nb == 1
                       and int(blocked.win_ptr[-1]) == 0):
        return
    raise ValueError(f"{op}: the schedule is not this view's "
                     f"({total} scheduled blocks, {nb} in the view)")


def zero_outside(out: torch.Tensor, lo: int, hi: int) -> None:
    """Store zeros in the rows of ``out`` (``(H, R, C)``) outside
    ``[lo, hi)``: the rows a rank-local schedule does not write.  The
    kernels allocate without filling because a full schedule writes every
    row; a local one writes only its windows (SpMM, attention) or its
    blocks (SDDMM).  Zeros are stored, not multiplied in, so whatever the
    allocation held never leaks."""
    out[:, :lo] = 0
    out[:, hi:] = 0


def column_tile(op: str, n_blk: int, hi: int) -> None:
    """Raise unless ``n_blk`` is a multiple of 32 in ``[32, hi]``."""
    if not (n_blk % 32 == 0 and 32 <= n_blk <= hi):
        raise ValueError(f"{op}: n_blk={n_blk} must be a multiple of 32 in "
                         f"[32, {hi}]")


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

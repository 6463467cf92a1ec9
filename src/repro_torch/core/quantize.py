"""The precision axis of the kernel stack and its block quantizer.

Counterpart of ``repro.core.quantize`` (the port keeps its own copy).  One
absmax int8 quantizer gives a blocked ME-BCRS view per-K-block scales:
each K-block's ``(K_BLK, V)`` value tile stores int8 with one fp32 scale,
and the SpMM kernels dequantize on the fly (``s·q`` contracted with B is
``s·(q·B)``), so the values move at one byte each.

``PRECISIONS`` names the levels:

  ``fp32``   operands cast to float32
  ``bf16``   dense operands and float sparse values cast to bfloat16
             before the kernel; the kernels accumulate in fp32 and cast
             once at the end
  ``int8``   sparse values quantized per K-block to int8 + fp32 scale
             (SpMM only; the dense operand rides at bf16)

``precision=None`` everywhere means "run at the operand dtypes as given".
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = [
    "PRECISIONS",
    "precision_dtype",
    "validate_precision",
    "cast_precision",
    "quantize_blocked",
    "dequantize_blocked",
    "quantize_block_values",
    "dequantize_block_values",
    "quantize_format",
]

PRECISIONS: Tuple[str, ...] = ("fp32", "bf16", "int8")

_DENSE_DTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16,
                "int8": torch.bfloat16}


def validate_precision(precision: Optional[str]) -> Optional[str]:
    """``None`` (operand dtypes as given) or one of :data:`PRECISIONS`."""
    if precision is not None and precision not in PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; expected None or one of "
            f"{', '.join(PRECISIONS)}")
    return precision


def precision_dtype(precision: str) -> torch.dtype:
    """Dense-operand dtype of a precision level (int8 rides dense at bf16)."""
    validate_precision(precision)
    if precision is None:
        raise ValueError("precision None has no fixed dtype (operand dtypes "
                         "as given)")
    return _DENSE_DTYPE[precision]


def cast_precision(precision: Optional[str], *operands: torch.Tensor):
    """Cast dense operands per the precision policy (``None``/fp32/bf16).

    The entry of the ops whose narrow path is a plain operand cast (SDDMM,
    attention): ``None`` returns the operands untouched; int8 is refused,
    since it applies only to SpMM sparse values (per-K-block scales).
    """
    validate_precision(precision)
    if precision == "int8":
        raise ValueError("int8 applies to SpMM sparse values; SDDMM and "
                         "attention support precision 'fp32'/'bf16'")
    if precision is None:
        return operands
    return tuple(x.to(_DENSE_DTYPE[precision]) for x in operands)


def quantize_blocked(x: torch.Tensor, block: int, scale=None):
    """Per-block int8 quantization of ``x`` (any shape), saturating.

    Flattens, zero-pads to a multiple of ``block`` and quantizes each
    ``block``-element group:

      scale = max(absmax, 1e-12) / 127     (default, per group)
      q     = clip(round(x / scale), -127, 127)  (int8, half to even)

    Returns ``(q (NBLK, block) int8, scale (NBLK,) fp32)``.  An explicit
    ``scale`` (a scalar or per-group ``(NBLK,)``, the fixed-scale regime
    of calibrated scales) can overflow the int8 range: the quantizer then
    saturates at ±127 and adds the number of clipped elements to the
    ``int8_clip`` counter (:func:`repro_torch.core.metrics.record_counter`).
    """
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block
    xp = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
    if scale is None:
        absmax = xp.abs().amax(dim=-1, keepdim=True)
        sc = torch.clamp(absmax, min=1e-12) / 127.0
        q = torch.clamp(torch.round(xp / sc), -127, 127).to(torch.int8)
    else:
        from .metrics import record_counter

        sc = torch.as_tensor(scale, dtype=torch.float32, device=xp.device)
        sc = (sc.reshape(-1, 1) if sc.dim() else sc).expand(xp.shape[0], 1)
        rounded = torch.round(xp / sc)
        record_counter("int8_clip", int((rounded.abs() > 127).sum()))
        q = torch.clamp(rounded, -127, 127).to(torch.int8)
    return q, sc[:, 0].float().contiguous()


def dequantize_blocked(q: torch.Tensor, scale: torch.Tensor,
                       shape) -> torch.Tensor:
    """Inverse of :func:`quantize_blocked`: ``(q, scale)`` → fp32 of
    ``shape``."""
    x = (q.float() * scale[:, None]).reshape(-1)
    size = 1
    for s in shape:
        size *= s
    return x[:size].reshape(shape)


def quantize_block_values(vals: torch.Tensor, k_blk: int, scales=None):
    """Quantize blocked ME-BCRS values ``(NNZP, V)`` per K-block.

    Each K-block owns ``k_blk`` consecutive vectors, one quantization
    group of ``k_blk * V`` elements.  Returns ``(q (NNZP, V) int8, scales
    (NB,) fp32)`` with ``NB = NNZP / k_blk``.  Zero-padding vectors keep
    quantizing to exact 0.  An explicit ``scales`` (scalar or ``(NB,)``)
    runs the saturating fixed-scale path of :func:`quantize_blocked`.
    """
    if vals.dim() != 2:
        raise ValueError(
            "per-K-block quantization expects 2-D values (NNZP, V); "
            f"got shape {tuple(vals.shape)}: per-head quantized values are "
            "not supported (quantize before stacking heads)")
    q, out_scales = quantize_blocked(vals, k_blk * vals.shape[-1],
                                     scale=scales)
    return q.reshape(vals.shape), out_scales


def dequantize_block_values(q: torch.Tensor,
                            scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_block_values` → fp32 ``(NNZP, V)``."""
    return dequantize_blocked(q.reshape(scales.shape[0], -1), scales,
                              tuple(q.shape))


def quantize_format(blocked):
    """A copy of a blocked view with per-K-block int8 values and fp32
    ``scales``; the SpMM paths detect the pair and dequantize."""
    q, scales = quantize_block_values(blocked.vals, blocked.k_blk)
    return dataclasses.replace(blocked, vals=q, scales=scales)

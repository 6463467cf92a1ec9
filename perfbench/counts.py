"""The yardstick: the H100's peaks, and the operations and bytes of a
training step, counted from the graph and the widths alone.

Bytes follow ``chip_smoke.read_once``'s rule: each input read once (an
operand passed twice, Q = K, once), each output written once.  They are
counted from the true nonzeros and the widths (values and 32-bit column
ids of the nonzeros, n + 1 row pointers, the dense operands, the
output), not from the program's padded arrays, so a change of format or
kernel leaves the yardstick where it is.  ``bound`` is
``chip_smoke.bound``: the least time is the larger of bytes over the
memory's rate and operations over the unit's peak.

Peaks (NVIDIA's data sheet, H100 SXM, dense): 67 TFLOP/s in float32
outside the tensor cores, 3.35 TB/s of HBM.  A cell of another precision
brings its peak and element size here.
"""

from __future__ import annotations

from typing import Iterable, Tuple

__all__ = ["HBM_BYTES_PER_S", "PEAK_FLOPS_PER_S", "ELEMENT_BYTES", "bound",
           "op_bytes", "op_flops", "least_ms"]

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = {"float32": 67e12}
ELEMENT_BYTES = {"float32": 4}
ID_BYTES = 4


def bound(nbytes: int, flops: int, flops_per_s: float) -> Tuple[float, str]:
    """Least time (ms) the card could take, and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _structure(n: int, nnz: int) -> int:
    return nnz * ID_BYTES + (n + 1) * ID_BYTES


def op_bytes(op: dict, n: int, nnz: int, dtype: str) -> int:
    """Bytes one sparse product over an n × n pattern of ``nnz`` entries
    must move, at ``dtype``'s element size."""
    e = ELEMENT_BYTES[dtype]
    w = op["width"]
    if op["op"] == "spmm":      # values, B (n × w) in; C (n × w) out
        return _structure(n, nnz) + nnz * e + 2 * n * w * e
    if op["op"] == "sddmm":     # Q and K (n × w) in; nnz values out
        return _structure(n, nnz) + 2 * n * w * e + nnz * e
    if op["op"] == "attention":  # Q = K (n × w) and V (n × wv) in; O out
        wv = op["value_width"]
        return _structure(n, nnz) + n * w * e + 2 * n * wv * e
    raise ValueError(f"unknown sparse op {op['op']!r}")


def op_flops(op: dict, nnz: int) -> int:
    """Multiply-adds on the true nonzeros, two operations each (the
    attention's exponentials and sums not counted)."""
    w = op["width"]
    if op["op"] in ("spmm", "sddmm"):
        return 2 * nnz * w
    if op["op"] == "attention":
        return 2 * nnz * (w + op["value_width"])
    raise ValueError(f"unknown sparse op {op['op']!r}")


def least_ms(ops: Iterable[dict], n: int, nnz: int, dtype: str) -> float:
    """Sum of each operation's least time."""
    peak = PEAK_FLOPS_PER_S[dtype]
    return sum(bound(op_bytes(op, n, nnz, dtype), op_flops(op, nnz), peak)[0]
               for op in ops)

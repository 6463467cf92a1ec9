"""Redundancy metrics of the paper's analysis, and runtime counters.

Counterpart of ``repro.core.metrics`` (the port keeps its own copy).

Format metrics (host numpy, exact functions of the ME-BCRS structure):

  * :func:`zeros_in_nonzero_vectors` (Table 2)
  * :func:`mma_count`                (Fig. 1)
  * :func:`data_access_bytes`        (Fig. 12 cost model)
  * :func:`padded_flops`             (executed against useful flops)
  * :func:`summarize`                (all of them in one dict)

Runtime counters (process-global, thread-safe) record degradation events
such as int8 saturation clips (:func:`repro_torch.core.quantize.
quantize_blocked` with an external scale): :func:`record_counter` adds,
:func:`counters` snapshots, :func:`reset_counters` clears.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np

from .format import MEBCRS

__all__ = [
    "zeros_in_nonzero_vectors",
    "mma_count",
    "data_access_bytes",
    "padded_flops",
    "summarize",
    "record_counter",
    "counters",
    "reset_counters",
]

_counters: Dict[str, int] = {}
_counters_lock = threading.Lock()


def record_counter(name: str, n=1) -> None:
    """Add ``n`` (a number or a 0-d tensor) to the counter ``name``."""
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + int(n)


def counters() -> Dict[str, int]:
    """Snapshot of all runtime counters."""
    with _counters_lock:
        return dict(_counters)


def reset_counters(name: Optional[str] = None) -> None:
    """Clear one counter, or all of them (``name=None``)."""
    with _counters_lock:
        if name is None:
            _counters.clear()
        else:
            _counters.pop(name, None)


# MMA operand shapes (paper Table 1): (m, n, k)
MMA_SHAPES = {
    ("fp16", "flashsparse"): (16, 8, 8),   # sparse block k x n: vector = n = 8
    ("tf32", "flashsparse"): (16, 8, 4),
    ("fp16", "sota16"): (16, 8, 8),        # sparse block m x k: vector = m = 16
    ("tf32", "sota16"): (16, 8, 8),
}


def _window_counts(fmt: MEBCRS) -> np.ndarray:
    return np.diff(fmt.row_pointers.cpu().numpy().astype(np.int64))


def zeros_in_nonzero_vectors(fmt: MEBCRS) -> int:
    """Explicit zeros carried inside nonzero vectors (paper Table 2)."""
    mask = fmt.mask.cpu().numpy()
    return int(mask.size - mask.sum())


def mma_count(fmt: MEBCRS, n_cols: int, precision: str = "fp16") -> int:
    """MMA invocations to complete one SpMM (paper Fig. 1).

    FlashSparse (V = 8): the sparse block is the k x n operand, so each MMA
    covers k vectors of one window and m output columns,
    ``Σ_w ceil(nnzv_w / k) · ceil(N / m)``; the 16x1 scheme (V = 16) has
    the sparse block on the m x k side, ``Σ_w ceil(nnzv_w / k) ·
    ceil(N / n)``.
    """
    scheme = "flashsparse" if fmt.vector_size == 8 else "sota16"
    m, n, k = MMA_SHAPES[(precision, scheme)]
    kblocks = -(-_window_counts(fmt) // k)
    ntiles = -(-n_cols // (m if scheme == "flashsparse" else n))
    return int(kblocks.sum()) * ntiles


def data_access_bytes(fmt: MEBCRS, n_cols: int, value_bytes: int = 2,
                      precision: str = "fp16") -> Dict[str, int]:
    """Cost model of global data movement for one SpMM (paper Fig. 12):
    every MMA loads its sparse and dense operand blocks, so the traffic
    follows the MMA count."""
    scheme = "flashsparse" if fmt.vector_size == 8 else "sota16"
    m, n, k = MMA_SHAPES[(precision, scheme)]
    kblocks = int((-(-_window_counts(fmt) // k)).sum())
    if scheme == "flashsparse":
        mmas = kblocks * -(-n_cols // m)
        a_block, b_block = k * n, m * k     # sparse k x n, dense m x k
    else:
        mmas = kblocks * -(-n_cols // n)
        a_block, b_block = m * k, k * n     # sparse m x k, dense k x n
    a_bytes = (mmas * a_block * value_bytes + 4 * fmt.nnzv
               + 4 * (fmt.num_windows + 1))
    b_bytes = mmas * b_block * value_bytes
    c_bytes = fmt.shape[0] * n_cols * value_bytes
    return {"A": a_bytes, "B": b_bytes, "C": c_bytes, "mmas": mmas,
            "total": a_bytes + b_bytes + c_bytes}


def padded_flops(fmt: MEBCRS, n_cols: int,
                 k_blk: int = 8) -> Dict[str, float]:
    """Executed (K-block padded) against useful flops of one SpMM."""
    counts = _window_counts(fmt)
    padded_vecs = int((-(-counts // k_blk) * k_blk).sum())
    executed = 2.0 * padded_vecs * fmt.vector_size * n_cols
    useful = 2.0 * fmt.nnz * n_cols
    return {"executed_flops": executed, "useful_flops": useful,
            "efficiency": useful / max(executed, 1.0)}


def summarize(fmt: MEBCRS, n_cols: int,
              precision: str = "fp16") -> Dict[str, float]:
    """One-dict redundancy summary of a format at feature width
    ``n_cols``: vectors, windows, carried zeros, MMAs, padded flops and
    modelled access bytes."""
    return {
        "V": fmt.vector_size,
        "windows": fmt.num_windows,
        "nnzv": fmt.nnzv,
        "nnz": fmt.nnz,
        "zeros_in_vectors": zeros_in_nonzero_vectors(fmt),
        "mma_count": mma_count(fmt, n_cols, precision),
        "access_bytes": data_access_bytes(fmt, n_cols,
                                          precision=precision)["total"],
        **padded_flops(fmt, n_cols),
    }

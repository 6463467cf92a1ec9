"""Structural checks that the format builders raise themselves.

Counterpart of the parts of ``repro.core.validate`` that ``from_coo`` and
``block_format`` use: :class:`ValidationError` and the ``coo-in-bounds``,
``duplicate-coords`` and ``block-config`` invariants.  The full auditor
(named invariants at none/cheap/full levels) is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["ValidationError", "check_coo", "check_block_config"]


class ValidationError(ValueError):
    """A named structural invariant was violated.

    ``invariant`` is a stable kebab-case identifier (e.g. ``coo-in-bounds``);
    the message always starts with ``[invariant]``.
    """

    def __init__(self, invariant: str, message: str):
        self.invariant = invariant
        super().__init__(f"[{invariant}] {message}")


def check_coo(rows: np.ndarray, cols: np.ndarray, shape: Tuple[int, int],
              duplicates: str) -> None:
    """Reject COO triplets outside ``shape`` and, with
    ``duplicates="error"``, repeated ``(row, col)`` coordinates."""
    m, k = shape
    if rows.size and (rows.min() < 0 or cols.min() < 0
                      or rows.max() >= m or cols.max() >= k):
        raise ValidationError(
            "coo-in-bounds", f"COO indices out of bounds for shape {shape}")
    if rows.size and duplicates == "error":
        elem_key = rows * k + cols
        n_dup = elem_key.size - np.unique(elem_key).size
        if n_dup:
            raise ValidationError("duplicate-coords",
                                  f"{n_dup} duplicate COO coordinate(s)")


def check_block_config(k_blk) -> None:
    """Reject a K-block size outside ``[1, 4096]``."""
    if not (isinstance(k_blk, int) and 1 <= k_blk <= 4096):
        raise ValidationError(
            "block-config", f"k_blk={k_blk!r} outside the sane range "
            "[1, 4096]")

"""Structural checks that the format builders raise themselves.

Counterpart of the parts of ``repro.core.validate`` that ``from_coo``,
``block_format`` and ``build_schedule`` use: :class:`ValidationError`, the
``coo-in-bounds``, ``duplicate-coords`` and ``block-config`` invariants,
and the schedule invariants of ``validate_schedule`` at its full level.
The port has one level: the builders always check.  The rest of the
auditor (29 named invariants at none/cheap/full levels) is not ported
yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["ValidationError", "check_coo", "check_block_config",
           "check_schedule"]


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


def _require(cond, invariant: str, message: str) -> None:
    if not cond:
        raise ValidationError(invariant, message)


def check_schedule(sched, win_ptr: np.ndarray) -> None:
    """Check a :class:`~repro_torch.core.format.Schedule` against the
    blocked view's ``win_ptr`` (host numpy): the segments of each window
    are contiguous and tile its block range ``[win_ptr[w], win_ptr[w+1])``
    exactly once in ascending order, with the first/last flags on its first
    and last segment.  Vectorised counterpart of
    ``repro.core.validate.validate_schedule`` at level ``full``, with the
    same invariant names."""
    sw = sched.seg_win.cpu().numpy().astype(np.int64)
    sm = sched.seg_meta.cpu().numpy().astype(np.int64)
    blk_id = sched.blk_id.cpu().numpy()
    blk_win = sched.blk_win.cpu().numpy()
    ns = sw.shape[0]
    w = win_ptr.shape[0] - 1
    counts = np.diff(win_ptr)
    _require(sm.shape == (ns, 4), "schedule-shape",
             f"seg_meta shape {sm.shape} != ({ns}, 4)")
    lo, ln, first, last = sm.T
    _require(bool(np.all(ln >= 0)), "seg-flags",
             "segment lengths must be >= 0")
    _require(bool(np.isin(first, (0, 1)).all() and np.isin(last, (0, 1)).all()),
             "seg-flags", "seg first/last flags must be 0/1")
    nb = sched.num_blocks
    _require(blk_id.shape == blk_win.shape == (nb,), "blk-id-bounds",
             f"blk_id/blk_win shapes {blk_id.shape}/{blk_win.shape} != "
             f"({nb},)")
    _require(nb == 0 or (blk_id.min() >= 0 and blk_id.max() < nb),
             "blk-id-bounds", f"blk_id outside [0, {nb})")
    _require(ns == 0 or (sw.min() >= 0 and sw.max() < w), "seg-coverage",
             f"seg_win outside [0, {w})")
    _require(int(win_ptr[-1]) == nb, "seg-coverage",
             f"schedule num_blocks={nb} != owned blocks {int(win_ptr[-1])}")
    # Contiguous per window (seg_win ascends) and at least one segment each.
    _require(bool(np.all(np.diff(sw) >= 0)), "seg-coverage",
             "a window's segments are not contiguous")
    nseg = np.bincount(sw, minlength=w)
    _require(bool(np.all(nseg >= 1)), "seg-coverage",
             "a window has no segment (empty windows keep one zero-length "
             "store-only segment)")
    win_seg = np.concatenate([[0], np.cumsum(nseg)])  # w's first segment
    s = np.arange(ns)
    _require(np.array_equal(first, (s == win_seg[sw]).astype(np.int64))
             and np.array_equal(last, (s == win_seg[sw + 1] - 1)
                                .astype(np.int64)), "seg-flags",
             "a window's first/last segment flags are wrong")
    # Each window's lengths add up to its block count, and each non-empty
    # segment starts where the window's earlier segments stopped.
    _require(np.array_equal(np.bincount(sw, weights=ln, minlength=w)
                            .astype(np.int64), counts), "seg-coverage",
             "segments do not cover each window's blocks exactly once")
    before = np.cumsum(ln) - ln
    start = win_ptr[sw] + before - before[win_seg[sw]]
    _require(bool(np.all((ln == 0) | (lo == start))), "seg-coverage",
             "segments do not tile their window's block range in order")
    _require(np.array_equal(blk_win, np.repeat(np.arange(w), counts)),
             "block-win-consistent",
             "schedule blk_win disagrees with win_ptr")

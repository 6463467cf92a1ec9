"""Structural validation for the sparse format stack (DESIGN.md §15).

Counterpart of ``repro.core.validate``.  Every layer between a COO matrix
and a kernel launch (``MEBCRS`` → ``BlockedMEBCRS`` → ``Schedule``) is
index and metadata driven: one out-of-bounds ``cols`` entry or a
non-monotone ``win_ptr`` gives a silent wrong answer or a device fault,
never a clean error.  This module holds the invariants in one place, at
three check levels:

  ``"none"``   no work at all, the default: the entry points run no
               validation code and add no host sync.
  ``"cheap"``  non-finite values and out-of-range indices, as eager
               reductions that raise :class:`ValidationError` (one host
               sync each; the port has no tracing, so there is no
               warning path).
  ``"full"``   a host-side NumPy audit of every structural invariant;
               CUDA tensors are copied to the host for it.

Errors carry the violated invariant's name (``err.invariant``) and read
``[invariant-name] explanation``, so the fault-injection harness
(:mod:`repro_torch.testing.faults`) and logs classify failures without
parsing prose.  The names and the order they are checked in are the
reference's.

The level is resolved per call: an explicit ``check=`` argument wins,
then a :func:`checking` context override, then the ``REPRO_TORCH_CHECK``
environment variable, then ``"none"``.

The builders' own checks (:func:`check_coo`, :func:`check_block_config`)
run at every level, as the reference's builders do.
"""

from __future__ import annotations

import contextlib
import os
import threading
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "CHECK_LEVELS",
    "ValidationError",
    "ValidationWarning",
    "check_level",
    "checking",
    "resolve_check",
    "effective_check",
    "validate",
    "validate_format",
    "validate_blocked",
    "validate_schedule",
    "validate_sharded",
    "cheap_guard",
    "guard_operand",
    "guard_call",
    "check_coo",
    "check_block_config",
]

CHECK_LEVELS = ("none", "cheap", "full")
_CHECK_ENV = "REPRO_TORCH_CHECK"
_local = threading.local()


class ValidationWarning(UserWarning):
    """A condition worth reporting that the runtime absorbs: at level
    ``full``, ``from_coo(duplicates="sum")`` coalescing repeated
    coordinates."""


class ValidationError(ValueError):
    """A named structural invariant was violated.

    ``invariant`` is a stable kebab-case identifier (e.g. ``col-in-bounds``)
    that the fault-injection harness matches on; the message always starts
    with ``[invariant]``.
    """

    def __init__(self, invariant: str, message: str):
        self.invariant = invariant
        super().__init__(f"[{invariant}] {message}")


def check_level() -> str:
    """The ambient check level: :func:`checking` override, else the
    ``REPRO_TORCH_CHECK`` environment variable, else ``"none"``."""
    override = getattr(_local, "override", None)
    if override is not None:
        return override
    env = os.environ.get(_CHECK_ENV, "none").strip().lower()
    return env if env in CHECK_LEVELS else "none"


@contextlib.contextmanager
def checking(level: str):
    """Scoped override of the ambient check level (thread-local)."""
    if level not in CHECK_LEVELS:
        raise ValueError(f"check must be one of {CHECK_LEVELS}, got {level!r}")
    prev = getattr(_local, "override", None)
    _local.override = level
    try:
        yield
    finally:
        _local.override = prev


def resolve_check(check: Optional[str]) -> str:
    """An explicit ``check=`` argument, validated; ``None`` → ambient."""
    if check is None:
        return check_level()
    if check not in CHECK_LEVELS:
        raise ValueError(f"check must be one of {CHECK_LEVELS}, got {check!r}")
    return check


def effective_check(check: Optional[str]) -> str:
    """The level an entry point runs at.  The reference downgrades
    ``full`` to ``cheap`` under a tracer; the port has no tracing, so this
    is :func:`resolve_check`."""
    return resolve_check(check)


def _require(ok, invariant: str, message: str) -> None:
    if not ok:
        raise ValidationError(invariant, message)


# ---------------------------------------------------------------------------
# Cheap guards: eager reductions
# ---------------------------------------------------------------------------


def cheap_guard(ok, invariant: str, message: str) -> None:
    """Raise :class:`ValidationError` unless ``ok`` (a bool or a 0-d
    tensor, read back to the host) holds."""
    _require(bool(ok), invariant, message)


def _finite_ok(x) -> bool:
    if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
        return True
    return bool(torch.isfinite(x).all())


def guard_operand(x, name: str = "operand") -> None:
    """Cheap non-finite guard on a dense operand."""
    cheap_guard(_finite_ok(x), "values-finite",
                f"{name} contains NaN/Inf values")


def _in_bounds(idx: torch.Tensor, hi: int) -> bool:
    return not idx.numel() or bool((idx.min() >= 0) & (idx.max() < hi))


# ---------------------------------------------------------------------------
# Full host-side audits
# ---------------------------------------------------------------------------


def _np(x: torch.Tensor) -> np.ndarray:
    """Host numpy copy of ``x`` (bf16 widened to fp32: numpy has none)."""
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.cpu().numpy()


def validate_format(fmt, check: Optional[str] = "full"):
    """Audit a canonical :class:`~repro_torch.core.format.MEBCRS`.

    Returns ``fmt`` so construction sites can validate and pass through.
    """
    level = resolve_check(check)
    if level == "none":
        return fmt
    m, k = fmt.shape
    if level == "cheap":
        cheap_guard(_in_bounds(fmt.column_indices, k), "col-in-bounds",
                    f"column_indices outside [0, {k})")
        cheap_guard(_finite_ok(fmt.values), "values-finite",
                    "values contain NaN/Inf")
        return fmt

    v = fmt.vector_size
    w = -(-m // v)
    rp = _np(fmt.row_pointers)
    ci = _np(fmt.column_indices)
    vals = _np(fmt.values)
    mask = _np(fmt.mask)
    _require(rp.ndim == 1 and rp.shape[0] == w + 1, "row-ptr-shape",
             f"row_pointers shape {rp.shape} != ({w + 1},) for "
             f"shape={fmt.shape}, vector_size={v}")
    _require(np.issubdtype(rp.dtype, np.integer), "dtype-mismatch",
             f"row_pointers dtype {rp.dtype} is not integer")
    _require(np.issubdtype(ci.dtype, np.integer), "dtype-mismatch",
             f"column_indices dtype {ci.dtype} is not integer")
    _require(rp[0] == 0 and np.all(np.diff(rp) >= 0), "row-ptr-monotone",
             "row_pointers must start at 0 and be non-decreasing")
    nnzv = vals.shape[0] if vals.ndim else 0
    _require(int(rp[-1]) == nnzv, "row-ptr-bounds",
             f"row_pointers[-1]={int(rp[-1])} != nnzv={nnzv}")
    _require(ci.shape == (nnzv,), "leaf-length",
             f"column_indices shape {ci.shape} != ({nnzv},)")
    _require(nnzv == 0 or (ci.min() >= 0 and ci.max() < k), "col-in-bounds",
             f"column_indices outside [0, {k})")
    _require(vals.ndim == 2 and vals.shape == (nnzv, v), "values-shape",
             f"values shape {vals.shape} != ({nnzv}, {v})")
    _require(mask.shape == (nnzv, v) and mask.dtype == np.bool_,
             "mask-dtype", f"mask shape/dtype {mask.shape}/{mask.dtype} "
             f"!= ({nnzv}, {v})/bool")
    if np.issubdtype(vals.dtype, np.floating):
        _require(bool(np.isfinite(vals).all()), "values-finite",
                 "values contain NaN/Inf")
    # Masked-off lanes must hold zeros: the kernels contract raw values
    # (the mask is read only by the SDDMM's write-back and the metrics).
    _require(nnzv == 0 or not np.any(vals[~mask]), "masked-zeros",
             "values under mask=False must be zero")
    # Each (window, column) vector appears at most once: a duplicate
    # counts its lanes twice in every contraction.
    if nnzv:
        win_of_vec = np.repeat(np.arange(w, dtype=np.int64), np.diff(rp))
        keys = win_of_vec * int(k) + ci.astype(np.int64)
        _require(np.unique(keys).shape[0] == nnzv, "vector-unique",
                 "duplicate (window, column) vector in format")
    return fmt


def validate_blocked(blocked, check: Optional[str] = "full"):
    """Audit a :class:`~repro_torch.core.format.BlockedMEBCRS` view."""
    level = resolve_check(check)
    if level == "none":
        return blocked
    m, k = blocked.shape
    if level == "cheap":
        cheap_guard(_in_bounds(blocked.cols, k), "col-in-bounds",
                    f"cols outside [0, {k})")
        cheap_guard(_finite_ok(blocked.vals), "values-finite",
                    "vals contain NaN/Inf")
        if blocked.scales is not None:
            cheap_guard(_finite_ok(blocked.scales), "scales-finite",
                        "scales contain NaN/Inf")
        return blocked

    v = blocked.vector_size
    kb = blocked.k_blk
    w = blocked.num_windows
    check_block_config(kb)
    vals = _np(blocked.vals)
    cols = _np(blocked.cols)
    mask = _np(blocked.mask)
    bwin = _np(blocked.block_win)
    wptr = _np(blocked.win_ptr)
    nb = bwin.shape[0]
    nnzp = nb * kb
    _require(wptr.ndim == 1 and wptr.shape[0] == w + 1, "win-ptr-shape",
             f"win_ptr shape {wptr.shape} != ({w + 1},)")
    _require(np.issubdtype(wptr.dtype, np.integer)
             and np.issubdtype(bwin.dtype, np.integer)
             and np.issubdtype(cols.dtype, np.integer), "dtype-mismatch",
             "win_ptr/block_win/cols must be integer dtypes")
    _require(wptr[0] == 0 and np.all(np.diff(wptr) >= 0), "win-ptr-monotone",
             "win_ptr must start at 0 and be non-decreasing")
    # The dummy block of an all-empty matrix lies outside every window
    # range, hence <= rather than ==.
    _require(int(wptr[-1]) <= nb, "win-ptr-bounds",
             f"win_ptr[-1]={int(wptr[-1])} > num_blocks={nb}")
    _require(vals.shape == (nnzp, v) and cols.shape == (nnzp,)
             and mask.shape == (nnzp, v), "leaf-length",
             f"vals/cols/mask shapes {vals.shape}/{cols.shape}/{mask.shape} "
             f"inconsistent with num_blocks={nb}, k_blk={kb}, V={v}")
    _require(mask.dtype == np.bool_, "mask-dtype",
             f"mask dtype {mask.dtype} != bool")
    _require(nnzp == 0 or (cols.min() >= 0 and cols.max() < k),
             "col-in-bounds", f"cols outside [0, {k})")
    # Owned blocks must agree between the gather (win_ptr) and scatter
    # (block_win) views.
    owned = int(wptr[-1])
    expect = np.repeat(np.arange(w, dtype=bwin.dtype), np.diff(wptr))
    _require(np.array_equal(bwin[:owned], expect), "block-win-consistent",
             "block_win disagrees with win_ptr block ranges")
    if np.issubdtype(vals.dtype, np.floating):
        _require(bool(np.isfinite(vals).all()), "values-finite",
                 "vals contain NaN/Inf")
    _require(nnzp == 0 or not np.any(vals[~mask]), "masked-zeros",
             "vals under mask=False (incl. block padding) must be zero")
    if blocked.scales is not None:
        sc = _np(blocked.scales)
        _require(sc.shape == (nb,), "scales-shape",
                 f"scales shape {sc.shape} != ({nb},)")
        _require(bool(np.isfinite(sc).all()) and bool((sc > 0).all()),
                 "scales-finite", "scales must be finite and positive")
        _require(vals.dtype == np.int8, "dtype-mismatch",
                 f"scales present but vals dtype is {vals.dtype}, not int8")
    elif vals.dtype == np.int8:
        raise ValidationError("dtype-mismatch",
                              "int8 vals without per-block scales")
    return blocked


def _schedule_arrays(sched):
    return (_np(sched.seg_win).astype(np.int64),
            _np(sched.seg_meta).astype(np.int64), _np(sched.blk_id),
            _np(sched.blk_win))


def _schedule_shape(sched, sw, sm, blk_id, blk_win) -> None:
    """The schedule's own invariants: shapes, flags, block ids."""
    ns = sw.shape[0]
    _require(sm.ndim == 2 and sm.shape == (ns, 4), "schedule-shape",
             f"seg_meta shape {sm.shape} != ({ns}, 4)")
    lo, ln, first, last = sm.T
    _require(bool(np.all(ln >= 0)), "seg-flags",
             "segment lengths must be >= 0")
    _require(bool(np.isin(first, (0, 1)).all()
                  and np.isin(last, (0, 1)).all()),
             "seg-flags", "seg first/last flags must be 0/1")
    nb = sched.num_blocks
    _require(blk_id.shape == blk_win.shape == (nb,), "blk-id-bounds",
             f"blk_id/blk_win shapes {blk_id.shape}/{blk_win.shape} != "
             f"({nb},)")
    _require(nb == 0 or (blk_id.min() >= 0 and blk_id.max() < nb),
             "blk-id-bounds", f"blk_id outside [0, {nb})")


def _schedule_coverage(sched, sw, sm, blk_win, win_ptr: np.ndarray) -> None:
    """The schedule against its view's ``win_ptr``: the segments of each
    window are contiguous and tile its block range ``[win_ptr[w],
    win_ptr[w+1])`` exactly once in ascending order, with the first/last
    flags on its first and last segment (the balanced kernels'
    accumulate/epilogue contract).  The reference walks the windows in a
    loop; this evaluates each window's four checks at once and raises the
    first failing check of the first failing window, as that loop does."""
    ns = sw.shape[0]
    w = win_ptr.shape[0] - 1
    nb = sched.num_blocks
    counts = np.diff(win_ptr)
    lo, ln, first, last = sm.T
    _require(ns == 0 or (sw.min() >= 0 and sw.max() < w), "seg-coverage",
             f"seg_win outside [0, {w})")
    _require(int(win_ptr[-1]) == nb, "seg-coverage",
             f"schedule num_blocks={nb} != owned blocks {int(win_ptr[-1])}")
    _require(ns or not w, "seg-coverage",
             "window 0 has no segment (empty windows keep one zero-length "
             "store-only segment)")
    s = np.arange(ns)
    nseg = np.bincount(sw, minlength=w)
    head = np.full(w, ns - 1)           # each window's first segment
    np.minimum.at(head, sw, s)
    tail = np.zeros(w, np.int64)        # and its last
    np.maximum.at(tail, sw, s)
    has = nseg >= 1
    contiguous = tail - head + 1 == nseg
    flags = (has & (first[head] == 1) & (last[tail] == 1)
             & (np.bincount(sw, weights=first, minlength=w) == 1)
             & (np.bincount(sw, weights=last, minlength=w) == 1))
    # a contiguous window's segments tile its range in order when their
    # lengths add up to its block count and each non-empty one starts
    # where the window's earlier ones stopped
    before = np.cumsum(ln) - ln
    start = win_ptr[sw] + before - before[head[sw]]
    misplaced = np.bincount(sw, weights=(ln != 0) & (lo != start),
                            minlength=w)
    span = ((np.bincount(sw, weights=ln, minlength=w) == counts)
            & (misplaced == 0))
    checks = np.stack([has, contiguous, flags, span])
    bad = np.nonzero(~checks.all(axis=0))[0]
    if bad.size:
        wi = int(bad[0])
        which = int(np.argmin(checks[:, wi]))
        _require(which != 0, "seg-coverage",
                 f"window {wi} has no segment (empty windows keep one "
                 "zero-length store-only segment)")
        _require(which != 1, "seg-coverage",
                 f"window {wi}'s segments are not contiguous")
        _require(which != 2, "seg-flags",
                 f"window {wi}'s first/last segment flags are wrong")
        raise ValidationError(
            "seg-coverage", f"window {wi}'s segments do not cover blocks "
            f"[{int(win_ptr[wi])}, {int(win_ptr[wi + 1])}) exactly once "
            "in order")
    _require(np.array_equal(blk_win, np.repeat(np.arange(w), counts)),
             "block-win-consistent",
             "schedule blk_win disagrees with win_ptr")


def validate_schedule(sched, blocked=None, check: Optional[str] = "full"):
    """Audit a :class:`~repro_torch.core.format.Schedule`.

    With ``blocked`` given, also proves the segments cover each window's
    block range exactly once, in ascending order, with correct first/last
    flags (:func:`_schedule_coverage`).
    """
    level = resolve_check(check)
    if level == "none":
        return sched
    if level == "cheap":
        cheap_guard(bool((sched.seg_meta[:, 1] >= 0).all()), "seg-flags",
                    "segment lengths must be >= 0")
        return sched
    sw, sm, blk_id, blk_win = _schedule_arrays(sched)
    _schedule_shape(sched, sw, sm, blk_id, blk_win)
    if blocked is not None:
        _schedule_coverage(sched, sw, sm, blk_win,
                           _np(blocked.win_ptr).astype(np.int64))
    return sched


def validate_sharded(part, blocked=None, check: Optional[str] = "full"):
    """Audit a :class:`~repro_torch.distributed.sparse_shard.
    ShardedSchedule`: its stacked shapes and, with ``blocked`` given, that
    each rank's ``row_own`` is exactly the rows of its segments' windows,
    that every output row has an owner, and that every scheduled value
    row has exactly one (the reference's invariants, in its order)."""
    level = resolve_check(check)
    if level == "none":
        return part
    if level == "cheap":
        cheap_guard(bool((part.seg_meta[:, :, 1] >= 0).all()), "seg-flags",
                    "sharded segment lengths must be >= 0")
        return part

    d = part.num_devices
    sw = _np(part.seg_win)
    sm = _np(part.seg_meta)
    row_own = _np(part.row_own)
    blk_own = _np(part.blk_own)
    _require(sw.ndim == 2 and sw.shape[0] == d and sm.shape[:2] == sw.shape
             and sm.shape[2] == 4, "shard-shape",
             f"seg_win/seg_meta shapes {sw.shape}/{sm.shape} inconsistent "
             f"with num_devices={d}")
    _require(row_own.shape[0] == d and blk_own.shape[0] == d, "shard-shape",
             f"ownership masks must lead with num_devices={d}")
    _require(bool(np.all(sm[:, :, 1] >= 0)), "seg-flags",
             "sharded segment lengths must be >= 0")
    if blocked is not None:
        w = blocked.num_windows
        # pad segments carry seg_win == W (one past the last window)
        _require(bool(sw.min() >= 0 and sw.max() <= w), "seg-coverage",
                 f"sharded seg_win outside [0, {w}]")
        m = blocked.shape[0]
        v = blocked.vector_size
        wptr = _np(blocked.win_ptr)
        # a straddled window is owned by every rank holding one of its
        # segments: the reduce adds the partials
        for dev in range(d):
            wins = np.unique(sw[dev][sw[dev] < w])
            rows = (wins[:, None] * v + np.arange(v)).reshape(-1)
            expect = np.zeros(m, bool)
            expect[rows[rows < m]] = True
            _require(np.array_equal(row_own[dev], expect),
                     "row-own-consistent",
                     f"device {dev}'s row_own disagrees with its segments")
        _require(bool(row_own.any(axis=0).all()), "row-own-cover",
                 "some output rows are owned by no device")
        owned_rows = int(wptr[-1]) * blocked.k_blk
        blk_count = blk_own[:, :owned_rows].astype(np.int64).sum(axis=0)
        _require(bool(np.all(blk_count == 1)), "blk-own-unique",
                 "each scheduled K-block value row must be owned by "
                 "exactly one device")
    return part


def guard_call(check: Optional[str], fmt, **operands) -> None:
    """An entry point's validation at the resolved ``check`` level: the
    format audited (:func:`validate`) and each dense operand guarded
    (:func:`guard_operand`); nothing at ``"none"``."""
    level = effective_check(check)
    if level != "none":
        validate(fmt, check=level)
        for name, x in operands.items():
            guard_operand(x, name)


def validate(obj, blocked=None, check: Optional[str] = "full"):
    """Type-dispatching audit of any of the format stack's four types."""
    from repro_torch.distributed.sparse_shard import ShardedSchedule

    from .format import BlockedMEBCRS, MEBCRS, Schedule

    if isinstance(obj, MEBCRS):
        return validate_format(obj, check=check)
    if isinstance(obj, BlockedMEBCRS):
        return validate_blocked(obj, check=check)
    if isinstance(obj, Schedule):
        return validate_schedule(obj, blocked=blocked, check=check)
    if isinstance(obj, ShardedSchedule):
        return validate_sharded(obj, blocked=blocked, check=check)
    raise TypeError(f"cannot validate object of type {type(obj).__name__}")


# ---------------------------------------------------------------------------
# The builders' checks (every level)
# ---------------------------------------------------------------------------


def check_coo(rows: np.ndarray, cols: np.ndarray, shape: Tuple[int, int],
              duplicates: str, check: str = "none") -> None:
    """Reject COO triplets outside ``shape`` and, with
    ``duplicates="error"``, repeated ``(row, col)`` coordinates; at level
    ``full`` with ``duplicates="sum"``, report the coordinates that will
    be coalesced with a :class:`ValidationWarning`."""
    m, k = shape
    if rows.size and (rows.min() < 0 or cols.min() < 0
                      or rows.max() >= m or cols.max() >= k):
        raise ValidationError(
            "coo-in-bounds", f"COO indices out of bounds for shape {shape}")
    if rows.size and (duplicates == "error" or check == "full"):
        elem_key = rows * k + cols
        n_dup = elem_key.size - np.unique(elem_key).size
        if n_dup and duplicates == "error":
            raise ValidationError("duplicate-coords",
                                  f"{n_dup} duplicate COO coordinate(s)")
        if n_dup:
            warnings.warn(ValidationWarning(
                f"[duplicate-coords] coalesced {n_dup} duplicate COO "
                "coordinate(s) by summation"), stacklevel=3)


def check_block_config(k_blk) -> None:
    """Reject a K-block size outside ``[1, 4096]``."""
    if not (isinstance(k_blk, int) and 1 <= k_blk <= 4096):
        raise ValidationError(
            "block-config", f"k_blk={k_blk!r} outside the sane range "
            "[1, 4096]")

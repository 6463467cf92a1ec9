"""Run plans of the block-parallel SpMM and attention kernels.

The TPU kernels (``_balanced_spmm_kernel``, ``_balanced_attn_kernel``)
carry a window's sum across its segments on a sequential grid.  CUDA
blocks run in no order, so ``spmm_balanced.cu`` and
``attention_balanced.cu`` carry the sum inside one thread block (SpMM) or
one warp (attention) instead, over a **run**: consecutive segments of the
schedule, in order, of about ``run_blk`` K-blocks, cut only at segment
boundaries.  A run walks its K-blocks in order with the accumulator in
registers (or, for attention, the online-softmax state in registers and
shared memory).  Within a run, consecutive segments of one window form a
**piece**; at the end of a piece the kernel stores the window's rows of
the output directly when the run holds the whole window, and otherwise
writes one partial, an **edge entry**, for the run edge that cut it.  So
a run leaves partials for at most two windows: the one cut at its start
and the one cut at its end.  The builder moves a cut to a window boundary
less than ``run_blk // 2`` K-blocks away, so runs seldom cut a window
that is shorter than a run.

The edge entries of a window are merged by a combine tree: a tree of
groups of up to ``COMBINE_FANIN`` consecutive entries of one window, one
level per launch, summed in fp64 (``spmm_balanced.cu``,
``attention_balanced.cu``).  Both kernels are bound by the bytes they
move (their headers give the figures), and the partials were the largest
part of it while the tree ran over every segment of a split window:
at split_blk = 1 on the Amazon replica the SpMM (N = 128) wrote and
read back one (8, 128) fp32 partial per segment, 0.93 GB on A and 1.59
GB on Aᵀ, and the attention (DV = 32) 0.25 and 0.42 GB.  Over run edges
the SpMM (``RUN_BLK`` 32) leaves none on A and 47 MB on Aᵀ, the attention
(``RUN_BLK`` 16) none and 25 MB: a hub window of Aᵀ (50,424 K-blocks)
has about 50,424 / run_blk entries instead of 50,424 (``chip_smoke.py``
phase 5 prints the runs, entries and partial bytes of each plan).

``split_blk = 0`` keeps every window one segment, so a hub window stays in
one run: the unsplit schedule keeps its meaning (one running sum per
window).  The plan is host data derived from the schedule's ``seg_win``
and ``seg_meta``, built once per :class:`~repro_torch.core.format.Schedule`
and run length and memoized on the schedule; the schedule itself stays the
reference's four arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.format import Schedule

__all__ = ["COMBINE_FANIN", "CombineTree", "RunPlan", "run_plan"]

COMBINE_FANIN = 32  # entries summed by one group of the tree


@dataclasses.dataclass(frozen=True, eq=False)
class CombineTree:
    """The merge order of the edge entries of a plan's split windows.

      meta    (G, 4) int32  per group: [first entry, entry count, window,
                            destination entry or -1 for the window's output]
      levels                each level's ``(first group, group count)``
      entries               entries of levels 1 and up (the fp64 scratch)
    """

    meta: torch.Tensor
    levels: Tuple[Tuple[int, int], ...]
    entries: int

    def level_ints(self) -> list:
        """``levels`` flattened, as the kernels' host array takes them."""
        return [x for level in self.levels for x in level]


@dataclasses.dataclass(frozen=True, eq=False)
class RunPlan:
    """A schedule cut into runs of about ``run_blk`` K-blocks.

      run_ptr (NR + 1,) int32  run r owns pieces [run_ptr[r], run_ptr[r+1])
      pieces  (P, 4)    int32  per piece: [window, first K-block, K-block
                               count, edge entry or -1 when the piece is
                               the whole window]
      entries                  edge entries (fp32 partials) of all pieces
      tree                     the combine tree over the edge entries
    """

    run_ptr: torch.Tensor
    pieces: torch.Tensor
    entries: int
    tree: CombineTree
    run_blk: int
    num_windows: int

    @property
    def num_runs(self) -> int:
        return int(self.run_ptr.shape[0]) - 1

    @property
    def num_pieces(self) -> int:
        return int(self.pieces.shape[0])


def _tree_arrays(win_ent: np.ndarray, fanin: int = COMBINE_FANIN):
    """``(meta, levels, entries)`` over the entries of every window that
    has more than one; window ``w`` owns entries ``[win_ent[w],
    win_ent[w+1])``.  Groups never cross windows; the groups of a level
    that are not their window's last write consecutive entries of the next
    level, so each window's entries stay contiguous."""
    nent = np.diff(win_ent)
    win = np.nonzero(nent > 1)[0]
    lo, cnt = win_ent[win], nent[win]
    metas, levels, g0, entries = [], [], 0, 0
    while win.size:
        ngrp = -(-cnt // fanin)
        first = np.cumsum(ngrp) - ngrp
        rank = np.arange(int(ngrp.sum())) - np.repeat(first, ngrp)
        g_lo = np.repeat(lo, ngrp) + rank * fanin
        g_cnt = np.minimum(fanin, np.repeat(cnt, ngrp) - rank * fanin)
        g_final = np.repeat(ngrp == 1, ngrp)
        dst = np.full(g_lo.shape, -1, np.int64)
        dst[~g_final] = entries + np.arange(int((~g_final).sum()))
        metas.append(np.stack([g_lo, g_cnt, np.repeat(win, ngrp), dst], 1))
        levels.append((g0, int(ngrp.sum())))
        g0 += int(ngrp.sum())
        keep = ngrp > 1
        lo = dst[first[keep]]
        entries += int((~g_final).sum())
        win, cnt = win[keep], ngrp[keep]
    meta = (np.concatenate(metas) if metas else np.zeros((0, 4), np.int64))
    return meta.astype(np.int32), tuple(levels), entries


def _run_cuts(seg_meta: np.ndarray, run_blk: int) -> np.ndarray:
    """First segment of each run, and the segment count last: one cut per
    ``run_blk`` K-blocks, at the nearest window boundary when one lies
    less than ``run_blk // 2`` K-blocks away (so no two cuts share one),
    else at the first segment boundary at or after it."""
    ns = seg_meta.shape[0]
    pos = np.concatenate([[0], np.cumsum(seg_meta[:, 1])])   # segment starts
    targets = np.arange(run_blk, pos[-1], run_blk)
    cut = np.searchsorted(pos, targets, "left")
    wstart = np.append(np.nonzero(seg_meta[:, 2])[0], ns)
    if targets.size and wstart.size > 1:
        j = np.searchsorted(pos[wstart], targets, "left")
        nxt = wstart[np.minimum(j, wstart.size - 1)]
        prv = wstart[np.maximum(j - 1, 0)]
        d_nxt, d_prv = pos[nxt] - targets, targets - pos[prv]
        near = np.where(d_nxt <= d_prv, nxt, prv)
        cut = np.where(np.minimum(d_nxt, d_prv) < run_blk // 2, near, cut)
    return np.unique(np.concatenate([[0], cut, [ns]])).astype(np.int64)


def _plan_arrays(seg_win: np.ndarray, seg_meta: np.ndarray, w: int,
                 run_blk: int):
    """``(run_ptr, pieces, win_ent)`` of the plan (host numpy)."""
    ns = seg_meta.shape[0]
    if ns == 0:
        return (np.zeros(1, np.int64), np.zeros((0, 4), np.int64),
                np.zeros(w + 1, np.int64))
    cuts = _run_cuts(seg_meta, run_blk)
    # The segments walk one contiguous block range in order: block
    # positions count from its first block (0 for a full schedule, the
    # rank's first for a rank-local one).
    real = np.nonzero(seg_meta[:, 1])[0]
    base = int(seg_meta[real[0], 0]) if real.size else 0
    pos = base + np.concatenate([[0], np.cumsum(seg_meta[:, 1])])
    first = np.nonzero(seg_meta[:, 2])[0]
    start = np.unique(np.concatenate([cuts[:-1], first]))   # piece starts
    end = np.append(start[1:], ns)
    whole = (seg_meta[start, 2] == 1) & (seg_meta[end - 1, 3] == 1)
    entry = np.where(whole, -1, np.cumsum(~whole) - 1)
    win = seg_win[start]
    pieces = np.stack([win, pos[start], pos[end] - pos[start], entry], 1)
    win_ent = np.zeros(w + 1, np.int64)
    win_ent[1:] = np.cumsum(np.bincount(win[~whole], minlength=w))
    return np.searchsorted(start, cuts), pieces, win_ent


def run_plan(op: str, schedule: Schedule, num_windows: int,
             run_blk: int) -> RunPlan:
    """The :class:`RunPlan` of ``schedule`` in runs of about ``run_blk``
    K-blocks, on the schedule's device, memoized on the schedule.  Raises
    ``ValueError`` naming ``op`` when the schedule does not cover
    ``num_windows`` windows (it belongs to another view); a rank-local
    schedule covers the windows its :class:`~repro_torch.core.format.
    LocalRange` records, with pieces only in its own range."""
    if run_blk < 1:
        raise ValueError(f"{op}: run_blk must be >= 1, got {run_blk}")
    plans = getattr(schedule, "_run_plans", None)
    if plans is None:
        plans = {}
        object.__setattr__(schedule, "_run_plans", plans)
    plan = plans.get(run_blk)
    if plan is None:
        # every window keeps at least one segment and seg_win ascends, so
        # a full schedule's window count is its last segment's window + 1
        sw = schedule.seg_win.cpu().numpy().astype(np.int64)
        meta = schedule.seg_meta.cpu().numpy().astype(np.int64)
        if schedule.local is not None:
            w = schedule.local.view_windows
        else:
            w = int(sw[-1]) + 1 if sw.size else 0
        run_ptr, pieces, win_ent = _plan_arrays(sw, meta, w, run_blk)
        tmeta, levels, tree_entries = _tree_arrays(win_ent)
        dev = schedule.seg_win.device
        plan = RunPlan(
            run_ptr=torch.from_numpy(run_ptr.astype(np.int32)).to(dev),
            pieces=torch.from_numpy(pieces.astype(np.int32)).to(dev),
            entries=int(win_ent[-1]),
            tree=CombineTree(torch.from_numpy(tmeta).to(dev), levels,
                             tree_entries),
            run_blk=run_blk, num_windows=w)
        plans[run_blk] = plan
    if plan.num_windows != num_windows:
        raise ValueError(f"{op}: the schedule is not this view's ({num_windows}"
                         f" windows, the schedule covers {plan.num_windows})")
    return plan

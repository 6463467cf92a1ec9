"""The combine tree of the block-parallel SpMM and attention kernels.

The TPU kernels carry a window's sum across its segments on a sequential
grid.  CUDA blocks run in no order, so ``spmm_balanced.cu`` and
``attention_balanced.cu`` write each segment of a split window as a
partial and merge the partials afterwards.  A hub window can own tens of
thousands of segments, so that merge is a tree: level 0 groups up to
``COMBINE_FANIN`` consecutive segments of one window into one entry of
level 1, and so on, until a window has one group left, which writes its
output.  The tree is host data derived from the schedule's ``seg_win``,
built once per :class:`~repro_torch.core.format.Schedule` and memoized on
it; the schedule itself stays the reference's four arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.format import Schedule

__all__ = ["COMBINE_FANIN", "CombineTree", "combine_tree"]

COMBINE_FANIN = 32  # entries summed by one group of the tree


@dataclasses.dataclass(frozen=True, eq=False)
class CombineTree:
    """The merge order of a schedule's split windows.

      meta    (G, 4) int32  per group: [first entry, entry count, window,
                            destination entry or -1 for the window's output]
      levels                each level's ``(first group, group count)``
      entries               entries of levels 1 and up (the fp64 scratch)
    """

    meta: torch.Tensor
    levels: Tuple[Tuple[int, int], ...]
    entries: int
    num_windows: int

    @property
    def splits_windows(self) -> bool:
        """Whether some window has more than one segment."""
        return bool(self.levels)

    def level_ints(self) -> list:
        """``levels`` flattened, as the kernels' host array takes them."""
        return [x for level in self.levels for x in level]


def _tree_arrays(win_seg: np.ndarray, fanin: int = COMBINE_FANIN):
    """``(meta, levels, entries)`` over the segments of every window that
    has more than one; window ``w`` owns segments ``[win_seg[w],
    win_seg[w+1])``.  Groups never cross windows; the groups of a level
    that are not their window's last write consecutive entries of the next
    level, so each window's entries stay contiguous."""
    nseg = np.diff(win_seg)
    win = np.nonzero(nseg > 1)[0]
    lo, cnt = win_seg[win], nseg[win]
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


def combine_tree(op: str, schedule: Schedule, num_windows: int) -> CombineTree:
    """The :class:`CombineTree` of ``schedule`` on its device, memoized on
    the schedule.  Raises ``ValueError`` naming ``op`` when the schedule
    does not cover ``num_windows`` windows (it belongs to another view)."""
    tree = getattr(schedule, "_combine_tree", None)
    if tree is None:
        # every window keeps at least one segment and seg_win ascends, so
        # the schedule's window count is its last segment's window + 1
        sw = schedule.seg_win.cpu().numpy().astype(np.int64)
        w = int(sw[-1]) + 1 if sw.size else 0
        win_seg = np.zeros(w + 1, np.int64)
        win_seg[1:] = np.cumsum(np.bincount(sw, minlength=w))
        meta, levels, entries = _tree_arrays(win_seg)
        tree = CombineTree(torch.from_numpy(meta).to(schedule.seg_win.device),
                           levels, entries, w)
        object.__setattr__(schedule, "_combine_tree", tree)
    if tree.num_windows != num_windows:
        raise ValueError(f"{op}: the schedule is not this view's ({num_windows}"
                         f" windows, the schedule covers {tree.num_windows})")
    return tree

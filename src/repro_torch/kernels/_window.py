"""Window plans of the window-parallel SpMM kernel (``csrc/spmm_window.cuh``).

The TPU kernel (``_fused_spmm_kernel``) runs its grid in order on one
core, so a window with many K-blocks costs only its share of the work.
``spmm_window.cuh`` gives a window's vectors to a group of threads that
sums them in registers, and one group on one SM would walk a hub window
long after every other window is done.  So every window of more than
``split_blk`` K-blocks is cut into ``ns = ceil(L / split_blk)`` **slices**
of equal size, slice ``i`` holding K-blocks ``[i * L // ns, (i + 1) * L //
ns)`` of the window's ``L``, each at most ``split_blk`` long.  A thread
block is ``groups`` slice groups; ``cluster`` blocks form a thread-block
cluster.  The plan's work items ("tasks"), one cluster each, in launch
order:

  * **long** windows (more than ``groups * split_blk`` K-blocks), longest
    first: one per cluster, group ``j = rank * groups + g`` walking slices
    ``[j * ns // (C G), (j + 1) * ns // (C G))``;
  * **medium** windows (more than ``split_blk``), longest first: ``C`` per
    cluster, one per block, group ``g`` walking slices ``[g * ns // G,
    (g + 1) * ns // G)``;
  * **packs** of ``C * G`` consecutive windows, one per group; a window
    longer than ``split_blk`` is skipped there (it has its own task).

Each slice is one fp32 running sum in vector order, added into its group's
sum at the slice's end; a window's group sums are added in group order, and
a long window's block sums in rank order, so the order is fixed and a
window of at most ``split_blk`` K-blocks keeps the unsplit kernel's single
running sum.  ``groups`` fills a block of ``MAX_THREADS`` threads with
column tiles of ``n_tile`` (:func:`slice_groups`), and ``cluster`` is the
smallest power of two that gives the longest window a block per ``groups``
of its slices, at most ``MAX_CLUSTER``; with no long window it is 1 (no
cluster launch).  A plan without split windows packs ``PACK_WARPS``
windows into a block of one-warp groups, and one window into a block of a
wider column tile, instead: the kernel then runs a variant without the
split path, whose small blocks keep more windows in flight on an SM (and
a wider tile's warps share one ring of chunks).  The plan is host data derived from ``win_ptr``, built
once per ``win_ptr`` tensor, split length and column tile and memoized on
the tensor (views made by ``with_values`` share it), with ``split_ids`` on
``win_ptr``'s device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["SPLIT_BLK", "MAX_CLUSTER", "MAX_THREADS", "PACK_WARPS",
           "LANES", "WindowPlan", "LanePlan", "slice_groups", "window_plan",
           "lane_plan"]

SPLIT_BLK = 32      # longest window (K-blocks) walked by one group unsplit
MAX_CLUSTER = 16    # blocks per cluster (above 8 the size is non-portable)
MAX_THREADS = 512   # threads per block, groups * n_tile
MAX_GROUPS = 16
PACK_WARPS = 4      # one-warp groups per block of a plan without split windows
LANES = 32          # slices per lane group of the non-coalesced SpMM


def slice_groups(n_tile: int) -> int:
    """Slice groups per block for a column tile of ``n_tile`` threads: the
    largest power of two with at most ``MAX_THREADS`` threads in all."""
    g = 1
    while 2 * g <= MAX_GROUPS and 2 * g * n_tile <= MAX_THREADS:
        g *= 2
    return g


@dataclasses.dataclass(frozen=True, eq=False)
class WindowPlan:
    """The tasks of one window-parallel SpMM launch.

      split_ids (num_long + num_medium,) int32  long windows, then medium
                                                ones, each longest first
    """

    split_ids: torch.Tensor
    num_long: int
    num_medium: int
    num_windows: int
    split_blk: int
    groups: int
    cluster: int

    @property
    def num_tasks(self) -> int:
        pack = self.cluster * self.groups
        return (self.num_long + -(-self.num_medium // self.cluster)
                + -(-self.num_windows // pack))

    def slices(self, win_ptr) -> np.ndarray:
        """Every slice of the plan, in the kernel's order of summation:
        rows ``[window, slice, first K-block, K-block count, task, rank,
        group]``.  A window's slices ascend; its sum adds them by group,
        then by rank.  ``win_ptr`` is the view's (host or device)."""
        wp = np.asarray(torch.as_tensor(win_ptr).cpu(), np.int64)
        lens = np.diff(wp)
        s, g, c = self.split_blk, self.groups, self.cluster
        rows = []
        ids = self.split_ids.cpu().numpy().astype(np.int64)
        medium_tasks = -(-self.num_medium // c)
        for i, w in enumerate(ids):
            ln = int(lens[w])
            ns = -(-ln // s)
            if i < self.num_long:
                task, ranks, tg = i, range(c), c * g
            else:
                k = i - self.num_long
                task, ranks, tg = self.num_long + k // c, [k % c], g
            for rank in ranks:
                for grp in range(g):
                    j = rank * g + grp if i < self.num_long else grp
                    for sl in range(j * ns // tg, (j + 1) * ns // tg):
                        lo = sl * ln // ns
                        rows.append((w, sl, wp[w] + lo,
                                     (sl + 1) * ln // ns - lo, task, rank,
                                     grp))
        for w in np.nonzero(lens <= s)[0]:
            p, j = divmod(int(w), c * g)
            rows.append((w, 0, wp[w], lens[w], self.num_long + medium_tasks
                         + p, j // g, j % g))
        out = np.asarray(rows, np.int64).reshape(-1, 7)
        return out[np.lexsort((out[:, 1], out[:, 0]))]


def _plan(win_ptr: np.ndarray, split_blk: int, groups: int):
    lens = np.diff(win_ptr.astype(np.int64))
    long_ = np.nonzero(lens > groups * split_blk)[0]
    medium = np.nonzero((lens > split_blk) & (lens <= groups * split_blk))[0]
    # longest first (stable: ties by window id)
    long_ = long_[np.argsort(-lens[long_], kind="stable")]
    medium = medium[np.argsort(-lens[medium], kind="stable")]
    cluster = 1
    if long_.size:
        slices = -(-int(lens[long_[0]]) // split_blk)
        while cluster < min(-(-slices // groups), MAX_CLUSTER):
            cluster *= 2
    return np.concatenate([long_, medium]), long_.size, medium.size, cluster


def window_plan(op: str, win_ptr: torch.Tensor, split_blk: int,
                n_tile: int) -> WindowPlan:
    """The :class:`WindowPlan` of a view's ``win_ptr`` for windows split
    above ``split_blk`` K-blocks and column tiles of ``n_tile`` threads,
    memoized on the tensor; ``split_ids`` lives on its device.  Raises
    ``ValueError`` naming ``op`` on a ``split_blk`` below 1."""
    if split_blk < 1:
        raise ValueError(f"{op}: split_blk must be >= 1, got {split_blk}")
    plans = getattr(win_ptr, "_window_plans", None)
    if plans is None:
        plans = {}
        win_ptr._window_plans = plans
    key = (split_blk, n_tile)
    plan = plans.get(key)
    if plan is None:
        wp = win_ptr.cpu().numpy()
        groups = slice_groups(n_tile)
        ids, n_long, n_medium, cluster = _plan(wp, split_blk, groups)
        if ids.size == 0:
            groups = PACK_WARPS if n_tile == 32 else 1
        plan = WindowPlan(
            split_ids=torch.from_numpy(ids.astype(np.int32)).to(
                win_ptr.device),
            num_long=int(n_long), num_medium=int(n_medium),
            num_windows=int(win_ptr.shape[0]) - 1, split_blk=split_blk,
            groups=groups, cluster=cluster)
        plans[key] = plan
    return plan


@dataclasses.dataclass(frozen=True, eq=False)
class LanePlan:
    """The slices of one non-coalesced SpMM launch
    (``csrc/spmm_noncoalesced.cu``), one per lane.

    The windows are cut into the slices of :class:`WindowPlan` (a window of
    ``L`` K-blocks into ``ns = max(1, ceil(L / split_blk))`` slices, slice
    ``i`` holding blocks ``[i * L // ns, (i + 1) * L // ns)``), listed in
    window order, a window's slices in order; an empty window is one empty
    slice.  Lane group ``g`` (the 32 lanes of a warp) takes slices ``[32 g,
    32 g + 32)``.  A window's slices in one lane group form a **run**; the
    run's last lane holds the run's sum (a segmented scan over the lanes),
    and stores it into C when the run is the whole window, else as one
    fp32 partial, which a second pass adds in run order.

      slice_ptr (S + 1,) int32  slice ``s`` holds K-blocks
                                ``[slice_ptr[s], slice_ptr[s + 1])``
      slice_win (S,) int32      its window
      slice_out (S,) int32      -1: the last slice of a run that is its
                                whole window (stores C); ``p >= 0``: the
                                last slice of a run that is part of its
                                window (stores partial ``p``); -2: not the
                                last slice of its run
      part_win (NPW,) int32     windows with partials, ascending
      part_ptr (NPW + 1,) int32 window ``part_win[i]``'s partials
                                ``[part_ptr[i], part_ptr[i + 1])``, in run
                                order
    """

    slice_ptr: torch.Tensor
    slice_win: torch.Tensor
    slice_out: torch.Tensor
    part_win: torch.Tensor
    part_ptr: torch.Tensor
    num_slices: int
    num_partials: int
    split_blk: int

    @property
    def num_part_windows(self) -> int:
        return int(self.part_win.shape[0])


def _lane_plan(win_ptr: np.ndarray, split_blk: int):
    wp = win_ptr.astype(np.int64)
    lens = np.diff(wp)
    ns = np.maximum(1, -(-lens // split_blk))
    first_slice = np.cumsum(ns) - ns
    win = np.repeat(np.arange(lens.size), ns)
    idx = np.arange(win.size) - first_slice[win]
    slice_ptr = np.append(wp[win] + idx * lens[win] // ns[win], wp[-1])
    grp = np.arange(win.size) // LANES
    # the last slice of each run (a window's slices in one lane group)
    last = np.ones(win.size, bool)
    last[:-1] = (win[1:] != win[:-1]) | (grp[1:] != grp[:-1])
    whole = grp[first_slice] == grp[first_slice + ns - 1]
    out = np.full(win.size, -2, np.int64)
    ends = np.nonzero(last)[0]
    out[ends[whole[win[ends]]]] = -1
    part_ends = ends[~whole[win[ends]]]
    out[part_ends] = np.arange(part_ends.size)
    part_win, counts = np.unique(win[part_ends], return_counts=True)
    part_ptr = np.concatenate([[0], np.cumsum(counts)])
    return slice_ptr, win, out, part_win, part_ptr


def lane_plan(op: str, win_ptr: torch.Tensor, split_blk: int) -> LanePlan:
    """The :class:`LanePlan` of a view's ``win_ptr`` for windows cut above
    ``split_blk`` K-blocks, memoized on the tensor; its arrays live on
    ``win_ptr``'s device.  Raises ``ValueError`` naming ``op`` on a
    ``split_blk`` below 1."""
    if split_blk < 1:
        raise ValueError(f"{op}: split_blk must be >= 1, got {split_blk}")
    plans = getattr(win_ptr, "_lane_plans", None)
    if plans is None:
        plans = {}
        win_ptr._lane_plans = plans
    plan = plans.get(split_blk)
    if plan is None:
        arrays = _lane_plan(win_ptr.cpu().numpy(), split_blk)
        dev = [torch.from_numpy(a.astype(np.int32)).to(win_ptr.device)
               for a in arrays]
        plan = LanePlan(*dev, num_slices=int(arrays[1].size),
                        num_partials=int(arrays[4][-1]), split_blk=split_blk)
        plans[split_blk] = plan
    return plan

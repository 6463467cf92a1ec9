"""Multi-device sharded sparse ops over a ``DeviceMesh`` of ranks.

Counterpart of ``repro.distributed.sparse_shard`` (DESIGN.md §12).  The
block-parallel :class:`~repro_torch.core.format.Schedule` already cuts a
matrix into uniform, independent segments; this module splits its
segment list into one **contiguous range per rank** of the mesh's
``"data"`` dim, cut where the cumulative per-segment cost
(:func:`segment_costs`, the reference's cell model, kept as it is so the
cuts match) crosses each rank's fair share:

  * :func:`partition_schedule` builds a :class:`ShardedSchedule`, the
    reference's stacked per-rank arrays, array for array.  With
    ``window_split=True`` a cut may fall inside a hub window (each side
    stores a partial and the reduce adds them); ``window_split=False``
    snaps cuts to window starts, which the attention needs (a window's
    online softmax cannot cross ranks).
  * :meth:`ShardedSchedule.local` hands a rank its range as a rank-local
    ``Schedule`` with the pads stripped, which the balanced kernels
    (``spmm_balanced_cuda``, ``sddmm_balanced_cuda``,
    ``attention_balanced_cuda``) take as they are: they write the rank's
    rows and zeros elsewhere.
  * :func:`spmm_sharded_local` / :func:`sddmm_sharded_local` /
    :func:`attention_sharded_local` are that one local launch: the
    rank's masked partial.  :func:`spmm_sharded` /
    :func:`sddmm_sharded` / :func:`attention_sharded` add the
    collective: ``all_reduce(SUM)`` over the data group, where the
    reference has its ``psum``.

Row parallelism needs no halo: every output row lives in one window, and
a rank's launch writes exactly its windows' rows (its blocks' rows for
the SDDMM), so one sum over the data group reassembles the output, exact
except on windows split across ranks.  The ``"model"`` dim carries heads
(3-D operands), output columns (a 2-D SpMM) or the contracted features (a
2-D SDDMM, summed over the model group), as the reference picks them;
every rank then gathers the model group's slices, so each rank returns
the whole output.  Operands are replicated: every rank holds the whole
dense operands and the whole pattern.

Narrow partials (bf16, or the bf16 C of an int8 SpMM) are reduced in
fp32 and rounded once, where the reference's psum adds them in bf16: a
row that one rank owns comes back bit for bit; a split window's sum is
rounded once instead of once per add.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core import dispatch as _dispatch
from repro_torch.core.format import (BlockedMEBCRS, LocalRange, Schedule,
                                     block_format)
from repro_torch.core.quantize import cast_precision
from repro_torch.core.sddmm import with_values
from repro_torch.core.spmm import apply_precision

from .ctx import _resolve_mesh

__all__ = [
    "ShardedSchedule",
    "partition_schedule",
    "sharded_schedule",
    "segment_costs",
    "device_balance",
    "batch_costs",
    "spmm_sharded_local",
    "sddmm_sharded_local",
    "attention_sharded_local",
    "spmm_sharded",
    "sddmm_sharded",
    "attention_sharded",
]


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedSchedule:
    """Per-rank partition of a :class:`~repro_torch.core.format.Schedule`.

    The reference's arrays, with its names and values, stacked per rank
    (leading dim ``num_devices``) and padded to one shape:

      seg_win  (D, NSL)    int32  local segments' global windows; pads
                                  point at the dummy window ``num_windows``
      seg_meta (D, NSL, 4) int32  [first block, block count, seg_first,
                                  seg_last], the flags recomputed per
                                  rank; pads ``[0, 0, 1, 1]``
      blk_id   (D, NBL)    int32  the rank's scheduled K-blocks, padded
                                  with a repeat of its first
      blk_win  (D, NBL)    int32  owning window of each
      row_own  (D, M)      bool   output rows the rank writes
      blk_own  (D, NNZP)   bool   value rows the rank writes (SDDMM)

    and the segment batches of the overlapped ops (each rank's range cut
    again into ``n_batches`` by the same cost model):
    ``bseg_win``/``bseg_meta`` (D, NB, NSLB[, 4]), ``brow_idx`` (D, NB, R)
    global output rows of a batch's windows (pads ``M``), ``bblk_id``/
    ``bblk_win`` (D, NB, NBLB) and ``bval_idx`` (D, NB, RV) global value
    rows of a batch's blocks (pads ``NNZP``).

    The tensors lie on the blocked view's device.  The kernels never see
    a pad: :meth:`local` and :meth:`local_batch` strip them.
    """

    seg_win: torch.Tensor
    seg_meta: torch.Tensor
    blk_id: torch.Tensor
    blk_win: torch.Tensor
    row_own: torch.Tensor
    blk_own: torch.Tensor
    num_devices: int
    num_windows: int
    split_blk: int
    window_split: bool
    num_blocks: int
    bseg_win: Optional[torch.Tensor] = None
    bseg_meta: Optional[torch.Tensor] = None
    brow_idx: Optional[torch.Tensor] = None
    bblk_id: Optional[torch.Tensor] = None
    bblk_win: Optional[torch.Tensor] = None
    bval_idx: Optional[torch.Tensor] = None
    n_batches: int = 1

    def _host(self, name: str) -> np.ndarray:
        """Host copy of one stacked array, made once."""
        memo = self.__dict__.setdefault("_host_arrays", {})
        if name not in memo:
            memo[name] = getattr(self, name).cpu().numpy().astype(np.int64)
        return memo[name]

    def _memo(self, key, build):
        memo = self.__dict__.setdefault("_locals", {})
        if key not in memo:
            memo[key] = build()
        return memo[key]

    def _local(self, sw, sm, bid, bwin) -> Schedule:
        """A rank-local schedule from one padded slot (pads stripped)."""
        n = int(np.count_nonzero(sw < self.num_windows))
        sw, sm = sw[:n], sm[:n]
        blk_lo, blk_hi = _range_blocks(sm)
        cnt = blk_hi - blk_lo
        dev = self.seg_win.device

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

        return Schedule(
            seg_win=t(sw), seg_meta=t(sm.reshape(n, 4)), blk_id=t(bid[:cnt]),
            blk_win=t(bwin[:cnt]), split_blk=self.split_blk, num_blocks=cnt,
            local=LocalRange(view_blocks=self.num_blocks,
                             view_windows=self.num_windows,
                             win_lo=int(sw[0]) if n else 0,
                             win_hi=int(sw[-1]) + 1 if n else 0,
                             blk_lo=blk_lo, blk_hi=blk_hi))

    def local(self, rank: int) -> Schedule:
        """Rank ``rank``'s range as a rank-local schedule on the view's
        device, pads stripped (memoized)."""
        return self._memo(rank, lambda: self._local(
            self._host("seg_win")[rank], self._host("seg_meta")[rank],
            self._host("blk_id")[rank], self._host("blk_win")[rank]))

    def local_batch(self, rank: int, t: int) -> Schedule:
        """Segment batch ``t`` of rank ``rank`` as a rank-local schedule
        (memoized)."""
        if self.bseg_win is None:
            raise ValueError("the partition has no segment batches")
        return self._memo((rank, t), lambda: self._local(
            self._host("bseg_win")[rank, t], self._host("bseg_meta")[rank, t],
            self._host("bblk_id")[rank, t], self._host("bblk_win")[rank, t]))


# Fixed per-grid-cell issue overhead of the reference's cell model
# (bytes-equivalent), kept as it is so the port cuts where the reference
# cuts.
_FIXED_CELL_BYTES = 512


def segment_costs(blocked: BlockedMEBCRS, schedule: Schedule, *,
                  n_blk: int = 128, value_bytes: int = 4,
                  fixed_cell_bytes: int = _FIXED_CELL_BYTES) -> np.ndarray:
    """Per-segment cost (bytes-equivalent) under the reference's cell
    model: a fixed issue overhead, the bytes of the segment's K-blocks
    (values and the K_BLK dense rows of an ``n_blk`` tile) and the output
    tile's store, charged to the window's last segment."""
    v = blocked.vector_size
    k_blk = blocked.k_blk
    meta = schedule.seg_meta.cpu().numpy().astype(np.int64)
    block_bytes = k_blk * (v + n_blk) * value_bytes
    store_bytes = v * n_blk * value_bytes
    return (fixed_cell_bytes + meta[:, 1] * block_bytes
            + meta[:, 3] * store_bytes).astype(np.float64)


def _allowed_cuts(seg_win: np.ndarray, window_split: bool) -> np.ndarray:
    """Legal cut positions (segment indices incl. 0 and NS): everywhere,
    or window starts only when ``window_split`` is off."""
    ns = seg_win.size
    if window_split:
        return np.arange(ns + 1)
    starts = np.flatnonzero(np.diff(seg_win) != 0) + 1
    return np.concatenate([[0], starts, [ns]])


def _cut_points(costs: np.ndarray, num_devices: int,
                allowed: np.ndarray) -> np.ndarray:
    """Contiguous cuts (D + 1 monotone segment indices) balancing
    ``costs``: cut ``i`` lands on the ``allowed`` boundary whose cost
    prefix is nearest ``i / D`` of the total."""
    ns = costs.size
    prefix = np.concatenate([[0.0], np.cumsum(costs)])
    total = prefix[-1]
    cuts = [0]
    for i in range(1, num_devices):
        target = total * i / num_devices
        pa = prefix[allowed]
        j = int(np.searchsorted(pa, target))
        cands = [c for c in (j - 1, j) if 0 <= c < allowed.size]
        best = min(cands, key=lambda c: abs(pa[c] - target))
        cuts.append(max(int(allowed[best]), cuts[-1]))
    cuts.append(ns)
    return np.asarray(cuts, np.int64)


def _run_flags(seg_win: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Window-run first/last flags recomputed for a local segment range."""
    n_loc = seg_win.size
    run_first = np.ones(n_loc, bool)
    run_first[1:] = seg_win[1:] != seg_win[:-1]
    run_last = np.ones(n_loc, bool)
    run_last[:-1] = seg_win[:-1] != seg_win[1:]
    return run_first, run_last


def _range_blocks(seg_meta: np.ndarray) -> Tuple[int, int]:
    """``[blk_lo, blk_hi)``, the global block range of a segment slice."""
    seg_meta = np.asarray(seg_meta).reshape(-1, 4)
    lens = seg_meta[:, 1]
    real = lens > 0
    if real.any():
        return (int(seg_meta[:, 0][real].min()),
                int((seg_meta[:, 0] + lens)[real].max()))
    return 0, 0


def _range_rows(seg_win: np.ndarray, v: int, m: int) -> np.ndarray:
    """Global output rows (< m) of the windows a segment slice touches."""
    owned = np.unique(seg_win)
    rows = (owned[:, None] * v + np.arange(v)).reshape(-1)
    return rows[rows < m]


def _fill_slot(sw, sm, seg_win, seg_meta, lo, hi):
    """Write segments ``[lo, hi)`` into one padded slot, flags recomputed
    for the range (a straddled window re-inits on each side)."""
    n_loc = hi - lo
    sw[:n_loc] = seg_win[lo:hi]
    sm[:n_loc] = seg_meta[lo:hi]
    run_first, run_last = _run_flags(seg_win[lo:hi])
    sm[:n_loc, 2] = run_first
    sm[:n_loc, 3] = run_last


def partition_schedule(blocked: BlockedMEBCRS,
                       schedule: Optional[Schedule] = None,
                       num_devices: int = 1, *, split_blk: int = 1,
                       window_split: bool = True,
                       n_blk: int = 128,
                       n_batches: int = 1,
                       check: Optional[str] = None) -> ShardedSchedule:
    """Split a Schedule into ``num_devices`` balanced contiguous ranges.

    Host-side numpy, like :func:`~repro_torch.core.format.build_schedule`;
    the result lands on ``blocked``'s device.  ``window_split=False``
    cuts only at window starts (the attention's partition).
    ``n_batches`` cuts each rank's range again into that many contiguous
    segment batches by the same cost model (the overlapped ops' unit;
    batch cuts follow the ``window_split`` rule).  Ranks (or batches)
    beyond the non-empty segments come out store-only: pads only, so the
    local launch stores zeros.  ``check`` audits the inputs and the
    result (:func:`~repro_torch.core.validate.validate_sharded`).
    """
    from repro_torch.core import validate as _validate

    level = _validate.resolve_check(check)
    if num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    if n_batches < 1:
        raise ValueError(f"n_batches must be >= 1, got {n_batches}")
    if schedule is None:
        schedule = blocked.schedule(split_blk)
    _validate.validate_blocked(blocked, check=level)
    _validate.validate_schedule(schedule, blocked=blocked, check=level)
    w = blocked.num_windows
    v = blocked.vector_size
    k_blk = blocked.k_blk
    m = blocked.shape[0]
    nnzp = int(blocked.cols.shape[0])
    seg_win = schedule.seg_win.cpu().numpy().astype(np.int64)
    seg_meta = schedule.seg_meta.cpu().numpy().astype(np.int64)
    blk_win_g = schedule.blk_win.cpu().numpy().astype(np.int64)
    d, nb = num_devices, n_batches

    costs = segment_costs(blocked, schedule, n_blk=n_blk)
    cuts = _cut_points(costs, d, _allowed_cuts(seg_win, window_split))

    nsl = max(int(np.diff(cuts).max()) if cuts.size > 1 else 0, 1)
    sw = np.full((d, nsl), w, np.int64)               # pad → dummy window
    sm = np.zeros((d, nsl, 4), np.int64)
    sm[:, :, 2:] = 1                                  # pad: store-only zero
    row_own = np.zeros((d, m), bool)
    blk_own = np.zeros((d, nnzp), bool)
    blk_ranges = []
    bat_ranges = []
    for dev in range(d):
        lo, hi = int(cuts[dev]), int(cuts[dev + 1])
        if hi > lo:
            _fill_slot(sw[dev], sm[dev], seg_win, seg_meta, lo, hi)
            row_own[dev, _range_rows(seg_win[lo:hi], v, m)] = True
        blk_lo, blk_hi = _range_blocks(seg_meta[lo:hi])
        blk_ranges.append((blk_lo, blk_hi))
        blk_own[dev, blk_lo * k_blk: blk_hi * k_blk] = True
        bcuts = lo + _cut_points(
            costs[lo:hi], nb, _allowed_cuts(seg_win[lo:hi], window_split))
        bat_ranges.append([(int(bcuts[b]), int(bcuts[b + 1]))
                           for b in range(nb)])

    def block_grid(shape, ranges):
        bid = np.zeros(shape, np.int64)
        bwin = np.zeros(shape, np.int64)
        if shape[-1] == 0:                  # no scheduled blocks at all
            return bid, bwin
        flat_id = bid.reshape(-1, shape[-1])
        flat_win = bwin.reshape(-1, shape[-1])
        for i, (lo, hi) in enumerate(ranges):
            pad_id = lo if hi > lo else 0
            flat_id[i, :] = pad_id           # pad: a repeat of the first
            if blk_win_g.size:
                flat_win[i, :] = blk_win_g[pad_id]
            flat_id[i, :hi - lo] = np.arange(lo, hi)
            flat_win[i, :hi - lo] = blk_win_g[lo:hi]
        return bid, bwin

    nbl = max((hi - lo for lo, hi in blk_ranges), default=0)
    bid, bwin = block_grid((d, nbl), blk_ranges)

    # ---- segment-batch arrays ------------------------------------------
    flat_bat = [r for row in bat_ranges for r in row]
    nslb = max(max((hi - lo for lo, hi in flat_bat), default=0), 1)
    bsw = np.full((d * nb, nslb), w, np.int64)
    bsm = np.zeros((d * nb, nslb, 4), np.int64)
    bsm[:, :, 2:] = 1
    row_lists, bat_blk_ranges = [], []
    for i, (lo, hi) in enumerate(flat_bat):
        rows = np.zeros(0, np.int64)
        if hi > lo:
            _fill_slot(bsw[i], bsm[i], seg_win, seg_meta, lo, hi)
            rows = _range_rows(seg_win[lo:hi], v, m)
        row_lists.append(rows)
        bat_blk_ranges.append(_range_blocks(seg_meta[lo:hi]))

    r_max = max((r.size for r in row_lists), default=0) or 1
    bri = np.full((d * nb, r_max), m, np.int64)       # pad → zero-masked
    for i, rows in enumerate(row_lists):
        bri[i, :rows.size] = rows
    nblb = max((hi - lo for lo, hi in bat_blk_ranges), default=0) or 1
    bbi, bbw = block_grid((d * nb, nblb), bat_blk_ranges)
    rv_max = max((hi - lo for lo, hi in bat_blk_ranges),
                 default=0) * k_blk or 1
    bvi = np.full((d * nb, rv_max), nnzp, np.int64)   # pad → zero-masked
    for i, (lo, hi) in enumerate(bat_blk_ranges):
        bvi[i, :(hi - lo) * k_blk] = np.arange(lo * k_blk, hi * k_blk)

    dev_ = blocked.win_ptr.device

    def t(a, shape=None, dtype=torch.int32):
        a = a if shape is None else a.reshape(shape)
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(dev_)

    part = ShardedSchedule(
        seg_win=t(sw), seg_meta=t(sm), blk_id=t(bid), blk_win=t(bwin),
        row_own=t(row_own, dtype=torch.bool),
        blk_own=t(blk_own, dtype=torch.bool),
        num_devices=d, num_windows=w, split_blk=schedule.split_blk,
        window_split=window_split, num_blocks=schedule.num_blocks,
        bseg_win=t(bsw, (d, nb, nslb)), bseg_meta=t(bsm, (d, nb, nslb, 4)),
        brow_idx=t(bri, (d, nb, r_max)), bblk_id=t(bbi, (d, nb, nblb)),
        bblk_win=t(bbw, (d, nb, nblb)), bval_idx=t(bvi, (d, nb, rv_max)),
        n_batches=nb)
    return _validate.validate_sharded(part, blocked=blocked, check=level)


def sharded_schedule(blocked: BlockedMEBCRS, num_devices: int, *,
                     split_blk: int = 1, window_split: bool = True,
                     n_blk: int = 128, n_batches: int = 1,
                     schedule: Optional[Schedule] = None) -> ShardedSchedule:
    """Memoized :func:`partition_schedule` on the blocked view (per
    ``(split_blk, D, window_split, n_blk, n_batches)``).  An explicit
    ``schedule`` bypasses the memo: the key cannot see it."""
    if schedule is not None:
        return partition_schedule(blocked, schedule, num_devices,
                                  split_blk=split_blk,
                                  window_split=window_split, n_blk=n_blk,
                                  n_batches=n_batches)
    memo = getattr(blocked, "_shard_plans", None)
    if memo is None:
        memo = {}
        object.__setattr__(blocked, "_shard_plans", memo)
    key = (split_blk, num_devices, window_split, n_blk, n_batches)
    if key not in memo:
        memo[key] = partition_schedule(blocked, None, num_devices,
                                       split_blk=split_blk,
                                       window_split=window_split,
                                       n_blk=n_blk, n_batches=n_batches)
    return memo[key]


def device_balance(blocked: BlockedMEBCRS, num_devices: int, *,
                   schedule: Optional[Schedule] = None, split_blk: int = 1,
                   window_split: bool = True, n_blk: int = 128) -> dict:
    """Per-rank cost totals of the partition the sharded ops run:
    ``{"costs": [per-rank cost], "max_over_mean": float}``."""
    if schedule is None:
        schedule = blocked.schedule(split_blk)
    costs = segment_costs(blocked, schedule, n_blk=n_blk)
    seg_win = schedule.seg_win.cpu().numpy()
    cuts = _cut_points(costs, num_devices,
                       _allowed_cuts(seg_win, window_split))
    per_dev = [float(costs[cuts[i]:cuts[i + 1]].sum())
               for i in range(num_devices)]
    mean = float(np.mean(per_dev)) if per_dev else 0.0
    return {"costs": per_dev,
            "max_over_mean": (max(per_dev) / mean) if mean > 0 else 1.0}


def batch_costs(blocked: BlockedMEBCRS, num_devices: int, n_batches: int, *,
                schedule: Optional[Schedule] = None, split_blk: int = 1,
                window_split: bool = True, n_blk: int = 128) -> dict:
    """Per-(rank, batch) ``costs`` (D, NB) and output ``rows`` (D, NB) of
    the overlap partition, host numpy; ``costs.sum(axis=1)`` equals
    :func:`device_balance`'s totals."""
    if schedule is None:
        schedule = blocked.schedule(split_blk)
    costs = segment_costs(blocked, schedule, n_blk=n_blk)
    seg_win = schedule.seg_win.cpu().numpy()
    v = blocked.vector_size
    m = blocked.shape[0]
    cuts = _cut_points(costs, num_devices,
                       _allowed_cuts(seg_win, window_split))
    c = np.zeros((num_devices, n_batches), np.float64)
    r = np.zeros((num_devices, n_batches), np.int64)
    for dev in range(num_devices):
        lo, hi = int(cuts[dev]), int(cuts[dev + 1])
        bcuts = lo + _cut_points(
            costs[lo:hi], n_batches,
            _allowed_cuts(seg_win[lo:hi], window_split))
        for b in range(n_batches):
            blo, bhi = int(bcuts[b]), int(bcuts[b + 1])
            c[dev, b] = float(costs[blo:bhi].sum())
            if bhi > blo:
                r[dev, b] = _range_rows(seg_win[blo:bhi], v, m).size
    return {"costs": c, "rows": r}


# ---------------------------------------------------------------------------
# The mesh: sizes, ranks, groups and the checks of a call
# ---------------------------------------------------------------------------


def _axis(mesh: DeviceMesh, name: str) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def _model_axis(mesh: DeviceMesh) -> Tuple[Optional[str], int]:
    tp = _axis(mesh, "model")
    return ("model", tp) if tp > 1 else (None, 1)


def _check_part(part: ShardedSchedule, mesh: DeviceMesh, *,
                window_aligned: bool = False) -> None:
    ndev = _axis(mesh, "data")
    if part.num_devices != ndev:
        raise ValueError(f"partition built for {part.num_devices} devices, "
                         f"mesh 'data' axis has {ndev}")
    if window_aligned and part.window_split:
        raise ValueError("attention_sharded needs a window-aligned "
                         "partition (window_split=False): online-softmax "
                         "statistics cannot cross devices")


def _check_devices(op: str, mesh: DeviceMesh, *tensors) -> None:
    """Raise unless every tensor lies on the mesh's device type (CUDA
    tensors on an NCCL mesh, CPU tensors on a gloo one): nothing moves
    between the host and the card behind the caller's back."""
    got = {t.device.type for t in tensors if isinstance(t, torch.Tensor)}
    if got != {mesh.device_type}:
        raise ValueError(f"{op}: the mesh is on {mesh.device_type!r} but the "
                         f"operands are on {sorted(got)}")


def _blocked(fmt, k_blk: int, device) -> BlockedMEBCRS:
    return (fmt if isinstance(fmt, BlockedMEBCRS)
            else block_format(fmt, k_blk, device=device))


def _prepare(op: str, fmt, mesh, part, k_blk, device, build, *tensors,
             window_aligned: bool = False):
    """``(blocked, mesh, part)`` of a sharded call: the mesh resolved,
    the operands' devices checked, the partition built (memoized) when
    not given and checked against the mesh."""
    mesh = _resolve_mesh(mesh)
    blocked = _blocked(fmt, k_blk, device)
    _check_devices(op, mesh, blocked.vals, *tensors)
    if part is None:
        part = build(blocked, _axis(mesh, "data"))
    _check_part(part, mesh, window_aligned=window_aligned)
    return blocked, mesh, part


def _reduce(x: torch.Tensor, group) -> torch.Tensor:
    """``all_reduce(SUM)`` of ``x`` over ``group``, fp32 for narrow
    dtypes (rounded once after the sum).  A one-rank group's sum is its
    one partial in any dtype, so narrow partials skip the fp32 copy."""
    if x.dtype == torch.float32 or dist.get_world_size(group) == 1:
        dist.all_reduce(x, group=group)
        return x
    y = x.float()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def _gather(x: torch.Tensor, mesh: DeviceMesh, dim: int) -> torch.Tensor:
    """The model group's slices of ``x`` joined along ``dim``."""
    group = mesh.get_group("model")
    parts = [torch.empty_like(x) for _ in range(_axis(mesh, "model"))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _slice(x: torch.Tensor, dim: int, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` over the model dim."""
    tp = _axis(mesh, "model")
    step = x.shape[dim] // tp
    r = mesh.get_local_rank("model")
    return x.narrow(dim, r * step, step).contiguous()


def _spmm_mode(mesh, vals, b) -> str:
    model_ax, tp = _model_axis(mesh)
    vb, bb = vals.dim() == 3, b.dim() == 3
    h = vals.shape[0] if vb else (b.shape[0] if bb else 1)
    if model_ax and (vb or bb) and h % tp == 0:
        return "heads"
    if model_ax and not (vb or bb) and b.shape[-1] % tp == 0:
        return "cols"
    return "none"


def _spmm_model_split(mesh, blocked, b, mode):
    """The operands of this rank's model slice."""
    if mode == "heads":
        if blocked.vals.dim() == 3:
            blocked = with_values(blocked, _slice(blocked.vals, 0, mesh))
        if b.dim() == 3:
            b = _slice(b, 0, mesh)
    elif mode == "cols":
        b = _slice(b, 1, mesh)
    return blocked, b


def _model_join(out, mesh, mode):
    """The whole output from this rank's model slice: heads joined along
    dim 0, output columns along the last."""
    if mode == "heads":
        return _gather(out, mesh, 0)
    if mode == "cols":
        return _gather(out, mesh, out.dim() - 1)
    return out


def _sddmm_mode(mesh, q, k) -> str:
    model_ax, tp = _model_axis(mesh)
    qb, kb = q.dim() == 3, k.dim() == 3
    h = q.shape[0] if qb else (k.shape[0] if kb else 1)
    if model_ax and (qb or kb) and h % tp == 0:
        return "heads"
    if model_ax and not (qb or kb) and q.shape[-1] % tp == 0:
        return "feat"
    return "none"


def _dense_model_split(mesh, mode, *operands):
    """Heads of the 3-D operands, or the features of 2-D Q and K."""
    if mode == "heads":
        return tuple(_slice(x, 0, mesh) if x.dim() == 3 else x
                     for x in operands)
    if mode == "feat":
        return tuple(_slice(x, 1, mesh) for x in operands)
    return operands


def _attention_mode(mesh, q, k, v) -> str:
    model_ax, tp = _model_axis(mesh)
    batched = [x for x in (q, k, v) if x.dim() == 3]
    if model_ax and batched and batched[0].shape[0] % tp == 0:
        return "heads"
    return "none"


def _data_rank(mesh: DeviceMesh) -> int:
    return mesh.get_local_rank("data")


# ---------------------------------------------------------------------------
# Rank-local launches
# ---------------------------------------------------------------------------


def spmm_sharded_local(blocked: BlockedMEBCRS, b: torch.Tensor,
                       part: ShardedSchedule, rank: int, *,
                       n_blk: int = 128) -> torch.Tensor:
    """Rank ``rank``'s masked partial of ``A @ B``: one balanced SpMM
    launch (row 4) over its range, zeros in the rows it does not own.
    Operands as ``spmm_balanced_cuda`` takes them (already at their
    precision)."""
    from repro_torch.kernels.spmm_balanced_cuda import spmm_balanced_cuda

    return spmm_balanced_cuda(blocked, b, schedule=part.local(rank),
                              n_blk=n_blk)


def sddmm_sharded_local(blocked: BlockedMEBCRS, q: torch.Tensor,
                        k: torch.Tensor, part: ShardedSchedule,
                        rank: int) -> torch.Tensor:
    """Rank ``rank``'s masked partial of the SDDMM: one balanced launch
    (row 8) over its blocks, zeros in the value rows it does not own."""
    from repro_torch.kernels.sddmm_balanced_cuda import sddmm_balanced_cuda

    return sddmm_balanced_cuda(blocked, q, k, schedule=part.local(rank))


def attention_sharded_local(blocked: BlockedMEBCRS, q: torch.Tensor,
                            k: torch.Tensor, v: torch.Tensor,
                            part: ShardedSchedule, rank: int, *,
                            scale=None) -> torch.Tensor:
    """Rank ``rank``'s masked partial of the fused attention: one
    balanced launch (row 10) over its windows of a window-aligned
    partition, zeros in the rows it does not own."""
    from repro_torch.kernels.attention_balanced_cuda import (
        attention_balanced_cuda)

    if part.window_split:
        raise ValueError("attention_sharded needs a window-aligned "
                         "partition (window_split=False): online-softmax "
                         "statistics cannot cross devices")
    return attention_balanced_cuda(blocked, q, k, v, scale=scale,
                                   schedule=part.local(rank))


# ---------------------------------------------------------------------------
# The bulk sharded ops: the local launch, then one all_reduce
# ---------------------------------------------------------------------------


def spmm_sharded(fmt, b: torch.Tensor, *, mesh: Optional[DeviceMesh] = None,
                 part: Optional[ShardedSchedule] = None,
                 schedule: Optional[Schedule] = None, split_blk: int = 1,
                 k_blk: int = 8, n_blk: int = 128,
                 precision: Optional[str] = None) -> torch.Tensor:
    """Multi-rank SpMM: this rank's local balanced launch, then
    ``all_reduce`` over the mesh's data group.

    ``fmt`` is canonical or blocked (values may carry a leading head
    dim); ``b`` is ``(K, N)`` or ``(H, K, N)``.  The model dim carries
    heads (3-D operands) or output columns (2-D), when they divide, and
    the rank gathers the model group's slices.  ``precision`` follows
    :func:`~repro_torch.core.spmm.apply_precision` (int8 quantizes the
    whole view before the split).  Every rank returns the whole C.
    """
    blocked, mesh, part = _prepare(
        "spmm_sharded", fmt, mesh, part, k_blk, b.device,
        lambda bl, d: sharded_schedule(bl, d, split_blk=split_blk,
                                       n_blk=n_blk, schedule=schedule), b)
    blocked, b = apply_precision(blocked, b, precision)
    mode = _spmm_mode(mesh, blocked.vals, b)
    blocked, b = _spmm_model_split(mesh, blocked, b, mode)
    out = spmm_sharded_local(blocked, b.contiguous(), part, _data_rank(mesh),
                             n_blk=n_blk)
    out = _reduce(out, mesh.get_group("data"))
    return _model_join(out, mesh, mode)


def sddmm_sharded(fmt, q: torch.Tensor, k: torch.Tensor, *,
                  mesh: Optional[DeviceMesh] = None,
                  part: Optional[ShardedSchedule] = None,
                  schedule: Optional[Schedule] = None, split_blk: int = 1,
                  k_blk: int = 8, f_blk: int = 128,
                  precision: Optional[str] = None) -> torch.Tensor:
    """Multi-rank SDDMM → blocked-layout values ``([H,] NNZP, V)``.

    K-blocks are owned by one rank each, so the reduce over the data
    group only reassembles.  Heads take the model dim for 3-D operands;
    for 2-D ones the contracted features split over it and the partial
    products are summed over the model group.
    """
    q, k = cast_precision(precision, q, k)
    blocked, mesh, part = _prepare(
        "sddmm_sharded", fmt, mesh, part, k_blk, q.device,
        lambda bl, d: sharded_schedule(bl, d, split_blk=split_blk,
                                       n_blk=f_blk, schedule=schedule), q, k)
    if part.num_blocks == 0:                     # all-empty pattern
        h = next((x.shape[0] for x in (q, k) if x.dim() == 3), None)
        shape = (blocked.cols.shape[0], blocked.vector_size)
        return torch.zeros(((h,) if h else ()) + shape, dtype=q.dtype,
                           device=q.device)
    mode = _sddmm_mode(mesh, q, k)
    q_l, k_l = _dense_model_split(mesh, mode, q, k)
    out = sddmm_sharded_local(blocked, q_l, k_l, part, _data_rank(mesh))
    out = _reduce(out, mesh.get_group("data"))
    if mode == "feat":
        return _reduce(out, mesh.get_group("model"))
    return _model_join(out, mesh, mode)


def attention_sharded(fmt, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, *, mesh: Optional[DeviceMesh] = None,
                      part: Optional[ShardedSchedule] = None,
                      schedule: Optional[Schedule] = None,
                      split_blk: int = 1, k_blk: int = 8, scale=None,
                      precision: Optional[str] = None) -> torch.Tensor:
    """Multi-rank fused sparse attention on a window-aligned partition
    (a window's online softmax stays on one rank); heads take the model
    dim when every 3-D operand's head count divides.  ``scale`` (default
    ``1/sqrt(D)``, may be a 0-d tensor) is folded into Q by the kernel's
    wrapper."""
    q, k, v = cast_precision(precision, q, k, v)
    blocked, mesh, part = _prepare(
        "attention_sharded", fmt, mesh, part, k_blk, q.device,
        lambda bl, d: sharded_schedule(bl, d, split_blk=split_blk,
                                       window_split=False,
                                       schedule=schedule), q, k, v,
        window_aligned=True)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    mode = _attention_mode(mesh, q, k, v)
    q_l, k_l, v_l = _dense_model_split(mesh, mode, q, k, v)
    out = attention_sharded_local(blocked, q_l, k_l, v_l, part,
                                  _data_rank(mesh), scale=scale)
    out = _reduce(out, mesh.get_group("data"))
    return _model_join(out, mesh, mode)


# ---------------------------------------------------------------------------
# Registry adapters: impl "cuda_sharded" (the multi_device flag).  The
# entry points cast the operands to the call's precision first; the
# autodiff layer passes each direction's partition and the plan's mesh.
# ---------------------------------------------------------------------------


def _spmm_sharded_adapter(fmt, b, *, k_blk=8, n_blk=128, split_blk=1,
                          schedule=None, mesh=None, part=None):
    return spmm_sharded(fmt, b, mesh=mesh, part=part, schedule=schedule,
                        split_blk=split_blk, k_blk=k_blk, n_blk=n_blk)


def _sddmm_sharded_adapter(fmt, q, k, *, k_blk=8, f_blk=128, split_blk=1,
                           schedule=None, mesh=None, part=None):
    return sddmm_sharded(fmt, q, k, mesh=mesh, part=part, schedule=schedule,
                         split_blk=split_blk, k_blk=k_blk,
                         f_blk=f_blk or 128)


def _attention_sharded_adapter(fmt, q, k, v, *, scale=None, k_blk=8,
                               split_blk=1, schedule=None, mesh=None,
                               part=None):
    return attention_sharded(fmt, q, k, v, mesh=mesh, part=part,
                             schedule=schedule, split_blk=split_blk,
                             k_blk=k_blk, scale=scale)


_dispatch.register("spmm", "cuda_sharded", _spmm_sharded_adapter,
                   differentiable=True, batched=True, load_balanced=True,
                   multi_device=True, precisions=("fp32", "bf16", "int8"))
_dispatch.register("sddmm", "cuda_sharded", _sddmm_sharded_adapter,
                   differentiable=True, batched=True, load_balanced=True,
                   multi_device=True, precisions=("fp32", "bf16"))
_dispatch.register("attention", "cuda_sharded", _attention_sharded_adapter,
                   differentiable=True, batched=True, load_balanced=True,
                   multi_device=True, precisions=("fp32", "bf16"))

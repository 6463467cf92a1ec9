"""ME-BCRS: memory-efficient block-compressed row storage (FlashSparse §3.5).

Counterpart of ``repro.core.format``.  The sparse matrix A (M, K) is cut
into row *windows* of V rows (V = 8 is FlashSparse's granularity, V = 16
the TC-GNN / DTC-SpMM baseline).  Within a window every column holding a
nonzero is a *nonzero vector*; ME-BCRS stores only those:

  row_pointers   (W + 1,) int32   start of each window in column_indices
  column_indices (NNZV,)  int32   column id of each nonzero vector
  values         (NNZV, V)        the V elements of each vector
  mask           (NNZV, V) bool   which elements are true nonzeros

``values`` is vector-major: ``values[t]`` is the t-th nonzero vector, so
the storage is Aᵀ restricted to nonzero vectors.

:class:`BlockedMEBCRS` pads each window's vector count to a multiple of
``k_blk`` for the window-GEMM kernels; the canonical format stays
padding-free.  :class:`Schedule` re-maps a blocked view's work onto
uniform segments of at most ``split_blk`` K-blocks for the block-parallel
(load-balanced) kernels.

Building is host-side numpy, as in the JAX package (format translation is
preprocessing); the built arrays are torch tensors.  The canonical format
is built on the CPU; :func:`block_format` places its blocked view on the
requested device, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import validate as _validate

__all__ = [
    "MEBCRS",
    "BlockedMEBCRS",
    "Schedule",
    "build_schedule",
    "resolve_device",
    "from_dense",
    "from_coo",
    "to_dense",
    "to_coo",
    "block_format",
]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``device`` as given, else the
    card.  With no CUDA device and no ``device`` this raises rather than
    falling back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass device="cpu" '
                           "to run on the CPU")
    return torch.device("cuda")


def _to_device(obj, fields, device):
    return dataclasses.replace(
        obj, **{f: getattr(obj, f).to(device) for f in fields
                if getattr(obj, f) is not None})


@dataclasses.dataclass(frozen=True, eq=False)
class MEBCRS:
    """Padding-free ME-BCRS sparse matrix (FlashSparse §3.5)."""

    row_pointers: torch.Tensor    # (W + 1,) int32
    column_indices: torch.Tensor  # (NNZV,) int32
    values: torch.Tensor          # (NNZV, V) vector-major (= Aᵀ layout)
    mask: torch.Tensor            # (NNZV, V) bool true-nonzero positions
    shape: Tuple[int, int]        # (M, K) of the dense matrix
    vector_size: int              # V

    _TENSORS = ("row_pointers", "column_indices", "values", "mask")

    @property
    def num_windows(self) -> int:
        return int(self.row_pointers.shape[0]) - 1

    @property
    def nnzv(self) -> int:
        return int(self.values.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.mask.sum())

    def to(self, device) -> "MEBCRS":
        """A copy with every tensor on ``device``."""
        return _to_device(self, self._TENSORS, device)

    def transpose(self) -> "MEBCRS":
        """ME-BCRS of Aᵀ, on this format's device (host-side build,
        memoized on the instance).

        The backward duality turns SpMM/SDDMM gradients into sparse ops on
        Aᵀ, so the transposed format is a one-time translation cost paid
        per adjacency.
        """
        cached = getattr(self, "_transpose_cache", None)
        if cached is not None:
            return cached
        rows, cols, vals = to_coo(self)
        m, k = self.shape
        out = from_coo(cols, rows, vals, (k, m), vector_size=self.vector_size,
                       dtype=self.values.dtype).to(self.values.device)
        object.__setattr__(self, "_transpose_cache", out)
        return out


@dataclasses.dataclass(frozen=True, eq=False)
class BlockedMEBCRS:
    """Blocked execution view: windows padded to multiples of K_BLK vectors.

    Flat arrays over NB = sum_w ceil(nnzv_w / K_BLK) K-blocks:
      vals      (NB * K_BLK, V)   zero-padded vector values
      cols      (NB * K_BLK,)     column ids (0 for padding; vals are 0)
      mask      (NB * K_BLK, V)   element mask (False for padding)
      block_win (NB,) int32       output window of each K-block
      win_ptr   (W + 1,) int32    window ``w`` owns K-blocks
                                  ``[win_ptr[w], win_ptr[w+1])``
      scales    (NB,) fp32 or None  per-K-block dequantization scales,
                                  set with int8 ``vals`` by
                                  :func:`~repro_torch.core.quantize.quantize_format`
    For the all-empty matrix a single dummy zero block exists so the
    arrays are never empty, but no window owns it (``win_ptr[-1] == 0``).
    """

    vals: torch.Tensor
    cols: torch.Tensor
    mask: torch.Tensor
    block_win: torch.Tensor
    win_ptr: torch.Tensor
    shape: Tuple[int, int]
    vector_size: int
    k_blk: int
    scales: Optional[torch.Tensor] = None

    _TENSORS = ("vals", "cols", "mask", "block_win", "win_ptr", "scales")

    @property
    def num_blocks(self) -> int:
        return int(self.block_win.shape[0])

    @property
    def num_windows(self) -> int:
        return -(-self.shape[0] // self.vector_size)

    def to(self, device) -> "BlockedMEBCRS":
        """A copy with every tensor on ``device``."""
        return _to_device(self, self._TENSORS, device)

    def schedule(self, split_blk: int = 1) -> "Schedule":
        """Block-parallel :class:`Schedule` on this view's device, built on
        the host and memoized per ``split_blk``."""
        memo = getattr(self, "_schedules", None)
        if memo is None:
            memo = {}
            object.__setattr__(self, "_schedules", memo)
        if split_blk not in memo:
            memo[split_blk] = build_schedule(self, split_blk)
        return memo[split_blk]


@dataclasses.dataclass(frozen=True, eq=False)
class Schedule:
    """Block-parallel, load-balanced execution schedule (DESIGN.md §11).

    The window-parallel kernels give each output window one unit of work
    with a ragged loop over its K-blocks, so on a power-law graph hub
    windows dominate the run time.  A schedule cuts the work into
    **segments** of at most ``split_blk`` K-blocks:

      seg_win  (NS,)    int32  output window of each segment
      seg_meta (NS, 4)  int32  per segment: [first K-block, K-block count,
                               is-first-segment-of-window,
                               is-last-segment-of-window]
      blk_id   (NSB,)   int32  scheduled K-blocks in segment order (the
                               block-grid SDDMM walks these)
      blk_win  (NSB,)   int32  owning window of each scheduled block

    The arrays equal ``repro.core.format.Schedule``'s.  Segments of one
    window are contiguous and ascend in block order.  An empty window keeps
    one zero-length segment (count 0, first = last = 1) that only stores
    zeros, so the all-empty matrix is a valid zero-block schedule.  The
    balanced CUDA SpMM and attention kernels walk it in runs of consecutive
    segments and merge the windows that runs cut through a combine tree of
    their own (``repro_torch.kernels._combine``)."""

    seg_win: torch.Tensor
    seg_meta: torch.Tensor
    blk_id: torch.Tensor
    blk_win: torch.Tensor
    split_blk: int            # max K-blocks per segment (0 = unsplit)
    num_blocks: int           # total scheduled K-blocks (0 iff all-empty)

    _TENSORS = ("seg_win", "seg_meta", "blk_id", "blk_win")

    @property
    def num_segments(self) -> int:
        return int(self.seg_win.shape[0])

    def to(self, device) -> "Schedule":
        """A copy with every tensor on ``device``."""
        return _to_device(self, self._TENSORS, device)


# ---------------------------------------------------------------------------
# Construction (host-side numpy, like the paper's CSR → ME-BCRS converter).
# ---------------------------------------------------------------------------


def from_coo(rows, cols, vals, shape: Tuple[int, int], vector_size: int = 8,
             dtype: torch.dtype = torch.float32, *,
             duplicates: str = "sum") -> MEBCRS:
    """Build ME-BCRS (on the CPU) from COO triplets.

    ``duplicates="sum"`` coalesces repeated ``(row, col)`` coordinates;
    ``"error"`` raises a ``duplicate-coords`` :class:`ValidationError`.
    """
    if duplicates not in ("sum", "error"):
        raise ValueError(f"duplicates must be 'sum' or 'error', "
                         f"got {duplicates!r}")
    m, k = shape
    v = vector_size
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    _validate.check_coo(rows, cols, shape, duplicates)

    w = -(-m // v)
    win = rows // v
    r_in_win = rows % v

    # Sort by (window, column) and coalesce duplicates into vectors.
    vec_key = win * k + cols
    order = np.argsort(vec_key, kind="stable")
    uniq_keys, vec_of_elem = np.unique(vec_key[order], return_inverse=True)
    nnzv = uniq_keys.shape[0]

    values = np.zeros((nnzv, v), dtype=np.float64)
    maskf = np.zeros((nnzv, v), dtype=bool)
    np.add.at(values, (vec_of_elem, r_in_win[order]), vals[order])
    maskf[vec_of_elem, r_in_win[order]] = True

    vec_win = (uniq_keys // k).astype(np.int32)
    vec_col = (uniq_keys % k).astype(np.int32)
    row_pointers = np.zeros(w + 1, dtype=np.int32)
    np.add.at(row_pointers, vec_win + 1, 1)
    row_pointers = np.cumsum(row_pointers, dtype=np.int32)

    return MEBCRS(
        row_pointers=torch.from_numpy(row_pointers),
        column_indices=torch.from_numpy(vec_col),
        values=torch.from_numpy(values).to(dtype),
        mask=torch.from_numpy(maskf),
        shape=(m, k),
        vector_size=v,
    )


def from_dense(a, vector_size: int = 8, dtype=None) -> MEBCRS:
    """Build ME-BCRS from a dense matrix (numpy array or tensor).

    With no ``dtype`` the values keep ``a``'s dtype, except that float64
    becomes float32, as JAX's default (32-bit) mode does.
    """
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    rows, cols = np.nonzero(a)
    if dtype is None:
        dtype = (torch.float32 if a.dtype == np.float64
                 else torch.from_numpy(a[:0]).dtype)
    return from_coo(rows, cols, a[rows, cols], a.shape, vector_size,
                    dtype=dtype)


def _win_of_vec(row_pointers: np.ndarray) -> np.ndarray:
    w = row_pointers.shape[0] - 1
    return np.repeat(np.arange(w, dtype=np.int64), np.diff(row_pointers))


def to_dense(fmt: MEBCRS) -> torch.Tensor:
    """Reconstruct the dense matrix (oracle for round-trip tests)."""
    m, k = fmt.shape
    v = fmt.vector_size
    rp = fmt.row_pointers.cpu().numpy()
    win_of_vec = torch.from_numpy(_win_of_vec(rp))
    vals = (fmt.values * fmt.mask).cpu()
    out = torch.zeros((fmt.num_windows * v, k), dtype=vals.dtype)
    rows = win_of_vec[:, None] * v + torch.arange(v)[None, :]
    out[rows, fmt.column_indices.cpu().long()[:, None]] = vals
    return out[:m]


def to_coo(fmt) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """True-nonzero COO triplets ``(rows, cols, vals)`` of a format.

    Accepts the canonical :class:`MEBCRS` or a :class:`BlockedMEBCRS`
    (padding entries carry ``mask=False`` and are dropped).  Host-side
    numpy.
    """
    v = fmt.vector_size
    mask = fmt.mask.cpu().numpy()
    t_idx, r_idx = np.nonzero(mask)
    if isinstance(fmt, BlockedMEBCRS):
        win = fmt.block_win.cpu().numpy()[t_idx // fmt.k_blk]
        col_of_vec = fmt.cols
        values = fmt.vals
    else:
        win = _win_of_vec(fmt.row_pointers.cpu().numpy())[t_idx]
        col_of_vec = fmt.column_indices
        values = fmt.values
    rows = win.astype(np.int64) * v + r_idx
    cols = col_of_vec.cpu().numpy()[t_idx].astype(np.int64)
    if values.dtype == torch.bfloat16:
        values = values.float()
    vals = values.cpu().numpy()[t_idx, r_idx]
    return rows, cols, vals


def block_format(fmt: MEBCRS, k_blk: int = 8, *,
                 device=None) -> BlockedMEBCRS:
    """Pad each window's vectors to a multiple of ``k_blk`` → blocked view
    on ``device`` (the card unless ``device`` says otherwise).

    Padding vectors get value 0, mask False and column 0, so their product
    contributes nothing (the paper's arithmetic elimination of the last
    block's residue, resolved at translation time).
    """
    device = resolve_device(device)
    _validate.check_block_config(k_blk)
    rp = fmt.row_pointers.cpu().numpy().astype(np.int64)
    counts = np.diff(rp)
    w = fmt.num_windows
    v = fmt.vector_size
    nblk_per_win = -(-counts // k_blk)
    nb = max(int(nblk_per_win.sum()), 1)  # >=1 so kernels always have a block
    nnzp = nb * k_blk

    # Per-window K-block ranges for the fused kernels' window loop.  The
    # all-empty dummy block lies outside every range.
    win_ptr = np.zeros((w + 1,), dtype=np.int32)
    win_ptr[1:] = np.cumsum(nblk_per_win)
    block_win = np.zeros((nb,), dtype=np.int32)
    block_win[: int(win_ptr[-1])] = np.repeat(np.arange(w, dtype=np.int32),
                                              nblk_per_win)

    # Destination of canonical vector t: its window's first padded slot
    # plus its rank inside the window.
    win_of_vec = _win_of_vec(rp)
    dst = torch.from_numpy(win_ptr[win_of_vec].astype(np.int64) * k_blk
                           + np.arange(fmt.nnzv) - rp[win_of_vec])
    vals = torch.zeros((nnzp, v), dtype=fmt.values.dtype)
    cols = torch.zeros((nnzp,), dtype=torch.int32)
    mask = torch.zeros((nnzp, v), dtype=torch.bool)
    vals[dst] = fmt.values.cpu()
    cols[dst] = fmt.column_indices.cpu()
    mask[dst] = fmt.mask.cpu()

    return BlockedMEBCRS(
        vals=vals, cols=cols, mask=mask,
        block_win=torch.from_numpy(block_win),
        win_ptr=torch.from_numpy(win_ptr),
        shape=fmt.shape, vector_size=v, k_blk=k_blk,
    ).to(device)


def build_schedule(blocked: BlockedMEBCRS, split_blk: int = 1) -> Schedule:
    """Split windows into segments of at most ``split_blk`` K-blocks; an
    empty window keeps one zero-length store-only segment.

    ``split_blk = 0`` disables splitting: one segment per window, the
    window-parallel assignment in schedule form.  Host-side numpy, like
    :func:`block_format`; the schedule lands on ``blocked``'s device and is
    checked by :func:`~repro_torch.core.validate.check_schedule`.
    """
    if split_blk < 0:
        raise ValueError(f"split_blk must be >= 0, got {split_blk}")
    wp = blocked.win_ptr.cpu().numpy().astype(np.int64)
    w = blocked.num_windows
    counts = np.diff(wp)

    step = (np.maximum(counts, 1) if split_blk == 0
            else np.full(w, split_blk, np.int64))
    nseg = np.maximum(-(-counts // step), 1)   # empty windows keep one seg
    seg_win = np.repeat(np.arange(w, dtype=np.int64), nseg)
    idx = np.arange(seg_win.size) - np.repeat(np.cumsum(nseg) - nseg, nseg)
    seg_lo = wp[seg_win] + idx * step[seg_win]
    seg_len = np.clip(counts[seg_win] - idx * step[seg_win], 0,
                      step[seg_win])
    seg_lo = np.where(seg_len > 0, seg_lo, 0)  # empty: store-only segment
    seg_first = (idx == 0).astype(np.int64)
    seg_last = (idx == nseg[seg_win] - 1).astype(np.int64)
    seg_meta = np.stack([seg_lo, seg_len, seg_first, seg_last], axis=1)

    # Segments walk each window's contiguous block range in ascending
    # order, so the scheduled blocks are exactly the owned blocks
    # 0..win_ptr[-1) (the dummy block of an all-empty matrix is never
    # scheduled).
    sched = Schedule(
        seg_win=torch.from_numpy(seg_win.astype(np.int32)),
        seg_meta=torch.from_numpy(seg_meta.astype(np.int32)),
        blk_id=torch.arange(int(wp[-1]), dtype=torch.int32),
        blk_win=torch.from_numpy(np.repeat(np.arange(w, dtype=np.int32),
                                           counts)),
        split_blk=split_blk,
        num_blocks=int(wp[-1]),
    )
    _validate.check_schedule(sched, wp)
    return sched.to(blocked.win_ptr.device)

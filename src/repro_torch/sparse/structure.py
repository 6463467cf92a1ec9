"""Matrix structure taxonomy: feature extraction and class assignment.

Counterpart of ``repro.sparse.structure`` (the port keeps its own copy).
Which kernel wins is a function of a matrix's structure class more than
of its size: a hub-row matrix wants the block-parallel schedule, a banded
or mesh matrix is window-uniform already, near-dense blocks favour deeper
K-blocks.

  :func:`structure_stats`     COO triplets → feature dict (density,
                              row-length CV, window skew, normalized p95
                              bandwidth, band fill)
  :func:`classify_structure`  feature dict → one of
                              :data:`STRUCTURE_CLASSES` by the threshold
                              rules below
  :func:`classify_format`     the same from an ME-BCRS format, memoized
                              on the instance (the autotuner calls it per
                              stats-key lookup)

The class is a field of the autotuner's stats key (cache schema v6), so
matrices of different classes never share a tuned winner.  Every feature
is host-side numpy over the COO triplets, format-translation-time work
like :func:`repro_torch.core.format.from_coo`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

__all__ = [
    "STRUCTURE_CLASSES",
    "structure_stats",
    "classify_structure",
    "classify_format",
]

# Every class the taxonomy assigns, from most to least structured;
# ``empty`` and ``dense`` are the degenerate ends:
#
#   banded   tight diagonal band (tridiagonal chains, narrow-band FEM):
#            near-constant row lengths, p95 bandwidth a few elements
#   mesh     local stencil couplings (2-D/3-D grid Laplacians): regular
#            rows, bandwidth about the grid pitch, sparse within the band
#   block    dense diagonal blocks (multi-body, circuit, supernodal):
#            moderate bandwidth but a mostly full band
#   hub      heavy-tailed row lengths (social, web and citation graphs)
#   uniform  unstructured near-uniform scatter (Erdős–Rényi-like)
STRUCTURE_CLASSES: Tuple[str, ...] = (
    "empty", "dense", "hub", "banded", "block", "mesh", "uniform")

# Decision thresholds, in the order :func:`classify_structure` tests them.
DENSE_DENSITY = 0.25        # density ≥ this → "dense"
HUB_ROW_CV = 1.0            # row-length CV ≥ this → "hub"
HUB_WINDOW_SKEW = 4.0       # or p99/mean window skew ≥ this → "hub"
BANDED_RATIO = 0.03         # p95 |i−j| / max(m,k) ≤ this → "banded"
BANDED_ABS = 4.0            # or p95 |i−j| ≤ this many elements → "banded"
LOCAL_RATIO = 0.30          # ≤ this → band-local ("block" or "mesh")
BLOCK_FILL = 0.40           # band fill ≥ this within a local band → "block"


def structure_stats(rows, cols, shape: Tuple[int, int],
                    vector_size: int = 8) -> Dict[str, float]:
    """Structure features of a COO matrix (host-side numpy).

    Returns ``nnz``, ``density`` (nnz / (m·k)), ``avg_row_len``,
    ``row_cv`` (std/mean of the per-row counts, 0 when empty),
    ``window_skew`` (p99/mean of nonzero vectors per ``vector_size``-row
    window, at least 1.0, the statistic of
    :func:`repro_torch.core.format.window_skew` taken from COO),
    ``bandwidth`` (p95 of |i − j|), ``bandwidth_ratio`` (the same over
    max(m, k)), ``band_fill`` (nnz over the band's area at that
    bandwidth, at most 1) and ``diag_frac`` (rows with a diagonal entry).
    """
    m, k = int(shape[0]), int(shape[1])
    if m <= 0 or k <= 0:
        raise ValueError(f"invalid shape {shape!r}")
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if rows.shape != cols.shape or rows.ndim != 1:
        raise ValueError("rows/cols must be 1-D arrays of equal length")
    nnz = int(rows.size)
    stats: Dict[str, float] = {
        "nnz": float(nnz),
        "density": nnz / float(m * k),
        "avg_row_len": nnz / float(m),
    }
    if nnz == 0:
        stats.update(row_cv=0.0, window_skew=1.0, bandwidth=0.0,
                     bandwidth_ratio=0.0, band_fill=0.0, diag_frac=0.0)
        return stats

    row_len = np.bincount(rows, minlength=m).astype(np.float64)
    mean_len = row_len.mean()
    stats["row_cv"] = float(row_len.std() / mean_len) if mean_len > 0 else 0.0

    win = rows // vector_size
    uniq_vec = np.unique(win * k + cols)
    w = -(-m // vector_size)
    vec_counts = np.bincount((uniq_vec // k).astype(np.int64),
                             minlength=w).astype(np.float64)
    vmean = uniq_vec.size / float(w)
    stats["window_skew"] = float(
        max(np.percentile(vec_counts, 99) / vmean, 1.0)) if vmean > 0 else 1.0

    band = np.abs(rows - cols)
    bw = float(np.percentile(band, 95))
    stats["bandwidth"] = bw
    stats["bandwidth_ratio"] = bw / float(max(m, k))
    band_area = (2.0 * bw + 1.0) * min(m, k)
    stats["band_fill"] = float(min(nnz / band_area, 1.0))
    stats["diag_frac"] = float(
        np.unique(rows[rows == cols]).size / min(m, k))
    return stats


def classify_structure(stats: Dict[str, float]) -> str:
    """One of :data:`STRUCTURE_CLASSES` from a feature dict; the first
    rule that matches wins:

      1. ``nnz == 0``                                        → ``empty``
      2. ``density ≥ DENSE_DENSITY``                         → ``dense``
      3. ``row_cv ≥ HUB_ROW_CV`` or
         ``window_skew ≥ HUB_WINDOW_SKEW``                   → ``hub``
      4. ``bandwidth_ratio ≤ BANDED_RATIO`` or
         ``bandwidth ≤ BANDED_ABS`` elements                 → ``banded``
      5. ``bandwidth_ratio ≤ LOCAL_RATIO`` and
         ``band_fill ≥ BLOCK_FILL``                          → ``block``
      6. ``bandwidth_ratio ≤ LOCAL_RATIO``                   → ``mesh``
      7. otherwise                                           → ``uniform``
    """
    if stats["nnz"] == 0:
        return "empty"
    if stats["density"] >= DENSE_DENSITY:
        return "dense"
    if (stats["row_cv"] >= HUB_ROW_CV
            or stats["window_skew"] >= HUB_WINDOW_SKEW):
        return "hub"
    if (stats["bandwidth_ratio"] <= BANDED_RATIO
            or stats.get("bandwidth", np.inf) <= BANDED_ABS):
        return "banded"
    if stats["bandwidth_ratio"] <= LOCAL_RATIO:
        return "block" if stats["band_fill"] >= BLOCK_FILL else "mesh"
    return "uniform"


def classify_format(fmt) -> str:
    """Structure class of an ME-BCRS or blocked format, memoized on the
    instance (as :meth:`~repro_torch.core.format.MEBCRS.transpose`), so
    the O(nnz) feature pass runs once per format."""
    cached = getattr(fmt, "_structure_class", None)
    if cached is not None:
        return cached
    from repro_torch.core.format import to_coo

    rows, cols, _ = to_coo(fmt)
    cls = classify_structure(
        structure_stats(rows, cols, fmt.shape,
                        vector_size=fmt.vector_size))
    object.__setattr__(fmt, "_structure_class", cls)
    return cls

"""The graphs the cells train on: structural replicas of the paper's
datasets (FlashSparse, arXiv:2412.11007, Table 4), made from a seed, and
their cache inside the checkout.

A frozen copy of ``repro_torch.sparse.graphs`` (``power_law_graph``,
``erdos_renyi_graph``, ``gcn_normalized`` and ``make_dataset``'s
assembly), so that a change to the program cannot move the benchmark's
inputs.  The edge lists are deduplicated on one int64 key per edge
(``row * n + col``) instead of ``np.unique(..., axis=0)`` on pairs: the
same sorted arrays for the same seed, about ten times faster on the
Reddit replica.  The random draws are the original's, call for call.

The benchmark hands both sides the coalesced COO: ``make_dataset``
appends self-loops after the edge list is deduplicated, so an edge
``(i, i)`` can appear twice; :func:`coalesce` sums such pairs, as the
program's ``from_coo`` does, so that the reference sees the matrix the
program sees.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pathlib
from typing import Tuple

import numpy as np

__all__ = ["Graph", "power_law_graph", "erdos_renyi_graph",
           "gcn_normalized", "generate", "coalesce", "load_graph",
           "cache_path"]


@dataclasses.dataclass(frozen=True)
class Graph:
    name: str
    num_nodes: int
    rows: np.ndarray   # (nnz,) int32, sorted by (row, col), no duplicates
    cols: np.ndarray   # (nnz,) int32
    vals: np.ndarray   # (nnz,) float32

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])


def _unique_edges(rows: np.ndarray, cols: np.ndarray, n: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    keys = np.unique(rows.astype(np.int64) * n + cols)
    return keys // n, keys % n


def power_law_graph(num_nodes: int, avg_degree: float, seed: int = 0,
                    alpha: float = 1.8) -> Tuple[np.ndarray, np.ndarray]:
    """Directed power-law graph (Zipf-ish in-degrees): (rows, cols)."""
    rng = np.random.default_rng(seed)
    num_edges = int(num_nodes * avg_degree)
    weights = 1.0 / np.arange(1, num_nodes + 1) ** alpha
    weights /= weights.sum()
    cols = rng.choice(num_nodes, size=num_edges, p=weights)
    rows = rng.integers(0, num_nodes, size=num_edges)
    perm = rng.permutation(num_nodes)
    cols = perm[cols]
    return _unique_edges(rows, cols, num_nodes)


def erdos_renyi_graph(num_nodes: int, avg_degree: float, seed: int = 0
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Near-uniform sparse graph: (rows, cols)."""
    rng = np.random.default_rng(seed)
    num_edges = int(num_nodes * avg_degree)
    rows = rng.integers(0, num_nodes, size=num_edges)
    cols = rng.integers(0, num_nodes, size=num_edges)
    return _unique_edges(rows, cols, num_nodes)


def gcn_normalized(rows: np.ndarray, cols: np.ndarray, num_nodes: int
                   ) -> np.ndarray:
    """D^-1/2 (A+I) D^-1/2 per edge, with D the row degrees plus one."""
    deg = np.bincount(rows, minlength=num_nodes) + 1.0
    dinv = 1.0 / np.sqrt(deg)
    return (dinv[rows] * dinv[cols]).astype(np.float32)


_GENERATORS = {"power_law": power_law_graph, "uniform": erdos_renyi_graph}


def generate(spec: dict) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """``make_dataset``'s arrays for a traffic file's ``graph`` entry:
    ``(n, rows, cols, vals)``, self-loops appended after the edge list,
    not coalesced."""
    n = int(spec["num_nodes"])
    gen = _GENERATORS[spec["generator"]]
    extra = {"alpha": spec["alpha"]} if "alpha" in spec else {}
    rows, cols = gen(n, spec["avg_degree"], seed=spec["seed"], **extra)
    if spec.get("self_loops", True):
        loops = np.arange(n)
        rows = np.concatenate([rows, loops])
        cols = np.concatenate([cols, loops])
    vals = (gcn_normalized(rows, cols, n) if spec.get("normalize", True)
            else np.ones_like(rows, dtype=np.float32))
    return n, rows, cols, vals


def coalesce(n: int, rows, cols, vals) -> Tuple[np.ndarray, np.ndarray,
                                                np.ndarray]:
    """Sorted by (row, col), repeated coordinates summed (in float64, then
    rounded once, as ``from_coo``)."""
    keys, inverse = np.unique(np.asarray(rows, np.int64) * n + cols,
                              return_inverse=True)
    summed = np.bincount(inverse, weights=vals, minlength=keys.shape[0])
    return ((keys // n).astype(np.int32), (keys % n).astype(np.int32),
            summed.astype(np.float32))


def cache_path(spec: dict, cache_dir: pathlib.Path) -> pathlib.Path:
    """A fixed file for this graph: its name, its seed and a hash of its
    parameters and of this module's source."""
    h = hashlib.sha256(pathlib.Path(__file__).read_bytes())
    h.update(repr(sorted(spec.items())).encode())
    return cache_dir / f"{spec['name']}-s{spec['seed']}-{h.hexdigest()[:16]}.npz"


def load_graph(spec: dict, cache_dir: pathlib.Path) -> Tuple[Graph, bool]:
    """The coalesced graph of ``spec``, from the cache when it is there;
    otherwise generated and written to the cache (renamed into place, so
    a run cut while writing leaves no half file).  Also whether it was
    generated."""
    path = cache_path(spec, cache_dir)
    generated = not path.exists()
    if not generated:
        with np.load(path) as z:
            n, rows, cols, vals = (int(z["n"]), z["rows"], z["cols"],
                                   z["vals"])
    else:
        n, rows, cols, vals = generate(spec)
        rows, cols, vals = coalesce(n, rows, cols, vals)
        cache_dir.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".part.npz")
        np.savez(tmp, n=n, rows=rows, cols=cols, vals=vals)
        os.replace(tmp, path)
    return Graph(spec["name"], n, rows, cols, vals), generated

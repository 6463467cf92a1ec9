"""Synthetic graph generation matching the paper's dataset statistics.

Counterpart of ``repro.sparse.graphs``: the same generators and presets,
giving the same arrays from the same seed (numpy only).  Two regimes
matter for vector-granularity behaviour:

  * power-law degree distribution (social / web / product graphs — Reddit,
    AmazonProducts, ogbn-products ...), generated Barabási–Albert-style;
  * near-uniform sparse (meshes, bio graphs — DD, Yeast, Ell), generated
    Erdős–Rényi.

``DATASET_PRESETS`` mirrors Table 4's (#vertices, avg row length), scaled
by ``scale`` at make time while keeping each graph's density/skew
signature.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

__all__ = [
    "power_law_graph",
    "hub_row_graph",
    "erdos_renyi_graph",
    "gcn_normalized",
    "GraphData",
    "DATASET_PRESETS",
    "make_dataset",
]


def power_law_graph(num_nodes: int, avg_degree: float, seed: int = 0,
                    alpha: float = 1.8) -> Tuple[np.ndarray, np.ndarray]:
    """Directed power-law graph (Zipf-ish in-degrees), returns (rows, cols)."""
    rng = np.random.default_rng(seed)
    num_edges = int(num_nodes * avg_degree)
    # Zipf-weighted target selection → heavy-tailed column density
    weights = 1.0 / np.arange(1, num_nodes + 1) ** alpha
    weights /= weights.sum()
    cols = rng.choice(num_nodes, size=num_edges, p=weights)
    rows = rng.integers(0, num_nodes, size=num_edges)
    # permute target ids so hubs are scattered, as in real graphs
    perm = rng.permutation(num_nodes)
    cols = perm[cols]
    edges = np.unique(np.stack([rows, cols], axis=1), axis=0)
    return edges[:, 0], edges[:, 1]


def hub_row_graph(num_nodes: int, avg_degree: float, seed: int = 0,
                  skew: float = 1.5) -> Tuple[np.ndarray, np.ndarray]:
    """Directed graph with Zipf-distributed **out**-degrees (hub rows).

    :func:`power_law_graph` skews the *column* density (hub targets);
    this generator skews the *row* lengths instead — the distribution
    that unbalances ME-BCRS row windows: a few windows own most K-blocks
    while the tail is near-empty (p99/mean window skew grows with
    ``skew``).  This is the workload the block-parallel schedule
    (DESIGN.md §11) exists for; ``skew`` is the Zipf exponent (≥ ~1.5
    gives the hub-dominated regime the benchmarks regress against).
    Hub rows stay at low indices so they concentrate in few windows,
    like the degree-sorted graphs GNN pipelines feed.
    """
    rng = np.random.default_rng(seed)
    num_edges = int(num_nodes * avg_degree)
    weights = 1.0 / np.arange(1, num_nodes + 1) ** skew
    weights /= weights.sum()
    rows = rng.choice(num_nodes, size=num_edges, p=weights)
    cols = rng.integers(0, num_nodes, size=num_edges)
    edges = np.unique(np.stack([rows, cols], axis=1), axis=0)
    return edges[:, 0], edges[:, 1]


def erdos_renyi_graph(num_nodes: int, avg_degree: float, seed: int = 0
                      ) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    num_edges = int(num_nodes * avg_degree)
    rows = rng.integers(0, num_nodes, size=num_edges)
    cols = rng.integers(0, num_nodes, size=num_edges)
    edges = np.unique(np.stack([rows, cols], axis=1), axis=0)
    return edges[:, 0], edges[:, 1]


def gcn_normalized(rows: np.ndarray, cols: np.ndarray, num_nodes: int
                   ) -> np.ndarray:
    """Symmetric GCN normalisation values D^-1/2 (A+I) D^-1/2 per edge.

    Self-loops are appended by callers; here we compute per-edge values for
    the provided edge list.
    """
    deg = np.bincount(rows, minlength=num_nodes) + 1.0
    dinv = 1.0 / np.sqrt(deg)
    return (dinv[rows] * dinv[cols]).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class GraphData:
    name: str
    num_nodes: int
    rows: np.ndarray  # (E,)
    cols: np.ndarray  # (E,)
    vals: np.ndarray  # (E,) float32

    @property
    def num_edges(self) -> int:
        return int(self.rows.shape[0])

    def dense(self) -> np.ndarray:
        a = np.zeros((self.num_nodes, self.num_nodes), np.float32)
        a[self.rows, self.cols] = self.vals
        return a


# name: (num_nodes, avg_degree, generator) — Table 4, scaled at make time.
DATASET_PRESETS: Dict[str, Tuple[int, float, str]] = {
    "GitHub": (37_700, 16.33, "power_law"),
    "Artist": (50_515, 32.4, "power_law"),
    "Blog": (88_784, 47.2, "power_law"),
    "Ell": (203_769, 3.3, "uniform"),
    "Yelp": (716_847, 19.46, "power_law"),
    "DD": (334_925, 5.03, "uniform"),
    "Reddit": (232_965, 492.98, "power_law"),
    "Amazon": (403_394, 22.48, "power_law"),
    "Amazon0505": (410_236, 11.89, "power_law"),
    "Comamazon": (334_863, 5.5, "uniform"),
    "Yeast": (1_710_902, 3.1, "uniform"),
    "OGBProducts": (2_449_029, 51.52, "power_law"),
    "AmazonProducts": (1_569_960, 128.37, "power_law"),
    "IGB-small": (1_000_000, 13.06, "power_law"),
    "IGB-medium": (10_000_000, 12.99, "power_law"),
}


def make_dataset(name: str, scale: float = 1.0, seed: int = 0,
                 add_self_loops: bool = True, normalize: bool = True
                 ) -> GraphData:
    """Generate a scaled structural replica of a paper dataset."""
    nodes, deg, kind = DATASET_PRESETS[name]
    n = max(int(nodes * scale), 16)
    gen = power_law_graph if kind == "power_law" else erdos_renyi_graph
    rows, cols = gen(n, deg, seed=seed)
    if add_self_loops:
        loops = np.arange(n)
        rows = np.concatenate([rows, loops])
        cols = np.concatenate([cols, loops])
    vals = (gcn_normalized(rows, cols, n) if normalize
            else np.ones_like(rows, dtype=np.float32))
    return GraphData(name=name, num_nodes=n, rows=rows, cols=cols, vals=vals)

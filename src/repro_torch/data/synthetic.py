"""Step-indexed synthetic LM data: any host can regenerate any step.

Counterpart of ``repro.data.synthetic`` (the port keeps its own copy).
The pipeline is a pure function ``(seed, step, host_shard) -> batch``, so
there is no iterator state to hand off when a host is replaced: the
restarted worker computes exactly the batch its predecessor would have,
and a checkpoint needs only the step counter to resume bit-identically.
The batches are numpy arrays, bitwise the reference's: the same Philox
streams, drawn in the same order.

Token statistics follow a Zipfian unigram over the vocab, mixed with
short repeated n-grams so the LM loss decreases during the example runs.

``input_specs(cfg, batch, seq_len)`` returns stand-ins on PyTorch's
``meta`` device for every model input of an (arch x shape) cell: shapes
and dtypes, no allocation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.models.config import ArchConfig

__all__ = [
    "SyntheticLMData",
    "make_batch",
    "input_specs",
    "decode_specs",
    "synthetic_sparse_coo",
    "synthetic_sparse_format",
]


def _rng_for(seed: int, step: int, shard: int) -> np.random.Generator:
    # Philox is counter-based: cheap to construct per (step, shard)
    return np.random.Generator(np.random.Philox(key=seed,
                                                counter=[step, shard, 0, 0]))


@dataclasses.dataclass(frozen=True)
class SyntheticLMData:
    cfg: ArchConfig
    batch_size: int          # per-host batch
    seq_len: int
    seed: int = 0
    host_shard: int = 0      # this host's index in the data-loading group
    zipf_a: float = 1.2
    ngram_period: int = 64   # repeated motif length: learnable structure

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = _rng_for(self.seed, step, self.host_shard)
        v = self.cfg.vocab
        b, s = self.batch_size, self.seq_len
        # Zipf over vocab, clipped
        base = rng.zipf(self.zipf_a, size=(b, s)).astype(np.int64)
        tokens = np.minimum(base - 1, v - 1).astype(np.int32)
        # overlay a per-sequence repeating motif (predictable structure)
        motif_len = self.ngram_period
        motif = rng.integers(0, v, size=(b, motif_len), dtype=np.int32)
        reps = -(-s // motif_len)
        motif_full = np.tile(motif, (1, reps))[:, :s]
        use_motif = rng.random((b, s)) < 0.5
        tokens = np.where(use_motif, motif_full, tokens)
        out: Dict[str, np.ndarray] = {"tokens": tokens}
        out.update(_family_extras(self.cfg, b, s, rng))
        return out


def _family_extras(cfg: ArchConfig, b: int, s: int,
                   rng: Optional[np.random.Generator]) -> Dict[str, np.ndarray]:
    """Stub modality inputs: precomputed frame/patch embeddings."""
    extras: Dict[str, np.ndarray] = {}
    if cfg.family in ("encdec", "audio"):
        shape = (b, max(cfg.prefix_len or s // 2, 8), cfg.d_model)
    elif cfg.family == "vlm" and cfg.prefix_len:
        shape = (b, cfg.prefix_len, cfg.d_model)
    else:
        return extras
    key = "src_embeds" if cfg.family in ("encdec", "audio") else "prefix_embeds"
    extras[key] = (np.zeros(shape, np.float32) if rng is None
                   else rng.standard_normal(shape).astype(np.float32))
    return extras


def make_batch(cfg: ArchConfig, batch_size: int, seq_len: int, step: int = 0,
               seed: int = 0) -> Dict[str, np.ndarray]:
    return SyntheticLMData(cfg, batch_size, seq_len, seed=seed).batch(step)


# ---------------------------------------------------------------- dry-run --


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, batch: int, seq_len: int
                ) -> Dict[str, torch.Tensor]:
    """``meta`` tensors standing in for a *training* batch (no
    allocation)."""
    specs = {"tokens": _spec((batch, seq_len), torch.int32)}
    if cfg.family in ("encdec", "audio"):
        src_len = max(cfg.prefix_len or seq_len // 2, 8)
        specs["src_embeds"] = _spec((batch, src_len, cfg.d_model),
                                    torch.float32)
    elif cfg.family == "vlm" and cfg.prefix_len:
        specs["prefix_embeds"] = _spec((batch, cfg.prefix_len, cfg.d_model),
                                       torch.float32)
    return specs


def decode_specs(cfg: ArchConfig, batch: int) -> Dict[str, torch.Tensor]:
    """One-token decode input (the cache's come from ``init_cache``)."""
    return {"tokens": _spec((batch, 1), torch.int32)}


# ----------------------------------------------------- sparse matrices -----
# Deterministic synthetic sparse adjacencies with a controlled degree
# distribution: ``kind="hub_row"`` with skew >= 1.5 gives the hub-window
# imbalance the block-parallel schedule is built for; "power_law" skews
# columns; "uniform" is the Erdos-Renyi control.


def synthetic_sparse_coo(num_nodes: int, avg_degree: float = 8.0,
                         kind: str = "hub_row", skew: float = 1.5,
                         seed: int = 0):
    """COO triplets ``(rows, cols, vals, shape)`` of a synthetic matrix,
    a pure function of its arguments."""
    from repro_torch.sparse.graphs import (erdos_renyi_graph, hub_row_graph,
                                           power_law_graph)

    if kind == "hub_row":
        rows, cols = hub_row_graph(num_nodes, avg_degree, seed=seed,
                                   skew=skew)
    elif kind == "power_law":
        rows, cols = power_law_graph(num_nodes, avg_degree, seed=seed,
                                     alpha=skew)
    elif kind == "uniform":
        rows, cols = erdos_renyi_graph(num_nodes, avg_degree, seed=seed)
    else:
        raise ValueError(f"unknown kind {kind!r} "
                         "(hub_row / power_law / uniform)")
    rng = np.random.default_rng(seed + 1)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return rows, cols, vals, (num_nodes, num_nodes)


def synthetic_sparse_format(num_nodes: int, avg_degree: float = 8.0,
                            kind: str = "hub_row", skew: float = 1.5,
                            seed: int = 0, vector_size: int = 8):
    """The same matrix as :func:`synthetic_sparse_coo`, as an ME-BCRS
    format (on the CPU) ready for ``block_format`` / ``schedule``."""
    from repro_torch.core.format import from_coo

    rows, cols, vals, shape = synthetic_sparse_coo(
        num_nodes, avg_degree, kind=kind, skew=skew, seed=seed)
    return from_coo(rows, cols, vals, shape, vector_size=vector_size)

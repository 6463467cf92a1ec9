"""GCN (FlashSparse §4.4; Kipf and Welling): ``H' = σ(Â H W)``, ReLU
between layers, logits from the last.

The benchmark's side of one model kind: the weights it makes from the
seed, the plain reference forward pass, and the counts of the step's
work (the yardstick of ``step_mfu`` and ``sparse_roofline``); the GNN
family's entry points (:mod:`perfbench.gnn`) drive the rest.  The
reference imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from perfbench import reference as ref
from perfbench.gnn import (load_traffic, make_inputs, make_program,  # noqa: F401
                           reference_readings, step_counts, trainer)


def dims(cfg: dict) -> List[int]:
    return ([cfg["in_dim"]] + [cfg["hidden_dim"]] * (cfg["num_layers"] - 1)
            + [cfg["num_classes"]])


def init_weights(cfg: dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Glorot-normal weights in float32, as the program's ``_dense_init``
    scales them, drawn on the device; named as the program's module
    names its parameters."""
    d = dims(cfg)
    return {f"w.{i}": torch.randn(d[i], d[i + 1], generator=gen,
                                  device=device) * (2.0 / (d[i] + d[i + 1])) ** 0.5
            for i in range(cfg["num_layers"])}


def reference_forward(p: Dict[str, torch.Tensor], graph: ref.RefGraph, x,
                      cfg: dict, rnd: ref.Rounding) -> torch.Tensor:
    h = x
    n_layers = cfg["num_layers"]
    for i in range(n_layers):
        h = ref.spmm(graph, graph.vals, h, rnd)
        h = ref.matmul(h, p[f"w.{i}"], rnd)
        if i < n_layers - 1:
            h = torch.relu(h)
    return h


def sparse_ops(cfg: dict) -> List[dict]:
    """The sparse products a training step needs: ``Â H`` for every layer,
    and ``Âᵀ G`` for every layer whose input needs a gradient (not the
    first: its input is the features)."""
    d = dims(cfg)
    fwd = [{"op": "spmm", "width": d[i]} for i in range(cfg["num_layers"])]
    bwd = [{"op": "spmm", "width": d[i]} for i in range(1, cfg["num_layers"])]
    return fwd + bwd


def dense_flops(cfg: dict, n: int) -> int:
    """``H W`` forward, ``Hᵀ G`` for every weight, ``G Wᵀ`` for every layer
    but the first."""
    d = dims(cfg)
    total = 0
    for i in range(cfg["num_layers"]):
        gemm = 2 * n * d[i] * d[i + 1]
        total += gemm * (2 if i == 0 else 3)
    return total

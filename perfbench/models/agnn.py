"""AGNN (FlashSparse §4.4; Thekumparampil et al.): ``H₀ = ReLU(X W_in)``;
each layer ``H' = P H`` with ``P = softmax_row(β · cos(hᵢ, hⱼ))`` over the
graph's edges; logits ``H W_out``.

The benchmark's side of one model kind, as :mod:`perfbench.models.gcn`.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from perfbench import reference as ref
from perfbench.gnn import (load_traffic, make_inputs, make_program,  # noqa: F401
                           reference_readings, step_counts, trainer)


def init_weights(cfg: dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Glorot-normal ``W_in`` and ``W_out`` in float32 drawn on the
    device, and β = 1 in every layer, as the program initialises it;
    named as the program's module names its parameters."""
    i, h, c = cfg["in_dim"], cfg["hidden_dim"], cfg["num_classes"]
    w_in = torch.randn(i, h, generator=gen, device=device) * (2.0 / (i + h)) ** 0.5
    w_out = torch.randn(h, c, generator=gen, device=device) * (2.0 / (h + c)) ** 0.5
    out = {"w_in": w_in}
    out.update({f"beta.{k}": torch.ones((), device=device)
                for k in range(cfg["num_layers"])})
    out["w_out"] = w_out
    return out


def reference_forward(p: Dict[str, torch.Tensor], graph: ref.RefGraph, x,
                      cfg: dict, rnd: ref.Rounding) -> torch.Tensor:
    h = torch.relu(ref.matmul(x, p["w_in"], rnd))
    for k in range(cfg["num_layers"]):
        norm = torch.linalg.vector_norm(h, dim=-1, keepdim=True)
        hn = h / torch.clamp(norm, min=1e-6)
        scores = p[f"beta.{k}"] * ref.edge_dot(graph, hn, hn, rnd)
        h = ref.spmm(graph, ref.row_softmax(graph, scores), h, rnd)
    return ref.matmul(h, p["w_out"], rnd)


def sparse_ops(cfg: dict) -> List[dict]:
    """Per layer: the attention forward (scores on the edges, softmax,
    ``P H``, with Q = K); backward ``dP = sddmm(G, H)``, ``dH = Pᵀ G`` and
    the two products of the scores' gradient, ``dS K`` and ``dSᵀ Q``."""
    h = cfg["hidden_dim"]
    layer = [{"op": "attention", "width": h, "value_width": h},
             {"op": "sddmm", "width": h},
             {"op": "spmm", "width": h},
             {"op": "spmm", "width": h},
             {"op": "spmm", "width": h}]
    return layer * cfg["num_layers"]


def dense_flops(cfg: dict, n: int) -> int:
    """``X W_in`` and its weight gradient; ``H W_out``, its weight and its
    input gradients."""
    i, h, c = cfg["in_dim"], cfg["hidden_dim"], cfg["num_classes"]
    return 2 * (2 * n * i * h) + 3 * (2 * n * h * c)

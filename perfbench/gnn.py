"""The GNN family's side of a cell: full-graph node classification on a
graph the benchmark generates, trained by the program's own step.

A model kind of this family (``perfbench/models/gcn.py``, ``agnn.py``)
re-exports these entry points beside its own weights, plain reference
forward pass and counts; the harness reaches them by the kind's name:

  load_traffic(cell, cache_dir, log)   the cell's graph, cached, and
                                       the caches it filled
  make_program(cell, graph, devices)   ``from_coo`` and ``ad_plan``
  make_inputs(cell, graph, seed, devices)   features, labels, mask,
                                       weights: all from the seed
  trainer(cell, plan, inputs, devices)      the program's model and
                                       ``make_train_step``, holding the
                                       benchmark's weights
  reference_readings(cell, graph, inputs, devices, rounding, fault)
  step_counts(cell, graph)             the yardstick's FLOPs and least
                                       time of a step
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

import torch

from perfbench import counts, graphs, reference

__all__ = ["load_traffic", "make_program", "make_inputs", "trainer",
           "reference_readings", "step_counts", "Inputs", "FAULTS"]

DTYPES = {"float32": torch.float32}


def _device(cell, devices: List[torch.device]) -> torch.device:
    if cell.chips != 1 or len(devices) != 1:
        raise ValueError(f"{cell.name}: the GNN family runs on one card, "
                         f"not {cell.chips}")
    return devices[0]


def load_traffic(cell, cache_dir, log=lambda line: None
                 ) -> Tuple[graphs.Graph, List[str]]:
    """The cell's graph, from the cache or generated into it, held to the
    node and nonzero counts its traffic file states; and ``["graph"]``
    where this call filled the cache."""
    spec = cell.traffic["graph"]
    graph, generated = graphs.load_graph(spec, cache_dir)
    want = cell.traffic["replica"]
    got = {"num_nodes": graph.num_nodes, "nnz": graph.nnz}
    if got != {k: want[k] for k in got}:
        raise ValueError(f"{cell.name}: the graph has {got}, its traffic "
                         f"file states {want}")
    log(f"perfbench: {cell.name}: {graph.num_nodes:,} nodes, "
        f"{graph.nnz:,} nonzeros ({'generated' if generated else 'cached'}),"
        f" {cell.traffic['dtype']}, route {cell.traffic['route']}")
    return graph, ["graph"] if generated else []


def make_program(cell, graph: graphs.Graph, devices):
    """The program's adjacency: ME-BCRS from the COO, then its plan."""
    from repro_torch.core import ad_plan, from_coo

    cfg = cell.config
    fmt = from_coo(graph.rows, graph.cols, graph.vals,
                   (graph.num_nodes, graph.num_nodes),
                   vector_size=cfg["vector_size"],
                   dtype=DTYPES[cell.traffic["dtype"]])
    return ad_plan(fmt, impl=cell.traffic["route"], k_blk=cfg["k_blk"],
                   n_example=cfg["hidden_dim"],
                   device=_device(cell, devices))


@dataclasses.dataclass
class Inputs:
    """What the benchmark makes and hands to both sides."""
    x: torch.Tensor          # (n, in_dim) float32
    labels: torch.Tensor     # (n,) int64
    mask: torch.Tensor       # (n,) float32, 1 on training nodes
    weights: Dict[str, torch.Tensor]   # float32, the program's names


def make_inputs(cell, graph: graphs.Graph, seed: int, devices) -> Inputs:
    """Features, labels and training mask as ``make_task`` makes them
    (planted class centres plus noise), then the weights; all from one
    generator on the device seeded with ``seed``."""
    device = _device(cell, devices)
    cfg, task = cell.config, cell.traffic["task"]
    gen = torch.Generator(device).manual_seed(seed)
    n, c = graph.num_nodes, cfg["num_classes"]
    labels = torch.randint(0, c, (n,), generator=gen, device=device)
    centers = torch.randn(c, cfg["in_dim"], generator=gen, device=device)
    x = centers[labels] + task["noise"] * torch.randn(
        n, cfg["in_dim"], generator=gen, device=device)
    mask = (torch.rand(n, generator=gen, device=device)
            < task["train_share"]).float()
    weights = cell.model().init_weights(cfg, gen, device)
    return Inputs(x, labels, mask, weights)


def _program_class(dotted: str):
    mod, _, attr = dotted.partition(":")
    return getattr(importlib.import_module(mod), attr)


def trainer(cell, plan, inputs: Inputs, devices):
    """The program's model holding the benchmark's weights, and its train
    step (SGD with momentum) called on the plan and the inputs."""
    from perfbench.harness import Trainer
    from repro_torch.models.gnn import GNNConfig, make_train_step

    device = _device(cell, devices)
    cfg, dtype = cell.config, DTYPES[cell.traffic["dtype"]]
    gcfg = GNNConfig(model=cfg["model"], in_dim=cfg["in_dim"],
                     hidden_dim=cfg["hidden_dim"],
                     num_classes=cfg["num_classes"],
                     num_layers=cfg["num_layers"],
                     impl=cell.traffic["route"], dtype=dtype)
    model = _program_class(cfg["program_model"])(gcfg, device=device)
    params = dict(model.named_parameters())
    if set(params) != set(inputs.weights):
        raise ValueError(f"the program's parameters {sorted(params)} are "
                         f"not the benchmark's {sorted(inputs.weights)}")
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(inputs.weights[k])
    step = make_train_step(gcfg, model, lr=cfg["optimizer"]["lr"])
    x = inputs.x.to(dtype)

    def first_grad_norms() -> Dict[str, float]:
        """SGD's momentum buffer after one step is the first gradient; a
        leaf that holds no buffer got none."""
        state = step.optimizer.state
        return {k: float(torch.linalg.vector_norm(
                    state[p]["momentum_buffer"].float()))
                if "momentum_buffer" in state.get(p, {}) else 0.0
                for k, p in params.items()}

    return Trainer(params=params,
                   call=lambda: step(plan, x, inputs.labels, inputs.mask),
                   first_grad_norms=first_grad_norms)


def _half_batch(inputs: Inputs) -> torch.Tensor:
    half = inputs.mask.clone()
    half[half.shape[0] // 2:] = 0
    return half


FAULTS = {"half_batch": _half_batch}


def reference_readings(cell, graph: graphs.Graph, inputs: Inputs, devices, *,
                       rounding: Optional[str] = None,
                       fault: Optional[str] = None) -> dict:
    """The plain reference's readings on the same inputs, in float64 (see
    :mod:`perfbench.reference`); ``rounding="tf32"`` puts it at the
    control's precision, ``fault="half_batch"`` leaves the second half of
    the nodes out of the mean (a planted fault)."""
    device = _device(cell, devices)
    rg = reference.RefGraph.from_numpy(graph.num_nodes, graph.rows,
                                       graph.cols, graph.vals, device)
    opt, model = cell.config["optimizer"], cell.model()
    fwd = lambda p, g, x, rnd: model.reference_forward(p, g, x, cell.config,
                                                      rnd)
    mask = inputs.mask if fault is None else FAULTS[fault](inputs)
    return reference.train_readings(
        fwd, inputs.weights, rg, inputs.x, inputs.labels, mask,
        lr=opt["lr"], momentum=opt["momentum"], steps=cell.checked_steps,
        rnd=reference.Rounding(rounding),
        dtype=torch.float32 if rounding else torch.float64)


def step_counts(cell, graph: graphs.Graph) -> dict:
    """The yardstick of one step (:mod:`perfbench.counts`): its model
    FLOPs, dense and sparse on the true nonzeros, and the least time of
    its sparse products."""
    model, dtype = cell.model(), cell.traffic["dtype"]
    ops = model.sparse_ops(cell.config)
    n, nnz = graph.num_nodes, graph.nnz
    return {"flops": model.dense_flops(cell.config, n)
            + sum(counts.op_flops(op, nnz) for op in ops),
            "peak_flops_per_s": counts.PEAK_FLOPS_PER_S[dtype],
            "sparse_least_ms": counts.least_ms(ops, n, nnz, dtype)}

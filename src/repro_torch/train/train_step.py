"""Train-step builders: the LM step (microbatched gradient accumulation,
compression, AdamW) and the GNN step (paper §4.4 end-to-end case).

Counterpart of ``repro.train.train_step``.  The LM step
``train_step(state, batch) -> (state, metrics)`` composes, as the
reference's:

  batch (B, S) -> (microbatches, B/mu, S)
  a Python loop over the microbatches: loss and gradients by autograd
    (per-layer remat lives inside the model via ``cfg.remat``), summed in
    ``accum_dtype``
  optional gradient compression (int8 / top-k) with error feedback in
    ``state["err"]``: the numerics of a compressed data-parallel
    reduction (quantize -> reduce -> dequantize)
  AdamW (optionally 8-bit moments), in place

The state keeps the reference's stacked layout (``"layers"`` and
``"encoder"`` as dicts of ``(L, ...)`` tensors), so weight decay, int8
blocks, top-k's ``k`` and the 8-bit scales see the reference's leaves.

A **sharded** state (its leaves ``DTensor``s on a ``("data", "model")``
mesh: ``distributed.elastic.reshard_state``) runs the same step, the
math the one-device step's: the forward and backward under the state's
mesh as the ambient one (``constrain`` lays out the activations) and
under ``implicit_replication`` (the constants the model makes, rope
tables and masks, meet DTensor operands as replicated); each gradient is
reduced to its parameter's placements; AdamW updates the shards.  The
batch is sharded by ``sharding.batch_pspec``.  Gradient compression
runs on the shards (``compression.roundtrip_sharded``), on a leaf made
whole where an int8 block or top-k's ``k`` straddles ranks: the
one-device step's result, to summation order.

``compressed_psum`` is an int8-compressed mean over a process group
(all-gather the codes and scales, dequantize and average locally).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Shard

from repro_torch.core.format import resolve_device
from repro_torch.core.quantize import quantize_blocked
from repro_torch.distributed.elastic import whole
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import (STACKED, init_lm, lm_loss, stack_layers,
                                   tensor_from_numpy)

from .compression import (CompressionConfig, compress_int8, compress_topk,
                          decompress_int8, decompress_topk, init_error,
                          roundtrip_sharded)
from .optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.pytree import leaves, tree_map, unflatten

__all__ = ["TrainStepConfig", "init_train_state", "train_state_from_jax",
           "accumulate_grads", "apply_gradients", "make_train_step",
           "make_gnn_train_step",
           "compressed_psum"]

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    opt: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    compression: CompressionConfig = CompressionConfig(kind="none")
    aux_weight: float = 0.01
    # gradient-accumulation dtype: float32, or bfloat16 to halve the
    # largest training buffer
    accum_dtype: str = "float32"


def init_train_state(cfg: ArchConfig, ts: TrainStepConfig,
                     generator: torch.Generator, device=None) -> Dict[str, Any]:
    """Parameters from ``init_lm`` (drawn from ``generator``) in the
    stacked layout, AdamW state, the step counter and, under
    compression, the error buffers; on ``device`` (default: the card)."""
    device = resolve_device(device)
    params = stack_layers(init_lm(cfg, generator, device))
    state: Dict[str, Any] = {
        "params": params,
        "opt": adamw_init(params, ts.opt),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if ts.compression.kind != "none":
        state["err"] = init_error(params)
    return state


def train_state_from_jax(cfg: ArchConfig, state: Dict, device=None) -> Dict:
    """The port's train state from the JAX package's (numpy leaves, bf16
    as ``ml_dtypes.bfloat16``): leaf for leaf, the same tree, its layers
    stacked.  ``device`` defaults to the card."""
    device = resolve_device(device)
    out = tree_map(lambda arr: tensor_from_numpy(arr, device), state)
    for key in STACKED:
        depth = cfg.encoder_layers if key == "encoder" else cfg.n_layers
        stacked = out["params"].get(key)
        if stacked is not None and any(x.shape[0] != depth
                                       for x in leaves(stacked)):
            raise ValueError(f"params[{key!r}] is not stacked over {depth} "
                             "layers")
    return out


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int
                        ) -> Dict[str, torch.Tensor]:
    """Each leaf (B, ...) as (n, B/n, ...).  A DTensor leaf split over
    its batch dim is split rank by rank: microbatch i takes the i-th
    slice of every rank's rows, so no row moves between ranks (a global
    reshape would regroup the rows across them).  Every row is in one
    microbatch as in the reference, and the step is its result to
    summation order where the microbatches hold equal counts of unmasked
    labels."""

    def resh(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by microbatches {n}")
        if not isinstance(x, DTensor):
            return x.reshape((n, b // n) + tuple(x.shape[1:]))
        loc = x.to_local()
        if loc.shape[0] % n:
            raise ValueError(f"a rank's {loc.shape[0]} rows not divisible "
                             f"by microbatches {n}")
        pl = [Shard(p.dim + 1) if isinstance(p, Shard) else p
              for p in x.placements]
        return DTensor.from_local(
            loc.reshape((n, loc.shape[0] // n) + tuple(loc.shape[1:])),
            x.device_mesh, pl, run_check=False)

    return {k: resh(v) for k, v in batch.items()}


def _state_mesh(params: Any):
    """The ``DeviceMesh`` of a sharded params tree, else ``None``."""
    first = leaves(params)[0]
    return first.device_mesh if isinstance(first, DTensor) else None


@contextlib.contextmanager
def _sharded(mesh):
    """The context of a sharded forward and backward (module docstring);
    nothing without a mesh."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.ctx import activation_mesh

    with activation_mesh(mesh), implicit_replication():
        yield


def _loss_and_grads(cfg: ArchConfig, ts: TrainStepConfig, params, batch):
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    flat = leaves(live)
    with _sharded(_state_mesh(params)):
        total, parts = lm_loss(live, batch, cfg, aux_weight=ts.aux_weight)
        grads = torch.autograd.grad(total, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else
                 g.redistribute(p.device_mesh, p.placements)
                 if isinstance(p, DTensor) else g
                 for p, g in zip(flat, grads)]
    return (whole(total.detach()),
            {k: whole(v.detach()) for k, v in parts.items()}, grads)


def accumulate_grads(cfg: ArchConfig, ts: TrainStepConfig, params: Dict,
                     batch: Dict) -> Tuple[torch.Tensor, Dict, Dict]:
    """The step's loss, its parts and the gradients (a tree like
    ``params``): one autograd pass, or the mean over ``ts.microbatches``
    passes summed in ``ts.accum_dtype``.  ``params`` are not changed."""
    n_mb = ts.microbatches
    if n_mb == 1:
        loss, parts, flat = _loss_and_grads(cfg, ts, params, batch)
        return loss, parts, unflatten(params, flat)
    acc_dt = getattr(torch, ts.accum_dtype)
    mbs = _split_microbatches(batch, n_mb)
    acc = [torch.zeros_like(p, dtype=acc_dt) for p in leaves(params)]
    loss_sum = ce_sum = aux_sum = 0.0
    for i in range(n_mb):
        loss, parts, grads = _loss_and_grads(
            cfg, ts, params, {k: v[i] for k, v in mbs.items()})
        for a, g in zip(acc, grads):
            a.add_(g.to(acc_dt))
        loss_sum = loss_sum + loss
        ce_sum = ce_sum + parts["ce"]
        aux_sum = aux_sum + parts["aux"]
    inv = 1.0 / n_mb
    return (loss_sum * inv, {"ce": ce_sum * inv, "aux": aux_sum * inv},
            unflatten(params, [a * inv for a in acc]))


def apply_gradients(state: Dict, grads: Dict, ts: TrainStepConfig
                    ) -> Tuple[Dict, Dict]:
    """The step after the gradients: compression with error feedback
    (``ts.compression``), then AdamW, in place on ``state``'s parameters
    and optimizer state.  Returns ``(new_state, {"grad_norm", "lr"})``;
    the new state holds the updated tensors, the advanced step counter
    and the new error buffers."""
    new_err = None
    if ts.compression.kind != "none" and _state_mesh(grads) is not None:
        grads, new_err = roundtrip_sharded(grads, state["err"],
                                           ts.compression)
    elif ts.compression.kind == "int8":
        comp, new_err = compress_int8(grads, state["err"], ts.compression)
        grads = decompress_int8(comp, grads)
    elif ts.compression.kind == "topk":
        comp, new_err = compress_topk(grads, state["err"], ts.compression)
        grads = decompress_topk(comp, grads)

    params, opt, om = adamw_update(grads, state["opt"], state["params"],
                                   ts.opt)
    new_state = {"params": params, "opt": opt, "step": state["step"] + 1}
    if new_err is not None:
        new_state["err"] = new_err
    return new_state, om


def make_train_step(cfg: ArchConfig, ts: TrainStepConfig
                    ) -> Callable[[Dict, Dict], Tuple[Dict, Dict]]:
    """The train step of one architecture: :func:`accumulate_grads`, then
    :func:`apply_gradients`.

    ``train_step(state, batch) -> (state, metrics)``: ``batch`` holds
    tensors on the state's device; the parameters and optimizer state of
    ``state`` are updated in place (the reference donates them) and the
    returned dict holds them, the step counter advanced.  ``metrics``:
    ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr``, 0-d tensors; the
    step never waits for the device.
    """

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        loss, parts, grads = accumulate_grads(cfg, ts, state["params"], batch)
        new_state, om = apply_gradients(state, grads, ts)
        metrics = {"loss": loss, "ce": parts["ce"], "aux": parts["aux"], **om}
        return new_state, metrics

    return train_step


def make_gnn_train_step(cfg, model: nn.Module, lr: float = 1e-2):
    """SGD-with-momentum train step for a GNN ``model`` (``GCN``/``AGNN``).

    Checks ``cfg.impl`` against the sparse-op registry first: the impl must
    carry the ``differentiable`` capability flag (``blocked`` natively; the
    ``cuda`` impls through the autograd Functions of
    :mod:`repro_torch.core.autodiff`, which need the adjacency as an
    ``ADPlan``).  A non-differentiable impl fails here with the list of
    usable ones.

    The update is the reference's ``mom = 0.9 * mom + g; p -= lr * mom``
    from ``mom = 0``, which is exactly ``torch.optim.SGD(lr=lr,
    momentum=0.9)`` (``dampening=0``, no Nesterov, no weight decay: its
    first step sets the buffer to ``g``).  The momentum lives in each
    parameter's dtype: bf16 for a bf16 model, as the reference's
    ``zeros_like`` of bf16 parameters; an int8 plan trains fp32 masters.

    ``step(adj, x, labels, train_mask) -> (loss, acc)`` runs one step and
    returns the loss and accuracy before the update; the step's gradients
    stay in each parameter's ``.grad`` until the next step.
    """
    from repro_torch.core import dispatch as sparse_dispatch
    from repro_torch.core.autodiff import ADPlan
    from repro_torch.models.gnn import gnn_loss

    sparse_dispatch.require("spmm", cfg.impl, differentiable=True)
    if cfg.model == "agnn":
        sparse_dispatch.require("sddmm", cfg.impl, differentiable=True)
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9)

    def step(adj, x, labels, train_mask):
        # The kernel impls differentiate only through the autograd
        # Functions, which need the ADPlan's cached transpose.
        if cfg.impl != "blocked" and not isinstance(adj, ADPlan):
            raise ValueError(
                f"impl={cfg.impl!r} trains only through an ADPlan adjacency "
                f"(build one with ad_plan(fmt, impl={cfg.impl!r})); got "
                f"{type(adj).__name__}")
        opt.zero_grad(set_to_none=True)
        loss, acc = gnn_loss(model.params(), adj, x, labels, train_mask, cfg)
        loss.backward()
        opt.step()
        return loss.detach(), acc.detach()

    step.optimizer = opt
    return step


# ---------------------------------------------------------------------------
# Compressed data-parallel reduction: all-gather int8 + local dequant-mean.
# ---------------------------------------------------------------------------


def compressed_psum(x: torch.Tensor, group=None, block: int = 256
                    ) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group`` (default: the whole
    world), sent as int8: each rank quantizes per block of ``block``
    elements (absmax scale), all-gathers codes and scales, and averages
    the dequantized copies.  NCCL on the card, gloo on the CPU."""
    q, scale = quantize_blocked(x.to(f32), block)
    n = dist.get_world_size(group)
    q_all = [torch.empty_like(q) for _ in range(n)]
    s_all = [torch.empty_like(scale) for _ in range(n)]
    dist.all_gather(q_all, q, group=group)
    dist.all_gather(s_all, scale, group=group)
    deq = torch.stack(q_all).to(f32) * torch.stack(s_all)[..., None]
    mean = deq.mean(dim=0).reshape(-1)
    return mean[:x.numel()].reshape(x.shape).to(x.dtype)

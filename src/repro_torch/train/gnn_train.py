"""End-to-end GNN training on FlashSparse operators (paper §4.4).

The port's counterpart of ``examples/gnn_train.py``: trains GCN (SpMM
aggregation) and AGNN (sparse attention) on a scaled paper graph.  The
adjacency is wrapped in an autodiff plan (``ad_plan``), so ``--impl``
selects any differentiable registry impl — ``blocked`` (plain PyTorch),
``cuda`` (the window-parallel kernels), ``cuda_balanced`` (the
block-parallel kernels over a schedule), ``cuda_tuned`` (the autotuner
picks the route and tiles of each direction when the plan is built, at
the model's hidden width; winners cached in
``$REPRO_TORCH_AUTOTUNE_CACHE``) or ``cuda_sharded`` /
``cuda_sharded_overlap`` (one rank-local launch of the block-parallel
kernels per rank of ``--mesh DATA,MODEL`` and an ``all_reduce``, or a
send/recv ring over segment batches) — and the backward pass runs the
dispatched transpose-SpMM/SDDMM duality through the same kernels.

  PYTHONPATH=src python -m repro_torch.train.gnn_train [--graph GitHub]
  PYTHONPATH=src python -m repro_torch.train.gnn_train --steps 2 \\
      --impl cuda --device cpu [--dtype bf16 | --int8]
      # smoke: one small config, asserts a finite, decreasing loss
  torchrun --nproc_per_node=N -m repro_torch.train.gnn_train --steps 2 \
      --impl cuda_sharded --mesh N,1
      # N ranks, one card each (gloo with --device cpu)

A sharded impl without ``--mesh`` runs on a one-rank mesh.

The full run trains each model at the reference's (V, dtype) pairs,
(8, f32), (16, f32) and (8, bf16).  ``--dtype bf16`` runs the smoke in
bf16 end to end (format, features, weights and momentum), as the
reference's; ``--int8`` keeps fp32 masters and builds the plan with
``precision="int8"``: the forward SpMMs quantize the adjacency values
per K-block, everything else runs at bf16 (DESIGN.md §13).  On the CPU
the kernel impls run their kernels' plain versions.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import ad_plan, from_coo
from repro_torch.core.format import resolve_device
from repro_torch.launch.mesh import mesh_from_arg
from repro_torch.models.gnn import AGNN, GCN, GNNConfig, make_train_step
from repro_torch.sparse.graphs import make_dataset

__all__ = ["make_task", "train_one", "main"]


def make_task(g, seed: int = 0, num_classes: int = 8, in_dim: int = 64):
    """Node features, labels and train mask as numpy arrays, made as the
    reference's ``make_task`` makes them: class centres plus noise."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=g.num_nodes)
    centers = rng.standard_normal((num_classes, in_dim)).astype(np.float32)
    x = centers[labels] + 0.5 * rng.standard_normal(
        (g.num_nodes, in_dim)).astype(np.float32)
    train_mask = (rng.random(g.num_nodes) < 0.7).astype(np.float32)
    return x, labels.astype(np.int64), train_mask


DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def train_one(g, x_np, labels_np, mask_np, *, model: str, v: int, impl: str,
              epochs: int, num_classes: int = 8, in_dim: int = 64,
              lr: float = 5e-3, device=None, dtype=torch.float32,
              precision=None, mesh=None):
    """Train one (model, V, dtype, impl) configuration for ``epochs``
    steps; ``precision`` is the plan's (``"int8"`` on fp32 masters),
    ``mesh`` the sharded impls' ``DeviceMesh``.
    Returns the losses, the last step's accuracy and ms per step (host
    clock, ending in a synchronise on the card)."""
    device = resolve_device(device)
    cfg = GNNConfig(model=model, in_dim=in_dim,
                    hidden_dim=128 if model == "gcn" else 32,
                    num_classes=num_classes,
                    num_layers=3 if model == "gcn" else 2, impl=impl,
                    dtype=dtype)
    fmt = from_coo(g.rows, g.cols, g.vals, (g.num_nodes, g.num_nodes),
                   vector_size=v, dtype=dtype)
    adj = ad_plan(fmt, impl=impl, n_example=cfg.hidden_dim, device=device,
                  mesh=mesh, precision=precision)
    x = torch.from_numpy(x_np).to(device=device, dtype=dtype)
    labels = torch.from_numpy(labels_np).to(device)
    mask = torch.from_numpy(mask_np).to(device)
    net = (GCN if model == "gcn" else AGNN)(cfg, device=device, seed=0)
    step = make_train_step(cfg, net, lr=lr)

    losses = []
    t0 = time.time()
    for _ in range(epochs):
        loss, acc = step(adj, x, labels, mask)
        losses.append(loss)   # device tensors: keep the loop asynchronous
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = (time.time() - t0) / max(epochs, 1) * 1e3
    return [float(l) for l in losses], float(acc), dt


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graph", default="GitHub")
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--model", default="both", choices=["gcn", "agnn", "both"])
    ap.add_argument("--impl", default="blocked",
                    choices=["blocked", "cuda", "cuda_balanced",
                             "cuda_tuned", "cuda_sharded",
                             "cuda_sharded_overlap"])
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="the sharded impls' mesh (run DATA*MODEL ranks "
                         "under torchrun); default 1,1")
    ap.add_argument("--steps", type=int, default=None,
                    help="smoke mode: run STEPS steps of one small config "
                         "and assert a finite loss decrease")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--dtype", default="f32", choices=sorted(DTYPES),
                    help="format, feature and weight dtype of the smoke "
                         "config (--steps): bf16 runs the kernels' bf16 "
                         "variants end to end")
    ap.add_argument("--int8", action="store_true",
                    help="smoke config on fp32 masters with an int8 plan: "
                         "per-K-block int8 adjacency values in the forward "
                         "SpMMs, bf16 elsewhere")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.int8 and args.dtype != "f32":
        ap.error("--int8 keeps fp32 masters; it takes --dtype f32")
    mesh = None
    if args.impl.startswith("cuda_sharded"):
        mesh = mesh_from_arg(args.mesh or "1,1", device=device)
    elif args.mesh is not None:
        ap.error("--mesh takes a sharded --impl")

    if args.steps is not None:
        scale = min(args.scale, 0.002)
        model = args.model if args.model != "both" else "gcn"
        g = make_dataset(args.graph, scale=scale)
        x, labels, mask = make_task(g)
        losses, _, dt = train_one(
            g, x, labels, mask, model=model, v=8, impl=args.impl,
            epochs=args.steps, lr=5e-2, device=device,
            dtype=DTYPES[args.dtype],
            precision="int8" if args.int8 else None, mesh=mesh)
        mode = "int8 plan" if args.int8 else args.dtype
        print(f"smoke {model} impl={args.impl} {mode} device={device}: loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f} ({dt:.1f} ms/step)")
        assert all(np.isfinite(l) for l in losses), f"non-finite loss: {losses}"
        assert losses[-1] < losses[0], \
            f"loss did not decrease under impl={args.impl}: {losses}"
        print(f"OK: finite decreasing loss through the {args.impl} gradient "
              "path")
        return

    g = make_dataset(args.graph, scale=args.scale)
    print(f"{args.graph} (scale {args.scale}): {g.num_nodes:,} nodes, "
          f"{g.num_edges:,} edges, device {device}")
    x, labels, mask = make_task(g)
    models = ["gcn", "agnn"] if args.model == "both" else [args.model]
    for model in models:
        for v, dtype_name in ((8, "f32"), (16, "f32"), (8, "bf16")):
            losses, acc, dt = train_one(
                g, x, labels, mask, model=model, v=v, impl=args.impl,
                epochs=args.epochs, device=device,
                dtype=DTYPES[dtype_name], mesh=mesh)
            print(f"  {model:4s} V={v:2d} {dtype_name:4s} impl={args.impl}: "
                  f"{dt:7.1f} ms/epoch | loss {losses[-1]:.4f} | "
                  f"train acc {acc:.3f}")


if __name__ == "__main__":
    main()

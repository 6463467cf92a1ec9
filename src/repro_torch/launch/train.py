"""End-to-end LM training driver.

Counterpart of ``repro.launch.train``: config registry -> synthetic data
pipeline -> train step (microbatches, compression, AdamW with optional
8-bit states) -> checkpoint manager (atomic, async, keep-N) -> resume
from the newest checkpoint.  On the card unless ``--device`` names
another device (``--device cpu`` runs the reduced configs here).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --reduced --steps 50 --batch 8 --seq 128 --checkpoint-dir DIR

``--data-axis D --model-axis M`` with ``D * M > 1`` trains the sharded
LM on a ``(D, M)`` mesh (``launch/mesh.py``: NCCL on cards, gloo with
``--device cpu``), one rank per process under ``torchrun``:

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen3-0.6b --reduced --device cpu --data-axis 2 \\
      --model-axis 2 --steps 4

The state is laid out by the logical rules (``distributed/elastic.py``:
params by ``param_shardings``, the moments by ``shardings_like``), the
batch by ``batch_pspec``, and the step runs under the mesh
(``train_step.py``).  A checkpoint holds the global tensors (rank 0
writes, the others wait), so a run resumes onto any mesh shape.

Kill the process mid-run and start it again with the same flags: it
resumes from the newest complete checkpoint (``[resume]``); the batches
are a function of the step, so the run continues as if never stopped.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true",
                   help="smoke-scale config (CPU-runnable)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--compress", default="none",
                   choices=["none", "int8", "topk"])
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=20)
    p.add_argument("--data-axis", type=int, default=1)
    p.add_argument("--model-axis", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; cpu to run here)")
    return p.parse_args(argv)


def _barrier(mesh) -> None:
    """Every rank of ``mesh`` waits for rank (0, 0): a barrier over each
    mesh dim's group, in turn (a rank outside the mesh does not call)."""
    for dim in mesh.mesh_dim_names:
        dist.barrier(group=mesh.get_group(dim))


def run(args, mesh=None) -> Dict:
    """Train as ``args`` say; returns the state, the first step run and
    each step's loss (floats, read from the device after the last step).

    ``mesh``: a ``(data, model)`` DeviceMesh of the ranks that train (its
    shape must be the flags'); by default one is made when ``data *
    model > 1`` (``make_mesh``, which needs the ranks of a torchrun)."""
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.core.format import resolve_device
    from repro_torch.data.synthetic import SyntheticLMData
    from repro_torch.distributed.elastic import reshard_state, whole
    from repro_torch.distributed.sharding import batch_pspec, placements
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.pytree import tree_map
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.compression import CompressionConfig
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainStepConfig,
                                              init_train_state,
                                              make_train_step)

    device = resolve_device(args.device)
    shape = (args.data_axis, args.model_axis)
    if mesh is None and shape != (1, 1):
        mesh = make_mesh(*shape, device=device)
    if mesh is not None and tuple(mesh.shape) != shape:
        raise ValueError(f"mesh {tuple(mesh.shape)} is not --data-axis "
                         f"{shape[0]} --model-axis {shape[1]}")
    lead = mesh is None or tuple(mesh.get_coordinate() or (1,)) == (
        0,) * mesh.ndim
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    ts = TrainStepConfig(
        opt=AdamWConfig(lr=args.lr),
        microbatches=args.microbatches,
        compression=CompressionConfig(kind=args.compress),
    )
    data = SyntheticLMData(cfg, args.batch, args.seq, seed=args.seed)
    step_fn = make_train_step(cfg, ts)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = init_train_state(cfg, ts, gen, device)
    mgr = (CheckpointManager(args.checkpoint_dir)
           if args.checkpoint_dir else None)
    start_step = 0
    if mgr and mgr.latest_step() is not None:
        state, start_step = mgr.restore(state)
        if lead:
            print(f"[resume] restored checkpoint at step {start_step}")
    if mesh is not None:
        state = reshard_state(state, mesh)

    def save(step: int, sync: bool) -> None:
        if mesh is None:
            (mgr.save if sync else mgr.save_async)(state, step)
            return
        host = tree_map(lambda t: whole(t).cpu(), state)
        if lead:
            mgr.save(host, step)
        _barrier(mesh)

    t0 = time.time()
    tokens_done = 0
    losses = []
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch(step).items()}
        if mesh is not None:
            batch = {k: distribute_tensor(
                v, mesh, placements(batch_pspec(mesh, v.dim() - 1), mesh),
                src_data_rank=None) for k, v in batch.items()}
        state, metrics = step_fn(state, batch)
        tokens_done += args.batch * args.seq
        if lead and ((step + 1) % args.log_every == 0
                     or step == start_step):
            loss = float(metrics["loss"])
            gn = float(metrics["grad_norm"])
            tput = tokens_done / (time.time() - t0)
            print(f"step {step + 1:5d} | loss {loss:.4f} | "
                  f"gnorm {gn:.3f} | {tput:,.0f} tok/s")
        losses.append(metrics["loss"])
        if mgr and (step + 1) % args.checkpoint_every == 0:
            save(step + 1, sync=False)
    if mgr:
        mgr.wait()
        save(args.steps, sync=True)
        if lead:
            print(f"[done] final checkpoint at step {args.steps}")
    losses = [float(x) for x in losses]
    if losses and lead:
        print(f"final loss: {losses[-1]:.4f}")
    return {"state": state, "start_step": start_step, "losses": losses}


def main(argv: Optional[List[str]] = None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

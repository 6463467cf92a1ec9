"""End-to-end LM training driver.

Counterpart of ``repro.launch.train``: config registry -> synthetic data
pipeline -> train step (microbatches, compression, AdamW with optional
8-bit states) -> checkpoint manager (atomic, async, keep-N) -> resume
from the newest checkpoint.  One device: the card unless ``--device``
names another (``--device cpu`` runs the reduced configs here).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --reduced --steps 50 --batch 8 --seq 128 --checkpoint-dir DIR

Kill the process mid-run and start it again with the same flags: it
resumes from the newest complete checkpoint (``[resume]``); the batches
are a function of the step, so the run continues as if never stopped.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch


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


def run(args) -> Dict:
    """Train as ``args`` say; returns the state, the first step run and
    each step's loss (floats, read from the device after the last step)."""
    if args.data_axis != 1 or args.model_axis != 1:
        raise ValueError(
            f"--data-axis {args.data_axis} --model-axis {args.model_axis}: "
            "the sharded LM is not ported yet (ROADMAP queue 1, slice 14); "
            "this driver trains on one device")

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.core.format import resolve_device
    from repro_torch.data.synthetic import SyntheticLMData
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.compression import CompressionConfig
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainStepConfig,
                                              init_train_state,
                                              make_train_step)

    device = resolve_device(args.device)
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
        print(f"[resume] restored checkpoint at step {start_step}")

    t0 = time.time()
    tokens_done = 0
    losses = []
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch(step).items()}
        state, metrics = step_fn(state, batch)
        tokens_done += args.batch * args.seq
        if (step + 1) % args.log_every == 0 or step == start_step:
            loss = float(metrics["loss"])
            gn = float(metrics["grad_norm"])
            tput = tokens_done / (time.time() - t0)
            print(f"step {step + 1:5d} | loss {loss:.4f} | "
                  f"gnorm {gn:.3f} | {tput:,.0f} tok/s")
        losses.append(metrics["loss"])
        if mgr and (step + 1) % args.checkpoint_every == 0:
            mgr.save_async(state, step + 1)
    if mgr:
        mgr.wait()
        mgr.save(state, args.steps)
        print(f"[done] final checkpoint at step {args.steps}")
    losses = [float(x) for x in losses]
    if losses:
        print(f"final loss: {losses[-1]:.4f}")
    return {"state": state, "start_step": start_step, "losses": losses}


def main(argv: Optional[List[str]] = None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

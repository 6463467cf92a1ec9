"""The sharded routes across cards: one rank per card under torchrun.

    torchrun --nproc_per_node=4 -m repro_torch.testing.multicard
    torchrun --nproc_per_node=4 -m repro_torch.testing.multicard \\
        --device cpu --scale 0.005                  # gloo rehearsal

Every rank builds the Amazon replica (seeded, ``--scale`` of its size)
and runs, on each mesh of ``--meshes`` and each sharded impl
(``cuda_sharded``, ``cuda_sharded_overlap``), GCN and AGNN at
``GNNConfig``'s published widths: the logits against the one-card
``cuda_balanced`` route's (computed on the same rank), the first train
step's loss and gradients against that route's at the train gates, and
the step time (CUDA events, the slowest rank's).  Then, on the first
mesh, the bulk SpMM at N = 128 on A and Aᵀ: the sharded op, this rank's
local launch and the ``all_reduce`` alone, beside the one-card launch.
A failed check is counted on every rank and all ranks exit non-zero
together, so no rank is left waiting in a collective.  Rank 0 prints one
JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import statistics
import time

import torch
import torch.distributed as dist

__all__ = ["main"]

IMPLS = ("cuda_sharded", "cuda_sharded_overlap")
LOGIT_TOL = 1e-4                  # forwards against the one-card route
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-3, 1e-4   # the first step's gradients


def _ms(fn, device, reps: int = 5, batch: int = 3) -> float:
    """Median ms of one call: CUDA events on the card, the host clock on
    the CPU; the slowest rank's."""
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(batch):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / batch)
        else:
            t0 = time.perf_counter()
            for _ in range(batch):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / batch)
    t = torch.tensor([statistics.median(times)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def main(argv=None) -> None:
    from repro_torch.core import ad_plan, from_coo
    from repro_torch.core.format import resolve_device
    from repro_torch.distributed import spmm_sharded, spmm_sharded_local
    from repro_torch.kernels import _build, spmm_balanced_cuda
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.gnn import AGNN, GCN, GNNConfig, gnn_loss
    from repro_torch.sparse.graphs import make_dataset
    from repro_torch.train.gnn_train import make_task
    from repro_torch.train.train_step import make_gnn_train_step

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--meshes", default="4,1;2,2",
                    help="DATA,MODEL shapes, ';'-separated")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            timeout=datetime.timedelta(seconds=300))
    rank = dist.get_rank()
    shapes = [tuple(int(v) for v in s.split(",")) for s in
              args.meshes.split(";")]
    meshes = [make_mesh(d, m, device=device) for d, m in shapes]
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        if rank == 0:
            _build.build()
        dist.barrier()
    torch.backends.cuda.matmul.allow_tf32 = False

    g = make_dataset("Amazon", args.scale, seed=0)
    n = g.num_nodes
    fmt = from_coo(g.rows, g.cols, g.vals, (n, n))
    x_np, labels_np, mask_np = make_task(g, seed=0, num_classes=16,
                                         in_dim=128)
    x = torch.from_numpy(x_np).to(device)
    labels = torch.from_numpy(labels_np).to(device)
    mask = torch.from_numpy(mask_np).to(device)
    cfgs = {"gcn": GNNConfig(model="gcn", in_dim=128, hidden_dim=128,
                             num_classes=16, num_layers=5),
            "agnn": GNNConfig(model="agnn", in_dim=128, hidden_dim=32,
                              num_classes=16, num_layers=5)}
    failures = []
    out = {"nodes": n, "ranks": dist.get_world_size(),
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu")}

    def check(label, got, want, rtol, atol):
        err = (got - want).abs().max().item()
        if not (torch.isfinite(got).all() and torch.allclose(
                got, want, rtol=rtol, atol=atol)):
            failures.append(f"{label}: max abs err {err:.3e}")
        return err

    def run(model, impl, plan):
        cfg = dataclasses.replace(cfgs[model], impl=impl)
        seed = 0 if model == "gcn" else 1
        net = (GCN if model == "gcn" else AGNN)(cfg, device=device,
                                                seed=seed)
        with torch.inference_mode():
            logits = net(plan, x)
        loss, _ = gnn_loss(net.params(), plan, x, labels, mask, cfg)
        loss.backward()
        grads = [p.grad.clone() for p in net.parameters()]
        step = make_gnn_train_step(cfg, net, lr=5e-2)
        return logits, loss.detach(), grads, step

    bplan = ad_plan(fmt, impl="cuda_balanced", device=device)
    refs = {model: run(model, "cuda_balanced", bplan) for model in cfgs}
    for model in cfgs:
        step = refs[model][3]
        out[f"{model}_cuda_balanced_step_ms"] = _ms(
            lambda: step(bplan, x, labels, mask), device)
    for (d, m), mesh in zip(shapes, meshes):
        for impl in IMPLS:
            plan = ad_plan(fmt, impl=impl, device=device, mesh=mesh)
            for model in cfgs:
                logits, loss, grads, step = run(model, impl, plan)
                r_logits, r_loss, r_grads, _ = refs[model]
                tag = f"{model}/{impl}/{d}x{m}"
                top = max(gr.abs().max().item() for gr in r_grads)
                row = {
                    "logits_err": check(f"{tag} logits", logits, r_logits,
                                        LOGIT_TOL,
                                        LOGIT_TOL * r_logits.abs().max()
                                        .item()),
                    "loss_err": check(f"{tag} loss", loss, r_loss,
                                      GRAD_RTOL, 0.0),
                    "grad_err": max(check(f"{tag} grad {j}", gr, rg,
                                          GRAD_RTOL, GRAD_ATOL_OF_MAX * top)
                                    for j, (gr, rg) in enumerate(
                                        zip(grads, r_grads))),
                    "step_ms": _ms(lambda: step(plan, x, labels, mask),
                                   device)}
                out[tag] = row
    # The bulk SpMM at N = 128 on the first mesh: the op, this rank's local
    # launch and the reduce alone, beside the one-card launch.
    mesh = meshes[0]
    data_rank = mesh.get_local_rank("data")
    group = mesh.get_group("data")
    splan = ad_plan(fmt, impl="cuda_sharded", device=device, mesh=mesh)
    b = torch.randn((n, 128), generator=torch.Generator().manual_seed(0)
                    ).to(device)
    for name, view, part in (("A", bplan.fwd, splan.fwd_part),
                             ("A^T", bplan.bwd, splan.bwd_part)):
        want = spmm_balanced_cuda(view, b)
        check(f"spmm {name} sharded", spmm_sharded(view, b, mesh=mesh,
                                                   part=part), want, 1e-4,
              1e-6 * want.abs().max().item())
        c = torch.zeros_like(want)          # the reduce's message
        out[f"spmm_{name}"] = {
            "one_card_ms": _ms(lambda: spmm_balanced_cuda(view, b), device),
            "sharded_ms": _ms(lambda: spmm_sharded(view, b, mesh=mesh,
                                                   part=part), device),
            "local_ms": _ms(lambda: spmm_sharded_local(view, b, part,
                                                       data_rank), device),
            "all_reduce_ms": _ms(lambda: dist.all_reduce(c, group=group),
                                 device),
            "all_reduce_bytes": c.numel() * c.element_size()}
    n_fail = torch.tensor([len(failures)], device=device)
    dist.all_reduce(n_fail)
    for f in failures:
        print(f"FAIL rank {rank}: {f}", flush=True)
    if rank == 0:
        print(json.dumps(out), flush=True)
    dist.destroy_process_group()
    if int(n_fail):
        raise SystemExit(f"{int(n_fail)} checks failed across the ranks")


if __name__ == "__main__":
    main()

"""Run the sharded ops on several gloo ranks of the CPU.

The multi-device layer (:mod:`repro_torch.distributed`) runs one rank per
process.  :func:`spawn` starts ``world`` processes (the ``forkserver``
start method: a fresh server process imports torch and the cases once,
and the ranks fork from it), joins them in a gloo group through a
``FileStore`` under a
working directory (no port, so runs side by side never collide), and has
every rank run a list of jobs; each job names a mesh shape and a case of
:data:`CASES`, and the ranks outside a job's mesh skip it.  Each rank's
results come back as one dict per rank: ``{job name: case output}``.

  results = spawn(4, [("ops41", (4, 1), "ops", inputs), ...], workdir)

The cases (the sharded ops, a GNN train step, the int8-compressed mean
of the LM train step, and the sharded LM's of :mod:`.lm_shard_cases`)
take numpy inputs, run on the CPU (the kernels'
plain versions) and return tensors, so a test can hold them against another
implementation in its own process.  This module imports no JAX.
"""

from __future__ import annotations

import datetime
import os
import pickle
import traceback
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.launch.mesh import AXES

__all__ = ["CASES", "spawn"]

# A rank that fails leaves the others waiting in a collective: the group's
# timeout ends the wait.
TIMEOUT_S = 120


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _ops_case(mesh: DeviceMesh, inp: dict) -> Dict[str, torch.Tensor]:
    """SpMM, SDDMM and attention of ``inp["impl"]`` on the pattern of
    ``inp["a"]``: 2-D and per-head (3-D) operands at fp32 and bf16, and
    the SpMM at int8; ``n_batches`` 2 for the overlapped impl."""
    from repro_torch.core import attention, from_dense, sddmm, spmm

    impl = inp["impl"]
    fmt = from_dense(inp["a"])
    kw = dict(impl=impl, mesh=mesh)
    if impl == "cuda_sharded_overlap":
        kw["n_batches"] = 2
    out = {}
    b2, b3 = _t(inp["b2"]), _t(inp["b3"])
    q2, k2, v2 = _t(inp["q2"]), _t(inp["k2"]), _t(inp["v2"])
    q3, k3, v3 = _t(inp["q3"]), _t(inp["k3"]), _t(inp["v3"])
    for prec in ("fp32", "bf16"):
        out[f"spmm2_{prec}"] = spmm(fmt, b2, precision=prec, **kw)
        out[f"spmm3_{prec}"] = spmm(fmt, b3, precision=prec, **kw)
        out[f"sddmm2_{prec}"] = sddmm(fmt, q2, k2, precision=prec, **kw)
        out[f"sddmm3_{prec}"] = sddmm(fmt, q3, k2, precision=prec, **kw)
        if inp["a"].shape[0] == inp["a"].shape[1]:
            out[f"attn2_{prec}"] = attention(fmt, q2, k2, v2, precision=prec,
                                             **kw)
            out[f"attn3_{prec}"] = attention(fmt, q3, k3, v3, precision=prec,
                                             **kw)
    out["spmm2_int8"] = spmm(fmt, b2, precision="int8", **kw)
    return out


def _train_case(mesh: DeviceMesh, inp: dict) -> Dict[str, object]:
    """A GNN on a sharded plan: the logits and every gradient at the
    given parameters, and the losses of two train steps from them."""
    from repro_torch.core import ad_plan, from_coo
    from repro_torch.models import gnn

    cfg = gnn.GNNConfig(impl=inp["impl"], **inp["cfg"])
    rows, cols, vals, n = inp["graph"]

    def fresh():
        return (gnn.params_from_jax(cfg, inp["params"], device="cpu"),
                ad_plan(from_coo(rows, cols, vals, (n, n)), impl=inp["impl"],
                        device="cpu", mesh=mesh))

    x, labels, mask = (_t(a) for a in inp["task"])
    net, plan = fresh()
    logits = net(plan, x)
    loss, _ = gnn.gnn_loss(net.params(), plan, x, labels, mask, cfg)
    loss.backward()
    grads = [p.grad.detach().clone() for p in net.parameters()]
    net, plan = fresh()
    step = gnn.make_train_step(cfg, net, lr=inp["lr"])
    losses = [float(step(plan, x, labels, mask)[0]) for _ in range(2)]
    return {"logits": logits.detach(), "grads": grads,
            "names": [name for name, _ in net.named_parameters()],
            "losses": torch.tensor(losses, dtype=torch.float64)}


def _compressed_psum_case(mesh: DeviceMesh, inp: dict
                          ) -> Dict[str, torch.Tensor]:
    """``compressed_psum`` over the mesh's data group of this rank's
    ``inp["x"][rank]``, as fp32 and as bf16."""
    from repro_torch.train.train_step import compressed_psum

    x = _t(inp["x"][dist.get_rank()])
    group = mesh.get_group("data")
    return {"fp32": compressed_psum(x, group, block=inp["block"]),
            "bf16": compressed_psum(x.to(torch.bfloat16), group,
                                    block=inp["block"])}


def _lm_case(name: str):
    """A case of :mod:`.lm_shard_cases` (imported when it runs)."""

    def run(mesh: DeviceMesh, inp: dict):
        from repro_torch.testing.lm_shard_cases import CASES as LM

        return LM[name](mesh, inp)

    return run


CASES = {"ops": _ops_case, "train": _train_case,
         "compressed_psum": _compressed_psum_case,
         **{name: _lm_case(name) for name in (
             "moe_ep", "collective_matmul", "reshard", "lm_train",
             "lm_8bit", "act_sp", "lm_cli", "lm_decode", "lm_loss")}}


# what the ranks import, torch's lazy imports of a DTensor step included
_PRELOAD = ["repro_torch.testing.multirank",
            "repro_torch.testing.lm_shard_cases", "repro_torch.models.lm",
            "repro_torch.train.train_step", "torch.distributed.tensor",
            "torch._dynamo"]


def _mesh(shape: Tuple[int, int]) -> DeviceMesh:
    """A ``("data", "model")`` mesh over the first ``data * model`` ranks
    (every rank of the group builds it; the others stand outside)."""
    data, model = shape
    return DeviceMesh("cpu", torch.arange(data * model).reshape(data, model),
                      mesh_dim_names=AXES)


def _worker(rank: int, world: int, workdir: str) -> None:
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "jobs.pkl"), "rb") as f:
        jobs = pickle.load(f)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    results = {}
    try:
        meshes = {}
        for name, shape, case, inp in jobs:
            if shape not in meshes:
                meshes[shape] = _mesh(shape)
            if rank < shape[0] * shape[1]:
                results[name] = CASES[case](meshes[shape], inp)
    except Exception:                          # noqa: BLE001 — reported
        results = {"error": traceback.format_exc()}
    torch.save(results, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def spawn(world: int, jobs: Sequence[tuple], workdir) -> List[dict]:
    """Run ``jobs`` (``(name, (data, model), case, inputs)``) on ``world``
    gloo ranks and return each rank's results; raises if a rank failed,
    with its traceback."""
    workdir = str(workdir)
    # The jobs go through a file: arguments larger than a pipe's buffer
    # would make each start wait for the child before to import torch.
    with open(os.path.join(workdir, "jobs.pkl"), "wb") as f:
        pickle.dump(list(jobs), f)
    # The ranks fork from a single-threaded server that imported torch and
    # the cases once (the first spawn of a process starts it): a rank
    # skips the seconds of CPU its own imports would take.
    mp.get_context("forkserver").set_forkserver_preload(_PRELOAD)
    mp.start_processes(_worker, args=(world, workdir), nprocs=world,
                       start_method="forkserver")
    out = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                      weights_only=False) for r in range(world)]
    for r, res in enumerate(out):
        if "error" in res:
            raise RuntimeError(f"rank {r} failed:\n{res['error']}")
    return out

"""Block-sparse attention on FlashSparse operators, checked and trained.

The port's counterpart of ``examples/sparse_attention_lm.py`` (it lives in
the package, as ``gnn_train`` does, since ``examples/`` belongs to the JAX
package).  A fixed block-sparse causal pattern (a local window plus
strided global keys) is stored as ME-BCRS at the paper's V = 8; the
multi-head layer ``models.layers.sparse_attention`` runs over an
``ad_plan`` of it.  On ``--impl cuda`` the forward is one launch of the
fused attention kernel for every head, and the backward the head-grid
SDDMM/SpMM kernels; ``cuda_balanced`` runs their block-parallel versions,
and ``cuda_sharded`` / ``cuda_sharded_overlap`` those per rank of
``--mesh DATA,MODEL`` (sequence windows over ``data``, heads over
``model``; a one-rank mesh without ``--mesh``).
The script holds the output and ∂out/∂Q against dense masked attention
and, with ``--steps N``, recovers a value projection by SGD through the
gradient path.  ``--precision bf16`` builds the plan with
``precision="bf16"`` (the reference's ``ad_plan`` knob): q, k and v are
drawn at bf16 and every op runs its kernels' bf16 variant, the
projection W staying an fp32 master; the checks then take the bf16
ladder.

  PYTHONPATH=src python -m repro_torch.train.sparse_attention_train \\
      [--seq 512] [--heads 2] [--head-dim 64] [--impl cuda] [--steps 2] \\
      [--precision bf16]
  PYTHONPATH=src python -m repro_torch.train.sparse_attention_train \\
      --device cpu --seq 256 --heads 2 --steps 2 [--precision bf16]
      # CPU smoke through the kernels' plain versions
  torchrun --nproc_per_node=4 -m repro_torch.train.sparse_attention_train \
      --impl cuda_sharded --mesh 2,2

Entry points run on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core import ad_plan, from_coo
from repro_torch.core import dispatch as sparse_dispatch
from repro_torch.core.format import resolve_device
from repro_torch.core.quantize import precision_dtype, validate_precision
from repro_torch.models.layers import sparse_attention, sparse_attention_staged

__all__ = ["block_sparse_causal_pattern", "dense_mask",
           "dense_masked_attention", "make_inputs", "initial_w",
           "params_from_jax", "value_projection_loss",
           "train_value_projection", "ValueProjectionRun", "main"]

KERNEL_IMPLS = ("cuda", "cuda_balanced", "cuda_sharded",
                "cuda_sharded_overlap")
# Against dense masked attention: the reference example's tolerances in
# fp32, and at bf16 the reference's ladder (DESIGN.md §13: within about
# 1e-2 of the fp32 run; the output and dQ are rounded to bf16).
TOLERANCES = {None: (2e-4, 2e-3), "fp32": (2e-4, 2e-3), "bf16": (2e-2, 5e-2)}


def block_sparse_causal_pattern(seq: int, window: int = 64, stride: int = 128):
    """``(rows, cols)`` int64 of the local causal window plus strided global
    keys: row i attends to keys ``max(0, i - window + 1) .. i`` and then to
    ``0, stride, 2·stride, …`` below that window, in that order, as the
    reference example's loop builds them, without a Python loop."""
    i = np.arange(seq, dtype=np.int64)
    lo = np.maximum(0, i - window + 1)
    n_local = i - lo + 1
    n_global = -(-lo // stride)
    per_row = n_local + n_global
    rows = np.repeat(i, per_row)
    rank = np.arange(rows.shape[0], dtype=np.int64) - np.repeat(
        np.cumsum(per_row) - per_row, per_row)
    local = np.repeat(n_local, per_row)
    cols = np.where(rank < local, np.repeat(lo, per_row) + rank,
                    (rank - local) * stride)
    return rows, cols


def dense_mask(rows, cols, seq: int, device=None) -> torch.Tensor:
    """The pattern as a dense ``(seq, seq)`` bool mask."""
    mask = torch.zeros((seq, seq), dtype=torch.bool,
                       device=resolve_device(device))
    mask[torch.as_tensor(rows, device=mask.device),
         torch.as_tensor(cols, device=mask.device)] = True
    return mask


def dense_masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: torch.Tensor, scale=None) -> torch.Tensor:
    """The oracle for one head: standard attention over the dense ``(S, S)``
    scores with the pattern's complement at -1e30, as the reference
    example's ``dense_head``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.where(mask, (q @ k.T) * scale, -1e30)
    return torch.softmax(scores, dim=-1) @ v


def make_inputs(seq: int, heads: int, head_dim: int = 64, seed: int = 0,
                precision=None):
    """``q``, ``k``, ``v`` of shape (heads, seq, head_dim) as numpy fp32,
    drawn in that order from ``default_rng(seed)`` as the example does; at
    ``precision="bf16"`` rounded to bf16 values (half to even), so both
    packages and the dense oracle see the operands a bf16 plan runs."""
    validate_precision(precision)
    rng = np.random.default_rng(seed)
    draws = [rng.standard_normal((heads, seq, head_dim)).astype(np.float32)
             for _ in range(3)]
    if precision == "bf16":
        draws = [torch.from_numpy(x).to(precision_dtype(precision)).float()
                 .numpy() for x in draws]
    return tuple(draws)


def initial_w(d: int) -> np.ndarray:
    """The example's initial value projection (numpy fp32)."""
    w = np.random.default_rng(1).standard_normal((d, d)).astype(np.float32)
    return w * np.float32(0.1)


def params_from_jax(*, device=None, **arrays) -> Dict[str, torch.Tensor]:
    """The port's tensors for the example's numpy arrays (``w``, ``q``,
    ``k``, ``v``; JAX arrays go through ``np.asarray`` first), on
    ``device`` (the card unless it says otherwise).  A bf16 leaf
    (``ml_dtypes.bfloat16``, which torch does not read) passes through
    float32, which holds every bf16 value exactly, and comes back bf16;
    every other leaf comes back float32."""
    device = resolve_device(device)
    out = {}
    for name, a in arrays.items():
        a = np.asarray(a)
        bf16 = a.dtype.name == "bfloat16"
        t = torch.from_numpy(np.asarray(a, np.float32)).to(device)
        out[name] = t.to(torch.bfloat16) if bf16 else t
    return out


def value_projection_loss(plan, q, k, v, w, target, *, impl=None,
                          staged: bool = False) -> torch.Tensor:
    """``mean((attention(q, k, v @ w) - target)²)`` through
    :func:`sparse_attention` or, with ``staged``, through
    :func:`sparse_attention_staged`, the mean in fp32 whatever the
    plan's precision (a bf16 plan's outputs are bf16)."""
    attend = sparse_attention_staged if staged else sparse_attention
    out = attend(plan, q, k, v @ w, impl=impl)
    return torch.mean((out.float() - target.float()) ** 2)


@dataclasses.dataclass
class ValueProjectionRun:
    """What :func:`train_value_projection` did."""

    losses: List[float]         # the loss at w before each step
    final: float                # the loss after the last step
    w: torch.Tensor             # the projection after the last step
    first_grad: torch.Tensor    # ∂loss/∂w of the first step


def train_value_projection(plan, q, k, v, impl=None, steps: int = 3,
                           lr: float = 0.05, *, staged: bool = False
                           ) -> ValueProjectionRun:
    """Recover a value projection W from attention outputs by SGD, as the
    reference example's ``train_value_projection``: the target is the
    attention of ``(q, k, v)``, W starts at :func:`initial_w`, and each
    step is ``W ← W − lr · ∂loss/∂W``.  Every forward is the layer's
    (the fused kernel on ``cuda``) and every backward the dispatched
    sparse duality, at the plan's precision (``ad_plan(...,
    precision=)``); W is an fp32 master, its gradient straight-through."""
    d = v.shape[-1]
    attend = sparse_attention_staged if staged else sparse_attention
    with torch.no_grad():
        target = attend(plan, q, k, v, impl=impl)
    w = torch.from_numpy(initial_w(d)).to(v.device)
    losses, first_grad = [], None
    for _ in range(steps):
        w_leaf = w.detach().requires_grad_(True)
        loss = value_projection_loss(plan, q, k, v, w_leaf, target,
                                     impl=impl, staged=staged)
        (gw,) = torch.autograd.grad(loss, w_leaf)
        losses.append(loss.detach())   # device tensors: no sync per step
        if first_grad is None:
            first_grad = gw
        w = (w_leaf - lr * gw).detach()
    with torch.no_grad():
        final = value_projection_loss(plan, q, k, v, w, target, impl=impl,
                                      staged=staged)
    return ValueProjectionRun([float(x) for x in losses], float(final), w,
                              first_grad)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--steps", type=int, default=0,
                    help="run N value-projection SGD steps through the "
                         "gradient path after the checks")
    ap.add_argument("--impl", default="cuda",
                    choices=["blocked"] + list(KERNEL_IMPLS))
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="the sharded impls' mesh (run DATA*MODEL ranks "
                         "under torchrun); default 1,1")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--precision", default=None, choices=["fp32", "bf16"],
                    help="the plan's precision (ad_plan(..., precision=)): "
                         "bf16 draws q, k, v at bf16 and runs every op's "
                         "bf16 variant")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    seq, d, heads = args.seq, args.head_dim, args.heads
    tol, dq_tol = TOLERANCES[args.precision]

    rows, cols = block_sparse_causal_pattern(seq)
    fmt = from_coo(rows, cols, np.ones(rows.shape, np.float32), (seq, seq),
                   vector_size=8)
    mesh = None
    if args.impl.startswith("cuda_sharded"):
        from repro_torch.launch.mesh import mesh_from_arg

        mesh = mesh_from_arg(args.mesh or "1,1", device=device)
    elif args.mesh is not None:
        ap.error("--mesh takes a sharded --impl")
    plan = ad_plan(fmt, impl=args.impl, device=device, mesh=mesh,
                   precision=args.precision)
    density = len(rows) / seq ** 2
    print(f"pattern: {len(rows):,} nonzeros of {seq * seq:,} "
          f"({density:.1%} dense), {plan.fwd.num_blocks:,} K-blocks; "
          f"impl={args.impl} precision={args.precision} device={device}")
    t = params_from_jax(device=device, **dict(zip(
        "qkv", make_inputs(seq, heads, d, precision=args.precision))))
    q, k, v = t["q"], t["k"], t["v"]

    with sparse_dispatch.record_calls() as log:
        out = sparse_attention(plan, q, k, v, impl=args.impl)
    if args.impl in KERNEL_IMPLS:
        assert log == [("attention", "cuda_fused_attn" if args.impl == "cuda"
                        else args.impl)], log
        print(f"forward: ONE fused-kernel dispatch for {heads} heads")

    mask = dense_mask(rows, cols, seq, device)
    dense = torch.stack([dense_masked_attention(q[h], k[h], v[h], mask)
                         for h in range(heads)])
    err = (out.float() - dense).abs().max().item()
    print(f"max |sparse - dense masked| = {err:.2e}")
    torch.testing.assert_close(out.float(), dense, rtol=tol, atol=tol)
    print("block-sparse attention == dense masked attention")

    qg = q.detach().requires_grad_(True)
    (gq,) = torch.autograd.grad(
        sparse_attention(plan, qg, k, v, impl=args.impl).float().sum(), qg)
    qd = q.detach().requires_grad_(True)
    (gq_dense,) = torch.autograd.grad(torch.stack(
        [dense_masked_attention(qd[h], k[h], v[h], mask)
         for h in range(heads)]).sum(), qd)
    gerr = (gq - gq_dense).abs().max().item()
    print(f"max |dsparse/dQ - ddense/dQ| = {gerr:.2e}")
    torch.testing.assert_close(gq, gq_dense, rtol=dq_tol, atol=dq_tol)
    print("sparse-attention gradients == dense masked gradients")

    if args.steps:
        run = train_value_projection(plan, q, k, v, args.impl, args.steps)
        assert all(map(math.isfinite, run.losses + [run.final])), run.losses
        assert run.final < run.losses[0], (run.losses, run.final)
        print(f"train: loss {run.losses[0]:.5f} -> {run.final:.5f} over "
              f"{args.steps} step(s) through impl={args.impl}")
        print("OK: finite decreasing loss through the "
              f"{args.impl} gradient path")


if __name__ == "__main__":
    main()

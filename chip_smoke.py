#!/usr/bin/env python3
"""Drive the PyTorch port of FlashSparse on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root, one card

It imports only ``repro_torch`` (from ``src/``), never JAX, and fails with
a non-zero exit at the first phase that fails:

  1. the card: name and power limit (``nvidia-smi``);
  2. build: ``nvcc`` compiles ``src/repro_torch/kernels/csrc/*.cu`` for
     sm_90a, one process per source, all started together; ``-Xptxas
     -v``'s register, shared-memory and spill lines;
  3. each kernel against its plain PyTorch version on the card: (a) on
     edge cases, the balanced kernels over schedules split at
     split_blk in {0, 1, 3} with one and two heads, shared and per-head
     operands, and the all-empty matrix (no balanced SDDMM launch), the
     run-carried SpMM and attention also against a second launch (same
     bits); the
     head-grid SpMM and SDDMM and the fused attention at H in {1, 2, 4}
     with every mix of shared and per-head operands, each bitwise-equal
     to H one-head launches; the non-coalesced SpMM bitwise-equal to the
     SpMM; the staged SpMM; (b) at the main paths' shapes: on the Amazon
     replica, the balanced kernels over the schedules of A and of its
     transpose (the run-carried SpMM and attention at split_blk in
     {0, 1, 3} and H in {1, 2}, each also against a second launch), and
     the two SpMM baselines at N = 128; on the attention pattern (12 heads,
     16,384 tokens, head dim 64), the head-grid SpMM on A and on its
     transpose, the balanced SpMM on its transpose (dV), the head-grid
     SDDMM and the fused attention;
  4. inference: GCN (5 x 128) and AGNN (hidden 32, 5 layers) on
     ``make_dataset("Amazon", 1.0, seed=0)`` over the ``cuda`` plan, the
     bare blocked format and the ``cuda_balanced`` plan, and GCN over the
     bare format with the two SpMM baselines (``cuda_noncoalesced``,
     ``cuda_staged``), each held against the same model with the plain
     ``blocked`` impl, with the kernels' launch counters read around each
     forward;
     4b. training: the gradients of ``spmm_ad``, ``sddmm_ad`` and
     ``attention_ad`` (β's included) under a random cotangent on both
     routes against ``blocked``; three steps of each model on ``cuda`` and
     ``cuda_balanced`` through ``make_gnn_train_step``; the first step's
     loss and gradients against the same step with ``blocked``, a finite
     decreasing loss, and the launch counters against the counts that the
     layers and the gradients the step needs give;
     4c. multi-head block-sparse attention forward at the widths of
     Longformer-base / LED-base (12 heads x 64, 16,384 tokens, the
     repository's causal window-64 / stride-128 pattern) on the ``cuda``
     (one fused launch for all heads), ``cuda_balanced`` and
     ``cuda_staged`` routes, each against ``blocked`` and, head by head,
     against dense masked attention;
     4d. its training: dout/dQ on ``cuda``, ``cuda_balanced`` and through
     ``sparse_attention_staged`` on the ``cuda`` plan against ``blocked``,
     and three value-projection SGD steps on each, with the launch
     counters against the derived counts;
  5. timing with CUDA events: each kernel, its plain version and one
     PyTorch library call computing the same function (a yardstick the port
     never calls), the balanced kernels at split_blk in {0, 1, 8, 32} with
     each run plan's runs, edge entries and partial bytes, the run length
     of the run-carried SpMM and attention swept at split_blk = 1, each
     forward and train step with its peak memory;
  6. where the time goes: ``torch.profiler`` over one forward and one train
     step of each model and route, device time by kernel and the device's
     idle share.

It prints one ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Kernel against plain version: both fp32, sums taken in another order.
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# A hub window (more K-blocks than HUB_OF_MEDIAN x the median window) is
# one fp32 running sum of n = blocks x k_blk terms in the window-parallel
# kernels.  Its rows are held against an fp64 product within
# KERNEL_ATOL + HUB_LAMBDA * sqrt(n) * 2^-24 * sum|a * b|, the
# probabilistic bound of a recursive fp32 sum (Higham and Mary, SIAM J.
# Sci. Comput. 41(5), 2019).
HUB_OF_MEDIAN, HUB_LAMBDA = 4, 3.0
# End to end: fp32 sums re-ordered over five layers.
E2E_RTOL, E2E_ATOL = 1e-4, 1e-4
# Training, first step against impl="blocked": each gradient is an fp32
# sum over the 403,394 rows (dW = hᵀ dH) or the 3.4 M edges (AGNN's β)
# through five layers, taken in another order; such sums drift by about
# sqrt(n) * 2^-24 ~ 4e-5 of the scale of their terms.  That scale is the
# model's, not each gradient's own: at init the β gradients of most AGNN
# layers cancel to 1e-5 .. 1e-10 of the largest gradient while their terms
# do not.  So in the model each gradient is held at rtol 1e-3 and atol 1e-4
# of the model's largest gradient entry, which leaves those β gradients
# below the floor; the op-level check holds every gradient of spmm_ad,
# sddmm_ad and attention_ad (β's included) under a random cotangent, where
# nothing cancels, at rtol 1e-3 and atol 1e-4 of that gradient's own
# largest entry.
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-3, 1e-4
TRAIN_STEPS = 3
TRAIN_LR = 5e-2  # the reference smoke's rate (examples/gnn_train.py)
# H100 SXM data sheet: device memory rate and fp32 rate outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

DEVICE = "cuda"
SCALE = 1.0  # the Amazon replica at full size

# Multi-head sparse attention at the widths of Longformer-base / LED-base
# (d_model 768 = 12 heads x 64) and LED's 16,384-token encoder length.
ATTN_SEQ, ATTN_HEADS, ATTN_DIM = 16384, 12, 64
# Against dense masked attention: the reference example's tolerances.
ATTN_DENSE_TOL, ATTN_DQ_TOL = 2e-4, 2e-3
ATTN_LR = 0.05  # the reference example's value-projection rate

KERNELS = {  # name: (route, impl that launches it, source, TPU kernel)
    "spmm": ("cuda", "cuda", "src/repro_torch/kernels/csrc/spmm.cu",
             "src/repro/kernels/spmm_pallas.py:110"),
    "sddmm": ("cuda", "cuda", "src/repro_torch/kernels/csrc/sddmm.cu",
              "src/repro/kernels/sddmm_pallas.py:49"),
    "attention": ("cuda", "cuda", "src/repro_torch/kernels/csrc/attention.cu",
                  "src/repro/kernels/attention_pallas.py:58"),
    "spmm_balanced": ("cuda", "cuda_balanced",
                      "src/repro_torch/kernels/csrc/spmm_balanced.cu",
                      "src/repro/kernels/spmm_pallas.py:453"),
    "sddmm_balanced": ("cuda", "cuda_balanced",
                       "src/repro_torch/kernels/csrc/sddmm_balanced.cu",
                       "src/repro/kernels/sddmm_pallas.py:313"),
    "attention_balanced": ("cuda", "cuda_balanced",
                           "src/repro_torch/kernels/csrc/attention_balanced.cu",
                           "src/repro/kernels/attention_pallas.py:241"),
    "spmm_noncoalesced": ("cuda", "cuda_noncoalesced",
                          "src/repro_torch/kernels/csrc/spmm_noncoalesced.cu",
                          "src/repro/kernels/spmm_pallas.py:271"),
    "spmm_batched": ("cuda", "cuda_batched",
                     "src/repro_torch/kernels/csrc/spmm_batched.cu",
                     "src/repro/kernels/spmm_pallas.py:294"),
    "spmm_staged": ("cuda", "cuda_staged",
                    "src/repro_torch/kernels/csrc/spmm_staged.cu",
                    "src/repro/kernels/spmm_pallas.py:613"),
    "sddmm_batched": ("cuda", "cuda_batched",
                      "src/repro_torch/kernels/csrc/sddmm_batched.cu",
                      "src/repro/kernels/sddmm_pallas.py:171"),
}


def phase(name: str) -> None:
    print(f"\n=== {name}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def compare(label: str, out, ref, rtol: float, atol: float,
            show: bool = True) -> float:
    """Fail unless ``out`` matches ``ref``; returns the max abs error."""
    import torch

    if out.shape != ref.shape:
        raise SystemExit(f"FAIL {label}: shape {tuple(out.shape)} != "
                         f"{tuple(ref.shape)}")
    if not bool(torch.isfinite(out).all()):
        raise SystemExit(f"FAIL {label}: non-finite values")
    err = (out - ref).abs().max().item() if out.numel() else 0.0
    scale = ref.abs().max().item() if ref.numel() else 0.0
    ok = torch.allclose(out, ref, rtol=rtol, atol=atol)
    if show or not ok:
        print(f"  {'ok  ' if ok else 'FAIL'} {label}: max abs err {err:.3e}, "
              f"max rel err {err / max(scale, 1e-30):.3e} "
              f"(rtol={rtol}, atol={atol})", flush=True)
    if not ok:
        raise SystemExit(f"FAIL {label}")
    return err


def cuda_ms(fn, reps: int = 5, batch: int = 10, warmup: int = 3) -> float:
    """Time of one call of ``fn`` in ms on the device: CUDA events around
    ``batch`` back-to-back calls, divided by ``batch``; the median over
    ``reps`` such runs, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def profile_run(run) -> dict:
    """Device time by kernel over one call of ``run``, and the share of
    that call's wall time (host clock, ending in a synchronise) in which
    no kernel ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.self_device_time_total / 1e3, e.count, e.key)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    idle = 1.0 - busy_ms / wall_ms
    print(f"  profiled wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {idle:.3f}")
    for ms_k, count, key in kernels[:6]:
        print(f"    {ms_k:8.3f} ms {count:3d}x  {key[:90]}")
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": idle,
            "top_kernels": [{"ms": t, "count": c, "name": k[:90]}
                            for t, c, k in kernels[:6]]}


def read_once(*tensors) -> int:
    """Bytes of the distinct tensors among ``tensors``: an input passed
    twice (Q = K) is read once."""
    seen = {}
    for t in tensors:
        seen[(t.data_ptr(), t.numel(), t.dtype)] = t.numel() * t.element_size()
    return sum(seen.values())


def bound(nbytes: int, flops: int) -> tuple:
    """Least time (ms) the card could take, and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def plan_stats(sched, num_windows: int, n: int = 128, dv: int = 32) -> dict:
    """The run plans of the run-carried SpMM and attention over ``sched``:
    runs, edge entries, combine-tree levels, and the fp32 partial bytes the
    kernel writes and the tree reads back at N = n (SpMM) or DV = dv
    (attention, with m and l), beside the partials of a per-segment pass,
    one per segment of every window that the schedule splits."""
    from repro_torch.kernels._combine import run_plan
    from repro_torch.kernels.attention_balanced_cuda import RUN_BLK as ATTN_RUN
    from repro_torch.kernels.spmm_balanced_cuda import RUN_BLK as SPMM_RUN

    v = 8
    nseg = np.bincount(sched.seg_win.cpu().numpy(), minlength=num_windows)
    split_segments = int(nseg[nseg > 1].sum())
    out = {"segments": sched.num_segments, "split_segments": split_segments}
    for kind, run_blk, entry_bytes in (("spmm", SPMM_RUN, 4 * v * n),
                                       ("attention", ATTN_RUN,
                                        4 * (v * dv + 2 * v))):
        plan = run_plan("chip_smoke", sched, num_windows, run_blk)
        out[kind] = {"run_blk": run_blk, "runs": plan.num_runs,
                     "pieces": plan.num_pieces, "entries": plan.entries,
                     "tree_levels": len(plan.tree.levels),
                     "partial_bytes": plan.entries * entry_bytes,
                     "segment_partial_bytes": split_segments * entry_bytes}
    return out


def print_plans(label: str, st: dict) -> None:
    for kind in ("spmm", "attention"):
        k = st[kind]
        ratio = k["segment_partial_bytes"] / max(k["partial_bytes"], 1)
        print(f"  {label}, {kind} run plan (run_blk={k['run_blk']}): "
              f"{k['runs']} runs, {k['pieces']} pieces, {k['entries']} edge "
              f"entries, {k['tree_levels']} tree levels; partials "
              f"{k['partial_bytes'] / 1e6:.3f} MB against "
              f"{k['segment_partial_bytes'] / 1e6:.3f} MB per segment "
              f"({st['split_segments']} of {st['segments']} segments), "
              f"{ratio:.1f}x fewer", flush=True)


def unit_rows(rng, m: int, d: int):
    import torch

    h = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32))
    return h / h.norm(dim=-1, keepdim=True).clamp(min=1e-6)


def kernel_cases(rng):
    """Edge cases: (label, dense matrix, V, k_blk, N, F = D, DV)."""
    def rand(m, k, density):
        keep = rng.random((m, k)) < density
        return (keep * rng.standard_normal((m, k))).astype(np.float32)

    empty = rand(100, 90, 0.1)
    empty[16:40] = 0.0
    return [
        ("empty windows (rows 16-39), N=200 ragged tile", empty, 8, 8, 200, 24, 40),
        ("M=45 not a multiple of 8, N=20", rand(45, 45, 0.2), 8, 8, 20, 32, 32),
        ("k_blk=4, N=130", rand(64, 64, 0.15), 8, 4, 130, 7, 5),
        ("k_blk=16, windows of 4 blocks, N=64", rand(64, 64, 0.3), 8, 16, 64, 33, 65),
        ("300 vectors per window, N=128", rand(300, 1000, 0.05), 8, 8, 128, 32, 32),
        ("k_blk=3, chunks across K-blocks", rand(40, 200, 0.5), 8, 3, 50, 16, 24),
        ("V=16, N=96", rand(77, 77, 0.2), 16, 8, 96, 24, 40),
        ("V=16, k_blk=4, N=33", rand(50, 61, 0.25), 16, 4, 33, 9, 16),
        ("all-empty matrix, N=40", np.zeros((30, 30), np.float32), 8, 8, 40, 8, 8),
    ]


def check_kernels_edge(rng) -> None:
    import torch

    from repro_torch.core.format import block_format, from_dense
    from repro_torch.core.sddmm import with_values
    from repro_torch.kernels import (attention_balanced_cuda,
                                     attention_balanced_plain, attention_cuda,
                                     attention_plain, sddmm_balanced_cuda,
                                     sddmm_balanced_plain, sddmm_cuda,
                                     sddmm_plain, spmm_balanced_cuda,
                                     spmm_balanced_plain, spmm_cuda,
                                     spmm_plain)

    def t(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(DEVICE)

    for label, a, v, k_blk, n, f, dv in kernel_cases(rng):
        blocked = block_format(from_dense(a, vector_size=v), k_blk,
                               device=DEVICE)
        m, k = a.shape
        b, q, kk, vv = t(k, n), t(m, f), t(k, f), t(k, dv)
        compare(f"spmm [{label}]", spmm_cuda(blocked, b), spmm_plain(blocked, b),
                KERNEL_RTOL, KERNEL_ATOL)
        compare(f"sddmm [{label}, F={f}]", sddmm_cuda(blocked, q, kk),
                sddmm_plain(blocked, q, kk), KERNEL_RTOL, KERNEL_ATOL)
        compare(f"attention [{label}, D={f}, DV={dv}]",
                attention_cuda(blocked, q, kk, vv),
                attention_plain(blocked, q, kk, vv), KERNEL_RTOL, KERNEL_ATOL)
        # Balanced kernels: split_blk 0 / 1 / 3; one head with shared
        # operands, two heads with per-head vals, B, Q and V and shared K.
        # The run-carried SpMM and attention sum in a fixed order: a second
        # launch gives the same bits.
        errs = []
        sddmm_before = sddmm_balanced_cuda.launches
        for split in (0, 1, 3):
            sched = blocked.schedule(split)
            for h in (1, 2):
                hs = (h,) if h > 1 else ()
                bv = with_values(blocked, t(*hs, *blocked.vals.shape)
                                 * blocked.mask)
                bh, qh, vh = t(*hs, k, n), t(*hs, m, f), t(*hs, k, dv)
                beta = torch.tensor(0.8, device=DEVICE)
                tag = f"[{label}, split_blk={split}, H={h}]"
                c_out = spmm_balanced_cuda(bv, bh, schedule=sched)
                a_out = attention_balanced_cuda(blocked, qh, kk, vh,
                                                scale=beta, schedule=sched)
                bitwise(f"spmm_balanced {tag}, second launch", c_out,
                        spmm_balanced_cuda(bv, bh, schedule=sched))
                bitwise(f"attention_balanced {tag}, second launch", a_out,
                        attention_balanced_cuda(blocked, qh, kk, vh,
                                                scale=beta, schedule=sched))
                errs.append(max(
                    compare(f"spmm_balanced {tag}", c_out,
                            spmm_balanced_plain(bv, bh, sched),
                            KERNEL_RTOL, KERNEL_ATOL, show=False),
                    compare(f"sddmm_balanced {tag}",
                            sddmm_balanced_cuda(blocked, qh, kk,
                                                schedule=sched),
                            sddmm_balanced_plain(blocked, qh, kk, sched),
                            KERNEL_RTOL, KERNEL_ATOL, show=False),
                    compare(f"attention_balanced {tag}", a_out,
                            attention_balanced_plain(blocked, qh, kk, vh,
                                                     sched, beta),
                            KERNEL_RTOL, KERNEL_ATOL, show=False)))
        sddmm_launched = sddmm_balanced_cuda.launches - sddmm_before
        print(f"  ok   balanced x3 [{label}], split_blk 0/1/3 x H 1/2: max abs "
              f"err {max(errs):.3e}, SpMM and attention the same bits on a "
              f"second launch; balanced SDDMM launches {sddmm_launched}",
              flush=True)
        if a.any() != (sddmm_launched == 6):
            raise SystemExit(f"FAIL [{label}]: {sddmm_launched} balanced SDDMM "
                             "launches (6 expected, 0 for the all-empty matrix)")
    torch.cuda.synchronize()


def check_hub_windows(label: str, blocked, vals, b, out, ref) -> float:
    """Hold ``out`` = Aᵀ⟨vals⟩ @ B (head-grid SpMM, (H, M, N)) to ``ref``
    (its plain version) at the kernel tolerance on the rows of ordinary
    windows, and to an fp64 product within the running-sum bound on the
    rows of hub windows.  Returns the max abs error of the ordinary rows."""
    import torch

    kb, v = blocked.k_blk, blocked.vector_size
    nb, m = blocked.num_blocks, blocked.shape[0]
    per_win = torch.diff(blocked.win_ptr.long())
    hub_win = per_win > HUB_OF_MEDIAN * per_win.median()
    hub_row = hub_win.repeat_interleave(v)[:m]
    err = compare(f"{label}, {int((~hub_win).sum())} ordinary windows "
                  "against the plain version", out[:, ~hub_row],
                  ref[:, ~hub_row], KERNEL_RTOL, KERNEL_ATOL)
    win = blocked.block_win.long()
    sel = torch.nonzero(hub_win[win]).squeeze(1)
    cols = blocked.cols.long().reshape(nb, kb)[sel]
    worst, kern_err, plain_err = 0.0, 0.0, 0.0
    for h in range(out.shape[0]):
        vals4 = vals[h].reshape(nb, kb, v)[sel].double()
        gb = b[h][cols].double()                              # (NS, K_BLK, N)
        exact = torch.zeros((blocked.num_windows, v, b.shape[-1]),
                            dtype=torch.float64, device=b.device)
        absum = torch.zeros_like(exact)
        exact.index_add_(0, win[sel], torch.einsum("bkv,bkn->bvn", vals4, gb))
        absum.index_add_(0, win[sel], torch.einsum("bkv,bkn->bvn",
                                                   vals4.abs(), gb.abs()))
        n = (per_win * kb).double().sqrt()[:, None, None]
        limit = KERNEL_ATOL + HUB_LAMBDA * n * 2.0 ** -24 * absum
        exact, limit = (t.reshape(-1, b.shape[-1])[:m][hub_row]
                        for t in (exact, limit))
        got = out[h][hub_row]
        if not bool(torch.isfinite(got).all()):
            raise SystemExit(f"FAIL {label}: non-finite values in head {h}")
        diff = (got.double() - exact).abs()
        ratio = (diff / limit).max().item()
        if ratio > 1.0:
            raise SystemExit(f"FAIL {label}: head {h}, hub rows off the fp64 "
                             f"product by {diff.max().item():.3e}, {ratio:.3f}"
                             " x the bound")
        worst = max(worst, ratio)
        kern_err = max(kern_err, diff.max().item())
        plain_err = max(plain_err, (ref[h][hub_row].double() - exact).abs()
                        .max().item())
    print(f"  ok   {label}, {int(hub_win.sum())} hub windows (up to "
          f"{int(per_win.max())} K-blocks) against fp64: max abs err "
          f"{kern_err:.3e}, at most {worst:.3f} x the bound {HUB_LAMBDA} "
          f"sqrt(n) 2^-24 sum|a b| + {KERNEL_ATOL}; the plain version's "
          f"blockwise sums are off fp64 by {plain_err:.3e}, the output's "
          f"largest entry is {out.abs().max().item():.3e}", flush=True)
    return err


def bitwise(label: str, out, ref) -> None:
    """Fail unless ``out`` and ``ref`` are the same bits."""
    import torch

    if out.shape != ref.shape or not torch.equal(out, ref):
        err = ((out - ref).abs().max().item() if out.shape == ref.shape
               else float("nan"))
        raise SystemExit(f"FAIL {label}: not bitwise-equal (max abs diff "
                         f"{err:.3e}, shapes {tuple(out.shape)} and "
                         f"{tuple(ref.shape)})")


def check_head_grids_edge(rng) -> None:
    """Phase 3a for the head-grid kernels, the fused attention over heads
    and the two SpMM baselines."""
    import torch

    from repro_torch.core.format import block_format, from_dense
    from repro_torch.core.sddmm import with_values
    from repro_torch.kernels import (attention_cuda, attention_plain,
                                     sddmm_batched_cuda, sddmm_batched_plain,
                                     sddmm_cuda, spmm_batched_cuda,
                                     spmm_batched_plain, spmm_cuda,
                                     spmm_noncoalesced_cuda, spmm_staged_cuda,
                                     spmm_staged_plain)

    def t(heads, *shape):
        return torch.from_numpy(rng.standard_normal(
            heads + shape).astype(np.float32)).to(DEVICE)

    def head(x, i):
        return x[i] if x.dim() == 3 else x

    two = ("first", "second", "both")
    # which of q, k, v carry the head dimension (at least one)
    three = [m for m in ((a, b, c) for a in (0, 1) for b in (0, 1)
                         for c in (0, 1)) if any(m)]
    beta = torch.tensor(0.8, device=DEVICE)
    for label, a, v, k_blk, n, f, dv in kernel_cases(rng):
        blocked = block_format(from_dense(a, vector_size=v), k_blk,
                               device=DEVICE)
        m, k = a.shape
        errs = []
        for h in (1, 2, 4):
            for mix in two:
                hf = (h,) if mix in ("first", "both") else ()
                hs = (h,) if mix in ("second", "both") else ()
                tag = f"[{label}, H={h}, per-head {mix}]"
                bv = with_values(blocked, t(hf, *blocked.vals.shape)
                                 * blocked.mask)
                b = t(hs, k, n)
                out = spmm_batched_cuda(bv, b)
                bitwise(f"spmm_batched {tag} vs {h} spmm launches", out,
                        torch.stack([spmm_cuda(with_values(
                            blocked, head(bv.vals, i)), head(b, i))
                            for i in range(h)]))
                errs.append(compare(f"spmm_batched {tag}", out,
                                    spmm_batched_plain(bv, b), KERNEL_RTOL,
                                    KERNEL_ATOL, show=False))
                q, kk = t(hf, m, f), t(hs, k, f)
                out = sddmm_batched_cuda(blocked, q, kk)
                bitwise(f"sddmm_batched {tag} vs {h} sddmm launches", out,
                        torch.stack([sddmm_cuda(blocked, head(q, i),
                                                head(kk, i))
                                     for i in range(h)]))
                errs.append(compare(f"sddmm_batched {tag}", out,
                                    sddmm_batched_plain(blocked, q, kk),
                                    KERNEL_RTOL, KERNEL_ATOL, show=False))
            for mq, mk, mv in three:
                q, kk, vv = (t((h,) if per else (), rows, width)
                             for per, rows, width in ((mq, m, f), (mk, k, f),
                                                      (mv, k, dv)))
                tag = f"[{label}, H={h}, per-head q/k/v {mq}{mk}{mv}]"
                out = attention_cuda(blocked, q, kk, vv, scale=beta)
                bitwise(f"attention {tag} vs {h} one-head launches", out,
                        torch.stack([attention_cuda(
                            blocked, head(q, i), head(kk, i), head(vv, i),
                            scale=beta) for i in range(h)]))
                errs.append(compare(f"attention {tag}", out,
                                    attention_plain(blocked, q, kk, vv, beta),
                                    KERNEL_RTOL, KERNEL_ATOL, show=False))
        b = t((), k, n)
        bitwise(f"spmm_noncoalesced [{label}] vs spmm",
                spmm_noncoalesced_cuda(blocked, b), spmm_cuda(blocked, b))
        errs.append(compare(f"spmm_staged [{label}]",
                            spmm_staged_cuda(blocked, b),
                            spmm_staged_plain(blocked, b), KERNEL_RTOL,
                            KERNEL_ATOL, show=False))
        print(f"  ok   [{label}]: spmm_batched, sddmm_batched (H 1/2/4 x 3 "
              "mixes) and attention (H 1/2/4 x 7 mixes) bitwise-equal to "
              "their one-head launches, spmm_noncoalesced bitwise-equal to "
              f"spmm; against the plain versions max abs err {max(errs):.3e}",
              flush=True)
    torch.cuda.synchronize()


def attention_setup(rng) -> dict:
    """The multi-head attention configuration on the card: the pattern,
    its ``cuda`` and ``cuda_balanced`` plans, q, k and v (the reference
    example's inputs, from numpy seed 0) and a random cotangent g."""
    import torch

    from repro_torch.core.autodiff import ad_plan
    from repro_torch.core.format import from_coo
    from repro_torch.train.sparse_attention_train import (
        block_sparse_causal_pattern, make_inputs, params_from_jax)

    t0 = time.time()
    rows, cols = block_sparse_causal_pattern(ATTN_SEQ)
    fmt = from_coo(rows, cols, np.ones(rows.shape, np.float32),
                   (ATTN_SEQ, ATTN_SEQ), vector_size=8)
    plan = ad_plan(fmt, impl="cuda", k_blk=8, device=DEVICE)
    bplan = ad_plan(fmt, impl="cuda_balanced", k_blk=8, split_blk=1,
                    device=DEVICE)
    t_host = time.time() - t0
    print(f"  attention pattern: S={ATTN_SEQ}, window 64, stride 128: "
          f"{rows.shape[0]} nonzeros, {plan.fwd.num_windows} windows; "
          f"pattern + plans {t_host:.1f} s on the host")
    for dirn, bl, sc in (("A", bplan.fwd, bplan.fwd_sched),
                         ("A^T", bplan.bwd, bplan.bwd_sched)):
        per_win = np.diff(bl.win_ptr.cpu().numpy())
        print(f"  {dirn}: {bl.num_blocks} K-blocks, NNZP={bl.vals.shape[0]}, "
              f"blocks per window mean {per_win.mean():.2f}, max "
              f"{per_win.max()}; split_blk=1 schedule: {sc.num_segments} "
              "segments")
    t = params_from_jax(device=DEVICE, **dict(zip(
        "qkv", make_inputs(ATTN_SEQ, ATTN_HEADS, ATTN_DIM))))
    g = torch.from_numpy(rng.standard_normal(
        (ATTN_HEADS, ATTN_SEQ, ATTN_DIM)).astype(np.float32)).to(DEVICE)
    return dict(rows=rows, cols=cols, plan=plan, bplan=bplan, g=g,
                scale=1.0 / math.sqrt(ATTN_DIM), host_s=t_host, **t)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script runs the port on a CUDA card only")

    from repro_torch.core.autodiff import (ad_plan, attention_ad, sddmm_ad,
                                           spmm_ad)
    from repro_torch.core.format import from_coo
    from repro_torch.kernels import (_build, attention_balanced_cuda,
                                     attention_balanced_plain, attention_cuda,
                                     attention_plain, sddmm_balanced_cuda,
                                     sddmm_balanced_plain, sddmm_batched_cuda,
                                     sddmm_batched_plain, sddmm_cuda,
                                     sddmm_plain, spmm_balanced_cuda,
                                     spmm_balanced_plain, spmm_batched_cuda,
                                     spmm_batched_plain, spmm_cuda,
                                     spmm_noncoalesced_cuda,
                                     spmm_noncoalesced_plain, spmm_plain,
                                     spmm_staged_cuda, spmm_staged_plain)
    from repro_torch.core.sddmm import attention, with_values
    from repro_torch.kernels._combine import run_plan
    from repro_torch.kernels.attention_balanced_cuda import RUN_BLK as ATTN_RUN
    from repro_torch.kernels.spmm_balanced_cuda import RUN_BLK as SPMM_RUN
    from repro_torch.core.softmax import sparse_softmax
    from repro_torch.models.gnn import (AGNN, GCN, GNNConfig, agnn_forward,
                                        gcn_forward, gnn_loss)
    from repro_torch.models.layers import (sparse_attention,
                                           sparse_attention_staged)
    from repro_torch.sparse.graphs import make_dataset
    from repro_torch.train.sparse_attention_train import (
        dense_mask, dense_masked_attention, initial_w, train_value_projection,
        value_projection_loss)
    from repro_torch.train.gnn_train import make_task
    from repro_torch.train.train_step import make_gnn_train_step

    wrappers = {"spmm": spmm_cuda, "sddmm": sddmm_cuda,
                "attention": attention_cuda,
                "spmm_balanced": spmm_balanced_cuda,
                "sddmm_balanced": sddmm_balanced_cuda,
                "attention_balanced": attention_balanced_cuda,
                "spmm_noncoalesced": spmm_noncoalesced_cuda,
                "spmm_batched": spmm_batched_cuda,
                "spmm_staged": spmm_staged_cuda,
                "sddmm_batched": sddmm_batched_cuda}

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    def expect(**nonzero):
        return {name: nonzero.get(name, 0) for name in wrappers}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()

    phase("1. card")
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {kind}, count {torch.cuda.device_count()}")
    print("torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False (fp32 references)")

    phase("2. build kernels (nvcc, sm_90a)")
    t0 = time.time()
    for name, path in _build.build().items():
        print(f"  {name}: {path.relative_to(ROOT)}")
    print(f"  built in {time.time() - t0:.1f} s")
    print(_build.ptxas_report())

    phase("3a. kernels against their plain versions: edge cases")
    rng = np.random.default_rng(0)
    check_kernels_edge(rng)
    check_head_grids_edge(rng)

    phase("3b. kernels against their plain versions: main-path shapes")
    t0 = time.time()
    g = make_dataset("Amazon", SCALE, seed=0)
    t_graph = time.time() - t0
    t0 = time.time()
    fmt = from_coo(g.rows, g.cols, g.vals, (g.num_nodes, g.num_nodes),
                   vector_size=8)
    plan = ad_plan(fmt, impl="cuda", k_blk=8, device=DEVICE)
    t_format = time.time() - t0
    t0 = time.time()
    bplan = ad_plan(fmt, impl="cuda_balanced", k_blk=8, split_blk=1,
                    device=DEVICE)
    t_bplan = time.time() - t0
    blk = plan.fwd
    m = g.num_nodes
    nnzp = blk.vals.shape[0]
    print(f"  Amazon replica, scale {SCALE}: {m} nodes, {fmt.nnz} nonzeros, "
          f"{blk.num_windows} windows, {fmt.nnzv} nonzero vectors, "
          f"{blk.num_blocks} K-blocks, NNZP={nnzp}; graph {t_graph:.1f} s, "
          f"format + plan {t_format:.1f} s, balanced plan {t_bplan:.1f} s "
          "on the host")
    for dirn, bl, sc in (("A", bplan.fwd, bplan.fwd_sched),
                         ("A^T", bplan.bwd, bplan.bwd_sched)):
        per_win = np.diff(bl.win_ptr.cpu().numpy())
        top = np.sort(per_win)[::-1]
        print(f"  {dirn}: {bl.num_blocks} K-blocks, NNZP={bl.vals.shape[0]}, "
              f"blocks per window mean {per_win.mean():.2f}, largest "
              f"{top[:5].tolist()}, the 10 largest windows hold "
              f"{top[:10].sum() / max(per_win.sum(), 1):.3f} of the blocks; "
              f"split_blk=1 schedule: {sc.num_segments} segments, "
              f"{int((per_win > 1).sum())} split windows")
        print_plans(f"{dirn}, split_blk=1", plan_stats(sc, bl.num_windows))
    b = torch.from_numpy(rng.standard_normal((m, 128)).astype(np.float32)).to(DEVICE)
    b32 = torch.from_numpy(rng.standard_normal((m, 32)).astype(np.float32)).to(DEVICE)
    h32 = unit_rows(rng, m, 32).to(DEVICE)
    h128 = unit_rows(rng, m, 128).to(DEVICE)
    v32 = torch.from_numpy(rng.standard_normal((m, 32)).astype(np.float32)).to(DEVICE)
    beta = torch.ones((), device=DEVICE)
    err = {
        "spmm": compare("spmm [Amazon, N=128]", spmm_cuda(blk, b),
                        spmm_plain(blk, b), KERNEL_RTOL, KERNEL_ATOL),
        "sddmm": compare("sddmm [Amazon, F=32]", sddmm_cuda(blk, h32, h32),
                         sddmm_plain(blk, h32, h32), KERNEL_RTOL, KERNEL_ATOL),
        "attention": compare(
            "attention [Amazon, D=DV=32, scale=beta]",
            attention_cuda(blk, h32, h32, v32, scale=beta),
            attention_plain(blk, h32, h32, v32, scale=beta),
            KERNEL_RTOL, KERNEL_ATOL),
    }
    # The balanced kernels on A and A^T.  The run-carried SpMM and
    # attention at split_blk 0 / 1 / 3, with one head (the main path's
    # operands) and two (per-head vals, B, Q and V, shared K), each also
    # against a second launch (same bits).
    rng2 = np.random.default_rng(1)

    def second_head(x, unit=False):
        y = torch.from_numpy(rng2.standard_normal(tuple(x.shape)).astype(
            np.float32)).to(DEVICE)
        if unit:
            y = y / y.norm(dim=-1, keepdim=True).clamp(min=1e-6)
        return torch.stack([x, y])

    b_2, h32_2, v32_2 = second_head(b), second_head(h32, True), second_head(v32)
    for dirn, bl, sc in (("A", bplan.fwd, bplan.fwd_sched),
                         ("A^T", bplan.bwd, bplan.bwd_sched)):
        e_spmm = [compare(f"spmm_balanced [Amazon {dirn}, N={bb.shape[1]}]",
                          spmm_balanced_cuda(bl, bb, schedule=sc),
                          spmm_balanced_plain(bl, bb, sc),
                          KERNEL_RTOL, KERNEL_ATOL) for bb in (b, b32)]
        e_sddmm = [compare(f"sddmm_balanced [Amazon {dirn}, F={hh.shape[1]}]",
                           sddmm_balanced_cuda(bl, hh, hh, schedule=sc),
                           sddmm_balanced_plain(bl, hh, hh, sc),
                           KERNEL_RTOL, KERNEL_ATOL) for hh in (h32, h128)]
        e_attn = compare(
            f"attention_balanced [Amazon {dirn}, D=DV=32, scale=beta]",
            attention_balanced_cuda(bl, h32, h32, v32, scale=beta,
                                    schedule=sc),
            attention_balanced_plain(bl, h32, h32, v32, sc, beta),
            KERNEL_RTOL, KERNEL_ATOL)
        if dirn == "A":
            err.update(spmm_balanced=e_spmm[0], sddmm_balanced=e_sddmm[0],
                       attention_balanced=e_attn)
        vals_2 = torch.stack([bl.vals, bl.vals * torch.from_numpy(
            rng2.uniform(0.5, 1.5, tuple(bl.vals.shape)).astype(
                np.float32)).to(DEVICE)])
        for split in (0, 1, 3):
            sched = bl.schedule(split)
            for h in (1, 2):
                bv = bl if h == 1 else with_values(bl, vals_2)
                bb, qq, vv = (b, h32, v32) if h == 1 else (b_2, h32_2, v32_2)
                tag = f"[Amazon {dirn}, split_blk={split}, H={h}"
                out = spmm_balanced_cuda(bv, bb, schedule=sched)
                bitwise(f"spmm_balanced {tag}, N=128], second launch", out,
                        spmm_balanced_cuda(bv, bb, schedule=sched))
                compare(f"spmm_balanced {tag}, N=128]", out,
                        spmm_balanced_plain(bv, bb, sched), KERNEL_RTOL,
                        KERNEL_ATOL)
                out = attention_balanced_cuda(bl, qq, h32, vv, scale=beta,
                                              schedule=sched)
                bitwise(f"attention_balanced {tag}, D=DV=32], second launch",
                        out, attention_balanced_cuda(bl, qq, h32, vv,
                                                     scale=beta,
                                                     schedule=sched))
                compare(f"attention_balanced {tag}, D=DV=32]", out,
                        attention_balanced_plain(bl, qq, h32, vv, sched, beta),
                        KERNEL_RTOL, KERNEL_ATOL)
    del b_2, h32_2, v32_2, vals_2, out
    # The Fig. 15 baseline keeps spmm.cu's per-output order: same bits.
    bitwise("spmm_noncoalesced [Amazon, N=128] vs spmm",
            spmm_noncoalesced_cuda(blk, b), spmm_cuda(blk, b))
    err["spmm_noncoalesced"] = compare(
        "spmm_noncoalesced [Amazon, N=128]", spmm_noncoalesced_cuda(blk, b),
        spmm_noncoalesced_plain(blk, b), KERNEL_RTOL, KERNEL_ATOL)
    err["spmm_staged"] = compare(
        "spmm_staged [Amazon, N=128]", spmm_staged_cuda(blk, b),
        spmm_staged_plain(blk, b), KERNEL_RTOL, KERNEL_ATOL)
    torch.cuda.synchronize()

    att = attention_setup(rng)
    aplan, abplan = att["plan"], att["bplan"]
    ablk = aplan.fwd
    aq, ak, av, ag = att["q"], att["k"], att["v"], att["g"]
    with torch.no_grad():
        aprobs = sparse_softmax(ablk, sddmm_batched_plain(ablk, aq, ak)
                                * att["scale"])
    aprobs_t = aplan.transpose_vals(aprobs)
    tag = (f"H={ATTN_HEADS}, S={ATTN_SEQ}, D=DV={ATTN_DIM}")
    err["spmm_batched"] = compare(
        f"spmm_batched [attention A, {tag}: probabilities @ V]",
        spmm_batched_cuda(with_values(ablk, aprobs), av),
        spmm_batched_plain(with_values(ablk, aprobs), av), KERNEL_RTOL,
        KERNEL_ATOL)
    # A global key's window of A^T sums up to 16,384 vectors in one fp32
    # running sum (spmm.cu's order, the reference's sequential window
    # accumulation), where the plain version sums blockwise: its rows are
    # held against fp64, the rest against the plain version.
    check_hub_windows(
        f"spmm_batched [attention A^T, {tag}: dV = P^T @ G]", aplan.bwd,
        aprobs_t, ag, spmm_batched_cuda(with_values(aplan.bwd, aprobs_t), ag),
        spmm_batched_plain(with_values(aplan.bwd, aprobs_t), ag))
    # The same dV on the balanced route: runs cut the global keys' windows.
    aprob_t_blk = with_values(aplan.bwd, aprobs_t)
    dv_sched = aplan.bwd.schedule(1)
    dv_out = spmm_balanced_cuda(aprob_t_blk, ag, schedule=dv_sched)
    bitwise(f"spmm_balanced [attention A^T, {tag}: dV, split_blk=1], second "
            "launch", dv_out,
            spmm_balanced_cuda(aprob_t_blk, ag, schedule=dv_sched))
    compare(f"spmm_balanced [attention A^T, {tag}: dV, split_blk=1]", dv_out,
            spmm_balanced_plain(aprob_t_blk, ag, dv_sched), KERNEL_RTOL,
            KERNEL_ATOL)
    print_plans("attention A^T, split_blk=1",
                plan_stats(dv_sched, aplan.bwd.num_windows, n=ATTN_DIM,
                           dv=ATTN_DIM))
    del dv_out
    err["sddmm_batched"] = compare(
        f"sddmm_batched [attention A, {tag}: scores]",
        sddmm_batched_cuda(ablk, aq, ak), sddmm_batched_plain(ablk, aq, ak),
        KERNEL_RTOL, KERNEL_ATOL)
    err["attention_h12"] = compare(
        f"attention [attention A, {tag}, scale 1/sqrt(D)]",
        attention_cuda(ablk, aq, ak, av, scale=att["scale"]),
        attention_plain(ablk, aq, ak, av, att["scale"]), KERNEL_RTOL,
        KERNEL_ATOL)
    torch.cuda.synchronize()

    phase("4. end to end: GCN and AGNN inference on the Amazon replica")
    x_np, labels_np, train_np = make_task(g, seed=0, num_classes=16,
                                          in_dim=128)
    x = torch.from_numpy(x_np).to(DEVICE)
    labels = torch.from_numpy(labels_np).to(DEVICE)
    train_mask = torch.from_numpy(train_np).to(DEVICE)
    cfgs = {
        "gcn": GNNConfig(model="gcn", in_dim=128, hidden_dim=128,
                         num_classes=16, num_layers=5, impl="cuda"),
        "agnn": GNNConfig(model="agnn", in_dim=128, hidden_dim=32,
                          num_classes=16, num_layers=5, impl="cuda"),
    }
    n_layers = cfgs["gcn"].num_layers
    gcn = GCN(cfgs["gcn"], device=DEVICE, seed=0)
    agnn = AGNN(cfgs["agnn"], device=DEVICE, seed=1)
    plain = {k: dataclasses.replace(c, impl="blocked") for k, c in cfgs.items()}
    bal = {k: dataclasses.replace(c, impl="cuda_balanced")
           for k, c in cfgs.items()}
    runs = {
        "gcn_plan": (lambda: gcn(plan, x),
                     lambda: gcn_forward(gcn.params(), plan, x, plain["gcn"]),
                     expect(spmm=n_layers)),
        "agnn_plan": (lambda: agnn(plan, x),
                      lambda: agnn_forward(agnn.params(), plan, x,
                                           plain["agnn"]),
                      expect(attention=n_layers)),
        "agnn_blocked": (lambda: agnn(blk, x),
                         lambda: agnn_forward(agnn.params(), blk, x,
                                              plain["agnn"]),
                         expect(spmm=n_layers, sddmm=n_layers)),
        "gcn_balanced": (lambda: gcn_forward(gcn.params(), bplan, x,
                                             bal["gcn"]),
                         lambda: gcn_forward(gcn.params(), bplan, x,
                                             plain["gcn"]),
                         expect(spmm_balanced=n_layers)),
        "agnn_balanced": (lambda: agnn_forward(agnn.params(), bplan, x,
                                               bal["agnn"]),
                          lambda: agnn_forward(agnn.params(), bplan, x,
                                               plain["agnn"]),
                          expect(attention_balanced=n_layers)),
        # the paper's SpMM ablation baselines on the GCN forward
        "gcn_noncoalesced": (
            lambda: gcn_forward(gcn.params(), blk, x, dataclasses.replace(
                cfgs["gcn"], impl="cuda_noncoalesced")),
            lambda: gcn_forward(gcn.params(), blk, x, plain["gcn"]),
            expect(spmm_noncoalesced=n_layers)),
        "gcn_staged": (
            lambda: gcn_forward(gcn.params(), blk, x, dataclasses.replace(
                cfgs["gcn"], impl="cuda_staged")),
            lambda: gcn_forward(gcn.params(), blk, x, plain["gcn"]),
            expect(spmm_staged=n_layers)),
    }
    launches = {name: 0 for name in wrappers}
    outs = {}
    with torch.inference_mode():
        for name, (run, ref_run, want) in runs.items():
            reset_counts()
            out = run()
            torch.cuda.synchronize()
            got = counts()
            print(f"  {name}: launches {got}")
            if got != want:
                raise SystemExit(f"FAIL {name}: launch counts {got} != {want}")
            for k_name in launches:
                launches[k_name] += got[k_name]
            if out.shape != (m, 16):
                raise SystemExit(f"FAIL {name}: logits shape {tuple(out.shape)}")
            compare(f"{name} logits vs impl=blocked", out, ref_run(),
                    E2E_RTOL, E2E_ATOL)
            outs[name] = out
        compare("agnn over the ADPlan (attention kernel) vs over the bare "
                "format (SDDMM + softmax + SpMM kernels)", outs["agnn_plan"],
                outs["agnn_blocked"], E2E_RTOL, E2E_ATOL)
        for model, params in (("gcn", gcn.params()), ("agnn", agnn.params())):
            loss, acc = gnn_loss(params, plan, x, labels, train_mask,
                                 cfgs[model])
            if not math.isfinite(loss.item()):
                raise SystemExit(f"FAIL {model}: non-finite eval loss")
            print(f"  {model} eval (random weights): loss {loss.item():.4f}, "
                  f"accuracy {acc.item():.4f}")

    phase(f"4b. training: {TRAIN_STEPS} steps of each model and route")
    adjs = {"cuda": plan, "cuda_balanced": bplan}
    nets = {}

    def make(model, impl):
        cfg = dataclasses.replace(cfgs[model], impl=impl)
        net = (GCN if model == "gcn" else AGNN)(cfg, device=DEVICE,
                                                seed=0 if model == "gcn" else 1)
        return net, make_gnn_train_step(cfg, net, lr=TRAIN_LR)

    def train_expect(model, impl):
        # Per step, from the layers and the gradients the step needs: GCN
        # runs one SpMM per layer forward and a transpose SpMM (dB) per
        # layer but the first (the features need no gradient, nor do the
        # adjacency values).  AGNN runs one attention kernel per layer
        # forward; backward, per layer, the score SDDMM and the dProbs
        # SDDMM, and three SpMMs: dV, dQ and dK.
        suffix = "" if impl == "cuda" else "_balanced"
        if model == "gcn":
            return expect(**{"spmm" + suffix: 2 * n_layers - 1})
        return expect(**{"attention" + suffix: n_layers,
                         "sddmm" + suffix: 2 * n_layers,
                         "spmm" + suffix: 3 * n_layers})

    def op_grads(adj, impl, op, inputs):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        out = op(adj, *leaves, impl=impl)
        cot = torch.from_numpy(np.random.default_rng(7).standard_normal(
            tuple(out.shape)).astype(np.float32)).to(DEVICE)
        return torch.autograd.grad(out, leaves, cot)

    ops = {
        "spmm_ad (dVals, dB), N=32": (spmm_ad, (plan.vals, b32)),
        "sddmm_ad (dQ, dK), F=32": (sddmm_ad, (h32, h32)),
        "attention_ad (dQ, dK, dV, dβ), D=DV=32": (
            lambda adj, q, k, v, s, impl: attention_ad(adj, q, k, v, scale=s,
                                                       impl=impl),
            (h32, h32, v32, beta)),
    }
    for label, (op, inputs) in ops.items():
        want = op_grads(plan, "blocked", op, inputs)
        for impl in ("cuda", "cuda_balanced"):
            got = op_grads(adjs[impl], impl, op, inputs)
            for j, (g_, w_) in enumerate(zip(got, want)):
                compare(f"{label} {impl}: gradient {j} vs blocked", g_, w_,
                        GRAD_RTOL,
                        GRAD_ATOL_OF_MAX * w_.abs().max().item())
    del want, got
    torch.cuda.synchronize()

    train = {}
    for model in ("gcn", "agnn"):
        ref_net, ref_step = make(model, "blocked")
        ref_loss, _ = ref_step(plan, x, labels, train_mask)
        ref_grads = [p.grad.clone() for p in ref_net.parameters()]
        del ref_net, ref_step
        for impl in ("cuda", "cuda_balanced"):
            net, step = make(model, impl)
            nets[(model, impl)] = (net, step)
            losses = []
            for i in range(TRAIN_STEPS):
                reset_counts()
                loss, _ = step(adjs[impl], x, labels, train_mask)
                torch.cuda.synchronize()
                got = counts()
                want = train_expect(model, impl)
                if got != want:
                    raise SystemExit(f"FAIL train {model}/{impl} step {i}: "
                                     f"launch counts {got} != {want}")
                for k_name in launches:
                    launches[k_name] += got[k_name]
                losses.append(loss.item())
                if i == 0:
                    compare(f"train {model}/{impl}: step-1 loss vs blocked",
                            loss, ref_loss, GRAD_RTOL, 0.0)
                    tol = GRAD_ATOL_OF_MAX * max(
                        gr.abs().max().item() for gr in ref_grads)
                    for j, (p, want_g) in enumerate(zip(net.parameters(),
                                                        ref_grads)):
                        top = want_g.abs().max().item()
                        note = (", below the floor: held by the op-level "
                                "check" if top < tol else "")
                        compare(f"train {model}/{impl}: step-1 grad of "
                                f"parameter {j} {tuple(p.shape)}, max |grad| "
                                f"{top:.3e}{note}", p.grad, want_g, GRAD_RTOL,
                                tol)
            print(f"  {model}/{impl}: losses {losses}; launches per step "
                  f"{got}")
            if not (all(map(math.isfinite, losses))
                    and all(b_ < a_ for a_, b_ in zip(losses, losses[1:]))):
                raise SystemExit(f"FAIL train {model}/{impl}: losses {losses} "
                                 "are not finite and decreasing")
            train[f"{model}_{impl}"] = {"losses": losses,
                                        "launches_per_step": got}

    phase(f"4c. multi-head sparse attention forward: H={ATTN_HEADS}, "
          f"S={ATTN_SEQ}, D=DV={ATTN_DIM}")
    attn_routes = {   # name: (forward, launches of one forward)
        "cuda": (lambda: sparse_attention(aplan, aq, ak, av),
                 expect(attention=1)),
        "cuda_balanced": (lambda: sparse_attention(abplan, aq, ak, av),
                          expect(attention_balanced=1)),
        "cuda_staged": (lambda: attention(ablk, aq, ak, av,
                                          impl="cuda_staged"),
                        expect(sddmm_batched=1, spmm_batched=1)),
    }

    def attn_blocked():
        return sparse_attention(aplan, aq, ak, av, impl="blocked")

    amask = dense_mask(att["rows"], att["cols"], ATTN_SEQ, DEVICE)
    dense_heads = (0, ATTN_HEADS - 1)
    with torch.inference_mode():
        attn_ref = attn_blocked()
        # the dense oracle, one head at a time (1 GiB of scores per head)
        dense = {h: dense_masked_attention(aq[h], ak[h], av[h], amask)
                 for h in dense_heads}
        for h in dense_heads:
            compare(f"attention blocked head {h} vs dense masked attention",
                    attn_ref[h], dense[h], ATTN_DENSE_TOL, ATTN_DENSE_TOL)
        for name, (run, want) in attn_routes.items():
            reset_counts()
            out = run()
            torch.cuda.synchronize()
            got = counts()
            print(f"  attention forward {name}: launches {got}")
            if got != want:
                raise SystemExit(f"FAIL attention forward {name}: launch "
                                 f"counts {got} != {want}")
            for k_name in launches:
                launches[k_name] += got[k_name]
            compare(f"attention forward {name} vs impl=blocked", out,
                    attn_ref, E2E_RTOL, E2E_ATOL)
            for h in dense_heads:
                compare(f"attention forward {name} head {h} vs dense masked "
                        "attention", out[h], dense[h], ATTN_DENSE_TOL,
                        ATTN_DENSE_TOL)
        del dense, attn_ref
    print(f"  cuda: ONE attention_cuda launch for {ATTN_HEADS} heads")

    phase("4d. multi-head sparse attention training: dout/dQ and "
          f"{TRAIN_STEPS} value-projection SGD steps")
    # (plan, impl, staged layer): the fused routes through
    # sparse_attention, and sparse_attention_staged over the cuda plan.
    attn_train = {"cuda": (aplan, "cuda", False),
                  "cuda_balanced": (abplan, "cuda_balanced", False),
                  "staged_cuda": (aplan, "cuda", True)}

    def attn_counts(route, what):
        # Launches of a forward ("fwd"), or of a forward and the backward
        # for dQ ("dq") or for dV ("dv", the value projection), from the
        # autograd Functions and the gradients needed.  Fused routes:
        # forward one attention kernel; backward the recomputed scores
        # (SDDMM), then for dQ the dProbs SDDMM and the dQ SpMM, for dV the
        # dV SpMM on A^T.  Staged layer: forward the scores SDDMM and the
        # P @ V SpMM; backward for dQ the dProbs SDDMM and the dQ SpMM, for
        # dV the dV SpMM.  Each is one launch for all heads.
        batched = route != "cuda_balanced"
        sd, sp = (("sddmm_batched", "spmm_batched") if batched
                  else ("sddmm_balanced", "spmm_balanced"))
        if route == "staged_cuda":
            fwd = {sd: 1, sp: 1}
            bwd = {sd: 1, sp: 1} if what == "dq" else {sp: 1}
        else:
            fwd = {"attention" if batched else "attention_balanced": 1}
            bwd = {sd: 2, sp: 1} if what == "dq" else {sd: 1, sp: 1}
        if what == "fwd":
            bwd = {}
        return {k_: fwd.get(k_, 0) + bwd.get(k_, 0) for k_ in wrappers}

    def attn_dq(plan_, impl, staged):
        layer = sparse_attention_staged if staged else sparse_attention
        leaf = aq.detach().clone().requires_grad_(True)
        (dq,) = torch.autograd.grad(layer(plan_, leaf, ak, av,
                                          impl=impl).sum(), leaf)
        return dq

    dq_ref = attn_dq(aplan, "blocked", False)
    vp_ref = train_value_projection(aplan, aq, ak, av, "blocked", steps=1,
                                    lr=ATTN_LR)
    attn_result = {}
    for name, (plan_, impl, staged) in attn_train.items():
        reset_counts()
        dq = attn_dq(plan_, impl, staged)
        torch.cuda.synchronize()
        got, want = counts(), attn_counts(name, "dq")
        if got != want:
            raise SystemExit(f"FAIL attention dQ {name}: launch counts "
                             f"{got} != {want}")
        for k_name in launches:
            launches[k_name] += got[k_name]
        compare(f"attention dout/dQ {name} vs impl=blocked", dq, dq_ref,
                ATTN_DQ_TOL, ATTN_DQ_TOL)
        reset_counts()
        run = train_value_projection(plan_, aq, ak, av, impl,
                                     steps=TRAIN_STEPS, lr=ATTN_LR,
                                     staged=staged)
        torch.cuda.synchronize()
        got = counts()
        # the target and the final loss are one forward each
        fwd, step = attn_counts(name, "fwd"), attn_counts(name, "dv")
        want = {k_: 2 * fwd[k_] + TRAIN_STEPS * step[k_] for k_ in wrappers}
        if got != want:
            raise SystemExit(f"FAIL attention value projection {name}: "
                             f"launch counts {got} != {want}")
        for k_name in launches:
            launches[k_name] += got[k_name]
        losses = run.losses + [run.final]
        print(f"  value projection {name}: losses {losses}; launches "
              f"{got} (target + {TRAIN_STEPS} steps + final loss)")
        if not (all(map(math.isfinite, losses))
                and all(b_ < a_ for a_, b_ in zip(losses, losses[1:]))):
            raise SystemExit(f"FAIL value projection {name}: losses "
                             f"{losses} are not finite and decreasing")
        compare(f"value projection {name}: step-1 loss vs blocked",
                torch.tensor(run.losses[0]), torch.tensor(vp_ref.losses[0]),
                GRAD_RTOL, 0.0)
        compare(f"value projection {name}: step-1 dloss/dW vs blocked",
                run.first_grad, vp_ref.first_grad, GRAD_RTOL,
                GRAD_ATOL_OF_MAX * vp_ref.first_grad.abs().max().item())
        attn_result[name] = {"losses": losses, "launches": got,
                             "launches_per_step": step}
    del dq, dq_ref

    phase("5. timing (CUDA events around back-to-back calls, median of runs)")
    csr = torch.sparse_coo_tensor(
        torch.from_numpy(np.stack([g.rows, g.cols])),
        torch.from_numpy(g.vals), (m, m)).coalesce().to_sparse_csr().to(DEVICE)
    pattern = torch.sparse_csr_tensor(csr.crow_indices(), csr.col_indices(),
                                      torch.ones_like(csr.values()), (m, m))
    bblk, bsched = bplan.fwd, bplan.fwd_sched
    # Library yardsticks of the attention kernels: the probabilities as a
    # (H, S, S) sparse COO tensor for torch.bmm, the pattern as a batched
    # CSR tensor for sampled_addmm, the dense mask for
    # scaled_dot_product_attention.
    aprob_blk = with_values(ablk, aprobs)
    t_idx, r_idx = torch.nonzero(ablk.mask, as_tuple=True)
    a_rows = (ablk.block_win.long()[t_idx // ablk.k_blk]
              * ablk.vector_size + r_idx)
    a_cols = ablk.cols.long()[t_idx]
    heads_idx = torch.arange(ATTN_HEADS, device=DEVICE).repeat_interleave(
        a_rows.shape[0])
    aprob_coo = torch.sparse_coo_tensor(
        torch.stack([heads_idx, a_rows.repeat(ATTN_HEADS),
                     a_cols.repeat(ATTN_HEADS)]),
        aprobs[:, t_idx, r_idx].reshape(-1),
        (ATTN_HEADS, ATTN_SEQ, ATTN_SEQ)).coalesce()
    pat = torch.sparse_coo_tensor(torch.stack([a_rows, a_cols]),
                                  torch.ones_like(a_rows, dtype=torch.float32),
                                  (ATTN_SEQ, ATTN_SEQ)).coalesce().to_sparse_csr()
    apattern = torch.sparse_csr_tensor(
        pat.crow_indices().repeat(ATTN_HEADS, 1),
        pat.col_indices().repeat(ATTN_HEADS, 1),
        pat.values().repeat(ATTN_HEADS, 1),
        (ATTN_HEADS, ATTN_SEQ, ATTN_SEQ))
    del t_idx, r_idx, heads_idx, pat
    e2e = {}
    with torch.inference_mode():
        timed = {
            "spmm": (lambda: spmm_cuda(blk, b), lambda: spmm_plain(blk, b),
                     lambda: torch.sparse.mm(csr, b)),
            "sddmm": (lambda: sddmm_cuda(blk, h32, h32),
                      lambda: sddmm_plain(blk, h32, h32),
                      lambda: torch.sparse.sampled_addmm(pattern, h32, h32.T,
                                                         beta=0.0)),
            "attention": (lambda: attention_cuda(blk, h32, h32, v32, scale=beta),
                          lambda: attention_plain(blk, h32, h32, v32, scale=beta),
                          None),
            "spmm_balanced": (
                lambda: spmm_balanced_cuda(bblk, b, schedule=bsched),
                lambda: spmm_balanced_plain(bblk, b, bsched),
                lambda: torch.sparse.mm(csr, b)),
            "sddmm_balanced": (
                lambda: sddmm_balanced_cuda(bblk, h32, h32, schedule=bsched),
                lambda: sddmm_balanced_plain(bblk, h32, h32, bsched),
                lambda: torch.sparse.sampled_addmm(pattern, h32, h32.T,
                                                   beta=0.0)),
            "attention_balanced": (
                lambda: attention_balanced_cuda(bblk, h32, h32, v32,
                                                scale=beta, schedule=bsched),
                lambda: attention_balanced_plain(bblk, h32, h32, v32, bsched,
                                                 beta),
                None),
            "spmm_noncoalesced": (lambda: spmm_noncoalesced_cuda(blk, b),
                                  lambda: spmm_noncoalesced_plain(blk, b),
                                  lambda: torch.sparse.mm(csr, b)),
            "spmm_staged": (lambda: spmm_staged_cuda(blk, b),
                            lambda: spmm_staged_plain(blk, b),
                            lambda: torch.sparse.mm(csr, b)),
            "spmm_batched": (lambda: spmm_batched_cuda(aprob_blk, av),
                             lambda: spmm_batched_plain(aprob_blk, av),
                             lambda: torch.bmm(aprob_coo, av)),
            "sddmm_batched": (
                lambda: sddmm_batched_cuda(ablk, aq, ak),
                lambda: sddmm_batched_plain(ablk, aq, ak),
                lambda: torch.sparse.sampled_addmm(apattern, aq,
                                                   ak.transpose(1, 2),
                                                   beta=0.0)),
            "attention_h12": (
                lambda: attention_cuda(ablk, aq, ak, av, scale=att["scale"]),
                lambda: attention_plain(ablk, aq, ak, av, att["scale"]),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    aq[None], ak[None], av[None], attn_mask=amask,
                    scale=att["scale"])),
        }
        ms = {}
        for name, (kern, plain_fn, lib_fn) in timed.items():
            ms[name] = (cuda_ms(kern), cuda_ms(plain_fn, reps=3, batch=3),
                        None if lib_fn is None else cuda_ms(lib_fn))
            print(f"  {name}: kernel {ms[name][0]:.4f} ms, plain "
                  f"{ms[name][1]:.4f} ms, library {ms[name][2]} ms")
        # The transpose SpMM (dB, dK) on Aᵀ, whose hub columns of A are
        # hub windows, window-parallel against block-parallel.
        for n_cols, bb in ((128, b), (32, b32)):
            t_win = cuda_ms(lambda: spmm_cuda(plan.bwd, bb))
            t_bal = cuda_ms(lambda: spmm_balanced_cuda(
                bplan.bwd, bb, schedule=bplan.bwd_sched))
            print(f"  transpose SpMM on A^T, N={n_cols}: window-parallel "
                  f"{t_win:.4f} ms, balanced (split_blk=1) {t_bal:.4f} ms")
            e2e[f"spmm_transpose_n{n_cols}"] = {"cuda_ms": t_win,
                                                "balanced_ms": t_bal}
        # The attention backward's dV = P^T @ G on A^T, whose global-key
        # windows hold up to 2,048 K-blocks: head grid against balanced.
        t_win = cuda_ms(lambda: spmm_batched_cuda(aprob_t_blk, ag))
        t_bal = {split: cuda_ms(lambda: spmm_balanced_cuda(
            aprob_t_blk, ag, schedule=aplan.bwd.schedule(split)))
            for split in (0, 1, 8, 32)}
        dv_bound = bound(
            read_once(aprobs_t, aplan.bwd.cols, aplan.bwd.win_ptr, ag)
            + ag.numel() * 4,
            2 * ATTN_HEADS * int(aplan.bwd.mask.sum()) * ATTN_DIM)
        print(f"  attention dV on A^T, H={ATTN_HEADS}, N={ATTN_DIM}: head "
              f"grid {t_win:.4f} ms, balanced " + ", ".join(
                  f"split_blk={k_} {v_:.4f} ms" for k_, v_ in t_bal.items())
              + f"; bound {dv_bound[0]:.4f} ms ({dv_bound[1]})")
        e2e["attention_dv_transpose"] = {"cuda_batched_ms": t_win,
                                         "balanced_ms": t_bal,
                                         "bound_ms": dv_bound[0]}
        sweep = {}
        for split in (0, 1, 8, 32):
            fs, ts = bblk.schedule(split), bplan.bwd.schedule(split)
            sweep[split] = {
                "spmm_A_n128": cuda_ms(lambda: spmm_balanced_cuda(
                    bblk, b, schedule=fs)),
                "spmm_At_n128": cuda_ms(lambda: spmm_balanced_cuda(
                    bplan.bwd, b, schedule=ts)),
                "sddmm_A_f32": cuda_ms(lambda: sddmm_balanced_cuda(
                    bblk, h32, h32, schedule=fs)),
                "attention_A_d32": cuda_ms(lambda: attention_balanced_cuda(
                    bblk, h32, h32, v32, scale=beta, schedule=fs)),
                "attention_At_d32": cuda_ms(lambda: attention_balanced_cuda(
                    bplan.bwd, h32, h32, v32, scale=beta, schedule=ts)),
                "plans_A": plan_stats(fs, bblk.num_windows),
                "plans_At": plan_stats(ts, bplan.bwd.num_windows),
            }
            print(f"  split_blk={split}: " + ", ".join(
                f"{k_} {v_:.4f} ms" for k_, v_ in sweep[split].items()
                if isinstance(v_, float)))
            print_plans(f"    A, split_blk={split}", sweep[split]["plans_A"])
            print_plans(f"    A^T, split_blk={split}", sweep[split]["plans_At"])
        # The run length of the run-carried kernels at split_blk = 1: SpMM
        # on A and A^T (N = 128) and the attention dV, attention on A and
        # A^T (D = DV = 32) and the 12-head attention forward.
        run_sweep = {}
        at_sched = bplan.bwd_sched
        for r_blk in (8, 16, 32, 64):
            run_sweep[f"spmm_run_blk_{r_blk}"] = {
                "A_n128": cuda_ms(lambda: spmm_balanced_cuda(
                    bblk, b, schedule=bsched, run_blk=r_blk)),
                "At_n128": cuda_ms(lambda: spmm_balanced_cuda(
                    bplan.bwd, b, schedule=at_sched, run_blk=r_blk)),
                "attention_dV_h12": cuda_ms(lambda: spmm_balanced_cuda(
                    aprob_t_blk, ag, schedule=dv_sched, run_blk=r_blk)),
                "entries_A": run_plan("chip_smoke", bsched, bblk.num_windows,
                                      r_blk).entries,
                "entries_At": run_plan("chip_smoke", at_sched,
                                       bplan.bwd.num_windows, r_blk).entries,
            }
        for r_blk in (2, 4, 8, 16, 32):
            run_sweep[f"attention_run_blk_{r_blk}"] = {
                "A_d32": cuda_ms(lambda: attention_balanced_cuda(
                    bblk, h32, h32, v32, scale=beta, schedule=bsched,
                    run_blk=r_blk)),
                "At_d32": cuda_ms(lambda: attention_balanced_cuda(
                    bplan.bwd, h32, h32, v32, scale=beta, schedule=at_sched,
                    run_blk=r_blk)),
                "attention_h12": cuda_ms(lambda: attention_balanced_cuda(
                    abplan.fwd, aq, ak, av, scale=att["scale"],
                    schedule=abplan.fwd_sched, run_blk=r_blk)),
                "entries_A": run_plan("chip_smoke", bsched, bblk.num_windows,
                                      r_blk).entries,
                "entries_At": run_plan("chip_smoke", at_sched,
                                       bplan.bwd.num_windows, r_blk).entries,
            }
        for key, row in run_sweep.items():
            print(f"  {key}: " + ", ".join(
                f"{k_} {v_:.4f} ms" if isinstance(v_, float) else f"{k_} {v_}"
                for k_, v_ in row.items()))
        for name, (run, ref_run, _) in runs.items():
            torch.cuda.reset_peak_memory_stats()
            t_kernel = cuda_ms(run, batch=2, warmup=1)
            peak = torch.cuda.max_memory_allocated()
            t_plain = cuda_ms(ref_run, reps=3, batch=1, warmup=1)
            e2e[name] = {"ms": t_kernel, "plain_ms": t_plain,
                         "peak_bytes": peak}
            print(f"  {name} forward: {t_kernel:.3f} ms (impl=blocked "
                  f"{t_plain:.3f} ms), peak memory {peak / 2**30:.3f} GiB")
    for (model, impl), (net, step) in nets.items():
        torch.cuda.reset_peak_memory_stats()
        t_step = cuda_ms(lambda: step(adjs[impl], x, labels, train_mask),
                         reps=3, batch=2, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        train[f"{model}_{impl}"].update(step_ms=t_step, peak_bytes=peak)
        print(f"  train step {model}/{impl}: {t_step:.3f} ms, peak memory "
              f"{peak / 2**30:.3f} GiB")

    # Multi-head attention: a forward of each route, and one
    # value-projection SGD step (loss, dloss/dW, update) of each.
    with torch.no_grad():
        vp_target = attn_blocked()
    vp_w = torch.from_numpy(initial_w(ATTN_DIM)).to(DEVICE)

    def vp_step(plan_, impl, staged):
        w_leaf = vp_w.detach().requires_grad_(True)
        loss = value_projection_loss(plan_, aq, ak, av, w_leaf, vp_target,
                                     impl=impl, staged=staged)
        (gw,) = torch.autograd.grad(loss, w_leaf)
        return (w_leaf - ATTN_LR * gw).detach()

    attn_fwd = dict(attn_routes, blocked=(attn_blocked, None))
    for name, (run, _) in attn_fwd.items():
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            t_fwd = cuda_ms(run, reps=3, batch=2, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        e2e[f"attention_{name}"] = {"ms": t_fwd, "peak_bytes": peak}
        print(f"  attention forward {name}: {t_fwd:.3f} ms, peak memory "
              f"{peak / 2**30:.3f} GiB")
    attn_steps = dict(attn_train, blocked=(aplan, "blocked", False))
    for name, (plan_, impl, staged) in attn_steps.items():
        torch.cuda.reset_peak_memory_stats()
        t_step = cuda_ms(lambda: vp_step(plan_, impl, staged), reps=3,
                         batch=2, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        attn_result.setdefault(name, {}).update(step_ms=t_step,
                                                peak_bytes=peak)
        print(f"  attention value-projection step {name}: {t_step:.3f} ms, "
              f"peak memory {peak / 2**30:.3f} GiB")

    phase("6. where the time goes (torch.profiler, one forward or step each)")
    with torch.inference_mode():
        for name, (run, _, _) in runs.items():
            print(f"  {name} forward:")
            e2e[name].update(profile_run(run))
    for (model, impl), (net, step) in nets.items():
        print(f"  train step {model}/{impl}:")
        train[f"{model}_{impl}"].update(profile_run(
            lambda: step(adjs[impl], x, labels, train_mask)))
    for name, (run, _) in attn_fwd.items():
        print(f"  attention forward {name}:")
        with torch.inference_mode():
            e2e[f"attention_{name}"].update(profile_run(run))
    for name, (plan_, impl, staged) in attn_steps.items():
        print(f"  attention value-projection step {name}:")
        attn_result[name].update(profile_run(
            lambda: vp_step(plan_, impl, staged)))

    v = blk.vector_size
    # Each distinct input read once (the main path passes Q and K as one
    # tensor, AGNN's q = k = ĥ, counted once), the output written once, and
    # for the balanced kernels the schedule arrays they read (the run plan
    # of the run-carried SpMM and attention); never the balanced kernels'
    # own scratch partials.
    bal_plans = {name: run_plan("chip_smoke", bsched, bblk.num_windows, r_)
                 for name, r_ in (("spmm_balanced", SPMM_RUN),
                                  ("attention_balanced", ATTN_RUN))}
    plan_arrays = {name: (pl.run_ptr, pl.pieces)
                   for name, pl in bal_plans.items()}
    nbytes = {
        "spmm": read_once(blk.vals, blk.cols, blk.win_ptr, b) + m * 128 * 4,
        "sddmm": (read_once(h32, h32, blk.mask, blk.cols, blk.block_win)
                  + nnzp * v * 4),
        "attention": (read_once(h32, h32, v32, beta, blk.mask, blk.cols,
                                blk.win_ptr)
                      + m * 32 * 4),
        "spmm_balanced": (read_once(bblk.vals, bblk.cols, b,
                                    *plan_arrays["spmm_balanced"])
                          + m * 128 * 4),
        "sddmm_balanced": (read_once(h32, h32, bblk.mask, bblk.cols,
                                     bsched.blk_id, bsched.blk_win)
                           + nnzp * v * 4),
        "attention_balanced": (read_once(h32, h32, v32, beta, bblk.mask,
                                         bblk.cols,
                                         *plan_arrays["attention_balanced"])
                               + m * 32 * 4),
        # the two SpMM baselines compute row 1's function on its inputs
        # (the staged gather is the design's own traffic)
        "spmm_noncoalesced": (read_once(blk.vals, blk.cols, blk.win_ptr, b)
                              + m * 128 * 4),
        "spmm_staged": (read_once(blk.vals, blk.cols, blk.block_win, b)
                        + m * 128 * 4),
        # the attention configuration, H = 12: probabilities @ V, the
        # scores, the fused attention
        "spmm_batched": (read_once(aprobs, ablk.cols, ablk.win_ptr, av)
                         + av.numel() * 4),
        "sddmm_batched": (read_once(aq, ak, ablk.mask, ablk.cols,
                                    ablk.block_win) + aprobs.numel() * 4),
        "attention_h12": (read_once(aq, ak, av, ablk.mask, ablk.cols,
                                    ablk.win_ptr) + av.numel() * 4),
    }
    # Operations on the true nonzeros only: the padded and masked-off
    # slots of a block are the format's, not the function's.
    annzp, hd = ablk.vals.shape[0], ATTN_HEADS * ATTN_DIM
    nnz, annz = int(blk.mask.sum()), int(ablk.mask.sum())
    flops = {"spmm": 2 * nnz * 128, "sddmm": 2 * nnz * 32,
             "attention": 2 * nnz * (32 + 32),
             "spmm_batched": 2 * annz * hd,
             "sddmm_batched": 2 * annz * hd,
             "attention_h12": 2 * annz * 2 * hd}
    for name in ("spmm", "sddmm", "attention"):
        flops[f"{name}_balanced"] = flops[name]
    for name in ("spmm_noncoalesced", "spmm_staged"):
        flops[name] = flops["spmm"]
    shapes = {
        "spmm": {"M": m, "K": m, "N": 128, "NNZP": nnzp, "nnz": nnz, "V": v,
                 "k_blk": 8},
        "sddmm": {"M": m, "F": 32, "NNZP": nnzp, "nnz": nnz, "V": v,
                  "k_blk": 8},
        "attention": {"M": m, "D": 32, "DV": 32, "NNZP": nnzp, "nnz": nnz,
                      "V": v, "k_blk": 8},
        "spmm_batched": {"H": ATTN_HEADS, "M": ATTN_SEQ, "K": ATTN_SEQ,
                         "N": ATTN_DIM, "NNZP": annzp, "nnz": annz, "V": v,
                         "k_blk": 8, "per_head": "vals, B"},
        "sddmm_batched": {"H": ATTN_HEADS, "M": ATTN_SEQ, "F": ATTN_DIM,
                          "NNZP": annzp, "nnz": annz, "V": v, "k_blk": 8,
                          "per_head": "Q, K"},
        "attention_h12": {"H": ATTN_HEADS, "M": ATTN_SEQ, "D": ATTN_DIM,
                          "DV": ATTN_DIM, "NNZP": annzp, "nnz": annz, "V": v,
                          "k_blk": 8, "per_head": "Q, K, V"},
    }
    for name in ("spmm", "sddmm", "attention"):
        shapes[f"{name}_balanced"] = dict(
            shapes[name], split_blk=1, segments=bsched.num_segments)
    for name, pl in bal_plans.items():
        shapes[name].update(run_blk=pl.run_blk, runs=pl.num_runs,
                            edge_entries=pl.entries)
    for name in ("spmm_noncoalesced", "spmm_staged"):
        shapes[name] = shapes["spmm"]

    def measured(name):
        b_ms, b_by = bound(nbytes[name], flops[name])
        kernel_ms, plain_ms, library_ms = ms[name]
        return {"shape": shapes[name], "max_abs_err": err[name],
                "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
                "bytes": nbytes[name], "flops": flops[name]}

    rows = []
    for name, (route, impl, source, replaces) in KERNELS.items():
        # "route" is the kind of kernel (hand-written CUDA C++); "impl" the
        # registry impl whose path launches it.
        row = {"name": name, "route": route, "impl": impl, "source": source,
               "replaces": replaces, "tpu_kernel": replaces,
               "launches": launches[name], **measured(name)}
        if name == "attention":
            # the fused kernel on the multi-head attention path, beside its
            # one-head (AGNN) numbers above
            row["h12"] = measured("attention_h12")
        rows.append(row)
    for name, n_launch in launches.items():
        if n_launch == 0:
            raise SystemExit(f"FAIL: the {name} kernel never ran on the main path")

    print(json.dumps({"end_to_end": e2e, "training": train,
                      "sparse_attention": attn_result,
                      "split_blk_sweep": sweep, "run_blk_sweep": run_sweep,
                      "card": card,
                      "seconds": round(time.time() - t_start, 1)}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

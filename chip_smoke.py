#!/usr/bin/env python3
"""Drive the PyTorch port of FlashSparse on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root, one card

It imports only ``repro_torch`` (from ``src/``), never JAX, and fails with
a non-zero exit at the first phase that fails:

  1. the card: name and power limit (``nvidia-smi``);
  2. build: ``nvcc`` compiles ``src/repro_torch/kernels/csrc/*.cu`` for
     sm_90a, one process per source, all started together; ``-Xptxas
     -v``'s register, shared-memory and spill lines;
  3. each kernel against its plain PyTorch version on the card (the bf16
     and int8 variants of every SpMM but the two baselines and the bf16
     ones of every SDDMM and attention within one bf16 ulp, at least 99%
     of the entries bitwise equal, on the edge cases and on the Amazon
     replica's A and Aᵀ at N = 128 and 32, hub rows of Aᵀ against fp64;
     the head grids at H in {1, 2, 12} bitwise H one-head launches, the
     balanced ones bitwise the fp32 kernel on the widened operands,
     rounded once, at split_blk in {0, 1, 3}): (a) on
     edge cases, the balanced kernels over schedules split at
     split_blk in {0, 1, 3} with one and two heads, shared and per-head
     operands, and the all-empty matrix (no balanced SDDMM launch), the
     run-carried SpMM and attention also against a second launch (same
     bits); the window-parallel SpMM and the fused attention each against
     a second launch (same bits); the
     head-grid SpMM and SDDMM and the fused attention at H in {1, 2, 4}
     with every mix of shared and per-head operands, each bitwise-equal
     to H one-head launches; the non-coalesced SpMM bitwise-equal to the
     SpMM on the rows of the windows the SpMM does not split; the staged
     SpMM; (b) at the main paths' shapes: on the Amazon replica, the
     window-parallel SpMM on A and on its transpose (N = 128 and 32; the
     rows of hub windows against fp64), each with its window plan, the
     balanced kernels over the schedules of A and of its
     transpose (the run-carried SpMM and attention at split_blk in
     {0, 1, 3} and H in {1, 2}, each also against a second launch), and
     the two SpMM baselines at N = 128; on the attention pattern (12 heads,
     16,384 tokens, head dim 64), the head-grid SpMM on A and on its
     transpose, the balanced SpMM on its transpose (dV), the head-grid
     SDDMM and the fused attention; (c) the SDDMM tile that rows 6, 7 and
     8 share: on every edge case at its F and at F = 720 and 1,500, fp32
     and bf16, one head and three, and at the main paths' shapes, the
     window, head-grid and balanced SDDMMs the same bits per sampled row,
     the same bits on a second launch, and bf16 bitwise the fp32 kernel on
     widened operands, rounded;
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
     4e. the precision axis: three train steps of GCN and AGNN on ``cuda``
     and ``cuda_balanced`` in bf16 end to end and of GCN under an int8
     plan on fp32 masters, the first loss and every gradient against the
     ``blocked`` route's step at the same precision and the loss against
     the fp32 step, a finite falling loss, and the launch counters of
     each variant against the derived counts; and the int8-plan GCN
     forward over two feature sets at once (the head-grid SpMM with the
     quantized values shared by both);
     4f. the fused attention over value bands (DV 129 and 256, one launch
     a band) and past its shared memory (D = 720 fp32, through the SDDMM
     and SpMM kernels) on the Amazon replica, against its plain version;
     4g. multi-head sparse attention under bf16 plans at the widths of
     4c: the forward on ``cuda``, ``cuda_balanced`` and through
     ``sparse_attention_staged`` on the ``cuda`` plan against dense masked
     attention on the bf16 operands (the bf16 ladder), dout/dQ against
     ``blocked`` at bf16, three value-projection steps on each with a
     falling loss, and the launch counters of each variant;
  5. timing with CUDA events: each kernel, its plain version and one
     PyTorch library call computing the same function (a yardstick the port
     never calls), the window-parallel SpMM also on the transposes (the
     Amazon replica's at N = 128 and 32, the attention pattern's dV), the
     balanced kernels at split_blk in {0, 1, 8, 32} with
     each run plan's runs, edge entries and partial bytes, the run length
     of the run-carried SpMM and attention swept at split_blk = 1, the
     SDDMM on the Amazon replica with its K gathers folded into cache and
     a device copy of its bound's bytes (what holds it off the bound), each
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
# bf16 outputs: kernel and plain version sum in fp32 and round once, so
# every entry is within one bf16 ulp (plus 1e-6 of the largest entry) and
# at least 99% of the entries are bitwise equal.
ULP_RTOL, ULP_ATOL_OF_MAX, BITWISE_SHARE = 2.0 ** -7, 1e-6, 0.99
# The first train step's loss at bf16 or under an int8 plan: against the
# blocked route at the same precision, and against the fp32 cuda step.
NARROW_LOSS_RTOL, NARROW_VS_FP32_RTOL = 1e-2, 2e-2
# Its gradients against the blocked route's at the same precision: the two
# routes round the same fp32 sums, taken in another order, to bf16 at each
# of five layers, so an entry may move by a few bf16 ulps of the model's
# largest gradient entry (an SpMM that returned zeros moves them by all).
NARROW_GRAD_ULPS = 4
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
# H100 SXM data sheet: device memory rate, fp32 rate outside the tensor
# cores, the dense TF32 tensor-core rate (the fused attention's fp32
# products, three TF32 products per multiply in its 3xTF32 split), and
# the dense bf16 tensor-core rate (the bound of every bf16 and int8
# variant: their products take bf16 operands, or int8 values with bf16
# B, whatever unit the kernel multiplies them on).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12
TF32_PRODUCTS = 3

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
    # the precision variants of rows 1, 6 and 9 (the reference's bf16
    # paths, and its int8 `quantized` SpMM, spmm_pallas.py:150)
    "spmm_bf16": ("cuda", "cuda", "src/repro_torch/kernels/csrc/spmm.cu",
                  "src/repro/kernels/spmm_pallas.py:110"),
    "spmm_int8": ("cuda", "cuda", "src/repro_torch/kernels/csrc/spmm.cu",
                  "src/repro/kernels/spmm_pallas.py:110"),
    "sddmm_bf16": ("cuda", "cuda", "src/repro_torch/kernels/csrc/sddmm.cu",
                   "src/repro/kernels/sddmm_pallas.py:49"),
    "attention_bf16": ("cuda", "cuda",
                       "src/repro_torch/kernels/csrc/attention.cu",
                       "src/repro/kernels/attention_pallas.py:58"),
    # and of rows 3, 4, 7, 8 and 10 (row 9 at H = 12 is attention_bf16's
    # "h12" entry)
    "spmm_batched_bf16": ("cuda", "cuda_batched",
                          "src/repro_torch/kernels/csrc/spmm_batched.cu",
                          "src/repro/kernels/spmm_pallas.py:294"),
    "spmm_batched_int8": ("cuda", "cuda_batched",
                          "src/repro_torch/kernels/csrc/spmm_batched.cu",
                          "src/repro/kernels/spmm_pallas.py:294"),
    "sddmm_batched_bf16": ("cuda", "cuda_batched",
                           "src/repro_torch/kernels/csrc/sddmm_batched.cu",
                           "src/repro/kernels/sddmm_pallas.py:171"),
    "spmm_balanced_bf16": ("cuda", "cuda_balanced",
                           "src/repro_torch/kernels/csrc/spmm_balanced.cu",
                           "src/repro/kernels/spmm_pallas.py:453"),
    "spmm_balanced_int8": ("cuda", "cuda_balanced",
                           "src/repro_torch/kernels/csrc/spmm_balanced.cu",
                           "src/repro/kernels/spmm_pallas.py:453"),
    "sddmm_balanced_bf16": ("cuda", "cuda_balanced",
                            "src/repro_torch/kernels/csrc/sddmm_balanced.cu",
                            "src/repro/kernels/sddmm_pallas.py:313"),
    "attention_balanced_bf16": (
        "cuda", "cuda_balanced",
        "src/repro_torch/kernels/csrc/attention_balanced.cu",
        "src/repro/kernels/attention_pallas.py:241"),
}
# The launch counter of each entry: the wrapper, and for the wrappers with
# precision variants the variant's count.
VARIANT_OF = {name: ("int8" if name.endswith("_int8") else
                     "bf16" if name.endswith("_bf16") else "fp32")
              for name in KERNELS
              if name not in ("spmm_noncoalesced", "spmm_staged")}


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


def bound(nbytes: int, flops: int,
          flops_per_s: float = FP32_FLOPS_PER_S) -> tuple:
    """Least time (ms) the card could take, and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
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


def window_stats(label: str, blocked, n: int) -> dict:
    """Print and return the window plan of the window-parallel SpMM over
    ``blocked`` at N = n: windows split (long over a cluster, medium over a
    block), their slices, the block shape and the cluster size."""
    from repro_torch.kernels._window import SPLIT_BLK, window_plan

    n_tile = min(128, max(32, -(-n // 32) * 32))
    plan = window_plan("chip_smoke", blocked.win_ptr, SPLIT_BLK, n_tile)
    per_win = np.diff(blocked.win_ptr.cpu().numpy())
    split = per_win > SPLIT_BLK
    slices = int(-(-per_win[split] // SPLIT_BLK).sum())
    st = {"split_blk": SPLIT_BLK, "n_tile": n_tile, "groups": plan.groups,
          "cluster": plan.cluster, "long_windows": plan.num_long,
          "medium_windows": plan.num_medium, "slices": slices,
          "split_blocks": int(per_win[split].sum()),
          "blocks": int(per_win.sum()), "tasks": plan.num_tasks}
    print(f"  {label}, window plan at N={n} (split_blk={SPLIT_BLK}): "
          f"{plan.num_long} long windows over clusters of {plan.cluster} "
          f"blocks, {plan.num_medium} medium over one block, {slices} slices "
          f"holding {st['split_blocks']} of {st['blocks']} K-blocks; blocks "
          f"of {plan.groups} x {n_tile} threads, {plan.num_tasks} tasks",
          flush=True)
    return st


def unsplit_rows(blocked):
    """Rows of the windows the window-parallel SpMM walks unsplit (at most
    SPLIT_BLK K-blocks): there it keeps one running sum per output."""
    import torch

    from repro_torch.kernels._window import SPLIT_BLK

    per_win = torch.diff(blocked.win_ptr.long())
    return (per_win <= SPLIT_BLK).repeat_interleave(
        blocked.vector_size)[:blocked.shape[0]]


def check_noncoalesced(label: str, blocked, out, ref, plain) -> None:
    """The Fig. 15 baseline keeps the window-parallel SpMM's per-output
    order on every window that SpMM walks unsplit: same bits there.  The
    rows of split windows (summed by slices in the SpMM) are held, for
    both, to the plain version at the kernel tolerance."""
    rows = unsplit_rows(blocked)
    bitwise(f"{label}, rows of unsplit windows", out[rows], ref[rows])
    if bool((~rows).any()):
        compare(f"{label}, rows of split windows: spmm_noncoalesced vs "
                "plain", out[~rows], plain[~rows], KERNEL_RTOL, KERNEL_ATOL,
                show=False)
        compare(f"{label}, rows of split windows: spmm vs plain", ref[~rows],
                plain[~rows], KERNEL_RTOL, KERNEL_ATOL, show=False)


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
        # The window-parallel SpMM (windows of more than SPLIT_BLK K-blocks
        # split over the groups of a block) and the fused attention: the
        # same bits on a second launch.
        out = spmm_cuda(blocked, b)
        bitwise(f"spmm [{label}], second launch", out, spmm_cuda(blocked, b))
        compare(f"spmm [{label}]", out, spmm_plain(blocked, b), KERNEL_RTOL,
                KERNEL_ATOL)
        compare(f"sddmm [{label}, F={f}]", sddmm_cuda(blocked, q, kk),
                sddmm_plain(blocked, q, kk), KERNEL_RTOL, KERNEL_ATOL)
        out = attention_cuda(blocked, q, kk, vv)
        bitwise(f"attention [{label}, D={f}, DV={dv}], second launch", out,
                attention_cuda(blocked, q, kk, vv))
        compare(f"attention [{label}, D={f}, DV={dv}]", out,
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


def one_ulp(label: str, out, ref, show: bool = True) -> float:
    """Fail unless the bf16 ``out`` is within one bf16 ulp of ``ref`` (plus
    1e-6 of its largest entry) on every entry and bitwise-equal on at
    least 99% of them; returns the max abs error."""
    import torch

    if out.dtype != torch.bfloat16 or ref.dtype != torch.bfloat16:
        raise SystemExit(f"FAIL {label}: dtypes {out.dtype}, {ref.dtype} "
                         "(bf16 expected)")
    scale = ref.float().abs().max().item() if ref.numel() else 0.0
    err = compare(label, out.float(), ref.float(), ULP_RTOL,
                  ULP_ATOL_OF_MAX * max(scale, 1e-30), show=False)
    share = (out == ref).float().mean().item() if out.numel() else 1.0
    ok = share >= BITWISE_SHARE
    if show or not ok:
        print(f"  {'ok  ' if ok else 'FAIL'} {label}: max abs err "
              f"{err:.3e} (output scale {scale:.3e}), {share:.5f} of the "
              f"entries bitwise equal (one bf16 ulp, >= {BITWISE_SHARE})",
              flush=True)
    if not ok:
        raise SystemExit(f"FAIL {label}")
    return err


def check_narrow_hub_windows(label: str, blocked, b, out, ref) -> float:
    """The bf16 or int8 window SpMM on a transpose: ``out`` (bf16) within
    one ulp of ``ref`` (its plain version) on the rows of ordinary
    windows, and on the rows of hub windows within the running-sum bound
    of the fp64 product of the (dequantized) values, plus the final
    rounding to bf16 (half an ulp, 2^-8 of the value).  Returns the max
    abs error of the ordinary rows."""
    import torch

    from repro_torch.core.spmm import dequantized

    kb, v = blocked.k_blk, blocked.vector_size
    nb, m = blocked.num_blocks, blocked.shape[0]
    per_win = torch.diff(blocked.win_ptr.long())
    hub_win = per_win > HUB_OF_MEDIAN * per_win.median()
    hub_row = hub_win.repeat_interleave(v)[:m]
    err = one_ulp(f"{label}, {int((~hub_win).sum())} ordinary windows "
                  "against the plain version", out[~hub_row], ref[~hub_row])
    win = blocked.block_win.long()
    sel = torch.nonzero(hub_win[win]).squeeze(1)
    cols = blocked.cols.long().reshape(nb, kb)[sel]
    vals4 = dequantized(blocked).vals.reshape(nb, kb, v)[sel].double()
    gb = b[cols].double()
    exact = torch.zeros((blocked.num_windows, v, b.shape[-1]),
                        dtype=torch.float64, device=b.device)
    absum = torch.zeros_like(exact)
    exact.index_add_(0, win[sel], torch.einsum("bkv,bkn->bvn", vals4, gb))
    absum.index_add_(0, win[sel], torch.einsum("bkv,bkn->bvn", vals4.abs(),
                                               gb.abs()))
    n = (per_win * kb).double().sqrt()[:, None, None]
    limit = KERNEL_ATOL + HUB_LAMBDA * n * 2.0 ** -24 * absum
    exact, limit = (t.reshape(-1, b.shape[-1])[:m][hub_row]
                    for t in (exact, limit))
    limit = limit + 2.0 ** -8 * (exact.abs() + limit)
    diff = (out[hub_row].double() - exact).abs()
    ratio = (diff / limit).max().item() if diff.numel() else 0.0
    if not bool(torch.isfinite(out).all()) or ratio > 1.0:
        raise SystemExit(f"FAIL {label}: hub rows off the fp64 product by "
                         f"{diff.max().item():.3e}, {ratio:.3f} x the bound")
    print(f"  ok   {label}, {int(hub_win.sum())} hub windows against fp64: "
          f"max abs err {diff.max().item():.3e}, at most {ratio:.3f} x the "
          f"running-sum bound plus half a bf16 ulp; the plain version is "
          f"off fp64 by {(ref[hub_row].double() - exact).abs().max().item():.3e}",
          flush=True)
    return err


def check_narrow_edge(rng) -> None:
    """Phase 3a for the precision variants: the bf16 and int8 window SpMM
    (bf16 B; int8 also with fp32 B, an fp32 result), the bf16 SDDMM and
    the bf16 fused attention against their plain versions, each also
    against a second launch."""
    import torch

    from repro_torch.core.format import block_format, from_dense
    from repro_torch.core.quantize import quantize_format
    from repro_torch.core.sddmm import with_values
    from repro_torch.kernels import (attention_cuda, attention_plain,
                                     sddmm_cuda, sddmm_plain, spmm_cuda,
                                     spmm_plain)
    from repro_torch.kernels._window import SPLIT_BLK

    bf16 = torch.bfloat16

    def t(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(DEVICE)

    beta = torch.tensor(0.8, device=DEVICE)
    for label, a, v, k_blk, n, f, dv in kernel_cases(rng):
        blocked = block_format(from_dense(a, vector_size=v), k_blk,
                               device=DEVICE)
        m, k = a.shape
        b, q, kk, vv = t(k, n), t(m, f), t(k, f), t(k, dv)
        b16, q16, kk16, vv16 = (x.to(bf16) for x in (b, q, kk, vv))
        errs = []
        for var, bv in (("bf16", with_values(blocked, blocked.vals.to(bf16))),
                        ("int8", quantize_format(blocked))):
            out = spmm_cuda(bv, b16)
            bitwise(f"spmm {var} [{label}], second launch", out,
                    spmm_cuda(bv, b16))
            errs.append(one_ulp(f"spmm {var} [{label}]", out,
                                spmm_plain(bv, b16), show=False))
        # int8 values with fp32 B: an fp32 result, held like the fp32 SpMM
        # on the windows it does not split
        per_win = torch.diff(blocked.win_ptr.long())
        rows = (per_win <= SPLIT_BLK).repeat_interleave(v)[:m]
        q8 = quantize_format(blocked)
        errs.append(compare(f"spmm int8, fp32 B [{label}]",
                            spmm_cuda(q8, b)[rows], spmm_plain(q8, b)[rows],
                            KERNEL_RTOL, KERNEL_ATOL, show=False))
        errs.append(one_ulp(f"sddmm bf16 [{label}, F={f}]",
                            sddmm_cuda(blocked, q16, kk16),
                            sddmm_plain(blocked, q16, kk16), show=False))
        out = attention_cuda(blocked, q16, kk16, vv16, scale=beta)
        bitwise(f"attention bf16 [{label}], second launch", out,
                attention_cuda(blocked, q16, kk16, vv16, scale=beta))
        errs.append(one_ulp(f"attention bf16 [{label}, D={f}, DV={dv}]", out,
                            attention_plain(blocked, q16, kk16, vv16, beta),
                            show=False))
        print(f"  ok   bf16/int8 variants [{label}]: spmm bf16 and int8, "
              "sddmm and attention bf16 within one bf16 ulp of their plain "
              "versions with >= 99% of the entries bitwise equal, int8 with "
              "fp32 B at the fp32 tolerance; the same bits on a second "
              f"launch; max abs err {max(errs):.3e}", flush=True)
    torch.cuda.synchronize()


def widened(view):
    """``view`` with fp32 values: bf16 values widened, int8 values as
    ``q * scale`` in fp32, what the narrow kernels multiply by."""
    from repro_torch.core.sddmm import with_values
    from repro_torch.core.spmm import dequantized

    return with_values(dequantized(view), dequantized(view).vals.float())


def check_narrow_balanced(tag: str, blocked, sched, b16, q16, k16, v16,
                          beta, views: dict, show: bool = False) -> dict:
    """The balanced SpMM at bf16 and int8 (``views``: variant -> view,
    with B ``b16``), SDDMM and attention at bf16 over ``sched``: the same
    bits on a second launch, bitwise the fp32 kernel on the widened
    operands, rounded once (the kernels take every sum in the fp32
    kernel's order), and within one bf16 ulp of the plain versions.
    Returns each kernel's max abs error against its plain version, by
    its ``kernels`` line name (``spmm_balanced_bf16``, ...)."""
    import torch

    from repro_torch.kernels import (attention_balanced_cuda,
                                     attention_balanced_plain,
                                     sddmm_balanced_cuda,
                                     sddmm_balanced_plain,
                                     spmm_balanced_cuda, spmm_balanced_plain)

    bf16, errs = torch.bfloat16, {}
    for var, bv in views.items():
        out = spmm_balanced_cuda(bv, b16, schedule=sched)
        bitwise(f"spmm_balanced {var} {tag}, second launch", out,
                spmm_balanced_cuda(bv, b16, schedule=sched))
        bitwise(f"spmm_balanced {var} {tag} vs the fp32 kernel, rounded",
                out, spmm_balanced_cuda(widened(bv), b16.float(),
                                        schedule=sched).to(bf16))
        errs[f"spmm_balanced_{var}"] = one_ulp(
            f"spmm_balanced {var} {tag}", out,
            spmm_balanced_plain(bv, b16, sched), show=show)
    out = sddmm_balanced_cuda(blocked, q16, k16, schedule=sched)
    bitwise(f"sddmm_balanced bf16 {tag} vs the fp32 kernel, rounded", out,
            sddmm_balanced_cuda(blocked, q16.float(), k16.float(),
                                schedule=sched).to(bf16))
    errs["sddmm_balanced_bf16"] = one_ulp(
        f"sddmm_balanced bf16 {tag}", out,
        sddmm_balanced_plain(blocked, q16, k16, sched), show=show)
    out = attention_balanced_cuda(blocked, q16, k16, v16, scale=beta,
                                  schedule=sched)
    bitwise(f"attention_balanced bf16 {tag}, second launch", out,
            attention_balanced_cuda(blocked, q16, k16, v16, scale=beta,
                                    schedule=sched))
    qs = (q16.float() * beta).to(bf16).float()
    bitwise(f"attention_balanced bf16 {tag} vs the fp32 kernel, rounded",
            out, attention_balanced_cuda(blocked, qs, k16.float(),
                                         v16.float(), scale=1.0,
                                         schedule=sched).to(bf16))
    errs["attention_balanced_bf16"] = one_ulp(
        f"attention_balanced bf16 {tag}", out,
        attention_balanced_plain(blocked, q16, k16, v16, sched, beta),
        show=show)
    return errs


def check_narrow_heads_edge(rng) -> None:
    """Phase 3a for the narrow head grids and balanced kernels: the
    head-grid SpMM at bf16 (per-head values and B) and int8 (values shared
    by the heads), the head-grid SDDMM and the fused attention at bf16, at
    H in {1, 2, 12}, each bitwise H one-head launches and within one bf16
    ulp of its plain version; the balanced SpMM (bf16, int8), SDDMM and
    attention (bf16) at split_blk in {0, 1, 3} and H in {1, 2}, the
    attention also at H = 12 (check_narrow_balanced)."""
    import torch

    from repro_torch.core.format import block_format, from_dense
    from repro_torch.core.quantize import quantize_format
    from repro_torch.core.sddmm import with_values
    from repro_torch.kernels import (attention_cuda, attention_plain,
                                     sddmm_batched_cuda, sddmm_batched_plain,
                                     sddmm_cuda, spmm_batched_cuda,
                                     spmm_batched_plain, spmm_cuda)

    bf16 = torch.bfloat16

    def t(heads, *shape):
        return torch.from_numpy(rng.standard_normal(
            heads + shape).astype(np.float32)).to(device=DEVICE, dtype=bf16)

    def head(x, i):
        return x[i] if x.dim() == 3 else x

    beta = torch.tensor(0.8, device=DEVICE)
    for label, a, v, k_blk, n, f, dv in kernel_cases(rng):
        blocked = block_format(from_dense(a, vector_size=v), k_blk,
                               device=DEVICE)
        m, k = a.shape
        q8 = quantize_format(blocked)
        errs = []
        for h in (1, 2, 12):
            hs = (h,)
            b = t(hs, k, n)
            for var, bv in (("bf16", with_values(
                    blocked, t(hs, *blocked.vals.shape) * blocked.mask)),
                            ("int8", q8)):
                tag = f"[{label}, H={h}]"
                out = spmm_batched_cuda(bv, b)
                bitwise(f"spmm_batched {var} {tag} vs {h} spmm launches", out,
                        torch.stack([spmm_cuda(with_values(
                            bv, head(bv.vals, i)), b[i]) for i in range(h)]))
                errs.append(one_ulp(f"spmm_batched {var} {tag}", out,
                                    spmm_batched_plain(bv, b), show=False))
            q, kk, vv = t(hs, m, f), t(hs, k, f), t(hs, k, dv)
            out = sddmm_batched_cuda(blocked, q, kk)
            bitwise(f"sddmm_batched bf16 {tag} vs {h} sddmm launches", out,
                    torch.stack([sddmm_cuda(blocked, q[i], kk[i])
                                 for i in range(h)]))
            errs.append(one_ulp(f"sddmm_batched bf16 {tag}", out,
                                sddmm_batched_plain(blocked, q, kk),
                                show=False))
            out = attention_cuda(blocked, q, kk, vv, scale=beta)
            bitwise(f"attention bf16 {tag} vs {h} one-head launches", out,
                    torch.stack([attention_cuda(blocked, q[i], kk[i], vv[i],
                                                scale=beta)
                                 for i in range(h)]))
            errs.append(one_ulp(f"attention bf16 {tag}", out,
                                attention_plain(blocked, q, kk, vv, beta),
                                show=False))
        for split in (0, 1, 3):
            sched = blocked.schedule(split)
            for h in (1, 2, 12):
                if h == 12 and split != 1:
                    continue
                hs = (h,) if h > 1 else ()
                views = ({} if h == 12 else
                         {"bf16": with_values(blocked, t(
                             hs, *blocked.vals.shape) * blocked.mask),
                          "int8": q8})
                errs.extend(check_narrow_balanced(
                    f"[{label}, split_blk={split}, H={h}]", blocked, sched,
                    t(hs, k, n), t(hs, m, f), t((), k, f), t(hs, k, dv), beta,
                    views).values())
        print(f"  ok   narrow head grids and balanced kernels [{label}]: "
              "spmm_batched bf16/int8, sddmm_batched and attention bf16 at "
              "H 1/2/12 bitwise their one-head launches; spmm_balanced "
              "bf16/int8, sddmm_balanced and attention_balanced bf16 at "
              "split_blk 0/1/3 bitwise the fp32 kernels on the widened "
              "operands, rounded; within one bf16 ulp of the plain versions, "
              f"max abs err {max(errs):.3e}", flush=True)
    torch.cuda.synchronize()


def check_sddmm_rows(tag: str, blocked, scheds, q, k) -> None:
    """The three SDDMMs share one tensor-core tile (``sddmm_rows.cuh``), and
    a sampled row's products do not depend on the tile that holds it: on
    the same Q and K (fp32 or bf16; 2-D, or with a head dimension) the
    window SDDMM (row 6) gives the same bits on a second launch, the head
    grid (row 7) the same bits as one-head window launches, the balanced
    SDDMM (row 8) over each schedule in ``scheds`` the same bits per row;
    at bf16 each is bitwise the fp32 kernel on the widened operands,
    rounded once."""
    import torch

    from repro_torch.kernels import (sddmm_balanced_cuda, sddmm_batched_cuda,
                                     sddmm_cuda)

    def head(x, i):
        return x[i] if x.dim() == 3 else x

    h = max(q.shape[0] if q.dim() == 3 else 1,
            k.shape[0] if k.dim() == 3 else 1)
    if q.dim() == 2 and k.dim() == 2:
        out = sddmm_cuda(blocked, q, k)
        bitwise(f"sddmm {tag}, second launch", out, sddmm_cuda(blocked, q, k))
        bitwise(f"sddmm_batched {tag}, H=1, vs sddmm", sddmm_batched_cuda(
            blocked, q[None], k)[0], out)
    else:
        out = sddmm_batched_cuda(blocked, q, k)
        bitwise(f"sddmm_batched {tag}, second launch", out,
                sddmm_batched_cuda(blocked, q, k))
        bitwise(f"sddmm_batched {tag} vs {h} sddmm launches", out,
                torch.stack([sddmm_cuda(blocked, head(q, i), head(k, i))
                             for i in range(h)]))
    for sched in scheds:
        if sched.num_blocks:
            bitwise(f"sddmm_balanced {tag}, split_blk={sched.split_blk}, vs "
                    "the window SDDMM", sddmm_balanced_cuda(
                        blocked, q, k, schedule=sched), out)
    if q.dtype == torch.bfloat16:
        fn = sddmm_cuda if out.dim() == 2 else sddmm_batched_cuda
        bitwise(f"sddmm bf16 {tag} vs the fp32 kernel, rounded", out,
                fn(blocked, q.float(), k.float()).to(torch.bfloat16))


def check_sddmm_tiles_edge(rng) -> None:
    """Phase 3a for the SDDMM tile of rows 6, 7 and 8: on every edge case at
    its F and at F = 720 and 1,500 (streamed past one stage of 64
    features), Q and K of unit rows (the main path's scaling), fp32 and
    bf16, one head and three (per-head Q, shared K): check_sddmm_rows at
    split_blk 0 / 1 / 3, and the plain version within the kernel tolerance
    (fp32) or one bf16 ulp (bf16)."""
    import torch

    from repro_torch.core.format import block_format, from_dense
    from repro_torch.kernels import sddmm_batched_cuda, sddmm_batched_plain

    errs = []
    for label, a, v, k_blk, _, f, _ in kernel_cases(rng):
        blocked = block_format(from_dense(a, vector_size=v), k_blk,
                               device=DEVICE)
        scheds = [blocked.schedule(split) for split in (0, 1, 3)]
        m, k = a.shape
        for ff in (f, 720, 1500):
            q = unit_rows(rng, m, ff).to(DEVICE)
            q3 = torch.stack([q] + [unit_rows(rng, m, ff).to(DEVICE)
                                    for _ in range(2)])
            kk = unit_rows(rng, k, ff).to(DEVICE)
            for dtype in (torch.float32, torch.bfloat16):
                for x in (q, q3):
                    x, y = x.to(dtype), kk.to(dtype)
                    tag = (f"[{label}, F={ff}, {str(dtype)[6:]}, "
                           f"H={x.shape[0] if x.dim() == 3 else 1}]")
                    check_sddmm_rows(tag, blocked, scheds, x, y)
                    got = sddmm_batched_cuda(blocked, x, y)
                    want = sddmm_batched_plain(blocked, x, y)
                    errs.append(one_ulp(f"sddmm {tag}", got, want, show=False)
                                if dtype == torch.bfloat16 else
                                compare(f"sddmm {tag}", got, want,
                                        KERNEL_RTOL, KERNEL_ATOL, show=False))
        print(f"  ok   SDDMM tile [{label}], F {f}/720/1500, fp32/bf16, H "
              "1/3: rows 6, 7 and 8 the same bits per sampled row (split_blk "
              "0/1/3), the same bits on a second launch, bf16 bitwise the "
              "fp32 kernel on widened operands; against the plain versions "
              f"max abs err {max(errs):.3e}", flush=True)
    torch.cuda.synchronize()


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
                                     spmm_noncoalesced_cuda, spmm_plain,
                                     spmm_staged_cuda, spmm_staged_plain)

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
                bitwise(f"spmm_batched {tag}, second launch", out,
                        spmm_batched_cuda(bv, b))
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
        check_noncoalesced(f"spmm_noncoalesced [{label}] vs spmm", blocked,
                           spmm_noncoalesced_cuda(blocked, b),
                           spmm_cuda(blocked, b), spmm_plain(blocked, b))
        errs.append(compare(f"spmm_staged [{label}]",
                            spmm_staged_cuda(blocked, b),
                            spmm_staged_plain(blocked, b), KERNEL_RTOL,
                            KERNEL_ATOL, show=False))
        print(f"  ok   [{label}]: spmm_batched, sddmm_batched (H 1/2/4 x 3 "
              "mixes) and attention (H 1/2/4 x 7 mixes) bitwise-equal to "
              "their one-head launches, spmm_batched to a second launch, "
              "spmm_noncoalesced bitwise-equal to spmm on unsplit windows; "
              f"against the plain versions max abs err {max(errs):.3e}",
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
    return dict(rows=rows, cols=cols, fmt=fmt, plan=plan, bplan=bplan, g=g,
                scale=1.0 / math.sqrt(ATTN_DIM), host_s=t_host, **t)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script runs the port on a CUDA card only")

    from repro_torch.core.autodiff import (ad_plan, attention_ad, sddmm_ad,
                                           spmm_ad)
    from repro_torch.core.format import from_coo
    from repro_torch.core.quantize import quantize_format
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
    from repro_torch.kernels._window import SPLIT_BLK, window_plan
    from repro_torch.kernels.attention_cuda import rings_fit, value_bands
    from repro_torch.kernels.attention_balanced_cuda import RUN_BLK as ATTN_RUN
    from repro_torch.kernels.spmm_balanced_cuda import RUN_BLK as SPMM_RUN
    from repro_torch.core.softmax import sparse_softmax
    from repro_torch.models.gnn import (AGNN, GCN, GNNConfig, agnn_forward,
                                        gcn_forward, gnn_loss)
    from repro_torch.models.layers import (sparse_attention,
                                           sparse_attention_staged)
    from repro_torch.sparse.graphs import make_dataset
    from repro_torch.train.sparse_attention_train import (
        TOLERANCES as ATTN_TOLERANCES, dense_mask, dense_masked_attention,
        initial_w, make_inputs, params_from_jax, train_value_projection,
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
                "sddmm_batched": sddmm_batched_cuda,
                "spmm_bf16": spmm_cuda, "spmm_int8": spmm_cuda,
                "sddmm_bf16": sddmm_cuda, "attention_bf16": attention_cuda,
                "spmm_batched_bf16": spmm_batched_cuda,
                "spmm_batched_int8": spmm_batched_cuda,
                "sddmm_batched_bf16": sddmm_batched_cuda,
                "spmm_balanced_bf16": spmm_balanced_cuda,
                "spmm_balanced_int8": spmm_balanced_cuda,
                "sddmm_balanced_bf16": sddmm_balanced_cuda,
                "attention_balanced_bf16": attention_balanced_cuda}

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0
            for var in getattr(fn, "variant_launches", {}):
                fn.variant_launches[var] = 0

    def counts():
        # a wrapper with precision variants counts each entry's variant
        return {name: (fn.variant_launches[VARIANT_OF[name]]
                       if name in VARIANT_OF else fn.launches)
                for name, fn in wrappers.items()}

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
    check_narrow_edge(np.random.default_rng(2))
    check_narrow_heads_edge(np.random.default_rng(3))
    check_sddmm_tiles_edge(np.random.default_rng(4))

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
    out = spmm_cuda(blk, b)
    bitwise("spmm [Amazon, N=128], second launch", out, spmm_cuda(blk, b))
    a_out = attention_cuda(blk, h32, h32, v32, scale=beta)
    bitwise("attention [Amazon, D=DV=32, scale=beta], second launch", a_out,
            attention_cuda(blk, h32, h32, v32, scale=beta))
    err = {
        "spmm": compare("spmm [Amazon, N=128]", out, spmm_plain(blk, b),
                        KERNEL_RTOL, KERNEL_ATOL),
        "sddmm": compare("sddmm [Amazon, F=32]", sddmm_cuda(blk, h32, h32),
                         sddmm_plain(blk, h32, h32), KERNEL_RTOL, KERNEL_ATOL),
        "attention": compare(
            "attention [Amazon, D=DV=32, scale=beta]", a_out,
            attention_plain(blk, h32, h32, v32, scale=beta),
            KERNEL_RTOL, KERNEL_ATOL),
    }
    # The window-parallel SpMM on A^T (the dB of every GCN and AGNN layer
    # on the cuda route), whose hub columns of A are hub windows, cut into
    # slices over thread-block clusters: ordinary windows against the plain
    # version, hub windows against fp64, and a second launch (same bits).
    windows = {"A_n128": window_stats("A", blk, 128),
               "At_n128": window_stats("A^T", plan.bwd, 128),
               "At_n32": window_stats("A^T", plan.bwd, 32)}
    for n_cols, bb in ((128, b), (32, b32)):
        out = spmm_cuda(plan.bwd, bb)
        bitwise(f"spmm [Amazon A^T, N={n_cols}], second launch", out,
                spmm_cuda(plan.bwd, bb))
        err[f"spmm_At{n_cols}"] = check_hub_windows(
            f"spmm [Amazon A^T, N={n_cols}]", plan.bwd, plan.bwd.vals[None],
            bb[None], out[None], spmm_plain(plan.bwd, bb)[None])
    del out, a_out
    # The precision variants on A and A^T: bf16 values and B, and int8
    # values (per-K-block scales) with bf16 B, at N = 128 and 32; bf16
    # SDDMM and fused attention at F = D = DV = 32.  Each within one bf16
    # ulp of its plain version (hub rows of A^T against fp64), the same
    # bits on a second launch, and the same bits as the fp32 kernel on the
    # operands widened to fp32, rounded to bf16 (both take every column's
    # products in one order: this holds the two-columns-a-thread mapping
    # of bf16 B to the fp32 kernel's one column a thread).
    bf16 = torch.bfloat16
    b16, b32_16 = b.to(bf16), b32.to(bf16)
    h32_16, v32_16 = h32.to(bf16), v32.to(bf16)
    narrow = {"A": {"bf16": with_values(blk, blk.vals.to(bf16)),
                    "int8": quantize_format(blk)},
              "A^T": {"bf16": with_values(plan.bwd, plan.bwd.vals.to(bf16)),
                      "int8": quantize_format(plan.bwd)}}
    for dirn, views in narrow.items():
        for var, bv in views.items():
            for n_cols, bb in ((128, b16), (32, b32_16)):
                tag = f"spmm {var} [Amazon {dirn}, N={n_cols}]"
                out = spmm_cuda(bv, bb)
                bitwise(f"{tag}, second launch", out, spmm_cuda(bv, bb))
                wide = (bv if var == "int8"
                        else with_values(bv, bv.vals.float()))
                bitwise(f"{tag} vs the fp32 kernel, rounded", out,
                        spmm_cuda(wide, bb.float()).to(bf16))
                ref = spmm_plain(bv, bb)
                if dirn == "A":
                    e_ = one_ulp(tag, out, ref)
                else:
                    e_ = check_narrow_hub_windows(tag, bv, bb, out, ref)
                err[f"spmm_{var}_{dirn.replace('^T', 't')}{n_cols}"] = e_
    err["spmm_bf16"], err["spmm_int8"] = (err["spmm_bf16_A128"],
                                          err["spmm_int8_A128"])
    out = sddmm_cuda(blk, h32_16, h32_16)
    bitwise("sddmm bf16 [Amazon, F=32], second launch", out,
            sddmm_cuda(blk, h32_16, h32_16))
    err["sddmm_bf16"] = one_ulp("sddmm bf16 [Amazon, F=32]", out,
                                sddmm_plain(blk, h32_16, h32_16))
    for x in (h32, h32_16):
        check_sddmm_rows(f"[Amazon A, F=32, {str(x.dtype)[6:]}]", bplan.fwd,
                         [bplan.fwd_sched], x, x)
    out = attention_cuda(blk, h32_16, h32_16, v32_16, scale=beta)
    bitwise("attention bf16 [Amazon, D=DV=32, scale=beta], second launch",
            out, attention_cuda(blk, h32_16, h32_16, v32_16, scale=beta))
    err["attention_bf16"] = one_ulp(
        "attention bf16 [Amazon, D=DV=32, scale=beta]", out,
        attention_plain(blk, h32_16, h32_16, v32_16, beta))
    del out, ref
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
        else:
            err.update(spmm_balanced_At128=e_spmm[0],
                       spmm_balanced_At32=e_spmm[1])
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
    # The narrow balanced kernels on A and A^T: the SpMM at bf16 and int8
    # (N = 128 at split_blk 0 / 1 / 3, N = 32 at 1), the SDDMM and the
    # attention at bf16 (F = D = DV = 32), each bitwise the fp32 kernel on
    # the widened operands, rounded, the same bits on a second launch and
    # within one bf16 ulp of its plain version; the bf16 SpMM's hub rows of
    # A^T against fp64.
    bal16 = {"A": {"bf16": with_values(bplan.fwd, bplan.fwd.vals.to(bf16)),
                   "int8": quantize_format(bplan.fwd)},
             "A^T": {"bf16": with_values(bplan.bwd, bplan.bwd.vals.to(bf16)),
                     "int8": quantize_format(bplan.bwd)}}
    for dirn, bl in (("A", bplan.fwd), ("A^T", bplan.bwd)):
        for split, bb in ((0, b16), (1, b16), (3, b16), (1, b32_16)):
            sched = bl.schedule(split)
            tag = f"[Amazon {dirn}, N={bb.shape[1]}, split_blk={split}]"
            e_ = check_narrow_balanced(tag, bl, sched, bb, h32_16, h32_16,
                                       v32_16, beta, bal16[dirn], show=True)
            if split == 1 and dirn == "A" and bb.shape[1] == 128:
                err.update(e_)  # the kernels line's main-path shapes
            if split == 1 and dirn == "A^T" and bb.shape[1] == 32:
                err["spmm_balanced_bf16_At32"] = e_["spmm_balanced_bf16"]
        if dirn == "A^T":
            out = spmm_balanced_cuda(bal16[dirn]["bf16"], b16,
                                     schedule=bl.schedule(1))
            err["spmm_balanced_bf16_At128"] = check_narrow_hub_windows(
                "spmm_balanced bf16 [Amazon A^T, N=128, split_blk=1]",
                bal16[dirn]["bf16"], b16, out,
                spmm_balanced_plain(bal16[dirn]["bf16"], b16,
                                    bl.schedule(1)))
    # The int8 head-grid SpMM at the main path's shape: the quantized
    # values of A shared by two feature sets (bf16 B), bitwise two one-head
    # launches.
    b_2 = torch.stack([b16, second_head(b)[1].to(bf16)])
    out = spmm_batched_cuda(narrow["A"]["int8"], b_2)
    bitwise("spmm_batched int8 [Amazon A, H=2, N=128] vs 2 spmm launches",
            out, torch.stack([spmm_cuda(narrow["A"]["int8"], b_2[i])
                              for i in range(2)]))
    err["spmm_batched_int8"] = one_ulp(
        "spmm_batched int8 [Amazon A, H=2, N=128]", out,
        spmm_batched_plain(narrow["A"]["int8"], b_2))
    del out, b_2
    # The Fig. 15 baseline keeps spmm.cu's per-output order on unsplit
    # windows (all of A's): same bits.
    check_noncoalesced("spmm_noncoalesced [Amazon, N=128] vs spmm", blk,
                       spmm_noncoalesced_cuda(blk, b), spmm_cuda(blk, b),
                       spmm_plain(blk, b))
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
    aprob_t_blk = with_values(aplan.bwd, aprobs_t)
    windows["attention_At_n64"] = window_stats("attention A^T", aplan.bwd,
                                                ATTN_DIM)
    dv_out = spmm_batched_cuda(aprob_t_blk, ag)
    bitwise(f"spmm_batched [attention A^T, {tag}: dV], second launch",
            dv_out, spmm_batched_cuda(aprob_t_blk, ag))
    err["spmm_batched_At"] = check_hub_windows(
        f"spmm_batched [attention A^T, {tag}: dV = P^T @ G]", aplan.bwd,
        aprobs_t, ag, dv_out, spmm_batched_plain(aprob_t_blk, ag))
    # The same dV on the balanced route: runs cut the global keys' windows.
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
    check_sddmm_rows(f"[attention A, {tag}]", abplan.fwd, [abplan.fwd_sched],
                     aq, ak)
    a_out = attention_cuda(ablk, aq, ak, av, scale=att["scale"])
    bitwise(f"attention [attention A, {tag}], second launch", a_out,
            attention_cuda(ablk, aq, ak, av, scale=att["scale"]))
    err["attention_h12"] = compare(
        f"attention [attention A, {tag}, scale 1/sqrt(D)]", a_out,
        attention_plain(ablk, aq, ak, av, att["scale"]), KERNEL_RTOL,
        KERNEL_ATOL)
    del a_out
    # The bf16 variants at the attention configuration: the head-grid SpMM
    # (probabilities @ V, and dV on A^T with its global-key windows against
    # fp64), the head-grid SDDMM and the fused attention, each bitwise its
    # 12 one-head launches; the balanced attention and the balanced SpMM on
    # dV bitwise the fp32 kernels on the widened operands; all within one
    # bf16 ulp of their plain versions.
    aq16, ak16, av16, ag16 = (x.to(bf16) for x in (aq, ak, av, ag))
    aprob16 = with_values(ablk, aprobs.to(bf16))
    aprob_t16 = with_values(aplan.bwd, aprobs_t.to(bf16))
    out = spmm_batched_cuda(aprob16, av16)
    bitwise(f"spmm_batched bf16 [attention A, {tag}] vs 12 spmm launches",
            out, torch.stack([spmm_cuda(with_values(ablk, aprob16.vals[i]),
                                        av16[i]) for i in range(ATTN_HEADS)]))
    err["spmm_batched_bf16"] = one_ulp(
        f"spmm_batched bf16 [attention A, {tag}: probabilities @ V]", out,
        spmm_batched_plain(aprob16, av16))
    out = spmm_batched_cuda(aprob_t16, ag16)
    bitwise(f"spmm_batched bf16 [attention A^T, {tag}: dV] vs the fp32 "
            "kernel, rounded", out,
            spmm_batched_cuda(widened(aprob_t16), ag16.float()).to(bf16))
    ref = spmm_batched_plain(aprob_t16, ag16)
    err["spmm_batched_bf16_At"] = max(
        check_narrow_hub_windows(
            f"spmm_batched bf16 [attention A^T, {tag}: dV, head {h_}]",
            with_values(aplan.bwd, aprob_t16.vals[h_]), ag16[h_], out[h_],
            ref[h_]) for h_ in (0, ATTN_HEADS - 1))
    out = spmm_balanced_cuda(aprob_t16, ag16, schedule=dv_sched)
    bitwise(f"spmm_balanced bf16 [attention A^T, {tag}: dV, split_blk=1] vs "
            "the fp32 kernel, rounded", out,
            spmm_balanced_cuda(widened(aprob_t16), ag16.float(),
                               schedule=dv_sched).to(bf16))
    one_ulp(f"spmm_balanced bf16 [attention A^T, {tag}: dV, split_blk=1]",
            out, spmm_balanced_plain(aprob_t16, ag16, dv_sched))
    out = sddmm_batched_cuda(ablk, aq16, ak16)
    bitwise(f"sddmm_batched bf16 [attention A, {tag}] vs 12 sddmm launches",
            out, torch.stack([sddmm_cuda(ablk, aq16[i], ak16[i])
                              for i in range(ATTN_HEADS)]))
    err["sddmm_batched_bf16"] = one_ulp(
        f"sddmm_batched bf16 [attention A, {tag}: scores]", out,
        sddmm_batched_plain(ablk, aq16, ak16))
    check_sddmm_rows(f"[attention A, {tag}, bf16]", abplan.fwd,
                     [abplan.fwd_sched], aq16, ak16)
    one_ulp(f"sddmm_balanced bf16 [attention A, {tag}: scores]",
            sddmm_balanced_cuda(abplan.fwd, aq16, ak16,
                                schedule=abplan.fwd_sched),
            sddmm_balanced_plain(abplan.fwd, aq16, ak16, abplan.fwd_sched))
    a_out = attention_cuda(ablk, aq16, ak16, av16, scale=att["scale"])
    bitwise(f"attention bf16 [attention A, {tag}], second launch", a_out,
            attention_cuda(ablk, aq16, ak16, av16, scale=att["scale"]))
    bitwise(f"attention bf16 [attention A, {tag}] vs 12 one-head launches",
            a_out, torch.stack([attention_cuda(ablk, aq16[i], ak16[i],
                                               av16[i], scale=att["scale"])
                                for i in range(ATTN_HEADS)]))
    err["attention_bf16_h12"] = one_ulp(
        f"attention bf16 [attention A, {tag}]", a_out,
        attention_plain(ablk, aq16, ak16, av16, att["scale"]))
    a_out = attention_balanced_cuda(abplan.fwd, aq16, ak16, av16,
                                    scale=att["scale"],
                                    schedule=abplan.fwd_sched)
    qs16 = (aq16.float() * att["scale"]).to(bf16).float()
    bitwise(f"attention_balanced bf16 [attention A, {tag}] vs the fp32 "
            "kernel, rounded", a_out,
            attention_balanced_cuda(abplan.fwd, qs16, ak16.float(),
                                    av16.float(), scale=1.0,
                                    schedule=abplan.fwd_sched).to(bf16))
    err["attention_balanced_bf16_h12"] = one_ulp(
        f"attention_balanced bf16 [attention A, {tag}]", a_out,
        attention_balanced_plain(abplan.fwd, aq16, ak16, av16,
                                 abplan.fwd_sched, att["scale"]))
    del a_out, out, ref, qs16
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

    def attn_counts(route, what, var=""):
        # Launches of a forward ("fwd"), or of a forward and the backward
        # for dQ ("dq") or for dV ("dv", the value projection), from the
        # autograd Functions and the gradients needed.  Fused routes:
        # forward one attention kernel; backward the recomputed scores
        # (SDDMM), then for dQ the dProbs SDDMM and the dQ SpMM, for dV the
        # dV SpMM on A^T.  Staged layer: forward the scores SDDMM and the
        # P @ V SpMM; backward for dQ the dProbs SDDMM and the dQ SpMM, for
        # dV the dV SpMM.  Each is one launch for all heads, of the
        # variant ``var`` ("" fp32, "_bf16").
        batched = route != "cuda_balanced"
        sd, sp = (("sddmm_batched", "spmm_batched") if batched
                  else ("sddmm_balanced", "spmm_balanced"))
        sd, sp = sd + var, sp + var
        if route == "staged_cuda":
            fwd = {sd: 1, sp: 1}
            bwd = {sd: 1, sp: 1} if what == "dq" else {sp: 1}
        else:
            fwd = {("attention" if batched else "attention_balanced")
                   + var: 1}
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

    phase(f"4e. precision: {TRAIN_STEPS} steps of GCN and AGNN in bf16 and "
          "of GCN under an int8 plan, on cuda and cuda_balanced")
    t0 = time.time()
    fmt16 = from_coo(g.rows, g.cols, g.vals, (m, m), vector_size=8,
                     dtype=bf16)
    plan16 = ad_plan(fmt16, impl="cuda", k_blk=8, device=DEVICE)
    plan8 = ad_plan(fmt, impl="cuda", k_blk=8, device=DEVICE,
                    precision="int8")
    print(f"  bf16 format + plan {time.time() - t0:.1f} s on the host; the "
          "int8 plan shares the fp32 plan's arrays and quantizes A's values "
          "per K-block at each forward SpMM")
    t0 = time.time()
    bplan16 = ad_plan(fmt16, impl="cuda_balanced", k_blk=8, split_blk=1,
                      device=DEVICE)
    bplan8 = ad_plan(fmt, impl="cuda_balanced", k_blk=8, split_blk=1,
                     device=DEVICE, precision="int8")
    print(f"  bf16 balanced plan {time.time() - t0:.1f} s on the host")
    x16 = x.to(bf16)
    modes = {  # name: (model, parameter dtype, adjacency per impl, features)
        "gcn_bf16": ("gcn", bf16, {"cuda": plan16, "cuda_balanced": bplan16},
                     x16),
        "agnn_bf16": ("agnn", bf16, {"cuda": plan16,
                                     "cuda_balanced": bplan16}, x16),
        "gcn_int8": ("gcn", torch.float32, {"cuda": plan8,
                                            "cuda_balanced": bplan8}, x),
    }

    def narrow_expect(name, impl):
        # The fp32 step's counts (4b) on the variants each mode runs: in
        # bf16 every launch is a bf16 one; under an int8 plan the forward
        # SpMMs are int8 and the transpose SpMMs (dB) bf16.
        sfx = "" if impl == "cuda" else "_balanced"
        if name == "gcn_bf16":
            return expect(**{f"spmm{sfx}_bf16": 2 * n_layers - 1})
        if name == "agnn_bf16":
            return expect(**{f"attention{sfx}_bf16": n_layers,
                             f"sddmm{sfx}_bf16": 2 * n_layers,
                             f"spmm{sfx}_bf16": 3 * n_layers})
        return expect(**{f"spmm{sfx}_int8": n_layers,
                         f"spmm{sfx}_bf16": n_layers - 1})

    def make_narrow(model, dtype, impl):
        cfg = dataclasses.replace(cfgs[model], impl=impl, dtype=dtype)
        net = (GCN if model == "gcn" else AGNN)(cfg, device=DEVICE,
                                                seed=0 if model == "gcn" else 1)
        return net, make_gnn_train_step(cfg, net, lr=TRAIN_LR)

    narrow_nets = {}
    for name, (model, dtype, adjs_, xx) in modes.items():
        ref_net, ref_step = make_narrow(model, dtype, "blocked")
        ref_loss = ref_step(adjs_["cuda"], xx, labels, train_mask)[0].item()
        ref_grads = [p_.grad.float() for p_ in ref_net.parameters()]
        del ref_net, ref_step
        grad_tol = NARROW_GRAD_ULPS * 2.0 ** -7 * max(
            gr.abs().max().item() for gr in ref_grads)
        for impl, adj in adjs_.items():
            net, step = make_narrow(model, dtype, impl)
            narrow_nets[(name, impl)] = (net, step, adj, xx)
            losses = []
            for i in range(TRAIN_STEPS):
                reset_counts()
                loss, _ = step(adj, xx, labels, train_mask)
                torch.cuda.synchronize()
                got, want = counts(), narrow_expect(name, impl)
                if got != want:
                    raise SystemExit(f"FAIL train {name}/{impl} step {i}: "
                                     f"launch counts {got} != {want}")
                for k_name in launches:
                    launches[k_name] += got[k_name]
                losses.append(loss.item())
                if i == 0:
                    for j, (p_, want_g) in enumerate(zip(net.parameters(),
                                                         ref_grads)):
                        compare(f"train {name}/{impl}: step-1 grad of "
                                f"parameter {j} {tuple(p_.shape)} vs blocked "
                                "at the same precision", p_.grad.float(),
                                want_g, 0.0, grad_tol)
            fp32_loss = train[f"{model}_{impl}"]["losses"][0]
            compare(f"train {name}/{impl}: step-1 loss vs blocked at the same "
                    "precision", torch.tensor(losses[0]),
                    torch.tensor(ref_loss), NARROW_LOSS_RTOL, 0.0)
            compare(f"train {name}/{impl}: step-1 loss vs the fp32 {impl} "
                    "step", torch.tensor(losses[0]), torch.tensor(fp32_loss),
                    NARROW_VS_FP32_RTOL, 0.0)
            print(f"  {name}/{impl}: losses {losses} (blocked {ref_loss}, "
                  f"fp32 {impl} {fp32_loss}); launches per step {got}")
            if not (all(map(math.isfinite, losses))
                    and all(b_ < a_ for a_, b_ in zip(losses, losses[1:]))):
                raise SystemExit(f"FAIL train {name}/{impl}: losses {losses} "
                                 "are not finite and decreasing")
            if not all(p_.dtype == dtype for p_ in net.parameters()):
                raise SystemExit(f"FAIL train {name}/{impl}: parameters left "
                                 f"{dtype}")
            train[f"{name}_{impl}"] = {"losses": losses,
                                       "launches_per_step": got,
                                       "blocked_step1_loss": ref_loss,
                                       "fp32_step1_loss": fp32_loss}
        del ref_grads
    # The int8-plan GCN forward over two feature sets at once: the forward
    # SpMMs run the head-grid kernel on the quantized values of A, shared
    # by both sets (the reference routes 3-D features to its batched grid
    # with shared int8 values, spmm_pallas.py:407), against the blocked
    # route at the same precision.
    gcn8 = narrow_nets[("gcn_int8", "cuda")][0]
    x_2 = torch.stack([x, x.flip(0)])
    with torch.inference_mode():
        reset_counts()
        out = gcn8(plan8, x_2)
        torch.cuda.synchronize()
        got, want = counts(), expect(spmm_batched_int8=n_layers)
        if got != want:
            raise SystemExit(f"FAIL gcn_int8 forward over 2 feature sets: "
                             f"launch counts {got} != {want}")
        for k_name in launches:
            launches[k_name] += got[k_name]
        ref = gcn_forward(gcn8.params(), plan8, x_2, plain["gcn"])
        compare("gcn_int8/cuda forward over 2 feature sets vs blocked at the "
                "same precision", out, ref, NARROW_LOSS_RTOL,
                NARROW_LOSS_RTOL * ref.abs().max().item())
    print(f"  gcn_int8/cuda forward over 2 feature sets: launches {got}")
    del out, ref

    phase("4f. fused attention over value bands and past its shared memory "
          "(Amazon A)")
    wide = {}
    for d_, dv_, dtype in ((32, 129, torch.float32), (32, 256, torch.float32),
                           (32, 256, bf16), (720, 32, torch.float32)):
        qq = unit_rows(rng, m, d_).to(device=DEVICE, dtype=dtype)
        vv = torch.from_numpy(rng.standard_normal((m, dv_)).astype(
            np.float32)).to(device=DEVICE, dtype=dtype)
        tag = f"attention [Amazon, D={d_}, DV={dv_}, {dtype}]"
        fits = rings_fit(8, d_, dtype)
        reset_counts()
        out = attention_cuda(blk, qq, qq, vv, scale=beta)
        torch.cuda.synchronize()
        got = counts()
        var = "" if dtype == torch.float32 else "_bf16"
        want = (expect(**{"attention" + var: len(value_bands(dv_))}) if fits
                else expect(**{"sddmm" + var: 1, "spmm" + var: 1}))
        if got != want:
            raise SystemExit(f"FAIL {tag}: launch counts {got} != {want}")
        ref = attention_plain(blk, qq, qq, vv, beta)
        e_ = (one_ulp(tag, out, ref) if dtype == bf16 else
              compare(tag, out, ref, KERNEL_RTOL, KERNEL_ATOL))
        route = (f"{len(value_bands(dv_))} band launch(es)" if fits
                 else "the SDDMM and SpMM kernels (rings past shared memory)")
        print(f"  {tag}: {route}")
        wide[f"d{d_}_dv{dv_}_{dtype}"] = {"max_abs_err": e_, "route": route}
    del qq, vv, out, ref
    torch.cuda.synchronize()

    phase(f"4g. multi-head sparse attention under bf16 plans: H={ATTN_HEADS}, "
          f"S={ATTN_SEQ}, D=DV={ATTN_DIM}")
    # The reference example's inputs rounded to bf16 (the operands a bf16
    # plan runs), kept as fp32 masters; the plans of 4c at
    # precision="bf16", sharing their arrays.
    aplan16 = ad_plan(att["fmt"], impl="cuda", k_blk=8, device=DEVICE,
                      precision="bf16")
    abplan16 = ad_plan(att["fmt"], impl="cuda_balanced", k_blk=8,
                       split_blk=1, device=DEVICE, precision="bf16")
    t16 = params_from_jax(device=DEVICE, **dict(zip("qkv", make_inputs(
        ATTN_SEQ, ATTN_HEADS, ATTN_DIM, precision="bf16"))))
    bq, bk, bv = t16["q"], t16["k"], t16["v"]
    tol16, dq_tol16 = ATTN_TOLERANCES["bf16"]
    attn16 = {   # name: (plan, impl, staged layer), as in 4d
        "cuda": (aplan16, "cuda", False),
        "cuda_balanced": (abplan16, "cuda_balanced", False),
        "staged_cuda": (aplan16, "cuda", True)}

    def attend16(name):
        plan_, impl, staged = attn16[name]
        layer = sparse_attention_staged if staged else sparse_attention
        return layer(plan_, bq, bk, bv, impl=impl)

    with torch.inference_mode():
        dense16 = {h: dense_masked_attention(bq[h], bk[h], bv[h], amask)
                   for h in dense_heads}
        for name in attn16:
            reset_counts()
            out = attend16(name)
            torch.cuda.synchronize()
            got, want = counts(), attn_counts(name, "fwd", "_bf16")
            print(f"  bf16 attention forward {name}: launches {got}")
            if got != want:
                raise SystemExit(f"FAIL bf16 attention forward {name}: "
                                 f"launch counts {got} != {want}")
            for k_name in launches:
                launches[k_name] += got[k_name]
            if out.dtype != bf16 or out.shape != bq.shape:
                raise SystemExit(f"FAIL bf16 attention forward {name}: "
                                 f"{out.dtype} {tuple(out.shape)}")
            for h in dense_heads:
                compare(f"bf16 attention forward {name} head {h} vs dense "
                        "masked attention on the bf16 operands (bf16 ladder)",
                        out[h].float(), dense16[h], tol16, tol16)
        del dense16, out

    def attn16_dq(plan_, impl, staged):
        layer = sparse_attention_staged if staged else sparse_attention
        leaf = bq.detach().clone().requires_grad_(True)
        (dq,) = torch.autograd.grad(layer(plan_, leaf, bk, bv,
                                          impl=impl).float().sum(), leaf)
        return dq

    dq_ref = attn16_dq(aplan16, "blocked", False)
    vp_ref16 = train_value_projection(aplan16, bq, bk, bv, "blocked",
                                      steps=1, lr=ATTN_LR)
    attn16_result = {}
    for name, (plan_, impl, staged) in attn16.items():
        reset_counts()
        dq = attn16_dq(plan_, impl, staged)
        torch.cuda.synchronize()
        got, want = counts(), attn_counts(name, "dq", "_bf16")
        if got != want:
            raise SystemExit(f"FAIL bf16 attention dQ {name}: launch counts "
                             f"{got} != {want}")
        for k_name in launches:
            launches[k_name] += got[k_name]
        compare(f"bf16 attention dout/dQ {name} vs blocked at bf16, within "
                f"{NARROW_GRAD_ULPS} bf16 ulps of its largest entry", dq,
                dq_ref, 0.0,
                NARROW_GRAD_ULPS * 2.0 ** -7 * dq_ref.abs().max().item())
        reset_counts()
        run = train_value_projection(plan_, bq, bk, bv, impl,
                                     steps=TRAIN_STEPS, lr=ATTN_LR,
                                     staged=staged)
        torch.cuda.synchronize()
        got = counts()
        fwd = attn_counts(name, "fwd", "_bf16")
        step = attn_counts(name, "dv", "_bf16")
        want = {k_: 2 * fwd[k_] + TRAIN_STEPS * step[k_] for k_ in wrappers}
        if got != want:
            raise SystemExit(f"FAIL bf16 value projection {name}: launch "
                             f"counts {got} != {want}")
        for k_name in launches:
            launches[k_name] += got[k_name]
        losses = run.losses + [run.final]
        print(f"  bf16 value projection {name}: losses {losses}; launches "
              f"{got} (target + {TRAIN_STEPS} steps + final loss)")
        if not (all(map(math.isfinite, losses))
                and all(b_ < a_ for a_, b_ in zip(losses, losses[1:]))):
            raise SystemExit(f"FAIL bf16 value projection {name}: losses "
                             f"{losses} are not finite and decreasing")
        compare(f"bf16 value projection {name}: step-1 loss vs blocked at "
                "bf16", torch.tensor(run.losses[0]),
                torch.tensor(vp_ref16.losses[0]), NARROW_LOSS_RTOL, 0.0)
        compare(f"bf16 value projection {name}: step-1 dloss/dW vs blocked "
                f"at bf16, within {NARROW_GRAD_ULPS} bf16 ulps of its "
                "largest entry", run.first_grad, vp_ref16.first_grad, 0.0,
                NARROW_GRAD_ULPS * 2.0 ** -7
                * vp_ref16.first_grad.abs().max().item())
        attn16_result[name] = {"losses": losses, "launches": got,
                               "launches_per_step": step}
    del dq, dq_ref
    torch.cuda.synchronize()

    phase("5. timing (CUDA events around back-to-back calls, median of runs)")
    csr = torch.sparse_coo_tensor(
        torch.from_numpy(np.stack([g.rows, g.cols])),
        torch.from_numpy(g.vals), (m, m)).coalesce().to_sparse_csr().to(DEVICE)
    pattern = torch.sparse_csr_tensor(csr.crow_indices(), csr.col_indices(),
                                      torch.ones_like(csr.values()), (m, m))
    csr_t = torch.sparse_coo_tensor(
        torch.from_numpy(np.stack([g.cols, g.rows])),
        torch.from_numpy(g.vals), (m, m)).coalesce().to_sparse_csr().to(DEVICE)
    bblk, bsched = bplan.fwd, bplan.fwd_sched
    nnz_all = int(blk.mask.sum())
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
    # P^T for the dV yardstick
    aprob_t_coo = torch.sparse_coo_tensor(
        aprob_coo.indices()[[0, 2, 1]], aprob_coo.values(),
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
            # the window-parallel SpMM on the transposes: dB = A^T G on the
            # Amazon replica, the attention's dV = P^T G
            "spmm_At128": (lambda: spmm_cuda(plan.bwd, b),
                           lambda: spmm_plain(plan.bwd, b),
                           lambda: torch.sparse.mm(csr_t, b)),
            "spmm_At32": (lambda: spmm_cuda(plan.bwd, b32),
                          lambda: spmm_plain(plan.bwd, b32),
                          lambda: torch.sparse.mm(csr_t, b32)),
            "spmm_batched_At": (lambda: spmm_batched_cuda(aprob_t_blk, ag),
                                lambda: spmm_batched_plain(aprob_t_blk, ag),
                                lambda: torch.bmm(aprob_t_coo, ag)),
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
        # The precision variants (rows 1, 6, 9) at the same shapes; their
        # yardsticks take the bf16 CSR (the int8 SpMM and the attention have
        # none).
        blk16, q8 = narrow["A"]["bf16"], narrow["A"]["int8"]
        at16 = narrow["A^T"]["bf16"]
        csr16, csr_t16, pattern16 = (
            torch.sparse_csr_tensor(c_.crow_indices(), c_.col_indices(),
                                    c_.values().to(bf16), (m, m))
            for c_ in (csr, csr_t, pattern))
        timed.update({
            "spmm_bf16": (lambda: spmm_cuda(blk16, b16),
                          lambda: spmm_plain(blk16, b16),
                          lambda: torch.sparse.mm(csr16, b16)),
            "spmm_int8": (lambda: spmm_cuda(q8, b16),
                          lambda: spmm_plain(q8, b16), None),
            "spmm_bf16_At128": (lambda: spmm_cuda(at16, b16),
                                lambda: spmm_plain(at16, b16),
                                lambda: torch.sparse.mm(csr_t16, b16)),
            "spmm_bf16_At32": (lambda: spmm_cuda(at16, b32_16),
                               lambda: spmm_plain(at16, b32_16),
                               lambda: torch.sparse.mm(csr_t16, b32_16)),
            "sddmm_bf16": (lambda: sddmm_cuda(blk, h32_16, h32_16),
                           lambda: sddmm_plain(blk, h32_16, h32_16),
                           lambda: torch.sparse.sampled_addmm(
                               pattern16, h32_16, h32_16.T, beta=0.0)),
            "attention_bf16": (
                lambda: attention_cuda(blk, h32_16, h32_16, v32_16,
                                       scale=beta),
                lambda: attention_plain(blk, h32_16, h32_16, v32_16, beta),
                None),
        })
        # The precision variants of rows 3, 4, 7, 8, 9 (H = 12) and 10, and
        # row 4 in fp32 on A^T.  Their yardsticks take bf16 operands (bf16
        # COO and CSR tensors, masked SDPA at bf16); a refusal is recorded.
        bb16, bq8, bat16 = (bal16["A"]["bf16"], bal16["A"]["int8"],
                            bal16["A^T"]["bf16"])
        b16_2 = torch.stack([b16, b16.flip(0)])
        aprob16_coo, aprob_t16_coo = (
            torch.sparse_coo_tensor(c_.indices(), c_.values().to(bf16),
                                    c_.shape).coalesce()
            for c_ in (aprob_coo, aprob_t_coo))
        apattern16 = torch.sparse_csr_tensor(
            apattern.crow_indices(), apattern.col_indices(),
            apattern.values().to(bf16), apattern.shape)
        at_sched, a_sched = bplan.bwd_sched, abplan.fwd_sched
        timed.update({
            "spmm_batched_bf16": (
                lambda: spmm_batched_cuda(aprob16, av16),
                lambda: spmm_batched_plain(aprob16, av16),
                lambda: torch.bmm(aprob16_coo, av16)),
            "spmm_batched_bf16_At": (
                lambda: spmm_batched_cuda(aprob_t16, ag16),
                lambda: spmm_batched_plain(aprob_t16, ag16),
                lambda: torch.bmm(aprob_t16_coo, ag16)),
            "spmm_batched_int8": (
                lambda: spmm_batched_cuda(q8, b16_2),
                lambda: spmm_batched_plain(q8, b16_2), None),
            "sddmm_batched_bf16": (
                lambda: sddmm_batched_cuda(ablk, aq16, ak16),
                lambda: sddmm_batched_plain(ablk, aq16, ak16),
                lambda: torch.sparse.sampled_addmm(
                    apattern16, aq16, ak16.transpose(1, 2), beta=0.0)),
            "spmm_balanced_At128": (
                lambda: spmm_balanced_cuda(bplan.bwd, b, schedule=at_sched),
                lambda: spmm_balanced_plain(bplan.bwd, b, at_sched),
                lambda: torch.sparse.mm(csr_t, b)),
            "spmm_balanced_At32": (
                lambda: spmm_balanced_cuda(bplan.bwd, b32, schedule=at_sched),
                lambda: spmm_balanced_plain(bplan.bwd, b32, at_sched),
                lambda: torch.sparse.mm(csr_t, b32)),
            "spmm_balanced_bf16": (
                lambda: spmm_balanced_cuda(bb16, b16, schedule=bsched),
                lambda: spmm_balanced_plain(bb16, b16, bsched),
                lambda: torch.sparse.mm(csr16, b16)),
            "spmm_balanced_int8": (
                lambda: spmm_balanced_cuda(bq8, b16, schedule=bsched),
                lambda: spmm_balanced_plain(bq8, b16, bsched), None),
            "spmm_balanced_bf16_At128": (
                lambda: spmm_balanced_cuda(bat16, b16, schedule=at_sched),
                lambda: spmm_balanced_plain(bat16, b16, at_sched),
                lambda: torch.sparse.mm(csr_t16, b16)),
            "spmm_balanced_bf16_At32": (
                lambda: spmm_balanced_cuda(bat16, b32_16, schedule=at_sched),
                lambda: spmm_balanced_plain(bat16, b32_16, at_sched),
                lambda: torch.sparse.mm(csr_t16, b32_16)),
            "sddmm_balanced_bf16": (
                lambda: sddmm_balanced_cuda(bblk, h32_16, h32_16,
                                            schedule=bsched),
                lambda: sddmm_balanced_plain(bblk, h32_16, h32_16, bsched),
                lambda: torch.sparse.sampled_addmm(pattern16, h32_16,
                                                   h32_16.T, beta=0.0)),
            "attention_balanced_bf16": (
                lambda: attention_balanced_cuda(bblk, h32_16, h32_16, v32_16,
                                                scale=beta, schedule=bsched),
                lambda: attention_balanced_plain(bblk, h32_16, h32_16,
                                                 v32_16, bsched, beta),
                None),
            "attention_balanced_bf16_h12": (
                lambda: attention_balanced_cuda(abplan.fwd, aq16, ak16, av16,
                                                scale=att["scale"],
                                                schedule=a_sched),
                lambda: attention_balanced_plain(abplan.fwd, aq16, ak16,
                                                 av16, a_sched, att["scale"]),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    aq16[None], ak16[None], av16[None], attn_mask=amask,
                    scale=att["scale"])),
            "attention_bf16_h12": (
                lambda: attention_cuda(ablk, aq16, ak16, av16,
                                       scale=att["scale"]),
                lambda: attention_plain(ablk, aq16, ak16, av16, att["scale"]),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    aq16[None], ak16[None], av16[None], attn_mask=amask,
                    scale=att["scale"])),
        })
        ms, lib_errors = {}, {}
        for name, (kern, plain_fn, lib_fn) in timed.items():
            lib_ms = None
            if lib_fn is not None:
                try:
                    lib_ms = cuda_ms(lib_fn)
                except (RuntimeError, NotImplementedError) as exc:
                    lib_errors[name] = str(exc).strip().splitlines()[0][:240]
            ms[name] = (cuda_ms(kern), cuda_ms(plain_fn, reps=3, batch=3),
                        lib_ms)
            print(f"  {name}: kernel {ms[name][0]:.4f} ms, plain "
                  f"{ms[name][1]:.4f} ms, library {ms[name][2]} ms"
                  + (f" (refused: {lib_errors[name]})"
                     if name in lib_errors else ""))
        # What holds the SDDMM tile (rows 6-8) off its bound: row 6 on the
        # Amazon A with its column ids folded into K's first 8,192 rows
        # (every K gather then hits L1 or L2) against the real gathers, and
        # a device copy that reads and writes as many bytes as the bound
        # counts (the rate a plain stream gets from this card's HBM).
        folded = dataclasses.replace(blk, cols=blk.cols % 8192)
        stream = torch.empty(
            (read_once(h32, blk.mask, blk.cols, blk.block_win)
             + blk.cols.shape[0] * blk.vector_size * 4) // 8,
            dtype=torch.float32, device=DEVICE)
        diag = {"sddmm_ms": ms["sddmm"][0], "sddmm_bf16_ms": ms["sddmm_bf16"][0],
                "sddmm_folded_ms": cuda_ms(
                    lambda: sddmm_cuda(folded, h32, h32)),
                "sddmm_bf16_folded_ms": cuda_ms(
                    lambda: sddmm_cuda(folded, h32_16, h32_16)),
                "copy_of_bound_bytes_ms": cuda_ms(lambda: stream.clone())}
        del folded, stream
        e2e["sddmm_tile_diagnosis"] = diag
        print("  SDDMM tile on the Amazon A, F=32: " + ", ".join(
            f"{k_} {v_:.4f}" for k_, v_ in diag.items()))
        # The transpose SpMM (dB, dK) on Aᵀ, whose hub columns of A are
        # hub windows, window-parallel (timed above) against block-parallel,
        # and its bound.
        for n_cols, bb in ((128, b), (32, b32)):
            t_win, _, t_lib = ms[f"spmm_At{n_cols}"]
            t_bal = cuda_ms(lambda: spmm_balanced_cuda(
                bplan.bwd, bb, schedule=bplan.bwd_sched))
            t_bound = bound(read_once(plan.bwd.vals, plan.bwd.cols,
                                      plan.bwd.win_ptr, bb)
                            + bb.numel() * 4, 2 * nnz_all * n_cols)[0]
            print(f"  transpose SpMM on A^T, N={n_cols}: window-parallel "
                  f"{t_win:.4f} ms, balanced (split_blk=1) {t_bal:.4f} ms, "
                  f"torch.sparse.mm {t_lib:.4f} ms; bound {t_bound:.4f} ms")
            e2e[f"spmm_transpose_n{n_cols}"] = {
                "cuda_ms": t_win, "balanced_ms": t_bal, "library_ms": t_lib,
                "bound_ms": t_bound}
        # The attention backward's dV = P^T @ G on A^T, whose global-key
        # windows hold up to 2,048 K-blocks: head grid against balanced.
        t_win, _, t_lib = ms["spmm_batched_At"]
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
              + f", torch.bmm {t_lib:.4f} ms; bound {dv_bound[0]:.4f} ms "
              f"({dv_bound[1]})")
        e2e["attention_dv_transpose"] = {"cuda_batched_ms": t_win,
                                         "balanced_ms": t_bal,
                                         "library_ms": t_lib,
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
    # the precision modes on each route: a train step and a forward each
    for (name, impl), (net, step, adj, xx) in narrow_nets.items():
        torch.cuda.reset_peak_memory_stats()
        t_step = cuda_ms(lambda: step(adj, xx, labels, train_mask), reps=3,
                         batch=2, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        train[f"{name}_{impl}"].update(step_ms=t_step, peak_bytes=peak)
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            t_fwd = cuda_ms(lambda: net(adj, xx), batch=2, warmup=1)
        e2e[f"{name}_{impl}_forward"] = {
            "ms": t_fwd, "peak_bytes": torch.cuda.max_memory_allocated()}
        print(f"  {name}/{impl}: train step {t_step:.3f} ms (peak memory "
              f"{peak / 2**30:.3f} GiB), forward {t_fwd:.3f} ms")

    # Multi-head attention: a forward of each route, and one
    # value-projection SGD step (loss, dloss/dW, update) of each.
    with torch.no_grad():
        vp_target = attn_blocked()
    vp_w = torch.from_numpy(initial_w(ATTN_DIM)).to(DEVICE)

    with torch.no_grad():
        vp_target16 = sparse_attention(aplan16, bq, bk, bv, impl="blocked")

    def vp_step(plan_, impl, staged, bf16_plan=False):
        qq, kk, vv, target = ((bq, bk, bv, vp_target16) if bf16_plan
                              else (aq, ak, av, vp_target))
        w_leaf = vp_w.detach().requires_grad_(True)
        loss = value_projection_loss(plan_, qq, kk, vv, w_leaf, target,
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
    # the same under the bf16 plans (4g), forward and step
    for name in attn16:
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            t_fwd = cuda_ms(lambda: attend16(name), reps=3, batch=2,
                            warmup=1)
        e2e[f"attention_bf16_{name}"] = {
            "ms": t_fwd, "peak_bytes": torch.cuda.max_memory_allocated()}
        torch.cuda.reset_peak_memory_stats()
        t_step = cuda_ms(lambda: vp_step(*attn16[name], bf16_plan=True),
                         reps=3, batch=2, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        attn16_result[name].update(step_ms=t_step, peak_bytes=peak)
        print(f"  bf16 attention {name}: forward {t_fwd:.3f} ms, "
              f"value-projection step {t_step:.3f} ms, peak memory "
              f"{peak / 2**30:.3f} GiB")

    phase("6. where the time goes (torch.profiler, one forward or step each)")
    with torch.inference_mode():
        for name, (run, _, _) in runs.items():
            print(f"  {name} forward:")
            e2e[name].update(profile_run(run))
    for (model, impl), (net, step) in nets.items():
        print(f"  train step {model}/{impl}:")
        train[f"{model}_{impl}"].update(profile_run(
            lambda: step(adjs[impl], x, labels, train_mask)))
    for (name, impl), (net, step, adj, xx) in narrow_nets.items():
        print(f"  train step {name}/{impl}:")
        train[f"{name}_{impl}"].update(profile_run(
            lambda: step(adj, xx, labels, train_mask)))
        print(f"  forward {name}/{impl}:")
        with torch.inference_mode():
            e2e[f"{name}_{impl}_forward"].update(
                profile_run(lambda: net(adj, xx)))
    for name, (run, _) in attn_fwd.items():
        print(f"  attention forward {name}:")
        with torch.inference_mode():
            e2e[f"attention_{name}"].update(profile_run(run))
    for name, (plan_, impl, staged) in attn_steps.items():
        print(f"  attention value-projection step {name}:")
        attn_result[name].update(profile_run(
            lambda: vp_step(plan_, impl, staged)))
    for name in attn16:
        print(f"  bf16 attention forward {name}:")
        with torch.inference_mode():
            e2e[f"attention_bf16_{name}"].update(
                profile_run(lambda: attend16(name)))
        print(f"  bf16 attention value-projection step {name}:")
        attn16_result[name].update(profile_run(
            lambda: vp_step(*attn16[name], bf16_plan=True)))

    v = blk.vector_size
    # Each distinct input read once (the main path passes Q and K as one
    # tensor, AGNN's q = k = ĥ, counted once), the output written once, and
    # for the balanced kernels the schedule arrays they read (the run plan
    # of the run-carried SpMM and attention); never the balanced kernels'
    # own scratch partials.
    def split_ids(blocked, n_cols):
        n_tile = min(128, max(32, -(-n_cols // 32) * 32))
        return window_plan("chip_smoke", blocked.win_ptr, SPLIT_BLK,
                           n_tile).split_ids

    bal_plans = {name: run_plan("chip_smoke", bsched, bblk.num_windows, r_)
                 for name, r_ in (("spmm_balanced", SPMM_RUN),
                                  ("attention_balanced", ATTN_RUN))}
    plan_arrays = {name: (pl.run_ptr, pl.pieces)
                   for name, pl in bal_plans.items()}
    at_pl = run_plan("chip_smoke", at_sched, bplan.bwd.num_windows, SPMM_RUN)
    h12_pl = run_plan("chip_smoke", a_sched, abplan.fwd.num_windows, ATTN_RUN)
    at_plan = (at_pl.run_ptr, at_pl.pieces)
    h12_plan = (h12_pl.run_ptr, h12_pl.pieces)
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
        # the window-parallel SpMM on the transposes, with its window plan
        "spmm_At128": (read_once(plan.bwd.vals, plan.bwd.cols,
                                 plan.bwd.win_ptr, b, split_ids(plan.bwd, 128))
                       + m * 128 * 4),
        "spmm_At32": (read_once(plan.bwd.vals, plan.bwd.cols,
                                plan.bwd.win_ptr, b32, split_ids(plan.bwd, 32))
                      + m * 32 * 4),
        "spmm_batched_At": (read_once(aprobs_t, aplan.bwd.cols,
                                      aplan.bwd.win_ptr, ag,
                                      split_ids(aplan.bwd, ATTN_DIM))
                            + ag.numel() * 4),
        # the precision variants: 2-byte values, B, Q, K, V and outputs;
        # int8 values at one byte with one fp32 scale per K-block
        "spmm_bf16": (read_once(blk16.vals, blk.cols, blk.win_ptr, b16)
                      + m * 128 * 2),
        "spmm_int8": (read_once(q8.vals, q8.scales, blk.cols, blk.win_ptr,
                                b16) + m * 128 * 2),
        "spmm_bf16_At128": (read_once(at16.vals, plan.bwd.cols,
                                      plan.bwd.win_ptr, b16,
                                      split_ids(plan.bwd, 128))
                            + m * 128 * 2),
        "spmm_bf16_At32": (read_once(at16.vals, plan.bwd.cols,
                                     plan.bwd.win_ptr, b32_16,
                                     split_ids(plan.bwd, 32))
                           + m * 32 * 2),
        "sddmm_bf16": (read_once(h32_16, h32_16, blk.mask, blk.cols,
                                 blk.block_win) + nnzp * v * 2),
        "attention_bf16": (read_once(h32_16, h32_16, v32_16, beta, blk.mask,
                                     blk.cols, blk.win_ptr) + m * 32 * 2),
        # rows 3, 4, 7, 8, 9 (H = 12) and 10 at bf16 / int8, and row 4 in
        # fp32 on A^T, each with the arrays of its run or window plan
        "spmm_batched_bf16": (read_once(aprob16.vals, ablk.cols,
                                        ablk.win_ptr, av16)
                              + av16.numel() * 2),
        "spmm_batched_bf16_At": (read_once(aprob_t16.vals, aplan.bwd.cols,
                                           aplan.bwd.win_ptr, ag16,
                                           split_ids(aplan.bwd, ATTN_DIM))
                                 + ag16.numel() * 2),
        "spmm_batched_int8": (read_once(q8.vals, q8.scales, blk.cols,
                                        blk.win_ptr, b16_2) + 2 * m * 128 * 2),
        "sddmm_batched_bf16": (read_once(aq16, ak16, ablk.mask, ablk.cols,
                                         ablk.block_win)
                               + aprobs.numel() * 2),
        "spmm_balanced_At128": (read_once(bplan.bwd.vals, bplan.bwd.cols, b,
                                          *at_plan) + m * 128 * 4),
        "spmm_balanced_At32": (read_once(bplan.bwd.vals, bplan.bwd.cols, b32,
                                         *at_plan) + m * 32 * 4),
        "spmm_balanced_bf16": (read_once(bb16.vals, bblk.cols, b16,
                                         *plan_arrays["spmm_balanced"])
                               + m * 128 * 2),
        "spmm_balanced_int8": (read_once(bq8.vals, bq8.scales, bblk.cols, b16,
                                         *plan_arrays["spmm_balanced"])
                               + m * 128 * 2),
        "spmm_balanced_bf16_At128": (read_once(bat16.vals, bplan.bwd.cols,
                                               b16, *at_plan) + m * 128 * 2),
        "spmm_balanced_bf16_At32": (read_once(bat16.vals, bplan.bwd.cols,
                                              b32_16, *at_plan) + m * 32 * 2),
        "sddmm_balanced_bf16": (read_once(h32_16, h32_16, bblk.mask,
                                          bblk.cols, bsched.blk_id,
                                          bsched.blk_win) + nnzp * v * 2),
        "attention_balanced_bf16": (
            read_once(h32_16, h32_16, v32_16, beta, bblk.mask, bblk.cols,
                      *plan_arrays["attention_balanced"]) + m * 32 * 2),
        "attention_balanced_bf16_h12": (
            read_once(aq16, ak16, av16, abplan.fwd.mask, abplan.fwd.cols,
                      *h12_plan) + av16.numel() * 2),
        "attention_bf16_h12": (read_once(aq16, ak16, av16, ablk.mask,
                                         ablk.cols, ablk.win_ptr)
                               + av16.numel() * 2),
    }
    # Operations on the true nonzeros only: the padded and masked-off
    # slots of a block are the format's, not the function's.
    annzp, hd = ablk.vals.shape[0], ATTN_HEADS * ATTN_DIM
    nnz, annz = int(blk.mask.sum()), int(ablk.mask.sum())
    flops = {"spmm": 2 * nnz * 128, "sddmm": 2 * nnz * 32,
             "attention": 2 * nnz * (32 + 32),
             "spmm_batched": 2 * annz * hd,
             "sddmm_batched": 2 * annz * hd,
             "attention_h12": 2 * annz * 2 * hd,
             "spmm_At128": 2 * nnz * 128, "spmm_At32": 2 * nnz * 32,
             "spmm_batched_At": 2 * annz * hd}
    for name in ("spmm", "sddmm", "attention"):
        flops[f"{name}_balanced"] = flops[name]
    for name in ("spmm_noncoalesced", "spmm_staged", "spmm_bf16",
                 "spmm_int8"):
        flops[name] = flops["spmm"]
    flops.update(spmm_bf16_At128=flops["spmm_At128"],
                 spmm_bf16_At32=flops["spmm_At32"], sddmm_bf16=flops["sddmm"],
                 attention_bf16=flops["attention"])
    flops.update(spmm_batched_bf16=flops["spmm_batched"],
                 spmm_batched_bf16_At=flops["spmm_batched_At"],
                 spmm_batched_int8=2 * flops["spmm"],
                 sddmm_batched_bf16=flops["sddmm_batched"],
                 spmm_balanced_At128=flops["spmm_At128"],
                 spmm_balanced_At32=flops["spmm_At32"],
                 spmm_balanced_bf16=flops["spmm"],
                 spmm_balanced_int8=flops["spmm"],
                 spmm_balanced_bf16_At128=flops["spmm_At128"],
                 spmm_balanced_bf16_At32=flops["spmm_At32"],
                 sddmm_balanced_bf16=flops["sddmm"],
                 attention_balanced_bf16=flops["attention"],
                 attention_balanced_bf16_h12=flops["attention_h12"],
                 attention_bf16_h12=flops["attention_h12"])
    # Tensor-core operations of the fp32 fused attention at the TF32 rate:
    # three TF32 products per multiply (3xTF32).
    tc_flops = {"attention": TF32_PRODUCTS * flops["attention"],
                "attention_h12": TF32_PRODUCTS * flops["attention_h12"]}
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
    for n_cols, key in ((128, "At_n128"), (32, "At_n32")):
        shapes[f"spmm_At{n_cols}"] = dict(
            shapes["spmm"], N=n_cols, NNZP=int(plan.bwd.vals.shape[0]),
            operand="A^T", window_plan=windows[key])
    shapes["spmm_batched_At"] = dict(
        shapes["spmm_batched"], NNZP=int(aplan.bwd.vals.shape[0]),
        operand="A^T (dV = P^T G)", window_plan=windows["attention_At_n64"])
    shapes.update(
        spmm_bf16=dict(shapes["spmm"], dtypes="bf16 vals, B and C"),
        spmm_int8=dict(shapes["spmm"], dtypes="int8 vals with fp32 per-K-block "
                       "scales, bf16 B and C"),
        sddmm_bf16=dict(shapes["sddmm"], dtypes="bf16 Q, K and S"),
        attention_bf16=dict(shapes["attention"], dtypes="bf16 Q, K, V, out"))
    for n_cols in (128, 32):
        shapes[f"spmm_bf16_At{n_cols}"] = dict(
            shapes[f"spmm_At{n_cols}"], dtypes="bf16 vals, B and C")
        shapes[f"spmm_balanced_At{n_cols}"] = dict(
            shapes[f"spmm_At{n_cols}"], split_blk=1,
            segments=at_sched.num_segments, run_blk=SPMM_RUN)
        shapes[f"spmm_balanced_bf16_At{n_cols}"] = dict(
            shapes[f"spmm_balanced_At{n_cols}"], dtypes="bf16 vals, B and C")
    shapes.update(
        spmm_batched_bf16=dict(shapes["spmm_batched"],
                               dtypes="bf16 vals, B and C"),
        spmm_batched_bf16_At=dict(shapes["spmm_batched_At"],
                                  dtypes="bf16 vals, B and C"),
        spmm_batched_int8=dict(shapes["spmm"], H=2, per_head="B",
                               dtypes="int8 vals shared by the heads with "
                               "fp32 per-K-block scales, bf16 B and C"),
        sddmm_batched_bf16=dict(shapes["sddmm_batched"],
                                dtypes="bf16 Q, K and S"),
        spmm_balanced_bf16=dict(shapes["spmm_balanced"],
                                dtypes="bf16 vals, B and C"),
        spmm_balanced_int8=dict(shapes["spmm_balanced"],
                                dtypes="int8 vals with fp32 per-K-block "
                                "scales, bf16 B and C"),
        sddmm_balanced_bf16=dict(shapes["sddmm_balanced"],
                                 dtypes="bf16 Q, K and S"),
        attention_balanced_bf16=dict(shapes["attention_balanced"],
                                     dtypes="bf16 Q, K, V, out"),
        attention_balanced_bf16_h12=dict(
            shapes["attention_h12"], split_blk=1,
            segments=a_sched.num_segments, run_blk=ATTN_RUN,
            dtypes="bf16 Q, K, V, out"),
        attention_bf16_h12=dict(shapes["attention_h12"],
                                dtypes="bf16 Q, K, V, out"))

    def measured(name):
        kernel_ms, plain_ms, library_ms = ms[name]
        row = {"shape": shapes[name], "max_abs_err": err[name],
               "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bytes": nbytes[name],
               "flops": flops[name]}
        if name in tc_flops:
            # the fused attention's products run on the tensor cores (see
            # tc_flops); beside that bound, the one at the fp32 rate of the
            # CUDA cores
            b_ms, b_by = bound(nbytes[name], tc_flops[name],
                               TF32_FLOPS_PER_S)
            row.update(bound_peak="TF32 tensor cores, 495 TFLOP/s, "
                       f"{tc_flops[name] / flops[name]:.1f} products per "
                       "multiply",
                       bound_fp32_ms=bound(nbytes[name], flops[name])[0],
                       bound_fp32_by=bound(nbytes[name], flops[name])[1])
        elif "bf16" in name or "int8" in name:
            b_ms, b_by = bound(nbytes[name], flops[name], BF16_FLOPS_PER_S)
            row["bound_peak"] = "bf16 tensor cores, 989 TFLOP/s"
        else:
            b_ms, b_by = bound(nbytes[name], flops[name])
        row.update(bound_ms=b_ms, bound_by=b_by)
        if name in lib_errors:
            row["library_error"] = lib_errors[name]
        return row

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
        if name == "spmm":
            # the transpose SpMM (dB) of the train steps, on A^T
            row["At"] = {"n128": measured("spmm_At128"),
                         "n32": measured("spmm_At32")}
        if name == "spmm_batched":
            # the attention backward's dV on the pattern's transpose
            row["At"] = measured("spmm_batched_At")
        if name == "spmm_bf16":
            # the transpose SpMM (dB) of the bf16 and int8-plan train steps
            row["At"] = {"n128": measured("spmm_bf16_At128"),
                         "n32": measured("spmm_bf16_At32")}
        if name in ("spmm_balanced", "spmm_balanced_bf16"):
            # the balanced route's transpose SpMM (dB), split_blk = 1
            row["At"] = {"n128": measured(f"{name}_At128"),
                         "n32": measured(f"{name}_At32")}
        if name == "spmm_batched_bf16":
            # the bf16 attention backward's dV on the pattern's transpose
            row["At"] = measured("spmm_batched_bf16_At")
        if name in ("attention_bf16", "attention_balanced_bf16"):
            # the 12-head attention at bf16, beside the one-head (AGNN)
            # numbers above
            row["h12"] = measured(f"{name}_h12")
        rows.append(row)
    for name, n_launch in launches.items():
        if n_launch == 0:
            raise SystemExit(f"FAIL: the {name} kernel never ran on the main path")

    print(json.dumps({"end_to_end": e2e, "training": train,
                      "sparse_attention": attn_result,
                      "sparse_attention_bf16": attn16_result,
                      "attention_wide": wide,
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

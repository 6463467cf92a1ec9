#!/usr/bin/env python3
"""Drive the PyTorch port of FlashSparse on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root, one card

It imports only ``repro_torch`` (from ``src/``), never JAX, and fails with
a non-zero exit at the first phase that fails:

  1. the card: name and power limit (``nvidia-smi``);
  2. build: ``nvcc`` compiles ``src/repro_torch/kernels/csrc/*.cu`` for
     sm_90a, one process per source; ``-Xptxas -v``'s register,
     shared-memory and spill lines;
  3. each kernel against its plain PyTorch version on the card: (a) on
     edge cases, the balanced kernels over schedules split at
     split_blk in {0, 1, 3} with one and two heads, shared and per-head
     operands, and the all-empty matrix (no balanced SDDMM launch);
     (b) at the main path's shapes on the Amazon replica, the balanced
     kernels over the schedules of A and of its transpose;
  4. inference: GCN (5 x 128) and AGNN (hidden 32, 5 layers) on
     ``make_dataset("Amazon", 1.0, seed=0)`` over the ``cuda`` plan, the
     bare blocked format and the ``cuda_balanced`` plan, each held against
     the same model with the plain ``blocked`` impl, with the kernels'
     launch counters read around each forward;
     4b. training: the gradients of ``spmm_ad``, ``sddmm_ad`` and
     ``attention_ad`` (β's included) under a random cotangent on both
     routes against ``blocked``; three steps of each model on ``cuda`` and
     ``cuda_balanced`` through ``make_gnn_train_step``; the first step's
     loss and gradients against the same step with ``blocked``, a finite
     decreasing loss, and the launch counters against the counts that the
     layers and the gradients the step needs give;
  5. timing with CUDA events: each kernel, its plain version and one
     PyTorch library call computing the same function (a yardstick the port
     never calls), the balanced kernels at split_blk in {1, 8, 32}, each
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
                errs.append(max(
                    compare(f"spmm_balanced {tag}",
                            spmm_balanced_cuda(bv, bh, schedule=sched),
                            spmm_balanced_plain(bv, bh, sched),
                            KERNEL_RTOL, KERNEL_ATOL, show=False),
                    compare(f"sddmm_balanced {tag}",
                            sddmm_balanced_cuda(blocked, qh, kk,
                                                schedule=sched),
                            sddmm_balanced_plain(blocked, qh, kk, sched),
                            KERNEL_RTOL, KERNEL_ATOL, show=False),
                    compare(f"attention_balanced {tag}",
                            attention_balanced_cuda(blocked, qh, kk, vh,
                                                    scale=beta,
                                                    schedule=sched),
                            attention_balanced_plain(blocked, qh, kk, vh,
                                                     sched, beta),
                            KERNEL_RTOL, KERNEL_ATOL, show=False)))
        sddmm_launched = sddmm_balanced_cuda.launches - sddmm_before
        print(f"  ok   balanced x3 [{label}], split_blk 0/1/3 x H 1/2: max abs "
              f"err {max(errs):.3e}; balanced SDDMM launches {sddmm_launched}",
              flush=True)
        if a.any() != (sddmm_launched == 6):
            raise SystemExit(f"FAIL [{label}]: {sddmm_launched} balanced SDDMM "
                             "launches (6 expected, 0 for the all-empty matrix)")
    torch.cuda.synchronize()


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
                                     sddmm_balanced_plain, sddmm_cuda,
                                     sddmm_plain, spmm_balanced_cuda,
                                     spmm_balanced_plain, spmm_cuda,
                                     spmm_plain)
    from repro_torch.kernels._combine import combine_tree
    from repro_torch.models.gnn import (AGNN, GCN, GNNConfig, agnn_forward,
                                        gcn_forward, gnn_loss)
    from repro_torch.sparse.graphs import make_dataset
    from repro_torch.train.gnn_train import make_task
    from repro_torch.train.train_step import make_gnn_train_step

    wrappers = {"spmm": spmm_cuda, "sddmm": sddmm_cuda,
                "attention": attention_cuda,
                "spmm_balanced": spmm_balanced_cuda,
                "sddmm_balanced": sddmm_balanced_cuda,
                "attention_balanced": attention_balanced_cuda}

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
              f"{int((per_win > 1).sum())} split windows, combine tree of "
              f"{len(combine_tree('chip_smoke', sc, bl.num_windows).levels)}"
              " levels")
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

    phase("5. timing (CUDA events around back-to-back calls, median of runs)")
    csr = torch.sparse_coo_tensor(
        torch.from_numpy(np.stack([g.rows, g.cols])),
        torch.from_numpy(g.vals), (m, m)).coalesce().to_sparse_csr().to(DEVICE)
    pattern = torch.sparse_csr_tensor(csr.crow_indices(), csr.col_indices(),
                                      torch.ones_like(csr.values()), (m, m))
    bblk, bsched = bplan.fwd, bplan.fwd_sched
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
        sweep = {}
        for split in (1, 8, 32):
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
                "segments_A": fs.num_segments, "segments_At": ts.num_segments,
            }
            print(f"  split_blk={split}: " + ", ".join(
                f"{k_} {v_:.4f} ms" if isinstance(v_, float) else f"{k_} {v_}"
                for k_, v_ in sweep[split].items()))
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

    phase("6. where the time goes (torch.profiler, one forward or step each)")
    with torch.inference_mode():
        for name, (run, _, _) in runs.items():
            print(f"  {name} forward:")
            e2e[name].update(profile_run(run))
    for (model, impl), (net, step) in nets.items():
        print(f"  train step {model}/{impl}:")
        train[f"{model}_{impl}"].update(profile_run(
            lambda: step(adjs[impl], x, labels, train_mask)))

    v = blk.vector_size
    # Each distinct input read once (the main path passes Q and K as one
    # tensor, AGNN's q = k = ĥ, counted once), the output written once, and
    # for the balanced kernels the schedule arrays they read; never the
    # balanced kernels' own scratch partials.
    sched_meta = (bsched.seg_win, bsched.seg_meta)
    nbytes = {
        "spmm": read_once(blk.vals, blk.cols, blk.win_ptr, b) + m * 128 * 4,
        "sddmm": (read_once(h32, h32, blk.mask, blk.cols, blk.block_win)
                  + nnzp * v * 4),
        "attention": (read_once(h32, h32, v32, beta, blk.mask, blk.cols,
                                blk.win_ptr)
                      + m * 32 * 4),
        "spmm_balanced": (read_once(bblk.vals, bblk.cols, b, *sched_meta)
                          + m * 128 * 4),
        "sddmm_balanced": (read_once(h32, h32, bblk.mask, bblk.cols,
                                     bsched.blk_id, bsched.blk_win)
                           + nnzp * v * 4),
        "attention_balanced": (read_once(h32, h32, v32, beta, bblk.mask,
                                         bblk.cols, *sched_meta)
                               + m * 32 * 4),
    }
    flops = {"spmm": 2 * nnzp * v * 128, "sddmm": 2 * nnzp * v * 32,
             "attention": 2 * nnzp * v * (32 + 32)}
    for name in ("spmm", "sddmm", "attention"):
        flops[f"{name}_balanced"] = flops[name]
    shapes = {
        "spmm": {"M": m, "K": m, "N": 128, "NNZP": nnzp, "V": v, "k_blk": 8},
        "sddmm": {"M": m, "F": 32, "NNZP": nnzp, "V": v, "k_blk": 8},
        "attention": {"M": m, "D": 32, "DV": 32, "NNZP": nnzp, "V": v,
                      "k_blk": 8},
    }
    for name in ("spmm", "sddmm", "attention"):
        shapes[f"{name}_balanced"] = dict(
            shapes[name], split_blk=1, segments=bsched.num_segments)
    rows = []
    for name, (route, impl, source, replaces) in KERNELS.items():
        b_ms, b_by = bound(nbytes[name], flops[name])
        kernel_ms, plain_ms, library_ms = ms[name]
        # "route" is the kind of kernel (hand-written CUDA C++); "impl" the
        # registry impl whose path launches it.
        rows.append({"name": name, "route": route, "impl": impl,
                     "source": source,
                     "replaces": replaces, "tpu_kernel": replaces,
                     "launches": launches[name], "shape": shapes[name],
                     "max_abs_err": err[name], "ms": kernel_ms,
                     "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "bytes": nbytes[name],
                     "flops": flops[name]})
    for name, n_launch in launches.items():
        if n_launch == 0:
            raise SystemExit(f"FAIL: the {name} kernel never ran on the main path")

    print(json.dumps({"end_to_end": e2e, "training": train,
                      "split_blk_sweep": sweep, "card": card,
                      "seconds": round(time.time() - t_start, 1)}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

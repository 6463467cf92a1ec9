#!/usr/bin/env python3
"""Drive the PyTorch port of FlashSparse on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root, one card

It imports only ``repro_torch`` (from ``src/``), never JAX, and fails with
a non-zero exit at the first phase that fails:

  1. the card: name and power limit (``nvidia-smi``);
  2. build: ``nvcc`` compiles ``src/repro_torch/kernels/csrc/*.cu`` for
     sm_90a; ``-Xptxas -v``'s register, shared-memory and spill lines;
  3. each kernel against its plain PyTorch version on the card, at the main
     path's shapes (the Amazon replica, N = 128 for SpMM, F = D = DV = 32
     for SDDMM and attention) and on edge cases;
  4. end to end: GCN (5 x 128) and AGNN (hidden 32, 5 layers, over the
     ADPlan and over the bare blocked format) inference on
     ``make_dataset("Amazon", 1.0, seed=0)`` with the ``cuda`` impl, each
     held against the same model with the plain ``blocked`` impl on the
     card, with the kernels' launch counters read around each forward;
  5. timing with CUDA events: each kernel, its plain version and one
     PyTorch library call computing the same function (a yardstick the port
     never calls), and each end-to-end forward with its peak memory;
  6. where the time goes: ``torch.profiler`` over one forward of each
     model, device time by kernel and the device's idle share.

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
# H100 SXM data sheet: device memory rate and fp32 rate outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

DEVICE = "cuda"
SCALE = 1.0  # the Amazon replica at full size

KERNELS = {
    "spmm": ("src/repro_torch/kernels/csrc/spmm.cu",
             "src/repro/kernels/spmm_pallas.py:110"),
    "sddmm": ("src/repro_torch/kernels/csrc/sddmm.cu",
              "src/repro/kernels/sddmm_pallas.py:49"),
    "attention": ("src/repro_torch/kernels/csrc/attention.cu",
                  "src/repro/kernels/attention_pallas.py:58"),
}


def phase(name: str) -> None:
    print(f"\n=== {name}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def compare(label: str, out, ref, rtol: float, atol: float) -> float:
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


def profile_forward(run) -> dict:
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


def make_task(num_nodes: int, seed: int, num_classes: int, in_dim: int):
    """Node features and labels as ``examples/gnn_train.py`` makes them."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=num_nodes)
    centers = rng.standard_normal((num_classes, in_dim)).astype(np.float32)
    x = centers[labels] + 0.5 * rng.standard_normal(
        (num_nodes, in_dim)).astype(np.float32)
    train_mask = (rng.random(num_nodes) < 0.7).astype(np.float32)
    return x, labels.astype(np.int64), train_mask


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
    from repro_torch.kernels import (attention_cuda, attention_plain,
                                     sddmm_cuda, sddmm_plain, spmm_cuda,
                                     spmm_plain)

    for label, a, v, k_blk, n, f, dv in kernel_cases(rng):
        blocked = block_format(from_dense(a, vector_size=v), k_blk,
                               device=DEVICE)
        m, k = a.shape
        b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(DEVICE)
        compare(f"spmm [{label}]", spmm_cuda(blocked, b), spmm_plain(blocked, b),
                KERNEL_RTOL, KERNEL_ATOL)
        q = torch.from_numpy(rng.standard_normal((m, f)).astype(np.float32)).to(DEVICE)
        kk = torch.from_numpy(rng.standard_normal((k, f)).astype(np.float32)).to(DEVICE)
        compare(f"sddmm [{label}, F={f}]", sddmm_cuda(blocked, q, kk),
                sddmm_plain(blocked, q, kk), KERNEL_RTOL, KERNEL_ATOL)
        vv = torch.from_numpy(rng.standard_normal((k, dv)).astype(np.float32)).to(DEVICE)
        compare(f"attention [{label}, D={f}, DV={dv}]",
                attention_cuda(blocked, q, kk, vv),
                attention_plain(blocked, q, kk, vv), KERNEL_RTOL, KERNEL_ATOL)
    torch.cuda.synchronize()


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script runs the port on a CUDA card only")

    from repro_torch.core.autodiff import ad_plan
    from repro_torch.core.format import from_coo
    from repro_torch.kernels import (_build, attention_cuda, attention_plain,
                                     sddmm_cuda, sddmm_plain, spmm_cuda,
                                     spmm_plain)
    from repro_torch.models.gnn import (AGNN, GCN, GNNConfig, agnn_forward,
                                        gcn_forward, gnn_loss)
    from repro_torch.sparse.graphs import make_dataset

    wrappers = {"spmm": spmm_cuda, "sddmm": sddmm_cuda,
                "attention": attention_cuda}

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

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
    blk = plan.fwd
    m = g.num_nodes
    nnzp = blk.vals.shape[0]
    print(f"  Amazon replica, scale {SCALE}: {m} nodes, {fmt.nnz} nonzeros, "
          f"{blk.num_windows} windows, {fmt.nnzv} nonzero vectors, "
          f"{blk.num_blocks} K-blocks, NNZP={nnzp}; graph {t_graph:.1f} s, "
          f"format + plan {t_format:.1f} s on the host")
    b = torch.from_numpy(rng.standard_normal((m, 128)).astype(np.float32)).to(DEVICE)
    h32 = unit_rows(rng, m, 32).to(DEVICE)
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
    torch.cuda.synchronize()

    phase("4. end to end: GCN and AGNN inference on the Amazon replica")
    x_np, labels_np, train_np = make_task(m, 0, 16, 128)
    x = torch.from_numpy(x_np).to(DEVICE)
    labels = torch.from_numpy(labels_np).to(DEVICE)
    train_mask = torch.from_numpy(train_np).to(DEVICE)
    gcn_cfg = GNNConfig(model="gcn", in_dim=128, hidden_dim=128,
                        num_classes=16, num_layers=5, impl="cuda")
    agnn_cfg = GNNConfig(model="agnn", in_dim=128, hidden_dim=32,
                         num_classes=16, num_layers=5, impl="cuda")
    gcn = GCN(gcn_cfg, device=DEVICE, seed=0)
    agnn = AGNN(agnn_cfg, device=DEVICE, seed=1)
    plain = {"gcn": dataclasses.replace(gcn_cfg, impl="blocked"),
             "agnn": dataclasses.replace(agnn_cfg, impl="blocked")}
    runs = {
        "gcn_plan": (lambda: gcn(plan, x),
                     lambda: gcn_forward(gcn.params(), plan, x, plain["gcn"]),
                     {"spmm": 5, "sddmm": 0, "attention": 0}),
        "agnn_plan": (lambda: agnn(plan, x),
                      lambda: agnn_forward(agnn.params(), plan, x,
                                           plain["agnn"]),
                      {"spmm": 0, "sddmm": 0, "attention": 5}),
        "agnn_blocked": (lambda: agnn(blk, x),
                         lambda: agnn_forward(agnn.params(), blk, x,
                                              plain["agnn"]),
                         {"spmm": 5, "sddmm": 5, "attention": 0}),
    }
    launches = {name: 0 for name in wrappers}
    outs = {}
    with torch.inference_mode():
        for name, (run, ref_run, expect) in runs.items():
            reset_counts()
            out = run()
            torch.cuda.synchronize()
            got = counts()
            print(f"  {name}: launches {got} (expected {expect})")
            if got != expect:
                raise SystemExit(f"FAIL {name}: launch counts {got} != {expect}")
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
        for model, params, cfg in (("gcn", gcn.params(), gcn_cfg),
                                   ("agnn", agnn.params(), agnn_cfg)):
            loss, acc = gnn_loss(params, plan, x, labels, train_mask, cfg)
            if not math.isfinite(loss.item()):
                raise SystemExit(f"FAIL {model}: non-finite eval loss")
            print(f"  {model} eval (random weights): loss {loss.item():.4f}, "
                  f"accuracy {acc.item():.4f}")

    phase("5. timing (CUDA events around back-to-back calls, median of runs)")
    csr = torch.sparse_coo_tensor(
        torch.from_numpy(np.stack([g.rows, g.cols])),
        torch.from_numpy(g.vals), (m, m)).coalesce().to_sparse_csr().to(DEVICE)
    pattern = torch.sparse_csr_tensor(csr.crow_indices(), csr.col_indices(),
                                      torch.ones_like(csr.values()), (m, m))
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
        }
        ms = {}
        for name, (kern, plain_fn, lib_fn) in timed.items():
            ms[name] = (cuda_ms(kern), cuda_ms(plain_fn, reps=3, batch=3),
                        None if lib_fn is None else cuda_ms(lib_fn))
            print(f"  {name}: kernel {ms[name][0]:.4f} ms, plain "
                  f"{ms[name][1]:.4f} ms, library {ms[name][2]} ms")
        for name, (run, ref_run, _) in runs.items():
            torch.cuda.reset_peak_memory_stats()
            t_kernel = cuda_ms(run, batch=2, warmup=1)
            peak = torch.cuda.max_memory_allocated()
            t_plain = cuda_ms(ref_run, reps=3, batch=1, warmup=1)
            e2e[name] = {"ms": t_kernel, "plain_ms": t_plain,
                         "peak_bytes": peak}
            print(f"  {name} forward: {t_kernel:.3f} ms (impl=blocked "
                  f"{t_plain:.3f} ms), peak memory {peak / 2**30:.3f} GiB")

    phase("6. where the time goes (torch.profiler, one forward each)")
    with torch.inference_mode():
        for name, (run, _, _) in runs.items():
            print(f"  {name}:")
            e2e[name].update(profile_forward(run))

    v = blk.vector_size
    # Each distinct input read once: the main path passes Q and K as one
    # tensor (AGNN's q = k = ĥ), and it is counted once.
    nbytes = {
        "spmm": (read_once(blk.vals, blk.cols, blk.win_ptr, b)
                 + m * 128 * 4),
        "sddmm": (read_once(h32, h32, blk.mask, blk.cols, blk.block_win)
                  + nnzp * v * 4),
        "attention": (read_once(h32, h32, v32, beta, blk.mask, blk.cols,
                                blk.win_ptr)
                      + m * 32 * 4),
    }
    flops = {"spmm": 2 * nnzp * v * 128, "sddmm": 2 * nnzp * v * 32,
             "attention": 2 * nnzp * v * (32 + 32)}
    shapes = {
        "spmm": {"M": m, "K": m, "N": 128, "NNZP": nnzp, "V": v, "k_blk": 8},
        "sddmm": {"M": m, "F": 32, "NNZP": nnzp, "V": v, "k_blk": 8},
        "attention": {"M": m, "D": 32, "DV": 32, "NNZP": nnzp, "V": v,
                      "k_blk": 8},
    }
    rows = []
    for name, (source, replaces) in KERNELS.items():
        b_ms, b_by = bound(nbytes[name], flops[name])
        kernel_ms, plain_ms, library_ms = ms[name]
        rows.append({"name": name, "route": "cuda", "source": source,
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

    print(json.dumps({"end_to_end": e2e, "card": card,
                      "seconds": round(time.time() - t_start, 1)}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time the port's SpMM kernels and the GNN steps that run them on the
Amazon replica, with a digest of each output, for one source tree, so
that two trees can be compared on one card in one run.

    python3 scripts/spmm_ab.py [SRC] [--only=PREFIX,...]

``SRC`` is the ``src`` directory whose ``repro_torch`` is imported (by
default this checkout's); its kernels build into that tree's ``build``
directory.  To compare two trees, unpack the other one into a git-ignored
directory of this checkout (``git archive``) and run the script on each in
turns (A, B, B, A), one card, one call.  At the widths of PERF.md §6
(``make_dataset("Amazon", 1.0, seed=0)``, V = 8, k_blk = 8) it times:

  row 1  ``spmm_cuda``: A and A^T at N = 128 (fp32, bf16, int8 values
         with bf16 B) and N = 32 (fp32);
  row 3  ``spmm_batched_cuda``: two heads of B on A and on A^T, N = 128
         (fp32; bf16 on A);
  row 4  ``spmm_balanced_cuda`` over the split_blk = 1 schedules: A and
         A^T at N = 128 (fp32, bf16, int8) and N = 32 (fp32);
  row 5  ``spmm_staged_cuda``: A at N = 128 (fp32, bf16), A^T (fp32);
  row 2  ``spmm_noncoalesced_cuda``: A at N = 128 (fp32, bf16), A^T at
         N = 128 and 32 where the tree's row 2 walks a lane plan
         (``kernels/_window.lane_plan``; without one a lane walks a whole
         hub window of A^T, up to 50,424 K-blocks);
  row 9  ``attention_cuda``: AGNN's one head on A (D = DV = 32, unit
         rows, Q = K, beta = 1) and the 12-head attention of
         ``chip_smoke.attention_setup`` (16,384 tokens, D = DV = 64), fp32
         and bf16;
  row 10 ``attention_balanced_cuda`` over the split_blk = 1 schedules:
         the same one head on A and A^T and the same 12 heads, fp32 and
         bf16;
  the main path: a GCN and an AGNN train step and forward on ``cuda`` and
         ``cuda_balanced`` in fp32 and in bf16, and the GCN under an int8
         plan (``chip_smoke.py`` phase 5's widths, 5 layers, lr 5e-2),
         and the GCN forward on the two baseline routes.
``--only`` keeps the rows whose names start with one of the prefixes
(``row10`` holds both ``row10_*`` and ``row10_bf16_*``; ``agnn`` the
AGNN steps and forwards).

Beside each kernel row it prints the bytes its B gathers move when every
padded vector reads its B row once (padded vectors x N x the size of B's
element) and the time those take at 3.35 TB/s.  A kernel's time is
``chip_smoke.cuda_ms`` (CUDA events around 10 back-to-back calls, median
of 5, after 3 warm-up calls), a step's or a forward's the same around 2
calls, median of 3, after one warm-up call; the digest is the sha256 of
the first call's output, loss or logits.  The last line is one JSON
object with every row, the card's name and power limit and ``SRC``.
Needs a CUDA card.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts this checkout's src on the path)


def main() -> None:
    args = [a for a in sys.argv[1:] if not a.startswith("--only=")]
    only = tuple(p for a in sys.argv[1:] if a.startswith("--only=")
                 for p in a[len("--only="):].split(",") if p)
    src = pathlib.Path(args[0] if args else ROOT / "src")
    sys.path.insert(0, str(src.resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("spmm_ab: needs a CUDA card")
    from repro_torch.core.autodiff import ad_plan
    from repro_torch.core.format import from_coo
    from repro_torch.core.quantize import quantize_format
    from repro_torch.core.sddmm import with_values
    from repro_torch.kernels import (_window, attention_balanced_cuda,
                                     attention_cuda, spmm_balanced_cuda,
                                     spmm_batched_cuda, spmm_cuda,
                                     spmm_noncoalesced_cuda, spmm_staged_cuda)
    from repro_torch.models.gnn import AGNN, GCN, GNNConfig, gcn_forward
    from repro_torch.sparse.graphs import make_dataset
    from repro_torch.train.gnn_train import make_task
    from repro_torch.train.train_step import make_gnn_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    bf16 = torch.bfloat16
    g = make_dataset("Amazon", 1.0, seed=0)
    n_nodes = g.num_nodes
    fmt = from_coo(g.rows, g.cols, g.vals, (n_nodes, n_nodes), vector_size=8)
    plan = ad_plan(fmt, impl="cuda", k_blk=8, device="cuda")
    a, at = plan.fwd, plan.bwd
    views = {"A": {"fp32": a, "bf16": with_values(a, a.vals.to(bf16)),
                   "int8": quantize_format(a)},
             "At": {"fp32": at, "bf16": with_values(at, at.vals.to(bf16)),
                    "int8": quantize_format(at)}}
    sched = {"A": a.schedule(1), "At": at.schedule(1)}
    rng = np.random.default_rng(0)
    b = torch.from_numpy(rng.standard_normal(
        (n_nodes, 128)).astype(np.float32)).cuda()
    feats = {(128, "fp32"): b, (128, "bf16"): b.to(bf16),
             (32, "fp32"): torch.from_numpy(rng.standard_normal(
                 (n_nodes, 32)).astype(np.float32)).cuda()}
    b2 = torch.stack([b, b.flip(0)])
    kernels, gathered = {}, {}

    def row(name, fn, view, n, b_dtype, heads=1):
        kernels[name] = fn
        gathered[name] = (view.vals.shape[-2] * n * heads
                          * torch.finfo(b_dtype).bits // 8)

    for d in ("A", "At"):
        for var in ("fp32", "bf16", "int8"):
            v_ = views[d][var]
            bb = feats[(128, "fp32" if var == "fp32" else "bf16")]
            sfx = "" if var == "fp32" else f"_{var}"
            row(f"row1{sfx}_{d}_n128", lambda v_=v_, bb=bb: spmm_cuda(v_, bb),
                v_, 128, bb.dtype)
            row(f"row4{sfx}_{d}_n128",
                lambda v_=v_, bb=bb, s=sched[d]: spmm_balanced_cuda(
                    v_, bb, schedule=s), v_, 128, bb.dtype)
        v_, bb = views[d]["fp32"], feats[(32, "fp32")]
        row(f"row1_{d}_n32", lambda v_=v_, bb=bb: spmm_cuda(v_, bb), v_, 32,
            bb.dtype)
        row(f"row4_{d}_n32", lambda v_=v_, bb=bb, s=sched[d]:
            spmm_balanced_cuda(v_, bb, schedule=s), v_, 32, bb.dtype)
        row(f"row3_{d}_h2_n128", lambda v_=v_: spmm_batched_cuda(v_, b2), v_,
            128, b.dtype, heads=2)
        row(f"row5_{d}_n128", lambda v_=v_: spmm_staged_cuda(v_, b), v_, 128,
            b.dtype)
    b2_16 = b2.to(bf16)
    row("row3_bf16_A_h2_n128",
        lambda: spmm_batched_cuda(views["A"]["bf16"], b2_16),
        views["A"]["bf16"], 128, bf16, heads=2)
    row("row5_bf16_A_n128",
        lambda: spmm_staged_cuda(views["A"]["bf16"], feats[(128, "bf16")]),
        views["A"]["bf16"], 128, bf16)
    kernels["row2_A_n128"] = lambda: spmm_noncoalesced_cuda(a, b)
    kernels["row2_bf16_A_n128"] = lambda: spmm_noncoalesced_cuda(
        views["A"]["bf16"], feats[(128, "bf16")])
    if hasattr(_window, "lane_plan"):  # else one lane walks a whole hub
        kernels.update(
            row2_At_n128=lambda: spmm_noncoalesced_cuda(at, b),
            row2_At_n32=lambda: spmm_noncoalesced_cuda(at, feats[(32,
                                                                  "fp32")]))

    # rows 9 and 10 at AGNN's one head and at the 12-head attention
    h32 = chip_smoke.unit_rows(rng, n_nodes, 32).cuda()
    v32 = torch.from_numpy(rng.standard_normal((n_nodes, 32)).astype(
        np.float32)).cuda()
    beta = torch.ones((), device="cuda")
    att = chip_smoke.attention_setup(np.random.default_rng(0))
    ablk, abblk = att["plan"].fwd, att["bplan"].fwd
    asched = att["bplan"].fwd_sched
    for prec, dt in (("", torch.float32), ("_bf16", bf16)):
        hh, vv = h32.to(dt), v32.to(dt)
        aq, ak, av = (att[x_].to(dt) for x_ in "qkv")
        kernels[f"row9{prec}_A_d32"] = (
            lambda hh=hh, vv=vv: attention_cuda(a, hh, hh, vv, scale=beta))
        kernels[f"row9{prec}_h12"] = (
            lambda aq=aq, ak=ak, av=av: attention_cuda(
                ablk, aq, ak, av, scale=att["scale"]))
        for d in ("A", "At"):
            kernels[f"row10{prec}_{d}_d32"] = (
                lambda hh=hh, vv=vv, d=d: attention_balanced_cuda(
                    views[d]["fp32"], hh, hh, vv, scale=beta,
                    schedule=sched[d]))
        kernels[f"row10{prec}_h12"] = (
            lambda aq=aq, ak=ak, av=av: attention_balanced_cuda(
                abblk, aq, ak, av, scale=att["scale"], schedule=asched))

    x, labels, mask = (torch.from_numpy(t).cuda() for t in make_task(
        g, seed=0, num_classes=16, in_dim=128))
    gcn_cfg = GNNConfig(model="gcn", in_dim=128, hidden_dim=128,
                        num_classes=16, num_layers=5, impl="cuda")
    cfgs = {"gcn": gcn_cfg,
            "agnn": dataclasses.replace(gcn_cfg, model="agnn", hidden_dim=32)}
    fmt16 = from_coo(g.rows, g.cols, g.vals, (n_nodes, n_nodes),
                     vector_size=8, dtype=bf16)
    plans = {
        ("fp32", "cuda"): plan,
        ("fp32", "cuda_balanced"): ad_plan(fmt, impl="cuda_balanced", k_blk=8,
                                           split_blk=1, device="cuda"),
        ("bf16", "cuda"): ad_plan(fmt16, impl="cuda", k_blk=8, device="cuda"),
        ("bf16", "cuda_balanced"): ad_plan(fmt16, impl="cuda_balanced",
                                           k_blk=8, split_blk=1,
                                           device="cuda"),
        ("int8", "cuda"): ad_plan(fmt, impl="cuda", k_blk=8, device="cuda",
                                  precision="int8"),
        ("int8", "cuda_balanced"): ad_plan(fmt, impl="cuda_balanced", k_blk=8,
                                           split_blk=1, device="cuda",
                                           precision="int8"),
    }
    steps = {}
    for (prec, impl), p_ in plans.items():
        for model in (("gcn",) if prec == "int8" else ("gcn", "agnn")):
            dtype = bf16 if prec == "bf16" else torch.float32
            cfg = dataclasses.replace(cfgs[model], impl=impl, dtype=dtype)
            net = (GCN if model == "gcn" else AGNN)(
                cfg, device="cuda", seed=0 if model == "gcn" else 1)
            step = make_gnn_train_step(cfg, net, lr=5e-2)
            xx = x.to(dtype)
            tag = f"{model}_{prec}_{impl}"
            steps[f"{tag}_step"] = (
                lambda step=step, p_=p_, xx=xx: step(p_, xx, labels, mask)[0],
                False)
            steps[f"{tag}_forward"] = (
                lambda net=net, p_=p_, xx=xx: net(p_, xx), True)
    gcn = GCN(gcn_cfg, device="cuda", seed=0)
    for impl in ("cuda_noncoalesced", "cuda_staged"):
        cfg = dataclasses.replace(gcn_cfg, impl=impl)
        steps[f"gcn_forward_{impl}"] = (
            lambda cfg=cfg: gcn_forward(gcn.params(), a, x, cfg), True)

    def digest(out):
        return hashlib.sha256(out.detach().reshape(-1).contiguous().view(
            torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]

    runs = {name: (fn, True, {}) for name, fn in kernels.items()}
    runs.update({name: (fn, inference, dict(reps=3, batch=2, warmup=1))
                 for name, (fn, inference) in steps.items()})
    if only:
        runs = {k: r for k, r in runs.items() if k.startswith(only)}
    rows = {}
    for name, (fn, inference, timing) in runs.items():
        with torch.inference_mode(inference):
            out = fn()
            torch.cuda.synchronize()
            rows[name] = {"ms": chip_smoke.cuda_ms(fn, **timing),
                          "sha256": digest(out)}
        extra = ""
        if name in gathered:
            nbytes = gathered[name]
            rows[name].update(gathered_bytes=nbytes, gathered_ms=(
                nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3))
            extra = (f", gathers {nbytes / 1e6:.1f} MB = "
                     f"{rows[name]['gathered_ms']:.4f} ms at 3.35 TB/s")
        print(f"  [{src}] {name}: {rows[name]['ms']:.4f} ms, sha256 "
              f"{rows[name]['sha256']}{extra}", flush=True)
    print(json.dumps({"src": str(src), "card": chip_smoke.card_line(),
                      "rows": rows}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time the port's window SpMMs and their two ablation baselines on the
Amazon replica, with a digest of each output, for one source tree, so that
two trees can be compared on one card in one run.

    python3 scripts/spmm_ab.py [SRC]

``SRC`` is the ``src`` directory whose ``repro_torch`` is imported (by
default this checkout's); its kernels build into that tree's ``build``
directory.  To compare two trees, unpack the other one into a git-ignored
directory of this checkout (``git archive``) and run the script on each in
turns (A, B, B, A), one card, one call.  At the widths of PERF.md §6
(``make_dataset("Amazon", 1.0, seed=0)``, V = 8, k_blk = 8) it times:

  row 1  ``spmm_cuda``: A at N = 128 (fp32, bf16), A^T at N = 128 and 32;
  row 3  ``spmm_batched_cuda``: two heads of B on A and on A^T, N = 128;
  row 2  ``spmm_noncoalesced_cuda``: A at N = 128 (fp32, bf16), A^T at
         N = 128 and 32 where the tree's row 2 walks a lane plan
         (``kernels/_window.lane_plan``; without one a lane walks a whole
         hub window of A^T, up to 50,424 K-blocks);
  row 5  ``spmm_staged_cuda``: A at N = 128 (fp32, bf16);
  the main path: a GCN and an AGNN train step on the ``cuda`` route
         (``chip_smoke.py`` phase 5's widths, 5 layers, lr 5e-2), and the
         GCN forward on ``cuda`` and on the two baseline routes.

A kernel's time is ``chip_smoke.cuda_ms`` (CUDA events around 10
back-to-back calls, median of 5, after 3 warm-up calls), a step's or a
forward's the same around 2 calls, median of 3, after one warm-up call;
the digest is the sha256 of the first call's output, loss or logits.  The
last line is one JSON object with every row, the card's name and power
limit and ``SRC``.  Needs a CUDA card.
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
    src = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else ROOT / "src")
    sys.path.insert(0, str(src.resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("spmm_ab: needs a CUDA card")
    from repro_torch.core.autodiff import ad_plan
    from repro_torch.core.format import from_coo
    from repro_torch.core.sddmm import with_values
    from repro_torch.kernels import (_window, spmm_batched_cuda, spmm_cuda,
                                     spmm_noncoalesced_cuda, spmm_staged_cuda)
    from repro_torch.models.gnn import AGNN, GCN, GNNConfig, gcn_forward
    from repro_torch.sparse.graphs import make_dataset
    from repro_torch.train.gnn_train import make_task
    from repro_torch.train.train_step import make_gnn_train_step

    g = make_dataset("Amazon", 1.0, seed=0)
    fmt = from_coo(g.rows, g.cols, g.vals, (g.num_nodes, g.num_nodes),
                   vector_size=8)
    plan = ad_plan(fmt, impl="cuda", k_blk=8, device="cuda")
    a, at = plan.fwd, plan.bwd
    rng = np.random.default_rng(0)
    b = torch.from_numpy(rng.standard_normal(
        (g.num_nodes, 128)).astype(np.float32)).cuda()
    b32 = torch.from_numpy(rng.standard_normal(
        (g.num_nodes, 32)).astype(np.float32)).cuda()
    b2 = torch.stack([b, b.flip(0)])
    a16, b16 = with_values(a, a.vals.to(torch.bfloat16)), b.to(torch.bfloat16)
    kernels = {
        "row1_A_n128": lambda: spmm_cuda(a, b),
        "row1_bf16_A_n128": lambda: spmm_cuda(a16, b16),
        "row1_At_n128": lambda: spmm_cuda(at, b),
        "row1_At_n32": lambda: spmm_cuda(at, b32),
        "row3_A_h2_n128": lambda: spmm_batched_cuda(a, b2),
        "row3_At_h2_n128": lambda: spmm_batched_cuda(at, b2),
        "row2_A_n128": lambda: spmm_noncoalesced_cuda(a, b),
        "row2_bf16_A_n128": lambda: spmm_noncoalesced_cuda(a16, b16),
        "row5_A_n128": lambda: spmm_staged_cuda(a, b),
        "row5_bf16_A_n128": lambda: spmm_staged_cuda(a16, b16),
    }
    if hasattr(_window, "lane_plan"):  # else one lane walks a whole hub
        kernels.update(
            row2_At_n128=lambda: spmm_noncoalesced_cuda(at, b),
            row2_At_n32=lambda: spmm_noncoalesced_cuda(at, b32))

    x, labels, mask = (torch.from_numpy(t).cuda() for t in make_task(
        g, seed=0, num_classes=16, in_dim=128))
    gcn_cfg = GNNConfig(model="gcn", in_dim=128, hidden_dim=128,
                        num_classes=16, num_layers=5, impl="cuda")
    agnn_cfg = dataclasses.replace(gcn_cfg, model="agnn", hidden_dim=32)
    steps = {}
    for name, cls, cfg, seed in (("gcn", GCN, gcn_cfg, 0),
                                 ("agnn", AGNN, agnn_cfg, 1)):
        step = make_gnn_train_step(cfg, cls(cfg, device="cuda", seed=seed),
                                   lr=5e-2)
        steps[f"{name}_step_cuda"] = (
            lambda step=step: step(plan, x, labels, mask)[0], False)
    gcn = GCN(gcn_cfg, device="cuda", seed=0)
    steps["gcn_forward_cuda"] = (lambda: gcn(plan, x), True)
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
    rows = {}
    for name, (fn, inference, timing) in runs.items():
        with torch.inference_mode(inference):
            out = fn()
            torch.cuda.synchronize()
            rows[name] = {"ms": chip_smoke.cuda_ms(fn, **timing),
                          "sha256": digest(out)}
        print(f"  [{src}] {name}: {rows[name]['ms']:.4f} ms, sha256 "
              f"{rows[name]['sha256']}", flush=True)
    print(json.dumps({"src": str(src), "card": chip_smoke.card_line(),
                      "rows": rows}))


if __name__ == "__main__":
    main()

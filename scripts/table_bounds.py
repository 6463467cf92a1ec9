#!/usr/bin/env python3
"""The read-once bounds of the PERF.md §6 sub-rows that ``chip_smoke.py``'s
``kernels`` line does not carry, from the shapes of the Amazon replica
(``make_dataset("Amazon", 1.0, seed=0)``, V = 8, k_blk = 8, N = 128):

  row 1 int8 on A^T   ``spmm_cuda`` on the quantized transpose, bf16 B,
                      with its window plan's split ids;
  row 4 int8 on A^T   ``spmm_balanced_cuda`` on it over the split_blk = 1
                      schedule, with its run plan;
  row 5 on A^T        ``spmm_staged_cuda`` (row 1's function on row 1's
                      inputs, as the ``kernels`` line counts row 5 on A);
  row 3 at H = 2      ``spmm_batched_cuda`` with the values shared by two
                      heads of B, on A and A^T (fp32) and on A (bf16).

Each is ``chip_smoke.bound`` of ``chip_smoke.read_once`` of its inputs
plus its output written once, and 2 * nnz * N * H flops (fp32 rows at the
67 TFLOP/s fp32 rate, the narrow ones at 989), as ``chip_smoke.py`` counts
its own rows.  Runs on the host alone (no card): arrays are built on the
CPU, only their sizes are read.

    python3 scripts/table_bounds.py
"""

from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts this checkout's src on the path)


def main() -> None:
    import torch

    from repro_torch.core.autodiff import ad_plan
    from repro_torch.core.format import from_coo
    from repro_torch.core.quantize import quantize_format
    from repro_torch.core.sddmm import with_values
    from repro_torch.kernels._combine import run_plan
    from repro_torch.kernels._window import SPLIT_BLK, window_plan
    from repro_torch.kernels.spmm_balanced_cuda import RUN_BLK
    from repro_torch.sparse.graphs import make_dataset

    g = make_dataset("Amazon", 1.0, seed=0)
    m = g.num_nodes
    fmt = from_coo(g.rows, g.cols, g.vals, (m, m), vector_size=8)
    plan = ad_plan(fmt, impl="cuda", k_blk=8, device="cpu")
    bplan = ad_plan(fmt, impl="cuda_balanced", k_blk=8, split_blk=1,
                    device="cpu")
    a, at, bat = plan.fwd, plan.bwd, bplan.bwd
    nnz = int(a.mask.sum())
    n, bf16 = 128, torch.bfloat16
    b = torch.zeros((m, n))
    b16, b2 = b.to(bf16), torch.zeros((2, m, n))
    split_ids = window_plan("table_bounds", at.win_ptr, SPLIT_BLK,
                            n).split_ids
    rp = run_plan("table_bounds", bat.schedule(1), bat.num_windows, RUN_BLK)
    q8t, bq8t = quantize_format(at), quantize_format(bat)
    a16 = with_values(a, a.vals.to(bf16))
    rows = {
        "row1_int8_At": (chip_smoke.read_once(q8t.vals, q8t.scales, at.cols,
                                              at.win_ptr, b16, split_ids)
                         + m * n * 2, 2 * nnz * n, chip_smoke.BF16_FLOPS_PER_S),
        "row4_int8_At": (chip_smoke.read_once(bq8t.vals, bq8t.scales,
                                              bat.cols, b16, rp.run_ptr,
                                              rp.pieces)
                         + m * n * 2, 2 * nnz * n, chip_smoke.BF16_FLOPS_PER_S),
        "row5_At": (chip_smoke.read_once(at.vals, at.cols, at.block_win, b)
                    + m * n * 4, 2 * nnz * n, chip_smoke.FP32_FLOPS_PER_S),
        "row3_A_h2": (chip_smoke.read_once(a.vals, a.cols, a.win_ptr, b2)
                      + 2 * m * n * 4, 4 * nnz * n,
                      chip_smoke.FP32_FLOPS_PER_S),
        "row3_At_h2": (chip_smoke.read_once(at.vals, at.cols, at.win_ptr, b2,
                                            split_ids)
                       + 2 * m * n * 4, 4 * nnz * n,
                       chip_smoke.FP32_FLOPS_PER_S),
        "row3_bf16_A_h2": (chip_smoke.read_once(a16.vals, a.cols, a.win_ptr,
                                                b2.to(bf16))
                           + 2 * m * n * 2, 4 * nnz * n,
                           chip_smoke.BF16_FLOPS_PER_S),
    }
    out = {}
    for name, (nbytes, flops, rate) in rows.items():
        ms, by = chip_smoke.bound(nbytes, flops, rate)
        out[name] = {"bytes": nbytes, "flops": flops, "bound_ms": ms,
                     "bound_by": by}
        print(f"  {name}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP: "
              f"bound {ms:.4f} ms by {by}", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

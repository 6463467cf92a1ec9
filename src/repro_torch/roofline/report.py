"""Render the dry-run JSONL ledger into the dry-run and roofline tables.

Counterpart of ``repro.roofline.report``:

  PYTHONPATH=src python -m repro_torch.roofline.report \\
      experiments/dryrun_torch.jsonl

Emits §Dry-run (memory proof per cell) and §Roofline (three terms,
bottleneck, MODEL_FLOPS ratio, improvement note) in markdown.  "fits"
reads the capacity of the hardware the records name (``"hw"``, written by
``launch/dryrun.py``: 80 GB for the H100); a ledger without that key is
the reference's, at its 16 GB.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List

from .analysis import HW_H100, HW_V5E

HBM_PER_CHIP = HW_V5E.hbm_bytes          # a record that names no hardware
_HBM = {hw.name: hw.hbm_bytes for hw in (HW_H100, HW_V5E)}


def load(path: str, tag: str = "baseline") -> List[Dict]:
    seen = {}
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            if r.get("tag", "baseline") != tag or "status" not in r:
                continue
            seen[(r["arch"], r["shape"], r["mesh"])] = r  # last wins
    rows = list(seen.values())
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    return rows


def _hint(r: Dict) -> str:
    rf = r["roofline"]
    b = rf["bottleneck"]
    kind = "train" if r["shape"].startswith("train") else (
        "prefill" if r["shape"].startswith("prefill") else "decode")
    if b == "memory" and kind == "train":
        return ("fuse the attention score chain / cut f32 round-trips "
                "(activation traffic dominates)")
    if b == "memory":
        return "KV-cache layout + scatter traffic; quantize cache to int8"
    if b == "collective" and kind == "train":
        return "bf16 TP collectives + reduce-scatter instead of f32 all-reduce"
    if b == "collective":
        return "replicate small weights to kill per-step weight gathers"
    unit = "MXU" if "hw" not in r else "tensor-core"
    return f"{unit}-bound — raise per-chip arithmetic intensity (larger tiles)"


def _capacity(rows: List[Dict]) -> float:
    for r in rows:
        if "hw" in r:
            return _HBM[r["hw"]]
    return HBM_PER_CHIP


def dryrun_table(rows: List[Dict]) -> str:
    cap = _capacity(rows)
    out = ["| arch | shape | mesh | status | compile s | mem/device GB | "
           f"fits {cap / 1e9:.0f} GB | collectives |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"skip — {r['reason'][:60]}… | | | | |")
            continue
        if r["status"] == "error":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"ERROR {r['error'][:60]} | | | | |")
            continue
        m = r["memory"]
        per_dev = (m["argument_bytes"] + m["temp_bytes"]
                   - m["alias_bytes"]) / 1e9
        fits = "yes" if per_dev * 1e9 <= cap else f"NO ({per_dev:.0f} GB)"
        rf = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{r['compile_s']:.0f} | {per_dev:.2f} | {fits} | "
            f"{rf['collective_count']} ops, "
            f"{rf['collective_ring'] / 1e9:.2f} GB/dev |")
    return "\n".join(out)


def roofline_table(rows: List[Dict]) -> str:
    out = ["| arch | shape | mesh | compute ms | memory ms | collective ms | "
           "bottleneck | useful/HLO flops | roofline | note |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] != "ok":
            continue
        # multi-pod rows are planned without accounting in the
        # reference's convention: the roofline table is single-pod only
        if r["mesh"] != "pod16x16":
            continue
        rf = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{rf['compute_s'] * 1e3:.2f} | {rf['memory_s'] * 1e3:.2f} | "
            f"{rf['collective_s'] * 1e3:.2f} | **{rf['bottleneck']}** | "
            f"{rf['useful_flops_ratio']:.2f} | "
            f"{rf['roofline_fraction']:.1%} | {_hint(r)} |")
    return "\n".join(out)


def main(argv=None) -> int:
    args = argv or sys.argv[1:]
    path = args[0] if args else "experiments/dryrun_torch.jsonl"
    tag = args[1] if len(args) > 1 else "baseline"
    rows = load(path, tag)
    print(f"## §Dry-run ({len(rows)} cells, tag={tag})\n")
    print(dryrun_table(rows))
    print(f"\n## §Roofline\n")
    print(roofline_table(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

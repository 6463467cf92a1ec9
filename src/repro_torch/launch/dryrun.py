"""Multi-pod dry-run: trace every (arch × shape × mesh) cell on the CPU.

Counterpart of ``repro.launch.dryrun``.  For each cell the pipeline is
``plan_cell`` (``meta`` inputs and their specs) → ``account_cell`` (the
step traced once on ``meta`` DTensors over the production mesh, under
``roofline/trace.py``'s counter) → the memory statistics (fits-per-device
proof) and the roofline report.  The production meshes live on a
``"fake"`` process group of 256 or 512 ranks in this one process
(``launch/mesh.fake_group``), which the reference gets by forcing 512
host devices: no card, no allocation.

Results append to a JSONL ledger (resumable: cells already present are
skipped unless --force).  Usage:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --out experiments/dryrun_torch.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch deepseek-v3-671b --shape train_4k --mesh single \\
      --dump-trace experiments/traces/

``--dump-trace`` takes the place of the reference's ``--dump-hlo``: the
port has no HLO, so it writes each cell's recorded ops and collectives.
The records name their hardware (``"hw"``: the roofline's constants,
``HW_H100``), which ``roofline/report.py`` reads for "fits".
"""

import argparse
import json
import os
import sys
import time
import traceback


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--arch", default="all")
    p.add_argument("--shape", default="all")
    p.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    p.add_argument("--out", default="experiments/dryrun_torch.jsonl")
    p.add_argument("--dump-trace", default=None,
                   help="directory to write each cell's recorded ops and "
                        "collectives")
    p.add_argument("--force", action="store_true",
                   help="trace cells already in the ledger again")
    p.add_argument("--ts-override", default=None,
                   help="JSON TrainStepConfig overrides, e.g. "
                        '\'{"microbatches": 8}\'')
    p.add_argument("--cfg-override", default=None,
                   help="JSON ArchConfig overrides, e.g. "
                        '\'{"moe_ep": true, "act_sp": true}\'')
    p.add_argument("--tag", default="baseline",
                   help="ledger tag (perf iterations use their own tags)")
    p.add_argument("--no-accounting", action="store_true",
                   help="production trace only (its roofline terms count "
                        "the policy's microbatches)")
    return p.parse_args(argv)


def load_done(path):
    done = set()
    try:
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"], r.get("tag")))
                except json.JSONDecodeError:
                    continue
    except FileNotFoundError:
        pass
    return done


def main(argv=None) -> int:
    args = parse_args(argv)

    from repro_torch.configs import SHAPES, list_archs
    from repro_torch.launch.mesh import fake_group, make_production_mesh

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    ts_overrides = json.loads(args.ts_override) if args.ts_override else None
    cfg_overrides = json.loads(args.cfg_override) if args.cfg_override else None

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set() if args.force else load_done(args.out)
    failures = 0

    for multi_pod in meshes:
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
        with fake_group(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod)
            for arch in archs:
                for shape in shapes:
                    key = (arch, shape, mesh_name, args.tag)
                    if key in done:
                        print(f"[skip-done] {key}")
                        continue
                    failures += _run_cell(args, arch, shape, mesh, mesh_name,
                                          ts_overrides, cfg_overrides)
    return 1 if failures else 0


def _run_cell(args, arch, shape, mesh, mesh_name, ts_overrides,
              cfg_overrides) -> int:
    """Plan, trace and record one cell; returns 1 if it failed."""
    from repro_torch.launch.cells import account_cell, compile_cell, plan_cell
    from repro_torch.roofline.analysis import HW_H100 as hw

    t0 = time.time()
    record = {"arch": arch, "shape": shape, "mesh": mesh_name,
              "tag": args.tag, "hw": hw.name}
    failed = 0
    try:
        plan = plan_cell(arch, shape, mesh, ts_overrides=ts_overrides,
                         cfg_overrides=cfg_overrides)
        if plan.skipped:
            record["status"] = "skipped"
            record["reason"] = plan.skipped
            print(f"[skip] {arch} × {shape} × {mesh_name}: {plan.skipped}")
        else:
            if args.no_accounting:
                res = compile_cell(plan, mesh, mesh_name, hw=hw)
            else:
                res = account_cell(arch, shape, mesh, mesh_name,
                                   ts_overrides=ts_overrides,
                                   cfg_overrides=cfg_overrides, hw=hw)
            record["status"] = "ok"
            record["compile_s"] = round(res.compile_s, 2)
            record["memory"] = res.memory_stats
            record["roofline"] = res.report.to_dict()
            if args.dump_trace:
                os.makedirs(args.dump_trace, exist_ok=True)
                fn = os.path.join(args.dump_trace,
                                  f"{arch}__{shape}__{mesh_name}.trace.txt")
                with open(fn, "w") as f:
                    f.write(res.trace.dump())
            r = res.report
            m = record["memory"]
            per_dev_gb = (m["argument_bytes"] + m["temp_bytes"]
                          - m["alias_bytes"]) / 1e9
            print(f"[ok]   {arch} × {shape} × {mesh_name}: "
                  f"trace {res.compile_s:.1f}s | "
                  f"mem/dev {per_dev_gb:.2f} GB | "
                  f"compute {r.compute_s*1e3:.2f} ms, "
                  f"memory {r.memory_s*1e3:.2f} ms, "
                  f"collective {r.collective_s*1e3:.2f} ms "
                  f"→ {r.bottleneck}-bound, "
                  f"roofline {r.roofline_fraction:.1%}")
    except Exception as e:  # noqa: BLE001 — the ledger records it
        failed = 1
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-2000:]
        print(f"[FAIL] {arch} × {shape} × {mesh_name}: "
              f"{type(e).__name__}: {e}")
    record["wall_s"] = round(time.time() - t0, 2)
    with open(args.out, "a") as f:
        f.write(json.dumps(record) + "\n")
    return failed


if __name__ == "__main__":
    sys.exit(main())

"""Readings that set a cell's limits, at the cell's own size, on the card.

    python3 perfbench/calibrate.py --workload <cell> [--seeds 12]
        [--faults 3] [--out chiprun_out/calibrate-<cell>.json]

In one process, over one plan of the cell's graph: for each seed, a
fresh trainer's checked steps against the plain reference (the sound
runs, whose largest numbers are the lower readings); for the first
``--faults`` seeds, the control (the reference at the next precision
below the cell's, in the program's place) and the planted fault of half
the training nodes left out, the mean taken over the rest (the reference
in the program's place); a step that leaves the state unchanged is
worked out from the sound readings.  The benchmark's runs do not run
this.  Prints one JSON line per reading and writes them all to ``--out``.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONTROL = "tf32"          # the next precision below the cells' float32
SEED0 = 3_000_000_017


def unchanged(prog: dict) -> dict:
    """The readings of a step that returns its state unchanged: every
    step sees the first step's parameters, and nothing moves."""
    first = prog["losses"][0]
    return {"losses": [first] * len(prog["losses"]),
            "grad_norms": prog["grad_norms"],
            "change_norms": {k: 0.0 for k in prog["change_norms"]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from perfbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    kind = cell.model()
    data, _ = kind.load_traffic(cell, ROOT / "build" / "perfbench" / "graphs")
    plan = kind.make_program(cell, data, devices)
    rows = []

    def emit(**row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    for i in range(args.seeds):
        seed = SEED0 + 7919 * i
        inputs = kind.make_inputs(cell, data, seed, devices)
        t0 = time.perf_counter()
        prog = harness.checked_steps(
            kind.trainer(cell, plan, inputs, devices), cell.checked_steps)
        t1 = time.perf_counter()
        ref = kind.reference_readings(cell, data, inputs, devices)
        t2 = time.perf_counter()
        emit(kind="program", seed=seed, numbers=harness.compare(prog, ref),
             program_s=t1 - t0, reference_s=t2 - t1, prog=prog, ref=ref)
        if i < args.faults:
            emit(kind="unchanged", seed=seed,
                 numbers=harness.compare(unchanged(prog), ref))
            ctrl = kind.reference_readings(cell, data, inputs, devices,
                                           rounding=CONTROL)
            emit(kind="control", seed=seed, rounding=CONTROL,
                 numbers=harness.compare(ctrl, ref), prog=ctrl)
            fault = kind.reference_readings(cell, data, inputs, devices,
                                            fault="half_batch")
            emit(kind="half_batch", seed=seed,
                 numbers=harness.compare(fault, ref), prog=fault)
    out = pathlib.Path(args.out or ROOT / "chiprun_out"
                       / f"calibrate-{cell.name}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    for kind_ in ("program", "unchanged", "control", "half_batch"):
        got = [r["numbers"] for r in rows if r["kind"] == kind_]
        if got:
            agg = max if kind_ == "program" else min
            print(kind_, {k: agg(g[k] for g in got) for k in got[0]})
    return 0


if __name__ == "__main__":
    sys.exit(main())

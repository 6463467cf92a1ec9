"""Run one cell of the benchmark once on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the card's name, power limit and
device count on an early line, the comparison's numbers beside their
limits as the last lines of standard error, and the result as one JSON
object on the last line of standard output.  Exits with another code
than 0, and prints no result, when there is no card (or fewer than the
cell asks for), when the cell is unknown, or when JAX or the JAX package
was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BUILD = ROOT / "build" / "perfbench"
# Bytecode of every module the run imports (the program's and PyTorch's,
# whose own directories may not be writable) in a fixed directory of the
# checkout: the first run compiles it, later runs read it, also where the
# environment turns bytecode writing off (it cost each run 4.5 s).
sys.pycache_prefix = str(BUILD / "pycache")
sys.dont_write_bytecode = False


COLD = [] if (BUILD / "pycache").is_dir() else ["bytecode"]
# The program's caches at fixed paths inside the checkout: its kernel
# builds are ``build/repro_torch_kernels`` by its own code, its autotune
# cache is where this variable says.
os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(BUILD / "autotune.json")


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    from perfbench import harness

    try:
        cell = harness.load_cell(ROOT, args.workload)
    except (KeyError, FileNotFoundError) as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    torch.cuda.set_device(devices[0])
    print(f"perfbench: card {torch.cuda.get_device_name(devices[0])}, "
          f"power.limit {_power_limit()}, devices {torch.cuda.device_count()}"
          f", cell uses {cell.chips}", flush=True)

    result = harness.run_cell(
        cell, args.seed, args.seconds, bool(args.trace), devices, T_START,
        log=lambda line: print(line, file=sys.stderr, flush=True), cold=COLD)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, value in result.pop("numbers").items():
        if name not in result["checks"]:
            print(f"number {name} {value!r} (not held in this cell)",
                  file=sys.stderr)
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

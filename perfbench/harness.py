"""One run of one cell: set-up, the checked first steps, the timed window,
the traced window, the comparison with the plain reference, the result.

Everything that belongs to one configuration, traffic mix, cell or
metric is found by its name under the benchmark's root:

  BENCHMARK.json                       cells, metrics, bounds
  perfbench/configs/<config>.json      widths, optimizer, the program's
                                       model class, the model kind
  perfbench/models/<kind>.py           the kind's entry points: its
                                       traffic, the program's set-up and
                                       trainer, inputs and weights from
                                       the seed, the plain reference, the
                                       step's counts
  perfbench/traffic/<traffic>.json     data, dtype, route, warm-up
  perfbench/limits/<cell>.json         the limits of the comparison
  perfbench/metrics/<metric>.py        one reader per metric

This module knows no model: it times what the kind's ``trainer`` calls,
one step after the other, and compares the readings of its first steps
with the kind's reference.  The GNN kinds (:mod:`perfbench.gnn`) train
the program's model with ``repro_torch.models.gnn.make_train_step`` on
an ``ad_plan`` of the cell's graph, one full-graph step (one epoch)
after the other.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import pathlib
import statistics
import sys
import time
from types import ModuleType
from typing import Callable, Dict, List, Optional, Sequence

import torch

from perfbench import trace

__all__ = ["Cell", "load_cell", "Trainer", "checked_steps", "compare",
           "RunRecord", "run_cell", "forbidden_modules"]

HOST_PROBE_STEPS = 20      # steps timed alone on the host (traced run)
TRACE_TARGET_S = 1.0       # device time the traced window aims at


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    root: pathlib.Path
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]
    checked_steps = 3       # the program's first steps the reference follows

    def model(self) -> ModuleType:
        kind = self.config["model"]
        return _module(self.root / "perfbench" / "models" / f"{kind}.py",
                       f"perfbench_model_{kind}")

    def metric(self, entry: dict) -> ModuleType:
        name = entry["name"]
        return _module(self.root / "perfbench" / "metrics" / f"{name}.py",
                       "perfbench_metric_" + name.replace(".", "_")
                       .replace("-", "_"))


_MODULES: Dict[pathlib.Path, ModuleType] = {}


def _module(path: pathlib.Path, name: str) -> ModuleType:
    """The module in the file ``path``, loaded once."""
    if path not in _MODULES:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def load_cell(root: pathlib.Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    manifest = _json(root / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        known = ", ".join(w["name"] for w in manifest["workloads"])
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {known})")
    base = root / "perfbench"
    return Cell(name=name, root=root,
                config=_json(base / "configs" / f"{entry['config']}.json"),
                traffic=_json(base / "traffic" / f"{entry['traffic']}.json"),
                limits=_json(base / "limits" / f"{name}.json"),
                chips=entry["chips"],
                end_to_end=manifest["end_to_end"],
                per_layer=manifest["per_layer"])


# ---------------------------------------------------------------------------
# The program's first steps and the comparison.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Trainer:
    """What a model kind's ``trainer`` hands the harness: the program's
    parameters by name, the window's own call (one step, returning the
    loss first), and the first gradient's norm of each leaf as the
    program's optimizer holds it after one step."""
    params: Dict[str, torch.Tensor]
    call: Callable[[], tuple]
    first_grad_norms: Callable[[], Dict[str, float]]


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().float()))


def checked_steps(trainer: Trainer, steps: int) -> dict:
    """The program's first ``steps`` steps, through the window's own call:
    each step's loss, each leaf's first gradient, and each leaf's change
    after the steps."""
    p0 = {k: p.detach().clone() for k, p in trainer.params.items()}
    losses, grad_norms = [], {}
    for i in range(steps):
        loss = trainer.call()[0]
        losses.append(float(loss))
        if i == 0:
            grad_norms = trainer.first_grad_norms()
    change = {k: _norm(p.float() - p0[k].float())
              for k, p in trainer.params.items()}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


RESOLUTION = 2.0 ** -24    # float32's relative half ulp
RESOLVED = 1e-3            # the state's rounding a counted change may carry


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers a cell's limits may hold.

    ``loss_gap``: the largest relative gap of a step's loss.
    ``grad_gap`` and ``change_gap``: by the worst leaf, the gap between
    the program's norm and the reference's (of the first gradient; of
    the change after the checked steps), over the reference's norm of
    that leaf or of the median leaf, whichever is larger.
    ``grad_group_gap``: the same gap of the first gradient by the worst
    group of leaves (the leaves whose names share the part before the
    first dot, such as AGNN's five one-number ``beta.<layer>``), over
    the group's own norm: it holds a group of small leaves that the
    median's floor in ``grad_gap`` leaves unread.

    The change counts the leaves that move by more than rounding, by two
    rules on the reference's first gradient g: g is at least a thousandth
    of the median leaf's, and the float32 state resolves the step's
    update, ``RESOLUTION * |p0| <= RESOLVED * lr * |g| * sqrt(size)``
    (the state's rounding of one update, over the leaf's elements, under
    a thousandth of the update's norm).  The program holds its
    parameters in float32; a leaf whose update is a few ulps, as AGNN's
    β, moves by its rounding as much as by its gradient.
    """
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(prog["losses"], ref["losses"]))
    gref = ref["grad_norms"]

    def worst(key, leaves):
        rn = ref[key]
        med = statistics.median(rn[k] for k in leaves)
        return max(abs(prog[key][k] - rn[k]) / max(rn[k], med, 1e-30)
                   for k in leaves)

    groups: Dict[str, List[str]] = {}
    for k in gref:
        groups.setdefault(k.split(".")[0], []).append(k)
    gnorm = lambda d, ks: math.sqrt(sum(d[k] ** 2 for k in ks))
    group_gap = max(abs(gnorm(prog["grad_norms"], ks) - gnorm(gref, ks))
                    / max(gnorm(gref, ks), 1e-30) for ks in groups.values())

    gmed = statistics.median(gref.values())
    moving = [k for k in gref if gref[k] >= 1e-3 * gmed
              and RESOLUTION * ref["start_norms"][k]
              <= RESOLVED * ref["lr"] * gref[k] * math.sqrt(ref["sizes"][k])]
    change_gap = worst("change_norms", moving) if moving else math.inf
    return {"loss_gap": loss_gap, "grad_gap": worst("grad_norms", list(gref)),
            "grad_group_gap": group_gap, "change_gap": change_gap}


# ---------------------------------------------------------------------------
# The run.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read."""
    cell: Cell
    counts: dict            # the kind's ``step_counts``: the yardstick
    setup_s: float
    steps: int
    window_s: float
    step_gaps_ms: List[float]
    window_peak_bytes: int
    host_step_ms: Optional[List[float]] = None
    trace: Optional[trace.TraceSummary] = None
    port_kernels: frozenset = frozenset()

    @property
    def epoch_ms(self) -> float:
        return self.window_s * 1e3 / self.steps


class _Clock:
    """Per-step stamps: CUDA events on the first card, the host clock on
    the CPU (where the harness runs only in tests)."""

    def __init__(self, devices: Sequence[torch.device]):
        self.cuda = devices[0].type == "cuda"
        self.stamps: list = []

    def stamp(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.stamps.append(ev)
        else:
            self.stamps.append(time.perf_counter())

    def gaps_ms(self) -> List[float]:
        s = self.stamps
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(s, s[1:])]
        return [(b - a) * 1e3 for a, b in zip(s, s[1:])]


def _sync(devices: Sequence[torch.device]) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _peak(devices: Sequence[torch.device]) -> int:
    """``max_memory_allocated`` of the fullest card."""
    return max((torch.cuda.max_memory_allocated(d) for d in devices
                if d.type == "cuda"), default=0)


def timed_window(call: Callable, seconds: float, devices):
    """Steps back to back until ``seconds`` have passed on the host's
    clock, then a synchronise: ``(steps, window_s, gaps_ms, losses)``.
    No synchronise inside; a stamp between consecutive steps."""
    clock = _Clock(devices)
    losses = []
    _sync(devices)
    t0 = time.perf_counter()
    clock.stamp()
    while True:
        losses.append(call()[0])
        clock.stamp()
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(devices)
    window_s = time.perf_counter() - t0
    return len(losses), window_s, clock.gaps_ms(), losses


def host_probe(call: Callable, devices, n: int = HOST_PROBE_STEPS
               ) -> List[float]:
    """Host ms of single steps that find the device idle (a synchronise
    before each): the host's own cost of a step, not held by the
    device's pace."""
    out = []
    for _ in range(n):
        _sync(devices)
        t = time.perf_counter()
        call()
        out.append((time.perf_counter() - t) * 1e3)
    _sync(devices)
    return out


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             devices: Sequence[torch.device], t_start: float,
             log: Callable[[str], None] = print,
             cold: Sequence[str] = ()) -> dict:
    """One run on ``devices`` (the cell's ``chips`` cards).  ``t_start``
    is the process's start on the host clock (``time.perf_counter``),
    from which ``setup_s`` counts; ``cold`` names caches the caller found
    empty.  Returns the result line's object: ``setup_parts`` splits
    ``setup_s`` and names the caches this run filled (a cell's first run
    in a checkout), ``checks`` (last) the comparison the cell holds, and
    ``numbers`` every number of the comparison, which the result line
    leaves out."""
    cuda = devices[0].type == "cuda"
    kind = cell.model()
    parts: Dict[str, object] = {}
    last = [t_start]

    def mark(what: str) -> None:
        now = time.perf_counter()
        parts[what + "_s"] = now - last[0]
        last[0] = now
        log(f"perfbench: set-up {what} done at {now - t_start:.3f} s")

    mark("imports")
    kernels = cell.root / "build" / "repro_torch_kernels"
    cold = list(cold) + ([] if any(kernels.glob("*/*.so")) else ["kernels"])
    data, filled = kind.load_traffic(cell, cell.root / "build" / "perfbench"
                                     / "graphs", log)
    mark("traffic")
    plan = kind.make_program(cell, data, devices)
    mark("program")
    inputs = kind.make_inputs(cell, data, seed, devices)
    mark("inputs")
    trainer = kind.trainer(cell, plan, inputs, devices)
    prog = checked_steps(trainer, cell.checked_steps)
    mark("checked_steps")
    for _ in range(cell.traffic["warmup_steps"] - cell.checked_steps):
        trainer.call()
    _sync(devices)
    mark("warmup")
    setup_peak = _peak(devices)
    setup_s = time.perf_counter() - t_start
    parts["cold_caches"] = cold + filled

    if cuda:
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)
    steps, window_s, gaps, losses = timed_window(trainer.call, seconds,
                                                 devices)
    window_peak = _peak(devices)
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    rec = RunRecord(cell, kind.step_counts(cell, data), setup_s, steps,
                    window_s, gaps, window_peak)
    if traced:
        rec.host_step_ms = host_probe(trainer.call, devices)
        n_prof = min(200, max(10, math.ceil(TRACE_TARGET_S * 1e3
                                            / rec.epoch_ms)))
        rec.trace = trace.profile_steps(trainer.call, n_prof, devices)
        rec.port_kernels = frozenset(trace.port_kernel_names(
            cell.root / "src" / "repro_torch" / "kernels" / "csrc"))
    memory_peak = max(setup_peak, window_peak, _peak(devices))

    # The program's state goes before the reference runs on the device.
    del trainer, plan, losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = kind.reference_readings(cell, data, inputs, devices)
    numbers = compare(prog, ref)
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in cell.limits.items()}
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())

    metrics = {}
    for entry in (cell.per_layer if traced else cell.end_to_end):
        value = cell.metric(entry).read(rec)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(devices[0]) if cuda else "cpu",
           "count": len(devices), "memory_peak_bytes": int(memory_peak)}
    if traced:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
    result = {"correct": bool(correct), "attempted": steps, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced:
        result["breakdown"] = trace.breakdown(rec.trace)
    result["setup_parts"] = parts
    result["checks"] = checks
    result["numbers"] = numbers
    return result


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules (or ``names``) whose top-level name is JAX's or the
    JAX package's, compared whole: ``repro_torch`` is not ``repro``."""
    banned = {"jax", "jaxlib", "flax", "repro"}
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & banned)

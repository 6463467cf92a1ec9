"""Three-term roofline from a traced step (no card needed).

Counterpart of ``repro.roofline.analysis``.  The reference reads XLA's
cost and memory analysis of an AOT-compiled SPMD executable; the port has
no compiler to ask, so it reads a *trace* of one rank's step instead
(:mod:`.trace`: the step run once on ``meta`` DTensors over a mesh of a
fake process group).  The terms are the reference's:

  compute term    = per-device FLOPs / peak FLOP/s
  memory term     = per-device bytes accessed / HBM bandwidth
  collective term = per-device collective bytes / link bandwidth

The per-device numbers are one rank's local ops: the rank's flops, its
operand plus result bytes of every op (XLA's "bytes accessed" sums the
same per HLO op), and the collectives it issues.  Collective bytes are
what a device moves under a ring / two-phase schedule, from each op's
result bytes ``r`` and group size ``g``:

  all-gather         r × (g-1)/g          (recv from g-1 peers)
  all-reduce         r × 2(g-1)/g         (reduce-scatter + gather)
  reduce-scatter     r·g × (g-1)/g        (the operand is g results)
  all-to-all         r × (g-1)/g
  collective-permute r                    (one hop)

plus the *naive* sum of operand bytes for comparison.

Hardware: ``HW_H100`` (H100 SXM datasheet: 989 TFLOP/s dense bf16,
3.35 TB/s HBM3, 80 GB, NVLink 4 at 450 GB/s a GPU a direction) is the
default.  A mesh wider than a node's 8 GPUs crosses InfiniBand (about
50 GB/s a GPU) on its outer axis; the report keeps the reference's one
link rate for every collective, a deliberate simplification.  ``HW_V5E``
keeps the reference's TPU constants for parity checks only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

__all__ = [
    "HardwareSpec",
    "HW_H100",
    "HW_V5E",
    "COLLECTIVES",
    "collective_bytes_from_trace",
    "model_flops",
    "RooflineReport",
    "analyze_trace",
]


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float        # per chip, bf16
    hbm_bw: float            # bytes/s per chip
    ici_bw: float            # bytes/s per link
    hbm_bytes: float         # capacity per chip


HW_H100 = HardwareSpec(
    name="h100-sxm",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    ici_bw=450e9,
    hbm_bytes=80e9,
)

HW_V5E = HardwareSpec(
    name="tpu-v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    ici_bw=50e9,
    hbm_bytes=16e9,
)

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


# ------------------------------------------------------------ collectives --


def collective_bytes_from_trace(records: Iterable[Tuple[str, float, int]]
                                ) -> Dict[str, float]:
    """Per-device collective traffic of a trace's collectives.

    ``records``: ``(kind, result_bytes, group_size)`` per collective, kind
    one of :data:`COLLECTIVES`.  Returns ``{"naive": sum of operand bytes,
    "ring": schedule-weighted bytes, one entry per kind, "count": number
    of collectives}`` (the reference's ``collective_bytes_from_hlo``
    dict).
    """
    naive = 0.0
    ring = 0.0
    by_kind: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
    count = 0
    for op, bytes_result, g in records:
        if op not in by_kind:
            raise ValueError(f"unknown collective {op!r}")
        if bytes_result == 0:
            continue
        frac = (g - 1) / g if g > 1 else 0.0
        if op == "all-gather":
            # result holds the gathered (operand × g); device receives (g-1)/g
            moved = bytes_result * frac
            operand = bytes_result / max(g, 1)
        elif op == "all-reduce":
            operand = bytes_result
            moved = 2.0 * operand * frac
        elif op == "reduce-scatter":
            operand = bytes_result * g  # result is operand/g
            moved = operand * frac
        elif op == "all-to-all":
            operand = bytes_result
            moved = operand * frac
        else:  # collective-permute: single hop of the operand
            operand = bytes_result
            moved = operand
        naive += operand
        ring += moved
        by_kind[op] += moved
        count += 1
    return {"naive": naive, "ring": ring, "count": float(count), **by_kind}


# ------------------------------------------------------------ model flops --


def model_flops(cfg, tokens: int) -> float:
    """Useful model FLOPs: 6·N·D (dense) or 6·N_active·D (MoE)."""
    n = cfg.active_param_count()
    return 6.0 * n * tokens


# ----------------------------------------------------------------- report --


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    per_device_flops: float
    per_device_bytes: float
    collective_naive: float
    collective_ring: float
    collective_count: int
    peak_mem_bytes: float
    arg_bytes: float
    model_flops_total: float
    hw: HardwareSpec = HW_H100

    # --- derived terms (seconds) ---
    @property
    def compute_s(self) -> float:
        return self.per_device_flops / self.hw.peak_flops

    @property
    def memory_s(self) -> float:
        return self.per_device_bytes / self.hw.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.collective_ring / self.hw.ici_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """No-overlap upper bound: max of the three terms (roofline model)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        global_flops = self.per_device_flops * self.chips
        return self.model_flops_total / max(global_flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs MFU bound at the modeled step time."""
        denom = self.step_time_s * self.hw.peak_flops * self.chips
        return self.model_flops_total / max(denom, 1e-30)

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "per_device_flops": self.per_device_flops,
            "per_device_bytes": self.per_device_bytes,
            "collective_naive": self.collective_naive,
            "collective_ring": self.collective_ring,
            "collective_count": self.collective_count,
            "peak_mem_bytes": self.peak_mem_bytes,
            "arg_bytes": self.arg_bytes,
            "model_flops_total": self.model_flops_total,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def analyze_trace(trace, *, arch: str, shape: str, mesh_name: str,
                  chips: int, mflops: float,
                  hw: HardwareSpec = HW_H100) -> RooflineReport:
    """Build a RooflineReport from a :class:`~.trace.StepTrace` (one
    rank's traced step)."""
    coll = collective_bytes_from_trace(trace.collectives)
    mem = trace.memory
    peak = (mem["temp_bytes"] + mem["argument_bytes"] + mem["output_bytes"]
            - mem["alias_bytes"])
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        per_device_flops=float(trace.flops),
        per_device_bytes=float(trace.bytes_accessed),
        collective_naive=coll["naive"],
        collective_ring=coll["ring"],
        collective_count=int(coll["count"]),
        peak_mem_bytes=float(peak),
        arg_bytes=float(mem["argument_bytes"]),
        model_flops_total=mflops,
        hw=hw,
    )

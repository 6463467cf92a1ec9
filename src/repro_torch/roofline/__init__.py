"""Roofline analysis from traced dry-run steps (no card needed).

Counterpart of ``repro.roofline``: ``collective_bytes_from_hlo`` and
``analyze_compiled`` become :func:`collective_bytes_from_trace` and
:func:`analyze_trace` (the port reads a trace, not an HLO module)."""

from .analysis import (
    HW_H100,
    HW_V5E,
    HardwareSpec,
    RooflineReport,
    analyze_trace,
    collective_bytes_from_trace,
    model_flops,
)

__all__ = [
    "HW_H100",
    "HW_V5E",
    "HardwareSpec",
    "RooflineReport",
    "analyze_trace",
    "collective_bytes_from_trace",
    "model_flops",
]

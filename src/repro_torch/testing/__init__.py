"""Fault-injection and conformance tooling of the hardened runtime
(DESIGN.md §15).

:mod:`repro_torch.testing.faults` corrupts formats, caches and kernel
arguments on purpose and asserts the runtime either names the violated
invariant (:class:`repro_torch.core.validate.ValidationError`) or
recovers: falls back down the capability ladder to the oracle answer,
salvages the cache, or counts the event::

    python -m repro_torch.testing.faults --op spmm --impl cuda --no-strict

:mod:`repro_torch.testing.conformance` is the positive gate: every
registered ``(op, impl, precision)`` of the port against the dense oracle
on the vendored real matrices (``tests/data``)::

    python -m repro_torch.testing.conformance --datasets tridiag_64

:mod:`repro_torch.testing.multirank` runs the sharded ops on several
gloo ranks of the CPU (one spawn, a ``FileStore`` rendezvous), for the
tests that hold the multi-device layer against the reference;
:mod:`repro_torch.testing.multicard` runs the sharded GNN routes across
cards under torchrun against the one-card route and times them::

    torchrun --nproc_per_node=4 -m repro_torch.testing.multicard

:mod:`repro_torch.testing.lm_card` checks and times the LM serving path
on one card (qwen3-0.6b at full width, its server, every family)::

    python -m repro_torch.testing.lm_card
"""

from .conformance import (
    ConformanceCase,
    ConformanceRecord,
    enumerate_cases,
    format_report,
    run_conformance,
    summarize,
)
from .conformance import self_test as conformance_self_test
from .faults import (
    FAULTS,
    FaultNotDetected,
    corrupt_blocked,
    corrupt_cache_file,
    run_fault,
    run_fault_suite,
)

__all__ = [
    "FAULTS",
    "ConformanceCase",
    "ConformanceRecord",
    "FaultNotDetected",
    "conformance_self_test",
    "corrupt_blocked",
    "corrupt_cache_file",
    "enumerate_cases",
    "format_report",
    "run_conformance",
    "run_fault",
    "run_fault_suite",
    "summarize",
]

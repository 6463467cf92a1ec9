"""Unified (op, impl) dispatch registry for the sparse operators.

Counterpart of ``repro.core.dispatch`` without the fallback ladders.
Every implementation of an op registers here exactly once, and every
layer (core entry points, autodiff plans, models, train steps) resolves
``(op, impl)`` through the same table.

Registered ops: ``spmm``, ``sddmm`` and ``attention`` (SDDMM → sparse
softmax → SpMM).  Impl names:

  blocked          plain PyTorch (gather + einsum + index_add), the
                   counterpart of the XLA ``blocked`` impl
  coo_segment/coo  element-wise oracles
  cuda             the hand-written SpMM and SDDMM kernels, the
                   counterpart of ``pallas``
  cuda_fused_attn  the single-pass attention kernel, the counterpart of
                   ``pallas_fused_attn``
  cuda_balanced    the block-parallel SpMM, SDDMM and attention kernels
                   over a ``Schedule`` (``schedule=`` / ``split_blk=``
                   kwargs), the counterpart of ``pallas_balanced``
  cuda_batched     the SpMM and SDDMM kernels over a head grid, one launch
                   for H heads, the counterpart of ``pallas_batched``
  cuda_staged      SpMM over a staged gather ``B[cols]`` (the pre-fusion
                   baseline) and, for ``attention``, the batched SDDMM →
                   sparse softmax → batched SpMM composition; the
                   counterparts of ``pallas_staged``
  cuda_noncoalesced  SpMM with the thread mapping the paper's coalesced
                   one replaces (Fig. 15), the counterpart of
                   ``pallas_noncoalesced``

Capability flags, enforced by :func:`require`:

  differentiable  the impl has a gradient path, natively (``blocked``'s
                  PyTorch ops) or through the ``torch.autograd.Function``s
                  of :mod:`repro_torch.core.autodiff`, which need the
                  adjacency as an ``ADPlan``;
  batched         the impl takes operands with a leading head dimension
                  (a 2-D operand is shared by every head) and serves every
                  head in one pass: one launch for a kernel impl;

plus the ``precisions`` tuple (DESIGN.md §13): the precision levels the
impl runs at, a subset of ``("fp32", "bf16", "int8")``; every impl
defaults to fp32 only.  The entry points check it with :func:`require`
and cast (or quantize) the operands once before the call, so an impl
sees only operands already at its precision.

A **call log** records every dispatch: ``record_calls()`` yields a list
that accumulates ``(op, impl)`` pairs while the context is active.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import threading
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["OpImpl", "register", "get", "impls", "require", "dispatch",
           "record_calls"]


@dataclasses.dataclass(frozen=True)
class OpImpl:
    """One registered implementation of a sparse op."""

    op: str
    name: str
    fn: Callable
    differentiable: bool = False
    batched: bool = False
    precisions: Tuple[str, ...] = ("fp32",)


_REGISTRY: Dict[Tuple[str, str], OpImpl] = {}

# Modules that register implementations at import time; ``get`` imports
# them lazily so the table is complete whichever layer touches it first.
_PROVIDERS = ("repro_torch.core.spmm", "repro_torch.core.sddmm",
              "repro_torch.kernels.ops")
_loaded = False
_lock = threading.Lock()


def register(op: str, name: str, fn: Callable, **flags) -> OpImpl:
    """Register ``fn`` as implementation ``name`` of ``op`` with the
    capability ``flags`` of :class:`OpImpl`."""
    entry = OpImpl(op=op, name=name, fn=fn, **flags)
    _REGISTRY[(op, name)] = entry
    return entry


def _ensure_loaded() -> None:
    global _loaded
    if _loaded:
        return
    with _lock:
        if not _loaded:
            for mod in _PROVIDERS:
                importlib.import_module(mod)
            _loaded = True


def get(op: str, impl: str) -> OpImpl:
    """Resolve ``(op, impl)`` → :class:`OpImpl`, loading providers lazily."""
    _ensure_loaded()
    entry = _REGISTRY.get((op, impl))
    if entry is None:
        raise ValueError(f"unknown impl {impl!r} for op {op!r}; "
                         f"available: {', '.join(impls(op)) or '(none)'}")
    return entry


def impls(op: str) -> Tuple[str, ...]:
    """Registered implementation names for ``op`` (sorted)."""
    _ensure_loaded()
    return tuple(sorted(n for (o, n) in _REGISTRY if o == op))


def require(op: str, impl: str, *, differentiable: bool = False,
            batched: bool = False,
            precision: Optional[str] = None) -> OpImpl:
    """Resolve ``(op, impl)`` and enforce the capability flags and the
    precision level, raising a ``ValueError`` that lists the impls that
    have the missing one."""
    entry = get(op, impl)
    if precision is not None and precision not in entry.precisions:
        ok = [n for n in impls(op)
              if precision in _REGISTRY[(op, n)].precisions]
        raise ValueError(
            f"impl {impl!r} of op {op!r} does not support precision "
            f"{precision!r} (supports: {', '.join(entry.precisions)}); "
            f"impls with {precision!r}: {', '.join(ok) or '(none)'}")
    for flag, wanted, text in (
            ("differentiable", differentiable, "is not differentiable"),
            ("batched", batched, "has no native batched path")):
        if wanted and not getattr(entry, flag):
            ok = [n for n in impls(op) if getattr(_REGISTRY[(op, n)], flag)]
            raise ValueError(f"impl {impl!r} of op {op!r} {text}; {flag} "
                             f"impls: {', '.join(ok) or '(none)'}")
    return entry


# ---------------------------------------------------------------------------
# Call log
# ---------------------------------------------------------------------------

_local = threading.local()


def _recorders() -> List[List[Tuple[str, str]]]:
    recs = getattr(_local, "recorders", None)
    if recs is None:
        recs = _local.recorders = []
    return recs


@contextlib.contextmanager
def record_calls():
    """Context manager yielding a list that accumulates ``(op, impl)``
    pairs for every :func:`dispatch` made while the context is active."""
    log: List[Tuple[str, str]] = []
    _recorders().append(log)
    try:
        yield log
    finally:
        _recorders().remove(log)


def dispatch(op: str, impl: str, *args, **kwargs):
    """Resolve ``(op, impl)`` and call it, recording in the call log."""
    entry = get(op, impl)
    for rec in _recorders():
        rec.append((op, impl))
    return entry.fn(*args, **kwargs)

"""Unified (op, impl) dispatch registry for the sparse operators.

Counterpart of ``repro.core.dispatch`` without the fallback ladders.
Every implementation of an op registers here exactly once, and every
layer (core entry points, autodiff plans, models) resolves ``(op, impl)``
through the same table.

Registered ops: ``spmm``, ``sddmm`` and ``attention`` (SDDMM → sparse
softmax → SpMM).  Impl names:

  blocked          plain PyTorch (gather + einsum + index_add), the
                   counterpart of the XLA ``blocked`` impl
  coo_segment/coo  element-wise oracles
  cuda             the hand-written SpMM and SDDMM kernels, the
                   counterpart of ``pallas``
  cuda_fused_attn  the single-pass attention kernel, the counterpart of
                   ``pallas_fused_attn``

A **call log** records every dispatch: ``record_calls()`` yields a list
that accumulates ``(op, impl)`` pairs while the context is active.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import threading
from typing import Callable, Dict, List, Tuple

__all__ = ["OpImpl", "register", "get", "impls", "require", "dispatch",
           "record_calls"]


@dataclasses.dataclass(frozen=True)
class OpImpl:
    """One registered implementation of a sparse op."""

    op: str
    name: str
    fn: Callable


_REGISTRY: Dict[Tuple[str, str], OpImpl] = {}

# Modules that register implementations at import time; ``get`` imports
# them lazily so the table is complete whichever layer touches it first.
_PROVIDERS = ("repro_torch.core.spmm", "repro_torch.core.sddmm",
              "repro_torch.kernels.ops")
_loaded = False
_lock = threading.Lock()


def register(op: str, name: str, fn: Callable) -> OpImpl:
    """Register ``fn`` as implementation ``name`` of ``op``."""
    entry = OpImpl(op=op, name=name, fn=fn)
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


def require(op: str, impl: str) -> OpImpl:
    """Resolve ``(op, impl)`` or raise a ``ValueError`` listing the
    registered impls."""
    return get(op, impl)


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

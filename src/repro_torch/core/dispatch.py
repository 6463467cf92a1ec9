"""Unified (op, impl) dispatch registry for the sparse operators.

Counterpart of ``repro.core.dispatch``.  Every implementation of an op
registers here exactly once, and every layer (core entry points,
autodiff plans, models, train steps) resolves ``(op, impl)`` through the
same table.

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
  cuda_tuned       SpMM and SDDMM through the autotuner
                   (``kernels/autotune.py``): the window-parallel or the
                   block-parallel kernel and their tiles per matrix class;
                   ``cuda_fused_attn_tuned`` the same for attention; the
                   counterparts of ``pallas_tuned`` and
                   ``pallas_fused_attn_tuned``
  cuda_sharded     one rank-local launch of the block-parallel kernels per
                   rank of a ``DeviceMesh`` and an ``all_reduce``
                   (``distributed/sparse_shard.py``); ``cuda_sharded_overlap``
                   the same over segment batches on a send/recv ring
                   (``distributed/sparse_shard_overlap.py``); the
                   counterparts of ``pallas_sharded`` and
                   ``pallas_sharded_overlap``

Capability flags, enforced by :func:`require`:

  differentiable  the impl has a gradient path, natively (``blocked``'s
                  PyTorch ops) or through the ``torch.autograd.Function``s
                  of :mod:`repro_torch.core.autodiff`, which need the
                  adjacency as an ``ADPlan``;
  batched         the impl takes operands with a leading head dimension
                  (a 2-D operand is shared by every head) and serves every
                  head in one pass: one launch for a kernel impl;
  needs_canonical the impl takes the canonical :class:`MEBCRS` (the
                  autotuned impls re-block it per ``k_blk`` candidate) and
                  the precision level itself (``precision=``), which the
                  entry points then pass on instead of casting first;
  returns_format  the impl returns a :class:`BlockedMEBCRS` with the
                  values bound instead of a bare value array (the tuned
                  SDDMM: the value layout depends on the tuned ``k_blk``);
  load_balanced   the impl maps work onto a ``Schedule``'s uniform
                  segments (the block-parallel ``cuda_balanced`` kernels)
                  and takes ``schedule=`` / ``split_blk=``, which the
                  fallback ladder drops on the rungs without the flag;
  multi_device    the impl runs one rank-local launch per rank of a mesh
                  over a partitioned schedule and takes ``mesh=`` /
                  ``part=``; every rank returns the whole output;
  overlapped      the impl pipelines the reduce behind compute over
                  segment batches on a send/recv ring and takes
                  ``n_batches=`` (``ADPlan.overlap_batches``);

plus the ``precisions`` tuple (DESIGN.md §13): the precision levels the
impl runs at, a subset of ``("fp32", "bf16", "int8")``; every impl
defaults to fp32 only.  The entry points check it with :func:`require`
and cast (or quantize) the operands once before the call, so an impl
sees only operands already at its precision.

A **call log** records every dispatch: ``record_calls()`` yields a list
that accumulates ``(op, impl)`` pairs while the context is active.

**Graceful degradation** (DESIGN.md §15), opt-in: :func:`robust_dispatch`
walks a capability ladder (:func:`fallback_chain`, fastest rung first)
when the requested impl fails, with one :class:`FallbackWarning`, a
``fallback:<requested>-><used>`` call-log entry and the
``dispatch_fallback`` counter per recovery; ``strict=True`` re-raises
instead, and a :class:`~repro_torch.core.validate.ValidationError` always
re-raises.  On CUDA operands the ladder keeps only its kernel rungs
(``cuda*``): a kernel that refuses on the card never gives way to a plain
PyTorch rung, and the call raises when no kernel rung serves.
``guard_nonfinite=True`` re-runs a bf16/int8 call at fp32 when its output
is not finite (``guard_nonfinite_rerun``, :func:`rescue_nonfinite`).  The port's
impls take operands already at their precision (the entry points cast
first, except for ``needs_canonical`` impls, which take ``precision=``),
so the ladder applies each rung's precision itself through the hook the
op's entry-point module registers (:func:`register_precision`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import inspect
import threading
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import torch

__all__ = ["OpImpl", "register", "get", "impls", "require", "dispatch",
           "record_calls", "FallbackWarning", "fallback_chain",
           "fallback_for", "register_precision", "rescue_nonfinite",
           "robust_dispatch"]


@dataclasses.dataclass(frozen=True)
class OpImpl:
    """One registered implementation of a sparse op."""

    op: str
    name: str
    fn: Callable
    differentiable: bool = False
    batched: bool = False
    needs_canonical: bool = False
    returns_format: bool = False
    load_balanced: bool = False
    multi_device: bool = False
    overlapped: bool = False
    precisions: Tuple[str, ...] = ("fp32",)


_REGISTRY: Dict[Tuple[str, str], OpImpl] = {}

# Modules that register implementations at import time; ``get`` imports
# them lazily so the table is complete whichever layer touches it first.
_PROVIDERS = ("repro_torch.core.spmm", "repro_torch.core.sddmm",
              "repro_torch.kernels.ops",
              "repro_torch.distributed.sparse_shard",
              "repro_torch.distributed.sparse_shard_overlap")
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


def _log(op: str, impl: str) -> None:
    for rec in _recorders():
        rec.append((op, impl))


def dispatch(op: str, impl: str, *args, **kwargs):
    """Resolve ``(op, impl)`` and call it, recording in the call log."""
    entry = get(op, impl)
    _log(op, impl)
    return entry.fn(*args, **kwargs)


# ---------------------------------------------------------------------------
# Graceful degradation (DESIGN.md §15)
# ---------------------------------------------------------------------------


class FallbackWarning(UserWarning):
    """A requested impl failed and the op recovered on a lower ladder rung.

    One structured warning per recovered dispatch: ``op``/``requested``/
    ``used`` name the ladder walk, ``failures`` holds ``(impl, "Type:
    message")`` for every rung that failed before the one that served.
    The port's tests turn it into an error, so silent degradation never
    hides a kernel fault there.
    """

    def __init__(self, op: str, requested: str, used: str, failures):
        self.op = op
        self.requested = requested
        self.used = used
        self.failures = tuple(
            (n, f"{type(e).__name__}: {str(e)[:200]}") for n, e in failures)
        detail = "; ".join(f"{n} ({t})" for n, t in self.failures)
        super().__init__(
            f"op {op!r}: impl {requested!r} degraded to {used!r} after "
            f"{len(self.failures)} failed rung(s): {detail}")


# Capability ladders, fastest first.  ``robust_dispatch`` enters at the
# requested impl and walks right; impls not on a ladder (the SpMM
# baselines cuda_staged and cuda_noncoalesced) enter at the default tier.
# The sddmm ladder ends at ``blocked``: the ``coo`` impl returns edge
# values (NNZ,), another output contract than the blocked-layout rungs.
_LADDERS: Dict[str, Tuple[str, ...]] = {
    "spmm": ("cuda_sharded_overlap", "cuda_sharded", "cuda_tuned",
             "cuda_balanced", "cuda_batched", "cuda", "blocked",
             "coo_segment"),
    "sddmm": ("cuda_sharded_overlap", "cuda_sharded", "cuda_tuned",
              "cuda_balanced", "cuda_batched", "cuda", "blocked"),
    "attention": ("cuda_sharded_overlap", "cuda_sharded",
                  "cuda_fused_attn_tuned", "cuda_balanced",
                  "cuda_fused_attn", "cuda_staged", "blocked"),
}
_DEFAULT_TIER = {"spmm": "cuda", "sddmm": "cuda", "attention": "cuda_staged"}
# Impls whose output contract matches no other rung: never degrade.
_NO_FALLBACK = {("sddmm", "coo")}
# A rung that lacks the requested level widens it (never the reverse: a
# fallback must not lose accuracy).
_PRECISION_FALLBACK = {"int8": ("bf16", "fp32"), "bf16": ("fp32",)}
# op -> fn(args, precision, k_blk) -> args at that precision, for the
# impls that take operands already cast (registered by the entry points).
_PRECISION_HOOKS: Dict[str, Callable] = {}


def register_precision(op: str, fn: Callable) -> None:
    """Register how ``op``'s operands are brought to a precision level:
    ``fn(args, precision, k_blk)`` returns the call's positional
    arguments at ``precision``, as the op's entry point casts them."""
    _PRECISION_HOOKS[op] = fn


def _is_kernel(impl: str) -> bool:
    return impl.startswith("cuda")


def fallback_chain(op: str, impl: str, *,
                   on_card: bool = False) -> Tuple[str, ...]:
    """The ladder rungs ``robust_dispatch`` tries after ``impl`` fails;
    ``on_card`` keeps only the kernel rungs (the operands are CUDA
    tensors, where no kernel gives way to a plain rung)."""
    if (op, impl) in _NO_FALLBACK:
        return ()
    ladder = _LADDERS.get(op, ())
    if impl in ladder:
        chain = ladder[ladder.index(impl) + 1:]
    else:
        tier = _DEFAULT_TIER.get(op)
        chain = ladder[ladder.index(tier):] if tier in ladder else ladder
    if on_card:
        chain = tuple(name for name in chain if _is_kernel(name))
    return chain


def _static_compatible(entry: OpImpl, orig: OpImpl) -> bool:
    return entry.returns_format == orig.returns_format


def fallback_for(op: str, impl: str) -> Optional[str]:
    """The first registered, contract-compatible rung below ``impl``."""
    try:
        orig = get(op, impl)
    except ValueError:
        return None
    for name in fallback_chain(op, impl):
        entry = _REGISTRY.get((op, name))
        if entry is not None and _static_compatible(entry, orig):
            return name
    return None


def _compatible(entry: OpImpl, orig: OpImpl, args) -> bool:
    """Can this rung serve the original request's contract and inputs?"""
    if not _static_compatible(entry, orig):
        return False
    if entry.needs_canonical and args:
        from .format import BlockedMEBCRS

        if isinstance(args[0], BlockedMEBCRS):
            return False
    return True


_sig_cache: Dict[Tuple[str, str], Optional[frozenset]] = {}


def _accepted_params(entry: OpImpl) -> Optional[frozenset]:
    """Keyword names ``entry.fn`` accepts; ``None`` = accepts anything."""
    key = (entry.op, entry.name)
    if key not in _sig_cache:
        try:
            params = inspect.signature(entry.fn).parameters.values()
        except (TypeError, ValueError):  # builtins / C callables
            _sig_cache[key] = None
        else:
            if any(p.kind == p.VAR_KEYWORD for p in params):
                _sig_cache[key] = None
            else:
                _sig_cache[key] = frozenset(
                    p.name for p in params
                    if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY))
    return _sig_cache[key]


def _adapt_kwargs(entry: OpImpl, kwargs: Dict) -> Dict:
    """Project a request's kwargs onto what a ladder rung understands.

    ``schedule``/``split_blk`` are dropped for rungs without the
    ``load_balanced`` capability, ``mesh``/``part`` for rungs without
    ``multi_device`` and ``n_batches`` for rungs without ``overlapped``; a
    ``precision`` the rung lacks widens along ``_PRECISION_FALLBACK``;
    then the rung's signature filters anything it cannot accept,
    ``precision`` aside (:func:`_call` applies it to the operands of the
    rungs that take them already cast).
    """
    kw = dict(kwargs)
    if not entry.load_balanced:
        kw.pop("schedule", None)
        kw.pop("split_blk", None)
    if not entry.multi_device:
        kw.pop("mesh", None)
        kw.pop("part", None)
    if not entry.overlapped:
        kw.pop("n_batches", None)
    prec = kw.get("precision")
    if prec is not None and prec not in entry.precisions:
        for cand in _PRECISION_FALLBACK.get(prec, ()):
            if cand in entry.precisions:
                kw["precision"] = cand
                break
        else:
            kw.pop("precision", None)
    allowed = _accepted_params(entry)
    if allowed is not None:
        kw = {k: v for k, v in kw.items()
              if k in allowed or k == "precision"}
    return kw


def _call(entry: OpImpl, args, kw: Dict):
    """Run one rung: a ``needs_canonical`` impl takes ``precision=``
    itself, any other gets its operands at that precision from the op's
    hook (:func:`register_precision`)."""
    kw = dict(kw)
    prec = kw.pop("precision", None)
    if prec is not None:
        if entry.needs_canonical:
            kw["precision"] = prec
        else:
            args = _PRECISION_HOOKS[entry.op](args, prec,
                                              kw.get("k_blk", 8))
    return entry.fn(*args, **kw)


def _on_card(args) -> bool:
    """Does any operand, or any tensor of a format operand, live on the
    card?"""
    for a in args:
        if dataclasses.is_dataclass(a) and not isinstance(a, type):
            a = [getattr(a, f.name) for f in dataclasses.fields(a)]
        else:
            a = [a]
        if any(isinstance(t, torch.Tensor) and t.is_cuda for t in a):
            return True
    return False


def _extract_values(out):
    """(container-or-None, value tensor) of an impl result."""
    if hasattr(out, "vals") and hasattr(out, "win_ptr"):
        return out, out.vals
    return None, out


def _count(name: str) -> None:
    from .metrics import record_counter

    record_counter(name)


def rescue_nonfinite(op: str, impl: str, precision: str,
                     out: torch.Tensor, rerun: Callable) -> torch.Tensor:
    """The non-finite rescue (DESIGN.md §15) of a narrow (bf16/int8)
    output ``out``: kept, promoted to fp32, when finite; else replaced by
    ``rerun()`` (the same call at fp32) with one :class:`FallbackWarning`,
    a ``guard:<impl>:fp32-rerun`` call-log entry and the
    ``guard_nonfinite_rerun`` counter.  The result is fp32 either way:
    casting the rescue back to the narrow dtype would overflow the very
    values it rescued.  The finiteness test is one host sync."""
    if bool(torch.isfinite(out).all()):
        return out.float()
    warnings.warn(FallbackWarning(
        op, f"{impl}[{precision}]", f"{impl}[fp32]",
        [(impl, FloatingPointError("non-finite output"))]), stacklevel=3)
    _count("guard_nonfinite_rerun")
    _log(op, f"guard:{impl}:fp32-rerun")
    return rerun().float()


def _guard_nonfinite(entry: OpImpl, args, kw: Dict, out):
    """:func:`rescue_nonfinite` on a rung's output, when the rung ran at
    bf16/int8 and has an fp32 level to re-run at."""
    if kw.get("precision") not in ("bf16", "int8"):
        return out
    if "fp32" not in entry.precisions:
        return out
    container, arr = _extract_values(out)
    if not arr.is_floating_point():
        return out
    fixed = rescue_nonfinite(
        entry.op, entry.name, kw["precision"], arr,
        lambda: _extract_values(
            _call(entry, args, {**kw, "precision": "fp32"}))[1])
    if container is not None:
        return dataclasses.replace(container, vals=fixed, scales=None)
    return fixed


def robust_dispatch(op: str, impl: str, *args, strict: bool = False,
                    guard_nonfinite: bool = False, **kwargs):
    """Dispatch with graceful degradation down the capability ladder.

    Tries ``impl`` first; on failure walks :func:`fallback_chain`, skipping
    rungs whose output contract or input requirements differ, adapting
    kwargs per rung (:func:`_adapt_kwargs`).  ``args`` are the operands as
    the caller gave them, and ``precision`` stays a kwarg: each rung runs
    at the level it has (:func:`_call`).  A recovery emits one
    :class:`FallbackWarning`, a call-log record
    ``(op, "fallback:<requested>-><used>")`` and counts
    ``dispatch_fallback``.  ``strict=True`` re-raises the requested impl's
    error instead of degrading.  On CUDA operands only the kernel rungs
    are tried (``fallback_chain(..., on_card=True)``): when none serves,
    the call raises rather than land on a plain PyTorch rung.  A
    :class:`~repro_torch.core.validate.ValidationError` always re-raises:
    a corrupted format computes the wrong answer on every rung.

    ``guard_nonfinite=True`` also re-runs a bf16/int8 call at fp32 when
    its output is not finite (:func:`_guard_nonfinite`).
    """
    from .validate import ValidationError

    orig = get(op, impl)
    on_card = _on_card(args)
    failures: List[Tuple[str, Exception]] = []
    for name in (impl,) + fallback_chain(op, impl, on_card=on_card):
        entry = _REGISTRY.get((op, name))
        if entry is None:
            continue
        if name != impl and not _compatible(entry, orig, args):
            continue
        kw = _adapt_kwargs(entry, kwargs)
        _log(op, name)
        try:
            out = _call(entry, args, kw)
        except ValidationError:
            raise
        except Exception as e:  # noqa: BLE001 — the ladder retries below
            if strict:
                raise
            failures.append((name, e))
            continue
        if guard_nonfinite:
            out = _guard_nonfinite(entry, args, kw, out)
        if failures:
            warnings.warn(FallbackWarning(op, impl, name, failures),
                          stacklevel=2)
            _log(op, f"fallback:{impl}->{name}")
            _count("dispatch_fallback")
        return out
    raise RuntimeError(
        f"op {op!r}: impl {impl!r} and every compatible fallback rung "
        f"{'(kernel rungs only, on CUDA operands) ' if on_card else ''}"
        f"failed: " + "; ".join(
            f"{n} ({type(e).__name__}: {str(e)[:200]})"
            for n, e in failures)) from (failures[-1][1] if failures
                                         else None)

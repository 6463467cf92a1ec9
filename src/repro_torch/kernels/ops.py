"""Registry adapters of the hand-written CUDA kernels.

Counterpart of ``repro.kernels.ops``'s adapters: uniform signatures
shared with the plain adapters in ``core/spmm.py`` and ``core/sddmm.py``,
so every layer resolves ``(op, impl)`` the same way.

  spmm      "cuda"               → :func:`spmm_cuda`      (``pallas``)
  sddmm     "cuda"               → :func:`sddmm_cuda`     (``pallas``)
  attention "cuda_fused_attn"    → :func:`attention_cuda` (``pallas_fused_attn``)
  spmm      "cuda_batched"       → :func:`spmm_batched_cuda`
  sddmm     "cuda_batched"       → :func:`sddmm_batched_cuda`
                                   (the two ``pallas_batched``)
  attention "cuda_staged"        → :func:`attention_cuda_staged`
                                   (``pallas_staged``)
  spmm      "cuda_balanced"      → :func:`spmm_balanced_cuda`
  sddmm     "cuda_balanced"      → :func:`sddmm_balanced_cuda`
  attention "cuda_balanced"      → :func:`attention_balanced_cuda`
                                   (the three ``pallas_balanced``)
  spmm      "cuda_staged"        → :func:`spmm_staged_cuda` (``pallas_staged``)
  spmm      "cuda_noncoalesced"  → :func:`spmm_noncoalesced_cuda`
                                   (``pallas_noncoalesced``)
  spmm      "cuda_tuned"         → :func:`spmm_tuned`
  sddmm     "cuda_tuned"         → :func:`sddmm_tuned` (the two
                                   ``pallas_tuned``)
  attention "cuda_fused_attn_tuned" → :func:`attention_tuned`
                                   (``pallas_fused_attn_tuned``)

The ``cuda_balanced`` adapters take ``schedule=`` (a precomputed
:class:`~repro_torch.core.format.Schedule`) or ``split_blk=`` (the
schedule is built and memoized on the blocked view).  A canonical format
is blocked with ``k_blk`` on the dense operand's device.  The flags follow
the reference's: ``differentiable`` impls run backward through the
autograd Functions of ``core/autodiff.py``; ``batched`` impls take a
leading head dimension in one launch.  The attention ``cuda_staged`` and
the two SpMM baselines are forward only, as in the reference.  The
``precisions`` follow the kernels' variants (DESIGN.md §13) and equal the
reference's: every SpMM but the staged baseline takes fp32, bf16 and
int8 (``cuda_staged`` fp32 and bf16), every SDDMM and attention fp32 and
bf16.

The tuned impls (``needs_canonical``) take the canonical format: the
autotuner (:mod:`.autotune`) blocks it at each candidate ``k_blk``, times
the window-parallel and the block-parallel kernels, caches the winner per
matrix class and runs it.  They take the precision level themselves
(``precision=``) and pin the sweep to it, as the reference's.  The tuned
SDDMM returns the blocked view with the scores bound as its values
(``returns_format``): their layout depends on the tuned ``k_blk``.  The
tuned attention is forward only; GNN training tunes through
``ad_plan(impl="cuda_tuned")``.
"""

from __future__ import annotations

from repro_torch.core import dispatch as _dispatch
from repro_torch.core.format import BlockedMEBCRS, block_format, blocked_view
from repro_torch.core.quantize import cast_precision
from repro_torch.core.sddmm import with_values
from repro_torch.core.spmm import _optional, apply_precision

from . import autotune
from .attention_balanced_cuda import attention_balanced_cuda
from .attention_cuda import attention_cuda, attention_cuda_staged
from .sddmm_balanced_cuda import sddmm_balanced_cuda
from .sddmm_batched_cuda import sddmm_batched_cuda
from .sddmm_cuda import sddmm_cuda
from .spmm_balanced_cuda import spmm_balanced_cuda
from .spmm_batched_cuda import spmm_batched_cuda
from .spmm_cuda import spmm_cuda
from .spmm_noncoalesced_cuda import spmm_noncoalesced_cuda
from .spmm_staged_cuda import spmm_staged_cuda

__all__ = ["spmm_cuda", "sddmm_cuda", "attention_cuda", "spmm_batched_cuda",
           "sddmm_batched_cuda", "attention_cuda_staged",
           "spmm_balanced_cuda", "sddmm_balanced_cuda",
           "attention_balanced_cuda", "spmm_staged_cuda",
           "spmm_noncoalesced_cuda", "spmm_tuned_plan", "spmm_tuned",
           "sddmm_tuned", "attention_tuned"]


def _precisions(precision, precisions):
    """The sweep's precision levels: ``precisions``, else ``precision``
    alone, else ``None`` (the operands' own dtypes)."""
    if precisions is None and precision is not None:
        precisions = (precision,)
    return None if precisions is None else tuple(precisions)


def spmm_tuned_plan(fmt, b, *, cache=None, k_blks=None, n_blks=None,
                    precisions=None):
    """The tuned SpMM's ``(cfg, blocked)``: the sweep's winner for this
    matrix class and N (cached), and the format blocked at its ``k_blk``
    on ``b``'s device.  ``precisions`` (e.g. ``("fp32", "bf16")``) adds
    the dtype axis to the sweep; the winner's level is ``cfg.precision``.
    """
    cfg = autotune.tune_spmm(fmt, b, cache=cache, **_optional(
        k_blks=k_blks, n_blks=n_blks,
        precisions=_precisions(None, precisions)))
    return cfg, blocked_view(fmt, cfg.k_blk, b.device)


def spmm_tuned(fmt, b, *, cache=None, k_blks=None, n_blks=None,
               precision=None, precisions=None):
    """Autotuned SpMM on the canonical ``fmt``: sweep (or find in the
    cache) ``(k_blk, n_blk, split_blk)``, then run the winner, the
    window-parallel kernel (the head grid for a 3-D B) or the
    block-parallel one over its schedule.  ``precision`` pins one level,
    ``precisions`` sweeps a set; with neither the operands run at their
    own dtypes."""
    precisions = _precisions(precision, precisions)
    cfg, blocked = spmm_tuned_plan(fmt, b, cache=cache, k_blks=k_blks,
                                   n_blks=n_blks, precisions=precisions)
    if precisions is not None:
        blocked, b = apply_precision(blocked, b, cfg.precision)
    b = b.contiguous()
    if cfg.split_blk:
        return spmm_balanced_cuda(blocked, b, split_blk=cfg.split_blk,
                                  n_blk=cfg.n_blk)
    window = spmm_batched_cuda if b.dim() == 3 else spmm_cuda
    return window(blocked, b, n_blk=cfg.n_blk)


def sddmm_tuned(fmt, q, k, *, cache=None, k_blks=None, f_blks=None,
                precision=None, precisions=None) -> BlockedMEBCRS:
    """Autotuned SDDMM on the canonical ``fmt``: sweep (or find) its
    ``k_blk``, run the window kernel (the head grid for 3-D Q or K), and
    return the blocked view at that ``k_blk`` with the scores bound as its
    values, ready for the SpMM that follows."""
    precisions = _precisions(precision, precisions)
    cfg = autotune.tune_sddmm(fmt, q, k, cache=cache, **_optional(
        k_blks=k_blks, f_blks=f_blks, precisions=precisions))
    blocked = blocked_view(fmt, cfg.k_blk, q.device)
    if precisions is not None:
        q, k = cast_precision(cfg.precision, q, k)
    heads = q.dim() == 3 or k.dim() == 3
    run = sddmm_batched_cuda if heads else sddmm_cuda
    return with_values(blocked, run(blocked, q.contiguous(), k.contiguous()))


def attention_tuned(fmt, q, k, v, *, scale=None, cache=None, k_blks=None,
                    precision=None, precisions=None):
    """Autotuned single-pass attention on the canonical ``fmt``: sweep (or
    find) ``(k_blk, split_blk)``, then run ``attention_cuda`` or
    ``attention_balanced_cuda`` over the winner's schedule."""
    precisions = _precisions(precision, precisions)
    cfg = autotune.tune_attention(fmt, q, k, v, cache=cache, **_optional(
        k_blks=k_blks, precisions=precisions))
    blocked = blocked_view(fmt, cfg.k_blk, q.device)
    if precisions is not None:
        q, k, v = cast_precision(cfg.precision, q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if cfg.split_blk:
        return attention_balanced_cuda(blocked, q, k, v, scale=scale,
                                       split_blk=cfg.split_blk)
    return attention_cuda(blocked, q, k, v, scale=scale)


def _ensure_blocked(fmt, k_blk: int, device) -> BlockedMEBCRS:
    return (fmt if isinstance(fmt, BlockedMEBCRS)
            else block_format(fmt, k_blk, device=device))


def _spmm_cuda_adapter(fmt, b, *, k_blk: int = 8, n_blk: int = 128):
    return spmm_cuda(_ensure_blocked(fmt, k_blk, b.device), b.contiguous(),
                     n_blk=n_blk)


def _sddmm_cuda_adapter(fmt, q, k, *, k_blk: int = 8, f_blk=None):
    del f_blk  # the kernel walks the whole feature dimension in one pass
    return sddmm_cuda(_ensure_blocked(fmt, k_blk, q.device), q.contiguous(),
                      k.contiguous())


def _attention_cuda_adapter(fmt, q, k, v, *, scale=None, k_blk: int = 8):
    return attention_cuda(_ensure_blocked(fmt, k_blk, q.device),
                          q.contiguous(), k.contiguous(), v.contiguous(),
                          scale=scale)


def _spmm_batched_adapter(fmt, b, *, k_blk: int = 8, n_blk: int = 128):
    return spmm_batched_cuda(_ensure_blocked(fmt, k_blk, b.device), b,
                             n_blk=n_blk)


def _sddmm_batched_adapter(fmt, q, k, *, k_blk: int = 8, f_blk=None):
    del f_blk  # the kernel walks the whole feature dimension in one pass
    return sddmm_batched_cuda(_ensure_blocked(fmt, k_blk, q.device), q, k)


def _attention_staged_adapter(fmt, q, k, v, *, scale=None, k_blk: int = 8,
                              n_blk: int = 128):
    return attention_cuda_staged(_ensure_blocked(fmt, k_blk, q.device), q, k,
                                 v, scale=scale, n_blk=n_blk)


def _spmm_balanced_adapter(fmt, b, *, k_blk: int = 8, n_blk: int = 128,
                           split_blk: int = 1, schedule=None):
    return spmm_balanced_cuda(_ensure_blocked(fmt, k_blk, b.device), b,
                              schedule=schedule, split_blk=split_blk,
                              n_blk=n_blk)


def _sddmm_balanced_adapter(fmt, q, k, *, k_blk: int = 8, f_blk=None,
                            split_blk: int = 1, schedule=None):
    del f_blk  # the kernel walks the whole feature dimension in one pass
    return sddmm_balanced_cuda(_ensure_blocked(fmt, k_blk, q.device), q, k,
                               schedule=schedule, split_blk=split_blk)


def _attention_balanced_adapter(fmt, q, k, v, *, scale=None, k_blk: int = 8,
                                split_blk: int = 1, schedule=None):
    return attention_balanced_cuda(_ensure_blocked(fmt, k_blk, q.device), q,
                                   k, v, scale=scale, schedule=schedule,
                                   split_blk=split_blk)


def _spmm_staged_adapter(fmt, b, *, k_blk: int = 8, n_blk: int = 128):
    return spmm_staged_cuda(_ensure_blocked(fmt, k_blk, b.device), b,
                            n_blk=n_blk)


def _spmm_noncoalesced_adapter(fmt, b, *, k_blk: int = 8, n_blk=None):
    del n_blk  # the mapping fixes the tile: 32 slices x 16 columns
    return spmm_noncoalesced_cuda(_ensure_blocked(fmt, k_blk, b.device), b)


def _require_canonical(fmt, impl: str):
    if isinstance(fmt, BlockedMEBCRS):
        raise ValueError(f"impl={impl!r} needs the canonical MEBCRS "
                         "(the autotuner re-blocks it per k_blk candidate)")
    return fmt


def _spmm_tuned_adapter(fmt, b, *, k_blk: int = 8, n_blk=None,
                        precision=None):
    del k_blk, n_blk  # the tuner picks both
    return spmm_tuned(_require_canonical(fmt, "cuda_tuned"), b,
                      precision=precision)


def _sddmm_tuned_adapter(fmt, q, k, *, k_blk: int = 8, f_blk=None,
                         precision=None):
    del k_blk, f_blk
    return sddmm_tuned(_require_canonical(fmt, "cuda_tuned"), q, k,
                       precision=precision)


def _attention_tuned_adapter(fmt, q, k, v, *, scale=None, k_blk: int = 8,
                             precision=None):
    del k_blk
    return attention_tuned(_require_canonical(fmt, "cuda_fused_attn_tuned"),
                           q, k, v, scale=scale, precision=precision)


_dispatch.register("spmm", "cuda", _spmm_cuda_adapter, differentiable=True,
                   precisions=("fp32", "bf16", "int8"))
_dispatch.register("sddmm", "cuda", _sddmm_cuda_adapter, differentiable=True,
                   precisions=("fp32", "bf16"))
_dispatch.register("attention", "cuda_fused_attn", _attention_cuda_adapter,
                   differentiable=True, batched=True,
                   precisions=("fp32", "bf16"))
# Head grids: one launch for every head, bitwise-equal to a launch per head.
_dispatch.register("spmm", "cuda_batched", _spmm_batched_adapter,
                   differentiable=True, batched=True,
                   precisions=("fp32", "bf16", "int8"))
_dispatch.register("sddmm", "cuda_batched", _sddmm_batched_adapter,
                   differentiable=True, batched=True,
                   precisions=("fp32", "bf16"))
# The three-pass baseline of the fused kernel: scores through device memory.
_dispatch.register("attention", "cuda_staged", _attention_staged_adapter,
                   batched=True, precisions=("fp32", "bf16"))
# Block-parallel load-balanced impls (DESIGN.md §11): uniform-segment grids
# driven by a host-built Schedule, for skewed matrices.
_dispatch.register("spmm", "cuda_balanced", _spmm_balanced_adapter,
                   differentiable=True, batched=True, load_balanced=True,
                   precisions=("fp32", "bf16", "int8"))
_dispatch.register("sddmm", "cuda_balanced", _sddmm_balanced_adapter,
                   differentiable=True, batched=True, load_balanced=True,
                   precisions=("fp32", "bf16"))
_dispatch.register("attention", "cuda_balanced", _attention_balanced_adapter,
                   differentiable=True, batched=True, load_balanced=True,
                   precisions=("fp32", "bf16"))
# The SpMM baselines of the paper's ablations (forward only).
_dispatch.register("spmm", "cuda_staged", _spmm_staged_adapter,
                   precisions=("fp32", "bf16"))
_dispatch.register("spmm", "cuda_noncoalesced", _spmm_noncoalesced_adapter,
                   precisions=("fp32", "bf16", "int8"))
# The autotuned impls: the window-parallel or block-parallel kernels and
# their tiles, per matrix class (they re-block the canonical format).
# Training tunes through ad_plan(impl="cuda_tuned"), whose plan fixes the
# route and tiles per direction; the tuned attention is forward only.
_dispatch.register("spmm", "cuda_tuned", _spmm_tuned_adapter,
                   differentiable=True, needs_canonical=True,
                   precisions=("fp32", "bf16", "int8"))
_dispatch.register("sddmm", "cuda_tuned", _sddmm_tuned_adapter,
                   differentiable=True, needs_canonical=True,
                   returns_format=True, precisions=("fp32", "bf16"))
_dispatch.register("attention", "cuda_fused_attn_tuned",
                   _attention_tuned_adapter, batched=True,
                   needs_canonical=True, precisions=("fp32", "bf16"))

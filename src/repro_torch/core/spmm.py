"""SpMM on ME-BCRS: C (M, N) = A_sparse (M, K) @ B_dense (K, N).

Counterpart of ``repro.core.spmm``.  Execution paths, all behind the
dispatch registry:

  * ``blocked``: the swap-and-transpose window GEMM in plain PyTorch —
    gather the B rows of every K-block, one batched contraction over the
    vector index, and an ``index_add_`` of the per-block partials into
    their windows, accumulating in fp32.
  * ``cuda`` and ``cuda_balanced`` (registered by
    :mod:`repro_torch.kernels.ops`): the hand-written kernels of
    ``kernels/csrc/spmm.cu`` and ``spmm_balanced.cu``.
  * ``coo_segment``: element-wise scatter-add SpMM, an independent oracle.

The precision axis (DESIGN.md §13): ``precision=`` on :func:`spmm` casts
the operands (``bf16``) or quantizes the values per K-block (``int8``,
B at bf16) before the impl runs (:func:`apply_precision`, the kernels'
policy); a view that carries int8 values and ``scales`` is dequantized
by every plain path, which then computes what the kernel computes.
"""

from __future__ import annotations

import dataclasses

import torch

from . import dispatch as _dispatch
from . import validate as _validate
from .format import BlockedMEBCRS, block_format, to_coo
from .quantize import (dequantize_block_values, quantize_block_values,
                       validate_precision)

__all__ = ["spmm", "spmm_blocked", "spmm_coo_segment", "spmm_dense_ref",
           "apply_precision", "dequantized"]


def spmm_dense_ref(a_dense: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense oracle: ``a @ b`` in fp32, cast to ``b``'s dtype."""
    return (a_dense.float() @ b.float()).to(b.dtype)


def _quantized(blocked: BlockedMEBCRS) -> bool:
    return blocked.scales is not None and blocked.vals.dtype == torch.int8


def dequantized(blocked: BlockedMEBCRS) -> BlockedMEBCRS:
    """``blocked`` with int8 values and ``scales`` turned into fp32 values
    (``q · scale`` per K-block); any other view as it is."""
    if not _quantized(blocked):
        return blocked
    return dataclasses.replace(
        blocked, vals=dequantize_block_values(blocked.vals, blocked.scales),
        scales=None)


def apply_precision(blocked: BlockedMEBCRS, b: torch.Tensor,
                    precision: str | None):
    """The kernels' precision policy for one SpMM: ``(blocked, b)`` with
    ``fp32``/``bf16`` casting B and float values, ``int8`` quantizing the
    values per K-block (unless the view already is) and casting B to bf16;
    ``None`` leaves both as given.  The counterpart of the reference's
    ``spmm_pallas._apply_precision``."""
    validate_precision(precision)
    vals, scales = blocked.vals, blocked.scales
    quantized = _quantized(blocked)
    if precision == "int8" and not quantized:
        vals, scales = quantize_block_values(vals, blocked.k_blk)
        quantized = True
    if precision in ("bf16", "int8"):
        b = b.to(torch.bfloat16)
        if not quantized:
            vals = vals.to(torch.bfloat16)
    elif precision == "fp32":
        b = b.float()
        if not quantized:
            vals = vals.float()
    if vals is not blocked.vals:
        blocked = dataclasses.replace(blocked, vals=vals,
                                      scales=scales if quantized else None)
    return blocked, b


def _spmm_blocked_impl(blocked: BlockedMEBCRS, b: torch.Tensor) -> torch.Tensor:
    blocked = dequantized(blocked)
    vals = blocked.vals
    batched = vals.dim() == 3 or b.dim() == 3
    vals3 = vals if vals.dim() == 3 else vals[None]
    b3 = b if b.dim() == 3 else b[None]
    h = max(vals3.shape[0], b3.shape[0])
    v = blocked.vector_size
    nb = blocked.num_blocks
    w = blocked.num_windows
    n = b3.shape[-1]
    gb = b3.float()[:, blocked.cols.long()].reshape(
        b3.shape[0], nb, blocked.k_blk, n)                 # (H|1, NB, K_BLK, N)
    vals4 = vals3.float().reshape(vals3.shape[0], nb, blocked.k_blk, v)
    # C_wᵀ = Σ_blocks B_gᵀ @ A_wᵀ: contraction over the vector index; a
    # shared operand (leading 1) broadcasts over the heads.
    partial_c = torch.einsum("hbkv,hbkn->hbvn", vals4.expand(h, -1, -1, -1),
                             gb.expand(h, -1, -1, -1))      # (H, NB, V, N)
    c_win = torch.zeros((h, w, v, n), dtype=torch.float32, device=b.device)
    c_win.index_add_(1, blocked.block_win.long(), partial_c)
    out = c_win.reshape(h, w * v, n)[:, : blocked.shape[0]].to(b.dtype)
    return out if batched else out[0]


def spmm_blocked(fmt, b: torch.Tensor, k_blk: int = 8) -> torch.Tensor:
    """Plain-PyTorch swap-and-transpose SpMM: ``C (M, N) = A @ B`` over the
    blocked view (``fmt`` may be canonical or already blocked).  Returns
    ``(M, N)`` in ``b``'s dtype; fp32 accumulation.

    Batched convention: the blocked view's ``vals`` may be ``(H, NNZP, V)``
    and ``b`` ``(H, K, N)``; a 2-D operand is shared by every head, and
    2-D in gives 2-D out, else ``(H, M, N)``."""
    blocked = (fmt if isinstance(fmt, BlockedMEBCRS)
               else block_format(fmt, k_blk, device=b.device))
    return _spmm_blocked_impl(blocked, b)


def spmm_coo_segment(rows: torch.Tensor, cols: torch.Tensor,
                     vals: torch.Tensor, b: torch.Tensor,
                     num_rows: int) -> torch.Tensor:
    """Element-wise scatter-add SpMM (CUDA-core-class baseline / oracle)."""
    contrib = vals[:, None] * b[cols.long()]
    out = torch.zeros((num_rows, b.shape[1]), dtype=contrib.dtype,
                      device=b.device)
    return out.index_add_(0, rows.long(), contrib).to(b.dtype)


def _optional(**kwargs) -> dict:
    """The keyword arguments that were given (not ``None``)."""
    return {key: val for key, val in kwargs.items() if val is not None}


def _spmm_at_precision(args, precision: str, k_blk: int):
    """``(fmt, b)`` at ``precision``, as :func:`spmm` casts them (the
    fallback ladder's hook, :func:`~repro_torch.core.dispatch.
    register_precision`)."""
    fmt, b = args
    blocked = (fmt if isinstance(fmt, BlockedMEBCRS)
               else block_format(fmt, k_blk, device=b.device))
    return apply_precision(blocked, b, precision)


def _robust(op: str, impl: str, operands, kwargs: dict, precision,
           strict, guard_nonfinite: bool):
    """The entry points' opt-in path through
    :func:`~repro_torch.core.dispatch.robust_dispatch`, as the
    reference's: ``require(precision=...)`` only when ``strict`` is
    ``None``, and ``guard_nonfinite`` alone means strict (no silent
    degradation, only the fp32 rescue)."""
    if precision is not None and strict is None:
        _dispatch.require(op, impl, precision=precision)
    return _dispatch.robust_dispatch(
        op, impl, *operands, strict=True if strict is None else bool(strict),
        guard_nonfinite=guard_nonfinite,
        **kwargs, **_optional(precision=precision))


def spmm(fmt, b: torch.Tensor, impl: str = "blocked", k_blk: int = 8,
         n_blk: int | None = None, split_blk: int | None = None,
         schedule=None, mesh=None, part=None, n_batches: int | None = None,
         precision: str | None = None,
         check: str | None = None, strict: bool | None = None,
         guard_nonfinite: bool = False) -> torch.Tensor:
    """SpMM dispatch through the registry (``dispatch.impls("spmm")``).

    ``fmt`` is the canonical :class:`~repro_torch.core.format.MEBCRS`
    (blocked on ``b``'s device with ``k_blk``) or a ``BlockedMEBCRS``;
    ``n_blk`` sets the column tile of the ``cuda*`` kernels;
    ``split_blk``/``schedule`` parameterize the block-parallel
    ``cuda_balanced`` kernel (DESIGN.md §11); ``mesh``/``part`` the
    multi-device ``cuda_sharded`` impls (a ``DeviceMesh`` and a
    :class:`~repro_torch.distributed.sparse_shard.ShardedSchedule`) and
    ``n_batches`` the pipeline depth of ``cuda_sharded_overlap``
    (DESIGN.md §12, §14).  ``precision`` (``"fp32"``,
    ``"bf16"``, ``"int8"``; ``None`` = operand dtypes as given) is checked
    against the impl's ``precisions``; the result is in B's dtype after
    the cast (bf16 for bf16 and int8).

    The hardened runtime (DESIGN.md §15): ``check`` audits ``fmt`` and
    guards ``b`` first (``None`` → ambient
    :func:`~repro_torch.core.validate.check_level`, by default ``"none"``:
    no validation code runs).  ``strict``/``guard_nonfinite`` go through
    :func:`~repro_torch.core.dispatch.robust_dispatch`: ``strict=False``
    degrades down the fallback ladder when the impl fails (one
    ``FallbackWarning``), ``strict=True`` re-raises the impl's error, and
    ``guard_nonfinite=True`` re-runs a bf16/int8 call at fp32 when its
    output is not finite and returns fp32.  ``strict=None`` (the default)
    with no guard is the plain dispatch.
    """
    _validate.guard_call(check, fmt, b=b)
    kwargs = _optional(n_blk=n_blk, split_blk=split_blk, schedule=schedule,
                       mesh=mesh, part=part, n_batches=n_batches)
    if strict is not None or guard_nonfinite:
        return _robust("spmm", impl, (fmt, b), dict(k_blk=k_blk, **kwargs),
                      precision, strict, guard_nonfinite)
    entry = _dispatch.require("spmm", impl, precision=precision)
    if entry.needs_canonical:       # the impl applies the level itself
        kwargs.update(_optional(precision=precision))
    elif precision is not None:
        fmt, b = _spmm_at_precision((fmt, b), precision, k_blk)
    return _dispatch.dispatch("spmm", impl, fmt, b, k_blk=k_blk, **kwargs)


# ---------------------------------------------------------------------------
# Registry adapters: uniform (fmt_or_blocked, b, *, k_blk, n_blk) signature.
# ---------------------------------------------------------------------------


def _spmm_blocked_adapter(fmt, b, *, k_blk: int = 8, n_blk: int | None = None):
    del n_blk  # no column tiling in the plain path
    return spmm_blocked(fmt, b, k_blk)


def _spmm_coo_adapter(fmt, b, *, k_blk: int = 8, n_blk: int | None = None):
    """Oracle via host-side COO conversion."""
    del k_blk, n_blk
    rows, cols, vals = to_coo(fmt)
    return spmm_coo_segment(torch.from_numpy(rows).to(b.device),
                            torch.from_numpy(cols).to(b.device),
                            torch.from_numpy(vals).to(b.device), b,
                            num_rows=fmt.shape[0])


_dispatch.register("spmm", "blocked", _spmm_blocked_adapter,
                   differentiable=True, batched=True,
                   precisions=("fp32", "bf16", "int8"))
_dispatch.register("spmm", "coo_segment", _spmm_coo_adapter)
_dispatch.register_precision("spmm", _spmm_at_precision)

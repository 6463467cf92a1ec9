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

The ``cuda_balanced`` adapters take ``schedule=`` (a precomputed
:class:`~repro_torch.core.format.Schedule`) or ``split_blk=`` (the
schedule is built and memoized on the blocked view).  A canonical format
is blocked with ``k_blk`` on the dense operand's device.  The flags follow
the reference's: ``differentiable`` impls run backward through the
autograd Functions of ``core/autodiff.py``; ``batched`` impls take a
leading head dimension in one launch.  The attention ``cuda_staged`` and
the two SpMM baselines are forward only, as in the reference.  The
``precisions`` follow the kernels' variants (DESIGN.md §13) and equal the
reference's: every SpMM of ``cuda``, ``cuda_batched`` and
``cuda_balanced`` takes fp32, bf16 and int8, their SDDMMs and every
attention fp32 and bf16.  The two SpMM baselines ``cuda_staged`` and
``cuda_noncoalesced`` take fp32 only (their narrow variants, rows 2 and 5
of PERF.md §6, are ROADMAP.md queue 2).
"""

from __future__ import annotations

from repro_torch.core import dispatch as _dispatch
from repro_torch.core.format import BlockedMEBCRS, block_format

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
           "spmm_noncoalesced_cuda"]


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


def _attention_staged_adapter(fmt, q, k, v, *, scale=None, k_blk: int = 8):
    return attention_cuda_staged(_ensure_blocked(fmt, k_blk, q.device), q, k,
                                 v, scale=scale)


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
    del n_blk  # the mapping fixes the tile: 32 windows x 4 columns
    return spmm_noncoalesced_cuda(_ensure_blocked(fmt, k_blk, b.device), b)


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
                   differentiable=True, batched=True,
                   precisions=("fp32", "bf16", "int8"))
_dispatch.register("sddmm", "cuda_balanced", _sddmm_balanced_adapter,
                   differentiable=True, batched=True,
                   precisions=("fp32", "bf16"))
_dispatch.register("attention", "cuda_balanced", _attention_balanced_adapter,
                   differentiable=True, batched=True,
                   precisions=("fp32", "bf16"))
# The SpMM baselines of the paper's ablations (forward only).
_dispatch.register("spmm", "cuda_staged", _spmm_staged_adapter)
_dispatch.register("spmm", "cuda_noncoalesced", _spmm_noncoalesced_adapter)

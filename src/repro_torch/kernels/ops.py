"""Registry adapters of the hand-written CUDA kernels.

Counterpart of ``repro.kernels.ops``'s adapters: uniform signatures
shared with the plain adapters in ``core/spmm.py`` and ``core/sddmm.py``,
so every layer resolves ``(op, impl)`` the same way.

  spmm      "cuda"             → :func:`spmm_cuda`      (``pallas``)
  sddmm     "cuda"             → :func:`sddmm_cuda`     (``pallas``)
  attention "cuda_fused_attn"  → :func:`attention_cuda` (``pallas_fused_attn``)
  spmm      "cuda_balanced"    → :func:`spmm_balanced_cuda`
  sddmm     "cuda_balanced"    → :func:`sddmm_balanced_cuda`
  attention "cuda_balanced"    → :func:`attention_balanced_cuda`
                                 (the three ``pallas_balanced``)

The ``cuda_balanced`` adapters take ``schedule=`` (a precomputed
:class:`~repro_torch.core.format.Schedule`) or ``split_blk=`` (the
schedule is built and memoized on the blocked view).  A canonical format
is blocked with ``k_blk`` on the dense operand's device.  Every impl here
is differentiable through the autograd Functions of ``core/autodiff.py``.
"""

from __future__ import annotations

from repro_torch.core import dispatch as _dispatch
from repro_torch.core.format import BlockedMEBCRS, block_format

from .attention_balanced_cuda import attention_balanced_cuda
from .attention_cuda import attention_cuda
from .sddmm_balanced_cuda import sddmm_balanced_cuda
from .sddmm_cuda import sddmm_cuda
from .spmm_balanced_cuda import spmm_balanced_cuda
from .spmm_cuda import spmm_cuda

__all__ = ["spmm_cuda", "sddmm_cuda", "attention_cuda", "spmm_balanced_cuda",
           "sddmm_balanced_cuda", "attention_balanced_cuda"]


def _ensure_blocked(fmt, k_blk: int, device) -> BlockedMEBCRS:
    return (fmt if isinstance(fmt, BlockedMEBCRS)
            else block_format(fmt, k_blk, device=device))


def _spmm_cuda_adapter(fmt, b, *, k_blk: int = 8, n_blk: int = 128):
    return spmm_cuda(_ensure_blocked(fmt, k_blk, b.device), b, n_blk=n_blk)


def _sddmm_cuda_adapter(fmt, q, k, *, k_blk: int = 8, f_blk=None):
    del f_blk  # the kernel walks the whole feature dimension in one pass
    return sddmm_cuda(_ensure_blocked(fmt, k_blk, q.device), q, k)


def _attention_cuda_adapter(fmt, q, k, v, *, scale=None, k_blk: int = 8):
    return attention_cuda(_ensure_blocked(fmt, k_blk, q.device), q, k, v,
                          scale=scale)


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


_dispatch.register("spmm", "cuda", _spmm_cuda_adapter, differentiable=True)
_dispatch.register("sddmm", "cuda", _sddmm_cuda_adapter, differentiable=True)
_dispatch.register("attention", "cuda_fused_attn", _attention_cuda_adapter,
                   differentiable=True)
# Block-parallel load-balanced impls (DESIGN.md §11): uniform-segment grids
# driven by a host-built Schedule, for skewed matrices.
_dispatch.register("spmm", "cuda_balanced", _spmm_balanced_adapter,
                   differentiable=True)
_dispatch.register("sddmm", "cuda_balanced", _sddmm_balanced_adapter,
                   differentiable=True)
_dispatch.register("attention", "cuda_balanced", _attention_balanced_adapter,
                   differentiable=True)

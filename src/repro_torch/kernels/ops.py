"""Registry adapters of the hand-written CUDA kernels.

Counterpart of ``repro.kernels.ops``'s adapters: uniform signatures
shared with the plain adapters in ``core/spmm.py`` and ``core/sddmm.py``,
so every layer resolves ``(op, impl)`` the same way.

  spmm      "cuda"             → :func:`spmm_cuda`      (``pallas``)
  sddmm     "cuda"             → :func:`sddmm_cuda`     (``pallas``)
  attention "cuda_fused_attn"  → :func:`attention_cuda` (``pallas_fused_attn``)

A canonical format is blocked with ``k_blk`` on the dense operand's
device.
"""

from __future__ import annotations

from repro_torch.core import dispatch as _dispatch
from repro_torch.core.format import BlockedMEBCRS, block_format

from .attention_cuda import attention_cuda
from .sddmm_cuda import sddmm_cuda
from .spmm_cuda import spmm_cuda

__all__ = ["spmm_cuda", "sddmm_cuda", "attention_cuda"]


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


_dispatch.register("spmm", "cuda", _spmm_cuda_adapter)
_dispatch.register("sddmm", "cuda", _sddmm_cuda_adapter)
_dispatch.register("attention", "cuda_fused_attn", _attention_cuda_adapter)

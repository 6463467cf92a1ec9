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
"""

from __future__ import annotations

import torch

from . import dispatch as _dispatch
from .format import BlockedMEBCRS, block_format, to_coo

__all__ = ["spmm", "spmm_blocked", "spmm_coo_segment", "spmm_dense_ref"]


def spmm_dense_ref(a_dense: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense oracle: ``a @ b`` in fp32, cast to ``b``'s dtype."""
    return (a_dense.float() @ b.float()).to(b.dtype)


def _spmm_blocked_impl(blocked: BlockedMEBCRS, b: torch.Tensor) -> torch.Tensor:
    v = blocked.vector_size
    nb = blocked.num_blocks
    w = blocked.num_windows
    bgath = b.float()[blocked.cols.long()]                 # (NB*K_BLK, N)
    vals = blocked.vals.float().reshape(nb, blocked.k_blk, v)
    gb = bgath.reshape(nb, blocked.k_blk, -1)
    # C_wᵀ = Σ_blocks B_gᵀ @ A_wᵀ: contraction over the vector index.
    partial_c = torch.einsum("bkv,bkn->bvn", vals, gb)     # (NB, V, N)
    c_win = torch.zeros((w, v, b.shape[1]), dtype=torch.float32,
                        device=b.device)
    c_win.index_add_(0, blocked.block_win.long(), partial_c)
    return c_win.reshape(w * v, -1)[: blocked.shape[0]].to(b.dtype)


def spmm_blocked(fmt, b: torch.Tensor, k_blk: int = 8) -> torch.Tensor:
    """Plain-PyTorch swap-and-transpose SpMM: ``C (M, N) = A @ B`` over the
    blocked view (``fmt`` may be canonical or already blocked).  Returns
    ``(M, N)`` in ``b``'s dtype; fp32 accumulation."""
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


def spmm(fmt, b: torch.Tensor, impl: str = "blocked", k_blk: int = 8,
         n_blk: int | None = None, split_blk: int | None = None,
         schedule=None) -> torch.Tensor:
    """SpMM dispatch through the registry (``dispatch.impls("spmm")``).

    ``fmt`` is the canonical :class:`~repro_torch.core.format.MEBCRS`
    (blocked on ``b``'s device with ``k_blk``) or a ``BlockedMEBCRS``;
    ``n_blk`` sets the column tile of the ``cuda*`` kernels;
    ``split_blk``/``schedule`` parameterize the block-parallel
    ``cuda_balanced`` kernel (DESIGN.md §11).
    """
    return _dispatch.dispatch("spmm", impl, fmt, b, k_blk=k_blk,
                              **_optional(n_blk=n_blk, split_blk=split_blk,
                                          schedule=schedule))


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
                   differentiable=True)
_dispatch.register("spmm", "coo_segment", _spmm_coo_adapter)

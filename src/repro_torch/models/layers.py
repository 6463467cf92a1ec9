"""Block-sparse attention layers on the FlashSparse operators.

Counterpart of ``repro.models.layers``'s ``sparse_attention`` and
``sparse_attention_staged`` (the reference module's GQA, MoE and Mamba
layers are ROADMAP.md queue 1 item 16).  The pattern (a local window plus
strided global keys, say) is shared by the heads; the scores and
probabilities are per head, and stay in the blocked ME-BCRS layout.
"""

from __future__ import annotations

import math

from repro_torch.core import dispatch as sparse_dispatch
from repro_torch.core.autodiff import ADPlan, attention_ad, sddmm_ad, spmm_ad
from repro_torch.core.format import BlockedMEBCRS
from repro_torch.core.sddmm import with_values
from repro_torch.core.softmax import sparse_softmax

__all__ = ["sparse_attention", "sparse_attention_staged"]


def sparse_attention(pattern, q, k, v, *, scale=None, impl: str | None = None):
    """Block-sparse attention ``softmax_rows(scale · mask ⊙ Q Kᵀ) @ V``.

    ``q``/``k``/``v``: ``(S, D)`` for one head or ``(H, S, D)`` per head
    (any operand may be shared); ``scale`` defaults to ``1/sqrt(D)`` and
    may be a learned 0-d tensor.  With an :class:`ADPlan` this is
    :func:`~repro_torch.core.autodiff.attention_ad`: on ``cuda`` the
    single-pass fused kernel, one launch for every head, and on
    ``cuda_balanced`` its block-parallel version, each with the recompute
    backward on the head-grid SDDMM/SpMM duality.  A bare
    :class:`BlockedMEBCRS` takes :func:`sparse_attention_staged`.
    """
    if isinstance(pattern, ADPlan):
        return attention_ad(pattern, q, k, v, scale=scale, impl=impl)
    return sparse_attention_staged(pattern, q, k, v, scale=scale, impl=impl)


def sparse_attention_staged(pattern, q, k, v, *, scale=None,
                            impl: str | None = None):
    """Three-dispatch block-sparse attention: SDDMM → sparse softmax → SpMM,
    the ``([H,] NNZP, V)`` scores through device memory.

    With an :class:`ADPlan` every stage is differentiable for any
    differentiable impl (``sddmm_ad`` and ``spmm_ad``; on ``cuda`` one
    head-grid launch each for all heads).  A bare :class:`BlockedMEBCRS`
    takes only ``impl="blocked"``, whose PyTorch ops differentiate
    natively; it runs every head in one pass.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if isinstance(pattern, ADPlan):
        scores = sddmm_ad(pattern, q, k, impl=impl)
        probs = sparse_softmax(pattern.fwd, scores * scale)
        return spmm_ad(pattern, probs.to(v.dtype), v, impl=impl)

    impl = impl or "blocked"
    if impl != "blocked":
        raise ValueError(
            f"sparse_attention with a bare BlockedMEBCRS takes only "
            f"impl='blocked'; build an ADPlan (ad_plan(fmt, impl={impl!r})) "
            f"for the kernel routes")
    if not isinstance(pattern, BlockedMEBCRS):
        raise TypeError("pattern must be an ADPlan or a BlockedMEBCRS")
    scores = sparse_dispatch.dispatch("sddmm", impl, pattern, q, k,
                                      k_blk=pattern.k_blk)
    probs = sparse_softmax(pattern, scores * scale)
    return sparse_dispatch.dispatch(
        "spmm", impl, with_values(pattern, probs.to(v.dtype)), v,
        k_blk=pattern.k_blk)

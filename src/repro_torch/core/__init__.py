"""FlashSparse core in PyTorch: the ME-BCRS format, the SpMM / SDDMM /
attention operators behind the dispatch registry, sparse softmax, and
the autodiff plan."""

from . import dispatch, validate
from .autodiff import ADPlan, ad_plan, attention_ad, sddmm_ad, spmm_ad
from .format import (
    MEBCRS,
    BlockedMEBCRS,
    block_format,
    from_coo,
    from_dense,
    resolve_device,
    to_coo,
    to_dense,
)
from .sddmm import attention, sddmm, with_values
from .softmax import sparse_softmax
from .spmm import spmm
from .validate import ValidationError

__all__ = [
    "ADPlan",
    "BlockedMEBCRS",
    "MEBCRS",
    "ValidationError",
    "ad_plan",
    "attention",
    "attention_ad",
    "block_format",
    "dispatch",
    "from_coo",
    "from_dense",
    "resolve_device",
    "sddmm",
    "sddmm_ad",
    "sparse_softmax",
    "spmm",
    "spmm_ad",
    "to_coo",
    "to_dense",
    "validate",
    "with_values",
]

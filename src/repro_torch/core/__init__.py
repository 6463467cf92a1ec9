"""FlashSparse core in PyTorch: the ME-BCRS format and its load-balanced
schedule, the SpMM / SDDMM / attention operators behind the dispatch
registry, sparse softmax, and the differentiable ops on an autodiff
plan."""

from . import dispatch, validate
from .autodiff import ADPlan, ad_plan, attention_ad, sddmm_ad, spmm_ad
from .format import (
    MEBCRS,
    BlockedMEBCRS,
    Schedule,
    block_format,
    build_schedule,
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
    "Schedule",
    "ValidationError",
    "ad_plan",
    "attention",
    "attention_ad",
    "block_format",
    "build_schedule",
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

"""FlashSparse core in PyTorch: the ME-BCRS format and its load-balanced
schedule, the SpMM / SDDMM / attention operators behind the dispatch
registry, sparse softmax, redundancy metrics, the structural validation
layer, and the differentiable ops on an autodiff plan.

Exports the reference's ``repro.core`` names but ``ValidationWarning``
(the reference warns from inside a JAX trace; the port has no tracer),
plus the port's ``resolve_device`` and ``sparse_softmax``."""

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
    memory_footprint_me_bcrs,
    memory_footprint_sr_bcrs,
    resolve_device,
    to_coo,
    to_dense,
    window_skew,
)
from .metrics import (
    counters,
    data_access_bytes,
    mma_count,
    padded_flops,
    record_counter,
    reset_counters,
    summarize,
    zeros_in_nonzero_vectors,
)
from .sddmm import (
    attention,
    sddmm,
    sddmm_blocked,
    sddmm_coo,
    sddmm_dense_ref,
    with_values,
)
from .softmax import sparse_softmax
from .spmm import spmm, spmm_blocked, spmm_coo_segment, spmm_dense_ref
from .validate import (
    ValidationError,
    check_level,
    checking,
    validate_blocked,
    validate_format,
    validate_schedule,
    validate_sharded,
)

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
    "check_level",
    "checking",
    "counters",
    "data_access_bytes",
    "dispatch",
    "from_coo",
    "from_dense",
    "memory_footprint_me_bcrs",
    "memory_footprint_sr_bcrs",
    "mma_count",
    "padded_flops",
    "record_counter",
    "reset_counters",
    "resolve_device",
    "sddmm",
    "sddmm_ad",
    "sddmm_blocked",
    "sddmm_coo",
    "sddmm_dense_ref",
    "sparse_softmax",
    "spmm",
    "spmm_ad",
    "spmm_blocked",
    "spmm_coo_segment",
    "spmm_dense_ref",
    "summarize",
    "to_coo",
    "to_dense",
    "validate",
    "validate_blocked",
    "validate_format",
    "validate_schedule",
    "validate_sharded",
    "window_skew",
    "with_values",
    "zeros_in_nonzero_vectors",
]

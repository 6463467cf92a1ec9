"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), their ctypes
wrappers with plain PyTorch versions and launch counters, the registry
adapters (``ops``) and element-wise oracles (``ref``)."""

from . import ops, ref
from .attention_balanced_cuda import (attention_balanced_cuda,
                                      attention_balanced_plain)
from .attention_cuda import attention_cuda, attention_plain
from .sddmm_balanced_cuda import sddmm_balanced_cuda, sddmm_balanced_plain
from .sddmm_cuda import sddmm_cuda, sddmm_plain
from .spmm_balanced_cuda import spmm_balanced_cuda, spmm_balanced_plain
from .spmm_cuda import spmm_cuda, spmm_plain

__all__ = ["attention_balanced_cuda", "attention_balanced_plain",
           "attention_cuda", "attention_plain", "ops", "ref",
           "sddmm_balanced_cuda", "sddmm_balanced_plain", "sddmm_cuda",
           "sddmm_plain", "spmm_balanced_cuda", "spmm_balanced_plain",
           "spmm_cuda", "spmm_plain"]

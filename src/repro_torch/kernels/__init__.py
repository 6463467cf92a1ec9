"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), their ctypes
wrappers with plain PyTorch versions and launch counters, the registry
adapters (``ops``) and element-wise oracles (``ref``)."""

from . import ops, ref
from .attention_cuda import attention_cuda, attention_plain
from .sddmm_cuda import sddmm_cuda, sddmm_plain
from .spmm_cuda import spmm_cuda, spmm_plain

__all__ = ["attention_cuda", "attention_plain", "ops", "ref", "sddmm_cuda",
           "sddmm_plain", "spmm_cuda", "spmm_plain"]

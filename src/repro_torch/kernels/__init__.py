"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), their ctypes
wrappers with plain PyTorch versions and launch counters, the registry
adapters and tuned entry points (``ops``), the autotuner (``autotune``)
and element-wise oracles (``ref``)."""

from . import autotune, ops, ref
from .attention_balanced_cuda import (attention_balanced_cuda,
                                      attention_balanced_plain)
from .attention_cuda import (attention_cuda, attention_cuda_staged,
                             attention_plain)
from .sddmm_balanced_cuda import sddmm_balanced_cuda, sddmm_balanced_plain
from .sddmm_batched_cuda import sddmm_batched_cuda, sddmm_batched_plain
from .sddmm_cuda import sddmm_cuda, sddmm_plain
from .spmm_balanced_cuda import spmm_balanced_cuda, spmm_balanced_plain
from .spmm_batched_cuda import spmm_batched_cuda, spmm_batched_plain
from .spmm_cuda import spmm_cuda, spmm_plain
from .spmm_noncoalesced_cuda import (spmm_noncoalesced_cuda,
                                     spmm_noncoalesced_plain)
from .spmm_staged_cuda import (spmm_staged_cuda, spmm_staged_plain,
                               staged_gather, staged_gather_plain)

__all__ = ["attention_balanced_cuda", "attention_balanced_plain",
           "attention_cuda", "attention_cuda_staged", "attention_plain",
           "autotune", "ops", "ref", "sddmm_balanced_cuda",
           "sddmm_balanced_plain",
           "sddmm_batched_cuda", "sddmm_batched_plain", "sddmm_cuda",
           "sddmm_plain", "spmm_balanced_cuda", "spmm_balanced_plain",
           "spmm_batched_cuda", "spmm_batched_plain", "spmm_cuda",
           "spmm_noncoalesced_cuda", "spmm_noncoalesced_plain",
           "spmm_plain", "spmm_staged_cuda", "spmm_staged_plain",
           "staged_gather", "staged_gather_plain"]

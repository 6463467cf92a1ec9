"""FlashSparse in PyTorch for NVIDIA Hopper.

The PyTorch counterpart of the JAX package ``repro``: the ME-BCRS format,
the SpMM / SDDMM / fused sparse-attention operators behind one dispatch
registry, and the GCN and AGNN models of the paper's end-to-end case
(§4.4).  Each TPU kernel of the reference becomes a CUDA kernel written
by hand for ``sm_90a`` (``kernels/csrc``), built with ``nvcc`` at first
use and bound with ``ctypes``.  The layout mirrors ``repro``: the
counterpart of ``repro/core/format.py`` is ``repro_torch/core/format.py``.

Entry points run on the card unless the caller passes ``device="cpu"``;
on CPU tensors every kernel wrapper runs its plain PyTorch version.
"""

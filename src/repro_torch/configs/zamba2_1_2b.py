"""zamba2-1.2b — Mamba-2 backbone + shared attention block [arXiv:2411.15242].

The shared transformer block (attention + MLP, one set of weights) is
applied every 6 mamba layers — a simplification of Zamba-2's shared-block
+ per-invocation LoRA scheme.  Runs long_500k: the mamba state is O(1).
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    attn_every=6,
    supports_long_context=True,
)

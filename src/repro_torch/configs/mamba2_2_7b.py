"""mamba2-2.7b — pure SSM, SSD (state-space duality) [arXiv:2405.21060].

Attention-free: FlashSparse's sparse-matmul technique is inapplicable;
implemented with the chunked SSD scan.
Runs long_500k — decode state is O(1) in sequence length.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    attention="none",
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    supports_long_context=True,
)

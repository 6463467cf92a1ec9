"""qwen3-0.6b — dense GQA with qk-norm [hf:Qwen/Qwen3-0.6B family].

head_dim is 128 in the Qwen3 family (explicit, not d_model / n_heads).
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
)

"""internvl2-76b — InternLM2-76B LM backbone of InternVL2 [arXiv:2404.16821].

The InternViT vision frontend is a stub: the caller provides ``prefix_len``
precomputed patch embeddings (B, P, d_model) as ``prefix_embeds``.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    prefix_len=256,
)

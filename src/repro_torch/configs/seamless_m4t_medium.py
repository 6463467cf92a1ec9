"""seamless-m4t-medium — enc-dec multimodal backbone [arXiv:2308.11596].

The speech frontend is a stub: the caller provides precomputed frame
embeddings (B, S_src, d_model) to the encoder as ``src_embeds``.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,            # decoder depth
    encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
)

"""yi-9b — llama-arch GQA [arXiv:2403.04652]."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
)

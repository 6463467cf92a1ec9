"""Models on the port's sparse operators: GCN and AGNN (paper §4.4), the
block-sparse attention layers (``layers``); and the language models
(``config``, ``layers``, ``lm``) with the ten architectures of
``repro_torch.configs``."""

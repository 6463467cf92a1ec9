"""Architecture configuration of the language models.

Counterpart of ``repro.models.config``: the same fields, defaults and
derived sizes, with ``dtype`` a torch dtype.  ``remat`` checkpoints
each layer of a differentiated forward (``torch.utils.checkpoint``).
The sharding knobs act under an ambient mesh (``distributed.ctx``):
``moe_ep`` takes the expert-parallel MoE (``layers.moe_ffn_ep``) and
``act_sp`` splits each layer's output over "model" on its sequence dim.
The fields that steer the reference's XLA compiler (``scan_layers``,
``attn_unroll``) are kept so the configurations carry over unchanged;
the port walks its layers in a Python loop, so they change nothing here.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["ArchConfig", "reduced"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture's dimensions.

    ``family`` is one of dense, moe, ssm, hybrid, encdec, vlm, audio.
    ``remat`` recomputes each layer's activations in the backward, as the
    reference's ``jax.checkpoint`` does.  ``moe_ep`` and ``act_sp`` act
    under an ambient mesh (module docstring); ``scan_layers`` and
    ``attn_unroll`` are the reference's compiler knobs: accepted and
    ignored (no layer scan here).
    """

    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab: int = 32000
    head_dim: int = 0            # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e4
    rmsnorm_eps: float = 1e-5
    tie_embeddings: bool = False

    attention: str = "gqa"       # gqa | mla | none
    # MLA (DeepSeek-V3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_ep: bool = False         # expert-parallel dispatch under a mesh

    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    conv_width: int = 4
    ssd_chunk: int = 128

    # hybrid (Zamba-2): shared attention block every N mamba layers
    attn_every: int = 0

    # encoder-decoder (Seamless): encoder depth; decoder uses n_layers
    encoder_layers: int = 0

    # multimodal stub prefix (ViT patches / audio frames), embeddings provided
    prefix_len: int = 0

    dtype: Any = torch.bfloat16
    remat: bool = True           # torch.utils.checkpoint per layer
    scan_layers: bool = True     # ignored here: layers run in a Python loop
    attn_impl: str = "auto"      # auto | full | chunked
    attn_unroll: bool = False    # ignored here
    act_sp: bool = False         # layer outputs' seq dim over "model"

    # which shapes this arch supports (long_500k only for sub-quadratic)
    supports_long_context: bool = False

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256; the pad columns of the
        logits are masked to -1e30 in the head."""
        return -(-self.vocab // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def param_count(self) -> int:
        """Analytic parameter count."""
        d, v = self.d_model, self.vocab
        n = v * d                                      # embed
        if not self.tie_embeddings:
            n += v * d                                 # lm head
        per_layer = 0
        if self.attention == "gqa" and self.n_heads:
            hd = self.head_dim
            per_layer += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d
        elif self.attention == "mla":
            qk = self.qk_nope_dim + self.qk_rope_dim
            per_layer += d * self.q_lora_rank + self.q_lora_rank * self.n_heads * qk
            per_layer += d * (self.kv_lora_rank + self.qk_rope_dim)
            per_layer += self.kv_lora_rank * self.n_heads * (
                self.qk_nope_dim + self.v_head_dim)
            per_layer += self.n_heads * self.v_head_dim * d
        if self.family in ("ssm", "hybrid"):
            di, g, ns = self.d_inner, self.ssm_ngroups, self.ssm_state
            per_layer = d * (2 * di + 2 * g * ns + self.ssm_nheads) + di * d
        if self.moe_experts:
            dff = self.moe_d_ff or self.d_ff
            per_layer += 3 * self.moe_experts * d * dff + d * self.moe_experts
            if self.moe_shared_experts:
                per_layer += 3 * d * dff * self.moe_shared_experts
        elif self.d_ff and self.family != "ssm":
            per_layer += 3 * d * self.d_ff
        n += self.n_layers * per_layer
        if self.family == "hybrid" and self.n_heads:
            hd = self.head_dim
            n += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d + 3 * d * self.d_ff  # shared block
        if self.family == "encdec":
            # encoder layers + decoder cross-attention
            enc = self.encoder_layers * (4 * d * self.n_heads * self.head_dim
                                         + 3 * d * self.d_ff)
            cross = self.n_layers * 4 * d * self.n_heads * self.head_dim
            n += enc + cross
        return n

    def active_param_count(self) -> int:
        """Active (per-token) params: MoE counts top-k + shared experts."""
        if not self.moe_experts:
            return self.param_count()
        dff = self.moe_d_ff or self.d_ff
        inactive = 3 * (self.moe_experts - self.moe_top_k) * self.d_model * dff
        return self.param_count() - self.n_layers * inactive


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Smoke-test sized variant of the same family (CPU-runnable), fp32."""
    small = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=128,
        n_heads=min(cfg.n_heads, 4) if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_ff=256 if cfg.d_ff else 0,
        vocab=min(cfg.vocab, 512),
        head_dim=32 if cfg.n_heads else 0,
        q_lora_rank=64 if cfg.q_lora_rank else 0,
        kv_lora_rank=32 if cfg.kv_lora_rank else 0,
        qk_nope_dim=32 if cfg.attention == "mla" else cfg.qk_nope_dim,
        qk_rope_dim=16 if cfg.attention == "mla" else cfg.qk_rope_dim,
        v_head_dim=32 if cfg.attention == "mla" else cfg.v_head_dim,
        moe_experts=min(cfg.moe_experts, 4) if cfg.moe_experts else 0,
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.moe_top_k else 0,
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_headdim=32 if cfg.ssm_state else cfg.ssm_headdim,
        encoder_layers=min(cfg.encoder_layers, 2) if cfg.encoder_layers else 0,
        prefix_len=min(cfg.prefix_len, 8) if cfg.prefix_len else 0,
        attn_every=2 if cfg.attn_every else 0,
        ssd_chunk=16,
        dtype=torch.float32,
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)

"""Unified language model covering every architecture family.

Counterpart of ``repro.models.lm``.  Families (``cfg.family``):
  dense / vlm / audio-decoder: GQA (or MLA) attention + SwiGLU MLP
  moe      attention + token-choice top-k MoE FFN (+ shared experts)
  ssm      Mamba-2 (SSD) blocks, attention-free
  hybrid   Mamba-2 blocks + one *shared* attention/MLP block applied
           every ``attn_every`` layers (Zamba-2 style)
  encdec   bidirectional encoder over stub modality embeddings + causal
           decoder with cross-attention (Seamless backbone)
  vlm      decoder with ``prefix_len`` stub patch embeddings prepended

API (functions over parameter dicts of tensors):
  init_lm(cfg, generator, device)            -> params
  lm_forward(params, batch, cfg)             -> (logits, aux_loss)
  init_cache(cfg, batch, capacity, device)   -> cache
  lm_decode_step(params, tokens, cache, cfg) -> (logits, cache)
  lm_prefill(params, batch, cfg, capacity)   -> (logits, cache)
  lm_loss(params, batch, cfg, aux_weight)    -> (loss, {"ce", "aux"})
  lm_params_from_jax(cfg, params)            -> params
  stack_layers(params) / unstack_layers(params)

``params["layers"]`` (and ``"encoder"``) is a list of per-layer dicts
walked by a Python loop.  Training keeps the reference's stacked layout
(``stack_layers``: dicts of ``(L, ...)`` tensors), and ``lm_loss`` takes
either.  ``cfg.remat`` runs each layer of a differentiated forward under
``torch.utils.checkpoint``, as the reference wraps each in
``jax.checkpoint``.  The decode cache keeps the reference's stacked
layout: ``(L, B, capacity, ...)`` tensors in a dict.  Entry points run
on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core.format import resolve_device
from repro_torch.distributed.ctx import constrain
from repro_torch.distributed.sharding import shard_range
from repro_torch.pytree import tree_map

from .config import ArchConfig
from .layers import (
    attention,
    f32,
    gqa_attn,
    gqa_decode,
    gqa_project_qkv,
    init_gqa,
    init_mamba2,
    init_mla,
    init_mlp,
    init_moe,
    mamba2_block,
    mamba2_decode,
    mla_attn,
    mla_decode,
    mlp,
    moe_ffn,
    rms_norm,
    split_heads,
    sum_over,
)

__all__ = ["init_lm", "abstract_lm", "lm_forward", "init_cache", "lm_prefill",
           "lm_decode_step", "lm_loss", "encode", "lm_params_from_jax",
           "tensor_from_numpy", "stack_layers", "unstack_layers", "tree_map"]

ATTN_FAMILIES = ("dense", "moe", "vlm")
ENCDEC_FAMILIES = ("encdec", "audio")
STACKED = ("layers", "encoder")   # the keys whose layers the reference stacks


# ------------------------------------------------------------------- init --


def _init_decoder_layer(cfg: ArchConfig, gen, device, cross: bool = False):
    p: Dict[str, Any] = {
        "attn_norm": torch.ones((cfg.d_model,), dtype=cfg.dtype,
                                device=device),
        "mlp_norm": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=device),
    }
    p["attn"] = (init_mla(cfg, gen, device) if cfg.attention == "mla"
                 else init_gqa(cfg, gen, device))
    p["mlp"] = (init_moe(cfg, gen, device) if cfg.moe_experts
                else init_mlp(cfg, gen, device))
    if cross:
        p["cross_norm"] = torch.ones((cfg.d_model,), dtype=cfg.dtype,
                                     device=device)
        p["cross"] = init_gqa(cfg, gen, device)
    return p


def _init_mamba_layer(cfg: ArchConfig, gen, device):
    return {"norm": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=device),
            "mixer": init_mamba2(cfg, gen, device)}


def init_lm(cfg: ArchConfig, generator: torch.Generator, device=None) -> Dict:
    """Random parameters at the reference's shapes, scales and dtypes,
    drawn from ``generator`` (on its own device) and placed on ``device``
    (default: the card)."""
    device = resolve_device(device)
    gen = generator
    vp = cfg.padded_vocab  # pad columns masked in _logits
    params: Dict[str, Any] = {
        "embed": (torch.randn((vp, cfg.d_model), generator=gen,
                              device=gen.device) * 0.02).to(device, cfg.dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.dtype,
                                 device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = (torch.randn((cfg.d_model, vp), generator=gen,
                                         device=gen.device) * 0.02
                             ).to(device, cfg.dtype)
    n = cfg.n_layers
    if cfg.family in ATTN_FAMILIES:
        params["layers"] = [_init_decoder_layer(cfg, gen, device)
                            for _ in range(n)]
    elif cfg.family in ("ssm", "hybrid"):
        params["layers"] = [_init_mamba_layer(cfg, gen, device)
                            for _ in range(n)]
        if cfg.family == "hybrid":
            params["shared_block"] = _init_decoder_layer(cfg, gen, device)
    elif cfg.family in ENCDEC_FAMILIES:
        params["encoder"] = [_init_decoder_layer(cfg, gen, device)
                             for _ in range(cfg.encoder_layers)]
        params["layers"] = [_init_decoder_layer(cfg, gen, device, cross=True)
                            for _ in range(n)]
    else:
        raise ValueError(f"unknown family {cfg.family}")
    return params


def tensor_from_numpy(arr, device) -> torch.Tensor:
    """A copy of a numpy array of the JAX package on ``device``; bf16
    (``ml_dtypes.bfloat16``, which torch does not read) passes through
    float32, which holds every bf16 value exactly."""
    arr = np.asarray(arr)
    if arr.dtype.kind not in "fiub":          # ml_dtypes.bfloat16
        return torch.tensor(arr.astype(np.float32)).to(device, torch.bfloat16)
    return torch.tensor(arr).to(device)


def lm_params_from_jax(cfg: ArchConfig, params: Dict, *, device=None) -> Dict:
    """The port's parameters from the JAX package's ``init_lm`` pytree.

    ``params`` holds numpy arrays (bf16 leaves as ``ml_dtypes.bfloat16``
    arrays: :func:`tensor_from_numpy`).  The stacked layer axis of
    ``"layers"`` and ``"encoder"`` is unstacked into lists of per-layer
    dicts.  ``device`` defaults to the card.
    """
    device = resolve_device(device)

    def leaf(arr):
        return tensor_from_numpy(arr, device)

    out = {}
    for key, val in params.items():
        if key in ("layers", "encoder"):
            stacked = tree_map(leaf, val)
            depth = cfg.encoder_layers if key == "encoder" else cfg.n_layers
            out[key] = [tree_map(lambda t, i=i: t[i].clone(), stacked)
                        for i in range(depth)]
        else:
            out[key] = tree_map(leaf, val)
    return out


def _stack(layers: List):
    if isinstance(layers[0], dict):
        return {k: _stack([lp[k] for lp in layers]) for k in layers[0]}
    return torch.stack(layers)


def _unbind(tree) -> List:
    if isinstance(tree, dict):
        parts = {k: _unbind(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    if isinstance(tree, DTensor) and any(
            isinstance(pl, Shard) and pl.dim == 0 for pl in tree.placements):
        # a layer dim split over a mesh dim (the rules give a stacked
        # leaf the "expert" axis where its rank reads as an expert
        # weight's): gathered over that mesh dim, then unbound; the
        # gradient goes back to the split by the redistribution
        tree = tree.redistribute(tree.device_mesh, [
            Replicate() if isinstance(pl, Shard) and pl.dim == 0 else pl
            for pl in tree.placements])
    return list(torch.unbind(tree))


def abstract_lm(cfg: ArchConfig) -> Dict:
    """``init_lm``'s parameters in the stacked layout as ``meta``
    tensors: their shapes and dtypes at any size, nothing allocated (the
    init is traced under ``FakeTensorMode``); the counterpart of the
    reference's ``jax.eval_shape(init_lm)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = stack_layers(init_lm(cfg, torch.Generator(), "cpu"))
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), fake)


def stack_layers(params: Dict) -> Dict:
    """The reference's stacked layout: the per-layer lists of
    ``"layers"`` and ``"encoder"`` become dicts of ``(L, ...)`` tensors
    (new tensors); every other entry is shared with ``params``."""
    return {k: _stack(v) if k in STACKED and isinstance(v, list) else v
            for k, v in params.items()}


def unstack_layers(params: Dict) -> Dict:
    """Per-layer views of a stacked ``"layers"``/``"encoder"`` (lists pass
    through).  The views come from ``torch.unbind``, so autograd gathers
    the layers' gradients into the stacked leaf's with one stack."""
    return {k: _unbind(v) if k in STACKED and isinstance(v, dict) else v
            for k, v in params.items()}


# ------------------------------------------------------------ layer apply --


def _zero_aux(x):
    return torch.zeros((), dtype=f32, device=x.device)


def _decoder_layer(p, x, cfg: ArchConfig, *, causal=True,
                   cross_kv: Optional[torch.Tensor] = None):
    attn_fn = mla_attn if cfg.attention == "mla" else gqa_attn
    h = x + attn_fn(p["attn"], rms_norm(x, p["attn_norm"], cfg.rmsnorm_eps),
                    cfg, causal=causal, attn_impl=cfg.attn_impl)
    if cross_kv is not None:
        h = h + _cross_attn(p["cross"], rms_norm(h, p["cross_norm"],
                                                 cfg.rmsnorm_eps), cross_kv, cfg)
    y = rms_norm(h, p["mlp_norm"], cfg.rmsnorm_eps)
    if cfg.moe_experts:
        out, aux = moe_ffn(p["mlp"], y, cfg)
    else:
        out, aux = mlp(p["mlp"], y), _zero_aux(x)
    return h + out, aux


def _cross_attn(p, x, memory, cfg: ArchConfig):
    """Encoder-decoder cross attention (no RoPE on cross keys)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = split_heads(x @ p["wq"], cfg.n_heads, hd)
    k = split_heads(memory @ p["wk"], cfg.n_kv_heads, hd)
    v = split_heads(memory @ p["wv"], cfg.n_kv_heads, hd)
    out = attention(q, k, v, causal=False, impl="auto")
    return out.reshape(b, s, -1) @ p["wo"]


def _mamba_layer(p, x, cfg: ArchConfig):
    return x + mamba2_block(p["mixer"], rms_norm(x, p["norm"], cfg.rmsnorm_eps),
                            cfg, chunk=cfg.ssd_chunk), _zero_aux(x)


def _checkpointed(body):
    """``body`` under ``torch.utils.checkpoint``: its activations are
    recomputed in the backward instead of kept (the forward draws no
    random numbers, so no RNG state is stashed)."""
    from torch.utils.checkpoint import checkpoint

    def run(*args):
        return checkpoint(body, *args, use_reentrant=False,
                          preserve_rng_state=False)

    return run


def _run_stack(x, layers: List, body, remat: bool = False,
               seq_ax: Optional[str] = None):
    """Apply ``body`` layer after layer; accumulates the aux losses.  Each
    layer's output is pinned to the batch layout (``constrain``; with
    ``seq_ax="act_seq"``, the ``act_sp`` layout, its sequence dim over
    "model" too).  With ``remat`` and grad enabled each call is
    checkpointed."""

    def step(lp, h):
        if seq_ax:           # the layer takes its input's sequence whole
            h = constrain(h, "act_batch")
        y, a = body(lp, h)
        return constrain(y, "act_batch", seq_ax), a

    if remat and torch.is_grad_enabled():
        step = _checkpointed(step)
    aux = _zero_aux(x)
    for lp in layers:
        x, a = step(lp, x)
        aux = aux + a
    return x, aux


# ---------------------------------------------------------------- forward --


def _embed_tokens(params, tokens):
    embed = params["embed"]
    if isinstance(embed, DTensor):
        return constrain(_embed_sharded(embed, tokens), "act_batch")
    return embed[tokens]


def _embed_sharded(embed: DTensor, tokens) -> DTensor:
    """The lookup in a sharded table, rank by rank (the vocab-parallel
    embedding): the table's "data" split (FSDP) is gathered; a rank whose
    vocab rows are a shard looks its tokens up there, zeros the rows of
    tokens it does not hold, and the rows are summed over the vocab split
    (an all-reduce, identity backward: exactly one rank holds a row).
    DTensor's own index rules are not in every torch release (2.11's
    refuse the lookup's backward).  Returns the rows laid out like the
    tokens' batch."""
    mesh = embed.device_mesh
    names = mesh.mesh_dim_names
    vocab = [i for i, pl in enumerate(embed.placements)
             if isinstance(pl, Shard) and pl.dim == 0]
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    tok = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
           for pl in tokens.placements]
    table = embed.redistribute(mesh, [Shard(0) if i in vocab else Replicate()
                                      for i in range(mesh.ndim)])
    rows = table.to_local(grad_placements=[
        Shard(0) if i in vocab else
        Partial() if isinstance(tok[i], Shard) else Replicate()
        for i in range(mesh.ndim)])
    t = tokens.redistribute(mesh, tok).to_local().long()
    if vocab:
        (i,) = vocab
        v0 = mesh.get_local_rank(names[i]) * rows.shape[0]
        held = (t >= v0) & (t < v0 + rows.shape[0])
        x = rows[(t - v0).clamp(0, rows.shape[0] - 1)] * held[..., None]
        x = sum_over(x, mesh.get_group(names[i]))
    else:
        x = rows[t]
    return DTensor.from_local(x, mesh, tok, run_check=False)


def _logits(params, x, cfg: ArchConfig):
    """fp32 logits over the padded vocab; pad columns are ``-1e30``."""
    x = constrain(x, "act_batch")     # the sequence whole (after act_sp)
    x = rms_norm(x, params["final_norm"], cfg.rmsnorm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if isinstance(head, DTensor):
        # the FSDP gather of the head before its product: the gradient
        # comes back through it in the weight's own layout, so a tied
        # table's two gradients meet in one layout
        mesh = head.device_mesh
        head = head.redistribute(mesh, [
            Replicate() if name == "data" else pl
            for name, pl in zip(mesh.mesh_dim_names, head.placements)])
    out = x.float() @ head.float()
    if cfg.padded_vocab != cfg.vocab:
        if isinstance(out, DTensor):      # no in-place fill on DTensors
            pad = torch.arange(out.shape[-1], device=out.device) >= cfg.vocab
            out = torch.where(pad, -1e30, out)
        else:
            out[..., cfg.vocab:] = -1e30
    return constrain(out, "act_batch", None, "act_vocab")


def encode(params, src_embeds: torch.Tensor, cfg: ArchConfig):
    """The encoder stack over the stub modality embeddings (encdec): the
    memory the decoder's cross-attention reads."""
    mem = src_embeds.to(cfg.dtype)
    mem, _ = _run_stack(mem, params["encoder"],
                        lambda p, h: _decoder_layer(p, h, cfg, causal=False),
                        cfg.remat)
    return mem


def _forward_hidden(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbone forward to final hidden states (no head) -> (hidden, aux)."""
    x = _embed_tokens(params, batch["tokens"])
    prefix = 0

    if cfg.family in ENCDEC_FAMILIES:
        mem = batch["src_embeds"].to(cfg.dtype)
        seq_ax = "act_seq" if cfg.act_sp else None
        mem, aux_e = _run_stack(
            mem, params["encoder"],
            lambda p, h: _decoder_layer(p, h, cfg, causal=False), cfg.remat,
            seq_ax)
        x, aux_d = _run_stack(
            x, params["layers"],
            lambda p, h: _decoder_layer(p, h, cfg, cross_kv=mem), cfg.remat,
            seq_ax)
        return x, aux_e + aux_d

    if cfg.family == "vlm" and "prefix_embeds" in batch:
        pe = batch["prefix_embeds"].to(cfg.dtype)
        prefix = pe.shape[1]
        x = torch.cat([pe, x], dim=1)

    seq_ax = "act_seq" if cfg.act_sp else None
    if cfg.family in ATTN_FAMILIES:
        x, aux = _run_stack(x, params["layers"],
                            lambda p, h: _decoder_layer(p, h, cfg), cfg.remat,
                            seq_ax)
    elif cfg.family == "ssm":
        x, aux = _run_stack(x, params["layers"],
                            lambda p, h: _mamba_layer(p, h, cfg), cfg.remat,
                            seq_ax)
    elif cfg.family == "hybrid":
        x, aux = _hybrid_forward(params, x, cfg)
    else:
        raise ValueError(cfg.family)

    if prefix:
        x = x[:, prefix:]
    return x, aux


def lm_forward(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Parallel forward. batch: {"tokens" (B, S)} + family extras
    (``src_embeds`` for encdec, optional ``prefix_embeds`` for vlm).

    Returns (logits (B, S, padded_vocab) fp32, pad columns ``-1e30``;
    aux_loss).
    """
    x, aux = _forward_hidden(params, batch, cfg)
    return _logits(params, x, cfg), aux


def _hybrid_forward(params, x, cfg: ArchConfig):
    """Zamba-2 style: periods of ``attn_every`` mamba layers, each
    followed by the shared block; leftover layers run without it.  Under
    ``remat`` a period is one checkpoint, as in the reference."""
    layers = params["layers"]
    period = cfg.attn_every or cfg.n_layers
    n_main = (cfg.n_layers // period) * period

    def period_body(plist, h):
        aux = _zero_aux(h)
        for lp in plist:
            h, a = _mamba_layer(lp, h, cfg)
            h = constrain(h, "act_batch")
            aux = aux + a
        h, a = _decoder_layer(params["shared_block"], h, cfg)
        return h, aux + a

    periods = [layers[i:i + period] for i in range(0, n_main, period)]
    x, aux = _run_stack(x, periods, period_body, cfg.remat)
    x, aux_tail = _run_stack(x, layers[n_main:],
                             lambda p, h: _mamba_layer(p, h, cfg), cfg.remat)
    return x, aux + aux_tail


# ------------------------------------------------------------------ cache --


def _n_shared_invocations(cfg: ArchConfig) -> int:
    return cfg.n_layers // (cfg.attn_every or cfg.n_layers + 1)


def init_cache(cfg: ArchConfig, batch: int, capacity: int, device=None
               ) -> Dict:
    """Zero-initialized decode cache with ``capacity`` timestep slots, in
    the reference's stacked layout; ``device`` defaults to the card."""
    device = resolve_device(device)
    dt = cfg.dtype
    L = cfg.n_layers

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    def gqa_kv(n):
        shape = (n, batch, capacity, cfg.n_kv_heads, cfg.head_dim)
        return {"k": zeros(shape), "v": zeros(shape)}

    def mamba():
        conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
        return {"conv": zeros((L, batch, cfg.conv_width - 1, conv_dim)),
                "ssm": zeros((L, batch, cfg.ssm_nheads, cfg.ssm_headdim,
                              cfg.ssm_state), f32)}

    cache: Dict[str, Any] = {"pos": zeros((batch,), torch.int32)}
    if cfg.family in ATTN_FAMILIES:
        if cfg.attention == "mla":
            cache["layers"] = {
                "ckv": zeros((L, batch, capacity, cfg.kv_lora_rank)),
                "k_rope": zeros((L, batch, capacity, cfg.qk_rope_dim)),
            }
        else:
            cache["layers"] = gqa_kv(L)
    elif cfg.family == "ssm":
        cache["layers"] = mamba()
    elif cfg.family == "hybrid":
        cache["layers"] = mamba()
        n_inv = _n_shared_invocations(cfg)
        if n_inv:
            cache["shared_attn"] = gqa_kv(n_inv)
    elif cfg.family in ENCDEC_FAMILIES:
        cache["layers"] = gqa_kv(L)
        # cross-attention memory is computed at prefill and stored once
        cache["memory"] = None
    return cache


# ------------------------------------------------------------ decode step --


def _store(stacked: Dict, i: int, new: Dict, view: Dict) -> None:
    """Write layer ``i``'s new cache entries into the stacked buffers;
    an entry that is the layer's ``view`` itself was written in place
    (the attention decodes' ``_scatter_time``) and is left alone."""
    for key, val in new.items():
        if val is not view[key]:
            stacked[key][i].copy_(val)


def _layer_view(stacked: Dict, i: int) -> Dict:
    return {key: val[i] for key, val in stacked.items()}


def lm_decode_step(params, tokens, cache: Dict, cfg: ArchConfig
                   ) -> Tuple[torch.Tensor, Dict]:
    """One decode step. tokens: (B, 1) int. Returns (logits (B, 1, V)
    fp32, new cache); ``cache`` itself is left as it was."""
    pos = cache["pos"]
    x = _embed_tokens(params, tokens)
    new = dict(cache)
    layers = {k: v.clone() for k, v in cache["layers"].items()}
    new["layers"] = layers

    if cfg.family in ATTN_FAMILIES:
        for i, lp in enumerate(params["layers"]):
            view = _layer_view(layers, i)
            x, lc = _layer_decode_attn(lp, x, view, pos, cfg)
            _store(layers, i, lc, view)
    elif cfg.family == "ssm":
        for i, lp in enumerate(params["layers"]):
            view = _layer_view(layers, i)
            x, lc = _layer_decode_mamba(lp, x, view, cfg)
            _store(layers, i, lc, view)
    elif cfg.family == "hybrid":
        shared = cache.get("shared_attn")
        if shared is not None:
            shared = {k: v.clone() for k, v in shared.items()}
            new["shared_attn"] = shared
        period = cfg.attn_every or (cfg.n_layers + 1)
        inv = 0
        for i, lp in enumerate(params["layers"]):
            view = _layer_view(layers, i)
            x, lc = _layer_decode_mamba(lp, x, view, cfg)
            _store(layers, i, lc, view)
            if (i + 1) % period == 0 and shared is not None:
                view = _layer_view(shared, inv)
                x, sc = _layer_decode_attn(params["shared_block"], x, view,
                                           pos, cfg)
                _store(shared, inv, sc, view)
                inv += 1
    elif cfg.family in ENCDEC_FAMILIES:
        memory = cache["memory"]
        for i, lp in enumerate(params["layers"]):
            view = _layer_view(layers, i)
            x, lc = _layer_decode_encdec(lp, x, view, pos, memory, cfg)
            _store(layers, i, lc, view)
    else:
        raise ValueError(cfg.family)
    new["pos"] = pos + 1
    return _logits(params, x, cfg), new


def _layer_decode_attn(p, x, lc, pos, cfg):
    norm_x = rms_norm(x, p["attn_norm"], cfg.rmsnorm_eps)
    if cfg.attention == "mla":
        y, lc2 = mla_decode(p["attn"], norm_x, lc, pos, cfg)
    else:
        y, lc2 = gqa_decode(p["attn"], norm_x, lc, pos, cfg)
    h = x + y
    ymlp = rms_norm(h, p["mlp_norm"], cfg.rmsnorm_eps)
    if cfg.moe_experts:
        out, _ = moe_ffn(p["mlp"], ymlp, cfg)
    else:
        out = mlp(p["mlp"], ymlp)
    return h + out, lc2


def _layer_decode_mamba(p, x, lc, cfg):
    y, lc2 = mamba2_decode(p["mixer"], rms_norm(x, p["norm"], cfg.rmsnorm_eps),
                           lc, cfg)
    return x + y, lc2


def _layer_decode_encdec(p, x, lc, pos, memory, cfg):
    norm_x = rms_norm(x, p["attn_norm"], cfg.rmsnorm_eps)
    y, lc2 = gqa_decode(p["attn"], norm_x, lc, pos, cfg)
    h = x + y
    h = h + _cross_attn(p["cross"], rms_norm(h, p["cross_norm"],
                                             cfg.rmsnorm_eps), memory, cfg)
    out = mlp(p["mlp"], rms_norm(h, p["mlp_norm"], cfg.rmsnorm_eps))
    return h + out, lc2


# ---------------------------------------------------------------- prefill --


def lm_prefill(params, batch: Dict, cfg: ArchConfig, capacity: int
               ) -> Tuple[torch.Tensor, Dict]:
    """Process a full prompt: last-position logits (B, 1, V) and a cache.

    As the reference: the parallel forward gives the logits; the GQA
    families' K/V cache is filled by a second pass over the tokens
    (``_extract_gqa_cache``); the encdec memory is the encoder's output;
    other families' layer caches stay zero.  ``pos`` is the token count.
    """
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache = init_cache(cfg, b, capacity, device=tokens.device)
    if cfg.family in ENCDEC_FAMILIES:
        cache["memory"] = encode(params, batch["src_embeds"], cfg)
    hidden, _ = _forward_hidden(params, batch, cfg)
    logits = _logits(params, hidden[:, -1:], cfg)
    if cfg.family in ATTN_FAMILIES and cfg.attention == "gqa":
        cache["layers"] = _extract_gqa_cache(params, batch, cfg, capacity)
    cache["pos"] = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    return logits, cache


def _extract_gqa_cache(params, batch, cfg, capacity):
    """Recompute each layer's K/V projections for the prompt (parallel)
    into the stacked (L, B, capacity, Hkv, D) buffers."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    if s > capacity:
        raise ValueError(f"prompt of {s} tokens exceeds the cache capacity "
                         f"{capacity}")
    x = _embed_tokens(params, tokens)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    ks, vs = [], []
    for lp in params["layers"]:
        norm_x = rms_norm(x, lp["attn_norm"], cfg.rmsnorm_eps)
        _, k, v = gqa_project_qkv(lp["attn"], norm_x, cfg, positions)
        x, _ = _decoder_layer(lp, x, cfg)
        ks.append(k.to(cfg.dtype))
        vs.append(v.to(cfg.dtype))
    # the slots past the prompt are zeros; stacked and padded rather than
    # written into a zeroed buffer, which also runs on DTensors
    pad = (0, 0, 0, 0, 0, capacity - s)
    return {"k": F.pad(torch.stack(ks), pad), "v": F.pad(torch.stack(vs), pad)}


# ------------------------------------------------------------------- loss --


def lm_loss(params, batch: Dict, cfg: ArchConfig, aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross entropy (+ MoE aux); the labels are the tokens
    shifted by one, and a negative label is masked out.

    CE is ``logsumexp(logits) - logits[target]`` in fp32, so no second
    (B, S, V) log-softmax buffer is kept.  On DTensor logits (a mesh) it
    is the vocab-parallel cross entropy (:func:`_vocab_parallel_ce`): no
    rank holds more than its own shard of the logits or of their
    gradient.  ``params`` may hold its layers stacked (the training
    state's layout) or as lists.  Returns ``(ce + aux_weight * aux,
    {"ce": ce, "aux": aux})``.
    """
    logits, aux = lm_forward(unstack_layers(params), batch, cfg)
    if isinstance(logits, DTensor):
        loss = _vocab_parallel_ce(logits, batch["tokens"])
        return loss + aux_weight * aux, {"ce": loss, "aux": aux}
    targets = batch["tokens"][:, 1:].long()
    logits = logits[:, :-1].float()
    lse = torch.logsumexp(logits, dim=-1)                        # (B, S-1)
    picked = torch.gather(logits, -1, targets.clamp(min=0)[..., None])[..., 0]
    mask = (targets >= 0).to(f32)
    loss = ((lse - picked) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


def _vocab_parallel_ce(logits: DTensor, tokens) -> DTensor:
    """The masked mean cross entropy of DTensor logits (B, S, V), rank by
    rank on the local shard (B_loc, S, V_loc): the logsumexp and the
    target's logit come from two all-reduces over the mesh dims that
    split the vocab (:class:`_VocabParallelNLL`), the sums over the
    batch shards from one more.  The logits' layout is taken as it comes
    (``_logits`` lays it out): a mesh dim may split the batch (dim 0) or
    the vocab (dim 2); any other split raises.  Returns the loss as a
    replicated 0-d DTensor."""
    mesh = logits.device_mesh
    pls = tuple(logits.placements)
    for pl in pls:
        if not (isinstance(pl, Replicate)
                or (isinstance(pl, Shard) and pl.dim in (0, 2))):
            raise ValueError(f"vocab-parallel cross entropy takes logits "
                             f"split on batch or vocab, got {pls}")
    rows = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
            for pl in pls]
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    targets = tokens.redistribute(mesh, rows).to_local()[:, 1:].long()
    local = logits.to_local(grad_placements=pls)[:, :-1].float()
    v0 = shard_range(logits, 2)[0]
    vocab = [mesh.get_group(i) for i, pl in enumerate(pls)
             if isinstance(pl, Shard) and pl.dim == 2]
    nll = _VocabParallelNLL.apply(local, targets, v0, vocab)    # (B_loc, S-1)
    mask = (targets >= 0).to(f32)
    sums = torch.stack([(nll * mask).sum(), mask.sum()])
    for i, pl in enumerate(pls):
        if isinstance(pl, Shard) and pl.dim == 0:
            sums = sum_over(sums, mesh.get_group(i))
    loss = sums[0] / torch.clamp(sums[1], min=1.0)
    return DTensor.from_local(loss, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


class _VocabParallelNLL(torch.autograd.Function):
    """Per-position ``logsumexp(logits) - logits[target]`` of the local
    vocab shard ``lg`` (B, T, V_loc) whose columns start at ``v0``; the
    statistics meet over ``groups`` (the vocab's mesh dims): the max by
    an all-reduce MAX, the sum of ``exp`` and the picked logit (0 on
    every rank but the target's) by all-reduce SUMs.  A target outside
    every rank's range (a masked label) picks 0.  The backward is
    ``g * softmax - g * onehot`` on the local shard, no collective: the
    all-reduced statistics are constants of each rank's own columns.
    The arithmetic is ``torch.logsumexp``'s and the gather's, so one rank
    gives the one-device loss and gradient bit for bit."""

    @staticmethod
    def forward(ctx, lg, targets, v0, groups):
        import torch.distributed as dist

        n = lg.shape[-1]
        m = lg.amax(dim=-1, keepdim=True)
        for g in groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        se = torch.exp(lg - m).sum(dim=-1)
        for g in groups:
            dist.all_reduce(se, group=g)
        lse = torch.log(se) + m[..., 0]
        held = (targets >= v0) & (targets < v0 + n)
        idx = (targets - v0).clamp(0, n - 1)
        picked = torch.where(held, torch.gather(lg, -1, idx[..., None])[..., 0],
                             0.0)
        for g in groups:
            dist.all_reduce(picked, group=g)
        ctx.save_for_backward(lg, lse, idx, held)
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        lg, lse, idx, held = ctx.saved_tensors
        grad = g[..., None] * torch.exp(lg - lse[..., None])
        grad.scatter_add_(-1, idx[..., None],
                          torch.where(held, -g, 0.0)[..., None])
        return grad, None, None, None

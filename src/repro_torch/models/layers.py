"""Transformer, MoE and Mamba-2 blocks of the language models, and the
block-sparse attention layers on the FlashSparse operators.

Counterpart of ``repro.models.layers``.  Every LM block is a function
``f(params, x, cfg, ...)`` over tensors, with parameters in the
reference's ``(in, out)`` layout (``x @ w``), so that carrying weights
across is a copy.  Numerics follow the reference: parameters and
activations in ``cfg.dtype``; norms, softmax, attention scores, the
router and the SSD scan in fp32 (a product the reference takes with
``preferred_element_type=f32`` and keeps in fp32 is taken on operands
upcast to fp32); masked scores are ``-1e30``.  The decode functions
write the new step into the cache buffers they are given, in place.

The block-sparse attention (``sparse_attention``,
``sparse_attention_staged``): the pattern (a local window plus strided
global keys, say) is shared by the heads; the scores and probabilities
are per head, and stay in the blocked ME-BCRS layout.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core import dispatch as sparse_dispatch
from repro_torch.core.autodiff import ADPlan, attention_ad, sddmm_ad, spmm_ad
from repro_torch.core.format import BlockedMEBCRS
from repro_torch.core.sddmm import with_values
from repro_torch.core.softmax import sparse_softmax
from repro_torch.distributed.ctx import current_mesh
from repro_torch.distributed.sharding import shard_range
from repro_torch.pytree import tree_map

__all__ = [
    "rms_norm", "apply_rope", "full_attention", "chunked_attention",
    "attention", "decode_merge", "init_gqa", "gqa_project_qkv", "gqa_attn",
    "gqa_decode",
    "init_mla", "mla_attn", "mla_decode", "init_mlp", "mlp", "init_moe",
    "moe_ffn", "moe_ffn_ep", "moe_ffn_ep_local", "moe_ep_capacity",
    "moe_route", "moe_slots", "split_heads", "sum_over",
    "init_mamba2",
    "ssd_scan", "mamba2_block", "mamba2_decode", "sparse_attention",
    "sparse_attention_staged"]

f32 = torch.float32


def sparse_attention(pattern, q, k, v, *, scale=None, impl: str | None = None):
    """Block-sparse attention ``softmax_rows(scale · mask ⊙ Q Kᵀ) @ V``.

    ``q``/``k``/``v``: ``(S, D)`` for one head or ``(H, S, D)`` per head
    (any operand may be shared); ``scale`` defaults to ``1/sqrt(D)`` and
    may be a learned 0-d tensor.  With an :class:`ADPlan` this is
    :func:`~repro_torch.core.autodiff.attention_ad`: on ``cuda`` the
    single-pass fused kernel, one launch for every head, and on
    ``cuda_balanced`` its block-parallel version, each with the recompute
    backward on the head-grid SDDMM/SpMM duality.  A bare
    :class:`BlockedMEBCRS` takes :func:`sparse_attention_staged`.
    """
    if isinstance(pattern, ADPlan):
        return attention_ad(pattern, q, k, v, scale=scale, impl=impl)
    return sparse_attention_staged(pattern, q, k, v, scale=scale, impl=impl)


def sparse_attention_staged(pattern, q, k, v, *, scale=None,
                            impl: str | None = None):
    """Three-dispatch block-sparse attention: SDDMM → sparse softmax → SpMM,
    the ``([H,] NNZP, V)`` scores through device memory.

    With an :class:`ADPlan` every stage is differentiable for any
    differentiable impl (``sddmm_ad`` and ``spmm_ad``; on ``cuda`` one
    head-grid launch each for all heads).  A bare :class:`BlockedMEBCRS`
    takes only ``impl="blocked"``, whose PyTorch ops differentiate
    natively; it runs every head in one pass.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if isinstance(pattern, ADPlan):
        scores = sddmm_ad(pattern, q, k, impl=impl)
        probs = sparse_softmax(pattern.fwd, scores * scale)
        return spmm_ad(pattern, probs.to(v.dtype), v, impl=impl)

    impl = impl or "blocked"
    if impl != "blocked":
        raise ValueError(
            f"sparse_attention with a bare BlockedMEBCRS takes only "
            f"impl='blocked'; build an ADPlan (ad_plan(fmt, impl={impl!r})) "
            f"for the kernel routes")
    if not isinstance(pattern, BlockedMEBCRS):
        raise TypeError("pattern must be an ADPlan or a BlockedMEBCRS")
    scores = sparse_dispatch.dispatch("sddmm", impl, pattern, q, k,
                                      k_blk=pattern.k_blk)
    probs = sparse_softmax(pattern, scores * scale)
    return sparse_dispatch.dispatch(
        "spmm", impl, with_values(pattern, probs.to(v.dtype)), v,
        k_blk=pattern.k_blk)


# ------------------------------------------------------------------ norms --


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    """RMS norm in fp32, rounded to ``x``'s dtype, then scaled by ``w``
    (the reference's order: at bf16 the rounding comes before the
    product)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


# ------------------------------------------------------------------- rope --


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding. x: (..., S, H, D); positions: (S,) or (..., S)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=f32, device=x.device) / half)
    angles = positions[..., :, None].float() * freqs     # (..., S, half)
    cos = torch.cos(angles)[..., :, None, :]              # (..., S, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- attention --


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    if groups == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, groups, d).reshape(
        b, s, h * groups, d)


def full_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                   kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Materialized-scores attention (short sequences, decode), GQA-native.

    q: (B, Sq, Hkv, G, D); k, v: (B, Sk, Hkv, D), never head-repeated.
    ``kv_len``: optional (B,) valid cache length for decode.  Scores in
    fp32, probabilities rounded to ``v``'s dtype before the product.
    """
    d = q.shape[-1]
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.float(),
                          k.float()) / math.sqrt(d)
    sq, sk = q.shape[1], k.shape[1]
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        kpos = torch.arange(sk, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        scores = torch.where(mask, scores, -1e30)
    if kv_len is not None:
        valid = torch.arange(sk, device=q.device)[None, :] < kv_len[:, None]
        scores = torch.where(valid[:, None, None, None, :], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def chunked_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                      kv_block: int = 1024):
    """Online-softmax attention over KV blocks of ``kv_block``: never
    materializes (Sq, Sk).  A Python loop over the blocks carries the
    running (acc, max, denom).
    """
    b, sq, h, g, d = q.shape        # GQA-native: h = kv heads, g = groups
    dv = v.shape[-1]
    sk = k.shape[1]
    nblk = -(-sk // kv_block)
    pad = nblk * kv_block - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    scale = 1.0 / math.sqrt(d)
    qpos = q_offset + torch.arange(sq, device=q.device)
    qf = q.float()
    acc = torch.zeros((b, h, g, sq, dv), dtype=f32, device=q.device)
    m = torch.full((b, h, g, sq), -math.inf, dtype=f32, device=q.device)
    den = torch.zeros((b, h, g, sq), dtype=f32, device=q.device)
    for i in range(nblk):
        kc = k[:, i * kv_block:(i + 1) * kv_block]
        vc = v[:, i * kv_block:(i + 1) * kv_block]
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, kc.float()) * scale
        kpos = i * kv_block + torch.arange(kv_block, device=q.device)
        mask = kpos[None, :] < sk                      # padding mask
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        else:
            mask = mask.expand(sq, kv_block)
        scores = torch.where(mask, scores, -1e30)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        den = den * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vc.dtype).float(),
                          vc.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(den, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)   # (B, Sq, H, G, Dv)


def attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
              kv_len=None, impl: str = "auto", kv_block: int = 1024):
    """Dispatch: GQA-native grouping + full vs chunked score computation.

    q: (B, S, Hq, D); k, v: (B, Sk, Hkv, D).  ``impl="auto"`` takes the
    chunked form for ``S > 2048`` without ``kv_len``.
    """
    if isinstance(q, DTensor):
        return _attention_local(q, k, v, causal=causal, q_offset=q_offset,
                                kv_len=kv_len, impl=impl, kv_block=kv_block)
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d)
    if impl == "auto":
        impl = "chunked" if (sq > 2048 and kv_len is None) else "full"
    if impl == "chunked":
        out = chunked_attention(qg, k, v, causal=causal, q_offset=q_offset,
                                kv_block=kv_block)
    else:
        out = full_attention(qg, k, v, causal=causal, q_offset=q_offset,
                             kv_len=kv_len)
    return out.reshape(b, sq, hq, -1)


def _attention_local(q, k, v, *, kv_len, **kw):
    """:func:`attention` on DTensors, rank by rank: attention is
    independent across the batch and the heads, so each rank attends its
    batch shard ("data") and head shard ("model") with the plain code on
    its local tensors, the sequence whole.  (DTensor's own rules would
    flatten a sharded head dim inside the score product, which torch
    releases before 2.13 refuse.)  Where the kv-heads do not divide the
    "model" ranks but the query heads do, the kv-heads are repeated to
    one a query head (the same products).  With ``kv_len`` (decode) the
    keys are a cache laid out by ``cache_shardings``:
    :func:`_attention_decode`."""
    if kv_len is not None:
        return _attention_decode(q, k, v, kv_len)
    mesh = q.device_mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    b, _, hq, _ = q.shape
    hkv = k.shape[2]
    n_data, n_model = sizes.get("data", 1), sizes.get("model", 1)
    heads = Replicate()
    if hq % n_model == 0:
        heads = Shard(2)
        if hkv % n_model:
            k, v = _repeat_kv(k, hq // hkv), _repeat_kv(v, hq // hkv)
    layout = _placed(mesh, data=Shard(0) if b % n_data == 0 else Replicate(),
                     model=heads)
    out = attention(*(t.redistribute(mesh, layout).to_local()
                      for t in (q, k, v)), **kw)
    return DTensor.from_local(out, mesh, layout, run_check=False)


def _cache_layout(cache: DTensor, dims=(0, 1, 2)):
    """The placements of a cache DTensor, checked: a mesh dim may split
    only the tensor dims ``dims`` (batch, sequence, heads), and nothing
    is partial.  Anything else raises: no layout is gathered here."""
    pls = tuple(cache.placements)
    for pl in pls:
        if not (isinstance(pl, Replicate)
                or (isinstance(pl, Shard) and pl.dim in dims)):
            raise ValueError(f"a decode cache split as {pls}: the sharded "
                             f"decode takes splits of dims {dims} only")
    return pls


def _rows_layout(pls) -> list:
    """Only the batch split (dim 0) of a layout; replicated elsewhere."""
    return [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
            for pl in pls]


def decode_merge(scores: torch.Tensor, values, groups) -> torch.Tensor:
    """Softmax attention over a key dim split across ranks: the merge
    GSPMD emits for a sequence-sharded decode.

    ``scores``: fp32, keys last, the local keys' (masked: ``-1e30``);
    ``values(p)``: the local product of probabilities ``p`` (the scores'
    shape) with the local values.  Each rank takes its local max, then
    the global one by an all-reduce MAX over ``groups`` (one process
    group per mesh dim that splits the keys), its local sum of ``exp``
    and the global sum by an all-reduce SUM, and its share of the output
    ``values(exp(s - max) / sum)`` in fp32, summed by a last all-reduce.
    With no group it is one rank's softmax.  The probabilities are
    normalised before the product, as the one-device softmax's are (and
    rounded where ``values`` rounds them)."""
    m = scores.amax(dim=-1, keepdim=True)
    for g in groups:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
    e = torch.exp(scores - m)
    den = e.sum(dim=-1, keepdim=True)
    for g in groups:
        dist.all_reduce(den, group=g)
    out = values(e / den)
    for g in groups:
        dist.all_reduce(out, group=g)
    return out


def _attention_decode(q, k, v, kv_len):
    """Decode attention over a DTensor cache ``k``, ``v`` (B, S, Hkv, D)
    laid out by ``cache_shardings``, with ``kv_len`` (B,) valid keys a
    row.  The cache is never moved: the query takes the cache's batch and
    head splits (replicated over its sequence split), each rank scores
    its local keys, masked by ``kv_len`` in global positions, and where
    the sequence is split the ranks that hold it merge by
    :func:`decode_merge`.  Where no mesh dim splits the sequence, each
    rank runs the one-device code on its batch and head shard."""
    mesh = k.device_mesh
    pls = _cache_layout(k)
    if tuple(v.placements) != pls:
        raise ValueError(f"K cache split as {pls}, V as {v.placements}")
    start, stop, seq = shard_range(k, 1)
    q_pl = [Replicate() if i in seq else pl for i, pl in enumerate(pls)]
    q_loc = q.redistribute(mesh, q_pl).to_local()
    kv_loc = _as_local(kv_len, mesh, _rows_layout(pls))
    k_loc, v_loc = k.to_local(), v.to_local()
    b, sq, hq, d = q_loc.shape
    hkv = k_loc.shape[2]
    qg = q_loc.reshape(b, sq, hkv, hq // hkv, d)
    if not seq:
        out = full_attention(qg, k_loc, v_loc, causal=False, kv_len=kv_loc)
    else:
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                              k_loc.float()) / math.sqrt(d)
        kpos = torch.arange(start, stop, device=k_loc.device)
        valid = kpos[None, :] < kv_loc[:, None]
        scores = torch.where(valid[:, None, None, None, :], scores, -1e30)
        out = decode_merge(scores, lambda p: torch.einsum(
            "bhgqk,bkhd->bqhgd", p.to(v_loc.dtype).float(), v_loc.float()),
            [mesh.get_group(i) for i in seq]).to(v_loc.dtype)
    return DTensor.from_local(out.reshape(b, sq, hq, -1), mesh, q_pl,
                              run_check=False)


# ------------------------------------------------------------------- init --


def _normal(gen: torch.Generator, shape, scale: float, dtype, device):
    """``N(0, scale^2)`` draws from ``gen`` (on its device), cast to
    ``dtype`` on ``device``."""
    out = torch.randn(shape, generator=gen, device=gen.device) * scale
    return out.to(device=device, dtype=dtype)


def _ones(n: int, dtype, device):
    return torch.ones((n,), dtype=dtype, device=device)


# -------------------------------------------------------------- GQA block --


def init_gqa(cfg, gen: torch.Generator, device) -> Dict:
    d, hd = cfg.d_model, cfg.head_dim
    s = d ** -0.5
    p = {
        "wq": _normal(gen, (d, cfg.n_heads * hd), s, cfg.dtype, device),
        "wk": _normal(gen, (d, cfg.n_kv_heads * hd), s, cfg.dtype, device),
        "wv": _normal(gen, (d, cfg.n_kv_heads * hd), s, cfg.dtype, device),
        "wo": _normal(gen, (cfg.n_heads * hd, d), s, cfg.dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = _ones(hd, cfg.dtype, device)
        p["k_norm"] = _ones(hd, cfg.dtype, device)
    return p


def split_heads(t: torch.Tensor, h: int, hd: int) -> torch.Tensor:
    """``t`` (..., h * hd) as (..., h, hd).  On a DTensor whose last dim
    is split over a mesh dim that does not divide ``h`` (2 kv-heads over
    4 "model" ranks), that split is undone first: DTensor has no rule for
    a view that cuts a head across ranks."""
    if isinstance(t, DTensor):
        last = t.dim() - 1
        pl = [Replicate() if isinstance(q, Shard) and q.dim == last
              and h % t.device_mesh.size(i) else q
              for i, q in enumerate(t.placements)]
        if pl != list(t.placements):
            t = t.redistribute(t.device_mesh, pl)
    return t.reshape(*t.shape[:-1], h, hd)


def gqa_project_qkv(p, x, cfg, positions):
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = split_heads(x @ p["wq"], cfg.n_heads, hd)
    k = split_heads(x @ p["wk"], cfg.n_kv_heads, hd)
    v = split_heads(x @ p["wv"], cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rmsnorm_eps)
        k = rms_norm(k, p["k_norm"], cfg.rmsnorm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attn(p, x, cfg, *, causal=True, attn_impl="auto") -> torch.Tensor:
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)  # batch-uniform: 1-D tables
    q, k, v = gqa_project_qkv(p, x, cfg, positions)
    out = attention(q, k, v, causal=causal, impl=attn_impl)
    return out.reshape(b, s, -1) @ p["wo"]


def gqa_decode(p, x, cache, pos, cfg) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. cache: {"k","v": (B, S_max, Hkv, D)}, written in
    place at each row's ``pos`` (B,); returns (y, cache)."""
    b, s, _ = x.shape  # s == 1
    positions = pos[:, None] + torch.arange(s, device=x.device)[None]
    q, k, v = gqa_project_qkv(p, x, cfg, positions)
    knew = _scatter_time(cache["k"], k, pos)
    vnew = _scatter_time(cache["v"], v, pos)
    out = attention(q, knew.to(q.dtype), vnew.to(q.dtype), causal=False,
                    kv_len=pos + 1, impl="full")
    y = out.reshape(b, s, -1) @ p["wo"]
    return y, {"k": knew, "v": vnew}


def _scatter_time(buf: torch.Tensor, new: torch.Tensor, pos: torch.Tensor):
    """Write ``new`` (B, 1, ...) into ``buf`` (B, S, ...) at each row's
    ``pos``, in place; returns ``buf``.  A row whose ``pos`` is past the
    end is left as it was, as the reference's one-hot blend leaves it.
    For finite values this is the blend's result, without reading and
    writing the whole buffer.  On a DTensor ``buf`` (a cache laid out by
    ``cache_shardings``) each rank writes, on its local tensor, the rows
    whose ``pos`` falls in its sequence range, at ``pos - start``:
    nothing of the cache moves between ranks."""
    start, n = 0, buf.shape[1]
    loc = buf
    if isinstance(buf, DTensor):
        mesh = buf.device_mesh
        pls = _cache_layout(buf, dims=tuple(range(buf.dim())))
        start, stop, seq = shard_range(buf, 1)
        n = stop - start
        new = _as_local(new, mesh, [Replicate() if i in seq else pl
                                    for i, pl in enumerate(pls)])
        pos = _as_local(pos, mesh, _rows_layout(pls))
        loc = buf.to_local()
    rows = torch.arange(loc.shape[0], device=loc.device)
    at = (pos - start).clamp(0, n - 1)
    inside = ((pos >= start) & (pos < start + n)).reshape(
        (-1,) + (1,) * (loc.dim() - 2))
    loc[rows, at] = torch.where(inside, new[:, 0].to(loc.dtype),
                                loc[rows, at])
    return buf


# -------------------------------------------------------------- MLA block --


def init_mla(cfg, gen: torch.Generator, device) -> Dict:
    d = cfg.d_model
    h = cfg.n_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim

    def mk(shape, fan):
        return _normal(gen, shape, fan ** -0.5, cfg.dtype, device)

    return {
        "w_dq": mk((d, cfg.q_lora_rank), d),
        "q_norm": _ones(cfg.q_lora_rank, cfg.dtype, device),
        "w_uq": mk((cfg.q_lora_rank, h * qk), cfg.q_lora_rank),
        "w_dkv": mk((d, cfg.kv_lora_rank + cfg.qk_rope_dim), d),
        "kv_norm": _ones(cfg.kv_lora_rank, cfg.dtype, device),
        "w_uk": mk((cfg.kv_lora_rank, h * cfg.qk_nope_dim), cfg.kv_lora_rank),
        "w_uv": mk((cfg.kv_lora_rank, h * cfg.v_head_dim), cfg.kv_lora_rank),
        "wo": mk((h * cfg.v_head_dim, d), h * cfg.v_head_dim),
    }


def _mla_q(p, x, cfg, positions):
    b, s, _ = x.shape
    cq = rms_norm(x @ p["w_dq"], p["q_norm"], cfg.rmsnorm_eps)
    q = split_heads(cq @ p["w_uq"], cfg.n_heads,
                    cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_nope, q_rope = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(p, x, cfg, positions):
    ckv_full = x @ p["w_dkv"]
    ckv = rms_norm(ckv_full[..., :cfg.kv_lora_rank], p["kv_norm"],
                   cfg.rmsnorm_eps)
    k_rope = ckv_full[..., cfg.kv_lora_rank:][:, :, None, :]  # (B,S,1,rope)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0]
    return ckv, k_rope


def mla_attn(p, x, cfg, *, causal=True, attn_impl="auto") -> torch.Tensor:
    """Training/prefill MLA: decompress K/V per token (standard form)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    positions = torch.arange(s, device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    ckv, k_rope = _mla_latent(p, x, cfg, positions)
    k_nope = split_heads(ckv @ p["w_uk"], h, cfg.qk_nope_dim)
    v = split_heads(ckv @ p["w_uv"], h, cfg.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, cfg.qk_rope_dim)], dim=-1)
    out = attention(q, k, v, causal=causal, impl=attn_impl)
    return out.reshape(b, s, -1) @ p["wo"]


def mla_decode(p, x, cache, pos, cfg) -> Tuple[torch.Tensor, Dict]:
    """Absorbed-matmul MLA decode over the latent cache.

    cache: {"ckv": (B, S, kv_lora), "k_rope": (B, S, rope)}, written in
    place at ``pos`` (B,).  ``w_uk`` is absorbed into the query and
    ``w_uv`` into the output, so attention runs in the latent space, in
    fp32.
    """
    b, s, _ = x.shape
    h = cfg.n_heads
    positions = pos[:, None] + torch.arange(s, device=x.device)[None]
    q_nope, q_rope = _mla_q(p, x, cfg, positions)          # (B,1,H,.)
    ckv_new, k_rope_new = _mla_latent(p, x, cfg, positions)
    ckv = _scatter_time(cache["ckv"], ckv_new, pos)
    k_rope = _scatter_time(cache["k_rope"], k_rope_new, pos)

    w_uk = p["w_uk"].reshape(cfg.kv_lora_rank, h, cfg.qk_nope_dim)
    q_lat = torch.einsum("bqhd,chd->bqhc", q_nope.float(), w_uk.float())
    scale = math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    if isinstance(ckv, DTensor):
        out_lat = _mla_attend_sharded(q_lat, q_rope, ckv, k_rope, pos + 1,
                                      scale)
    else:
        scores = (
            torch.einsum("bqhc,btc->bhqt", q_lat, ckv.float())
            + torch.einsum("bqhr,btr->bhqt", q_rope.float(), k_rope.float())
        ) / scale
        valid = (torch.arange(ckv.shape[1], device=x.device)[None, :]
                 < (pos + 1)[:, None])
        scores = torch.where(valid[:, None, None, :], scores, -1e30)
        pr = torch.softmax(scores, dim=-1)
        out_lat = torch.einsum("bhqt,btc->bqhc", pr, ckv.float())
    w_uv = p["w_uv"].reshape(cfg.kv_lora_rank, h, cfg.v_head_dim)
    out = torch.einsum("bqhc,chd->bqhd", out_lat, w_uv.float())
    y = out.reshape(b, s, -1).to(x.dtype) @ p["wo"]
    return y, {"ckv": ckv, "k_rope": k_rope}


def _mla_attend_sharded(q_lat, q_rope, ckv, k_rope, kv_len, scale):
    """``mla_decode``'s latent attention over a DTensor cache (``ckv``
    (B, S, C), ``k_rope`` (B, S, R), laid out by ``cache_shardings``):
    the queries (B, 1, H, .) take the cache's batch split with every
    head, each rank scores its sequence shard, masked by ``kv_len`` in
    global positions, and the ranks that split the sequence merge by
    :func:`decode_merge`.  Returns the latent output (B, 1, H, C), fp32,
    laid out like the cache's batch."""
    mesh = ckv.device_mesh
    pls = _cache_layout(ckv, dims=(0, 1))
    if tuple(k_rope.placements) != pls:
        raise ValueError(f"ckv split as {pls}, k_rope as {k_rope.placements}")
    start, stop, seq = shard_range(ckv, 1)
    rows = _rows_layout(pls)
    ql, qr = (_as_local(t, mesh, rows).float() for t in (q_lat, q_rope))
    c_loc, r_loc = ckv.to_local().float(), k_rope.to_local().float()
    kv_loc = _as_local(kv_len, mesh, rows)
    scores = (torch.einsum("bqhc,btc->bhqt", ql, c_loc)
              + torch.einsum("bqhr,btr->bhqt", qr, r_loc)) / scale
    valid = torch.arange(start, stop, device=c_loc.device)[None, :] \
        < kv_loc[:, None]
    scores = torch.where(valid[:, None, None, :], scores, -1e30)
    out = decode_merge(scores, lambda p: torch.einsum("bhqt,btc->bqhc", p,
                                                      c_loc),
                       [mesh.get_group(i) for i in seq])
    return DTensor.from_local(out, mesh, rows, run_check=False)


# -------------------------------------------------------------- MLP / MoE --


def init_mlp(cfg, gen: torch.Generator, device, d_ff=None) -> Dict:
    d = cfg.d_model
    d_ff = d_ff or cfg.d_ff
    return {
        "w_gate": _normal(gen, (d, d_ff), d ** -0.5, cfg.dtype, device),
        "w_up": _normal(gen, (d, d_ff), d ** -0.5, cfg.dtype, device),
        "w_down": _normal(gen, (d_ff, d), d_ff ** -0.5, cfg.dtype, device),
    }


def mlp(p, x) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def init_moe(cfg, gen: torch.Generator, device) -> Dict:
    d = cfg.d_model
    e = cfg.moe_experts
    dff = cfg.moe_d_ff or cfg.d_ff
    p = {
        "router": _normal(gen, (d, e), d ** -0.5, f32, device),
        "w_gate": _normal(gen, (e, d, dff), d ** -0.5, cfg.dtype, device),
        "w_up": _normal(gen, (e, d, dff), d ** -0.5, cfg.dtype, device),
        "w_down": _normal(gen, (e, dff, d), dff ** -0.5, cfg.dtype, device),
    }
    if cfg.moe_shared_experts:
        p["shared"] = init_mlp(cfg, gen, device,
                               d_ff=dff * cfg.moe_shared_experts)
    return p


def moe_route(p, xt: torch.Tensor, cfg):
    """Router of ``moe_ffn`` over tokens ``xt`` (T, D): fp32 softmax
    probabilities (T, E), the top-k gates renormalised and their expert
    ids (T, K), ties broken toward the lower id as ``lax.top_k`` does."""
    probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = srt[:, :cfg.moe_top_k], idx[:, :cfg.moe_top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, eidx


def moe_slots(eidx: torch.Tensor, cfg, *, cap: Optional[int] = None,
              j0: int = 0, e_loc: Optional[int] = None):
    """Sort-based dispatch of ``moe_ffn``: the (token, choice) pairs in
    stable expert order (``order``), each pair's row of the (E * cap)
    expert buffer (``slot``; a pair past its expert's capacity goes to
    the sentinel row ``E * cap``), whether it is kept, and ``cap =
    max(int(T * K / E * capacity_factor), 8)``.

    With ``e_loc`` (the expert-parallel path) only the experts
    ``[j0, j0 + e_loc)`` are kept, their rows numbered from ``j0``, the
    sentinel is ``e_loc * cap``, and ``cap`` is the caller's."""
    t, k = eidx.shape
    e = cfg.moe_experts
    if cap is None:
        cap = max(int(t * k / e * cfg.capacity_factor), 8)
    flat_e = eidx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(
        sorted_e, torch.arange(e, device=eidx.device, dtype=sorted_e.dtype))
    pos_in_e = torch.arange(t * k, device=eidx.device) - starts[sorted_e]
    keep = pos_in_e < cap
    if e_loc is None:
        e_loc = e
    else:
        keep = keep & (sorted_e >= j0) & (sorted_e < j0 + e_loc)
    slot = torch.where(keep, (sorted_e - j0) * cap + pos_in_e, e_loc * cap)
    return order, slot, keep, cap


def _expert_ffn(xt, order, slot, keep, cap, e_rows, wg, wu, wd):
    """The grouped expert GEMMs of one dispatch: the kept pairs' tokens
    into the (e_rows, cap, D) buffer, SwiGLU per expert, and each pair's
    output row in sorted order (0 for a dropped pair)."""
    token_of = order // (order.numel() // xt.shape[0])
    d = xt.shape[-1]
    xbuf = torch.zeros((e_rows * cap + 1, d), dtype=xt.dtype,
                       device=xt.device)
    xbuf[slot] = xt[token_of]             # dropped pairs: the sentinel row
    xg = xbuf[:e_rows * cap].reshape(e_rows, cap, d)
    h = torch.bmm(xg, wg)
    u = torch.bmm(xg, wu)
    yg = torch.bmm(F.silu(h) * u, wd)
    ybuf = yg.reshape(e_rows * cap, d)
    return torch.where(keep[:, None], ybuf[slot.clamp(max=e_rows * cap - 1)],
                       0.0)


def _combine(y_tok, gates, order, eidx, dtype):
    """Each token's k gated expert outputs, cast to ``dtype`` and summed
    in one fixed order (ascending expert id, the order the reference's
    scatter-add takes them in), so a second run gives the same bits on
    any device."""
    t, k = eidx.shape
    d = y_tok.shape[-1]
    g_tok = gates.reshape(-1)[order][:, None].to(y_tok.dtype)
    contrib = torch.empty_like(y_tok, dtype=dtype)
    contrib[order] = (y_tok * g_tok).to(dtype)   # back to (token, choice)
    contrib = contrib.reshape(t, k, d)
    by_expert = torch.argsort(eidx, dim=1)
    contrib = torch.gather(contrib, 1, by_expert[:, :, None].expand(t, k, d))
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    return out


def moe_ffn(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k MoE with sort-based grouped dispatch.

    x: (B, S, D) -> (out, aux_loss).  Each token's k expert outputs are
    summed in ascending expert id (:func:`_combine`).  Two paths, as the
    reference's:

      * default: one global sort over all tokens;
      * ``cfg.moe_ep`` under an ambient mesh whose "model" axis divides
        the experts: :func:`moe_ffn_ep`, expert-parallel.

    Under a mesh (DTensor activations) the default path runs rank by
    rank too (:func:`moe_ffn_ep` with ``token_parallel=False``): every
    rank routes all the tokens, with the global capacity, through the
    experts it holds.  DTensor has no rule for the routing's
    ``searchsorted`` and expert counts, and the reference's layout
    constraints on the dispatch buffers have no buffers to place there.
    """
    mesh = current_mesh()
    if mesh is not None and (cfg.moe_ep or isinstance(x, DTensor)):
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        ep = cfg.moe_ep and sizes.get("model", 1) > 1 \
            and cfg.moe_experts % sizes["model"] == 0
        if ep or isinstance(x, DTensor):
            return moe_ffn_ep(p, x, cfg, mesh, token_parallel=ep)
    b, s, d = x.shape
    t = b * s
    e, k = cfg.moe_experts, cfg.moe_top_k
    xt = x.reshape(t, d)
    probs, gates, eidx = moe_route(p, xt, cfg)

    # load-balancing aux loss (Switch-style)
    me = probs.mean(dim=0)
    ce = _expert_load(eidx, e) / (t * k)
    aux = e * torch.sum(me * ce)

    order, slot, keep, cap = moe_slots(eidx, cfg)
    y_tok = _expert_ffn(xt, order, slot, keep, cap, e, p["w_gate"],
                        p["w_up"], p["w_down"])
    out = _combine(y_tok, gates, order, eidx, x.dtype)

    if cfg.moe_shared_experts:
        out = out + mlp(p["shared"], xt)
    return out.reshape(b, s, d), aux


def _expert_load(eidx: torch.Tensor, e: int) -> torch.Tensor:
    """How many routed pairs each of the ``e`` experts got (fp32): the
    counts of ``bincount``, by a scatter-add, which also runs on the
    ``meta`` device (the dry-run traces the MoE layers there)."""
    flat = eidx.reshape(-1)
    return torch.zeros(e, dtype=torch.long, device=flat.device).scatter_add_(
        0, flat.long(), torch.ones_like(flat, dtype=torch.long)).float()


def moe_ep_capacity(t_loc: int, cfg) -> int:
    """Per-shard expert capacity of the expert-parallel path."""
    return max(int(t_loc * cfg.moe_top_k / cfg.moe_experts
                   * cfg.capacity_factor), 4)


def moe_ffn_ep_local(p, xt: torch.Tensor, cfg, *, j0: int, cap_loc: int):
    """The rank-local body of :func:`moe_ffn_ep`, with no collectives.

    ``xt``: this rank's token shard (T_loc, D); ``p``: the router (whole)
    and the expert weights of experts ``[j0, j0 + e_loc)`` (``w_gate``/
    ``w_up`` (e_loc, D, F), ``w_down`` (e_loc, F, D), whole in D).  The
    tokens are routed over all E experts; the pairs routed to the local
    experts, up to ``cap_loc`` per expert, go through them.  Returns
    ``(part, me, ce, routing)``: the fp32 partial output (T_loc, D), which
    summed over the expert shards is the layer's output; the local mean
    router probabilities and expert loads (E,), which averaged over the
    token shards make the aux loss; and ``{"slot", "keep", "order"}``.
    """
    e_loc = p["w_gate"].shape[0]
    e, k = cfg.moe_experts, cfg.moe_top_k
    probs, gates, eidx = moe_route(p, xt, cfg)
    me = probs.mean(dim=0)
    ce = _expert_load(eidx, e) / (xt.shape[0] * k)
    order, slot, keep, _ = moe_slots(eidx, cfg, cap=cap_loc, j0=j0,
                                     e_loc=e_loc)
    y_tok = _expert_ffn(xt, order, slot, keep, cap_loc, e_loc, p["w_gate"],
                        p["w_up"], p["w_down"])
    part = _combine(y_tok, gates, order, eidx, f32)
    return part, me, ce, {"slot": slot, "keep": keep, "order": order}


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) of rank partials over ``group``; the backward is
    the identity (each partial feeds one replicated sum)."""
    return _SumOver.apply(x, group)


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) over ``group``; the backward passes the gradient
    through: each rank's partial feeds one replicated sum."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        torch.distributed.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanOver(torch.autograd.Function):
    """All-reduce mean over ``group``; backward ``g / n`` (each rank's
    term is 1/n of the replicated mean)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n = torch.distributed.get_world_size(group)
        x = x.clone()
        torch.distributed.all_reduce(x, group=group)
        return x / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _ScaleGrad(torch.autograd.Function):
    """Identity forward, gradient times ``c``."""

    @staticmethod
    def forward(ctx, x, c):
        ctx.c = c
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.c, None


def _placed(mesh, **by_axis):
    """Placements, one per mesh dim, from ``axis=placement`` keywords
    (``Replicate()`` for the dims not named)."""
    return [by_axis.get(a, Replicate()) for a in mesh.mesh_dim_names]


def _as_local(t, mesh, layout, grad=None):
    """``t``'s local tensor after a redistribution to ``layout``, whose
    gradient goes back as ``grad`` placements (a plain ``t`` is taken as
    replicated: every rank holds the same values)."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, layout).to_local(grad_placements=grad)


def moe_ffn_ep(p, x: torch.Tensor, cfg, mesh, *, token_parallel: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE over the "model" axis of ``mesh`` (the
    reference's ``shard_map`` body as explicit per-rank code).

    Rank (i, j) takes token shard i (the batch over "data", when it
    divides) and experts ``[j * E/M, (j + 1) * E/M)``, whose weights it
    all-gathers over "data" (FSDP; the backward reduce-scatters their
    gradients).  :func:`moe_ffn_ep_local` routes and computes; ``me`` and
    ``ce`` are averaged over the token shards before the aux product, as
    the reference's ``pmean``; the fp32 partials are summed over "model"
    by one all-reduce, then cast.  Returns DTensors: the output (B, S, D)
    over the token shards and the aux loss, replicated.

    ``token_parallel=False`` is ``moe_ffn``'s global dispatch under a
    mesh: every rank takes all the tokens and the dense path's capacity,
    and, where "model" does not divide the experts, all of them (the
    model ranks then compute the same output, and nothing is summed).
    """
    b, s, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n_model, n_data = sizes.get("model", 1), sizes.get("data", 1)
    split = n_model > 1 and e % n_model == 0      # experts over "model"
    e_loc = e // n_model if split else e
    tok_sharded = token_parallel and n_data > 1 and b % n_data == 0
    t_loc = (b // n_data if tok_sharded else b) * s
    cap = (moe_ep_capacity(t_loc, cfg) if token_parallel
           else max(int(t_loc * k / e * cfg.capacity_factor), 8))
    tok = Shard(0) if tok_sharded else Replicate()
    # a rank's gradient of a replicated input is partial over the token
    # shards (its tokens) and over "model" (its experts)
    over_tok = Partial() if tok_sharded else Replicate()
    over_exp = Partial() if split else Replicate()
    held = Shard(0) if split else Replicate()
    x_loc = _as_local(x, mesh, _placed(mesh, data=tok),
                      _placed(mesh, data=tok, model=over_exp))
    router = _as_local(p["router"], mesh, _placed(mesh),
                       _placed(mesh, data=over_tok, model=over_exp))
    experts = {name: _as_local(p[name], mesh, _placed(mesh, model=held),
                               _placed(mesh, data=over_tok, model=held))
               for name in ("w_gate", "w_up", "w_down")}
    j0 = mesh.get_local_rank("model") * e_loc if split else 0
    part, me, ce, _ = moe_ffn_ep_local(
        {"router": router, **experts}, x_loc.reshape(-1, d), cfg, j0=j0,
        cap_loc=cap)
    if tok_sharded:               # global statistics before the product
        group = mesh.get_group("data")
        me = _MeanOver.apply(me, group)
        ce = _MeanOver.apply(ce, group)
    aux = e * torch.sum(me * ce)
    if split:
        # every "model" rank computes the same aux: 1/M of its gradient
        # each; the experts' partials sum over "model"
        aux = _ScaleGrad.apply(aux, 1.0 / n_model)
        part = sum_over(part, mesh.get_group("model"))
    out = part.to(x.dtype)
    out = DTensor.from_local(out.reshape(x_loc.shape), mesh,
                             _placed(mesh, data=tok), run_check=False)
    aux = DTensor.from_local(aux, mesh, _placed(mesh), run_check=False)
    if cfg.moe_shared_experts:
        out = out + mlp(p["shared"], x.reshape(-1, d)).reshape(x.shape)
    return out, aux


# ------------------------------------------------------------- Mamba2 SSD --


def init_mamba2(cfg, gen: torch.Generator, device) -> Dict:
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    n_heads = d_inner // cfg.ssm_headdim
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    conv_dim = d_inner + 2 * g * n
    return {
        "in_proj": _normal(gen, (d, 2 * d_inner + 2 * g * n + n_heads),
                           d ** -0.5, cfg.dtype, device),
        "conv_w": _normal(gen, (cfg.conv_width, conv_dim), 0.1, cfg.dtype,
                          device),
        "conv_b": torch.zeros((conv_dim,), dtype=cfg.dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads, dtype=f32,
                                          device=device)),
        "D": _ones(n_heads, f32, device),
        "dt_bias": torch.zeros((n_heads,), dtype=f32, device=device),
        "norm_w": _ones(d_inner, cfg.dtype, device),
        "out_proj": _normal(gen, (d_inner, d), d_inner ** -0.5, cfg.dtype,
                            device),
    }


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise cumulative sums:
    out[..., i, j] = sum_{j<k<=i} a_k, -inf above the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, seg, -math.inf)


def ssd_scan(x, da, bm, cm, chunk: int, init_state=None):
    """Chunked SSD (Mamba-2, state-space duality form), in fp32.

    x:  (B, L, H, P) inputs (already multiplied by dt); L a multiple of
    ``chunk``.  da: (B, L, H) decay dt*A (negative).  bm, cm: (B, L, G, N)
    input and output projections.  Returns (y (B, L, H, P), final state
    (B, H, P, N)); a Python loop carries the state across chunks.
    """
    b, l, h, pdim = x.shape
    g, n = bm.shape[2], bm.shape[3]
    hpg = h // g
    nc = l // chunk

    xc = x.reshape(b, nc, chunk, h, pdim).float()
    dac = da.reshape(b, nc, chunk, h).permute(0, 3, 1, 2)    # (B,H,C,Q)
    bmh = bm.reshape(b, nc, chunk, g, n).repeat_interleave(hpg, dim=3).float()
    cmh = cm.reshape(b, nc, chunk, g, n).repeat_interleave(hpg, dim=3).float()

    da_cs = torch.cumsum(dac, dim=-1)                          # (B,H,C,Q)
    lmat = torch.exp(_segsum(dac))                             # (B,H,C,Q,Q)

    # 1) intra-chunk (diagonal blocks)
    scores = torch.einsum("bcqhn,bckhn->bhcqk", cmh, bmh)
    y_diag = torch.einsum("bhcqk,bckhp->bcqhp", scores * lmat, xc)

    # 2) chunk states
    decay_states = torch.exp(da_cs[..., -1:] - da_cs)         # (B,H,C,Q)
    states = torch.einsum("bckhn,bckhp->bchpn",
                          bmh * decay_states.permute(0, 2, 3, 1)[..., None],
                          xc)

    # 3) inter-chunk recurrence over chunk states
    chunk_decay = torch.exp(da_cs[..., -1])                    # (B,H,C)
    st = (init_state.float() if init_state is not None
          else torch.zeros((b, h, pdim, n), dtype=f32, device=x.device))
    prior = []
    for c in range(nc):
        prior.append(st)                   # the state *before* chunk c
        st = st * chunk_decay[:, :, c][..., None, None] + states[:, c]
    prior = torch.stack(prior, dim=1)                          # (B,C,H,P,N)

    # 4) state -> output within chunk
    state_decay = torch.exp(da_cs)                             # (B,H,C,Q)
    y_off = torch.einsum("bcqhn,bchpn->bcqhp",
                         cmh * state_decay.permute(0, 2, 3, 1)[..., None],
                         prior)
    return (y_diag + y_off).reshape(b, l, h, pdim), st


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor):
    """Depthwise causal conv1d: xbc (B, L, C), w (W, C)."""
    wsz, l = w.shape[0], xbc.shape[1]
    xp = F.pad(xbc, (0, 0, wsz - 1, 0))
    out = xp[:, 0:l] * w[0]
    for i in range(1, wsz):
        out = out + xp[:, i:i + l] * w[i]
    return out + bias


def _mamba_split(zxbcdt, d_inner: int, gn: int):
    return (zxbcdt[..., :d_inner], zxbcdt[..., d_inner:2 * d_inner + 2 * gn],
            zxbcdt[..., 2 * d_inner + 2 * gn:])


def _batch_local(fn, p, x, state=None):
    """``fn(p, x)`` rank by rank on DTensors, data-parallel: each rank
    takes its batch shard ("data") and the weights whole (gathered; their
    gradients are partial over the batch shards), and the "model" ranks
    compute the same output.  With ``state`` (a dict of DTensors with a
    leading batch dim: a decode cache's layer) it is ``fn(p, x, state)``
    on the state's rows, whole in every other dim, and returns ``(y,
    new state)`` laid out the same way."""
    mesh = x.device_mesh
    n_data = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("data", 1)
    tok = Shard(0) if x.shape[0] % n_data == 0 else Replicate()
    whole_w = [Replicate()] * mesh.ndim
    grad_w = _placed(mesh, data=Partial() if isinstance(tok, Shard)
                     else Replicate())
    p_loc = tree_map(lambda w: w.redistribute(mesh, whole_w).to_local(
        grad_placements=grad_w), p)
    layout = _placed(mesh, data=tok)
    x_loc = x.redistribute(mesh, layout).to_local()
    if state is None:
        return DTensor.from_local(fn(p_loc, x_loc), mesh, layout,
                                  run_check=False)
    y, new = fn(p_loc, x_loc, {k: _as_local(t, mesh, layout)
                               for k, t in state.items()})
    return tree_map(lambda t: DTensor.from_local(t, mesh, layout,
                                                 run_check=False), (y, new))


def mamba2_block(p, x, cfg, *, chunk: int = 128) -> torch.Tensor:
    """Full-sequence Mamba-2 block (training / prefill); ``L`` is padded
    up to a multiple of ``chunk`` for the scan.  On DTensors it runs
    data-parallel (:func:`_batch_local`): its in-projection splits a
    sharded channel dim at uneven points, which DTensor releases before
    2.13 mishandle."""
    if isinstance(x, DTensor):
        return _batch_local(
            lambda p_, x_: mamba2_block(p_, x_, cfg, chunk=chunk), p, x)
    b, l, d = x.shape
    d_inner = cfg.ssm_expand * d
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    h = d_inner // cfg.ssm_headdim
    pdim = cfg.ssm_headdim

    z, xbc, dt = _mamba_split(x @ p["in_proj"], d_inner, g * n)
    xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xs, bm, cm = (xbc[..., :d_inner], xbc[..., d_inner:d_inner + g * n],
                  xbc[..., d_inner + g * n:])

    dt = F.softplus(dt.float() + p["dt_bias"])                 # (B,L,H)
    da = dt * -torch.exp(p["A_log"])                           # (B,L,H)

    xh_raw = xs.reshape(b, l, h, pdim)
    xh = xh_raw * dt[..., None].to(xh_raw.dtype)  # fold dt into the input
    pad = (-l) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        da = F.pad(da, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, pad))
    y, _ = ssd_scan(xh, da, bm.reshape(b, -1, g, n), cm.reshape(b, -1, g, n),
                    chunk)
    y = y[:, :l]
    y = y + p["D"][None, None, :, None] * xh_raw.float()  # skip: raw x
    y = y.reshape(b, l, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.rmsnorm_eps)
    return y @ p["out_proj"]


def mamba2_decode(p, x, cache, cfg) -> Tuple[torch.Tensor, Dict]:
    """Single-token recurrent step.

    cache: {"conv": (B, W-1, conv_dim), "ssm": (B, H, P, N)}; returns
    (y, the new conv window and state).  On DTensors it runs
    data-parallel (:func:`_batch_local`, as :func:`mamba2_block`): each
    rank steps its rows' states, whole in their heads and channels.
    """
    if isinstance(x, DTensor):
        return _batch_local(
            lambda p_, x_, c_: mamba2_decode(p_, x_, c_, cfg), p, x, cache)
    b, s, d = x.shape  # s == 1
    d_inner = cfg.ssm_expand * d
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    h = d_inner // cfg.ssm_headdim
    pdim = cfg.ssm_headdim

    z, xbc, dt = _mamba_split(x[:, 0] @ p["in_proj"], d_inner, g * n)
    conv_buf = torch.cat([cache["conv"], xbc[:, None]], dim=1)
    xbc = F.silu(torch.einsum("bwc,wc->bc", conv_buf, p["conv_w"])
                 + p["conv_b"])
    conv_new = conv_buf[:, 1:]

    xs, bm, cm = (xbc[..., :d_inner], xbc[..., d_inner:d_inner + g * n],
                  xbc[..., d_inner + g * n:])
    dt = F.softplus(dt.float() + p["dt_bias"])                 # (B,H)
    da = torch.exp(dt * -torch.exp(p["A_log"]))                # (B,H)

    xh = xs.reshape(b, h, pdim).float()
    bmh = bm.reshape(b, g, n).repeat_interleave(h // g, dim=1).float()
    cmh = cm.reshape(b, g, n).repeat_interleave(h // g, dim=1).float()

    ssm = cache["ssm"] * da[..., None, None] + \
        dt[..., None, None] * xh[..., None] * bmh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", ssm, cmh) + p["D"][None, :, None] * xh
    y = y.reshape(b, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.rmsnorm_eps)
    return (y @ p["out_proj"])[:, None], {"conv": conv_new, "ssm": ssm}

"""The port's LM blocks (``repro_torch.models.layers``) against the JAX
package's (``repro.models.layers``) on the same inputs, on the CPU.

Inputs come from numpy seeds; parameters from the reference's ``init_*``
carried across as numpy arrays.  Tolerances: fp32 ``rtol=1e-4,
atol=1e-5`` (scaled by the largest entry where the output is large);
bf16 one bf16 ulp of the largest entry (``2**-7``), the DESIGN.md §13
ladder's ``rtol ~ 1e-2``; MoE routing indices and kept slots exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import layers as jl
from repro_torch.configs import get_reduced
from repro_torch.models import layers as tl
from _torch_threads import one_intraop_thread  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    "error::repro_torch.core.dispatch.FallbackWarning")

RTOL, ATOL = 1e-4, 1e-5
BF16_RTOL = 2.0 ** -7


def t(a) -> torch.Tensor:
    """A numpy or JAX array as a CPU tensor (bf16 through float32)."""
    a = np.asarray(a)
    if a.dtype.kind not in "fiub":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def tree_t(tree):
    return jax.tree.map(t, tree)


def close(port, ref, rtol=RTOL, atol=ATOL, scaled=False):
    """``port`` (tensor) against ``ref`` (JAX or numpy array); with
    ``scaled`` the atol is relative to the largest entry of ``ref``."""
    ref = np.asarray(ref, np.float32)
    out = port.float().numpy()
    assert out.shape == ref.shape
    if scaled:
        atol = atol * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol)


def jitted(fn, *args):
    """``fn(*args)`` compiled once: eager JAX compiles op by op, which
    costs seconds a test.  fp32 only (jit may keep bf16 intermediates
    unrounded)."""
    return jax.jit(fn)(*args)


def draw(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


# ------------------------------------------------------------ norms, rope --


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    x = draw(0, 3, 5, 64, scale=3.0)
    w = 1.0 + draw(1, 64, scale=0.1)
    jdt = jnp.dtype(dtype)
    ref = jl.rms_norm(jnp.asarray(x, jdt), jnp.asarray(w, jdt), 1e-5)
    out = tl.rms_norm(t(np.asarray(jnp.asarray(x, jdt))),
                      t(np.asarray(jnp.asarray(w, jdt))), 1e-5)
    assert out.dtype == getattr(torch, dtype)
    if dtype == "float32":
        close(out, ref)
    else:   # the same rounding order: rounded norm, then the bf16 product
        close(out, ref, rtol=BF16_RTOL, atol=0)


def test_apply_rope_one_and_two_dimensional_positions():
    x = draw(2, 2, 7, 3, 32)
    pos1 = np.arange(7, dtype=np.int32) + 5
    pos2 = np.stack([pos1, pos1[::-1] * 9])
    for pos in (pos1, pos2):
        ref = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
        close(tl.apply_rope(t(x), t(pos), 1e6), ref, atol=1e-5)


# -------------------------------------------------------------- attention --


def test_repeat_kv():
    k = draw(21, 2, 5, 3, 8)
    for groups in (1, 4):
        assert np.array_equal(tl._repeat_kv(t(k), groups).numpy(),
                              np.asarray(jl._repeat_kv(jnp.asarray(k), groups)))


@pytest.mark.parametrize("causal,hq,hkv,kv_len", [
    (True, 4, 4, False), (True, 4, 2, False), (False, 8, 2, False),
    (False, 4, 1, True)])
def test_full_and_chunked_attention(causal, hq, hkv, kv_len):
    b, sq, sk, d = 2, 40, 40, 16
    q, k, v = draw(3, b, sq, hq, d), draw(4, b, sk, hkv, d), draw(5, b, sk, hkv, d)
    lens = np.array([17, 40], np.int32) if kv_len else None
    qg = q.reshape(b, sq, hkv, hq // hkv, d)
    ref = jitted(lambda q_, k_, v_, n_: jl.full_attention(
        q_, k_, v_, causal=causal, kv_len=n_), jnp.asarray(qg), jnp.asarray(k),
        jnp.asarray(v), None if lens is None else jnp.asarray(lens))
    out = tl.full_attention(t(qg), t(k), t(v), causal=causal,
                            kv_len=None if lens is None else t(lens))
    close(out, ref)
    if kv_len:
        return      # the chunked form has no kv_len
    ref_c = jitted(lambda *a: jl.chunked_attention(*a, causal=causal,
                                                   kv_block=16),
                   jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v))
    out_c = tl.chunked_attention(t(qg), t(k), t(v), causal=causal, kv_block=16)
    close(out_c, ref_c)
    close(out_c, ref)   # and the two forms agree


def test_attention_auto_takes_chunked_past_2048():
    b, s, h, d = 1, 2049, 2, 8
    q, k, v = draw(6, b, s, h, d), draw(7, b, s, h, d), draw(8, b, s, h, d)
    ref = jitted(lambda *a: jl.attention(*a, causal=True, kv_block=1024),
                 jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = tl.attention(t(q), t(k), t(v), causal=True, kv_block=1024)
    close(out, ref)
    chunked = tl.chunked_attention(t(q).reshape(b, s, h, 1, d), t(k), t(v),
                                   causal=True, kv_block=1024)
    assert torch.equal(out, chunked.reshape(b, s, h, d))


# ---------------------------------------------------------------- GQA, MLA --


def _cache_step(cfg, rng, b, cap, keys_shapes):
    cache = {k: rng.standard_normal((b, cap) + s).astype(np.float32)
             for k, s in keys_shapes.items()}
    pos = np.array([3, cap - 1][:b], np.int32)
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    return cache, pos, x


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen3-0.6b"])
def test_gqa_forward_and_decode(arch):
    cfg_j, cfg_t = jax_reduced(arch), get_reduced(arch)
    p = jl.init_gqa(jax.random.key(0), cfg_j)
    pt = tree_t(p)
    x = draw(9, 2, 12, cfg_j.d_model)
    close(tl.gqa_attn(pt, t(x), cfg_t),
          jitted(lambda p_, x_: jl.gqa_attn(p_, x_, cfg_j), p, jnp.asarray(x)),
          atol=1e-5, scaled=True)
    rng = np.random.default_rng(10)
    shape = (cfg_j.n_kv_heads, cfg_j.head_dim)
    cache, pos, x1 = _cache_step(cfg_j, rng, 2, 9, {"k": shape, "v": shape})
    y_ref, c_ref = jitted(
        lambda *a: jl.gqa_decode(*a, cfg_j), p, jnp.asarray(x1),
        jax.tree.map(jnp.asarray, cache), jnp.asarray(pos))
    y, c = tl.gqa_decode(pt, t(x1), tree_t(cache), t(pos), cfg_t)
    close(y, y_ref, scaled=True)
    for key in ("k", "v"):
        close(c[key], c_ref[key])


def test_mla_forward_and_absorbed_decode():
    cfg_j, cfg_t = jax_reduced("deepseek-v3-671b"), get_reduced("deepseek-v3-671b")
    p = jl.init_mla(jax.random.key(1), cfg_j)
    pt = tree_t(p)
    x = draw(11, 2, 10, cfg_j.d_model)
    close(tl.mla_attn(pt, t(x), cfg_t),
          jitted(lambda p_, x_: jl.mla_attn(p_, x_, cfg_j), p, jnp.asarray(x)),
          scaled=True)
    rng = np.random.default_rng(12)
    cache, pos, x1 = _cache_step(cfg_j, rng, 2, 7, {
        "ckv": (cfg_j.kv_lora_rank,), "k_rope": (cfg_j.qk_rope_dim,)})
    y_ref, c_ref = jitted(
        lambda *a: jl.mla_decode(*a, cfg_j), p, jnp.asarray(x1),
        jax.tree.map(jnp.asarray, cache), jnp.asarray(pos))
    y, c = tl.mla_decode(pt, t(x1), tree_t(cache), t(pos), cfg_t)
    close(y, y_ref, scaled=True)
    for key in ("ckv", "k_rope"):
        close(c[key], c_ref[key])


def test_scatter_time_is_the_one_hot_blend():
    """Rows written at ``pos``; a row whose ``pos`` is past the end is
    left as it was, as the reference's one-hot blend leaves it."""
    rng = np.random.default_rng(13)
    buf = rng.standard_normal((3, 5, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 1, 2, 4)).astype(np.float32)
    pos = np.array([0, 4, 5], np.int32)
    ref = jl._scatter_time(jnp.asarray(buf), jnp.asarray(new), jnp.asarray(pos))
    out = tl._scatter_time(t(buf), t(new), t(pos))
    assert np.array_equal(out.numpy(), np.asarray(ref))


# -------------------------------------------------------------- MLP / MoE --


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp(dtype):
    cfg_j = jax_reduced("granite-3-2b", dtype=jnp.dtype(dtype))
    p = jl.init_mlp(jax.random.key(2), cfg_j)
    x = jnp.asarray(draw(14, 2, 6, cfg_j.d_model), cfg_j.dtype)
    ref = jl.mlp(p, x)
    out = tl.mlp(tree_t(p), t(x))
    if dtype == "float32":
        close(out, ref, scaled=True)
    else:
        close(out, ref, rtol=0, atol=4 * BF16_RTOL, scaled=True)


def _jax_routing(p, x, cfg):
    """The reference's routing and slots (``moe_ffn``, layers.py:478-496)."""
    b, s, d = x.shape
    tk, e, k = b * s, cfg.moe_experts, cfg.moe_top_k
    xt = x.reshape(tk, d)
    probs = jax.nn.softmax((xt.astype(jnp.float32) @ p["router"]), axis=-1)
    gates, eidx = jax.lax.top_k(probs, k)
    cap = max(int(tk * k / e * cfg.capacity_factor), 8)
    flat_e = eidx.reshape(-1)
    order = jnp.argsort(flat_e)
    sorted_e = flat_e[order]
    starts = jnp.searchsorted(sorted_e, jnp.arange(e))
    pos_in_e = jnp.arange(tk * k) - starts[sorted_e]
    keep = pos_in_e < cap
    slot = jnp.where(keep, sorted_e * cap + pos_in_e, e * cap)
    return eidx, order, slot, keep, cap


@pytest.mark.parametrize("arch,cf,tokens", [
    ("moonshot-v1-16b-a3b", 1.25, 40),   # shared experts, tokens dropped
    ("deepseek-v3-671b", 4.0, 12)])      # dropless
def test_moe_ffn_routing_exact(arch, cf, tokens):
    cfg_j = jax_reduced(arch, capacity_factor=cf)
    cfg_t = get_reduced(arch, capacity_factor=cf)
    p = jl.init_moe(jax.random.key(3), cfg_j)
    pt = tree_t(p)
    x = draw(15, 2, tokens // 2, cfg_j.d_model)
    eidx, order, slot, keep, cap = _jax_routing(p, jnp.asarray(x), cfg_j)
    _, _, eidx_t = tl.moe_route(pt, t(x).reshape(tokens, -1), cfg_t)
    order_t, slot_t, keep_t, cap_t = tl.moe_slots(eidx_t, cfg_t)
    assert np.array_equal(eidx_t.numpy(), np.asarray(eidx))
    assert cap_t == cap
    assert np.array_equal(order_t.numpy(), np.asarray(order))
    assert np.array_equal(slot_t.numpy(), np.asarray(slot))
    assert np.array_equal(keep_t.numpy(), np.asarray(keep))
    if cf == 1.25:
        assert not bool(np.asarray(keep).all())   # the case drops pairs
    out_ref, aux_ref = jitted(lambda p_, x_: jl.moe_ffn(p_, x_, cfg_j), p,
                              jnp.asarray(x))
    out, aux = tl.moe_ffn(pt, t(x), cfg_t)
    close(out, out_ref, scaled=True)
    close(aux, aux_ref)
    out2, _ = tl.moe_ffn(pt, t(x), cfg_t)
    assert torch.equal(out, out2)          # fixed-order combine


def test_moe_top_k_ties_take_the_lower_expert():
    cfg_j = jax_reduced("moonshot-v1-16b-a3b")
    cfg_t = get_reduced("moonshot-v1-16b-a3b")
    p = jl.init_moe(jax.random.key(4), cfg_j)
    router = np.asarray(p["router"]).copy()
    router[:, 3] = router[:, 1]            # experts 1 and 3 always tie
    router[:, 2] = router[:, 0]            # and 0 and 2
    p = {**p, "router": jnp.asarray(router)}
    x = draw(16, 1, 9, cfg_j.d_model)
    eidx = _jax_routing(p, jnp.asarray(x), cfg_j)[0]
    _, _, eidx_t = tl.moe_route(tree_t(p), t(x).reshape(9, -1), cfg_t)
    assert np.array_equal(eidx_t.numpy(), np.asarray(eidx))
    assert (eidx_t.numpy().min(axis=1) < 2).all()


# ------------------------------------------------------------- Mamba2 SSD --


def _mamba_cfgs(**kw):
    return (jax_reduced("mamba2-2.7b", **kw), get_reduced("mamba2-2.7b", **kw))


def test_ssd_scan_with_initial_state():
    b, l, h, pdim, g, n, chunk = 2, 32, 4, 8, 2, 16, 8
    rng = np.random.default_rng(17)
    x = rng.standard_normal((b, l, h, pdim)).astype(np.float32)
    da = -np.abs(rng.standard_normal((b, l, h))).astype(np.float32) * 0.3
    bm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    st0 = rng.standard_normal((b, h, pdim, n)).astype(np.float32)
    y_ref, f_ref = jitted(
        lambda *a: jl.ssd_scan(*a[:4], chunk, init_state=a[4]),
        *map(jnp.asarray, (x, da, bm, cm, st0)))
    y, f = tl.ssd_scan(*map(t, (x, da, bm, cm)), chunk, init_state=t(st0))
    close(y, y_ref, scaled=True)
    close(f, f_ref, scaled=True)


def test_mamba2_block_pads_to_whole_chunks():
    cfg_j, cfg_t = _mamba_cfgs()
    p = jl.init_mamba2(jax.random.key(5), cfg_j)
    x = draw(18, 2, 21, cfg_j.d_model)           # 21 = 16 + 5: one pad
    close(tl.mamba2_block(tree_t(p), t(x), cfg_t, chunk=16),
          jitted(lambda p_, x_: jl.mamba2_block(p_, x_, cfg_j, chunk=16), p,
                 jnp.asarray(x)), scaled=True)


def test_mamba2_decode():
    cfg_j, cfg_t = _mamba_cfgs()
    p = jl.init_mamba2(jax.random.key(6), cfg_j)
    rng = np.random.default_rng(19)
    conv_dim = cfg_j.d_inner + 2 * cfg_j.ssm_ngroups * cfg_j.ssm_state
    cache = {"conv": rng.standard_normal(
        (2, cfg_j.conv_width - 1, conv_dim)).astype(np.float32),
        "ssm": rng.standard_normal((2, cfg_j.ssm_nheads, cfg_j.ssm_headdim,
                                    cfg_j.ssm_state)).astype(np.float32)}
    x = draw(20, 2, 1, cfg_j.d_model)
    y_ref, c_ref = jitted(lambda *a: jl.mamba2_decode(*a, cfg_j), p,
                          jnp.asarray(x), jax.tree.map(jnp.asarray, cache))
    y, c = tl.mamba2_decode(tree_t(p), t(x), tree_t(cache), cfg_t)
    close(y, y_ref, scaled=True)
    close(c["conv"], c_ref["conv"])
    close(c["ssm"], c_ref["ssm"], scaled=True)


def test_mamba2_init_shapes_and_dtypes_match_the_reference():
    for arch in ("mamba2-2.7b", "zamba2-1.2b"):
        cfg_j = jax_reduced(arch, dtype=jnp.bfloat16)
        cfg_t = get_reduced(arch, dtype=torch.bfloat16)
        ref = jl.init_mamba2(jax.random.key(7), cfg_j)
        out = tl.init_mamba2(cfg_t, torch.Generator().manual_seed(0), "cpu")
        assert set(out) == set(ref)
        for key, val in ref.items():
            assert tuple(out[key].shape) == val.shape, key
            assert out[key].dtype == t(np.asarray(val)).dtype, key
        for key in ("A_log", "D", "dt_bias", "conv_b", "norm_w"):
            close(out[key], ref[key])       # the deterministic leaves

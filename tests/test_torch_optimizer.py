"""The port's AdamW (``repro_torch.train.optimizer``) against the JAX
package's (``repro.train.optimizer``) on the CPU.

The trees are the reduced qwen3's parameters in the reference's stacked
layout (per-layer leaves ``(L, ...)``); both packages take the same
gradients, made with numpy, for two steps.  Tolerances: fp32 parameters
and moments ``rtol=1e-6`` (the same fp32 expressions; ``b ** count`` may
round apart by an ulp); bf16 parameters within one bf16 ulp (plus 1e-6 of
the leaf's largest entry, for results that cancel to near 0), at least
99% bitwise; int8 moment codes within one step, their scales
``rtol=1e-6``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro_torch import configs as tcfg
from repro_torch.train import optimizer as topt
from repro_torch.pytree import leaf_paths
from repro_torch.train.train_step import train_state_from_jax
from _torch_threads import one_intraop_thread  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    "error::repro_torch.core.dispatch.FallbackWarning")

CFG_T = tcfg.get_reduced("qwen3-0.6b")
SCALES = (1e-4, 1.0)   # gradient scale of each step: unclipped, clipped


def to_np(tree):
    return jax.tree.map(lambda a: None if a is None else np.asarray(a), tree)


def _params(dtype):
    cfg = jcfg.get_reduced("qwen3-0.6b", dtype=dtype)
    return to_np(jlm.init_lm(jax.random.key(0), cfg))


def _port(tree):
    return train_state_from_jax(CFG_T, {"params": tree}, device="cpu")[
        "params"]


def _grads(params, scale, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: (scale * rng.standard_normal(p.shape)).astype(np.float32),
        params)


def _check(port, ref, label):
    """A port tree against a JAX tree, leaf by leaf, by dtype."""
    ref_l = dict(leaf_paths(to_np(ref)))
    port_l = leaf_paths(port)
    assert sorted(p for p, _ in port_l) == sorted(ref_l), label
    for path, t in port_l:
        want = np.asarray(ref_l[path])
        where = f"{label}: {path}"
        if t.dtype == torch.int8:
            diff = np.abs(t.numpy().astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1, where
        elif t.dtype == torch.bfloat16:
            got = t.float().numpy()
            want = want.astype(np.float32)
            np.testing.assert_allclose(
                got, want, rtol=2.0 ** -7,
                atol=1e-6 * float(np.abs(want).max()), err_msg=where)
            assert (got == want).mean() >= 0.99, where
        else:
            assert t.dtype == getattr(torch, want.dtype.name), where
            np.testing.assert_allclose(
                t.numpy(), want, rtol=1e-6,
                atol=1e-7 * max(float(np.abs(want).max()), 1e-30),
                err_msg=where)


@pytest.mark.parametrize("quantize", [False, True], ids=["fp32-state",
                                                         "8bit-state"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype, quantize):
    """Two updates from the same gradients, the first below the clip's
    norm and the second above it: parameters, moments, scales, count and
    the metrics; the port's tensors change in place."""
    cfg_j = jopt.AdamWConfig(lr=1e-2, warmup_steps=1, quantize_state=quantize)
    cfg_t = topt.AdamWConfig(lr=1e-2, warmup_steps=1, quantize_state=quantize)
    pj = _params(getattr(jnp, dtype))
    oj = jopt.adamw_init(pj, cfg_j)
    pt = _port(pj)
    ot = topt.adamw_init(pt, cfg_t)
    wq = pt["layers"]["attn"]["wq"]
    update_j = jax.jit(lambda g, o, p: jopt.adamw_update(g, o, p, cfg_j))
    for step, scale in enumerate(SCALES):
        g = _grads(pj, scale, step)
        pj, oj, mj = update_j(jax.tree.map(jnp.asarray, g), oj, pj)
        pt, ot, mt = topt.adamw_update(_port(g), ot, pt, cfg_t)
        label = f"step {step}"
        _check(pt, pj, label)
        _check({k: v for k, v in ot.items() if v is not None},
               {k: v for k, v in oj.items() if v is not None}, label)
        assert int(ot["count"]) == int(oj["count"]) == step + 1
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(mt[key]), float(mj[key]),
                                       rtol=1e-6)
        clipped = float(mt["grad_norm"]) > cfg_t.grad_clip
        assert clipped == (scale == 1.0)
    assert pt["layers"]["attn"]["wq"] is wq


def test_lr_schedule_matches_jax():
    for cfg in (dict(), dict(warmup_steps=5, decay_steps=50),
                dict(warmup_steps=0, min_lr_ratio=0.0)):
        cj, ct = jopt.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
        for step in (0, 1, 3, 5, 50, 99, 100, 101, 5_000, 10_000, 20_000):
            got = topt.lr_schedule(ct, torch.tensor(step, dtype=torch.int32))
            want = jopt.lr_schedule(cj, jnp.asarray(step, jnp.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                       err_msg=f"{cfg} step {step}")


def test_global_norm_matches_jax():
    """fp32 sums of up to 65,536 squares a leaf, taken in another order:
    ``rtol=1e-5``."""
    pj = _params(jnp.bfloat16)
    g = _grads(pj, 3.0, 7)
    np.testing.assert_allclose(float(topt.global_norm(_port(g))),
                               float(jopt.global_norm(g)), rtol=1e-5)
    np.testing.assert_allclose(float(topt.global_norm(_port(pj))),
                               float(jopt.global_norm(pj)), rtol=1e-5)


def test_decay_applies_to_stacked_norms_not_the_final_norm():
    """With zero gradients only decay moves a parameter: the per-layer
    norms ``(L, d)`` shrink by ``lr * wd`` as in the reference, and the
    1-D ``final_norm`` stays."""
    cfg_j = jopt.AdamWConfig(lr=1e-2, warmup_steps=1)
    cfg_t = topt.AdamWConfig(lr=1e-2, warmup_steps=1)
    pj = _params(jnp.float32)
    zeros = jax.tree.map(np.zeros_like, pj)
    pt = _port(pj)
    pt, _, _ = topt.adamw_update(_port(zeros), topt.adamw_init(pt, cfg_t), pt,
                                 cfg_t)
    pj2, _, _ = jax.jit(lambda g, o, p: jopt.adamw_update(g, o, p, cfg_j))(
        zeros, jopt.adamw_init(pj, cfg_j), pj)
    _check(pt, pj2, "zero grads")
    lr = float(topt.lr_schedule(cfg_t, torch.tensor(1)))
    norm = pt["layers"]["attn_norm"]
    assert norm.shape == (CFG_T.n_layers, CFG_T.d_model)
    np.testing.assert_allclose(norm.numpy(), 1.0 - lr * cfg_t.weight_decay,
                               rtol=1e-6)
    for key in ("q_norm", "k_norm"):
        assert (pt["layers"]["attn"][key] < 1.0).all()
    assert torch.equal(pt["final_norm"], torch.ones(CFG_T.d_model))


@pytest.mark.parametrize("shape,block", [((), 256), ((5,), 256),
                                         ((3, 300), 256), ((2, 4, 256), 256),
                                         ((2, 128), 256), ((7, 33), 16)])
def test_block_quantizer_matches_jax_bitwise(shape, block):
    rng = np.random.default_rng(len(shape) + block)
    x = np.asarray(rng.standard_normal(shape) * 1e-3, np.float32)
    if x.size > 3:
        x.reshape(-1)[:3] = 0.0
    q, s = topt._quantize(torch.from_numpy(x), block)
    qj, sj = jopt._quantize(jnp.asarray(x), block)
    assert q.dtype == torch.int8 and tuple(q.shape) == shape
    assert np.array_equal(q.numpy(), np.asarray(qj))
    assert np.array_equal(s.numpy(), np.asarray(sj))
    last = shape[-1] if shape else 1
    assert tuple(s.shape) == (topt._quant_shape(shape, block) if shape
                              else ())
    np.testing.assert_array_equal(
        topt._dequantize(q, s, last, block).numpy(),
        np.asarray(jopt._dequantize(qj, sj, last, block)))


@pytest.mark.parametrize("quantize", [False, True])
def test_adamw_init_matches_the_reference_tree(quantize):
    pj = _params(jnp.bfloat16)
    oj = to_np(jopt.adamw_init(pj, jopt.AdamWConfig(quantize_state=quantize)))
    ot = topt.adamw_init(_port(pj), topt.AdamWConfig(quantize_state=quantize))
    assert sorted(ot) == sorted(oj)
    for key, val in oj.items():
        if val is None:
            assert ot[key] is None
            continue
        want = dict(leaf_paths(val))
        got = dict(leaf_paths(ot[key]))
        assert sorted(got) == sorted(want), key
        for path, w in want.items():
            assert tuple(got[path].shape) == w.shape, (key, path)
            assert str(got[path].dtype).removeprefix("torch.") == \
                w.dtype.name, (key, path)
            assert not got[path].any(), (key, path)

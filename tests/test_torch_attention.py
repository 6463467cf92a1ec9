"""Multi-head block-sparse attention parity: the port's fused attention
over H heads and its staged composition (``cuda_staged``) against the JAX
package's ``attention_pallas`` and ``attention_pallas_staged`` in
interpret mode; the gradients of ``spmm_ad``, ``sddmm_ad`` and
``attention_ad`` with leading-head and mixed operands against
``jax.grad``; the layers ``sparse_attention``/``sparse_attention_staged``;
and the training script against ``examples/sparse_attention_lm.py``."""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.core as jcore
from repro.core.autodiff import ad_plan as jax_ad_plan
from repro.core.autodiff import attention_ad as jax_attention_ad
from repro.core.autodiff import sddmm_ad as jax_sddmm_ad
from repro.core.autodiff import spmm_ad as jax_spmm_ad
from repro.kernels.attention_pallas import (attention_pallas,
                                            attention_pallas_staged)
from repro.models import layers as jlayers
from repro_torch.core import (ad_plan, attention, attention_ad, dispatch,
                              from_coo, from_dense, sddmm_ad, spmm_ad)
from repro_torch.core.format import block_format
from repro_torch.kernels import attention_cuda
from repro_torch.models.layers import sparse_attention, sparse_attention_staged
from repro_torch.train import sparse_attention_train as sat

ROOT = pathlib.Path(__file__).resolve().parents[1]

# fp32 on both sides; the sums are taken in another order.
RTOL, ATOL = 1e-5, 1e-5
# fp32 gradients of sums taken in another order.
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
# Two fp32 SGD steps through the layer.
STEP_RTOL, STEP_ATOL = 1e-4, 1e-4

PAIRS = [("blocked", "blocked"), ("cuda", "pallas"),
         ("cuda_balanced", "pallas_balanced")]


def _matrix():
    """40 x 36 with an empty window (rows 8-15); at k_blk=4 windows hold
    several blocks, so split_blk=2 splits them in both directions."""
    rng = np.random.default_rng(41)
    a = ((rng.random((40, 36)) < 0.3) * rng.standard_normal((40, 36))
         ).astype(np.float32)
    a[8:16] = 0.0
    return a


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


# (heads, the operands that carry the head dimension)
ATTN_MIXES = [(1, "qkv"), (4, "qkv"), (4, "q"), (4, "kv"), (4, "v")]


def _qkv(rng, h, mix, d=6, dv=5):
    return [_np(rng, *((h,) if name in mix else ()), rows, width)
            for name, rows, width in (("q", 40, d), ("k", 36, d),
                                      ("v", 36, dv))]


@pytest.mark.parametrize("h, mix", ATTN_MIXES)
def test_attention_over_heads_matches_pallas(h, mix):
    a = _matrix()
    port = block_format(from_dense(a), 4, device="cpu")
    jb = jcore.block_format(jcore.from_dense(a), 4)
    q, k, v = _qkv(np.random.default_rng(h + len(mix)), h, mix)
    out = attention_cuda(port, *map(torch.from_numpy, (q, k, v)), scale=0.7)
    assert out.shape == (h, 40, 5)
    _close(out, attention_pallas(jb, *map(jnp.asarray, (q, k, v)), scale=0.7))


@pytest.mark.parametrize("h, mix", [(4, "qkv"), (4, "q")])
def test_cuda_staged_attention_matches_pallas_staged(h, mix):
    a = _matrix()
    jb = jcore.block_format(jcore.from_dense(a), 4)
    q, k, v = _qkv(np.random.default_rng(5 * h + len(mix)), h, mix)
    with dispatch.record_calls() as log:
        out = attention(from_dense(a), *map(torch.from_numpy, (q, k, v)),
                        impl="cuda_staged", k_blk=4, scale=0.9)
    assert log == [("attention", "cuda_staged")]
    _close(out, attention_pallas_staged(jb, *map(jnp.asarray, (q, k, v)),
                                        scale=0.9))


@pytest.mark.parametrize("impl, jax_impl", PAIRS)
def test_op_gradients_with_heads_match_jax(impl, jax_impl):
    """Per-head and shared operands in every op, so the gradient of each
    shared operand is the sum over the heads; β's gradient included."""
    a = _matrix()
    m, k = a.shape
    h = 3
    plan = ad_plan(from_dense(a), impl=impl, k_blk=4, split_blk=2,
                   device="cpu")
    jplan = jax_ad_plan(jcore.from_dense(a), impl=jax_impl, k_blk=4,
                        split_blk=2)
    rng = np.random.default_rng(13)
    vals = np.asarray(jplan.vals)
    ins = [vals + _np(rng, *vals.shape),           # shared values
           _np(rng, h, k, 6),                      # per-head B
           _np(rng, h, *vals.shape),               # per-head values
           _np(rng, k, 4),                         # shared B
           _np(rng, h, m, 5), _np(rng, k, 5),      # SDDMM: per-head Q, shared K
           _np(rng, h, m, 6), _np(rng, h, k, 6),   # attention: per-head Q, K
           _np(rng, k, 7), np.float32(0.8)]        # shared V, β
    w = [_np(rng, h, m, 6), _np(rng, h, m, 4), _np(rng, h, *vals.shape),
         _np(rng, h, m, 7)]

    def jloss(v1, b1, v2, b2, q1, k1, q2, k2, v3, s):
        return (jnp.sum(w[0] * jax_spmm_ad(jplan, v1, b1))
                + jnp.sum(w[1] * jax_spmm_ad(jplan, v2, b2))
                + jnp.sum(w[2] * jax_sddmm_ad(jplan, q1, k1))
                + jnp.sum(w[3] * jax_attention_ad(jplan, q2, k2, v3,
                                                  scale=s)))

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(10))))(
        *map(jnp.asarray, ins))
    t = [torch.tensor(x, requires_grad=True) for x in ins]
    wt = [torch.from_numpy(x) for x in w]
    loss = ((wt[0] * spmm_ad(plan, t[0], t[1])).sum()
            + (wt[1] * spmm_ad(plan, t[2], t[3])).sum()
            + (wt[2] * sddmm_ad(plan, t[4], t[5])).sum()
            + (wt[3] * attention_ad(plan, t[6], t[7], t[8], scale=t[9])).sum())
    loss.backward()
    names = ["shared vals", "per-head b", "per-head vals", "shared b",
             "per-head q", "shared k", "attention q", "attention k",
             "shared v", "scale"]
    for name, got, ref in zip(names, t, want):
        assert got.grad.shape == got.shape, name
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def _causal(seq=160):
    rows, cols = sat.block_sparse_causal_pattern(seq)
    vals = np.ones(rows.shape, np.float32)
    return (from_coo(rows, cols, vals, (seq, seq)),
            jcore.from_coo(rows, cols, vals, (seq, seq)))


@pytest.mark.parametrize("layer", ["sparse_attention",
                                   "sparse_attention_staged"])
@pytest.mark.parametrize("impl, jax_impl", [("cuda", "pallas"),
                                            ("bare", "bare")])
def test_layers_match_jax(layer, impl, jax_impl):
    fmt, jfmt = _causal()
    q, k, v = sat.make_inputs(160, 2, 16)
    if impl == "bare":
        pattern = block_format(fmt, device="cpu")
        jpattern = jcore.block_format(jfmt)
        impl = jax_impl = None
    else:
        pattern = ad_plan(fmt, impl=impl, device="cpu")
        jpattern = jax_ad_plan(jfmt, impl=jax_impl)
    got = {"sparse_attention": sparse_attention,
           "sparse_attention_staged": sparse_attention_staged}[layer](
        pattern, *map(torch.from_numpy, (q, k, v)), impl=impl)
    want = getattr(jlayers, layer)(jpattern, *map(jnp.asarray, (q, k, v)),
                                   impl=jax_impl)
    _close(got, want)


def test_bare_pattern_takes_only_blocked():
    fmt, _ = _causal()
    with pytest.raises(ValueError, match="ADPlan"):
        sparse_attention(block_format(fmt, device="cpu"),
                         *(torch.ones(160, 4),) * 3, impl="cuda")


def _example():
    """``examples/sparse_attention_lm.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "sparse_attention_lm", ROOT / "examples" / "sparse_attention_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seq", [65, 256, 300])
def test_vectorised_pattern_equals_the_example(seq):
    want_rows, want_cols = _example().block_sparse_causal_pattern(seq)
    rows, cols = sat.block_sparse_causal_pattern(seq)
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_array_equal(cols, want_cols)
    assert rows.dtype == want_rows.dtype and cols.dtype == want_cols.dtype


@functools.lru_cache(maxsize=None)
def _jax_value_projection(steps=2, lr=0.05):
    """The example's ``train_value_projection`` arithmetic in JAX
    (``blocked``): the loss before each step and W after the last."""
    _, jfmt = _causal()
    jplan = jax_ad_plan(jfmt, impl="blocked")
    q, k, v = map(jnp.asarray, sat.make_inputs(160, 2, 16))
    target = jlayers.sparse_attention(jplan, q, k, v, impl="blocked")
    w = jnp.asarray(sat.initial_w(16))

    def loss_fn(w_):
        out = jlayers.sparse_attention(jplan, q, k, v @ w_, impl="blocked")
        return jnp.mean((out - target) ** 2)

    loss_grad = jax.jit(jax.value_and_grad(loss_fn))
    losses = []
    for _ in range(steps):
        loss, gw = loss_grad(w)
        w = w - lr * gw
        losses.append(float(loss))
    return losses, np.asarray(w)


@pytest.mark.parametrize("impl, staged", [("blocked", False), ("cuda", False),
                                          ("cuda_balanced", False),
                                          ("cuda", True)])
def test_value_projection_steps_match_jax(impl, staged):
    want_losses, want_w = _jax_value_projection()
    fmt, _ = _causal()
    plan = ad_plan(fmt, impl=impl, device="cpu")
    t = sat.params_from_jax(device="cpu", **dict(zip(
        "qkv", sat.make_inputs(160, 2, 16))))
    run = sat.train_value_projection(plan, t["q"], t["k"], t["v"], impl,
                                     steps=2, staged=staged)
    np.testing.assert_allclose(run.losses, want_losses, rtol=STEP_RTOL)
    np.testing.assert_allclose(run.w.numpy(), want_w, rtol=STEP_RTOL,
                               atol=STEP_ATOL)
    assert run.final < run.losses[0]


def test_multi_head_forward_and_backward_dispatch_once_per_op():
    """One dispatch per op for all heads: the fused kernel forward; the
    recomputed scores, dV, dProbs, dQ and dK backward, each on the head
    grids; the staged layer's SDDMM and SpMM likewise."""
    fmt, _ = _causal()
    plan = ad_plan(fmt, impl="cuda", device="cpu")
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in sat.make_inputs(160, 3, 16))
    with dispatch.record_calls() as log:
        sparse_attention(plan, q, k, v).sum().backward()
    assert log == [("attention", "cuda_fused_attn"),
                   ("sddmm", "cuda_batched"), ("spmm", "cuda_batched"),
                   ("sddmm", "cuda_batched"), ("spmm", "cuda_batched"),
                   ("spmm", "cuda_batched")]
    with dispatch.record_calls() as log:
        sparse_attention_staged(plan, q, k, v).sum().backward()
    # forward SDDMM, SpMM; backward dProbs, dV (SpMM vjp), dQ, dK
    assert sorted(log) == sorted([("sddmm", "cuda_batched")] * 2
                                 + [("spmm", "cuda_batched")] * 4)


def test_sparse_attention_smoke_cli(capsys):
    sat.main(["--device", "cpu", "--seq", "160", "--heads", "2",
              "--head-dim", "16", "--steps", "2"])
    out = capsys.readouterr().out
    assert "ONE fused-kernel dispatch for 2 heads" in out
    assert "OK: finite decreasing loss" in out


@pytest.mark.parametrize("entry", ["params_from_jax", "cli"])
def test_sparse_attention_entry_points_default_to_the_card(monkeypatch,
                                                           entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {"params_from_jax": lambda: sat.params_from_jax(w=np.ones((2, 2))),
             "cli": lambda: sat.main(["--seq", "64"])}
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[entry]()

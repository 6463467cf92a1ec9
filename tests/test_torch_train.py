"""Training parity: the port's autograd duality and GNN train step against
the JAX package's ``jax.grad`` and ``make_gnn_train_step``, per impl pair
(plain ``blocked``; ``cuda`` against ``pallas``; ``cuda_balanced`` against
``pallas_balanced``, the Pallas kernels in interpret mode); plus the
capability checks of the train step and the smoke CLI."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.core as jcore
import repro.sparse.graphs as jgraphs
from repro.core.autodiff import ad_plan as jax_ad_plan
from repro.core.autodiff import attention_ad as jax_attention_ad
from repro.core.autodiff import sddmm_ad as jax_sddmm_ad
from repro.core.autodiff import spmm_ad as jax_spmm_ad
from repro.models import gnn as jgnn
from repro.train.train_step import make_gnn_train_step as jax_train_step
from repro_torch.core import (ad_plan, attention_ad, block_format, dispatch,
                              from_coo, from_dense, sddmm_ad, spmm_ad)
from repro_torch.models import gnn
from repro_torch.train import gnn_train
from repro_torch.train.train_step import make_gnn_train_step
from _torch_threads import one_intraop_thread  # noqa: F401

# fp32 gradients of sums taken in another order.
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
# Two fp32 steps through several layers.
STEP_RTOL, STEP_ATOL = 1e-4, 1e-4
LR = 0.05

PAIRS = [("blocked", "blocked"), ("cuda", "pallas"),
         ("cuda_balanced", "pallas_balanced")]


def _matrix():
    """48 x 40 with an empty window, at k_blk=4 several blocks per window,
    so split_blk=2 splits windows in both directions."""
    rng = np.random.default_rng(11)
    a = ((rng.random((48, 40)) < 0.3) * rng.standard_normal((48, 40))
         ).astype(np.float32)
    a[8:16] = 0.0
    return a


@pytest.mark.parametrize("impl, jax_impl", PAIRS)
def test_op_gradients_match_jax(impl, jax_impl):
    a = _matrix()
    m, k = a.shape
    plan = ad_plan(from_dense(a), impl=impl, k_blk=4, split_blk=2,
                   device="cpu")
    jplan = jax_ad_plan(jcore.from_dense(a), impl=jax_impl, k_blk=4,
                        split_blk=2)
    rng = np.random.default_rng(12)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    vals = np.asarray(jplan.vals)
    ins = [vals + r(*vals.shape), r(k, 10), r(m, 6), r(k, 6), r(m, 5),
           r(k, 5), r(k, 7), np.float32(0.8)]
    w_c, w_s, w_a = r(m, 10), r(*vals.shape), r(m, 7)

    def jloss(vals_, b, q1, k1, q2, k2, v2, s):
        return (jnp.sum(w_c * jax_spmm_ad(jplan, vals_, b))
                + jnp.sum(w_s * jax_sddmm_ad(jplan, q1, k1))
                + jnp.sum(w_a * jax_attention_ad(jplan, q2, k2, v2, scale=s)))

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(8))))(
        *map(jnp.asarray, ins))
    t = [torch.tensor(x, requires_grad=True) for x in ins]
    loss = ((torch.from_numpy(w_c) * spmm_ad(plan, t[0], t[1])).sum()
            + (torch.from_numpy(w_s) * sddmm_ad(plan, t[2], t[3])).sum()
            + (torch.from_numpy(w_a)
               * attention_ad(plan, t[4], t[5], t[6], scale=t[7])).sum())
    loss.backward()
    for name, got, ref in zip(["vals", "b", "q", "k", "q_attn", "k_attn",
                               "v_attn", "scale"], t, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_unneeded_cotangents_launch_nothing():
    a = _matrix()
    plan = ad_plan(from_dense(a), impl="cuda", device="cpu")
    b = torch.ones(a.shape[1], 4, requires_grad=True)
    with dispatch.record_calls() as log:
        spmm_ad(plan, plan.vals, b).sum().backward()
    # forward, then dB only: the adjacency values need no gradient
    assert log == [("spmm", "cuda")] * 2
    h = torch.ones(a.shape[0], 4, requires_grad=True)
    hk = torch.ones(a.shape[1], 4)
    with dispatch.record_calls() as log:
        attention_ad(plan, h, hk, hk).sum().backward()
    # forward kernel; backward: scores, dProbs (SDDMM) and dQ (SpMM) only
    assert log == [("attention", "cuda_fused_attn"), ("sddmm", "cuda"),
                   ("sddmm", "cuda"), ("spmm", "cuda")]


def _graph(n=56, deg=5, seed=7):
    rows, cols = jgraphs.erdos_renyi_graph(n, deg, seed=seed)
    loops = np.arange(n)
    rows, cols = np.concatenate([rows, loops]), np.concatenate([cols, loops])
    return rows, cols, jgraphs.gcn_normalized(rows, cols, n), n


def _cfg_kw(model):
    return dict(model=model, in_dim=16, hidden_dim=16 if model == "gcn" else 8,
                num_classes=4, num_layers=3 if model == "gcn" else 2)


def _task(n):
    rng = np.random.default_rng(3)
    return (rng.standard_normal((n, 16)).astype(np.float32),
            rng.integers(0, 4, size=n), (rng.random(n) < 0.7).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_run(model, jax_impl):
    """Initial parameters, per-step losses and the parameters after two
    JAX steps (numpy leaves)."""
    rows, cols, vals, n = _graph()
    jcfg = jgnn.GNNConfig(impl=jax_impl, interpret=True, **_cfg_kw(model))
    init = jgnn.init_gcn if model == "gcn" else jgnn.init_agnn
    params = init(jax.random.key(0), jcfg)
    if model == "agnn":   # a learned β away from its init
        params["beta"] = [jnp.asarray(1.7, jnp.float32),
                          jnp.asarray(0.6, jnp.float32)]
    p0 = jax.tree.map(np.asarray, params)
    plan = jax_ad_plan(jcore.from_coo(rows, cols, vals, (n, n)),
                       impl=jax_impl)
    x, labels, mask = _task(n)
    step = jax_train_step(jcfg, lr=LR)
    mom = jax.tree.map(jnp.zeros_like, params)
    losses = []
    for _ in range(2):
        params, mom, loss, _ = step(params, mom, plan, jnp.asarray(x),
                                    jnp.asarray(labels.astype(np.int32)),
                                    jnp.asarray(mask))
        losses.append(float(loss))
    return p0, losses, jax.tree.map(np.asarray, params)


# The AGNN kernel impls are held against the JAX blocked run: the Pallas
# AGNN train step costs several seconds of interpret-mode compilation, and
# test_op_gradients_match_jax holds the port's attention gradients against
# pallas and pallas_balanced already.
TRAIN_CASES = [("gcn", "blocked", "blocked"), ("gcn", "cuda", "pallas"),
               ("gcn", "cuda_balanced", "pallas_balanced"),
               ("agnn", "blocked", "blocked"), ("agnn", "cuda", "blocked"),
               ("agnn", "cuda_balanced", "blocked")]


@pytest.mark.parametrize("model, impl, jax_impl", TRAIN_CASES)
def test_two_train_steps_match_jax(model, impl, jax_impl):
    p0, want_losses, want = _jax_run(model, jax_impl)
    rows, cols, vals, n = _graph()
    cfg = gnn.GNNConfig(impl=impl, **_cfg_kw(model))
    net = gnn.params_from_jax(cfg, p0, device="cpu")
    plan = ad_plan(from_coo(rows, cols, vals, (n, n)), impl=impl,
                   device="cpu")
    x, labels, mask = (torch.from_numpy(t) for t in _task(n))
    step = gnn.make_train_step(cfg, net, lr=LR)
    losses = [step(plan, x, labels, mask)[0].item() for _ in range(2)]
    np.testing.assert_allclose(losses, want_losses, rtol=STEP_RTOL)
    if model == "gcn":
        pairs = zip(net.w, want["w"])
    else:
        pairs = zip([net.w_in, net.w_out, *net.beta],
                    [want["w_in"], want["w_out"], *want["beta"]])
    for p, ref in pairs:
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=STEP_RTOL,
                                   atol=STEP_ATOL)


def test_train_step_checks_capability_and_adjacency():
    cfg = gnn.GNNConfig(impl="coo_segment", **_cfg_kw("gcn"))
    net = gnn.GCN(cfg, device="cpu")
    with pytest.raises(ValueError, match="not differentiable"):
        make_gnn_train_step(cfg, net)
    rows, cols, vals, n = _graph()
    blocked = block_format(from_coo(rows, cols, vals, (n, n)), device="cpu")
    step = make_gnn_train_step(gnn.GNNConfig(impl="cuda", **_cfg_kw("gcn")),
                               net)
    x, labels, mask = (torch.from_numpy(t) for t in _task(n))
    with pytest.raises(ValueError, match="trains only through an ADPlan"):
        step(blocked, x, labels, mask)


@pytest.mark.parametrize("impl", ["cuda", "cuda_balanced"])
def test_gnn_train_smoke_cli(impl, capsys):
    gnn_train.main(["--steps", "2", "--impl", impl, "--device", "cpu",
                    "--model", "agnn"])
    assert "OK: finite decreasing loss" in capsys.readouterr().out

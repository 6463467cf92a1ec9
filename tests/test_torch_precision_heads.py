"""Precision parity on the head grids and the balanced route: the port's
bf16 and int8 variants of the batched SpMM/SDDMM, the balanced
SpMM/SDDMM/attention and the fused attention over heads against the JAX
package's Pallas kernels in interpret mode, and the two paths they carry
end to end.

  * each variant's plain version (what the wrapper runs on CPU tensors)
    against the interpret-mode kernel at the same precision:
    ``spmm_pallas_batched`` bf16 / int8 (int8 values shared by the heads),
    ``spmm_pallas_balanced`` bf16 / int8, ``sddmm_pallas_batched`` and
    ``sddmm_pallas_balanced`` bf16, ``attention_pallas`` bf16 at H = 2 and
    ``attention_pallas_balanced`` bf16 at H = 1 and 2; every entry within
    one bf16 ulp and at least 99% of the entries bitwise equal (both sides
    contract the same narrow inputs in fp32 and round once), on vendored
    matrices, the balanced ones over runs that cut windows;
  * the multi-head attention path: one value-projection step under a bf16
    plan at H = 2 on ``cuda`` and ``cuda_balanced`` against JAX's step on
    ``pallas`` and ``pallas_balanced`` at bf16;
  * the balanced GNN path: two-layer GCN and AGNN in bf16 and GCN under
    an int8 plan on ``cuda_balanced`` against JAX's ``pallas_balanced``,
    and three steps with a falling loss.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.core as jcore
import repro.sparse.graphs as jgraphs
from repro.core.autodiff import ad_plan as jax_ad_plan
from repro.data.datasets import load_vendored
from repro.kernels.attention_pallas import (attention_pallas,
                                            attention_pallas_balanced)
from repro.kernels.sddmm_pallas import (sddmm_pallas_balanced,
                                        sddmm_pallas_batched)
from repro.kernels.spmm_pallas import spmm_pallas_balanced, spmm_pallas_batched
from repro.models import gnn as jgnn
from repro.models import layers as jlayers
from repro.train.train_step import make_gnn_train_step as jax_train_step
from repro_torch.core import ad_plan, block_format, from_coo, spmm
from repro_torch.core import quantize
from repro_torch.core.sddmm import with_values
from repro_torch.kernels import (attention_balanced_cuda, attention_cuda,
                                 sddmm_balanced_cuda, sddmm_batched_cuda,
                                 spmm_balanced_cuda, spmm_batched_cuda)
from repro_torch.models import gnn
from repro_torch.train import sparse_attention_train as sat
from _torch_threads import one_intraop_thread  # noqa: F401

BF16 = torch.bfloat16
# One bf16 ulp of an entry (2^-7 of it at most) plus a floor of 1e-6 of the
# output's largest entry, and the share of bitwise-equal entries.
ULP_RTOL, ULP_ATOL_OF_MAX, BITWISE_SHARE = 2.0 ** -7, 1e-6, 0.99
# Runs of two K-blocks, so the run-carried kernels' plain versions cut
# windows into pieces and merge them (the wrappers' default runs hold
# whole windows of these small matrices).
RUN_BLK = 2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _assert_one_ulp(got, want, label=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, label
    atol = ULP_ATOL_OF_MAX * max(np.abs(want).max(initial=0.0), 1e-30)
    np.testing.assert_allclose(got, want, rtol=ULP_RTOL, atol=atol,
                               err_msg=label)
    share = np.mean(got == want) if got.size else 1.0
    assert share >= BITWISE_SHARE, f"{label}: {share:.4f} bitwise equal"


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(BF16)


@functools.lru_cache(maxsize=None)
def _formats(name):
    """A vendored matrix blocked at V = 8, k_blk = 8 in both packages."""
    s = load_vendored([name])[0]
    port = block_format(from_coo(s.rows, s.cols, s.vals, s.shape,
                                 vector_size=8), 8, device="cpu")
    jb = jcore.block_format(jcore.from_coo(s.rows, s.cols, s.vals, s.shape,
                                           vector_size=8), 8)
    return port, jb


MATRICES = ["hub_128", "rect_120x40"]


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# ------------------------------------------------------- the head grids ----


@pytest.mark.parametrize("name", MATRICES)
def test_batched_spmm_bf16_and_int8_plain_within_one_ulp_of_pallas(name):
    port, jb = _formats(name)
    h, k = 2, port.shape[1]
    vals, b = _draw(1, (h, *port.vals.shape), (h, k, 24))
    vals = vals * port.mask.numpy()
    # bf16: per-head values and B
    p16 = with_values(port, _bf16(vals))
    want = spmm_pallas_batched(dataclasses.replace(jb, vals=jnp.asarray(vals)),
                               jnp.asarray(b), interpret=True,
                               precision="bf16")
    got = spmm_batched_cuda(p16, _bf16(b))
    assert got.dtype == BF16 and got.shape == (h, port.shape[0], 24)
    _assert_one_ulp(got, want, "spmm_batched_cuda bf16")
    # int8: the pattern's values shared by the heads, B per head at bf16
    want = spmm_pallas_batched(jb, jnp.asarray(b), interpret=True,
                               precision="int8")
    got = spmm_batched_cuda(quantize.quantize_format(port), _bf16(b))
    _assert_one_ulp(got, want, "spmm_batched_cuda int8")
    # the entry point applies the same policy to fp32 operands
    _assert_one_ulp(spmm(port, torch.from_numpy(b), impl="cuda_batched",
                         precision="int8"), want, "spmm cuda_batched int8")


@pytest.mark.parametrize("name", MATRICES)
def test_batched_sddmm_and_attention_bf16_plain_within_one_ulp_of_pallas(name):
    port, jb = _formats(name)
    h, (m, k) = 2, port.shape
    q, kk, v = _draw(2, (h, m, 16), (h, k, 16), (h, k, 12))
    want = sddmm_pallas_batched(jb, jnp.asarray(q), jnp.asarray(kk),
                                interpret=True, precision="bf16")
    got = sddmm_batched_cuda(port, _bf16(q), _bf16(kk))
    assert got.dtype == BF16 and got.shape == (h, *port.vals.shape)
    _assert_one_ulp(got, want, "sddmm_batched_cuda bf16")
    if m != k:
        return   # the fused attention wants a square pattern's keys
    want = attention_pallas(jb, jnp.asarray(q), jnp.asarray(kk),
                            jnp.asarray(v), scale=0.7, interpret=True,
                            precision="bf16")
    got = attention_cuda(port, _bf16(q), _bf16(kk), _bf16(v),
                         scale=torch.tensor(0.7))
    assert got.dtype == BF16 and got.shape == (h, m, 12)
    _assert_one_ulp(got, want, "attention_cuda bf16, H=2")


# ------------------------------------------------------ the balanced route ----


@pytest.mark.parametrize("name", MATRICES)
def test_balanced_spmm_bf16_and_int8_plain_within_one_ulp_of_pallas(name):
    port, jb = _formats(name)
    sched, jsched = port.schedule(1), jb.schedule(1)
    (b,) = _draw(3, (port.shape[1], 40))
    want = spmm_pallas_balanced(jb, jnp.asarray(b), schedule=jsched,
                                interpret=True, precision="bf16")
    p16 = with_values(port, port.vals.to(BF16))
    got = spmm_balanced_cuda(p16, _bf16(b), schedule=sched, run_blk=RUN_BLK)
    assert got.dtype == BF16
    _assert_one_ulp(got, want, "spmm_balanced_cuda bf16")
    want = spmm_pallas_balanced(jb, jnp.asarray(b), schedule=jsched,
                                interpret=True, precision="int8")
    got = spmm_balanced_cuda(quantize.quantize_format(port), _bf16(b),
                             schedule=sched, run_blk=RUN_BLK)
    _assert_one_ulp(got, want, "spmm_balanced_cuda int8")
    _assert_one_ulp(spmm(port, torch.from_numpy(b), impl="cuda_balanced",
                         precision="int8"), want, "spmm cuda_balanced int8")


@pytest.mark.parametrize("h", [1, 2])
def test_balanced_sddmm_and_attention_bf16_plain_within_one_ulp_of_pallas(h):
    port, jb = _formats("hub_128")
    sched, jsched = port.schedule(1), jb.schedule(1)
    m, k = port.shape
    hs = (h,) if h > 1 else ()
    q, kk, v = _draw(4 + h, (*hs, m, 16), (k, 16), (*hs, k, 12))
    want = sddmm_pallas_balanced(jb, jnp.asarray(q), jnp.asarray(kk),
                                 schedule=jsched, interpret=True,
                                 precision="bf16")
    got = sddmm_balanced_cuda(port, _bf16(q), _bf16(kk), schedule=sched)
    assert got.dtype == BF16
    _assert_one_ulp(got, want, f"sddmm_balanced_cuda bf16, H={h}")
    want = attention_pallas_balanced(jb, jnp.asarray(q), jnp.asarray(kk),
                                     jnp.asarray(v), schedule=jsched,
                                     scale=0.7, interpret=True,
                                     precision="bf16")
    got = attention_balanced_cuda(port, _bf16(q), _bf16(kk), _bf16(v),
                                  scale=torch.tensor(0.7), schedule=sched,
                                  run_blk=RUN_BLK)
    assert got.dtype == BF16 and got.shape == (*hs, m, 12)
    _assert_one_ulp(got, want, f"attention_balanced_cuda bf16, H={h}")


# ------------------------------------------- the multi-head attention path ----


SEQ, HEADS, DIM = 128, 2, 16
JAX_IMPL = {"cuda": "pallas", "cuda_balanced": "pallas_balanced"}


def _pattern():
    rows, cols = sat.block_sparse_causal_pattern(SEQ, window=32, stride=48)
    vals = np.ones(rows.shape, np.float32)
    return (from_coo(rows, cols, vals, (SEQ, SEQ), vector_size=8),
            jcore.from_coo(rows, cols, vals, (SEQ, SEQ), vector_size=8))


@pytest.mark.parametrize("impl", ["cuda", "cuda_balanced"])
def test_bf16_value_projection_step_matches_jax(impl):
    """One value-projection SGD step under a bf16 plan: the loss, dloss/dW
    and W after the step against the same step of JAX's kernels."""
    fmt, jfmt = _pattern()
    q, k, v = sat.make_inputs(SEQ, HEADS, DIM, precision="bf16")
    w0 = sat.initial_w(DIM)
    jplan = jax_ad_plan(jfmt, impl=JAX_IMPL[impl], precision="bf16")
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    target = jlayers.sparse_attention(jplan, jq, jk, jv, interpret=True)

    def loss_fn(w_):
        out = jlayers.sparse_attention(jplan, jq, jk, jv @ w_, interpret=True)
        return jnp.mean((out.astype(jnp.float32)
                         - target.astype(jnp.float32)) ** 2)

    want_loss, want_gw = jax.value_and_grad(loss_fn)(jnp.asarray(w0))
    plan = ad_plan(fmt, impl=impl, device="cpu", precision="bf16")
    t = sat.params_from_jax(device="cpu", q=q, k=k, v=v)
    run = sat.train_value_projection(plan, t["q"], t["k"], t["v"], impl,
                                     steps=1)
    assert run.first_grad.dtype == torch.float32
    np.testing.assert_allclose(run.losses[0], float(want_loss), rtol=1e-2)
    gw = np.asarray(want_gw)
    np.testing.assert_allclose(run.first_grad.numpy(), gw, rtol=5e-2,
                               atol=5e-2 * np.abs(gw).max())
    np.testing.assert_allclose(run.w.numpy(), w0 - 0.05 * gw, rtol=1e-3,
                               atol=1e-3 * np.abs(w0).max())
    assert run.final < run.losses[0]


def test_params_from_jax_keeps_bf16_leaves():
    x = np.asarray(jnp.asarray(np.linspace(-2, 2, 12, dtype=np.float32),
                               jnp.bfloat16))
    assert x.dtype.name == "bfloat16"
    t = sat.params_from_jax(device="cpu", q=x, w=np.ones(3, np.float32))
    assert t["q"].dtype == BF16 and t["w"].dtype == torch.float32
    np.testing.assert_array_equal(t["q"].float().numpy(),
                                  x.astype(np.float32))
    # make_inputs at bf16 rounds the fp32 draws half to even
    q32 = sat.make_inputs(24, 1, 8)[0]
    q16 = sat.make_inputs(24, 1, 8, precision="bf16")[0]
    np.testing.assert_array_equal(
        q16, np.asarray(jnp.asarray(q32, jnp.bfloat16), np.float32))


# --------------------------------------------------- the balanced GNN path ----


def _graph(n=48, deg=5, seed=9):
    rows, cols = jgraphs.erdos_renyi_graph(n, deg, seed=seed)
    loops = np.arange(n)
    rows, cols = np.concatenate([rows, loops]), np.concatenate([cols, loops])
    return rows, cols, jgraphs.gcn_normalized(rows, cols, n), n


MODES = {"gcn-bf16": ("gcn", torch.bfloat16, jnp.bfloat16, None),
         "agnn-bf16": ("agnn", torch.bfloat16, jnp.bfloat16, None),
         "gcn-int8": ("gcn", torch.float32, jnp.float32, "int8")}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_balanced_narrow_model_matches_jax_and_trains(mode):
    model, dtype, jdtype, precision = MODES[mode]
    kw = dict(model=model, in_dim=16, hidden_dim=16, num_classes=4,
              num_layers=2)
    rows, cols, vals, n = _graph()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    labels = rng.integers(0, 4, size=n)
    mask = (rng.random(n) < 0.7).astype(np.float32)
    jcfg = jgnn.GNNConfig(impl="pallas_balanced", interpret=True,
                          dtype=jdtype, **kw)
    params = (jgnn.init_gcn if model == "gcn" else jgnn.init_agnn)(
        jax.random.key(0), jcfg)
    jplan = jax_ad_plan(jcore.from_coo(rows, cols, vals, (n, n),
                                       dtype=jdtype),
                        impl="pallas_balanced", precision=precision)
    jx = jnp.asarray(x, jdtype)
    jfwd = jgnn.gcn_forward if model == "gcn" else jgnn.agnn_forward
    want_logits = np.asarray(jfwd(params, jplan, jx, jcfg), np.float32)
    mom = jax.tree.map(jnp.zeros_like, params)
    _, _, want_loss, _ = jax_train_step(jcfg, lr=0.05)(
        params, mom, jplan, jx, jnp.asarray(labels.astype(np.int32)),
        jnp.asarray(mask))

    cfg = gnn.GNNConfig(impl="cuda_balanced", dtype=dtype, **kw)
    net = gnn.params_from_jax(cfg, jax.tree.map(np.asarray, params),
                              device="cpu")
    plan = ad_plan(from_coo(rows, cols, vals, (n, n), dtype=dtype),
                   impl="cuda_balanced", device="cpu", precision=precision)
    tx = torch.from_numpy(x).to(dtype)
    with torch.no_grad():
        logits = net(plan, tx)
    np.testing.assert_allclose(_np(logits), want_logits, rtol=2e-2,
                               atol=2e-2 * np.abs(want_logits).max())
    step = gnn.make_train_step(cfg, net, lr=0.05)
    tl, tm = torch.from_numpy(labels), torch.from_numpy(mask)
    losses = [step(plan, tx, tl, tm)[0].item() for _ in range(3)]
    np.testing.assert_allclose(losses[0], float(want_loss), rtol=1e-2)
    assert all(np.isfinite(losses)) and losses[2] < losses[0], losses
    assert all(p.dtype == dtype for p in net.parameters())

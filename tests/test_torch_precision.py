"""Precision parity: the port's bf16 and int8 paths against the JAX
package's, the Pallas kernels in interpret mode.

  * quantization and the bf16 cast bitwise equal to the reference's (both
    round half to even), the saturating fixed-scale path and its
    ``int8_clip`` count included;
  * the kernels' plain versions at bf16 / int8 against the interpret-mode
    Pallas kernels: every entry within one bf16 ulp and at least 99% of
    the entries bitwise equal (both sides contract the same narrow inputs
    in fp32 and round once; a bf16 accumulator would fail the share);
  * the reference's tolerance ladder against each package's own fp32 run;
  * gradients of ``spmm_ad``/``sddmm_ad``/``attention_ad`` under bf16 and
    int8 plans against ``jax.grad`` of the same plans;
  * a 2-layer GCN and AGNN in bf16 and under an int8 plan against the
    reference's, and three steps of each with a falling loss;
  * the registry's precision gate, the attention's value bands, the
    window SpMM's 64-bit-index choice and the format metrics.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.core as jcore
import repro.sparse.graphs as jgraphs
from repro.core import dispatch as jdispatch
from repro.core import metrics as jmetrics
from repro.core import quantize as jquant
from repro.core.autodiff import ad_plan as jax_ad_plan
from repro.core.autodiff import attention_ad as jax_attention_ad
from repro.core.autodiff import sddmm_ad as jax_sddmm_ad
from repro.core.autodiff import spmm_ad as jax_spmm_ad
from repro.kernels import ops as jops
from repro.models import gnn as jgnn
from repro.train.train_step import make_gnn_train_step as jax_train_step
from repro_torch.core import (ad_plan, attention, attention_ad, block_format,
                              dispatch, from_coo, from_dense, sddmm,
                              sddmm_ad, spmm, spmm_ad)
from repro_torch.core import metrics, quantize
from repro_torch.kernels import (attention_cuda, attention_plain, ref,
                                 sddmm_cuda, spmm_cuda)
from repro_torch.kernels.attention_cuda import DV_BAND, value_bands
from repro_torch.kernels.spmm_cuda import wide_index
from repro_torch.models import gnn
from repro_torch.train import gnn_train
from _torch_threads import one_intraop_thread  # noqa: F401

BF16 = torch.bfloat16
# One bf16 ulp of an entry (2^-7 of it at most) plus a floor of 1e-6 of the
# output's largest entry, and the share of bitwise-equal entries.
ULP_RTOL, ULP_ATOL_OF_MAX, BITWISE_SHARE = 2.0 ** -7, 1e-6, 0.99


def _sparse(rng, m, k, density, empty=()):
    a = ((rng.random((m, k)) < density) * rng.standard_normal((m, k))
         ).astype(np.float32)
    a[list(empty)] = 0.0
    return a


# (label, M, K, density, empty rows, V, k_blk, N)
CASES = [("empty-windows-ragged-n", 48, 40, 0.3, range(8, 24), 8, 8, 19),
         ("v8-kblk4", 40, 56, 0.25, (), 8, 4, 32),
         ("v16", 50, 44, 0.25, (), 16, 8, 24)]


def _formats(case):
    _, m, k, density, empty, v, k_blk, _ = case
    a = _sparse(np.random.default_rng(m * k), m, k, density, empty)
    return (a, block_format(from_dense(a, vector_size=v), k_blk, device="cpu"),
            jcore.block_format(jcore.from_dense(a, vector_size=v), k_blk))


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
    return torch.from_numpy(x).to(BF16)


# --------------------------------------------------- quantize and cast ----


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_quantize_format_bitwise_equal_to_jax(case):
    _, port, jb = _formats(case)
    got = quantize.quantize_format(port)
    want = jquant.quantize_format(jb)
    assert got.vals.dtype == torch.int8 and got.scales.dtype == torch.float32
    np.testing.assert_array_equal(got.vals.numpy(), np.asarray(want.vals))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    np.testing.assert_array_equal(
        quantize.dequantize_block_values(got.vals, got.scales).numpy(),
        np.asarray(jquant.dequantize_block_values(want.vals, want.scales)))


@pytest.mark.parametrize("block", [7, 32])
def test_quantize_blocked_bitwise_with_halfway_values(block):
    """Entries at exact .5 multiples of the scale round half to even on
    both sides; the zero-padded tail quantizes to 0."""
    rng = np.random.default_rng(block)
    x = rng.standard_normal(101).astype(np.float32)
    x[:9] = np.float32(127.0) * np.array([1, 0.5, -0.5, 1.5, -2.5, 0.25,
                                          -0.75, 63.5, -126.5],
                                         np.float32) / 127.0
    q, s = quantize.quantize_blocked(torch.from_numpy(x), block)
    jq, js = jquant.quantize_blocked(jnp.asarray(x), block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        quantize.dequantize_blocked(q, s, (101,)).numpy(),
        np.asarray(jquant.dequantize_blocked(jq, js, (101,))))


@pytest.mark.parametrize("scale", ["scalar", "per-group"])
def test_fixed_scale_saturates_and_counts_clips_like_jax(scale):
    rng = np.random.default_rng(21)
    vals = rng.uniform(-300.0, 300.0, size=(64, 8)).astype(np.float32)
    sc = 1.0 if scale == "scalar" else rng.uniform(0.5, 2.0, 8).astype(
        np.float32)
    metrics.reset_counters("int8_clip")
    jmetrics.reset_counters("int8_clip")
    q, s = quantize.quantize_block_values(torch.from_numpy(vals), 8,
                                          scales=sc)
    jq, js = jquant.quantize_block_values(jnp.asarray(vals), 8, scales=sc)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.min() >= -127 and q.max() <= 127
    clips = metrics.counters()["int8_clip"]
    assert clips > 0 and clips == jmetrics.counters()["int8_clip"]


def test_cast_precision_to_bf16_bitwise_equal_to_jax():
    """Round half to even at the bf16 boundary, ties included."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(4096).astype(np.float32)
    ties = (1.0 + np.arange(1, 64) * 2.0 ** -8).astype(np.float32)
    x = np.concatenate([x, ties, -ties, [1e-40, 3e38, 0.0]]).astype(np.float32)
    (got,) = quantize.cast_precision("bf16", torch.from_numpy(x))
    (want,) = jquant.cast_precision("bf16", jnp.asarray(x))
    assert got.dtype == BF16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    assert quantize.cast_precision(None, torch.from_numpy(x))[0].dtype \
        == torch.float32
    with pytest.raises(ValueError, match="int8 applies to SpMM"):
        quantize.cast_precision("int8", torch.from_numpy(x))
    with pytest.raises(ValueError, match="unknown precision"):
        quantize.validate_precision("fp8")
    assert quantize.precision_dtype("int8") == BF16


def test_from_coo_bf16_values_bitwise_equal_to_jax():
    rng = np.random.default_rng(4)
    n = 60
    rows, cols = rng.integers(0, n, 400), rng.integers(0, n, 400)
    vals = rng.standard_normal(400)          # float64, duplicates summed
    got = from_coo(rows, cols, vals, (n, n), dtype=BF16)
    want = jcore.from_coo(rows, cols, vals, (n, n), dtype=jnp.bfloat16)
    assert got.values.dtype == BF16
    np.testing.assert_array_equal(got.values.float().numpy(),
                                  np.asarray(want.values, np.float32))
    np.testing.assert_array_equal(
        got.transpose().values.float().numpy(),
        np.asarray(want.transpose().values, np.float32))


# ------------------------------- plain operators vs the Pallas kernels ----


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_spmm_bf16_and_int8_plain_within_one_ulp_of_pallas(case):
    _, port, jb = _formats(case)
    b = np.random.default_rng(5).standard_normal(
        (port.shape[1], case[-1])).astype(np.float32)
    p16 = dataclasses.replace(port, vals=port.vals.to(BF16))
    want16 = jops.spmm(jb, jnp.asarray(b), interpret=True, precision="bf16")
    got16 = spmm_cuda(p16, _bf16(b))
    assert got16.dtype == BF16
    _assert_one_ulp(got16, want16, "spmm_cuda bf16")
    _assert_one_ulp(ref.spmm_ref(p16, _bf16(b)), want16, "spmm_ref bf16")
    want8 = jops.spmm(jb, jnp.asarray(b), interpret=True, precision="int8")
    q = quantize.quantize_format(port)
    got8 = spmm_cuda(q, _bf16(b))
    assert got8.dtype == BF16
    _assert_one_ulp(got8, want8, "spmm_cuda int8")
    _assert_one_ulp(ref.spmm_ref(q, _bf16(b)), want8, "spmm_ref int8")
    # int8 values against fp32 B give fp32: the kernels scale each value,
    # the reference each K-block's partial sum, fp32 apart
    want8f = np.asarray(jops.spmm(jquant.quantize_format(jb), jnp.asarray(b),
                                  interpret=True))
    got8f = spmm_cuda(q, torch.from_numpy(b))
    assert got8f.dtype == torch.float32
    np.testing.assert_allclose(got8f.numpy(), want8f, rtol=1e-5,
                               atol=1e-5 * np.abs(want8f).max())
    if case[0].startswith("empty"):
        assert not got8[8:24].any()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_sddmm_bf16_plain_within_one_ulp_of_pallas(case):
    _, port, jb = _formats(case)
    rng = np.random.default_rng(6)
    m, k = port.shape
    q = rng.standard_normal((m, 24)).astype(np.float32)
    kk = rng.standard_normal((k, 24)).astype(np.float32)
    want = jops.sddmm(jb, jnp.asarray(q), jnp.asarray(kk), interpret=True,
                      precision="bf16")
    got = sddmm_cuda(port, _bf16(q), _bf16(kk))
    assert got.dtype == BF16
    _assert_one_ulp(got, want, "sddmm_cuda bf16")
    _assert_one_ulp(ref.sddmm_ref(port, _bf16(q), _bf16(kk)), want,
                    "sddmm_ref bf16")


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_attention_bf16_plain_within_one_ulp_of_pallas(case):
    _, port, jb = _formats(case)
    rng = np.random.default_rng(7)
    m, k = port.shape
    q = rng.standard_normal((m, 16)).astype(np.float32)
    kk = rng.standard_normal((k, 16)).astype(np.float32)
    v = rng.standard_normal((k, 12)).astype(np.float32)
    want = jdispatch.dispatch("attention", "pallas_fused_attn", jb,
                              jnp.asarray(q), jnp.asarray(kk), jnp.asarray(v),
                              scale=0.7, interpret=True, precision="bf16")
    got = attention_cuda(port, _bf16(q), _bf16(kk), _bf16(v),
                         scale=torch.tensor(0.7))
    assert got.dtype == BF16
    _assert_one_ulp(got, want, "attention_cuda bf16")


# ------------------------------------------------ the reference's ladder ----


@pytest.mark.parametrize("impl", ["blocked", "cuda"])
def test_spmm_ladder_against_the_ports_fp32(impl):
    _, port, _ = _formats(CASES[0])
    b = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (port.shape[1], 19)).astype(np.float32))
    base = spmm(port, b, impl=impl)
    assert torch.equal(spmm(port, b, impl=impl, precision="fp32"), base)
    tol = dict(rtol=2e-2, atol=2e-2 * base.abs().max().item())
    for prec in ("bf16", "int8"):
        out = spmm(port, b, impl=impl, precision=prec)
        assert out.dtype == BF16
        np.testing.assert_allclose(_np(out), base.numpy(), **tol)
        assert not out[8:24].any()      # empty windows stay zero
    np.testing.assert_allclose(
        _np(spmm(quantize.quantize_format(port), b, impl=impl)), base.numpy(),
        **tol)


@pytest.mark.parametrize("impl", ["blocked", "cuda"])
def test_sddmm_and_attention_ladder_against_the_ports_fp32(impl):
    _, port, _ = _formats(CASES[1])
    rng = np.random.default_rng(9)
    m, k = port.shape
    q, kk = (torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))
             for n in (m, k))
    v = torch.from_numpy(rng.standard_normal((k, 16)).astype(np.float32))
    base = sddmm(port, q, kk, impl=impl)
    assert torch.equal(sddmm(port, q, kk, impl=impl, precision="fp32"), base)
    out = sddmm(port, q, kk, impl=impl, precision="bf16")
    assert out.dtype == BF16
    np.testing.assert_allclose(_np(out), base.numpy(), rtol=5e-2, atol=2e-1)
    with pytest.raises(ValueError, match="int8"):
        sddmm(port, q, kk, impl=impl, precision="int8")
    attn = "cuda_fused_attn" if impl == "cuda" else impl
    base = attention(port, q, kk, v, impl=attn)
    assert torch.equal(attention(port, q, kk, v, impl=attn,
                                 precision="fp32"), base)
    out = attention(port, q, kk, v, impl=attn, precision="bf16")
    assert out.dtype == BF16
    np.testing.assert_allclose(_np(out), base.numpy(), rtol=5e-2, atol=5e-2)


# ------------------------------------------------------------ gradients ----


def _grad_case():
    rng = np.random.default_rng(6)
    a = _sparse(rng, 40, 40, 0.2)
    return a, rng.standard_normal((40, 32)).astype(np.float32)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_spmm_and_sddmm_ad_grads_match_jax_under_narrow_plans(precision):
    a, b = _grad_case()
    rng = np.random.default_rng(10)
    q = rng.standard_normal((40, 8)).astype(np.float32)
    jplan = jax_ad_plan(jcore.from_dense(a), impl="pallas",
                        precision=precision)
    plan = ad_plan(from_dense(a), impl="cuda", device="cpu",
                   precision=precision)
    vals = np.asarray(jplan.vals)

    def jloss(vals_, bb, qq, kk):
        out = jax_spmm_ad(jplan, vals_, bb, interpret=True)
        s = jax_sddmm_ad(jplan, qq, kk, interpret=True)
        return (jnp.sum(out.astype(jnp.float32) ** 2)
                + jnp.sum(s.astype(jnp.float32) ** 2))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jnp.asarray(vals), jnp.asarray(b), jnp.asarray(q), jnp.asarray(q))
    t = [torch.tensor(x, requires_grad=True) for x in (vals, b, q, q)]
    out = spmm_ad(plan, t[0], t[1])
    s = sddmm_ad(plan, t[2], t[3])
    assert out.dtype == BF16 and s.dtype == BF16
    ((out.float() ** 2).sum() + (s.float() ** 2).sum()).backward()
    for name, got, ref_ in zip(("vals", "b", "q", "k"), t, want):
        assert got.grad.dtype == torch.float32, name
        atol = (0.08 if precision == "int8" else 0.05) * max(
            float(np.abs(np.asarray(ref_)).max()), 1.0)
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref_),
                                   rtol=8e-2, atol=atol, err_msg=name)


def test_attention_ad_grads_match_jax_under_bf16_and_int8_plans():
    a = _sparse(np.random.default_rng(7), 32, 32, 0.25)
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((32, 16)).astype(np.float32)
               for _ in range(3))
    for prec in ("bf16", "int8"):   # an int8 plan runs attention at bf16
        jplan = jax_ad_plan(jcore.from_dense(a), impl="pallas",
                            precision=prec)
        plan = ad_plan(from_dense(a), impl="cuda", device="cpu",
                       precision=prec)

        def jloss(q_, k_, v_, s_):
            return jnp.sum(jax_attention_ad(jplan, q_, k_, v_, scale=s_,
                                            interpret=True)
                           .astype(jnp.float32) ** 2)

        want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(0.8, jnp.float32))
        t = [torch.tensor(x, requires_grad=True)
             for x in (q, k, v, np.float32(0.8))]
        out = attention_ad(plan, t[0], t[1], t[2], scale=t[3])
        assert out.dtype == BF16
        (out.float() ** 2).sum().backward()
        for name, got, ref_ in zip(("q", "k", "v", "scale"), t, want):
            assert got.grad.dtype == torch.float32, name
            np.testing.assert_allclose(
                got.grad.numpy(), np.asarray(ref_), rtol=1e-1,
                atol=0.1 * max(float(np.abs(np.asarray(ref_)).max()), 1.0),
                err_msg=f"{prec} {name}")


# ------------------------------------------- the slice: GCN and AGNN ----


def _graph(n=56, deg=5, seed=7):
    rows, cols = jgraphs.erdos_renyi_graph(n, deg, seed=seed)
    loops = np.arange(n)
    rows, cols = np.concatenate([rows, loops]), np.concatenate([cols, loops])
    return rows, cols, jgraphs.gcn_normalized(rows, cols, n), n


def _task(n):
    rng = np.random.default_rng(3)
    return (rng.standard_normal((n, 16)).astype(np.float32),
            rng.integers(0, 4, size=n), (rng.random(n) < 0.7).astype(np.float32))


MODES = {"bf16": (torch.bfloat16, jnp.bfloat16, None),
         "int8": (torch.float32, jnp.float32, "int8")}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("model", ["gcn", "agnn"])
def test_two_layer_model_matches_jax_and_trains(model, mode):
    dtype, jdtype, precision = MODES[mode]
    kw = dict(model=model, in_dim=16, hidden_dim=16, num_classes=4,
              num_layers=2)
    rows, cols, vals, n = _graph()
    x, labels, mask = _task(n)
    jcfg = jgnn.GNNConfig(impl="blocked", dtype=jdtype, **kw)
    params = (jgnn.init_gcn if model == "gcn" else jgnn.init_agnn)(
        jax.random.key(0), jcfg)
    jplan = jax_ad_plan(jcore.from_coo(rows, cols, vals, (n, n),
                                       dtype=jdtype),
                        impl="blocked", precision=precision)
    jx = jnp.asarray(x, jdtype)
    jfwd = jgnn.gcn_forward if model == "gcn" else jgnn.agnn_forward
    want_logits = np.asarray(jfwd(params, jplan, jx, jcfg), np.float32)
    jstep = jax_train_step(jcfg, lr=0.05)
    mom = jax.tree.map(jnp.zeros_like, params)
    _, _, want_loss, _ = jstep(params, mom, jplan, jx,
                               jnp.asarray(labels.astype(np.int32)),
                               jnp.asarray(mask))

    cfg = gnn.GNNConfig(impl="cuda", dtype=dtype, **kw)
    net = gnn.params_from_jax(cfg, jax.tree.map(np.asarray, params),
                              device="cpu")
    plan = ad_plan(from_coo(rows, cols, vals, (n, n), dtype=dtype),
                   impl="cuda", device="cpu", precision=precision)
    tx = torch.from_numpy(x).to(dtype)
    with torch.no_grad():
        logits = net(plan, tx)
    assert logits.shape == (n, 4)
    np.testing.assert_allclose(_np(logits), want_logits, rtol=2e-2,
                               atol=2e-2 * np.abs(want_logits).max())
    step = gnn.make_train_step(cfg, net, lr=0.05)
    tl, tm = torch.from_numpy(labels), torch.from_numpy(mask)
    losses = [step(plan, tx, tl, tm)[0].item() for _ in range(3)]
    np.testing.assert_allclose(losses[0], float(want_loss), rtol=1e-2)
    assert all(np.isfinite(losses)) and losses[2] < losses[0], losses
    assert all(p.dtype == dtype for p in net.parameters())


def test_params_from_jax_takes_bf16_leaves():
    cfg = jgnn.GNNConfig(model="agnn", in_dim=8, hidden_dim=8, num_classes=3,
                         num_layers=2, dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray, jgnn.init_agnn(jax.random.key(1), cfg))
    assert params["w_in"].dtype.name == "bfloat16"
    net = gnn.params_from_jax(gnn.GNNConfig(
        model="agnn", in_dim=8, hidden_dim=8, num_classes=3, num_layers=2,
        dtype=BF16), params, device="cpu")
    np.testing.assert_array_equal(net.w_in.detach().float().numpy(),
                                  params["w_in"].astype(np.float32))


@pytest.mark.parametrize("flags", [["--dtype", "bf16"], ["--int8"]],
                         ids=["bf16", "int8"])
def test_gnn_train_smoke_cli_precisions(flags, capsys):
    gnn_train.main(["--steps", "3", "--impl", "cuda", "--device", "cpu",
                    *flags])
    assert "OK: finite decreasing loss" in capsys.readouterr().out


# ------------------------------------------------- registry and kernels ----


def test_dispatch_precision_gate_names_the_capable_impls():
    # the staged SpMM baseline has no int8 level, as the reference's;
    # every other SpMM impl takes the reference's narrow levels
    with pytest.raises(ValueError) as exc:
        dispatch.require("spmm", "cuda_staged", precision="int8")
    assert str(exc.value) == (
        "impl 'cuda_staged' of op 'spmm' does not support precision "
        "'int8' (supports: fp32, bf16); impls with 'int8': blocked, cuda, "
        "cuda_balanced, cuda_batched, cuda_noncoalesced, cuda_sharded, "
        "cuda_sharded_overlap, cuda_tuned")
    # the reference's text, up to the list of its own impls
    with pytest.raises(ValueError) as exc:
        dispatch.require("spmm", "coo_segment", precision="int8")
    with pytest.raises(ValueError) as jexc:
        jdispatch.require("spmm", "coo_segment", precision="int8")
    assert (str(exc.value).split("; impls with")[0]
            == str(jexc.value).split("; impls with")[0])
    for op, impl, want in (("spmm", "cuda_staged", ("fp32", "bf16")),
                           ("spmm", "cuda_noncoalesced",
                            ("fp32", "bf16", "int8")),
                           ("spmm", "cuda_batched", ("fp32", "bf16", "int8")),
                           ("spmm", "cuda_balanced", ("fp32", "bf16", "int8")),
                           ("sddmm", "cuda_balanced", ("fp32", "bf16")),
                           ("attention", "cuda_balanced", ("fp32", "bf16"))):
        assert dispatch.get(op, impl).precisions == want, (op, impl)
    assert dispatch.get("attention", "cuda_fused_attn").precisions == (
        "fp32", "bf16")
    with pytest.raises(ValueError, match="does not support precision 'int8'"):
        dispatch.require("sddmm", "cuda", precision="int8")
    with pytest.raises(ValueError, match="does not support precision"):
        ad_plan(from_dense(np.eye(16, dtype=np.float32)),
                impl="cuda_staged", device="cpu", precision="int8")
    # a plan on cuda_balanced now builds at every narrow level
    for prec in ("bf16", "int8"):
        plan = ad_plan(from_dense(np.eye(16, dtype=np.float32)),
                       impl="cuda_balanced", device="cpu", precision=prec)
        assert plan.precision == prec and plan.fwd_sched is not None
    _, port, _ = _formats(CASES[1])
    with pytest.raises(ValueError, match="does not support precision"):
        spmm(port, torch.ones(port.shape[1], 4), impl="coo_segment",
             precision="bf16")
    # the two baselines, fp32 only before, run their bf16 variants: their
    # plain versions, the window SpMM's function
    from repro_torch.kernels import (spmm_balanced_cuda, spmm_balanced_plain,
                                     spmm_noncoalesced_cuda, spmm_plain,
                                     spmm_staged_cuda)
    p16 = dataclasses.replace(port, vals=port.vals.to(BF16))
    b16 = _bf16(np.random.default_rng(14).standard_normal(
        (port.shape[1], 4)).astype(np.float32))
    for fn in (spmm_staged_cuda, spmm_noncoalesced_cuda):
        assert torch.equal(fn(p16, b16), spmm_plain(p16, b16))
    # the balanced SpMM, refused here before, runs its bf16 variant: its
    # plain version, within one bf16 ulp of the window SpMM's
    got = spmm_balanced_cuda(p16, b16)
    assert got.dtype == BF16
    sched = port.schedule(1)
    assert torch.equal(got, spmm_balanced_plain(p16, b16, sched))
    _assert_one_ulp(got, spmm_plain(p16, b16), "spmm_balanced_cuda bf16")


def test_wrappers_take_only_their_variants():
    _, port, _ = _formats(CASES[1])
    k = port.shape[1]
    with pytest.raises(TypeError, match="variants"):   # mixed bf16 / fp32
        spmm_cuda(dataclasses.replace(port, vals=port.vals.to(BF16)),
                  torch.ones(k, 4))
    with pytest.raises(TypeError, match="scales"):
        spmm_cuda(dataclasses.replace(port, vals=port.vals.to(torch.int8)),
                  torch.ones(k, 4))
    with pytest.raises(TypeError, match="variants"):
        sddmm_cuda(port, torch.ones(port.shape[0], 3, dtype=BF16),
                   torch.ones(k, 3))
    # int8 values over heads must be shared (2-D), as the reference says
    from repro_torch.kernels import spmm_balanced_cuda, spmm_batched_cuda
    q8 = quantize.quantize_format(port)
    q8h = dataclasses.replace(q8, vals=torch.stack([q8.vals, q8.vals]))
    for fn in (spmm_batched_cuda, spmm_balanced_cuda):
        with pytest.raises(ValueError, match="shared by every head"):
            fn(q8h, torch.ones(2, k, 4, dtype=BF16))
    # the fused attention takes bf16 over heads (refused here before): the
    # same function as one-head launches, within one bf16 ulp
    rng = np.random.default_rng(15)
    q, kk, v = (_bf16(rng.standard_normal((2, n, 4)).astype(np.float32))
                for n in (port.shape[0], k, k))
    got = attention_cuda(port, q, kk, v)
    assert got.dtype == BF16 and got.shape == (2, port.shape[0], 4)
    for h in range(2):
        _assert_one_ulp(got[h], attention_cuda(port, q[h], kk[h], v[h]),
                        f"attention_cuda bf16 head {h}")


def test_attention_value_bands_cover_dv_and_split_exactly():
    assert value_bands(32) == [(0, 32)]
    assert value_bands(DV_BAND) == [(0, DV_BAND)]
    assert value_bands(129) == [(0, 128), (128, 1)]
    assert value_bands(256) == [(0, 128), (128, 128)]
    # each output column depends on its own value column only: the bands'
    # outputs side by side are the whole output (up to the order of the
    # plain version's fp32 sums, which its BLAS picks by width)
    _, port, _ = _formats(CASES[1])
    rng = np.random.default_rng(12)
    m, k = port.shape
    q, kk = (torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32))
             for n in (m, k))
    v = torch.from_numpy(rng.standard_normal((k, 129)).astype(np.float32))
    whole = attention_plain(port, q, kk, v, 0.5)
    bands = torch.cat([attention_plain(port, q, kk, v[:, c:c + w], 0.5)
                       for c, w in value_bands(129)], dim=1)
    torch.testing.assert_close(bands, whole, rtol=1e-6, atol=1e-6)
    assert torch.equal(attention_cuda(port, q, kk, v, scale=0.5), whole)


def test_window_spmm_takes_64_bit_indices_only_at_2_31():
    assert not wide_index(403394 * 128, 3_440_000 * 8)   # Amazon, N = 128
    assert not wide_index(2**31 - 1, 5)
    assert wide_index(2**31, 5)                           # B of K·N = 2^31
    assert wide_index(5, (2**28) * 8)                     # NNZP·V = 2^31
    assert wide_index(2**20 * 2049, 8)


def test_format_metrics_equal_jax():
    from repro.data.datasets import load_vendored
    s = load_vendored(["hub_128"])[0]
    for v in (8, 16):
        port = from_coo(s.rows, s.cols, s.vals, s.shape, vector_size=v)
        want = jcore.from_coo(s.rows, s.cols, s.vals, s.shape, vector_size=v)
        for n_cols in (32, 100):
            assert metrics.summarize(port, n_cols) == jmetrics.summarize(
                want, n_cols)
            assert metrics.data_access_bytes(port, n_cols, value_bytes=4) \
                == jmetrics.data_access_bytes(want, n_cols, value_bytes=4)
            assert metrics.mma_count(port, n_cols, "tf32") \
                == jmetrics.mma_count(want, n_cols, "tf32")


def test_fp32_level_casts_for_fp32_only_impls():
    """Precision "fp32" is a plain cast of the operands, on the entry
    points and through a plan (here on cuda_balanced, fp32-only until its
    narrow variants were ported)."""
    _, port, _ = _formats(CASES[1])
    rng = np.random.default_rng(13)
    m, k = port.shape
    q16, k16 = (_bf16(rng.standard_normal((n, 8)).astype(np.float32))
                for n in (m, k))
    got = sddmm(port, q16, k16, impl="cuda_balanced", precision="fp32")
    assert got.dtype == torch.float32
    assert torch.equal(got, sddmm(port, q16.float(), k16.float(),
                                  impl="cuda_balanced"))
    b16 = _bf16(rng.standard_normal((k, 6)).astype(np.float32))
    fmt = from_dense(_formats(CASES[1])[0])
    plan = ad_plan(fmt, impl="cuda_balanced", device="cpu", precision="fp32")
    base = ad_plan(fmt, impl="cuda_balanced", device="cpu")
    assert plan.fwd is base.fwd          # one pattern, shared arrays
    out = spmm_ad(plan, plan.vals, b16)
    assert out.dtype == torch.float32
    assert torch.equal(out, spmm_ad(base, base.vals, b16.float()))

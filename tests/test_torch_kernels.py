"""Kernel parity: the port's ``cuda`` wrappers on CPU tensors (their plain
PyTorch versions) against the JAX package's Pallas kernels, which run in
interpret mode here, plus the registry, oracles and wrapper checks."""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import repro.core as jcore
from repro.core.softmax import sparse_softmax as jax_sparse_softmax
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import attention, dispatch, sddmm, spmm
from repro_torch.core.format import block_format, from_dense
from repro_torch.core.softmax import sparse_softmax
from repro_torch.kernels import (attention_cuda, ref, sddmm_cuda, spmm_cuda)
from _torch_threads import one_intraop_thread  # noqa: F401

# fp32 on both sides; the sums are taken in another order.
RTOL, ATOL = 1e-5, 1e-5


def _rand(rng, m, k, density):
    keep = rng.random((m, k)) < density
    return (keep * rng.standard_normal((m, k))).astype(np.float32)


def _case(name):
    """(dense matrix, V, k_blk, N) of one named edge case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "empty-windows":
        a = _rand(rng, 48, 40, 0.2)
        a[8:24] = 0.0
        return a, 8, 8, 20
    if name == "m-not-multiple-of-8":
        return _rand(rng, 29, 31, 0.2), 8, 8, 12
    if name == "k_blk-4":
        return _rand(rng, 32, 32, 0.25), 8, 4, 9
    if name == "k_blk-16-long-windows":
        return _rand(rng, 24, 96, 0.4), 8, 16, 16
    if name == "v16":
        return _rand(rng, 40, 36, 0.2), 16, 8, 10
    if name == "all-empty":
        return np.zeros((20, 17), np.float32), 8, 8, 6
    raise KeyError(name)


CASES = ["empty-windows", "m-not-multiple-of-8", "k_blk-4",
         "k_blk-16-long-windows", "v16", "all-empty"]


def _formats(a, v, k_blk):
    port = block_format(from_dense(a, vector_size=v), k_blk, device="cpu")
    jax_blocked = jcore.block_format(jcore.from_dense(a, vector_size=v), k_blk)
    return port, jax_blocked


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("name", CASES)
def test_spmm_cuda_matches_pallas(name):
    a, v, k_blk, n = _case(name)
    port, jb = _formats(a, v, k_blk)
    b = _np(np.random.default_rng(1), a.shape[1], n)
    out = spmm_cuda(port, torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(jops.spmm(jb, jnp.asarray(b))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), a @ b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", CASES)
def test_sddmm_cuda_matches_pallas(name):
    a, v, k_blk, _ = _case(name)
    port, jb = _formats(a, v, k_blk)
    rng = np.random.default_rng(2)
    q, k = _np(rng, a.shape[0], 12), _np(rng, a.shape[1], 12)
    out = sddmm_cuda(port, torch.from_numpy(q), torch.from_numpy(k))
    want = jops.sddmm(jb, jnp.asarray(q), jnp.asarray(k))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", CASES)
def test_attention_cuda_matches_pallas(name):
    a, v, k_blk, _ = _case(name)
    port, jb = _formats(a, v, k_blk)
    rng = np.random.default_rng(3)
    q, k, vv = (_np(rng, a.shape[0], 12), _np(rng, a.shape[1], 12),
                _np(rng, a.shape[1], 7))
    for scale in (None, 0.7):
        out = attention_cuda(port, torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(vv), scale=scale)
        want = jops.attention(jb, jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(vv), scale=scale)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("impl", ["blocked", "cuda", "coo_segment"])
def test_spmm_registry_impls_match_dense(impl):
    a, _, _, n = _case("empty-windows")
    b = _np(np.random.default_rng(4), a.shape[1], n)
    fmt = from_dense(a)
    with dispatch.record_calls() as log:
        out = spmm(fmt, torch.from_numpy(b), impl=impl)
    assert log == [("spmm", impl)]
    np.testing.assert_allclose(out.numpy(), a @ b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["blocked", "cuda"])
def test_sddmm_registry_impls_match_blocked_jax(impl):
    a, _, _, _ = _case("m-not-multiple-of-8")
    rng = np.random.default_rng(5)
    q, k = _np(rng, a.shape[0], 6), _np(rng, a.shape[1], 6)
    out = sddmm(from_dense(a), torch.from_numpy(q), torch.from_numpy(k),
                impl=impl)
    want = jcore.sddmm(jcore.from_dense(a), jnp.asarray(q), jnp.asarray(k))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_sddmm_coo_matches_jax():
    a, _, _, _ = _case("k_blk-4")
    rng = np.random.default_rng(6)
    q, k = _np(rng, a.shape[0], 5), _np(rng, a.shape[1], 5)
    out = sddmm(from_dense(a), torch.from_numpy(q), torch.from_numpy(k),
                impl="coo")
    want = jcore.sddmm(jcore.from_dense(a), jnp.asarray(q), jnp.asarray(k),
                       impl="coo")
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("impl", ["blocked", "cuda_fused_attn"])
def test_attention_registry_impls_match_jax_blocked(impl):
    a, _, _, _ = _case("v16")
    rng = np.random.default_rng(7)
    q, k, v = _np(rng, a.shape[0], 8), _np(rng, a.shape[1], 8), _np(rng, a.shape[1], 5)
    out = attention(from_dense(a), torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), impl=impl, scale=torch.tensor(1.3))
    want = jcore.attention(jcore.from_dense(a), jnp.asarray(q), jnp.asarray(k),
                           jnp.asarray(v), scale=1.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", CASES)
def test_oracles_match_jax(name):
    a, v, k_blk, n = _case(name)
    port, jb = _formats(a, v, k_blk)
    rng = np.random.default_rng(8)
    b, q, k = _np(rng, a.shape[1], n), _np(rng, a.shape[0], 4), _np(rng, a.shape[1], 4)
    np.testing.assert_allclose(ref.spmm_ref(port, torch.from_numpy(b)).numpy(),
                               np.asarray(jref.spmm_ref(jb, jnp.asarray(b))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        ref.sddmm_ref(port, torch.from_numpy(q), torch.from_numpy(k)).numpy(),
        np.asarray(jref.sddmm_ref(jb, jnp.asarray(q), jnp.asarray(k))),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", CASES)
def test_sparse_softmax_matches_jax(name):
    a, v, k_blk, _ = _case(name)
    port, jb = _formats(a, v, k_blk)
    scores = _np(np.random.default_rng(9), *port.vals.shape) * 3.0
    out = sparse_softmax(port, torch.from_numpy(scores))
    want = jax_sparse_softmax(jb, jnp.asarray(scores))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-7)


def test_registry_lists_the_ported_impls():
    assert dispatch.impls("spmm") == ("blocked", "coo_segment", "cuda",
                                      "cuda_balanced", "cuda_batched",
                                      "cuda_noncoalesced", "cuda_sharded",
                                      "cuda_sharded_overlap", "cuda_staged",
                                      "cuda_tuned")
    assert dispatch.impls("sddmm") == ("blocked", "coo", "cuda",
                                       "cuda_balanced", "cuda_batched",
                                       "cuda_sharded", "cuda_sharded_overlap",
                                       "cuda_tuned")
    assert dispatch.impls("attention") == ("blocked", "cuda_balanced",
                                           "cuda_fused_attn",
                                           "cuda_fused_attn_tuned",
                                           "cuda_sharded",
                                           "cuda_sharded_overlap",
                                           "cuda_staged")
    with pytest.raises(ValueError, match="available"):
        dispatch.get("spmm", "pallas")


def test_wrappers_on_cpu_run_the_plain_version_and_count_nothing():
    a, v, k_blk, n = _case("k_blk-4")
    port, _ = _formats(a, v, k_blk)
    before = (spmm_cuda.launches, sddmm_cuda.launches, attention_cuda.launches)
    x = torch.ones(a.shape[1], n)
    spmm_cuda(port, x)
    sddmm_cuda(port, torch.ones(a.shape[0], 3), torch.ones(a.shape[1], 3))
    attention_cuda(port, torch.ones(a.shape[0], 3), torch.ones(a.shape[1], 3),
                   torch.ones(a.shape[1], 2))
    assert (spmm_cuda.launches, sddmm_cuda.launches,
            attention_cuda.launches) == before


def test_wrappers_refuse_other_dtypes_and_grad():
    a, v, k_blk, n = _case("k_blk-4")
    port, _ = _formats(a, v, k_blk)
    with pytest.raises(TypeError, match="float32"):
        spmm_cuda(port, torch.ones(a.shape[1], n, dtype=torch.float64))
    with pytest.raises(TypeError, match="float32"):
        sddmm_cuda(port, torch.ones(a.shape[0], 3, dtype=torch.float16),
                   torch.ones(a.shape[1], 3, dtype=torch.float16))
    with pytest.raises(RuntimeError, match="forward-only"):
        spmm_cuda(port, torch.ones(a.shape[1], n, requires_grad=True))
    beta = torch.ones((), requires_grad=True)
    q = torch.ones(a.shape[0], 3)
    with pytest.raises(RuntimeError, match="forward-only"):
        attention_cuda(port, q, torch.ones(a.shape[1], 3),
                       torch.ones(a.shape[1], 2), scale=beta)
    with torch.inference_mode():
        out = attention_cuda(port, q, torch.ones(a.shape[1], 3),
                             torch.ones(a.shape[1], 2), scale=beta)
    assert out.shape == (a.shape[0], 2)


def test_default_attention_scale_is_inverse_sqrt_feature_dim():
    a, v, k_blk, _ = _case("empty-windows")
    port, _ = _formats(a, v, k_blk)
    rng = np.random.default_rng(10)
    q, k, vv = (torch.from_numpy(_np(rng, a.shape[0], 9)),
                torch.from_numpy(_np(rng, a.shape[1], 9)),
                torch.from_numpy(_np(rng, a.shape[1], 4)))
    torch.testing.assert_close(attention_cuda(port, q, k, vv),
                               attention_cuda(port, q, k, vv,
                                              scale=1.0 / math.sqrt(9)))

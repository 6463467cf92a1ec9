"""Balanced-kernel parity: the port's ``cuda_balanced`` wrappers on CPU
tensors (their plain PyTorch versions) against the JAX package's
``spmm_pallas_balanced``, ``sddmm_pallas_balanced`` and
``attention_pallas_balanced`` in interpret mode, one and two heads, with
shared and per-head operands, over split schedules; and the plain
versions of the run-carried SpMM and attention against dense oracles over
run plans that cut windows."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import repro.core as jcore
from repro.core.sddmm import with_values as jax_with_values
from repro.data.datasets import load_vendored
from repro.kernels.attention_pallas import attention_pallas_balanced
from repro.kernels.sddmm_pallas import sddmm_pallas_balanced
from repro.kernels.spmm_pallas import spmm_pallas_balanced
from repro_torch.core import attention, dispatch, sddmm, spmm
from repro_torch.core.format import block_format, from_dense
from repro_torch.core.sddmm import with_values
from repro_torch.kernels import (attention_balanced_cuda,
                                 attention_balanced_plain, sddmm_balanced_cuda,
                                 spmm_balanced_cuda, spmm_balanced_plain)
from repro_torch.kernels.attention_balanced_cuda import RUN_BLK as ATTN_RUN
from repro_torch.kernels.spmm_balanced_cuda import RUN_BLK as SPMM_RUN
from _torch_threads import one_intraop_thread  # noqa: F401

# fp32 on both sides; the sums are taken in another order.
RTOL, ATOL = 1e-5, 1e-5


def _matrix(empty=False):
    if empty:
        return np.zeros((20, 17), np.float32)
    rng = np.random.default_rng(21)
    a = ((rng.random((40, 36)) < 0.3) * rng.standard_normal((40, 36))
         ).astype(np.float32)
    a[8:16] = 0.0                                   # an empty window
    return a


def _formats(a):
    return (block_format(from_dense(a), 4, device="cpu"),
            jcore.block_format(jcore.from_dense(a), 4))


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# (heads, split_blk): two heads run per-head and shared operands together
CASES = [(1, 1), (1, 3), (2, 1), (2, 3)]


@pytest.mark.parametrize("h, split", CASES)
def test_spmm_balanced_matches_pallas(h, split):
    port, jb = _formats(_matrix())
    rng = np.random.default_rng(h * 10 + split)
    hs = (h,) if h > 1 else ()
    b = _np(rng, *hs, 36, 10)
    vals = _np(rng, *hs, *port.vals.shape) * port.mask.numpy()
    out = spmm_balanced_cuda(with_values(port, torch.from_numpy(vals)),
                             torch.from_numpy(b), split_blk=split)
    want = spmm_pallas_balanced(jax_with_values(jb, jnp.asarray(vals)),
                                jnp.asarray(b), split_blk=split)
    assert out.shape == (*hs, 40, 10)
    _close(out, want)


@pytest.mark.parametrize("h, split", CASES)
def test_sddmm_balanced_matches_pallas(h, split):
    port, jb = _formats(_matrix())
    rng = np.random.default_rng(h * 20 + split)
    hs = (h,) if h > 1 else ()
    q, k = _np(rng, *hs, 40, 6), _np(rng, 36, 6)   # K shared by the heads
    out = sddmm_balanced_cuda(port, torch.from_numpy(q), torch.from_numpy(k),
                              split_blk=split)
    _close(out, sddmm_pallas_balanced(jb, jnp.asarray(q), jnp.asarray(k),
                                      split_blk=split))


@pytest.mark.parametrize("h, split", CASES)
def test_attention_balanced_matches_pallas(h, split):
    port, jb = _formats(_matrix())
    rng = np.random.default_rng(h * 30 + split)
    hs = (h,) if h > 1 else ()
    q, k, v = _np(rng, *hs, 40, 6), _np(rng, 36, 6), _np(rng, *hs, 36, 5)
    out = attention_balanced_cuda(port, torch.from_numpy(q),
                                  torch.from_numpy(k), torch.from_numpy(v),
                                  scale=torch.tensor(0.7), split_blk=split)
    _close(out, attention_pallas_balanced(jb, jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), scale=0.7,
                                          split_blk=split))


def test_all_empty_matrix_gives_zeros():
    port, jb = _formats(_matrix(empty=True))
    rng = np.random.default_rng(5)
    b, q, k, v = (_np(rng, 17, 4), _np(rng, 20, 3), _np(rng, 17, 3),
                  _np(rng, 17, 2))
    tb, tq, tk, tv = map(torch.from_numpy, (b, q, k, v))
    _close(spmm_balanced_cuda(port, tb), spmm_pallas_balanced(jb, jnp.asarray(b)))
    _close(sddmm_balanced_cuda(port, tq, tk),
           sddmm_pallas_balanced(jb, jnp.asarray(q), jnp.asarray(k)))
    out = attention_balanced_cuda(port, tq, tk, tv)
    _close(out, attention_pallas_balanced(jb, jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v)))
    assert not out.abs().any()


def test_registry_routes_balanced_kwargs_and_counts_nothing_on_cpu():
    a = _matrix()
    port, _ = _formats(a)
    sched = port.schedule(2)
    rng = np.random.default_rng(6)
    b, q, k, v = (torch.from_numpy(_np(rng, 36, 8)),
                  torch.from_numpy(_np(rng, 40, 4)),
                  torch.from_numpy(_np(rng, 36, 4)),
                  torch.from_numpy(_np(rng, 36, 3)))
    before = (spmm_balanced_cuda.launches, sddmm_balanced_cuda.launches,
              attention_balanced_cuda.launches)
    with dispatch.record_calls() as log:
        c = spmm(port, b, impl="cuda_balanced", schedule=sched)
        s = sddmm(from_dense(a), q, k, impl="cuda_balanced", k_blk=4,
                  split_blk=3)
        o = attention(port, q, k, v, impl="cuda_balanced", split_blk=1)
    assert log == [("spmm", "cuda_balanced"), ("sddmm", "cuda_balanced"),
                   ("attention", "cuda_balanced")]
    np.testing.assert_allclose(c.numpy(), a @ b.numpy(), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, sddmm(port, q, k), rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(o, attention(port, q, k, v), rtol=RTOL,
                               atol=ATOL)
    assert (spmm_balanced_cuda.launches, sddmm_balanced_cuda.launches,
            attention_balanced_cuda.launches) == before


# A hub matrix, a banded one, a rectangular one, and one whose first
# window (150 vectors, 38 K-blocks at k_blk = 4) is longer than any run.
ORACLE_MATRICES = ["hub_128", "skewband_64", "rect_120x40", "long_window"]


def _oracle_matrix(name):
    if name != "long_window":
        return load_vendored([name])[0].dense().astype(np.float32)
    rng = np.random.default_rng(3)
    a = ((rng.random((48, 160)) < 0.1) * rng.standard_normal((48, 160))
         ).astype(np.float32)
    a[:8, :150] = 1.0
    a[16:24] = 0.0
    return a


@pytest.mark.parametrize("split", [0, 1, 3])
@pytest.mark.parametrize("name", ORACLE_MATRICES)
def test_spmm_balanced_plain_matches_dense(name, split):
    a = _oracle_matrix(name)
    port = block_format(from_dense(a), 4, device="cpu")
    rng = np.random.default_rng(split)
    b = _np(rng, a.shape[1], 7)
    want = a.astype(np.float64) @ b.astype(np.float64)
    for run_blk in (2, SPMM_RUN):    # runs that cut windows, the kernel's
        out = spmm_balanced_plain(port, torch.from_numpy(b),
                                  port.schedule(split), run_blk)
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("split", [0, 1, 3])
@pytest.mark.parametrize("name", ORACLE_MATRICES)
def test_attention_balanced_plain_matches_dense(name, split):
    a = _oracle_matrix(name)
    port = block_format(from_dense(a), 4, device="cpu")
    rng = np.random.default_rng(10 + split)
    (m, mc), scale = a.shape, 0.6
    q, k, v = _np(rng, m, 5), _np(rng, mc, 5), _np(rng, mc, 3)
    s = scale * q.astype(np.float64) @ k.astype(np.float64).T
    s = np.where(a != 0, s, -np.inf)
    top = s.max(axis=1, keepdims=True)
    p = np.where(a != 0, np.exp(s - np.where(np.isfinite(top), top, 0.0)),
                 0.0)
    want = (p @ v.astype(np.float64)) / np.maximum(p.sum(1, keepdims=True),
                                                   1e-300)
    for run_blk in (2, ATTN_RUN):
        out = attention_balanced_plain(port, *map(torch.from_numpy, (q, k, v)),
                                       port.schedule(split), scale, run_blk)
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)

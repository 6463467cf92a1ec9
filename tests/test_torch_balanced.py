"""Balanced-kernel parity: the port's ``cuda_balanced`` wrappers on CPU
tensors (their plain PyTorch versions) against the JAX package's
``spmm_pallas_balanced``, ``sddmm_pallas_balanced`` and
``attention_pallas_balanced`` in interpret mode, one and two heads, with
shared and per-head operands, over split schedules."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import repro.core as jcore
from repro.core.sddmm import with_values as jax_with_values
from repro.kernels.attention_pallas import attention_pallas_balanced
from repro.kernels.sddmm_pallas import sddmm_pallas_balanced
from repro.kernels.spmm_pallas import spmm_pallas_balanced
from repro_torch.core import attention, dispatch, sddmm, spmm
from repro_torch.core.format import block_format, from_dense
from repro_torch.core.sddmm import with_values
from repro_torch.kernels import (attention_balanced_cuda, sddmm_balanced_cuda,
                                 spmm_balanced_cuda)

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

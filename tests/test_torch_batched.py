"""Head-grid and baseline SpMM/SDDMM parity: the port's ``cuda_batched``,
``cuda_staged`` and ``cuda_noncoalesced`` wrappers on CPU tensors (their
plain PyTorch versions) against the JAX package's ``spmm_pallas_batched``,
``sddmm_pallas_batched``, ``spmm_pallas_staged`` and
``spmm_pallas_noncoalesced`` in interpret mode; the sparse softmax and the
oracles over a head dimension; and the ``batched`` capability flag."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import repro.core as jcore
from repro.core import dispatch as jdispatch
from repro.core.sddmm import with_values as jax_with_values
from repro.core.softmax import sparse_softmax as jax_sparse_softmax
from repro.kernels.sddmm_pallas import sddmm_pallas_batched
from repro.kernels.spmm_pallas import (spmm_pallas_batched,
                                       spmm_pallas_noncoalesced,
                                       spmm_pallas_staged)
from repro_torch.core import dispatch, sddmm, spmm
from repro_torch.core.format import block_format, from_dense
from repro_torch.core.sddmm import with_values
from repro_torch.core.softmax import sparse_softmax
from repro_torch.kernels import (ref, sddmm_batched_cuda, sddmm_cuda,
                                 spmm_batched_cuda, spmm_cuda,
                                 spmm_noncoalesced_cuda, spmm_staged_cuda)
from repro_torch.kernels.spmm_staged_cuda import zero_unvisited

# fp32 on both sides; the sums are taken in another order.
RTOL, ATOL = 1e-5, 1e-5


def _matrix(empty=False):
    """40 x 36 with an empty window (rows 8-15), or the all-empty matrix."""
    if empty:
        return np.zeros((20, 17), np.float32)
    rng = np.random.default_rng(31)
    a = ((rng.random((40, 36)) < 0.3) * rng.standard_normal((40, 36))
         ).astype(np.float32)
    a[8:16] = 0.0
    return a


def _formats(a):
    return (block_format(from_dense(a), 4, device="cpu"),
            jcore.block_format(jcore.from_dense(a), 4))


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# (heads, which operands carry the head dimension)
MIXES = [(h, mix) for h in (1, 4) for mix in ("first", "second", "both")]


def _heads(h, mix, which):
    return (h,) if mix in (which, "both") else ()


@pytest.mark.parametrize("h, mix", MIXES)
def test_spmm_batched_matches_pallas(h, mix):
    port, jb = _formats(_matrix())
    rng = np.random.default_rng(h * 7 + len(mix))
    vals = _np(rng, *_heads(h, mix, "first"), *port.vals.shape) * \
        port.mask.numpy()
    b = _np(rng, *_heads(h, mix, "second"), 36, 10)
    out = spmm_batched_cuda(with_values(port, torch.from_numpy(vals)),
                            torch.from_numpy(b))
    assert out.shape == (h, 40, 10)
    _close(out, spmm_pallas_batched(jax_with_values(jb, jnp.asarray(vals)),
                                    jnp.asarray(b)))


@pytest.mark.parametrize("h, mix", MIXES)
def test_sddmm_batched_matches_pallas(h, mix):
    port, jb = _formats(_matrix())
    rng = np.random.default_rng(h * 9 + len(mix))
    q = _np(rng, *_heads(h, mix, "first"), 40, 6)
    k = _np(rng, *_heads(h, mix, "second"), 36, 6)
    out = sddmm_batched_cuda(port, torch.from_numpy(q), torch.from_numpy(k))
    assert out.shape == (h, *port.vals.shape)
    _close(out, sddmm_pallas_batched(jb, jnp.asarray(q), jnp.asarray(k)))


def test_batched_wrappers_with_two_d_operands_are_the_single_head_kernels():
    port, _ = _formats(_matrix())
    rng = np.random.default_rng(3)
    b, q, k = (torch.from_numpy(_np(rng, *s)) for s in ((36, 5), (40, 6),
                                                        (36, 6)))
    torch.testing.assert_close(spmm_batched_cuda(port, b), spmm_cuda(port, b),
                               rtol=0, atol=0)
    torch.testing.assert_close(sddmm_batched_cuda(port, q, k),
                               sddmm_cuda(port, q, k), rtol=0, atol=0)


@pytest.mark.parametrize("empty", [False, True])
@pytest.mark.parametrize("impl, reference", [
    ("cuda_noncoalesced", spmm_pallas_noncoalesced),
    ("cuda_staged", spmm_pallas_staged)])
def test_spmm_baselines_match_pallas(impl, reference, empty):
    a = _matrix(empty)
    port, jb = _formats(a)
    b = _np(np.random.default_rng(5), a.shape[1], 7)
    out = spmm(port, torch.from_numpy(b), impl=impl)
    assert out.shape == (a.shape[0], 7)
    _close(out, reference(jb, jnp.asarray(b)))
    np.testing.assert_allclose(out.numpy(), a @ b, rtol=1e-4, atol=1e-5)


def test_zero_unvisited_clears_only_windows_without_a_block():
    port, _ = _formats(_matrix())
    out = zero_unvisited(torch.full((40, 3), float("nan")), port)
    assert torch.equal(torch.isnan(out).any(dim=1),
                       torch.tensor([r not in range(8, 16) for r in range(40)]))
    assert not out[8:16].any()


def test_spmm_baselines_take_two_d_operands_only():
    port, _ = _formats(_matrix())
    with pytest.raises(ValueError, match="b \\(36, N\\)"):
        spmm_noncoalesced_cuda(port, torch.ones(2, 36, 3))
    with pytest.raises(ValueError, match="b \\(36, N\\)"):
        spmm_staged_cuda(port, torch.ones(2, 36, 3))


@pytest.mark.parametrize("empty", [False, True])
def test_sparse_softmax_over_heads_matches_jax(empty):
    port, jb = _formats(_matrix(empty))
    s = _np(np.random.default_rng(8), 3, *port.vals.shape) * 4.0
    got = sparse_softmax(port, torch.from_numpy(s))
    _close(got, jax_sparse_softmax(jb, jnp.asarray(s)))
    for h in range(3):   # each head is the 2-D softmax of its scores
        torch.testing.assert_close(
            got[h], sparse_softmax(port, torch.from_numpy(s[h])), rtol=0,
            atol=0)


@pytest.mark.parametrize("mix", ["first", "second", "both"])
def test_blocked_and_oracles_over_heads_match_the_per_head_loop(mix):
    port, _ = _formats(_matrix())
    rng = np.random.default_rng(11)
    h = 3
    vals = torch.from_numpy(_np(rng, *_heads(h, mix, "first"),
                                *port.vals.shape)) * port.mask
    b = torch.from_numpy(_np(rng, *_heads(h, mix, "second"), 36, 4))
    q = torch.from_numpy(_np(rng, *_heads(h, mix, "first"), 40, 5))
    k = torch.from_numpy(_np(rng, *_heads(h, mix, "second"), 36, 5))
    pv = with_values(port, vals)

    def head(t, i):
        return t[i] if t.dim() == 3 else t

    got = {"spmm": spmm(pv, b), "spmm_ref": ref.spmm_ref(pv, b),
           "sddmm": sddmm(port, q, k), "sddmm_ref": ref.sddmm_ref(port, q, k)}
    for i in range(h):
        pvi = with_values(port, head(vals, i))
        want_c = ref.spmm_ref(pvi, head(b, i))
        want_s = ref.sddmm_ref(port, head(q, i), head(k, i))
        for name in ("spmm", "spmm_ref"):
            torch.testing.assert_close(got[name][i], want_c, rtol=RTOL,
                                       atol=ATOL)
        for name in ("sddmm", "sddmm_ref"):
            torch.testing.assert_close(got[name][i], want_s, rtol=RTOL,
                                       atol=ATOL)


def test_batched_flag_matches_the_reference_registry():
    pairs = {("spmm", "blocked"): "blocked", ("sddmm", "blocked"): "blocked",
             ("attention", "blocked"): "blocked",
             ("spmm", "cuda"): "pallas", ("sddmm", "cuda"): "pallas",
             ("spmm", "cuda_batched"): "pallas_batched",
             ("sddmm", "cuda_batched"): "pallas_batched",
             ("spmm", "cuda_balanced"): "pallas_balanced",
             ("sddmm", "cuda_balanced"): "pallas_balanced",
             ("attention", "cuda_balanced"): "pallas_balanced",
             ("attention", "cuda_fused_attn"): "pallas_fused_attn",
             ("attention", "cuda_staged"): "pallas_staged",
             ("spmm", "cuda_staged"): "pallas_staged",
             ("spmm", "cuda_noncoalesced"): "pallas_noncoalesced"}
    # The narrow variants of the two SpMM baselines (rows 2 and 5 of
    # PERF.md §6) are ROADMAP.md queue 2: until they are ported, their
    # impls take fp32 where the reference's take more.
    queue2 = {("spmm", "cuda_staged"): ("fp32", "bf16"),
              ("spmm", "cuda_noncoalesced"): ("fp32", "bf16", "int8")}
    for (op, impl), jax_impl in pairs.items():
        mine, theirs = dispatch.get(op, impl), jdispatch.get(op, jax_impl)
        assert (mine.batched, mine.differentiable) == (
            theirs.batched, theirs.differentiable), (op, impl)
        if (op, impl) in queue2:
            assert mine.precisions == ("fp32",), (op, impl)
            assert theirs.precisions == queue2[(op, impl)], (op, impl)
        else:
            assert mine.precisions == theirs.precisions, (op, impl)
    assert dispatch.require("spmm", "cuda_batched", batched=True,
                            differentiable=True).fn is not None
    with pytest.raises(ValueError, match="no native batched path.*"
                       "cuda_balanced, cuda_batched"):
        dispatch.require("spmm", "cuda", batched=True)
    with pytest.raises(ValueError, match="not differentiable"):
        dispatch.require("attention", "cuda_staged", differentiable=True)


def test_head_routing_requires_the_batched_flag():
    from repro_torch.core.autodiff import _head_impl
    two, three = torch.zeros(4, 3), torch.zeros(2, 4, 3)
    assert _head_impl("spmm", "cuda", two, two) == "cuda"
    assert _head_impl("spmm", "cuda", two, three) == "cuda_batched"
    assert _head_impl("sddmm", "cuda_balanced", three, two) == "cuda_balanced"
    assert _head_impl("attention", "cuda_fused_attn", two, three,
                      two) == "cuda_fused_attn"
    with pytest.raises(ValueError, match="no native batched path"):
        _head_impl("spmm", "coo_segment", three, two)

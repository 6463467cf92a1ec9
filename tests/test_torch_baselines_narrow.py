"""The narrow variants of the two SpMM baselines (PERF.md rows 2 and 5):
the non-coalesced SpMM at bf16 and int8 and the staged SpMM at bf16
against the JAX package's ``spmm_pallas_noncoalesced`` and
``spmm_pallas_staged`` at the same precision (interpret mode), within one
bf16 ulp with at least 99% of the entries bitwise equal; the staged
SpMM's refusal of int8, as the reference's; the wrappers' variants and
the registry's precision levels.  One small matrix (``tests/data``
``hub_128``) and one width for every interpret-mode call."""

import dataclasses
import functools
import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import repro.core as jcore
from repro.data.datasets import load_vendored
from repro.kernels.spmm_pallas import (spmm_pallas_noncoalesced,
                                       spmm_pallas_staged)
from repro_torch.core import block_format, from_coo, spmm
from repro_torch.core.quantize import quantize_format
from repro_torch.core.spmm import spmm_blocked
from repro_torch.kernels import (spmm_cuda, spmm_noncoalesced_cuda,
                                 spmm_noncoalesced_plain, spmm_staged_cuda,
                                 spmm_staged_plain)
from repro_torch.models import gnn
from _torch_threads import one_intraop_thread  # noqa: F401

# the modules (the package attributes of these names are the wrappers)
nc_module, st_module = (importlib.import_module(f"repro_torch.kernels.{n}")
                        for n in ("spmm_noncoalesced_cuda",
                                  "spmm_staged_cuda"))

BF16 = torch.bfloat16
# One bf16 ulp of an entry plus 1e-6 of the output's largest entry, and
# the share of bitwise-equal entries.
ULP_RTOL, ULP_ATOL_OF_MAX, BITWISE_SHARE = 2.0 ** -7, 1e-6, 0.99
N, K_BLK = 16, 8


@functools.lru_cache(maxsize=None)
def _case():
    """hub_128 blocked at k_blk 8 in both packages, and a B of N columns."""
    s = load_vendored(["hub_128"])[0]
    port = block_format(from_coo(s.rows, s.cols, s.vals, s.shape), K_BLK,
                        device="cpu")
    jb = jcore.block_format(jcore.from_coo(s.rows, s.cols, s.vals, s.shape),
                            K_BLK)
    b = np.random.default_rng(19).standard_normal(
        (s.shape[1], N)).astype(np.float32)
    return port, jb, b


def _assert_one_ulp(got, want, label):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, label
    atol = ULP_ATOL_OF_MAX * max(np.abs(want).max(initial=0.0), 1e-30)
    np.testing.assert_allclose(got, want, rtol=ULP_RTOL, atol=atol,
                               err_msg=label)
    share = np.mean(got == want)
    assert share >= BITWISE_SHARE, f"{label}: {share:.4f} bitwise equal"


def _narrow(port, precision):
    return (quantize_format(port) if precision == "int8"
            else dataclasses.replace(port, vals=port.vals.to(BF16)))


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_noncoalesced_narrow_plain_within_one_ulp_of_pallas(precision):
    port, jb, b = _case()
    want = spmm_pallas_noncoalesced(jb, jnp.asarray(b), interpret=True,
                                    precision=precision)
    view = _narrow(port, precision)
    got = spmm_noncoalesced_plain(view, torch.from_numpy(b).to(BF16))
    assert got.dtype == BF16
    _assert_one_ulp(got, want, f"spmm_noncoalesced {precision}")
    # the wrapper on CPU tensors is its plain version, and it is the
    # window SpMM's variant bit for bit
    wrapped = spmm_noncoalesced_cuda(view, torch.from_numpy(b).to(BF16))
    assert torch.equal(wrapped, got)
    assert torch.equal(wrapped, spmm_cuda(view, torch.from_numpy(b).to(BF16)))


def test_staged_bf16_plain_within_one_ulp_of_pallas():
    port, jb, b = _case()
    want = spmm_pallas_staged(jb, jnp.asarray(b), interpret=True,
                              precision="bf16")
    view = _narrow(port, "bf16")
    got = spmm_staged_plain(view, torch.from_numpy(b).to(BF16))
    assert got.dtype == BF16
    _assert_one_ulp(got, want, "spmm_staged bf16")
    assert torch.equal(spmm_staged_cuda(view, torch.from_numpy(b).to(BF16)),
                       got)


def test_staged_int8_raises_as_the_reference():
    port, jb, b = _case()
    with pytest.raises(ValueError, match="no int8 path"):
        spmm_pallas_staged(jb, jnp.asarray(b), interpret=True,
                           precision="int8")
    with pytest.raises(ValueError, match="no int8 path"):
        spmm_staged_cuda(quantize_format(port), torch.from_numpy(b).to(BF16))
    with pytest.raises(ValueError, match="does not support precision 'int8'"):
        spmm(port, torch.from_numpy(b), impl="cuda_staged", precision="int8")


def test_narrow_baselines_take_only_their_variants_and_count_nothing_on_cpu():
    port, _, b = _case()
    b32 = torch.from_numpy(b)
    assert nc_module.VARIANTS == (
        (torch.float32, torch.float32), (BF16, BF16),
        (torch.int8, torch.float32), (torch.int8, BF16))
    assert st_module.VARIANTS == ((torch.float32, torch.float32), (BF16, BF16))
    view16 = _narrow(port, "bf16")
    for fn in (spmm_noncoalesced_cuda, spmm_staged_cuda):
        with pytest.raises(TypeError, match="variants"):   # bf16 vals, fp32 B
            fn(view16, b32)
    with pytest.raises(TypeError, match="scales"):   # int8 without scales
        spmm_noncoalesced_cuda(dataclasses.replace(
            port, vals=port.vals.to(torch.int8)), b32.to(BF16))
    before = (spmm_noncoalesced_cuda.launches,
              dict(spmm_noncoalesced_cuda.variant_launches),
              spmm_staged_cuda.launches,
              dict(spmm_staged_cuda.variant_launches))
    q8 = quantize_format(port)
    # int8 values with fp32 B give fp32, as the window SpMM's variant
    out = spmm_noncoalesced_cuda(q8, b32)
    assert out.dtype == torch.float32
    assert torch.equal(out, spmm_cuda(q8, b32))
    spmm_staged_cuda(view16, b32.to(BF16))
    assert before == (spmm_noncoalesced_cuda.launches,
                      dict(spmm_noncoalesced_cuda.variant_launches),
                      spmm_staged_cuda.launches,
                      dict(spmm_staged_cuda.variant_launches))


@pytest.mark.parametrize("impl", ["cuda_noncoalesced", "cuda_staged"])
def test_baseline_entry_point_and_gcn_forward_at_bf16(impl):
    """``precision="bf16"`` on the entry point, and a bf16 GCN over the
    bare format, through each baseline: the blocked impl's result."""
    port, _, b = _case()
    b32 = torch.from_numpy(b)
    got = spmm(port, b32, impl=impl, precision="bf16")
    assert got.dtype == BF16
    assert torch.equal(got, spmm(port, b32, impl="blocked", precision="bf16"))
    cfg = gnn.GNNConfig(model="gcn", in_dim=N, hidden_dim=N, num_classes=4,
                        num_layers=2, impl=impl, dtype=BF16)
    net = gnn.GCN(cfg, device="cpu", seed=0)
    view16 = _narrow(port, "bf16")
    with torch.inference_mode():
        out = gnn.gcn_forward(net.params(), view16, b32.to(BF16), cfg)
        want = gnn.gcn_forward(net.params(), view16, b32.to(BF16),
                               dataclasses.replace(cfg, impl="blocked"))
    assert out.dtype == BF16 and torch.equal(out, want)
    assert torch.equal(spmm_blocked(view16, b32.to(BF16)),
                       spmm_noncoalesced_plain(view16, b32.to(BF16)))

"""The port's conformance harness, and the port's impls against the
reference's on real matrices.

* ``repro_torch.testing.conformance`` passes over the port's whole
  registry, at every precision each impl declares, on the 14 vendored
  matrices of ``tests/data`` (CPU tensors: the plain versions of the
  kernels), and its ``self_test`` goes red when the harness is blinded.
* Cross-package: each port impl and its reference impl (``cuda`` /
  ``pallas``, ``cuda_batched`` / ``pallas_batched``, ``cuda_balanced`` /
  ``pallas_balanced``, ``cuda_staged`` / ``pallas_staged``,
  ``cuda_noncoalesced`` / ``pallas_noncoalesced``, ``cuda_fused_attn`` /
  ``pallas_fused_attn``, and ``blocked``/``coo*`` with themselves) on the
  same vendored matrix and seed: fp32 within 1e-5, bf16 within one bf16
  ulp with at least 99% of the entries bitwise equal.  The int8 pairs are
  ``tests/test_torch_precision.py``'s (quantization bitwise) and the tuned
  impls' ``tests/test_torch_autotune.py``'s.
"""

import importlib
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import format as jformat
from repro.data import datasets as jds
from repro_torch.core import dispatch
from repro_torch.core import format as tformat
from repro_torch.core.sddmm import attention, sddmm, with_values
from repro_torch.core.spmm import spmm
from repro_torch.data import datasets as tds
from repro_torch.testing import conformance as conf
from repro_torch.testing.faults import FaultNotDetected
from _torch_threads import one_intraop_thread  # noqa: F401

# the modules (the package attributes of these names are the functions)
jsddmm = importlib.import_module("repro.core.sddmm")
jspmm = importlib.import_module("repro.core.spmm")

pytestmark = pytest.mark.filterwarnings(
    "error::repro_torch.core.dispatch.FallbackWarning")

ULP_RTOL, ULP_ATOL_OF_MAX, BITWISE_SHARE = 2.0 ** -7, 1e-6, 0.99
FP32_TOL = 1e-5
PAIR_MATRIX = "hub_96"   # hub windows: the balanced schedules split them

_PAIRS = [("spmm", "blocked", "blocked"),
          ("spmm", "coo_segment", "coo_segment"),
          ("spmm", "cuda", "pallas"),
          ("spmm", "cuda_batched", "pallas_batched"),
          ("spmm", "cuda_balanced", "pallas_balanced"),
          ("spmm", "cuda_staged", "pallas_staged"),
          ("spmm", "cuda_noncoalesced", "pallas_noncoalesced"),
          ("sddmm", "blocked", "blocked"),
          ("sddmm", "coo", "coo"),
          ("sddmm", "cuda", "pallas"),
          ("sddmm", "cuda_batched", "pallas_batched"),
          ("sddmm", "cuda_balanced", "pallas_balanced"),
          ("attention", "blocked", "blocked"),
          ("attention", "cuda_fused_attn", "pallas_fused_attn"),
          ("attention", "cuda_balanced", "pallas_balanced"),
          ("attention", "cuda_staged", "pallas_staged")]


@pytest.fixture(autouse=True)
def _quiet_autotune_log():
    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)


@pytest.mark.parametrize("op", conf.OPS)
def test_port_registry_conforms_on_the_vendored_set(op):
    records = conf.run_conformance(ops=(op,), device="cpu")
    s = conf.summarize(records)
    assert s["fail"] == 0, conf.format_report(records)
    assert s["matrices"] == sorted(tds.vendored_names())
    # every registered impl at every precision it declares, on every matrix
    cases = conf.enumerate_cases((op,))
    assert s["total"] == len(cases) * 14
    assert {(c.impl, c.precision) for c in cases} == {
        (name, p) for name in dispatch.impls(op)
        for p in dispatch.get(op, name).precisions}
    skipped = {r.matrix for r in records if r.status == "skip"}
    assert skipped <= {"rect_120x40", "densearray_8x6"}


def test_enumeration_follows_the_registry_and_the_report_reads():
    cases = conf.enumerate_cases()
    assert ({c.impl for c in cases if c.variant == "split"}
            == {"cuda_balanced", "cuda_sharded", "cuda_sharded_overlap"})
    assert ({c.impl for c in cases if c.variant == "overlap"}
            == {"cuda_sharded_overlap"})
    assert all(c.precision == "fp32" for c in cases if c.variant != "base")
    assert conf.enumerate_cases(precisions=("int8",)) == [
        conf.ConformanceCase("spmm", n, "int8") for n in dispatch.impls("spmm")
        if "int8" in dispatch.get("spmm", n).precisions]
    sample = tds.load_vendored(["tridiag_64"])
    records = conf.run_conformance(sample, ops=("spmm",),
                                   impl_names=["blocked"], device="cpu")
    report = conf.format_report(records)
    assert "blocked[bf16]" in report and "0 fail" in report
    assert conf.summarize(records)["by_impl"] == {
        "spmm/blocked": {"pass": 3, "fail": 0, "skip": 0}}


def test_self_test_catches_a_broken_impl_and_goes_red_when_blinded(
        monkeypatch):
    conf.self_test(device="cpu")
    assert ("spmm", "_conformance_broken") not in dispatch._REGISTRY
    blind = lambda case, sample, operands: conf.ConformanceRecord(  # noqa: E731
        sample.name, "", case.op, case.impl, case.precision, case.variant,
        "pass")
    monkeypatch.setattr(conf, "run_case", blind)
    with pytest.raises(FaultNotDetected, match="passed a deliberately"):
        conf.self_test(device="cpu")
    assert ("spmm", "_conformance_broken") not in dispatch._REGISTRY


# ---------------------------------------------------------------------------
# Cross-package pairs
# ---------------------------------------------------------------------------


def _dense_scores(rows, cols, vals, shape):
    out = np.zeros(shape, np.float32)
    out[rows, cols] = np.asarray(vals, np.float32)
    return out


def _outputs(op, impl, ref_impl, prec, jsample, tsample, batched):
    """(port output, reference output) on the same operands from one seed;
    SDDMM values scattered to dense, each through its own package."""
    rng = np.random.default_rng(0)
    m, kd = tsample.shape
    b, q, k, v = (rng.standard_normal(s).astype(np.float32)
                  for s in ((kd, 16), (m, 16), (kd, 16), (kd, 16)))
    if batched:
        b, q, k = np.stack([b, 2 * b]), np.stack([q, 2 * q]), np.stack([k, k])
    tf, jf = tsample.to_format(), jsample.to_format()
    kw = {} if prec == "fp32" else {"precision": prec}
    t, j = torch.from_numpy, jnp.asarray
    if op == "spmm":
        mine = spmm(tf, t(b), impl=impl, **kw)
        theirs = jspmm.spmm(jf, j(b), impl=ref_impl, interpret=True, **kw)
        return mine, theirs
    if op == "attention":
        mine = attention(tf, t(q), t(k), t(v), impl=impl, scale=0.25, **kw)
        theirs = jsddmm.attention(jf, j(q), j(k), j(v), impl=ref_impl,
                                  scale=0.25, interpret=True, **kw)
        return mine, theirs
    mine = sddmm(tf, t(q), t(k), impl=impl, **kw)
    theirs = jsddmm.sddmm(jf, j(q), j(k), impl=ref_impl, interpret=True, **kw)
    if impl == "coo":
        return mine, theirs
    # blocked-layout values to dense, each through its own package
    tb = tformat.block_format(tf, 8, device="cpu")
    jb = jformat.block_format(jf, 8)
    heads = range(mine.shape[0]) if batched else [None]

    def dense_of(blocked, vals, to_coo, bind):
        return np.stack([_dense_scores(*to_coo(bind(
            blocked, vals if h is None else vals[h])), tsample.shape)
            for h in heads])
    return (torch.from_numpy(dense_of(tb, mine, tformat.to_coo, with_values)),
            jnp.asarray(dense_of(jb, theirs, jformat.to_coo,
                                 jsddmm.with_values)))


@pytest.mark.parametrize("op,impl,ref_impl", _PAIRS,
                         ids=[f"{o}-{i}" for o, i, _ in _PAIRS])
def test_port_impl_agrees_with_its_reference_impl(op, impl, ref_impl):
    jsample = jds.load_vendored([PAIR_MATRIX])[0]
    tsample = tds.load_vendored([PAIR_MATRIX])[0]
    batched = impl.endswith("_batched")
    for prec in ("fp32", "bf16"):
        if prec not in dispatch.get(op, impl).precisions:
            continue
        mine, theirs = _outputs(op, impl, ref_impl, prec, jsample, tsample,
                                batched)
        got = mine.float().numpy()
        want = np.asarray(jnp.asarray(theirs, jnp.float32))
        assert got.shape == want.shape, (prec, got.shape, want.shape)
        if prec == "fp32":
            np.testing.assert_allclose(got, want, rtol=FP32_TOL,
                                       atol=FP32_TOL, err_msg=prec)
            continue
        assert op == "sddmm" or mine.dtype == torch.bfloat16, prec
        atol = ULP_ATOL_OF_MAX * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=ULP_RTOL, atol=atol,
                                   err_msg=prec)
        share = float((got == want).mean()) if got.size else 1.0
        assert share >= BITWISE_SHARE, (prec, share)

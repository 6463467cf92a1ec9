"""The port's graceful-degradation half of the dispatch registry.

The fallback ladders for every port impl (the reference's, with the
port's names), recovery with one ``FallbackWarning`` and one call-log
record, strict re-raise, ``ValidationError`` pass-through, and the
non-finite rescue at the entry points and on an autodiff plan, mirrored
from ``tests/test_dispatch.py``'s tests of the reference.
"""

import warnings

import numpy as np
import pytest
import torch

from repro.core import dispatch as jdispatch
from repro_torch.core import (ad_plan, attention, block_format, dispatch,
                              from_dense, sddmm, spmm, spmm_ad)
from repro_torch.core import metrics
from repro_torch.core.validate import ValidationError
from repro_torch.testing.faults import corrupt_blocked
from _torch_threads import one_intraop_thread  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    "error::repro_torch.core.dispatch.FallbackWarning")

# port impl -> reference impl of the same name on the ladders
_REF_NAME = {"cuda": "pallas", "cuda_batched": "pallas_batched",
             "cuda_balanced": "pallas_balanced",
             "cuda_staged": "pallas_staged",
             "cuda_noncoalesced": "pallas_noncoalesced",
             "cuda_tuned": "pallas_tuned",
             "cuda_fused_attn": "pallas_fused_attn",
             "cuda_fused_attn_tuned": "pallas_fused_attn_tuned",
             "cuda_sharded": "pallas_sharded",
             "cuda_sharded_overlap": "pallas_sharded_overlap"}


def make_fmt(seed=0, m=40, k=36, density=0.25):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    a *= rng.random((m, k)) < density
    return a, from_dense(a, vector_size=8)


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32))


def test_fallback_chain_shape():
    chain = dispatch.fallback_chain("spmm", "cuda")
    assert chain[-1] == "coo_segment" and "blocked" in chain
    assert "cuda" not in chain  # rungs strictly below the requested impl
    # off-ladder impls enter at the default tier
    assert dispatch.fallback_chain("spmm", "cuda_noncoalesced")[0] == "cuda"
    assert dispatch.fallback_chain("spmm", "cuda_staged")[0] == "cuda"
    # sddmm "coo" returns edge values, not blocked layout: no fallback
    assert dispatch.fallback_chain("sddmm", "coo") == ()
    assert dispatch.fallback_for("sddmm", "coo") is None
    # every op's ladder ends in a plain rung
    for op, first, last in (("spmm", "cuda", "coo_segment"),
                            ("sddmm", "cuda", "blocked"),
                            ("attention", "cuda_fused_attn", "blocked")):
        chain = dispatch.fallback_chain(op, first)
        assert chain and chain[-1] == last
        assert dispatch.fallback_for(op, first) is not None


@pytest.mark.parametrize("op", ["spmm", "sddmm", "attention"])
def test_every_port_impl_has_the_reference_ladder(op):
    """``fallback_chain``/``fallback_for`` for every registered impl: the
    reference's rungs under the port's names."""
    names = {v: k for k, v in _REF_NAME.items()}
    for impl in dispatch.impls(op):
        ref_impl = _REF_NAME.get(impl, impl)
        want = tuple(names.get(n, n) for n in
                     jdispatch.fallback_chain(op, ref_impl))
        assert dispatch.fallback_chain(op, impl) == want, (op, impl)
        assert set(want) <= set(dispatch.impls(op)), (op, impl)
        got = dispatch.fallback_for(op, impl)
        ref = jdispatch.fallback_for(op, ref_impl)
        assert got == (None if ref is None else names.get(ref, ref)), impl
        entry = dispatch.get(op, impl)
        assert entry.load_balanced == jdispatch.get(op, ref_impl).load_balanced
    assert dispatch.fallback_for(op, "no_such_impl") is None


def test_the_card_ladder_keeps_only_kernel_rungs(monkeypatch):
    """On CUDA operands no kernel gives way to a plain rung: the chains
    keep the ``cuda*`` rungs, and a refusal that no kernel rung below
    takes raises instead of landing on ``blocked``."""
    for op in ("spmm", "sddmm", "attention"):
        for impl in dispatch.impls(op):
            card = dispatch.fallback_chain(op, impl, on_card=True)
            assert card == tuple(n for n in dispatch.fallback_chain(op, impl)
                                 if n.startswith("cuda")), (op, impl)
    assert dispatch.fallback_chain("spmm", "cuda", on_card=True) == ()
    assert dispatch.fallback_chain("attention", "cuda_fused_attn",
                                   on_card=True) == ("cuda_staged",)
    monkeypatch.setattr(dispatch, "_on_card", lambda args: True)
    a, fmt = make_fmt(seed=12)
    b = _t(np.random.default_rng(4), 36, 16)
    metrics.reset_counters("dispatch_fallback")
    with dispatch.record_calls() as log:
        with pytest.raises(RuntimeError, match="kernel rungs only"):
            spmm(fmt, b, impl="cuda", n_blk=0, strict=False)
    assert log == [("spmm", "cuda")]
    assert metrics.counters().get("dispatch_fallback", 0) == 0


def test_adapt_kwargs_drops_schedules_and_widens_precision():
    kw = {"schedule": object(), "split_blk": 2, "k_blk": 8, "n_blk": 64,
          "precision": "int8"}
    assert dispatch._adapt_kwargs(dispatch.get("spmm", "cuda_balanced"),
                                  kw) == kw
    assert dispatch._adapt_kwargs(dispatch.get("spmm", "cuda"), kw) == {
        "k_blk": 8, "n_blk": 64, "precision": "int8"}
    assert dispatch._adapt_kwargs(dispatch.get("spmm", "cuda_staged"), kw)[
        "precision"] == "bf16"
    assert dispatch._adapt_kwargs(dispatch.get("spmm", "coo_segment"), kw) \
        == {"k_blk": 8, "n_blk": 64, "precision": "fp32"}
    # the rung's signature filters what it cannot take
    assert dispatch._adapt_kwargs(dispatch.get("attention", "blocked"), {
        "n_blk": 0, "scale": 0.5, "precision": "bf16"}) == {
        "scale": 0.5, "precision": "bf16"}


def test_robust_dispatch_recovers_and_logs():
    a, fmt = make_fmt(seed=11)
    b = _t(np.random.default_rng(3), 36, 16)
    ref = a @ b.numpy()
    metrics.reset_counters("dispatch_fallback")
    with pytest.warns(dispatch.FallbackWarning) as wlog:
        with dispatch.record_calls() as log:
            out = spmm(fmt, b, impl="cuda", n_blk=0, strict=False)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-4, atol=2e-4)
    assert ("spmm", "fallback:cuda->blocked") in log
    assert len([w for w in wlog
                if issubclass(w.category, dispatch.FallbackWarning)]) == 1
    w = wlog[0].message
    assert w.op == "spmm" and w.requested == "cuda" and w.used == "blocked"
    assert w.failures and w.failures[0][0] == "cuda"
    assert "n_blk=0" in w.failures[0][1]
    assert metrics.counters()["dispatch_fallback"] == 1


def test_recovery_walks_every_failing_rung_with_its_kwargs():
    """A balanced request whose tile every kernel refuses walks the whole
    ladder, the schedule dropped below the balanced rung, and lands on
    the plain rung at the requested precision."""
    rng = np.random.default_rng(4)
    a, fmt = make_fmt(seed=4)
    b = _t(rng, 36, 16)
    sched = block_format(fmt, 8, device="cpu").schedule(2)
    want = spmm(fmt, b, impl="blocked", precision="bf16")
    with pytest.warns(dispatch.FallbackWarning) as wlog:
        with dispatch.record_calls() as log:
            out = spmm(block_format(fmt, 8, device="cpu"), b,
                       impl="cuda_balanced", schedule=sched, n_blk=0,
                       precision="bf16", strict=False)
    assert torch.equal(out, want)
    w = wlog[0].message
    assert [n for n, _ in w.failures] == ["cuda_balanced", "cuda_batched",
                                          "cuda"]
    assert log[-1] == ("spmm", "fallback:cuda_balanced->blocked")
    # q, k at bf16 through the sddmm ladder
    q = _t(rng, 40, 8)
    with pytest.warns(dispatch.FallbackWarning):
        out = sddmm(fmt, q.double(), _t(rng, 36, 8).double(), impl="cuda",
                    strict=False)
    assert out.dtype == torch.float64


def test_robust_dispatch_strict_reraises():
    a, fmt = make_fmt(seed=12)
    b = torch.ones((36, 8))
    with pytest.raises(ValueError, match="n_blk=0"):
        spmm(fmt, b, impl="cuda", n_blk=0, strict=True)
    # guard_nonfinite alone keeps the strict behaviour: no degradation
    with pytest.raises(ValueError, match="n_blk=0"):
        spmm(fmt, b, impl="cuda", n_blk=0, precision="bf16",
             guard_nonfinite=True)
    q = torch.ones((40, 8))
    with pytest.raises(ValueError, match="n_blk=0"):
        attention(fmt, q, b, b, impl="cuda_staged", n_blk=0, strict=True)


def test_robust_dispatch_never_swallows_validation_errors():
    a, fmt = make_fmt(seed=13)
    bad = corrupt_blocked(block_format(fmt, 8, device="cpu"), "oob_col")
    b = torch.ones((36, 8))
    with pytest.raises(ValidationError, match=r"\[col-in-bounds\]"):
        spmm(bad, b, impl="cuda", check="full", strict=False)
    # raised by a rung itself: no rung below is tried
    calls = []

    def rung(fmt, b, **kw):
        calls.append(1)
        raise ValidationError("values-finite", "poisoned")

    dispatch.register("spmm", "_raises_validation", rung)
    try:
        with pytest.raises(ValidationError, match="values-finite"):
            dispatch.robust_dispatch("spmm", "_raises_validation", fmt, b)
    finally:
        dispatch._REGISTRY.pop(("spmm", "_raises_validation"))
        dispatch._sig_cache.pop(("spmm", "_raises_validation"), None)
    assert calls == [1]


def _overflowing(seed, m=40, k=40):
    rng = np.random.default_rng(seed)
    a = (rng.random((m, k)) < 0.3) * rng.standard_normal((m, k))
    a = a.astype(np.float32)
    a[3, 5] = 3.3999e38     # finite in fp32, inf in bf16
    return a, from_dense(a), _t(rng, k, 16, scale=1e-5)


@pytest.mark.parametrize("impl", ["blocked", "cuda"])
def test_guard_nonfinite_rescues_bf16_overflow(impl):
    a, fmt, b = _overflowing(14)
    bad = spmm(fmt, b, impl=impl, precision="bf16")
    assert not torch.isfinite(bad).all()
    metrics.reset_counters("guard_nonfinite_rerun")
    with pytest.warns(dispatch.FallbackWarning, match="non-finite"):
        with dispatch.record_calls() as log:
            out = spmm(fmt, b, impl=impl, precision="bf16",
                       guard_nonfinite=True)
    assert out.dtype == torch.float32
    ref = a.astype(np.float64) @ b.numpy().astype(np.float64)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-12)
    assert metrics.counters()["guard_nonfinite_rerun"] == 1
    assert ("spmm", f"guard:{impl}:fp32-rerun") in log


def test_guard_nonfinite_benign_passthrough():
    a, fmt = make_fmt(seed=15)
    b = torch.ones((36, 8))
    for impl in ("blocked", "cuda"):
        plain = spmm(fmt, b, impl=impl, precision="bf16")
        guarded = spmm(fmt, b, impl=impl, precision="bf16",
                       guard_nonfinite=True)
        # promoted dtype, identical numbers (the narrow pass was kept)
        assert guarded.dtype == torch.float32
        assert torch.equal(plain.float(), guarded)


def test_ad_plan_guard_nonfinite():
    a, fmt, b = _overflowing(16, 32, 32)
    plan = ad_plan(fmt, impl="blocked", precision="bf16",
                   guard_nonfinite=True, device="cpu")
    assert plan.guard_nonfinite
    metrics.reset_counters("guard_nonfinite_rerun")
    vals = plan.fwd.vals.clone().requires_grad_(True)
    bb = b.clone().requires_grad_(True)
    # the entry points' rescue: one warning, one log entry, one count
    with pytest.warns(dispatch.FallbackWarning, match="non-finite"):
        with dispatch.record_calls() as log:
            out = spmm_ad(plan, vals, bb)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert metrics.counters().get("guard_nonfinite_rerun", 0) == 1
    assert ("spmm", "guard:blocked:fp32-rerun") in log
    # gradients stay the plain straight-through duality: dVals is finite;
    # dB overflows in the rows fed by the poisoned master (the guard
    # covers the forward only)
    out.sum().backward()
    assert torch.isfinite(vals.grad).all()
    finite_rows = torch.isfinite(bb.grad).all(dim=1).numpy()
    assert not finite_rows[5] and finite_rows.sum() >= 32 - 1
    # fp32 and None plans drop the flag
    assert not ad_plan(fmt, impl="blocked", guard_nonfinite=True,
                       device="cpu").guard_nonfinite
    assert not ad_plan(fmt, impl="cuda", precision="fp32",
                       guard_nonfinite=True, device="cpu").guard_nonfinite
    # an unguarded bf16 plan counts nothing and stays bf16
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        raw = spmm_ad(ad_plan(fmt, impl="cuda", precision="bf16",
                              device="cpu"), plan.fwd.vals, b)
    assert raw.dtype == torch.bfloat16
    assert metrics.counters().get("guard_nonfinite_rerun", 0) == 1

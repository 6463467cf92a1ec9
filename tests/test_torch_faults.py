"""The port's fault-injection harness against the reference's.

For every class of ``FAULTS``, ``repro_torch.testing.faults.run_fault``
on CPU tensors gives the mode (raise / recover / counter) and the
invariant that ``repro.testing.faults.run_fault`` gives, at ``blocked``
and at ``cuda`` (the reference's ``pallas``), strict and not strict.
The injected launch failure differs on purpose: the SpMM and the staged
attention refuse ``n_blk=0`` with a ``ValueError`` where the reference's
grid divides by zero, and the SDDMM's failure is float64 Q and K (the
port's SDDMM kernels have no ``f_blk``); the recovery's call-log record
names the port's impls.
"""

import logging

import pytest
import torch

from repro.testing import faults as jfaults
from repro_torch.core import block_format, dispatch
from repro_torch.testing import faults as tfaults
from _torch_threads import one_intraop_thread  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    "error::repro_torch.core.dispatch.FallbackWarning")

_REF_IMPL = {"blocked": "blocked", "cuda": "pallas",
             "cuda_fused_attn": "pallas_fused_attn"}
_CASES = [(op, impl, strict)
          for op, impls in (("spmm", ("blocked", "cuda")),
                            ("sddmm", ("blocked", "cuda")),
                            ("attention", ("blocked", "cuda_fused_attn")))
          for impl in impls for strict in (True, False)]


@pytest.fixture(autouse=True)
def _quiet_cache_warnings():
    # the cache faults log their salvage on purpose
    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)


def _port_name(detail: str) -> str:
    for port, ref in (("cuda_staged", "pallas_staged"), ("cuda", "pallas")):
        detail = detail.replace(ref, port)
    return detail


@pytest.mark.parametrize("op,impl,strict", _CASES,
                         ids=[f"{o}-{i}-{'strict' if s else 'degrade'}"
                              for o, i, s in _CASES])
def test_every_fault_class_matches_the_reference(op, impl, strict):
    mine = tfaults.run_fault_suite(op, impl, strict=strict, device="cpu")
    theirs = jfaults.run_fault_suite(op, _REF_IMPL[impl], strict=strict,
                                     interpret=True)
    assert [r["fault"] for r in mine] == list(tfaults.FAULTS) \
        == list(jfaults.FAULTS)
    assert tfaults.FAULTS == jfaults.FAULTS
    for got, want in zip(mine, theirs):
        assert got["mode"] == want["mode"], got["fault"]
        if got["fault"] != "kernel_launch_failure":
            assert got["detail"] == want["detail"], got["fault"]
        elif not strict:
            assert got["detail"] == _port_name(want["detail"])
        else:
            assert got["detail"] == ("TypeError" if op == "sddmm"
                                     else "ValueError")


@pytest.mark.parametrize("op", ["spmm", "sddmm", "attention"])
def test_a_kernel_rung_recovers_on_the_next_kernel_rung(op):
    """Another view's schedule on ``cuda_balanced`` is refused on the host
    and served by the next kernel rung, which takes no schedule."""
    rec = tfaults.run_rung_recovery(op, device="cpu")
    nxt = "cuda_fused_attn" if op == "attention" else "cuda_batched"
    assert (rec["mode"], rec["detail"]) == (
        "recover", f"fallback:cuda_balanced->{nxt}")


def test_corrupt_blocked_leaves_the_original_untouched():
    _, fmt, *_ = tfaults._example(device="cpu")
    blocked = block_format(fmt, 8, device="cpu")
    before = {f: getattr(blocked, f).clone()
              for f in ("vals", "cols", "win_ptr")}
    for fault in ("oob_col", "swapped_win_ptr", "truncated_leaf",
                  "nonfinite_values", "dtype_mismatch"):
        tfaults.corrupt_blocked(blocked, fault)
    for f, t in before.items():
        assert torch.equal(getattr(blocked, f), t)
    with pytest.raises(KeyError, match="format-level"):
        tfaults.corrupt_blocked(blocked, "torn_cache_json")
    with pytest.raises(KeyError, match="cache-level"):
        tfaults.corrupt_cache_file("unused.json", "oob_col")


def test_cli_runs_the_suite(capsys):
    assert tfaults._main(["--op", "spmm", "--impl", "cuda", "--no-strict",
                          "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "11/11 fault classes handled" in out
    assert "fallback:cuda->blocked" in out
    assert tfaults._main(["--op", "sddmm", "--device", "cpu", "--fault",
                          "oob_col"]) == 0


def test_an_undetected_fault_is_reported(monkeypatch):
    """Blinded validation (every audit passes) turns a format fault into
    ``FaultNotDetected`` (or the kernel's unnamed error, re-raised), never
    a silent pass; so does a ladder with no rung below the failure."""
    from repro_torch.core import validate

    monkeypatch.setattr(validate, "validate", lambda obj, **kw: obj)
    with pytest.raises(tfaults.FaultNotDetected, match="accepted"):
        tfaults.run_fault("nonfinite_values", op="spmm", impl="blocked",
                          device="cpu")
    with pytest.raises(IndexError):
        tfaults.run_fault("oob_col", op="spmm", impl="blocked",
                          device="cpu")
    monkeypatch.setattr(dispatch, "_LADDERS", {})
    with pytest.raises(RuntimeError, match="every compatible fallback"):
        tfaults.run_fault("kernel_launch_failure", op="spmm", impl="cuda",
                          strict=False, device="cpu")

"""Fault-injection harness: corrupt on purpose, assert raise-or-recover.

Counterpart of ``repro.testing.faults``.  Every corruption class below is
one concrete failure a deployed sparse runtime meets: a bad converter
writing out-of-bounds columns, a checkpoint truncating a leaf, NaNs
leaking in from a diverged training run, a stale or torn autotune cache,
an int8 scale that saturates, a tile the kernel cannot launch.  For each
class the harness asserts the hardened runtime (DESIGN.md §15) does
exactly one of:

* **raise**: ``check="full"`` validation rejects the object with a
  :class:`~repro_torch.core.validate.ValidationError` naming the violated
  invariant (never a shape error from deep inside a kernel);
* **recover**: the op degrades down the fallback ladder
  (``strict=False``) and still matches the oracle, or the cache layer
  salvages or rebuilds and later lookups behave;
* **count**: the event is absorbed by design (int8 saturation clips) and
  shows in :func:`repro_torch.core.metrics.counters`.

Every injected launch failure is an argument the kernel wrappers refuse
on the host before any launch, so a run on the card never provokes a
device fault (which would stick to the context).  The SpMM and the
staged attention refuse a column tile ``n_blk=0``, as the reference's
do.  The port's SDDMM kernels stream all of F and have no ``f_blk``
(the reference's injected argument), so the SDDMM's failure is float64
Q and K: the kernels never cast and refuse them, and the plain
``blocked`` rung takes them.  On CUDA operands the ladder keeps only its
kernel rungs and none below ``cuda`` / ``cuda_staged`` takes the refused
argument, so there ``kernel_launch_failure`` ends in ``raise`` with
``strict=False`` too; :func:`run_rung_recovery` drives a recovery from
one kernel rung to the next instead (another view's schedule on
``cuda_balanced``), on either device.

Use from tests (:func:`run_fault`, :func:`run_fault_suite`) or as a CLI::

    python -m repro_torch.testing.faults --op spmm --impl cuda --no-strict
    python -m repro_torch.testing.faults --op sddmm --device cpu
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import warnings
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core import dispatch as _dispatch
from repro_torch.core import metrics as _metrics
from repro_torch.core.format import (block_format, from_coo, resolve_device,
                                     to_dense)
from repro_torch.core.sddmm import _sddmm_blocked_impl
from repro_torch.core.sddmm import attention as _attention
from repro_torch.core.sddmm import sddmm as _sddmm
from repro_torch.core.spmm import spmm as _spmm
from repro_torch.core.spmm import spmm_dense_ref
from repro_torch.core.validate import ValidationError

__all__ = [
    "FAULTS",
    "FaultNotDetected",
    "corrupt_blocked",
    "corrupt_cache_file",
    "run_fault",
    "run_fault_suite",
    "run_rung_recovery",
]


class FaultNotDetected(AssertionError):
    """An injected fault sailed through: no named error, no recovery."""


# fault name -> (kind, invariants the validator may name for it)
FAULTS: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "oob_col": ("format", ("col-in-bounds",)),
    "swapped_win_ptr": ("format", ("win-ptr-monotone", "win-ptr-bounds")),
    "truncated_leaf": ("format", ("leaf-length",)),
    "nonfinite_values": ("format", ("values-finite",)),
    "dtype_mismatch": ("format", ("dtype-mismatch",)),
    "duplicate_coo": ("input", ("duplicate-coords",)),
    "oversized_block_config": ("config", ("block-config",)),
    "kernel_launch_failure": ("runtime", ()),
    "int8_saturation": ("counter", ()),
    "stale_cache_schema": ("cache", ()),
    "torn_cache_json": ("cache", ()),
}


def _example(m: int = 64, k: int = 64, n: int = 16, density: float = 0.15,
             seed: int = 0, device=None):
    """The reference's example matrix (a hub row at 3) and dense operands,
    from the same seed, on ``device``."""
    rng = np.random.default_rng(seed)
    dense = ((rng.random((m, k)) < density)
             * rng.standard_normal((m, k))).astype(np.float32)
    dense[3] = (rng.standard_normal(k)
                * (rng.random(k) < 0.6)).astype(np.float32)  # hub row
    rows, cols = np.nonzero(dense)
    fmt = from_coo(rows, cols, dense[rows, cols], (m, k))

    def t(shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(device)

    b, q, kk, v = t((k, n)), t((m, n)), t((k, n)), t((k, n))
    return dense, fmt, b, q, kk, v


def corrupt_blocked(blocked, fault: str):
    """A copy of ``blocked`` with ``fault`` injected (on its device)."""
    vals = blocked.vals.clone()
    cols = blocked.cols.clone()
    wptr = blocked.win_ptr.clone()
    if fault == "oob_col":
        cols[0] = blocked.shape[1] + 7
        return dataclasses.replace(blocked, cols=cols)
    if fault == "swapped_win_ptr":
        if int(wptr[-1]) <= int(wptr[1]):
            raise ValueError("matrix too empty to break win_ptr monotonicity")
        wptr[1], wptr[-1] = wptr[-1].clone(), wptr[1].clone()
        return dataclasses.replace(blocked, win_ptr=wptr)
    if fault == "truncated_leaf":
        return dataclasses.replace(blocked, vals=vals[:-blocked.k_blk])
    if fault == "nonfinite_values":
        pos = torch.nonzero(blocked.mask)
        if pos.numel() == 0:
            raise ValueError("no owned nonzero to poison")
        r, c = pos[0].tolist()
        vals[r, c] = float("nan")
        return dataclasses.replace(blocked, vals=vals)
    if fault == "dtype_mismatch":
        return dataclasses.replace(blocked, win_ptr=wptr.float())
    raise KeyError(f"not a format-level fault: {fault!r}")


def corrupt_cache_file(path: str, fault: str) -> None:
    """Write a corrupted autotune-cache file for ``fault`` at ``path``
    (the port's :class:`~repro_torch.kernels.autotune.AutotuneCache`,
    schema 6)."""
    from repro_torch.kernels.autotune import SCHEMA_VERSION, TuneConfig

    healthy = {
        "schema": SCHEMA_VERSION,
        "configs": {
            "spmm|seed-entry|k8|nb128|s0|pfp32|o0":
                TuneConfig(8, 128, 1.0).to_json(),
            "spmm|other-entry|k8|nb64|s0|pfp32|o0":
                TuneConfig(8, 64, 2.0).to_json(),
        },
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if fault == "stale_cache_schema":
        healthy["schema"] = 1
        with open(path, "w") as f:
            json.dump(healthy, f, indent=2)
        return
    if fault == "torn_cache_json":
        text = json.dumps({"schema": healthy["schema"],
                           "configs": healthy["configs"]}, indent=2)
        with open(path, "w") as f:
            f.write(text[: int(len(text) * 0.7)])   # torn mid-entry
        return
    raise KeyError(f"not a cache-level fault: {fault!r}")


def _call_op(op: str, impl: str, fmt, b, q, k, v, **kw):
    if op == "spmm":
        return _spmm(fmt, b, impl=impl, **kw)
    if op == "sddmm":
        return _sddmm(fmt, q, k, impl=impl, **kw)
    if op == "attention":
        return _attention(fmt, q, k, v, impl=impl, **kw)
    raise KeyError(f"unknown op {op!r}")


def _oracle(op: str, dense, b, q, k, v, blocked):
    if op == "spmm":
        return spmm_dense_ref(torch.from_numpy(dense).to(b.device), b)
    if op == "sddmm":
        # blocked-layout scores: the plain rung is itself the oracle
        return _sddmm_blocked_impl(blocked, q, k)
    if op == "attention":
        return _attention(blocked, q, k, v, impl="blocked")
    raise KeyError(f"unknown op {op!r}")


def _launch_failure(op: str, impl: str, q, k):
    """``(impl, kwargs, q, k)`` of the injected launch failure: a column
    tile of 0 for the SpMM (on ``impl`` when it is a ``cuda*`` impl) and
    the staged attention, float64 Q and K for the SDDMM."""
    run_impl = impl if impl.startswith("cuda") else "cuda"
    if op == "sddmm":
        return run_impl, {}, q.double(), k.double()
    if op == "attention":
        # the fused attention has no free column tile: stage the failure
        # through the staged composition's SpMM
        return "cuda_staged", {"n_blk": 0}, q, k
    return run_impl, {"n_blk": 0}, q, k


def _recovered(fault, op, impl, dense, blocked, b, q, k, v, kw):
    """Run ``op`` on ``impl`` over ``blocked`` (the view of ``dense``)
    with ``strict=False``; check that it recovered with one
    :class:`FallbackWarning` and one ``fallback:`` call-log entry and
    matches the oracle.  Returns the entry."""
    with warnings.catch_warnings(record=True) as wlog:
        warnings.simplefilter("always")
        with _dispatch.record_calls() as calls:
            out = _call_op(op, impl, blocked, b, q, k, v, strict=False, **kw)
    oracle = _oracle(op, dense, b, q.float(), k.float(), v, blocked)
    if not torch.allclose(out.float(), oracle.float(), atol=1e-4):
        raise FaultNotDetected(f"{fault}: fallback result does not "
                               f"match the oracle")
    fb = [c for c in calls if c[1].startswith("fallback:")]
    warned = [w for w in wlog
              if issubclass(w.category, _dispatch.FallbackWarning)]
    if len(fb) != 1 or len(warned) != 1:
        raise FaultNotDetected(
            f"{fault}: recovery left {len(fb)} fallback records and "
            f"{len(warned)} warnings, not one each (calls={calls})")
    return fb[-1][1]


def _record(fault, op, impl, mode, detail, ok=True):
    return {"fault": fault, "op": op, "impl": impl, "mode": mode,
            "detail": detail, "ok": ok}


def run_fault(fault: str, *, op: str = "spmm", impl: str = "blocked",
              strict: bool = True, seed: int = 0, device=None) -> Dict:
    """Inject ``fault`` against ``op``/``impl`` with operands on
    ``device`` (the card unless it says otherwise); assert
    raise-or-recover.

    Returns a record dict (``mode`` is ``"raise"``, ``"recover"`` or
    ``"counter"``); raises :class:`FaultNotDetected` if the corruption
    goes unnoticed, and re-raises any *unnamed* error (failures are named
    or absorbed, never a bare IndexError from a kernel wrapper).
    """
    kind, invariants = FAULTS[fault]
    device = resolve_device(device)
    dense, fmt, b, q, k, v = _example(seed=seed, device=device)
    blocked = block_format(fmt, 8, device=device)

    if kind == "format":
        bad = corrupt_blocked(blocked, fault)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                _call_op(op, impl, bad, b, q, k, v, check="full")
        except ValidationError as e:
            if e.invariant not in invariants:
                raise FaultNotDetected(
                    f"{fault}: wrong invariant {e.invariant!r}, "
                    f"expected one of {invariants}") from e
            return _record(fault, op, impl, "raise", e.invariant)
        raise FaultNotDetected(f"{fault}: check='full' accepted the "
                               f"corrupted format")

    if fault == "duplicate_coo":
        rows, cols_np = np.nonzero(dense)
        vals_np = dense[rows, cols_np]
        rows2 = np.concatenate([rows, rows[:3]])
        cols2 = np.concatenate([cols_np, cols_np[:3]])
        vals2 = np.concatenate([vals_np, vals_np[:3]])
        try:
            from_coo(rows2, cols2, vals2, dense.shape, duplicates="error")
        except ValidationError as e:
            if e.invariant not in invariants:
                raise FaultNotDetected(
                    f"{fault}: wrong invariant {e.invariant!r}") from e
            # the coalescing mode must also recover to the summed oracle
            f2 = from_coo(rows2, cols2, vals2, dense.shape,
                          duplicates="sum")
            summed = dense.copy()
            summed[rows[:3], cols_np[:3]] += vals_np[:3]
            if not np.allclose(to_dense(f2).numpy(), summed, atol=1e-6):
                raise FaultNotDetected(
                    f"{fault}: duplicates='sum' did not coalesce")
            return _record(fault, op, impl, "raise", e.invariant)
        raise FaultNotDetected(f"{fault}: duplicates='error' accepted "
                               f"duplicate coordinates")

    if fault == "oversized_block_config":
        try:
            block_format(fmt, k_blk=2 ** 20, device=device)
        except ValidationError as e:
            if e.invariant not in invariants:
                raise FaultNotDetected(
                    f"{fault}: wrong invariant {e.invariant!r}") from e
            return _record(fault, op, impl, "raise", e.invariant)
        raise FaultNotDetected(f"{fault}: block_format accepted k_blk=2**20")

    if fault == "kernel_launch_failure":
        # strict=True must surface the wrapper's refusal; strict=False
        # must degrade down the ladder and still match the oracle, except
        # on the card, where no kernel rung below takes the argument and
        # no plain rung is tried: the call must raise there too.
        run_impl, kw, q_in, k_in = _launch_failure(op, impl, q, k)
        if strict or device.type == "cuda":
            try:
                _call_op(op, run_impl, blocked, b, q_in, k_in, v,
                         strict=strict, **kw)
            except ValidationError:
                raise
            except Exception as e:
                return _record(fault, op, run_impl, "raise",
                               type(e).__name__)
            raise FaultNotDetected(f"{fault}: the refused argument ran")
        out = _recovered(fault, op, run_impl, dense, blocked, b, q_in, k_in,
                         v, kw)
        return _record(fault, op, run_impl, "recover", out)

    if fault == "int8_saturation":
        from repro_torch.core.quantize import quantize_blocked

        _metrics.reset_counters("int8_clip")
        x = torch.from_numpy(np.linspace(-300.0, 300.0, 256,
                                         dtype=np.float32)
                             .reshape(32, 8)).to(device)
        qv, _ = quantize_blocked(x, 8, scale=1.0)   # |x| > 127 saturates
        n_clip = _metrics.counters().get("int8_clip", 0)
        if n_clip <= 0:
            raise FaultNotDetected(f"{fault}: clip counter did not fire")
        if int(qv.min()) < -127 or int(qv.max()) > 127:
            raise FaultNotDetected(f"{fault}: quantize overflowed int8")
        return _record(fault, op, impl, "counter", f"int8_clip={n_clip}")

    if kind == "cache":
        from repro_torch.kernels.autotune import AutotuneCache, TuneConfig

        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "cache.json")
            corrupt_cache_file(path, fault)
            cache = AutotuneCache(path)
            data = dict(cache._load())   # must not raise; a snapshot (put
                                         # below mutates the live dict)
            if fault == "stale_cache_schema" and data:
                raise FaultNotDetected(
                    f"{fault}: stale-schema entries satisfied a lookup")
            if fault == "torn_cache_json" and not data:
                raise FaultNotDetected(
                    f"{fault}: salvage recovered no entry from a file "
                    f"torn past the first config")
            # the cache must heal: a put round-trips through the salvage
            cache.put("heal|k8|nb128|s0|pfp32|o0", TuneConfig(8, 128, 0.5))
            if AutotuneCache(path).get("heal|k8|nb128|s0|pfp32|o0") is None:
                raise FaultNotDetected(f"{fault}: cache did not heal")
            return _record(fault, op, impl, "recover",
                           f"salvaged={len(data)}")

    raise KeyError(f"unknown fault {fault!r}")


def run_rung_recovery(op: str = "spmm", *, seed: int = 0,
                      device=None) -> Dict:
    """A recovery from one kernel rung to the next: ``cuda_balanced``
    given another view's schedule refuses it on the host, and the ladder
    serves the call on the next kernel rung (``cuda_batched``, or
    ``cuda_fused_attn`` for attention), which takes no schedule.  The
    same on the CPU and on the card; returns a ``recover`` record whose
    detail is the ``fallback:`` call-log entry."""
    device = resolve_device(device)
    dense, fmt, b, q, k, v = _example(seed=seed, device=device)
    blocked = block_format(fmt, 8, device=device)
    other = block_format(_example(m=128, seed=seed + 1)[1], 8, device=device)
    detail = _recovered("rung_recovery", op, "cuda_balanced", dense, blocked,
                        b, q, k, v, {"schedule": other.schedule(1)})
    return _record("rung_recovery", op, "cuda_balanced", "recover", detail)


def run_fault_suite(op: str = "spmm", impl: str = "blocked", *,
                    strict: bool = True, device=None) -> List[Dict]:
    """Run every fault class against ``op``/``impl``; return the records."""
    return [run_fault(name, op=op, impl=impl, strict=strict, device=device)
            for name in FAULTS]


def _main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--op", default="spmm",
                   choices=("spmm", "sddmm", "attention"))
    p.add_argument("--impl", default="blocked")
    p.add_argument("--strict", dest="strict", action="store_true",
                   default=True)
    p.add_argument("--no-strict", dest="strict", action="store_false")
    p.add_argument("--device", default=None,
                   help="cpu or cuda (default: the card)")
    p.add_argument("--fault", default=None, choices=sorted(FAULTS),
                   help="run one fault class instead of the full suite")
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    names = [a.fault] if a.fault else list(FAULTS)
    failed = 0
    for name in names:
        try:
            rec = run_fault(name, op=a.op, impl=a.impl, strict=a.strict,
                            device=device)
            print(f"  ok  {name:<24} {rec['mode']:<8} {rec['detail']}")
        except FaultNotDetected as e:
            failed += 1
            print(f"FAIL  {name:<24} {e}")
    print(f"{len(names) - failed}/{len(names)} fault classes handled "
          f"(op={a.op}, impl={a.impl}, strict={a.strict}, device={device})")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(_main())

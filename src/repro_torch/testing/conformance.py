"""Cross-impl conformance harness: every registered impl vs the dense oracle.

Counterpart of ``repro.testing.conformance``.  The dispatch registry
(:mod:`repro_torch.core.dispatch`) is the one table of every
``(op, impl)`` path of the port; this module proves the whole table
correct on real matrices.  For each loaded
:class:`~repro_torch.data.datasets.MatrixSample` it:

  1. enumerates every registered ``(op, impl, precision)`` combination
     (:func:`enumerate_cases`) plus the ``split`` variant of the
     ``load_balanced`` impls and the ``overlap`` variant (two segment
     batches) of the ``overlapped`` ones: nothing is hand-listed, so a
     newly registered impl is covered the day it lands;
  2. runs each against the dense numpy oracle under the per-
     ``(op, precision)`` tolerance ladder (DESIGN.md §13):
     fp32 ≈ 2e-4, bf16 ≈ 2e-2, int8 ≈ 5e-2, with the atol scaled by the
     oracle's largest entry;
  3. reports a pass/fail matrix (:class:`ConformanceRecord` rows;
     :func:`summarize` / :func:`format_report` for people).

Outputs are normalised per impl flags: blocked-layout SDDMM values are
scattered back through the format, ``returns_format`` impls (the tuned
SDDMM) are read through ``to_coo``, the edge-value ``coo`` impl is
compared in ``to_coo`` order, and the ``*_batched`` impls get H = 2
stacked operands against a stacked oracle.  Operands and impls run on a
``device=`` argument (the card unless it says otherwise); the tuned impls
sweep into a temporary autotune cache; the ``multi_device`` impls run on
a one-rank ``(1, 1)`` mesh of that device, as the reference's
``_conformance_mesh`` (the group it starts ends with the run).

:func:`self_test` proves the harness catches a wrong kernel: it registers
a deliberately broken impl and raises
:class:`~repro_torch.testing.faults.FaultNotDetected` unless the run
reports it failing.

CLI (offline; the vendored set under ``tests/data``)::

    python -m repro_torch.testing.conformance                  # on the card
    python -m repro_torch.testing.conformance --device cpu
    python -m repro_torch.testing.conformance --datasets tridiag_64,hub_96
    python -m repro_torch.testing.conformance --op spmm --precision fp32
    python -m repro_torch.testing.conformance --self-test
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import dispatch as _dispatch
from repro_torch.core.format import (block_format, resolve_device, to_coo)
from repro_torch.core.sddmm import attention, sddmm, with_values
from repro_torch.core.spmm import spmm
from repro_torch.launch.mesh import one_rank_mesh

__all__ = [
    "ConformanceCase",
    "ConformanceRecord",
    "enumerate_cases",
    "tolerance",
    "run_case",
    "run_conformance",
    "summarize",
    "format_report",
    "self_test",
]

OPS = ("spmm", "sddmm", "attention")

# Feature dims of the dense operands (small: the matrices carry the
# structure, the operands only need to be wide enough to exercise tiling).
N_FEAT = 16
BATCH_H = 2


@dataclasses.dataclass(frozen=True)
class ConformanceCase:
    """One (op, impl, precision, variant) combination to execute.

    ``variant``: ``"base"`` (plain call; ``*_batched`` impls get H = 2
    stacked operands), ``"split"`` (``split_blk=2`` on load-balanced
    impls) or ``"overlap"`` (``n_batches=2`` on overlapped impls); the
    variants run at fp32 only: they probe the schedule, precision expands
    on the base variant.
    """

    op: str
    impl: str
    precision: str
    variant: str = "base"

    @property
    def label(self) -> str:
        tag = f"{self.impl}[{self.precision}]"
        return tag if self.variant == "base" else f"{tag}+{self.variant}"


@dataclasses.dataclass(frozen=True)
class ConformanceRecord:
    """Outcome of one case on one matrix."""

    matrix: str
    structure_class: str
    op: str
    impl: str
    precision: str
    variant: str
    status: str            # "pass" | "fail" | "skip"
    max_err: float = 0.0   # max |out - ref| over the compared values
    detail: str = ""       # failure exception / skip reason


def enumerate_cases(ops: Sequence[str] = OPS,
                    impl_names: Optional[Sequence[str]] = None,
                    precisions: Optional[Sequence[str]] = None,
                    ) -> List[ConformanceCase]:
    """Every registered combination, straight from the dispatch registry."""
    cases: List[ConformanceCase] = []
    for op in ops:
        for name in _dispatch.impls(op):
            if impl_names is not None and name not in impl_names:
                continue
            entry = _dispatch.get(op, name)
            for prec in entry.precisions:
                if precisions is not None and prec not in precisions:
                    continue
                cases.append(ConformanceCase(op, name, prec))
            if precisions is not None and "fp32" not in precisions:
                continue
            if entry.load_balanced:
                cases.append(ConformanceCase(op, name, "fp32", "split"))
            if entry.overlapped:
                cases.append(ConformanceCase(op, name, "fp32", "overlap"))
    return cases


def tolerance(op: str, precision: str, ref: np.ndarray
              ) -> Tuple[float, float]:
    """(rtol, atol) of the ladder for this op/precision, atol scaled by
    the oracle's magnitude (real matrices are not unit-scale)."""
    scale = max(float(np.max(np.abs(ref))) if ref.size else 0.0, 1.0)
    if precision == "int8":
        return 5e-2, 5e-2 * scale
    if precision == "bf16":
        r = 5e-2 if op == "attention" else 2e-2
        return r, r * scale
    if op == "attention":
        return 2e-3, 2e-3 * scale
    return 2e-4, 2e-4 * scale


# ---------------------------------------------------------------------------
# Oracles + output normalisation
# ---------------------------------------------------------------------------


def _attention_oracle(mask: np.ndarray, q: np.ndarray, k: np.ndarray,
                      v: np.ndarray, scale: float) -> np.ndarray:
    """Masked-softmax dense reference; rows with no pattern entries → 0."""
    scores = (q @ k.T) * scale
    scores = np.where(mask, scores, -1e30)
    mx = scores.max(axis=-1, keepdims=True)
    e = np.exp(scores - mx) * mask
    denom = e.sum(axis=-1, keepdims=True)
    p = np.where(denom > 0, e / np.maximum(denom, 1e-30), 0.0)
    return (p @ v).astype(np.float32)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def _scatter_blocked(blocked, vals: torch.Tensor, shape) -> np.ndarray:
    """Blocked-layout (NNZP, V) values → dense (masked positions only)."""
    rows, cols, v = to_coo(with_values(blocked, vals))
    out = np.zeros(shape, np.float32)
    out[rows, cols] = v
    return out


def run_case(case: ConformanceCase, sample, operands) -> ConformanceRecord:
    """Execute one case on one sample; never raises (a failure becomes a
    ``status="fail"`` record: an exception is an explained failure, not a
    crash of the harness)."""
    cls = operands["structure_class"]

    def rec(status, max_err=0.0, detail=""):
        return ConformanceRecord(sample.name, cls, case.op, case.impl,
                                 case.precision, case.variant, status,
                                 max_err, detail)

    entry = _dispatch.get(case.op, case.impl)
    if case.op == "attention" and not sample.is_square:
        return rec("skip", detail="attention needs a square pattern")

    fmt = operands["fmt"]
    dense = operands["dense"]
    mask = operands["mask"]
    q, k, v, b = (operands[x] for x in ("q", "k", "v", "b"))
    qh, kh, vh, bh = (_host(x) for x in (q, k, v, b))
    batched = entry.batched and case.impl.endswith("_batched")

    kw: Dict[str, object] = {"impl": case.impl}
    if case.precision != "fp32":
        kw["precision"] = case.precision
    if entry.multi_device:
        kw["mesh"] = operands["mesh"]
    if case.variant == "split":
        kw["split_blk"] = 2
    if case.variant == "overlap":
        kw["n_batches"] = 2

    def blocked_view():
        if "blocked" not in operands:
            operands["blocked"] = block_format(fmt, k_blk=8,
                                               device=q.device)
        return operands["blocked"]

    try:
        if case.op == "spmm":
            rhs = torch.stack([b, 2.0 * b]) if batched else b
            out = _host(spmm(fmt, rhs, **kw))
            ref = (np.stack([dense @ _host(r) for r in rhs])
                   if batched else dense @ bh)
        elif case.op == "sddmm":
            dense_scores = (qh @ kh.T) * mask
            if case.impl == "coo":  # edge values in to_coo(fmt) order
                rows, cols, _ = to_coo(fmt)
                out = _host(sddmm(fmt, q, k, **kw))
                ref = dense_scores[rows, cols]
            elif batched:
                q3, k3 = torch.stack([q, 2.0 * q]), torch.stack([k, k])
                raw = sddmm(fmt, q3, k3, **kw)
                out = np.stack([_scatter_blocked(blocked_view(), raw[h],
                                                 sample.shape)
                                for h in range(raw.shape[0])])
                ref = np.stack([(_host(q3[h]) @ _host(k3[h]).T) * mask
                                for h in range(raw.shape[0])])
            else:
                raw = sddmm(fmt, q, k, **kw)
                if entry.returns_format:  # tuned: BlockedMEBCRS out
                    rows, cols, vals = to_coo(raw)
                    out = np.zeros(sample.shape, np.float32)
                    out[rows, cols] = vals
                else:  # blocked layout (NNZP, V) at the entry's k_blk=8
                    out = _scatter_blocked(blocked_view(), raw,
                                           sample.shape)
                ref = dense_scores
        else:  # attention
            scale = 1.0 / np.sqrt(N_FEAT)
            out = _host(attention(fmt, q, k, v, scale=scale, **kw))
            ref = _attention_oracle(mask, qh, kh, vh, scale)
    except Exception as e:  # noqa: BLE001 — recorded, not raised
        return rec("fail", detail=f"{type(e).__name__}: {str(e)[:200]}")

    if out.shape != ref.shape:
        return rec("fail", detail=f"shape {out.shape} != ref {ref.shape}")
    rtol, atol = tolerance(case.op, case.precision, ref)
    err = np.abs(out - ref)
    bound = atol + rtol * np.abs(ref)
    max_err = float(err.max()) if err.size else 0.0
    if not np.all(np.isfinite(out)):
        return rec("fail", max_err=float("inf"), detail="non-finite output")
    if np.any(err > bound):
        worst = float((err - bound).max())
        return rec("fail", max_err=max_err,
                   detail=f"tolerance exceeded by {worst:.3g} "
                          f"(rtol={rtol:g}, atol={atol:.3g})")
    return rec("pass", max_err=max_err)


def _operands_for(sample, rng: np.random.Generator,
                  device) -> Dict[str, object]:
    """Shared per-matrix operands (one format build per matrix)."""
    m, kd = sample.shape
    mask = np.zeros(sample.shape, bool)
    mask[sample.rows, sample.cols] = True

    def t(shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(device)

    return {
        "fmt": sample.to_format(),
        "dense": sample.dense(),
        "mask": mask,
        "structure_class": sample.meta.get("structure_class")
        or sample.structure_class(),
        "b": t((kd, N_FEAT)),
        "q": t((m, N_FEAT)),
        "k": t((kd, N_FEAT)),
        "v": t((kd, N_FEAT)),
    }


@contextlib.contextmanager
def _temporary_autotune_cache():
    """The tuned impls' default cache pointed at a fresh temporary file,
    so a conformance run never reads or writes the user's winners."""
    from repro_torch.kernels import autotune

    saved = autotune._DEFAULT_CACHE
    with tempfile.TemporaryDirectory() as d:
        autotune._DEFAULT_CACHE = autotune.AutotuneCache(
            os.path.join(d, "autotune_cache.json"))
        try:
            yield
        finally:
            autotune._DEFAULT_CACHE = saved


def run_conformance(samples=None, ops: Sequence[str] = OPS,
                    impl_names: Optional[Sequence[str]] = None,
                    precisions: Optional[Sequence[str]] = None,
                    seed: int = 0, verbose: bool = False, device=None,
                    ) -> List[ConformanceRecord]:
    """The harness: every enumerated case on every sample, on ``device``
    (the card unless it says otherwise).

    ``samples=None`` loads the vendored set.  Returns the flat record
    list; see :func:`summarize` / :func:`format_report`.
    """
    device = resolve_device(device)
    if samples is None:
        from repro_torch.data.datasets import load_vendored

        samples = load_vendored()
    cases = enumerate_cases(ops, impl_names, precisions)
    records: List[ConformanceRecord] = []
    sharded = any(_dispatch.get(c.op, c.impl).multi_device for c in cases)
    with _temporary_autotune_cache(), (
            one_rank_mesh(device) if sharded
            else contextlib.nullcontext()) as mesh:
        for sample in samples:
            operands = _operands_for(sample, np.random.default_rng(seed),
                                     device)
            operands["mesh"] = mesh
            for case in cases:
                record = run_case(case, sample, operands)
                records.append(record)
                if verbose:
                    mark = {"pass": ".", "skip": "s",
                            "fail": "F"}[record.status]
                    print(f"  {mark} {sample.name:16s} {case.op:9s} "
                          f"{case.label:28s} {record.detail}", flush=True)
    return records


def summarize(records: Sequence[ConformanceRecord]) -> Dict[str, object]:
    """Counts, the counts per (op, impl), and the full failure list
    (empty ⇔ the registry conforms)."""
    counts = {"pass": 0, "fail": 0, "skip": 0}
    by_impl: Dict[str, Dict[str, int]] = {}
    for r in records:
        counts[r.status] += 1
        row = by_impl.setdefault(f"{r.op}/{r.impl}",
                                 {"pass": 0, "fail": 0, "skip": 0})
        row[r.status] += 1
    failures = [dataclasses.asdict(r) for r in records if r.status == "fail"]
    return {
        "total": len(records),
        **counts,
        "matrices": sorted({r.matrix for r in records}),
        "impl_pairs_covered": len(by_impl),
        "by_impl": dict(sorted(by_impl.items())),
        "failures": failures,
    }


def format_report(records: Sequence[ConformanceRecord]) -> str:
    """Human-readable pass/fail matrix: one row per (op, impl, precision,
    variant), one column per matrix."""
    matrices = sorted({r.matrix for r in records})
    by_key: Dict[Tuple[str, str, str, str], Dict[str, ConformanceRecord]] = {}
    for r in records:
        by_key.setdefault((r.op, r.impl, r.precision, r.variant),
                          {})[r.matrix] = r
    width = max((len(m) for m in matrices), default=8)
    lines = [" " * 44 + "".join(f"{m:>{width + 1}}" for m in matrices)]
    glyph = {"pass": "ok", "fail": "FAIL", "skip": "-"}
    for (op, impl, prec, variant) in sorted(by_key):
        tag = f"{impl}[{prec}]" + ("" if variant == "base" else f"+{variant}")
        row = f"{op:10s}{tag:34s}"
        for m in matrices:
            r = by_key[(op, impl, prec, variant)].get(m)
            cell = glyph[r.status] if r else ""
            row += f"{cell:>{width + 1}}"
        lines.append(row)
    s = summarize(records)
    lines.append(f"\n{s['pass']} pass, {s['fail']} fail, {s['skip']} skip "
                 f"over {len(matrices)} matrices x "
                 f"{s['impl_pairs_covered']} (op, impl) pairs")
    for f in s["failures"]:
        lines.append(f"  FAIL {f['matrix']} {f['op']}/{f['impl']}"
                     f"[{f['precision']}]+{f['variant']}: {f['detail']}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Harness self-test
# ---------------------------------------------------------------------------


def self_test(sample=None, device=None) -> None:
    """Prove the harness catches a wrong kernel.

    Registers a deliberately broken SpMM impl (right shape, wrong
    values), runs the harness over it on ``device``, and raises
    :class:`~repro_torch.testing.faults.FaultNotDetected` unless the run
    reports it failing.  Always deregisters the broken impl.
    """
    from repro_torch.testing.faults import FaultNotDetected

    if sample is None:
        from repro_torch.data.datasets import load_vendored

        sample = load_vendored(["tridiag_64"])[0]

    def broken_spmm(fmt, b, **kwargs):
        return torch.zeros((fmt.shape[0], b.shape[-1]), dtype=torch.float32,
                           device=b.device) + 0.125

    name = "_conformance_broken"
    _dispatch.register("spmm", name, broken_spmm)
    try:
        records = run_conformance([sample], ops=("spmm",),
                                  impl_names=[name], device=device)
        if not records:
            raise FaultNotDetected(
                "conformance harness enumerated no cases for a freshly "
                "registered impl")
        if not all(r.status == "fail" for r in records):
            raise FaultNotDetected(
                "conformance harness passed a deliberately broken SpMM "
                f"impl: {[dataclasses.asdict(r) for r in records]}")
    finally:
        _dispatch._REGISTRY.pop(("spmm", name), None)
        _dispatch._sig_cache.pop(("spmm", name), None)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.testing.conformance",
        description="Run every registered (op, impl, precision) of the "
                    "port against the dense oracle on the vendored real "
                    "matrices.")
    ap.add_argument("--datasets", default=None,
                    help="comma-separated sample names (default: all "
                         "vendored)")
    ap.add_argument("--op", choices=OPS, action="append", default=None,
                    help="restrict to an op (repeatable; default: all)")
    ap.add_argument("--impl", action="append", default=None,
                    help="restrict to an impl name (repeatable)")
    ap.add_argument("--precision", choices=("fp32", "bf16", "int8"),
                    action="append", default=None,
                    help="restrict precisions (repeatable; default: all)")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    ap.add_argument("--self-test", action="store_true",
                    help="verify the harness flags a broken impl, then exit")
    ap.add_argument("--verbose", action="store_true",
                    help="print one line per case as it runs")
    args = ap.parse_args(argv)

    if args.self_test:
        self_test(device=args.device)
        print("conformance self-test ok: broken impl reported as failing")
        return 0

    from repro_torch.data.datasets import load_vendored

    names = args.datasets.split(",") if args.datasets else None
    records = run_conformance(
        load_vendored(names), ops=tuple(args.op) if args.op else OPS,
        impl_names=args.impl, precisions=args.precision,
        verbose=args.verbose, device=args.device)
    print(format_report(records))
    return 1 if any(r.status == "fail" for r in records) else 0


if __name__ == "__main__":
    raise SystemExit(main())

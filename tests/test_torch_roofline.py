"""The port's roofline tools (``repro_torch.roofline``) against the JAX
package's (``repro.roofline``), on the CPU.

  * ``collective_bytes_from_trace`` against ``collective_bytes_from_hlo``
    on HLO lines synthesised from the same kind, dtype, shape and group
    size, for all five kinds: every entry of the two dicts within
    ``1e-12`` relative (the same formulas on the same byte counts);
  * ``RooflineReport`` at ``HW_V5E``: every property and ``to_dict``
    equal to the reference's on the same inputs (exact);
  * ``model_flops`` for all ten configurations (exact);
  * ``load``, ``dryrun_table`` and ``roofline_table`` on one JSONL ledger
    (ok, skipped and error rows, both meshes, a tag filter, a cell
    written twice): the same rows and the same markdown (exact) where the
    records name no hardware, which the reference's 16 GB reads; the
    port's own records name the H100 and read 80 GB.
"""

import json
import math

import pytest

from repro.configs import get_config as jax_config
from repro.configs import list_archs
from repro.roofline import analysis as janalysis
from repro.roofline import report as jreport
from repro_torch.configs import get_config
from repro_torch.roofline import analysis, report
from repro_torch.roofline.trace import StepTrace
from _torch_threads import one_intraop_thread  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    "error::repro_torch.core.dispatch.FallbackWarning")

_DTYPES = {"bf16": 2, "f32": 4, "s32": 4, "s8": 1, "f64": 8}
_HLO_KIND = {"all-reduce": "all-reduce", "all-gather": "all-gather",
             "reduce-scatter": "reduce-scatter", "all-to-all": "all-to-all",
             "collective-permute": "collective-permute-start"}
# (kind, dtype, result shape, group size)
CASES = [
    ("all-gather", "bf16", (16, 8192), 16),
    ("all-gather", "f32", (7, 3), 2),
    ("all-reduce", "f32", (256,), 16),
    ("all-reduce", "bf16", (4, 4, 4), 1),
    ("reduce-scatter", "f32", (64, 32), 8),
    ("reduce-scatter", "s32", (5,), 4),
    ("all-to-all", "bf16", (128, 64), 16),
    ("all-to-all", "s8", (9, 9), 2),
    ("collective-permute", "bf16", (128,), 2),
    ("collective-permute", "f64", (3, 5), 2),
]


def _hlo_line(i, kind, dtype, shape, g):
    dims = ",".join(str(d) for d in shape)
    layout = ",".join(str(d) for d in reversed(range(len(shape))))
    groups = ("source_target_pairs={{0,1},{1,0}}"
              if kind == "collective-permute"
              else f"replica_groups=[{max(256 // g, 1)},{g}]<=[256]")
    return (f"%c{i} = {dtype}[{dims}]{{{layout}}} {_HLO_KIND[kind]}(%x{i}), "
            f"channel_id={i + 1}, {groups}")


def _record(kind, dtype, shape, g):
    return (kind, float(math.prod(shape) * _DTYPES[dtype]), g)


def _same_dict(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k] == pytest.approx(w, rel=1e-12, abs=1e-12), k


@pytest.mark.parametrize("kind", analysis.COLLECTIVES)
def test_collective_bytes_match_the_hlo_parser(kind):
    cases = [c for c in CASES if c[0] == kind]
    hlo = "\n".join(["HloModule m"] + [_hlo_line(i, *c)
                                       for i, c in enumerate(cases)]
                    + ["%n = f32[10]{0} add(%a, %b)"])
    want = janalysis.collective_bytes_from_hlo(hlo)
    got = analysis.collective_bytes_from_trace([_record(*c) for c in cases])
    assert got["count"] == len(cases)
    _same_dict(got, want)


def test_collective_bytes_of_a_mixed_trace_match_the_hlo_parser():
    hlo = "\n".join(_hlo_line(i, *c) for i, c in enumerate(CASES))
    _same_dict(analysis.collective_bytes_from_trace(
        [_record(*c) for c in CASES]),
        janalysis.collective_bytes_from_hlo(hlo))
    with pytest.raises(ValueError, match="unknown collective"):
        analysis.collective_bytes_from_trace([("broadcast", 4.0, 2)])


def _reports(**over):
    kw = dict(arch="x", shape="train_4k", mesh="pod16x16", chips=256,
              per_device_flops=197e12 * 0.010, per_device_bytes=819e9 * 0.050,
              collective_naive=1e9, collective_ring=50e9 * 0.020,
              collective_count=10, peak_mem_bytes=8e9, arg_bytes=4e9,
              model_flops_total=197e12 * 0.010 * 256 * 0.5)
    kw.update(over)
    return (analysis.RooflineReport(**kw, hw=analysis.HW_V5E),
            janalysis.RooflineReport(**kw))


@pytest.mark.parametrize("over", [
    {}, {"per_device_flops": 197e12 * 0.1}, {"collective_ring": 50e9},
    {"model_flops_total": 0.0, "chips": 512}],
    ids=["memory", "compute", "collective", "no-model-flops"])
def test_report_terms_equal_the_reference(over):
    port, ref = _reports(**over)
    assert port.to_dict() == ref.to_dict()
    for prop in ("compute_s", "memory_s", "collective_s", "bottleneck",
                 "step_time_s", "useful_flops_ratio", "roofline_fraction"):
        assert getattr(port, prop) == getattr(ref, prop), prop


def test_hardware_constants():
    for f in ("peak_flops", "hbm_bw", "ici_bw", "hbm_bytes", "name"):
        assert getattr(analysis.HW_V5E, f) == getattr(janalysis.HW_V5E, f)
    h = analysis.HW_H100
    assert (h.peak_flops, h.hbm_bw, h.hbm_bytes, h.ici_bw) == (
        989e12, 3.35e12, 80e9, 450e9)
    assert analysis.RooflineReport.__dataclass_fields__["hw"].default is h


def test_model_flops_equal_for_every_config():
    for arch in list_archs():
        for tokens in (1, 4096, 256 * 4096):
            assert analysis.model_flops(get_config(arch), tokens) == \
                janalysis.model_flops(jax_config(arch), tokens), arch


def test_analyze_trace_reads_the_trace():
    trace = StepTrace(
        flops=3e12, bytes_accessed=2e10,
        collectives=[("all-gather", 1.6e9, 16), ("all-reduce", 4e6, 16),
                     ("reduce-scatter", 1e8, 16)],
        memory={"argument_bytes": 10, "output_bytes": 7, "temp_bytes": 20,
                "alias_bytes": 6},
        ops={}, seconds=0.0)
    r = analysis.analyze_trace(trace, arch="a", shape="s", mesh_name="m",
                               chips=256, mflops=1e15)
    coll = analysis.collective_bytes_from_trace(trace.collectives)
    assert r.hw is analysis.HW_H100
    assert (r.per_device_flops, r.per_device_bytes) == (3e12, 2e10)
    assert (r.collective_ring, r.collective_naive, r.collective_count) == (
        coll["ring"], coll["naive"], 3)
    assert (r.peak_mem_bytes, r.arg_bytes) == (10 + 7 + 20 - 6, 10)
    assert r.compute_s == 3e12 / 989e12


def _ledger(path, hw=None):
    def ok(arch, shape, mesh, tag="baseline", flops=1e12, temp=3e9):
        r = _reports(per_device_flops=flops)[1].to_dict()
        r.update(arch=arch, shape=shape, mesh=mesh)
        rec = {"arch": arch, "shape": shape, "mesh": mesh, "tag": tag,
               "status": "ok", "compile_s": 12.3,
               "memory": {"argument_bytes": 5e9, "output_bytes": 5e9,
                          "temp_bytes": temp, "alias_bytes": 4.9e9},
               "roofline": r, "wall_s": 13.0}
        return rec

    rows = [
        ok("qwen3-0.6b", "train_4k", "pod16x16"),
        ok("qwen3-0.6b", "train_4k", "pod2x16x16"),
        ok("yi-9b", "prefill_32k", "pod16x16", flops=1e14, temp=2e10),
        ok("yi-9b", "prefill_32k", "pod16x16", tag="hillclimb"),
        {"arch": "yi-9b", "shape": "long_500k", "mesh": "pod16x16",
         "tag": "baseline", "status": "skipped",
         "reason": "full quadratic attention at 524288 would be O(S^2); "
                   "skipped per brief (pure full-attention arch)",
         "wall_s": 0.0},
        {"arch": "granite-8b", "shape": "decode_32k", "mesh": "pod16x16",
         "tag": "baseline", "status": "error",
         "error": "RuntimeError: " + "x" * 80, "wall_s": 1.0},
        ok("granite-8b", "train_4k", "pod16x16", flops=5e13),
        ok("granite-8b", "train_4k", "pod16x16", flops=2e12),  # last wins
    ]
    with open(path, "w") as f:
        for r in rows:
            if hw:
                r = dict(r, hw=hw)
            f.write(json.dumps(r) + "\n")
        f.write("not json\n")


def test_tables_equal_the_reference_on_a_fixed_ledger(tmp_path, capsys):
    path = str(tmp_path / "dryrun.jsonl")
    _ledger(path)
    for tag in ("baseline", "hillclimb"):
        rows, ref_rows = report.load(path, tag), jreport.load(path, tag)
        assert rows == ref_rows
        assert report.dryrun_table(rows) == jreport.dryrun_table(ref_rows)
        assert report.roofline_table(rows) == jreport.roofline_table(ref_rows)
    rows = report.load(path)
    assert [r["roofline"]["per_device_flops"] for r in rows
            if r["arch"] == "granite-8b" and r["status"] == "ok"] == [2e12]
    table = report.dryrun_table(rows)
    assert "fits 16 GB" in table and "NO (20 GB)" in table
    assert report.main([path]) == 0
    port_out = capsys.readouterr().out
    assert jreport.main([path]) == 0
    assert port_out == capsys.readouterr().out


def test_h100_records_read_80_gb(tmp_path):
    path = str(tmp_path / "dryrun.jsonl")
    _ledger(path, hw=analysis.HW_H100.name)
    table = report.dryrun_table(report.load(path))
    assert "fits 80 GB" in table and "NO (" not in table
    assert "| yi-9b | prefill_32k | pod16x16 | ok | 12 | 20.10 | yes |" \
        in table
    assert "tensor-core-bound" in report.roofline_table(report.load(path))

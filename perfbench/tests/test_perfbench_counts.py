"""The yardstick against hand counts on a 16-node graph, the metric
readers on a made-up trace, and the kernel names."""

import dataclasses

import numpy as np

import pytest

from conftest import ROOT
from perfbench import counts, graphs, harness, trace

N, NNZ = 16, 40


def test_spmm_counts_by_hand():
    op = {"op": "spmm", "width": 8}
    # ids 40*4 + row pointers 17*4 + values 40*4 + B 16*8*4 + C 16*8*4
    assert counts.op_bytes(op, N, NNZ, "float32") == 160 + 68 + 160 + 512 + 512
    assert counts.op_flops(op, NNZ) == 2 * 40 * 8


def test_sddmm_and_attention_counts_by_hand():
    sddmm = {"op": "sddmm", "width": 4}
    # ids, row pointers, Q and K 16*4*4 each, 40 values out
    assert counts.op_bytes(sddmm, N, NNZ, "float32") == 160 + 68 + 512 + 160
    assert counts.op_flops(sddmm, NNZ) == 2 * 40 * 4
    att = {"op": "attention", "width": 4, "value_width": 2}
    # ids, row pointers, Q = K once (16*4*4), V in and O out (16*2*4 each)
    assert counts.op_bytes(att, N, NNZ, "float32") == 160 + 68 + 256 + 256
    assert counts.op_flops(att, NNZ) == 2 * 40 * (4 + 2)


def test_bound_is_the_larger_term():
    t, what = counts.bound(3.35e9, 1, 67e12)
    assert what == "bytes" and t == pytest.approx(1.0)
    t, what = counts.bound(1, 67e9, 67e12)
    assert what == "operations" and t == pytest.approx(1.0)


def test_model_counts_by_hand():
    gcn = harness.load_cell(ROOT, "gcn-amazon-replica-f32")
    ops = gcn.model().sparse_ops(gcn.config)
    assert len(ops) == 9 and {o["width"] for o in ops} == {128}
    # layers 1-4: 128x128, layer 5: 128x16; forward and weight gradient
    # everywhere, input gradient but in the first layer
    per = 2 * N * 128 * 128
    assert gcn.model().dense_flops(gcn.config, N) == (
        2 * per + 3 * 3 * per + 3 * 2 * N * 128 * 16)
    agnn = harness.load_cell(ROOT, "agnn-amazon-replica-f32")
    ops = agnn.model().sparse_ops(agnn.config)
    assert [o["op"] for o in ops].count("attention") == 5
    assert [o["op"] for o in ops].count("spmm") == 15
    assert agnn.model().dense_flops(agnn.config, N) == (
        2 * 2 * N * 128 * 32 + 3 * 2 * N * 32 * 16)


def test_kernel_names():
    assert trace.kernel_base_name(
        "void repro::spmm_window_kernel<8, true, float>(repro::WindowArgs<"
        "float, float, float>)") == "spmm_window_kernel"
    assert trace.kernel_base_name("sm80_xmma_gemm_f32f32_nn") == \
        "sm80_xmma_gemm_f32f32_nn"
    names = trace.port_kernel_names(ROOT / "src/repro_torch/kernels/csrc")
    assert {"spmm_window_kernel", "attention_kernel", "sddmm_tile_kernel",
            "spmm_run_kernel", "attention_run_kernel"} <= names


def _record(cell, trace_summary):
    graph = graphs.Graph("hand", N, np.zeros(NNZ, np.int32),
                         np.zeros(NNZ, np.int32), np.ones(NNZ, np.float32))
    return harness.RunRecord(cell, cell.model().step_counts(cell, graph),
                             setup_s=3.0, steps=4,
                             window_s=0.04, step_gaps_ms=[10.0] * 4,
                             window_peak_bytes=2**30, host_step_ms=[2.0, 4.0],
                             trace=trace_summary,
                             port_kernels=frozenset({"spmm_window_kernel"}))


def test_metric_readers_on_a_made_up_run():
    cell = harness.load_cell(ROOT, "gcn-amazon-replica-f32")
    t = trace.TraceSummary(
        steps=2, window_s=0.025, busy_s=0.02,
        ops=[("void repro::spmm_window_kernel<8>(A)", 0.012, 18),
             ("sm80_xmma_gemm", 0.008, 30)], idle_by_host=[])
    run = _record(cell, t)
    read = {m["name"]: cell.metric(m).read(run)
            for m in cell.end_to_end + cell.per_layer}
    assert read["epoch_ms"] == pytest.approx(10.0)
    assert read["epoch_ms_p95"] == pytest.approx(10.0)
    assert read["peak_mem_gib"] == pytest.approx(1.0)
    assert read["host_ms_per_step"] == pytest.approx(3.0)
    assert read["sparse_device_ms"] == pytest.approx(6.0)
    assert read["dense_device_ms"] == pytest.approx(4.0)
    assert read["device_idle"] == pytest.approx(20.0)
    ops = cell.model().sparse_ops(cell.config)
    least = counts.least_ms(ops, N, NNZ, "float32")
    assert read["sparse_roofline"] == pytest.approx(100 * least / 6.0)
    flops = cell.model().dense_flops(cell.config, N) + 9 * 2 * NNZ * 128
    assert read["step_mfu"] == pytest.approx(100 * flops / 0.01 / 67e12)


def test_readers_give_nothing_without_a_device_trace():
    cell = harness.load_cell(ROOT, "gcn-amazon-replica-f32")
    empty = trace.TraceSummary(steps=2, window_s=0.1, busy_s=0.0, ops=[],
                               idle_by_host=[])
    run = dataclasses.replace(_record(cell, empty), window_peak_bytes=0)
    for name in ("dense_device_ms", "sparse_device_ms", "sparse_roofline",
                 "device_idle", "peak_mem_gib"):
        assert cell.metric({"name": name}).read(run) is None

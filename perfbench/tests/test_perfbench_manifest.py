"""BENCHMARK.json against the benchmark's contract, and every piece it
names found by its name; a new cell is found without an edit."""

import json
import re

import pytest
import torch

from conftest import ROOT, add_cell, copy_benchmark
from perfbench import harness

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "perfbench/run.py"]
    assert MANIFEST["paths"] == ["perfbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in MANIFEST[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in MANIFEST["workloads"]} == {
        c["name"] for c in MANIFEST["configs"]}


def test_metrics_entries():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert set(e2e) == {"epoch_ms", "peak_mem_gib", "setup_s"}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    per = {m["name"]: m for m in MANIFEST["per_layer"]}
    assert set(per) == {"step_mfu", "epoch_ms_p95", "host_ms_per_step",
                        "dense_device_ms", "sparse_device_ms",
                        "sparse_roofline", "device_idle"}
    for m in per.values():
        assert m["moves"] == "epoch_ms" and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in list(e2e.values()) + list(per.values()):
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_configs_files():
    for c in MANIFEST["configs"]:
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert (ROOT / "perfbench" / "models" / f"{cfg['model']}.py").exists()


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = harness.load_cell(ROOT, cell)
    assert c.traffic["dtype"] == "float32"
    assert c.limits and set(c.limits) <= {"loss_gap", "grad_gap",
                                         "grad_group_gap", "change_gap"}
    assert c.end_to_end and c.per_layer
    for entry in c.end_to_end + c.per_layer:
        assert callable(c.metric(entry).read)
    model = c.model()
    assert model.sparse_ops(c.config) and model.dense_flops(c.config, 16) > 0
    w = model.init_weights(c.config, torch.Generator().manual_seed(1), "cpu")
    assert all(t.dtype == torch.float32 for t in w.values())


def test_unknown_cell_names_the_known_ones():
    with pytest.raises(KeyError, match="gcn-amazon-replica-f32"):
        harness.load_cell(ROOT, "no-such-cell")


def test_new_cell_is_found_without_an_edit(tmp_path):
    """A cell added as a new traffic file, a limits file and an entry:
    the harness finds it and its metrics by name."""
    root = copy_benchmark(tmp_path)
    traffic = json.loads((root / "perfbench/traffic/amazon-replica-f32.json")
                         .read_text())
    traffic["route"] = "cuda_balanced"
    (root / "perfbench/traffic/amazon-replica-f32-balanced.json").write_text(
        json.dumps(traffic))
    add_cell(root, "gcn-amazon-balanced-f32", "gcn-5l-h128",
             "amazon-replica-f32-balanced", "gcn-amazon-replica-f32")
    cell = harness.load_cell(root, "gcn-amazon-balanced-f32")
    assert cell.traffic["route"] == "cuda_balanced"
    assert [m["name"] for m in cell.per_layer] == [
        m["name"] for m in MANIFEST["per_layer"]]

"""The comparison that decides ``correct``, driven on the CPU at a tiny
size past the look for a card: sound runs pass; the control (the
reference at the next precision down) and each fault a training cell
can have, planted under the timed path, fail.  Readings of the same at
the cells' own sizes come from ``perfbench/calibrate.py`` on the card.
"""

import time

import pytest
import torch

from perfbench import harness
from perfbench.calibrate import CONTROL

CPU = torch.device("cpu")
CELLS = ["gcn-tiny", "agnn-tiny"]


def _run(root, name, seed=11):
    cell = harness.load_cell(root, name)
    return harness.run_cell(cell, seed, 0.5, False, [CPU],
                            time.perf_counter(), log=lambda s: None)


def _failed(checks):
    return [k for k, c in checks.items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny_root, name):
    r = _run(tiny_root, name)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-2:] == ["checks", "numbers"]
    assert r["setup_parts"]["checked_steps_s"] > 0
    assert {"epoch_ms", "setup_s"} <= set(r["metrics"])


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny_root, name):
    """The reference at the control's precision in the program's place."""
    cell = harness.load_cell(tiny_root, name)
    kind = cell.model()
    graph, _ = kind.load_traffic(cell, tiny_root / "build" / "perfbench"
                                 / "graphs")
    inputs = kind.make_inputs(cell, graph, 11, [CPU])
    ref = kind.reference_readings(cell, graph, inputs, [CPU])
    ctrl = kind.reference_readings(cell, graph, inputs, [CPU],
                                   rounding=CONTROL)
    numbers = harness.compare(ctrl, ref)
    assert any(numbers[k] > lim for k, lim in cell.limits.items()), numbers


@pytest.mark.parametrize("name", CELLS)
def test_state_left_unchanged_is_not_correct(tiny_root, name, monkeypatch):
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None: None)
    r = _run(tiny_root, name)
    assert not r["correct"]
    assert any(k.startswith("change") for k in _failed(r["checks"]))


@pytest.mark.parametrize("name", CELLS)
def test_half_the_batch_left_out_is_not_correct(tiny_root, name,
                                                monkeypatch):
    import repro_torch.models.gnn as gnn

    full = gnn.gnn_loss

    def half(params, adj, x, labels, train_mask, cfg):
        kept = train_mask.clone()
        kept[kept.shape[0] // 2:] = 0
        return full(params, adj, x, labels, kept, cfg)

    monkeypatch.setattr(gnn, "gnn_loss", half)
    r = _run(tiny_root, name)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_non_finite_steps_are_failed(tiny_root, name, monkeypatch):
    """A window step whose loss is not finite counts as failed."""
    import repro_torch.models.gnn as gnn

    full = gnn.gnn_loss
    calls = {"n": 0}

    def late_nan(*args):
        calls["n"] += 1
        loss, acc = full(*args)
        return (loss * float("nan") if calls["n"] > 5 else loss), acc

    monkeypatch.setattr(gnn, "gnn_loss", late_nan)
    r = _run(tiny_root, name)
    assert r["failed"] >= 1 and not r["correct"]


@pytest.mark.gpu
def test_cell_on_the_card(tmp_path):
    """One short run of the first cell through ``run.py`` on the card."""
    import json
    import subprocess
    import sys

    from conftest import ROOT

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "gcn-amazon-replica-f32", "--seed", "7", "--seconds", "2",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


def _readings(grads, changes, starts, sizes, lr=0.01):
    return {"losses": [1.0, 0.9, 0.8], "grad_norms": dict(grads),
            "change_norms": dict(changes), "start_norms": dict(starts),
            "sizes": dict(sizes), "lr": lr}


AGNN_LIKE = dict(
    grads={"w_in": 0.6, "beta.0": 8e-4, "beta.1": 4e-4, "beta.2": 6e-5,
           "beta.3": 4e-6, "beta.4": 3e-8, "w_out": 0.57},
    changes={"w_in": 0.034, "beta.0": 3.8e-5, "beta.1": 2.2e-5,
             "beta.2": 3.4e-6, "beta.3": 2e-7, "beta.4": 1.6e-9,
             "w_out": 0.031},
    starts={"w_in": 7.2, "w_out": 4.6, **{f"beta.{k}": 1.0 for k in range(5)}},
    sizes={"w_in": 4096, "w_out": 512, **{f"beta.{k}": 1 for k in range(5)}})


def test_a_wrong_beta_gradient_shows_in_its_group():
    """AGNN's β leaves are the median leaf, so ``grad_gap`` divides their
    gaps by a β's own small norm; ``grad_group_gap`` holds the five as
    one leaf against their own norm, and a β gradient that is off shows."""
    ref = _readings(**AGNN_LIKE)
    prog = _readings(**AGNN_LIKE)
    assert harness.compare(prog, ref)["grad_group_gap"] == 0.0
    prog["grad_norms"]["beta.0"] *= 2
    assert harness.compare(prog, ref)["grad_group_gap"] > 0.5


def test_the_change_leaves_out_leaves_the_state_cannot_resolve():
    """β = 1 moves by a few float32 ulps a step: its change is left out;
    the weights' changes count."""
    ref = _readings(**AGNN_LIKE)
    prog = _readings(**AGNN_LIKE)
    for k in range(5):              # β's change off by rounding alone
        prog["change_norms"][f"beta.{k}"] *= 1.5
    assert harness.compare(prog, ref)["change_gap"] == 0.0
    prog["change_norms"]["w_out"] *= 1.01
    assert harness.compare(prog, ref)["change_gap"] == pytest.approx(
        0.01 * 0.031 / 0.0325)


def test_the_gnn_family_runs_on_one_card(tiny_root):
    cell = harness.load_cell(tiny_root, "gcn-tiny")
    with pytest.raises(ValueError, match="one card"):
        cell.model().make_inputs(cell, None, 1, [CPU, CPU])

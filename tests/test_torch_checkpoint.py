"""The port's checkpoint store (``repro_torch.train.checkpoint``) on the
CPU, and against the JAX package's (``repro.train.checkpoint``).

Round trips are bitwise for fp32, bf16, int8 and int32 leaves; the
manager keeps the newest ``keep_n`` complete steps, ignores a step
directory without its manifest and a staging directory, writes
asynchronously, and raises where no checkpoint exists.  A directory that
JAX's ``save_pytree`` wrote is read by the port bitwise, and the reverse,
on a train state of the reduced qwen3 in the stacked layout.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.train import checkpoint as jck
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import configs as tcfg
from repro_torch.train import checkpoint as tck
from repro_torch.pytree import leaf_paths
from repro_torch.train.train_step import train_state_from_jax
from _torch_threads import one_intraop_thread  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    "error::repro_torch.core.dispatch.FallbackWarning")


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 16), generator=g).to(torch.bfloat16),
                   "b": torch.arange(16, dtype=torch.float32),
                   "layers": {"norm": torch.randn((2, 16), generator=g)}},
        "opt": {"m": torch.randint(-127, 128, (8, 16), generator=g,
                                   dtype=torch.int8),
                "m_scale": None,
                "count": torch.tensor(3, dtype=torch.int32)},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def _assert_bitwise(got, want):
    got_l, want_l = leaf_paths(got), leaf_paths(want)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, g), (_, w) in zip(got_l, want_l):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert np.array_equal(_bits(g), _bits(w)), path


def test_roundtrip_is_bitwise(tmp_path):
    state = _state()
    tck.save_pytree(state, str(tmp_path / "ck"))
    restored = tck.load_pytree(str(tmp_path / "ck"), state)
    _assert_bitwise(restored, state)
    assert restored["opt"]["m_scale"] is None
    manifest = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    assert manifest["params/w"]["dtype"] == "bfloat16"
    assert manifest["opt/m"]["dtype"] == "int8"
    assert manifest["step"] == {"file": manifest["step"]["file"],
                                "dtype": "int32", "shape": []}
    assert "opt/m_scale" not in manifest


def test_latest_and_prune(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path), keep_n=2)
    for step in (10, 20, 30):
        mgr.save(_state(step), step)
    assert mgr.all_steps() == [20, 30]
    state, step = mgr.restore(_state())
    assert step == 30
    _assert_bitwise(state, _state(30))
    state, step = mgr.restore(_state(), step=20)
    _assert_bitwise(state, _state(20))


def test_incomplete_step_is_ignored(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path))
    mgr.save(_state(1), 5)
    os.makedirs(tmp_path / "step_0000000009")      # no manifest: a crash
    os.makedirs(tmp_path / ".tmp-12")              # a write never moved in
    assert mgr.latest_step() == 5
    _, step = mgr.restore(_state())
    assert step == 5


def test_async_save_copies_before_training_moves_on(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path))
    state = _state(2)
    want = {"params": {k: v.clone() for k, v in
                       state["params"].items() if k != "layers"}}
    mgr.save_async(state, 1)
    state["params"]["w"].add_(1)                   # an in-place update
    state["params"]["b"].zero_()
    mgr.wait()
    got = tck.load_pytree(str(tmp_path / "step_0000000001"),
                          {"params": {"w": state["params"]["w"],
                                      "b": state["params"]["b"]}})
    _assert_bitwise(got, want)


def test_missing_checkpoint_raises(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state())
    mgr.save({"a": torch.zeros(2)}, 1)
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore({"a": torch.zeros(2), "b": torch.zeros(2)})


@pytest.fixture(scope="module")
def jax_state():
    """A reduced-qwen3 train state of the JAX package at bf16 with the
    8-bit moments (every dtype the store holds), moved off its zeros."""
    cfg = jcfg.get_reduced("qwen3-0.6b", dtype=jnp.bfloat16)
    ts = jts.TrainStepConfig(opt=jopt.AdamWConfig(quantize_state=True))
    state = jts.init_train_state(jax.random.key(0), cfg, ts)
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda a: np.asarray(a) if a.dtype != jnp.float32 or a.ndim == 0
        else rng.standard_normal(a.shape).astype(np.float32), state)


def test_port_reads_what_jax_wrote(tmp_path, jax_state):
    jck.save_pytree(jax_state, str(tmp_path))
    cfg = tcfg.get_reduced("qwen3-0.6b", dtype=torch.bfloat16)
    like = train_state_from_jax(cfg, jax_state, device="cpu")
    got = tck.load_pytree(str(tmp_path), like)
    _assert_bitwise(got, like)
    assert got["params"]["embed"].dtype == torch.bfloat16
    assert got["opt"]["m"]["layers"]["attn"]["wq"].dtype == torch.int8


def test_jax_reads_what_the_port_wrote(tmp_path, jax_state):
    cfg = tcfg.get_reduced("qwen3-0.6b", dtype=torch.bfloat16)
    state = train_state_from_jax(cfg, jax_state, device="cpu")
    tck.save_pytree(state, str(tmp_path))
    got = jck.load_pytree(str(tmp_path), jax_state)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(jax_state)
    assert len(flat_got) == len(flat_want)
    for (path, g), (_, w) in zip(flat_got, flat_want):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert g.tobytes() == w.tobytes(), path
    assert got["params"]["embed"].dtype == ml_dtypes.bfloat16
    # the same manifest paths, files and order as JAX's own save
    jck.save_pytree(jax_state, str(tmp_path / "jax"))
    assert json.loads((tmp_path / "manifest.json").read_text()) == \
        json.loads((tmp_path / "jax" / "manifest.json").read_text())

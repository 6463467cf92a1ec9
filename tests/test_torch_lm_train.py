"""LM training in the port (``lm_loss``, ``repro_torch.train.train_step``,
``repro_torch.launch.train``) against the JAX package's on the CPU.

Every family at ``get_reduced`` size, the reference's weights and train
states carried across leaf for leaf (``train_state_from_jax``), batches
from the synthetic pipeline (bitwise the same on both sides).

Tolerances:
  * ``lm_loss``: ``rtol=1e-5``; every gradient leaf within ``1e-5 x`` the
    model's largest gradient entry (fp32 sums in another order; a leaf
    whose gradients cancel has no scale of its own).
  * one ``train_step`` from the reference's state: ``loss`` and
    ``grad_norm`` ``rtol=1e-5``; parameters ``rtol=1e-5`` (plus ``1e-4``
    of a step, ``lr``, for results that cancel to near 0: the update of
    an entry whose gradient is ``1e-4`` of the leaf's largest carries
    that gradient's rounding) where the gradient is above ``1e-4 x``
    the leaf's largest, and within ``2 lr``
    everywhere: Adam's update is about ``+-lr`` for any gradient well
    above eps, so an entry whose gradient is within rounding of 0 may
    step the other way.
  * under int8 compression or 8-bit moments the gradients agree only to
    rounding, so an int8 code may round one step apart: codes are held
    within one step, scales ``rtol=1e-5``, the int8 error buffers within
    one quantization step of the leaf's largest block (top-k's within
    ``1e-5 x`` the leaf's largest corrected gradient), and the parameters within ``2 lr``
    (int8: everywhere; 8-bit moments: where the gradient is above
    ``1e-4 x`` the leaf's largest, since an entry whose second moment
    rounds to code 0 takes the step ``m / (sqrt(1 - b2) |g|)``, as large
    as the rounding of its near-zero gradient makes it, in the
    reference's arithmetic as in the port's).  Top-k selects the same
    entries and is held as the plain step.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import lm as jlm
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import configs as tcfg
from repro_torch.data.synthetic import SyntheticLMData, make_batch
from repro_torch.launch import train as launch_train
from repro_torch.models import lm as tlm
from repro_torch.train import compression as tcomp
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from repro_torch.pytree import leaf_paths, tree_map
from _torch_threads import one_intraop_thread  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    "error::repro_torch.core.dispatch.FallbackWarning")

FAMILIES = {
    "dense": "qwen3-0.6b",           # GQA + qk_norm + tied embeddings
    "moe": "moonshot-v1-16b-a3b",    # GQA + MoE with shared experts
    "mla": "deepseek-v3-671b",       # MLA + MoE
    "ssm": "mamba2-2.7b",
    "hybrid": "zamba2-1.2b",
    "encdec": "seamless-m4t-medium",
    "vlm": "internvl2-76b",          # with its stub patch prefix
}
RTOL = 1e-5
GRAD_ATOL = 1e-5            # of the model's largest gradient entry
LR = 1e-3
B, T = 4, 16


def to_np(tree):
    return jax.tree.map(lambda a: None if a is None else np.asarray(a), tree)


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat(tree):
    return dict(leaf_paths(to_np(tree)))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_lm_loss_and_gradients_match_jax(family):
    arch = FAMILIES[family]
    cfg_j, cfg_t = jcfg.get_reduced(arch), tcfg.get_reduced(arch)
    params = to_np(jlm.init_lm(jax.random.key(0), cfg_j))
    batch = make_batch(cfg_t, 2, T, step=0, seed=1)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.lm_loss(p, b, cfg_j), has_aux=True))
    (loss_j, parts_j), grads_j = fn(params, _jax_batch(batch))

    params_t = tts.train_state_from_jax(cfg_t, {"params": params},
                                        device="cpu")["params"]
    loss_t, parts_t, grads_t = tts.accumulate_grads(
        cfg_t, tts.TrainStepConfig(), params_t, _torch_batch(batch))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=RTOL)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(float(parts_t[key]), float(parts_j[key]),
                                   rtol=RTOL, atol=1e-7)
    want = _flat(grads_j)
    top = max(float(np.abs(g).max()) for g in want.values())
    got = leaf_paths(grads_t)
    assert sorted(p for p, _ in got) == sorted(want)
    for path, g in got:
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), path
        np.testing.assert_allclose(g.numpy(), want[path], rtol=0,
                                   atol=GRAD_ATOL * top, err_msg=path)
    # the direct call, on the per-layer lists of init_lm's layout
    listed = tlm.unstack_layers(params_t)
    assert isinstance(listed["layers"], list)
    total, _ = tlm.lm_loss(listed, _torch_batch(batch), cfg_t)
    np.testing.assert_allclose(float(total), float(loss_j), rtol=RTOL)


def test_moe_aux_is_positive_and_weighted():
    cfg = tcfg.get_reduced("moonshot-v1-16b-a3b")
    params = tlm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _torch_batch(make_batch(cfg, 2, T))
    total, parts = tlm.lm_loss(params, batch, cfg, aux_weight=0.5)
    assert float(parts["aux"]) > 0
    np.testing.assert_allclose(float(total),
                               float(parts["ce"] + 0.5 * parts["aux"]),
                               rtol=1e-6)


def _configs(kind="none", quantize=False):
    """The same train-step configuration in both packages."""
    kw = dict(lr=LR, warmup_steps=2, quantize_state=quantize)
    return (jts.TrainStepConfig(opt=jopt.AdamWConfig(**kw),
                                compression=jcomp.CompressionConfig(kind=kind)),
            tts.TrainStepConfig(opt=topt.AdamWConfig(**kw),
                                compression=tcomp.CompressionConfig(kind=kind)))


_CFG_J = jcfg.get_reduced("qwen3-0.6b")
# the reference's gradient at a state (for the tolerances), compiled once
_GRAD_J = jax.jit(jax.grad(lambda p, b: jlm.lm_loss(p, b, _CFG_J)[0]))


def _jax_run(ts_j, steps):
    """The reduced qwen3's reference states before each of ``steps``
    steps, its gradients there, and its state and metrics after each."""
    cfg = _CFG_J
    step = jax.jit(jts.make_train_step(cfg, ts_j))
    grad = _GRAD_J
    data = SyntheticLMData(tcfg.get_reduced("qwen3-0.6b"), B, T, seed=0)
    state = jts.init_train_state(jax.random.key(0), cfg, ts_j)
    runs = []
    for i in range(steps):
        batch = data.batch(i)
        before = to_np(state)
        g = to_np(grad(state["params"], _jax_batch(batch)))
        state, metrics = step(state, _jax_batch(batch))
        runs.append((before, batch, g, to_np(state), to_np(metrics)))
    return runs


@pytest.fixture(scope="module")
def plain_run():
    return _jax_run(_configs()[0], 3)


def _port_step(run, ts_t):
    before, batch, _, _, _ = run
    cfg = tcfg.get_reduced("qwen3-0.6b")
    state = tts.train_state_from_jax(cfg, before, device="cpu")
    return tts.make_train_step(cfg, ts_t)(state, _torch_batch(batch))


def _check_params(port, run, label, close=True, everywhere=True):
    """The tolerances of the module docstring for the parameters:
    ``close`` holds the strong-gradient entries at ``rtol``, and
    ``everywhere`` holds every entry (else only those) within ``2 lr``."""
    _, _, grads, after, _ = run
    want, g = _flat(after["params"]), _flat(grads)
    for path, p in leaf_paths(port):
        w = want[path]
        strong = np.abs(g[path]) > 1e-4 * np.abs(g[path]).max()
        got = p.numpy()
        held = slice(None) if everywhere else strong
        np.testing.assert_allclose(got[held], w[held], rtol=0, atol=2 * LR,
                                   err_msg=f"{label} {path}")
        if close:
            np.testing.assert_allclose(got[strong], w[strong], rtol=RTOL,
                                       atol=1e-4 * LR,
                                       err_msg=f"{label} {path} (|g| large)")


@pytest.mark.parametrize("step", [0, 1, 2])
def test_train_step_from_the_reference_state(plain_run, step):
    run = plain_run[step]
    state, metrics = _port_step(run, _configs()[1])
    want = run[4]
    for key in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[key]), float(want[key]),
                                   rtol=RTOL, err_msg=key)
    assert int(state["step"]) == int(run[3]["step"]) == step + 1
    assert int(state["opt"]["count"]) == step + 1
    _check_params(state["params"], run, f"step {step}")


@pytest.mark.parametrize("kind,quantize", [("int8", False), ("topk", False),
                                           ("none", True)],
                         ids=["int8", "topk", "8bit-state"])
def test_compressed_and_8bit_steps_from_the_reference_state(kind, quantize):
    """One step from the reference's state after one step (so the error
    buffers and moments are not zero)."""
    ts_j, ts_t = _configs(kind, quantize)
    run = _jax_run(ts_j, 2)[1]
    state, metrics = _port_step(run, ts_t)
    want = run[4]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]), float(want[key]),
                                   rtol=RTOL, err_msg=key)
    _check_params(state["params"], run, kind, close=kind == "topk",
                  everywhere=not quantize)
    after = run[3]
    if quantize:
        for key in ("m", "v"):
            codes, ref = _flat(state["opt"][key]), _flat(after["opt"][key])
            for path, q in codes.items():
                assert q.dtype == np.int8, path
                assert np.abs(q.astype(int) - ref[path].astype(int)).max() \
                    <= 1, f"{key} {path}"
            for path, s in _flat(state["opt"][f"{key}_scale"]).items():
                np.testing.assert_allclose(
                    s, _flat(after["opt"][f"{key}_scale"])[path], rtol=RTOL,
                    err_msg=f"{key}_scale {path}")
    else:
        err, ref = _flat(state["err"]), _flat(after["err"])
        grads, prev = _flat(run[2]), _flat(run[0]["err"])
        for path, e in err.items():
            top = np.abs(grads[path] + prev[path]).max()
            # int8: one code step of the leaf's largest block scale; top-k:
            # the dropped entries are the gradients, held as above
            tol = 1.01 * top / 127.0 if kind == "int8" else GRAD_ATOL * top
            np.testing.assert_allclose(e, ref[path], rtol=0, atol=tol,
                                       err_msg=f"err {path}")


def _state(cfg, ts, seed=0):
    return tts.init_train_state(cfg, ts, torch.Generator().manual_seed(seed),
                                device="cpu")


def test_microbatches_and_remat_give_the_same_gradients():
    """Four microbatches against one, and remat on against off: every
    gradient leaf within ``1e-5 x`` the largest."""
    cfg = tcfg.get_reduced("qwen3-0.6b")
    assert cfg.remat
    params = _state(cfg, tts.TrainStepConfig())["params"]
    batch = _torch_batch(make_batch(cfg, 8, T))
    runs = {}
    for name, c, mb in (("remat", cfg, 1), ("mb4", cfg, 4),
                        ("no-remat", dataclasses.replace(cfg, remat=False),
                         1)):
        runs[name] = tts.accumulate_grads(
            c, tts.TrainStepConfig(microbatches=mb), params, batch)
    ref_loss, _, ref = runs["remat"]
    top = max(float(g.abs().max()) for _, g in leaf_paths(ref))
    for name in ("mb4", "no-remat"):
        loss, _, grads = runs[name]
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=RTOL)
        for (path, g), (_, r) in zip(leaf_paths(grads), leaf_paths(ref)):
            torch.testing.assert_close(g, r, rtol=0, atol=GRAD_ATOL * top,
                                       msg=f"{name} {path}")


def test_remat_checkpoints_each_layer_or_period(monkeypatch):
    """Under grad, one checkpoint per layer (per period of the hybrid
    stack, as the reference's); none without grad or without remat."""
    import torch.utils.checkpoint as tuc

    calls = []
    real = tuc.checkpoint

    def counting(fn, *args, **kw):
        calls.append(kw)
        return real(fn, *args, **kw)

    monkeypatch.setattr(tuc, "checkpoint", counting)
    for arch, want in (("qwen3-0.6b", 2), ("zamba2-1.2b", 1),
                       ("seamless-m4t-medium", 4)):
        cfg = tcfg.get_reduced(arch)
        params = tree_map(lambda t: t.requires_grad_(), tlm.init_lm(
            cfg, torch.Generator().manual_seed(0), "cpu"))
        batch = _torch_batch(make_batch(cfg, 1, 8))
        calls.clear()
        tlm.lm_loss(params, batch, cfg)[0].backward()
        assert len(calls) == want, arch
        assert all(kw["use_reentrant"] is False for kw in calls)
        calls.clear()
        with torch.no_grad():
            tlm.lm_loss(params, batch, cfg)
        tlm.lm_loss(params, batch, dataclasses.replace(cfg, remat=False))
        assert not calls, arch


@pytest.mark.parametrize("kind", ["none", "int8"])
def test_loss_falls_over_twenty_steps(kind):
    """The reference's loss-curve test: 20 steps, 2 microbatches."""
    cfg = tcfg.get_reduced("qwen3-0.6b")
    ts = tts.TrainStepConfig(
        opt=topt.AdamWConfig(lr=1e-3, warmup_steps=5), microbatches=2,
        compression=tcomp.CompressionConfig(kind=kind, block=128))
    state = _state(cfg, ts)
    step = tts.make_train_step(cfg, ts)
    data = SyntheticLMData(cfg, 8, 32, seed=0)
    losses = []
    for i in range(20):
        state, metrics = step(state, _torch_batch(data.batch(i)))
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert int(state["step"]) == 20


def test_train_state_tree_matches_the_reference():
    """``init_train_state``'s tree, shapes and dtypes against the
    reference's, every family, with compression and 8-bit moments."""
    ts_j, ts_t = _configs("int8", True)
    for arch in FAMILIES.values():
        ref = jax.eval_shape(lambda: jts.init_train_state(
            jax.random.key(0), jcfg.get_reduced(arch), ts_j))
        want = dict(leaf_paths(ref))
        got = dict(leaf_paths(_state(tcfg.get_reduced(arch), ts_t)))
        assert sorted(got) == sorted(want), arch
        for path, t in got.items():
            assert tuple(t.shape) == tuple(want[path].shape), (arch, path)
            assert str(t.dtype).removeprefix("torch.") == \
                want[path].dtype.name, (arch, path)


def test_cli_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    """``--steps 4`` with a checkpoint directory, then ``--steps 6``
    resumes at 4 and gives the uninterrupted run's losses."""
    base = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
            "--batch", "4", "--seq", "32", "--log-every", "1"]
    ck = str(tmp_path / "ck")
    assert launch_train.main(base + ["--steps", "4", "--checkpoint-dir", ck]) \
        == 0
    first = capsys.readouterr().out
    assert "[done] final checkpoint at step 4" in first
    resumed = launch_train.run(launch_train.parse_args(
        base + ["--steps", "6", "--checkpoint-dir", ck]))
    out = capsys.readouterr().out
    assert "[resume] restored checkpoint at step 4" in out
    assert resumed["start_step"] == 4 and len(resumed["losses"]) == 2
    whole = launch_train.run(launch_train.parse_args(base + ["--steps", "6"]))
    np.testing.assert_allclose(resumed["losses"], whole["losses"][4:],
                               rtol=1e-6)
    for (path, a), (_, b) in zip(leaf_paths(resumed["state"]),
                                 leaf_paths(whole["state"])):
        assert torch.equal(a, b), path


def test_sharded_axes_are_refused():
    """``--data-axis`` / ``--model-axis`` above 1 train the sharded LM,
    which needs the ranks of a torchrun: without a process group the
    driver refuses, naming it (the sharded runs themselves are in
    ``tests/test_torch_sharded_lm.py``)."""
    for flag in ("--data-axis", "--model-axis"):
        with pytest.raises(RuntimeError, match="torchrun"):
            launch_train.main(["--arch", "qwen3-0.6b", "--reduced",
                               "--device", "cpu", flag, "2"])


def test_entry_points_need_a_card_or_an_explicit_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.get_reduced("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tts.init_train_state(cfg, tts.TrainStepConfig(), torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tts.train_state_from_jax(cfg, {"params": {}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "qwen3-0.6b", "--reduced"])

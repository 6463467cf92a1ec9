"""The port's language model (``repro_torch.models.lm``) against the JAX
package's (``repro.models.lm``), family by family, on the CPU.

Each family at ``get_reduced`` size, the reference's weights carried
across by ``lm_params_from_jax``: ``lm_forward``, ``lm_prefill`` (logits
and every cache leaf), then ten ``lm_decode_step``s from the prefill
cache (each step's logits and every cache leaf).  Tolerances: fp32
``rtol=1e-4, atol=1e-5`` (scaled by a leaf's largest entry where it is
above 1); the bf16 case within the DESIGN.md §13 ladder, ``2e-2`` of the
largest logit.  Also: the configurations against the reference's, and
the port's import graph (no JAX).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import lm as jlm
from repro_torch import configs as tcfg
from repro_torch.models import lm as tlm
from _torch_threads import one_intraop_thread  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    "error::repro_torch.core.dispatch.FallbackWarning")

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5
BF16_TOL = 2e-2
B, S, STEPS = 2, 8, 10
CAP = S + STEPS + 2

FAMILIES = {
    "dense": "qwen3-0.6b",           # GQA + qk_norm + tied embeddings
    "moe": "moonshot-v1-16b-a3b",    # GQA + MoE with shared experts
    "mla": "deepseek-v3-671b",       # MLA + MoE
    "ssm": "mamba2-2.7b",
    "hybrid": "zamba2-1.2b",
    "encdec": "seamless-m4t-medium",
    "vlm": "internvl2-76b",          # with its stub patch prefix
}


def to_np(tree):
    return jax.tree.map(lambda a: None if a is None else np.asarray(a), tree)


def close(port, ref, rtol=RTOL, atol=ATOL, label=""):
    """A tensor against a JAX/numpy array; the atol is scaled by the
    reference's largest entry where that is above 1."""
    ref = np.asarray(ref, np.float32)
    out = port.float().numpy()
    assert out.shape == ref.shape, label
    scale = max(float(np.abs(ref).max()) if ref.size else 0.0, 1.0)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol * scale,
                               err_msg=label)


def real_logits(x, cfg):
    """The logits over the real vocab; the pad columns are ``-1e30``."""
    x = np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()
    assert (x[..., cfg.vocab:] == np.float32(-1e30)).all()
    return x[..., :cfg.vocab]


def dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def close_cache(port, ref, label, **tol):
    assert set(port) == set(ref), label
    for key, val in ref.items():
        if val is None:
            assert port[key] is None
        elif isinstance(val, dict):
            close_cache(port[key], val, f"{label}.{key}", **tol)
        elif key == "pos":
            assert np.array_equal(port[key].numpy(), np.asarray(val)), label
        else:
            assert dtype_name(port[key].dtype) == np.asarray(val).dtype.name, \
                f"{label}.{key}"
            close(port[key], val, label=f"{label}.{key}", **tol)


def make_inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.standard_normal(
            (B, 6, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["prefix_embeds"] = rng.standard_normal(
            (B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    steps = rng.integers(0, cfg.vocab, (STEPS, B, 1)).astype(np.int32)
    return batch, steps


def run_pair(arch, *, jdtype=jnp.float32, tdtype=torch.float32, seed=0):
    """Both packages over the same weights and inputs: the forward, the
    prefill and ten decode steps; yields (what, port, reference)."""
    cfg_j = jcfg.get_reduced(arch, dtype=jdtype)
    cfg_t = tcfg.get_reduced(arch, dtype=tdtype)
    params_j = jlm.init_lm(jax.random.key(seed), cfg_j)
    params_t = tlm.lm_params_from_jax(cfg_t, to_np(params_j), device="cpu")
    batch, steps = make_inputs(cfg_t)
    batch_j = {k: jnp.asarray(v) for k, v in batch.items()}
    batch_t = {k: torch.from_numpy(v) for k, v in batch.items()}

    out = []
    lg_j, aux_j = jlm.lm_forward(params_j, batch_j, cfg_j)
    lg_t, aux_t = tlm.lm_forward(params_t, batch_t, cfg_t)
    out.append(("forward", lg_t, lg_j, aux_t, aux_j))

    pf_j, cache_j = jlm.lm_prefill(params_j, batch_j, cfg_j, CAP)
    pf_t, cache_t = tlm.lm_prefill(params_t, batch_t, cfg_t, CAP)
    out.append(("prefill", pf_t, pf_j, cache_t, to_np(cache_j)))

    step_j = jax.jit(lambda p, t_, c: jlm.lm_decode_step(p, t_, c, cfg_j))
    for i in range(STEPS):
        lg_j, cache_j = step_j(params_j, jnp.asarray(steps[i]), cache_j)
        lg_t, cache_t = tlm.lm_decode_step(params_t, torch.from_numpy(
            steps[i]), cache_t, cfg_t)
        out.append((f"decode {i}", lg_t, lg_j, cache_t, to_np(cache_j)))
    return cfg_t, out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_forward_prefill_and_decode_match_jax(family):
    cfg, runs = run_pair(FAMILIES[family])
    for what, lg_t, lg_j, extra_t, extra_j in runs:
        close(torch.from_numpy(real_logits(lg_t, cfg)), real_logits(lg_j, cfg),
              label=f"{family} {what} logits")
        if what == "forward":
            close(extra_t, extra_j, label=f"{family} aux")
        else:
            close_cache(extra_t, extra_j, f"{family} {what} cache")


def test_bf16_dense_model_within_the_ladder():
    """qwen3 reduced at bf16: the same weights and inputs, the logits
    within 2e-2 of the largest logit after the forward, the prefill and
    each of ten decode steps."""
    cfg, runs = run_pair("qwen3-0.6b", jdtype=jnp.bfloat16,
                         tdtype=torch.bfloat16)
    for what, lg_t, lg_j, _, _ in runs:
        ref = real_logits(lg_j, cfg)
        close(torch.from_numpy(real_logits(lg_t, cfg)), ref, rtol=0,
              atol=BF16_TOL * float(np.abs(ref).max()), label=what)


def test_init_lm_matches_the_reference_tree():
    """The port's own init has the reference's tree (layers unstacked),
    shapes and dtypes, in every family and at bf16."""
    def spec(x):
        return tuple(x.shape), dtype_name(x.dtype)

    for arch in tcfg.list_archs():
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            cfg_j = jcfg.get_reduced(arch, dtype=jdt)
            cfg_t = tcfg.get_reduced(arch, dtype=tdt)
            ref = jax.tree.map(spec, jax.eval_shape(
                lambda: jlm.init_lm(jax.random.key(0), cfg_j)))
            for key, depth in (("layers", cfg_t.n_layers),
                               ("encoder", cfg_t.encoder_layers)):
                if key in ref:   # the port's per-layer dicts
                    one = jax.tree.map(lambda s_: (s_[0][1:], s_[1]),
                                       ref[key], is_leaf=lambda x: isinstance(
                                           x, tuple) and len(x) == 2
                                       and isinstance(x[1], str))
                    ref[key] = [one] * depth
            out = tlm.tree_map(spec, tlm.init_lm(
                cfg_t, torch.Generator().manual_seed(0), "cpu"))
            assert out == ref, arch


def test_init_cache_matches_the_reference():
    for family, arch in FAMILIES.items():
        cfg_j, cfg_t = jcfg.get_reduced(arch), tcfg.get_reduced(arch)
        ref = to_np(jlm.init_cache(cfg_j, 3, 11))
        out = tlm.init_cache(cfg_t, 3, 11, device="cpu")
        close_cache(out, ref, family)


def test_decode_step_leaves_its_input_cache_alone():
    """The step writes into its own copy of the cache, so a caller (the
    server's prompt feed) can keep the old one."""
    for arch in ("qwen3-0.6b", "zamba2-1.2b"):
        cfg = tcfg.get_reduced(arch)
        params = tlm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
        cache = tlm.init_cache(cfg, 2, 6, device="cpu")
        before = tlm.tree_map(torch.clone, cache)
        _, new = tlm.lm_decode_step(params, torch.tensor([[3], [5]]), cache,
                                    cfg)
        flat, flat_before = [], []
        tlm.tree_map(flat.append, cache)
        tlm.tree_map(flat_before.append, before)
        assert len(flat) == len(flat_before) > 1
        assert all(torch.equal(x, y) for x, y in zip(flat, flat_before)), arch
        assert new["pos"].tolist() == [1, 1]


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", jcfg.list_archs())
def test_config_matches_the_reference(arch):
    assert tcfg.list_archs() == jcfg.list_archs()
    for get in ("get_config", "get_reduced"):
        ref, out = getattr(jcfg, get)(arch), getattr(tcfg, get)(arch)
        f_ref, f_out = _fields(ref), _fields(out)
        assert str(f_out.pop("dtype")).replace("torch.", "") == \
            jnp.dtype(f_ref.pop("dtype")).name
        assert f_out == f_ref
        for prop in ("padded_vocab", "d_inner", "ssm_nheads"):
            assert getattr(out, prop) == getattr(ref, prop)
        assert out.param_count() == ref.param_count()
        assert out.active_param_count() == ref.active_param_count()
        for name, shape in jcfg.SHAPES.items():
            assert dataclasses.asdict(tcfg.SHAPES[name]) == \
                dataclasses.asdict(shape)
            assert tcfg.cell_is_applicable(out, tcfg.SHAPES[name])[0] == \
                jcfg.cell_is_applicable(ref, shape)[0]
    assert tcfg.get_reduced(arch).dtype == torch.float32


# The training slice's modules: the walk below must reach each of them.
TRAINING_MODULES = ("repro_torch.data.synthetic", "repro_torch.launch.train",
                    "repro_torch.train.checkpoint",
                    "repro_torch.train.compression",
                    "repro_torch.train.optimizer", "repro_torch.pytree",
                    "repro_torch.train.train_step",
                    "repro_torch.testing.lm_train_card")
SHARDED_MODULES = ("repro_torch.distributed.sharding",
                   "repro_torch.distributed.elastic",
                   "repro_torch.distributed.collective_matmul",
                   "repro_torch.testing.lm_shard_cases",
                   "repro_torch.testing.lm_shard_card")


def test_port_imports_no_jax():
    """Every module of ``repro_torch`` (the training slice's and the
    sharded LM's among them) imports without JAX or the JAX package, and
    no source line names them."""
    code = ("import importlib, json, pkgutil, sys, repro_torch\n"
            "seen = []\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "    seen.append(m.name)\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(json.dumps({'bad': bad, 'seen': seen}))\n"
            "sys.exit(1 if bad else 0)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    seen = json.loads(res.stdout.strip().splitlines()[-1])["seen"]
    missing = [m for m in TRAINING_MODULES + SHARDED_MODULES
               if m not in seen]
    assert not missing, missing
    pattern = re.compile(r"^\s*(import (jax|repro)\b|from (jax|repro)[. ])")
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            assert not pattern.match(line), f"{path}: {line}"


def test_entry_points_need_a_card_or_an_explicit_device(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.get_reduced("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init_lm(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.lm_params_from_jax(cfg, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-0.6b", "--reduced"])

"""The port's sharding rules (``repro_torch.distributed.sharding``) spec
for spec against the JAX package's (``repro.distributed.sharding``).

One JAX child process (8 host devices, as
``tests/test_distributed_multidevice.py`` runs its meshes) prints every
spec the reference gives as JSON; the port computes the same specs here
from ``{axis: size}`` meshes, with no process group:

* ``param_shardings`` for every family, reduced (real tensors) and at
  full size (``jax.eval_shape`` there, ``abstract_lm``'s meta tensors
  here), on meshes (4, 2), (2, 4) and (8, 1), with the training rules
  and ``serving_rules``;
* ``shardings_like`` over the 8-bit AdamW moments and their scales;
* ``cache_shardings`` at batch 8 and 1 (granite-8b's K/V cache,
  deepseek's MLA latent cache);
* ``fit_pspec``'s divisibility cases, ``batch_pspec``, both modes of
  ``sparse_operand_pspec``, and ``sparse_format_shardings`` on a format
  and on an ``ADPlan`` holding ``ShardedSchedule``s.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.core import ad_plan, from_dense
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sparse_shard import sharded_schedule
from repro_torch.models.lm import (abstract_lm, init_cache, init_lm,
                                   stack_layers)
from repro_torch.pytree import leaf_paths
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from _torch_threads import one_intraop_thread  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    "error::repro_torch.core.dispatch.FallbackWarning")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = ((4, 2), (2, 4), (8, 1))
LIKE_ARCHS = ("qwen3-0.6b", "moonshot-v1-16b-a3b", "deepseek-v3-671b",
              "zamba2-1.2b")
CACHE_ARCHS = ("granite-8b", "deepseek-v3-671b")
CACHE_BATCHES = (8, 1)
CACHE_CAPACITY = 4096
FIT_CASES = [
    (("vocab", "embed"), (512, 128)),
    (("vocab", None), (511, 128)),
    (("vocab", "embed"), (49155, 2048)),
    (("heads", "heads"), (64, 64)),
    (("batch", "kv_seq", None), (8, 32768, 128)),
    (("batch", "kv_seq", None), (1, 32768, 128)),
    (("kv_seq", "batch"), (4096, 6)),
    ((None, "expert", "embed", "ffn"), (3, 64, 2048, 1408)),
    (("ffn",), (7,)),
    (("embed", "nope"), (1024, 16)),
]
SPARSE_A = np.kron(np.eye(4, dtype=np.float32),
                   np.ones((8, 8), np.float32))[:, ::-1] * 1.5

_CHILD = """
import dataclasses, json
import jax
import numpy as np
from jax.sharding import Mesh
from repro.configs import get_config, get_reduced, list_archs
from repro.core import from_dense
from repro.core.autodiff import ad_plan
from repro.distributed import sharding as S
from repro.distributed.sparse_shard import sharded_schedule
from repro.models.lm import init_cache, init_lm
from repro.train.optimizer import AdamWConfig
from repro.train.train_step import TrainStepConfig, init_train_state

MESHES = {meshes}
FIT_CASES = {fit}
LIKE_ARCHS = {like}
CACHE_ARCHS = {cache}
CACHE_BATCHES = {batches}
CAP = {cap}


def mesh_of(d, m):
    return Mesh(np.asarray(jax.devices()[:d * m]).reshape(d, m),
                ("data", "model"))


def pl(p):
    out = [list(e) if isinstance(e, tuple) else e for e in tuple(p)]
    while out and out[-1] is None:
        out.pop()
    return out


def spec(s):
    return pl(s.spec)


def by_path(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = {{}}
    for kp, leaf in flat:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp)] = spec(leaf)
    return out


def fields(node, prefix, out):
    if isinstance(node, jax.sharding.NamedSharding):
        out[prefix] = spec(node)
    elif dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            fields(getattr(node, f.name),
                   prefix + "/" + f.name if prefix else f.name, out)
    return out


res = {{"params": {{}}, "like": {{}}, "cache": {{}}, "fit": [], "batch": {{}},
       "operand": {{}}}}
key = jax.random.key(0)
for arch in list_archs():
    for size in ("reduced", "full"):
        cfg = get_reduced(arch) if size == "reduced" else get_config(arch)
        shapes = jax.eval_shape(lambda: init_lm(key, cfg))
        for d, m in MESHES:
            mesh = mesh_of(d, m)
            for rname, rules in (("train", None),
                                 ("serve", S.serving_rules())):
                res["params"][f"{{arch}}|{{size}}|{{d}}x{{m}}|{{rname}}"] = \\
                    by_path(S.param_shardings(shapes, mesh, rules))
for arch in LIKE_ARCHS:
    for size in ("reduced", "full"):
        cfg = get_reduced(arch) if size == "reduced" else get_config(arch)
        ts = TrainStepConfig(opt=AdamWConfig(quantize_state=True))
        st = jax.eval_shape(lambda: init_train_state(key, cfg, ts))
        for d, m in MESHES:
            p_sh = S.param_shardings(st["params"], mesh_of(d, m))
            for k in ("m", "v", "m_scale", "v_scale"):
                res["like"][f"{{arch}}|{{size}}|{{d}}x{{m}}|{{k}}"] = by_path(
                    S.shardings_like(p_sh, st["opt"][k]))
for arch in CACHE_ARCHS:
    cfg = get_config(arch)
    for b in CACHE_BATCHES:
        cache = jax.eval_shape(lambda: init_cache(cfg, b, CAP))
        for d, m in MESHES:
            res["cache"][f"{{arch}}|{{b}}|{{d}}x{{m}}"] = by_path(
                S.cache_shardings(cache, mesh_of(d, m), batch=b))
for d, m in MESHES:
    mesh = mesh_of(d, m)
    name = f"{{d}}x{{m}}"
    res["fit"].append([pl(S.fit_pspec(lg, shp, mesh))
                       for lg, shp in FIT_CASES])
    res["batch"][name] = [pl(S.batch_pspec(mesh, n)) for n in (1, 2)]
    res["operand"][name] = [pl(S.sparse_operand_pspec(
                                mesh, batched=bt, heads_over_model=ho))
                            for bt in (False, True) for ho in (False, True)]
mesh = mesh_of(4, 2)
a = np.asarray(json.loads({sparse!r}), np.float32)
fmt = from_dense(a)
plan = ad_plan(fmt, impl="pallas_balanced")
plan = dataclasses.replace(
    plan, fwd_part=sharded_schedule(plan.fwd, 4),
    bwd_part=sharded_schedule(plan.bwd, 4),
    fwd_part_wa=sharded_schedule(plan.fwd, 4, window_split=False))
res["format"] = fields(S.sparse_format_shardings(fmt, mesh), "", {{}})
res["plan"] = fields(S.sparse_format_shardings(plan, mesh), "", {{}})
print("JSON" + json.dumps(res))
"""


def _as_spec(entries):
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


@pytest.fixture(scope="module")
def ref():
    prog = ("import os\nos.environ['XLA_FLAGS'] = "
            "'--xla_force_host_platform_device_count=8'\n"
            + textwrap.dedent(_CHILD.format(
                meshes=MESHES, fit=FIT_CASES, like=LIKE_ARCHS,
                cache=CACHE_ARCHS, batches=CACHE_BATCHES,
                cap=CACHE_CAPACITY, sparse=json.dumps(SPARSE_A.tolist()))))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, f"child failed:\n{out.stdout}\n{out.stderr}"
    line = next(x for x in out.stdout.splitlines() if x.startswith("JSON"))
    return json.loads(line[4:])


def _mesh(d, m):
    return {"data": d, "model": m}


def _specs(tree):
    """``{path: spec}`` of a port spec tree."""
    return dict(sh.spec_paths(tree))


def _expect(by_path):
    return {p: _as_spec(s) for p, s in by_path.items()}


@pytest.mark.parametrize("arch", list_archs())
def test_param_shardings_match_jax(ref, arch):
    params = {"reduced": stack_layers(init_lm(
                  get_reduced(arch), torch.Generator().manual_seed(0), "cpu")),
              "full": abstract_lm(get_config(arch))}
    for size, tree in params.items():
        for d, m in MESHES:
            for rname, rules in (("train", None),
                                 ("serve", sh.serving_rules())):
                got = _specs(sh.param_shardings(tree, _mesh(d, m), rules))
                want = _expect(ref["params"][f"{arch}|{size}|{d}x{m}|{rname}"])
                assert got == want, (size, d, m, rname)


def test_shardings_like_over_8bit_moments_match_jax(ref):
    cfgs = {"reduced": get_reduced, "full": get_config}
    for arch in LIKE_ARCHS:
        for size, get in cfgs.items():
            params = abstract_lm(get(arch))
            opt = adamw_init(params, AdamWConfig(quantize_state=True))
            for d, m in MESHES:
                p_specs = sh.param_shardings(params, _mesh(d, m))
                for k in ("m", "v", "m_scale", "v_scale"):
                    got = _specs(sh.shardings_like(p_specs, opt[k],
                                                   _mesh(d, m)))
                    want = _expect(ref["like"][f"{arch}|{size}|{d}x{m}|{k}"])
                    assert got == want, (arch, size, d, m, k)


def test_cache_shardings_match_jax(ref):
    for arch in CACHE_ARCHS:
        cfg = get_config(arch)
        for b in CACHE_BATCHES:
            cache = init_cache(cfg, b, CACHE_CAPACITY, device="meta")
            for d, m in MESHES:
                got = _specs(sh.cache_shardings(cache, _mesh(d, m), batch=b))
                want = _expect(ref["cache"][f"{arch}|{b}|{d}x{m}"])
                assert got == want, (arch, b, d, m)
    # the K/V heads take "model" where they divide it (8 kv-heads, M = 4)
    cache = init_cache(get_config("granite-8b"), 8, CACHE_CAPACITY,
                       device="meta")
    assert _specs(sh.cache_shardings(cache, _mesh(2, 4), batch=8))[
        "layers/k"] == (None, "data", None, "model")


def test_fit_pspec_divisibility_cases_match_jax(ref):
    for (d, m), want in zip(MESHES, ref["fit"]):
        got = [sh.fit_pspec(lg, shp, _mesh(d, m)) for lg, shp in FIT_CASES]
        assert got == [_as_spec(w) for w in want], (d, m)
    # an axis that does not divide its dim is dropped; one axis never
    # takes two dims of a tensor
    assert sh.fit_pspec(("vocab", None), (511, 128), _mesh(4, 2)) == ()
    assert sh.fit_pspec(("heads", "heads"), (64, 64), _mesh(4, 2)) == (
        "model",)


def test_batch_and_sparse_operand_specs_match_jax(ref):
    for d, m in MESHES:
        name = f"{d}x{m}"
        assert [sh.batch_pspec(_mesh(d, m), n) for n in (1, 2)] == [
            _as_spec(s) for s in ref["batch"][name]]
        got = [sh.sparse_operand_pspec(_mesh(d, m), batched=bt,
                                       heads_over_model=ho)
               for bt in (False, True) for ho in (False, True)]
        assert got == [_as_spec(s) for s in ref["operand"][name]], name


def test_sparse_format_shardings_match_jax(ref):
    fmt = from_dense(SPARSE_A)
    plan = ad_plan(fmt, impl="cuda_balanced", device="cpu")
    plan = dataclasses.replace(
        plan, fwd_part=sharded_schedule(plan.fwd, 4),
        bwd_part=sharded_schedule(plan.bwd, 4),
        fwd_part_wa=sharded_schedule(plan.fwd, 4, window_split=False))
    assert sh.sparse_format_shardings(fmt) == _expect(
        ref["format"])
    got = sh.sparse_format_shardings(plan)
    assert got == _expect(ref["plan"])
    assert got["fwd_part/seg_win"] == ("data",) and got["fwd/vals"] == ()


def test_expert_rule_by_path_and_rank():
    # a stacked dense MLP weight (L, d, f) takes the dense rule; a stacked
    # expert weight (L, E, d, f) and an unstacked one (E, d, f) the expert
    # rule
    assert sh.logical_spec_for("layers/mlp/w_gate", 3) == (
        None, "embed", "ffn")
    assert sh.logical_spec_for("layers/mlp/w_gate", 4) == (
        None, "expert", "embed", "ffn")
    assert sh.logical_spec_for("mlp/w_gate", 3) == ("expert", "embed", "ffn")
    assert sh.logical_spec_for("final_norm", 1) == (None,)


def test_local_shapes_of_the_specs():
    params = abstract_lm(get_config("qwen3-0.6b"))
    specs = sh.param_shardings(params, _mesh(4, 2))
    shapes = {p: sh.local_shape(t.shape, s, _mesh(4, 2)) for (p, t), (_, s)
              in zip(leaf_paths(params), sh.spec_paths(specs))}
    # embed (152064, 1024): vocab over model, d over data
    assert shapes["embed"] == (152064 // 2, 1024 // 4)
    assert shapes["final_norm"] == (1024,)

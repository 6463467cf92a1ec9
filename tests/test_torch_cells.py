"""The port's dry-run cells (``repro_torch.launch.cells``,
``repro_torch.launch.dryrun``) against the JAX package's, on the CPU.

  * ``step_policy``: equal to the reference's for every configuration
    at 1, 16 and 32 data shards, with and without overrides (exact);
  * the skip reason of every arch × shape cell, word for word;
  * ``plan_cell`` at ``get_reduced`` size: kind, tokens per step, model
    flops, donated arguments and every global input's shape and dtype
    equal to the reference's ``plan_cell`` on a one-device JAX mesh;
  * ``account_cell`` on a fake ``(2, 2)`` group at reduced qwen3 and
    moonshot: argument bytes exactly the local shards' of the plan's
    specs; four ranks' local flops between the one-device count and
    ``1 + REPLICATED`` times it (the layout replicates some compute:
    the attention's repeated kv heads, the norms and the vocab
    all-gather of the loss); the ring bytes the formulas over the
    recorded collectives; no process group left afterwards;
  * ``compile_cell`` on a fake ``(2, 2)`` group at reduced size: the
    serving cells (``decode_32k`` of qwen3, deepseek, mamba2, seamless;
    ``long_500k`` of zamba2) and seamless's ``train_4k`` (its encoder
    leaves split their layer dim) trace with flops; a decode step whose
    cache splits its sequence all-reduces the merge's max and sum, two a
    layer, and no other;
  * on a one-rank gloo mesh, the trace of real CPU tensors counts the
    flops, bytes and memory of the trace on ``meta`` (exact);
  * the dry-run CLI at 2 layers on the 256-rank mesh: a rerun skips the
    done cells, ``--force`` traces them again, ``long_500k`` keeps the
    reference's skip reason, an error cell exits 1, nothing is set in
    the environment on import.

The reference's ``repro.launch.dryrun`` is never imported here: it sets
``XLA_FLAGS`` to 512 host devices on import, which would reach every
later JAX test of the process.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.configs import list_archs
from repro.launch import cells as jcells
from repro_torch.configs import SHAPES, get_config, get_reduced
from repro_torch.distributed.sharding import local_shape, spec_paths
from repro_torch.launch import cells
from repro_torch.launch.mesh import fake_group
from repro_torch.pytree import leaf_paths
from repro_torch.roofline.analysis import COLLECTIVES, \
    collective_bytes_from_trace
from repro_torch.roofline.trace import trace_step
from _torch_threads import one_intraop_thread  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    "error::repro_torch.core.dispatch.FallbackWarning")

REPLICATED = 0.1        # share of compute the (2, 2) layout may repeat
ARCHS = list_archs()


def _overrides(full, red):
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if getattr(red, f.name) != getattr(full, f.name)}


def _port_over(arch):
    return _overrides(get_config(arch), get_reduced(arch))


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): (tuple(leaf.shape), str(leaf.dtype))
            for kp, leaf in flat}


def _port_paths(tree):
    return {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in leaf_paths(tree)}


@pytest.mark.parametrize("shards", [1, 16, 32])
def test_step_policy_equals_the_reference(shards):
    for arch in ARCHS:
        for over in (None, {"microbatches": 8}, {"accum_dtype": "bfloat16"}):
            for b, s in ((256, 4096), (32, 32768), (8, 128)):
                got = cells.step_policy(get_config(arch), b, s, over, shards)
                want = jcells.step_policy(jax_config(arch), b, s, over,
                                          shards)
                assert (got.microbatches, got.accum_dtype, got.aux_weight,
                        got.compression.kind) == (
                    want.microbatches, want.accum_dtype, want.aux_weight,
                    want.compression.kind), (arch, over, b, s)
                assert dataclasses.asdict(got.opt) == \
                    dataclasses.asdict(want.opt), arch
    assert cells.CARRY_BUDGET_BYTES == jcells.CARRY_BUDGET_BYTES
    assert cells.SRC_LEN_DECODE == jcells.SRC_LEN_DECODE


def test_skip_reasons_equal_the_reference():
    from repro.configs import cell_is_applicable as jax_applicable
    from repro_torch.configs import cell_is_applicable

    mesh = {"data": 16, "model": 16}
    for arch in ARCHS:
        for shape in SHAPES:
            got = cell_is_applicable(get_config(arch), SHAPES[shape])
            want = jax_applicable(jax_config(arch), JSHAPES[shape])
            assert got == want, (arch, shape)
            if not got[0]:
                plan = cells.plan_cell(arch, shape, mesh)
                ref = jcells.plan_cell(arch, shape, None)
                assert plan.skipped == ref.skipped == want[1]
                assert (plan.kind, plan.fn, plan.tokens_per_step) == (
                    ref.kind, None, 0)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_plan_cell_equals_the_reference_at_reduced_size(shape):
    jmesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    for arch in ("qwen3-0.6b", "mamba2-2.7b", "seamless-m4t-medium",
                 "deepseek-v3-671b"):
        jover = _overrides(jax_config(arch), jax_reduced(arch))
        ref = jcells.plan_cell(arch, shape, jmesh, cfg_overrides=jover)
        got = cells.plan_cell(arch, shape, {"data": 1, "model": 1},
                              cfg_overrides=_port_over(arch))
        assert got.skipped == ref.skipped, arch
        assert (got.kind, got.tokens_per_step, got.mflops, got.donate) == (
            ref.kind, ref.tokens_per_step, ref.mflops, ref.donate), arch
        assert len(got.in_shapes) == len(ref.in_shapes)
        for g, r in zip(got.in_shapes, ref.in_shapes):
            assert _port_paths(g) == _jax_paths(r), (arch, shape)
        # one spec a leaf, the same tree
        for g, sp in zip(got.in_shapes, got.in_shardings):
            if isinstance(g, torch.Tensor):
                assert isinstance(sp, tuple)
            else:
                assert [p for p, _ in spec_paths(sp)] == \
                    [p for p, _ in leaf_paths(g)]


def _arg_bytes(plan, sizes):
    total = 0
    for shapes, specs in zip(plan.in_shapes, plan.in_shardings):
        for (_, t), (_, sp) in zip(leaf_paths({"x": shapes}),
                                   spec_paths({"x": specs})):
            total += int(np.prod(local_shape(t.shape, sp, sizes),
                                 dtype=np.int64)) * t.element_size()
    return total


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "moonshot-v1-16b-a3b"])
def test_account_cell_on_a_fake_two_by_two_group(arch):
    from torch.distributed.device_mesh import DeviceMesh

    over = _port_over(arch)
    sizes = {"data": 2, "model": 2}
    plan = cells.plan_cell(arch, "train_4k", sizes, cfg_overrides=over)
    one, _ = trace_step(plan.fn, *plan.in_shapes)   # one device, no mesh
    with fake_group(4):
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        res = cells.account_cell(arch, "train_4k", mesh, "m2x2",
                                 cfg_overrides=over)
    assert not dist.is_initialized()
    assert res.memory_stats["argument_bytes"] == _arg_bytes(plan, sizes)
    assert res.memory_stats["alias_bytes"] > 0.99 * _arg_bytes(
        plan, sizes) - 2 * 256 * 4096 * 4
    share = 4 * res.report.per_device_flops / one.flops
    assert 1.0 <= share <= 1.0 + REPLICATED, share
    coll = collective_bytes_from_trace(res.trace.collectives)
    assert res.report.collective_ring == coll["ring"]
    assert res.report.collective_count == len(res.trace.collectives) > 0
    assert all(k in COLLECTIVES and g in (2, 4)
               for k, _, g in res.trace.collectives)
    assert res.report.model_flops_total == plan.mflops


@pytest.mark.parametrize("arch,shape,merged", [
    ("qwen3-0.6b", "decode_32k", 0),          # kv-heads divide "model"
    ("deepseek-v3-671b", "decode_32k", 2),    # MLA: sequence over "model"
    ("mamba2-2.7b", "decode_32k", 0),         # no attention
    ("seamless-m4t-medium", "decode_32k", 0),
    ("zamba2-1.2b", "long_500k", 1),          # B = 1: sequence over "data"
    ("seamless-m4t-medium", "train_4k", None),
])
def test_compile_cell_traces_serving_cells_on_two_by_two(arch, shape, merged):
    """The cells the reference compiles on a mesh, traced on a fake
    (2, 2) group; ``merged``: the attention layers whose decode merges a
    split sequence (each all-reduces its max and sum, shaped (..., 1,
    1))."""
    from torch.distributed.device_mesh import DeviceMesh

    with fake_group(4):
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        plan = cells.plan_cell(arch, shape, mesh,
                               cfg_overrides=_port_over(arch))
        res = cells.compile_cell(plan, mesh, "m2x2")
    assert not dist.is_initialized()
    assert res.error is None and res.trace.flops > 0
    assert res.report.per_device_flops > 0
    if merged is not None:
        stats = sum(kind == "all-reduce" and outs[0][-2:] == (1, 1)
                    for (kind, _, _), outs in zip(
                        res.trace.collectives, res.trace.collective_shapes))
        assert stats == 2 * merged


def test_meta_trace_counts_what_real_tensors_do():
    """The same sharded step traced on ``meta`` and on real CPU tensors
    over a one-rank gloo mesh: the same flops, bytes and memory."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.distributed.sharding import batch_pspec, placements
    from repro_torch.launch.mesh import one_rank_mesh
    from repro_torch.train.train_step import (TrainStepConfig,
                                              init_train_state,
                                              make_train_step)

    cfg = get_reduced("qwen3-0.6b")
    ts = TrainStepConfig(microbatches=2)
    traces = []
    with one_rank_mesh("cpu") as mesh:
        for state in (cells._meta_train_state(cfg, ts), init_train_state(
                cfg, ts, torch.Generator().manual_seed(0), "cpu")):
            dev = "meta" if state["step"].is_meta else "cpu"
            tokens = torch.zeros((4, 32), dtype=torch.int32, device=dev)
            batch = {"tokens": distribute_tensor(
                tokens, mesh, placements(batch_pspec(mesh), mesh),
                src_data_rank=None)}
            trace, _ = trace_step(make_train_step(cfg, ts),
                                  reshard_state(state, mesh), batch)
            traces.append(trace)
    meta, real = traces
    assert meta.flops == real.flops > 0
    assert meta.bytes_accessed == real.bytes_accessed
    assert meta.memory == real.memory
    assert meta.ops == real.ops


def _cli(tmp_path, *extra):
    from repro_torch.launch import dryrun

    return dryrun.main(["--arch", "qwen3-0.6b", "--mesh", "single",
                        "--cfg-override", json.dumps({"n_layers": 2}),
                        "--out", str(tmp_path / "dryrun.jsonl"), *extra])


def test_dryrun_cli_resumes_forces_skips_and_fails(tmp_path, capsys):
    env = dict(os.environ)
    from repro_torch.launch import dryrun       # noqa: F401 — import only

    assert dict(os.environ) == env
    assert _cli(tmp_path, "--shape", "train_4k,long_500k",
                "--dump-trace", str(tmp_path / "traces")) == 0
    assert not dist.is_initialized()
    recs = [json.loads(line)
            for line in open(tmp_path / "dryrun.jsonl")]
    assert [(r["shape"], r["status"]) for r in recs] == [
        ("train_4k", "ok"), ("long_500k", "skipped")]
    ok, skip = recs
    assert skip["reason"] == jcells.plan_cell(
        "qwen3-0.6b", "long_500k", None).skipped
    assert ok["mesh"] == "pod16x16" and ok["hw"] == "h100-sxm"
    assert ok["roofline"]["chips"] == 256
    assert set(ok["memory"]) == {"argument_bytes", "output_bytes",
                                 "temp_bytes", "alias_bytes"}
    assert (tmp_path / "traces"
            / "qwen3-0.6b__train_4k__pod16x16.trace.txt").stat().st_size
    capsys.readouterr()
    assert _cli(tmp_path, "--shape", "train_4k") == 0
    assert "[skip-done]" in capsys.readouterr().out
    assert _cli(tmp_path, "--shape", "long_500k", "--force") == 0
    assert "[skip] qwen3-0.6b × long_500k" in capsys.readouterr().out
    assert _cli(tmp_path, "--shape", "train_4k", "--tag", "broken",
                "--ts-override", json.dumps({"no_such_field": 1})) == 1
    recs = [json.loads(line) for line in open(tmp_path / "dryrun.jsonl")]
    assert len(recs) == 4 and recs[-1]["status"] == "error"
    assert "no_such_field" in recs[-1]["error"]
    assert not dist.is_initialized()

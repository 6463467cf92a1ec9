"""(architecture × input-shape × mesh) cell planner for the dry-run.

Counterpart of ``repro.launch.cells``.  A *cell* is one step:
  train_4k     → train_step(state, batch)          (grad accum + AdamW)
  prefill_32k  → prefill(params, batch)            (forward + cache build)
  decode_32k   → serve_step(params, tokens, cache) (one token, full KV cache)
  long_500k    → serve_step at 524288 cache        (sub-quadratic archs only)

``plan_cell`` resolves every input to ``meta`` tensors and specs (zero
allocation: the real init functions traced on ``meta``, as the reference
runs ``jax.eval_shape`` over them, so the dry-run sees exactly the shapes
the runtime uses).  ``compile_cell`` keeps the reference's name but
*traces* instead of compiling: it lays the inputs out as ``meta``
DTensors on the mesh (a mesh of a ``"fake"`` process group,
``launch/mesh.fake_group``) and runs the step once under
``roofline/trace.py``'s counter, which reads one rank's flops, bytes,
collectives and memory; ``roofline/analysis.py`` turns them into the
report.

Per-arch execution knobs (microbatching, 8-bit optimizer states) follow
the same policy the real launcher uses — see ``step_policy``.

Deliberate differences from the reference:
  * the port's layer loop is unrolled Python, so a trace at full depth
    counts every layer: ``account_cell`` takes no depth-u and depth-2u
    samples and extrapolates nothing;
  * memory is the trace's live bytes of ``meta`` storages, not XLA's
    buffer assignment: no fusion, no rematerialisation by the compiler,
    and the caching allocator's rounding is not modeled;
  * the steps are the port's: a train step updates its state in place
    (``alias_bytes``: the reference's donation), a decode step clones its
    cache (the reference donates it);
  * what GSPMD partitions by itself the port's model does by hand on the
    DTensors, so the trace counts those collectives: a decode cell
    attends its cache where ``cache_shardings`` lays it (a split
    sequence merged by all-reduces, ``models/layers.decode_merge``), and
    a train cell's loss is the vocab-parallel cross entropy (no rank
    holds more than its vocab shard of the logits or their gradient).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import SHAPES, cell_is_applicable, get_config
from repro_torch.data.synthetic import decode_specs, input_specs
from repro_torch.distributed.sharding import (axis_sizes, cache_shardings,
                                              fit_pspec, param_shardings,
                                              serving_rules, shardings_like)
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import (abstract_lm, init_cache, lm_decode_step,
                                   lm_prefill, unstack_layers)
from repro_torch.pytree import tree_map
from repro_torch.roofline.analysis import (HW_H100, HardwareSpec,
                                           RooflineReport, analyze_trace)
from repro_torch.train.compression import init_error
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_step import TrainStepConfig, make_train_step

__all__ = ["CellPlan", "CellResult", "plan_cell", "compile_cell",
           "account_cell", "step_policy", "SRC_LEN_DECODE",
           "CARRY_BUDGET_BYTES"]

SRC_LEN_DECODE = 1024  # audio-context length held by the enc-dec memory


CARRY_BUDGET_BYTES = 4e9  # per-device remat-carry budget for microbatching


def step_policy(cfg: ArchConfig, global_batch: int, seq_len: int = 4096,
                overrides: Optional[Dict] = None,
                data_shards: int = 16) -> TrainStepConfig:
    """Execution knobs per arch size (same policy as launch/train.py).

    With per-layer remat, the dominant saved state is one (tokens_μ,
    d_model) carry per layer.  Microbatch count is chosen so
    L · tokens_per_dev_per_μ · d_model · 2 B stays under
    CARRY_BUDGET_BYTES; capped at 16 so every device keeps ≥ 1 batch row.
    """
    tokens_per_dev = global_batch * seq_len / max(data_shards, 1)
    layers = cfg.n_layers + cfg.encoder_layers
    carry_bytes = layers * tokens_per_dev * cfg.d_model * 2
    micro = max(1, min(16, int(-(-carry_bytes // CARRY_BUDGET_BYTES))))
    while global_batch % micro:
        micro -= 1
    n = cfg.param_count()
    opt = AdamWConfig(quantize_state=n > 5e10)
    ts = TrainStepConfig(opt=opt, microbatches=micro)
    if overrides:
        ts = dataclasses.replace(ts, **overrides)
    return ts


@dataclasses.dataclass
class CellPlan:
    arch: str
    shape: str
    kind: str
    fn: Optional[Callable]
    in_shapes: Tuple          # trees of global ``meta`` tensors
    in_shardings: Tuple       # trees of specs (``distributed/sharding.py``)
    donate: Tuple[int, ...]
    tokens_per_step: int
    mflops: float
    skipped: Optional[str] = None


def _batch_sharding(leaf, mesh):
    """Batch-dim spec, divisibility-checked (B=1 decode → replicated)."""
    logical = ("batch",) + (None,) * (len(leaf.shape) - 1)
    return fit_pspec(logical, leaf.shape, mesh)


def _meta_train_state(cfg: ArchConfig, ts: TrainStepConfig) -> Dict:
    """``init_train_state``'s tree on ``meta``: the params of
    ``abstract_lm``, AdamW's zeros beside them, the step counter and,
    under compression, the error buffers."""
    params = abstract_lm(cfg)
    state: Dict[str, Any] = {
        "params": params,
        "opt": adamw_init(params, ts.opt),
        "step": torch.zeros((), dtype=torch.int32, device="meta"),
    }
    if ts.compression.kind != "none":
        state["err"] = init_error(params)
    return state


def plan_cell(arch: str, shape_name: str, mesh, *,
              ts_overrides: Optional[Dict] = None,
              cfg_overrides: Optional[Dict] = None) -> CellPlan:
    """The step, its inputs and their specs for one cell, or its skip
    reason.  ``mesh``: a ``DeviceMesh`` or a ``{axis: size}`` mapping
    (the specs read only the axis sizes)."""
    cfg = _config(arch, cfg_overrides)
    shape = SHAPES[shape_name]
    ok, why = cell_is_applicable(cfg, shape)
    if not ok:
        return CellPlan(arch, shape_name, shape.kind, None, (), (), (),
                        0, 0.0, skipped=why)

    n_active = cfg.active_param_count()
    b, s = shape.global_batch, shape.seq_len
    sizes = axis_sizes(mesh)

    if shape.kind == "train":
        ts = step_policy(cfg, b, s, ts_overrides,
                         data_shards=_data_shards(sizes))
        step = make_train_step(cfg, ts)
        state_shapes = _meta_train_state(cfg, ts)
        batch_shapes = input_specs(cfg, b, s)
        state_sh = _state_shardings(state_shapes, mesh)
        batch_sh = tree_map(lambda l: _batch_sharding(l, mesh),
                             batch_shapes)
        tokens = b * s
        return CellPlan(arch, shape_name, "train", step,
                        (state_shapes, batch_shapes), (state_sh, batch_sh),
                        (0,), tokens, 6.0 * n_active * tokens)

    if shape.kind == "prefill":
        def prefill(params, batch):
            return lm_prefill(unstack_layers(params), batch, cfg, capacity=s)

        params_shapes = abstract_lm(cfg)
        batch_shapes = input_specs(cfg, b, s)
        params_sh = param_shardings(params_shapes, mesh)
        batch_sh = tree_map(lambda l: _batch_sharding(l, mesh),
                             batch_shapes)
        tokens = b * s
        return CellPlan(arch, shape_name, "prefill", prefill,
                        (params_shapes, batch_shapes), (params_sh, batch_sh),
                        (), tokens, 2.0 * n_active * tokens)

    # decode kinds (decode_32k / long_500k): one new token over a cache of s
    def serve_step(params, tokens_, cache):
        return lm_decode_step(unstack_layers(params), tokens_, cache, cfg)

    params_shapes = abstract_lm(cfg)
    cache_shapes = init_cache(cfg, b, capacity=s, device="meta")
    if cfg.family in ("encdec", "audio"):
        cache_shapes = dict(cache_shapes)
        cache_shapes["memory"] = torch.empty(
            (b, SRC_LEN_DECODE, cfg.d_model), dtype=cfg.dtype, device="meta")
    tok_shapes = decode_specs(cfg, b)["tokens"]

    # serving layout: drop the FSDP dim when TP-sharded weights fit HBM
    # (10 GB budget leaves room for cache + transients) — kills the
    # per-token weight gathers
    tp = sizes.get("model", 1)
    no_fsdp = (cfg.param_count() * 2 / tp <= 10e9
               and not os.environ.get("REPRO_SERVE_FSDP"))  # ablation knob
    params_sh = param_shardings(params_shapes, mesh,
                                serving_rules() if no_fsdp else None)
    cache_sh = cache_shardings(cache_shapes, mesh, batch=b)
    tok_sh = _batch_sharding(tok_shapes, mesh)

    return CellPlan(arch, shape_name, "decode", serve_step,
                    (params_shapes, tok_shapes, cache_shapes),
                    (params_sh, tok_sh, cache_sh),
                    (2,), b, 2.0 * n_active * b)


def _state_shardings(state_shapes: Dict, mesh) -> Dict:
    p_sh = param_shardings(state_shapes["params"], mesh)
    out: Dict[str, Any] = {"params": p_sh, "step": ()}
    opt_shapes = state_shapes["opt"]
    opt_sh: Dict[str, Any] = {"count": ()}
    for k in ("m", "v", "m_scale", "v_scale"):
        if opt_shapes.get(k) is not None:
            opt_sh[k] = shardings_like(p_sh, opt_shapes[k], mesh)
        else:
            opt_sh[k] = None
    out["opt"] = opt_sh
    if "err" in state_shapes:
        out["err"] = shardings_like(p_sh, state_shapes["err"], mesh)
    return out


@dataclasses.dataclass
class CellResult:
    plan: CellPlan
    report: Optional[RooflineReport]
    compile_s: float
    memory_stats: Optional[Dict]
    error: Optional[str] = None
    trace: Optional[Any] = None   # the StepTrace the roofline terms read


def _place(plan: CellPlan, mesh) -> Tuple:
    """The plan's inputs as ``meta`` DTensors laid out by its specs."""
    from repro_torch.distributed.elastic import reshard_tree

    return tuple(reshard_tree(shapes, specs, mesh) if isinstance(shapes, dict)
                 else reshard_tree({"x": shapes}, {"x": specs}, mesh)["x"]
                 for shapes, specs in zip(plan.in_shapes, plan.in_shardings))


@contextlib.contextmanager
def _under(mesh):
    """The context the serving steps run in under a mesh (the train step
    sets its own): the mesh ambient, constants replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.ctx import activation_mesh

    with activation_mesh(mesh), implicit_replication(), torch.no_grad():
        yield


def compile_cell(plan: CellPlan, mesh, mesh_name: str,
                 hw: HardwareSpec = HW_H100) -> CellResult:
    """Trace the cell's step once on ``meta`` DTensors over ``mesh`` (a
    ``DeviceMesh``): the report at ``hw`` and the memory statistics."""
    from repro_torch.roofline.trace import trace_step

    if plan.skipped:
        return CellResult(plan, None, 0.0, None, error=None)
    chips = mesh.size()
    args = _place(plan, mesh)
    ctx = contextlib.nullcontext() if plan.kind == "train" else _under(mesh)
    with ctx:
        trace, _ = trace_step(plan.fn, *args)
    report = analyze_trace(trace, arch=plan.arch, shape=plan.shape,
                           mesh_name=mesh_name, chips=chips,
                           mflops=plan.mflops, hw=hw)
    return CellResult(plan, report, trace.seconds, dict(trace.memory),
                      trace=trace)


def account_cell(arch: str, shape_name: str, mesh, mesh_name: str, *,
                 ts_overrides: Optional[Dict] = None,
                 cfg_overrides: Optional[Dict] = None,
                 hw: HardwareSpec = HW_H100) -> CellResult:
    """Full dry-run of one cell: the production trace for memory and a
    trace at ``microbatches=1`` for the roofline terms.

      1. *Production trace* — policy microbatching, the real launcher's
         layout: the fits-in-HBM proof (the trace's memory).
      2. *Accounting trace* — ``microbatches=1``, the reference's
         accounting convention: per-step FLOPs are exact, the FSDP weight
         re-gathers of further microbatches are not counted (production
         and variants share the convention, so deltas are comparable).
         Where the policy already takes one microbatch, the production
         trace serves.

    The port runs its layers in a Python loop, so both traces count every
    layer at full depth: the reference's depth-u / 2u compiles and their
    linear extrapolation are not needed.
    """
    plan_prod = plan_cell(arch, shape_name, mesh, ts_overrides=ts_overrides,
                          cfg_overrides=cfg_overrides)
    if plan_prod.skipped:
        return CellResult(plan_prod, None, 0.0, None)
    res_prod = compile_cell(plan_prod, mesh, mesh_name, hw=hw)
    shape = SHAPES[shape_name]
    if plan_prod.kind != "train" or step_policy(
            _config(arch, cfg_overrides), shape.global_batch, shape.seq_len,
            ts_overrides, data_shards=_data_shards(mesh)).microbatches == 1:
        return res_prod

    acc_ts = dict(ts_overrides or {})
    acc_ts["microbatches"] = 1
    plan_acc = plan_cell(arch, shape_name, mesh, ts_overrides=acc_ts,
                         cfg_overrides=cfg_overrides)
    res_acc = compile_cell(plan_acc, mesh, mesh_name, hw=hw)
    r = res_acc.report
    report = dataclasses.replace(
        res_prod.report,
        per_device_flops=r.per_device_flops,
        per_device_bytes=r.per_device_bytes,
        collective_naive=r.collective_naive,
        collective_ring=r.collective_ring,
        collective_count=r.collective_count,
    )
    return CellResult(plan_prod, report,
                      res_prod.compile_s + res_acc.compile_s,
                      res_prod.memory_stats, trace=res_acc.trace)


def _config(arch: str, cfg_overrides: Optional[Dict]) -> ArchConfig:
    cfg = get_config(arch)
    return dataclasses.replace(cfg, **cfg_overrides) if cfg_overrides \
        else cfg


def _data_shards(mesh) -> int:
    sizes = axis_sizes(mesh)
    return sizes.get("pod", 1) * sizes.get("data", 1)

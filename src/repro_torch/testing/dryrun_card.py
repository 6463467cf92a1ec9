"""The dry-run and roofline tools on one card: the checks that
``chip_smoke.py`` runs in its tenth phase.

:func:`run` raises :class:`~repro_torch.testing.lm_card.LMCheckFailed`
on the first failed check and otherwise returns what it measured:

  (a) qwen3-0.6b's ``train_4k`` cell on the single-pod mesh ``pod16x16``
      (a ``"fake"`` group of 256 ranks in this process, ``meta`` tensors:
      nothing on the card), planned and accounted by
      ``launch/cells.py``; its dry-run and roofline rows at ``HW_H100``;
  (b) the bf16 step of the training phase (qwen3-0.6b at full width and
      depth, 8 x 4,096 tokens of ``train_4k`` in 4 microbatches, remat,
      seed 0) on a one-rank mesh, traced twice by
      ``roofline/trace.py``: on ``meta`` DTensors over a one-rank fake
      group, and on the card's tensors over a one-rank NCCL group.  The
      two flop counts must be equal.  The trace's predicted peak (the
      rank's arguments, outputs and temporaries, less the state updated
      in place) is held within ``PEAK_GATE`` of
      ``torch.cuda.max_memory_allocated`` over the card's step (the bytes
      live before the state was made subtracted); the modeled step time
      at ``HW_H100`` is printed beside the training phase's measured one;
  (c) qwen3-0.6b's serving step at its published width and depth (bf16,
      ``decode_32k``'s capacity of 32,768 with its batch cut from 128 to
      ``DECODE["batch"]`` = 4, so the cache holds 15.03 GB), laid out as
      ``plan_cell`` lays the cell out (the serving rules, the cache by
      ``cache_shardings``) on a one-rank mesh and traced twice as (b):
      flops equal, the predicted peak (the step's clone of the cache
      included) within ``PEAK_GATE`` of ``max_memory_allocated``; the
      modeled step beside the card's.

Run it alone on a card with ``python -m repro_torch.testing.dryrun_card``.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import distribute_tensor

from repro_torch.configs import SHAPES, get_config
from repro_torch.data.synthetic import SyntheticLMData, input_specs
from repro_torch.distributed.elastic import reshard_state, reshard_tree
from repro_torch.distributed.sharding import (batch_pspec, cache_shardings,
                                              param_shardings, placements,
                                              serving_rules)
from repro_torch.launch.cells import _meta_train_state, _under, account_cell
from repro_torch.launch.mesh import (AXES, fake_group, make_production_mesh,
                                     one_rank_mesh)
from repro_torch.models.lm import (abstract_lm, init_cache, init_lm,
                                   lm_decode_step, stack_layers,
                                   unstack_layers)
from repro_torch.roofline.analysis import HW_H100, analyze_trace
from repro_torch.roofline.report import dryrun_table, roofline_table
from repro_torch.roofline.trace import trace_step
from repro_torch.testing.lm_card import LMCheckFailed, _fail
from repro_torch.train.train_step import (TrainStepConfig, init_train_state,
                                          make_train_step)

__all__ = ["LMCheckFailed", "run", "plan_and_account", "count_twice",
           "count_decode", "PEAK_GATE"]

ARCH = "qwen3-0.6b"
# (b): the training phase's bf16 step (lm_train_card.BF16)
STEP = dict(batch=8, microbatches=4)
PEAK_GATE = 0.25       # predicted peak within 25% of the measured one
# (c): decode_32k's capacity, its batch of 128 cut to 4 (cache 15.03 GB)
DECODE = dict(batch=4, capacity=SHAPES["decode_32k"].seq_len, pos=32000)


def plan_and_account(log: Callable = print) -> Dict:
    """(a): the cell's dry-run record and its two table rows."""
    t0 = time.perf_counter()
    with fake_group(256):
        mesh = make_production_mesh()
        res = account_cell(ARCH, "train_4k", mesh, "pod16x16", hw=HW_H100)
    record = {"arch": ARCH, "shape": "train_4k", "mesh": "pod16x16",
              "tag": "baseline", "hw": HW_H100.name, "status": "ok",
              "compile_s": round(res.compile_s, 2),
              "memory": res.memory_stats, "roofline": res.report.to_dict()}
    log(dryrun_table([record]))
    log(roofline_table([record]))
    record["wall_s"] = time.perf_counter() - t0
    return record


def _meta_count(cfg, ts: TrainStepConfig, seq: int):
    with fake_group(1):
        mesh = DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.int64),
                          mesh_dim_names=AXES)
        state = reshard_state(_meta_train_state(cfg, ts), mesh)
        batch = {k: _place(v, mesh)
                 for k, v in input_specs(cfg, STEP["batch"], seq).items()}
        trace, _ = trace_step(make_train_step(cfg, ts), state, batch)
    return trace


def _place(t: torch.Tensor, mesh):
    """A batch leaf laid out by ``batch_pspec``."""
    spec = batch_pspec(mesh, t.dim() - 1)
    return distribute_tensor(t, mesh, placements(spec, mesh),
                             src_data_rank=None)


def _card_count(cfg, ts: TrainStepConfig, seq: int, device):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    live = torch.cuda.memory_allocated()
    with one_rank_mesh(device) as mesh:
        gen = torch.Generator(device=device).manual_seed(0)
        state = reshard_state(init_train_state(cfg, ts, gen, device), mesh)
        data = SyntheticLMData(cfg, STEP["batch"], seq, seed=0)
        batch = {k: _place(torch.from_numpy(v).to(device), mesh)
                 for k, v in data.batch(0).items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trace, (state, metrics) = trace_step(make_train_step(cfg, ts),
                                             state, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - live
        del state, metrics, batch
    torch.cuda.empty_cache()
    return trace, peak, loss, wall


def count_twice(device="cuda", log: Callable = print,
                n_layers: Optional[int] = None,
                measured_step_ms: Optional[float] = None) -> Dict:
    """(b), at ``n_layers`` (default: all 28)."""
    cfg = get_config(ARCH)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    seq = SHAPES["train_4k"].seq_len
    ts = TrainStepConfig(microbatches=STEP["microbatches"])
    meta = _meta_count(cfg, ts, seq)
    card, measured, loss, wall = _card_count(cfg, ts, seq, device)
    report = analyze_trace(meta, arch=ARCH, shape="train_4k",
                           mesh_name="one-rank", chips=1, mflops=0.0)
    predicted = report.peak_mem_bytes
    share = abs(predicted - measured) / measured
    out = {"layers": cfg.n_layers, "flops_meta": meta.flops,
           "flops_card": card.flops, "bytes_meta": meta.bytes_accessed,
           "bytes_card": card.bytes_accessed,
           "memory_meta": meta.memory, "memory_card": card.memory,
           "predicted_peak_bytes": predicted,
           "measured_peak_bytes": measured, "peak_error": share,
           "modeled_step_s": report.step_time_s,
           "modeled_terms_s": {"compute": report.compute_s,
                               "memory": report.memory_s,
                               "collective": report.collective_s},
           "measured_step_ms": measured_step_ms, "loss": loss,
           "meta_trace_s": meta.seconds, "card_step_s": wall}
    log(f"  {cfg.n_layers} layers, {STEP['batch']} x {seq} tokens in "
        f"{STEP['microbatches']} microbatches: flops on meta "
        f"{meta.flops:.6e}, on the card {card.flops:.6e}; bytes accessed "
        f"{meta.bytes_accessed:.6e} / {card.bytes_accessed:.6e}")
    log(f"  peak memory predicted {predicted / 2**30:.3f} GiB, measured "
        f"(max_memory_allocated) {measured / 2**30:.3f} GiB: "
        f"{share:.1%} apart (gate {PEAK_GATE:.0%})")
    log(f"  modeled step {report.step_time_s * 1e3:.1f} ms at "
        f"{HW_H100.name} ({report.bottleneck}-bound: compute "
        f"{report.compute_s * 1e3:.1f}, memory {report.memory_s * 1e3:.1f} "
        "ms)" + (f"; the training phase measured {measured_step_ms:.1f} ms"
                 if measured_step_ms is not None else ""))
    if meta.flops != card.flops:
        _fail(f"flops on meta {meta.flops} != on the card {card.flops}")
    if not loss == loss:
        _fail(f"the counted step's loss is not finite: {loss}")
    if share > PEAK_GATE:
        _fail(f"predicted peak {predicted} is {share:.1%} off the measured "
              f"{measured} (gate {PEAK_GATE:.0%})")
    return out


def _decode_inputs(cfg, mesh, device):
    """(c)'s inputs on ``device`` ("meta": shapes only), laid out as
    ``plan_cell`` lays a decode cell out."""
    b = DECODE["batch"]
    if torch.device(device).type == "meta":
        params = abstract_lm(cfg)
    else:
        params = stack_layers(init_lm(
            cfg, torch.Generator(device).manual_seed(0), device))
    cache = init_cache(cfg, b, DECODE["capacity"], device)
    tokens = torch.zeros((b, 1), dtype=torch.int32, device=device)
    if torch.device(device).type != "meta":
        cache["pos"].fill_(DECODE["pos"])
    p_sh = param_shardings(params, mesh, serving_rules())
    c_sh = cache_shardings(cache, mesh, batch=b)
    return (reshard_tree(params, p_sh, mesh), _place(tokens, mesh),
            reshard_tree(cache, c_sh, mesh))


def _serve_step(cfg):
    def step(params, tokens, cache):
        return lm_decode_step(unstack_layers(params), tokens, cache, cfg)

    return step


def count_decode(device="cuda", log: Callable = print) -> Dict:
    """(c)."""
    cfg = get_config(ARCH)
    with fake_group(1):
        mesh = DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.int64),
                          mesh_dim_names=AXES)
        args = _decode_inputs(cfg, mesh, "meta")
        with _under(mesh):
            meta, _ = trace_step(_serve_step(cfg), *args)
        del args
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    live = torch.cuda.memory_allocated()
    with one_rank_mesh(device) as mesh:
        args = _decode_inputs(cfg, mesh, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _under(mesh):
            card, (logits, _) = trace_step(_serve_step(cfg), *args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        measured = torch.cuda.max_memory_allocated() - live
        finite = bool(torch.isfinite(logits.to_local()[..., :cfg.vocab])
                      .all())
        cache_bytes = sum(t.to_local().numel() * t.element_size()
                          for t in args[2]["layers"].values())
        del args, logits
    torch.cuda.empty_cache()
    report = analyze_trace(meta, arch=ARCH, shape="decode_32k",
                           mesh_name="one-rank", chips=1, mflops=0.0)
    predicted = report.peak_mem_bytes
    share = abs(predicted - measured) / measured
    out = {"batch": DECODE["batch"], "capacity": DECODE["capacity"],
           "cache_bytes": cache_bytes, "flops_meta": meta.flops,
           "flops_card": card.flops, "bytes_meta": meta.bytes_accessed,
           "bytes_card": card.bytes_accessed, "memory_meta": meta.memory,
           "memory_card": card.memory, "predicted_peak_bytes": predicted,
           "measured_peak_bytes": measured, "peak_error": share,
           "modeled_step_s": report.step_time_s,
           "modeled_terms_s": {"compute": report.compute_s,
                               "memory": report.memory_s,
                               "collective": report.collective_s},
           "card_traced_step_s": wall, "meta_trace_s": meta.seconds,
           "logits_finite": finite}
    log(f"  decode step, {cfg.n_layers} layers, B = {DECODE['batch']} (cut "
        f"from 128), capacity {DECODE['capacity']:,} (cache "
        f"{cache_bytes / 1e9:.2f} GB): flops on meta {meta.flops:.6e}, on "
        f"the card {card.flops:.6e}; bytes accessed "
        f"{meta.bytes_accessed:.6e} / {card.bytes_accessed:.6e}")
    log(f"  peak memory predicted {predicted / 2**30:.3f} GiB, measured "
        f"(max_memory_allocated) {measured / 2**30:.3f} GiB: {share:.1%} "
        f"apart (gate {PEAK_GATE:.0%})")
    log(f"  modeled step {report.step_time_s * 1e3:.3f} ms at {HW_H100.name} "
        f"({report.bottleneck}-bound); the traced step on the card took "
        f"{wall * 1e3:.1f} ms (the trace's per-op overhead included)")
    if meta.flops != card.flops:
        _fail(f"decode flops on meta {meta.flops} != on the card "
              f"{card.flops}")
    if not finite:
        _fail("the counted decode step's logits are not finite")
    if share > PEAK_GATE:
        _fail(f"decode: predicted peak {predicted} is {share:.1%} off the "
              f"measured {measured} (gate {PEAK_GATE:.0%})")
    return out


def run(device="cuda", log: Callable = print,
        measured_step_ms: Optional[float] = None) -> Dict:
    """Both parts; ``measured_step_ms`` is the training phase's median
    bf16 step, printed beside the modeled one."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the dry-run phase measures a card: pass a CUDA "
                         "device")
    t0 = time.perf_counter()
    log("  (a) qwen3-0.6b train_4k on pod16x16 (a fake group of 256 ranks, "
        "meta tensors)")
    result = {"cell": plan_and_account(log)}
    log("  (b) the training phase's bf16 step, counted on meta and on the "
        "card")
    result["count"] = count_twice(device, log,
                                  measured_step_ms=measured_step_ms)
    log("  (c) qwen3-0.6b's decode step (decode_32k's capacity, B = 4), "
        "counted on meta and on the card")
    result["decode"] = count_decode(device, log)
    result["seconds"] = time.perf_counter() - t0
    log(f"  the dry-run phase took {result['seconds']:.1f} s")
    return result


if __name__ == "__main__":
    print(json.dumps(run(), default=str))

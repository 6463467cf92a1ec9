"""The LM training path on one card: the checks and timings that
``chip_smoke.py`` runs in its training phase.

:func:`run` raises :class:`~repro_torch.testing.lm_card.LMCheckFailed`
on the first failed check and otherwise returns what it measured:

  (a) qwen3-0.6b at its published width, 2 of its 28 layers, fp32 (TF32
      off), B = 2, T = 64, seed 0: the card's loss and gradients against
      the same call on the CPU; 4 microbatches against 1 (B = 4) and
      remat on against off; one step each under int8 compression, top-k
      compression and 8-bit moments from the same gradients on the card
      and on the CPU (int8 codes within one step, scales ``rtol=1e-6``,
      the same top-k entries up to ties at the k-th magnitude);
  (b) qwen3-0.6b at full width and depth in bf16 on the ``train_4k``
      shape (4,096 tokens) with the global batch cut from 256 to 8 (4
      microbatches of 2), remat on: 6 steps, the median step time of the
      last 4 by CUDA events, tokens/s, peak memory, the share of the
      step's bound, and a profile of the sixth step;
  (c) the loss falling over 20 steps at full width, 2 layers, bf16
      (the reference's loss-curve test: lr 1e-3, 5 warmup steps, 2
      microbatches, B = 8, T = 128);
  (d) a checkpoint of (c)'s state saved, restored and continued: the
      restored state bitwise the saved one, its next loss the
      uninterrupted run's; and ``launch/train.py --reduced`` resuming in
      a temporary directory.

The CPU side of (a) runs on a worker thread while the card runs (b):
the card's steps queue far ahead of its work, so the host's other load
does not reach their CUDA-event times.

Run it alone on a card with ``python -m repro_torch.testing.lm_train_card``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.data.synthetic import SyntheticLMData
from repro_torch.launch import train as launch_train
from repro_torch.testing.lm_card import LMCheckFailed, _close, _fail
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.compression import (CompressionConfig, compress_int8,
                                           compress_topk, init_error)
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.pytree import leaf_paths, tree_map
from repro_torch.train.train_step import (TrainStepConfig, accumulate_grads,
                                          apply_gradients, init_train_state,
                                          make_train_step)

__all__ = ["LMCheckFailed", "run", "step_flops"]

ARCH = "qwen3-0.6b"
# (a): the card's gradients against the CPU's: fp32 sums in another order,
# each leaf within rtol and atol of the model's largest gradient entry
CARD_CPU_RTOL, CARD_CPU_ATOL = 1e-3, 1e-4
LOSS_RTOL = 1e-5
SAME_ATOL = 1e-5           # microbatches / remat: of the largest gradient
SCALE_RTOL = 1e-6
FP32 = dict(layers=2, batch=2, seq=64, seed=0)
# (b): the global batch of train_4k (256) cut to 8 = 4 microbatches of 2
BF16 = dict(batch=8, microbatches=4, steps=6, timed=4)
FALL = dict(layers=2, batch=8, seq=128, steps=20, microbatches=2)
BF16_FLOPS_PER_S = 989e12  # H100 SXM data sheet, dense bf16 tensor cores


def _close_trees(label: str, got, want, rtol: float, log,
                 atol_of_max: float = 0.0, atol: float = 0.0) -> float:
    """Every leaf of ``got`` against ``want`` within ``rtol`` and ``atol
    + atol_of_max`` x the largest entry of ``want``; one line."""
    want_l = dict(leaf_paths(want))
    top = max(float(t.abs().max()) for t in want_l.values())
    tol = atol + atol_of_max * top
    worst = 0.0
    for path, g in leaf_paths(got):
        worst = max(worst, _close(f"{label} {path}", g, want_l[path], rtol,
                                  tol, log, show=False))
    log(f"  ok   {label}: {len(want_l)} leaves, max abs err {worst:.3e} "
        f"(rtol={rtol}, atol={tol:.3e})")
    return worst


def _batch(data: SyntheticLMData, step: int, device) -> Dict:
    return {k: torch.from_numpy(v).to(device)
            for k, v in data.batch(step).items()}


def _clone(tree, device=None):
    return tree_map(lambda t: t.detach().to(device or t.device, copy=True),
                    tree)


def _fresh(params, ts: TrainStepConfig, device):
    """A train state holding a copy of ``params`` on ``device``, with the
    optimizer state (and error buffers) of ``ts`` from zero."""
    params = _clone(params, device)
    new = {"params": params, "opt": adamw_init(params, ts.opt),
           "step": torch.zeros((), dtype=torch.int32, device=device)}
    if ts.compression.kind != "none":
        new["err"] = init_error(params)
    return new


INT8 = CompressionConfig(kind="int8")
TOPK = CompressionConfig(kind="topk")
EIGHT_BIT = TrainStepConfig(opt=AdamWConfig(quantize_state=True))


def _fp32_side(cfg, params, batch, grads) -> Dict:
    """The part of (a) computed on both devices: the loss and gradients
    at ``params`` on ``batch``, then from the same ``grads`` the int8 and
    top-k compressions and a step with 8-bit moments."""
    t0 = time.perf_counter()
    loss, _, own = accumulate_grads(cfg, TrainStepConfig(), params, batch)
    new, om = apply_gradients(_fresh(params, EIGHT_BIT, grads["embed"].device),
                              grads, EIGHT_BIT)
    return {"loss": loss, "grads": own,
            "int8": compress_int8(grads, init_error(grads), INT8)[0],
            "topk": compress_topk(grads, init_error(grads), TOPK)[0],
            "8bit": new, "8bit_lr": om["lr"],
            "seconds": time.perf_counter() - t0}


def start_fp32(device, log, pool) -> Dict:
    """(a) on the card, and its CPU side submitted to ``pool`` (a worker
    thread: it runs while the card runs (b); ``finish_fp32`` compares)."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=FP32["layers"],
                              dtype=torch.float32)
    ts = TrainStepConfig()
    gen = torch.Generator(device=device).manual_seed(FP32["seed"])
    params = init_train_state(cfg, ts, gen, device)["params"]
    data = SyntheticLMData(cfg, 2 * FP32["batch"], FP32["seq"],
                           seed=FP32["seed"])
    batch4 = _batch(data, 0, device)
    batch = {k: v[:FP32["batch"]] for k, v in batch4.items()}
    out = {"cut": f"depth 28 -> {FP32['layers']} layers, fp32",
           "params": sum(t.numel() for _, t in leaf_paths(params))}
    log(f"  qwen3-0.6b fp32, {FP32['layers']} layers: {out['params']:,} "
        f"parameters; B = {FP32['batch']}, T = {FP32['seq']}")

    _, _, grads = accumulate_grads(cfg, ts, params, batch)
    cpu = torch.device("cpu")
    # the CPU starts from copies of the card's parameters and gradients
    job = pool.submit(_fp32_side, cfg, _clone(params, cpu),
                      {k: v.cpu() for k, v in batch.items()},
                      _clone(grads, cpu))
    card = _fp32_side(cfg, params, batch, grads)

    _, _, g1 = accumulate_grads(cfg, ts, params, batch4)
    _, _, g4 = accumulate_grads(cfg, TrainStepConfig(microbatches=4), params,
                                batch4)
    out["microbatch_err"] = _close_trees(
        f"4 microbatches vs 1 (B = {2 * FP32['batch']})", g4, g1, 0.0, log,
        atol_of_max=SAME_ATOL)
    _, _, g_off = accumulate_grads(dataclasses.replace(cfg, remat=False), ts,
                                   params, batch)
    out["remat_err"] = _close_trees("remat off vs on", g_off, grads, 0.0,
                                    log, atol_of_max=SAME_ATOL)
    for kind, ts_k in (("int8", TrainStepConfig(compression=INT8)),
                       ("topk", TrainStepConfig(compression=TOPK))):
        new, om = apply_gradients(_fresh(params, ts_k, device), grads, ts_k)
        if not all(bool(torch.isfinite(t).all())
                   for _, t in leaf_paths(new["params"])):
            _fail(f"{kind} step: non-finite parameters")
        out[f"{kind}_step_grad_norm"] = float(om["grad_norm"])
    log("  the CPU side of (a) runs on a worker thread during (b)")
    return {"out": out, "card": card, "job": job, "grads": grads,
            "t_submit": time.perf_counter()}


def finish_fp32(ctx: Dict, log) -> Dict:
    """(a): the card against the CPU."""
    out, card = ctx["out"], ctx["card"]
    host = ctx["job"].result()
    out["cpu_side_s"] = host["seconds"]
    loss, loss_h = float(card["loss"]), float(host["loss"])
    out["loss"] = loss
    out["loss_rel_err"] = abs(loss - loss_h) / abs(loss_h)
    log(f"  loss card {loss:.7f}, CPU {loss_h:.7f} (rel err "
        f"{out['loss_rel_err']:.2e}, rtol {LOSS_RTOL}; the CPU side took "
        f"{host['seconds']:.1f} s)")
    if out["loss_rel_err"] > LOSS_RTOL:
        _fail("fp32 loss, card vs CPU")
    out["grad_card_vs_cpu_err"] = _close_trees(
        "gradients, card vs CPU", card["grads"], host["grads"],
        CARD_CPU_RTOL, log, atol_of_max=CARD_CPU_ATOL)

    code_diff, scale_err = 0, 0.0
    for (path, c), (_, h) in zip(leaf_paths(card["int8"]),
                                 leaf_paths(host["int8"])):
        if path.endswith("/q"):
            code_diff = max(code_diff, int((c.cpu().int() - h.int()).abs()
                                           .max()))
        else:
            scale_err = max(scale_err, _close(f"int8 scale {path}", c, h,
                                              SCALE_RTOL, 0.0, log,
                                              show=False))
    out["int8_code_diff"] = code_diff
    log(f"  {'ok  ' if code_diff <= 1 else 'FAIL'} int8 compression, card "
        f"vs CPU from the same gradients: codes within {code_diff} step(s), "
        f"scales within rtol {SCALE_RTOL} (max abs err {scale_err:.3e})")
    if code_diff > 1:
        _fail("int8 codes, card vs CPU")

    entries = ties = 0
    for path, _ in leaf_paths(ctx["grads"]):
        same, n_above, n_tied = _same_topk(_node(card["topk"], path),
                                           _node(host["topk"], path))
        if not same:
            _fail(f"top-k index set of {path}, card vs CPU")
        entries += n_above
        ties += n_tied
    out["topk_entries_above_threshold"] = entries
    out["topk_entries_at_threshold"] = ties
    log(f"  ok   top-k compression (5%), card vs CPU from the same "
        f"gradients: the same index set ({entries:,} entries above each "
        f"leaf's k-th magnitude; {ties:,} at it, tied, chosen by "
        "magnitude alone)")

    new, new_h = card["8bit"], host["8bit"]
    code_diff, scale_err = 0, 0.0
    for key in ("m", "v"):
        for (path, c), (_, h) in zip(leaf_paths(new["opt"][key]),
                                     leaf_paths(new_h["opt"][key])):
            code_diff = max(code_diff, int((c.cpu().int() - h.int()).abs()
                                           .max()))
        for (path, c), (_, h) in zip(leaf_paths(new["opt"][f"{key}_scale"]),
                                     leaf_paths(new_h["opt"][f"{key}_scale"])):
            scale_err = max(scale_err, _close(f"8-bit {key} scale {path}", c,
                                              h, SCALE_RTOL, 0.0, log,
                                              show=False))
    out["8bit_code_diff"] = code_diff
    log(f"  {'ok  ' if code_diff <= 1 else 'FAIL'} 8-bit moments, card vs "
        f"CPU from the same gradients: codes within {code_diff} step(s), "
        f"scales within rtol {SCALE_RTOL} (max abs err {scale_err:.3e})")
    if code_diff > 1:
        _fail("8-bit moment codes, card vs CPU")
    # the same fp32 update of the same values on both: rtol 1e-5, and
    # 1e-4 of a step (lr) where the result cancels to near 0
    out["8bit_param_err"] = _close_trees(
        "8-bit step parameters, card vs CPU", new["params"], new_h["params"],
        LOSS_RTOL, log, atol=1e-4 * float(host["8bit_lr"]))
    return out


def _same_topk(c: Dict, h: Dict):
    """Whether two top-k selections of the same values agree: the same
    count, the same selected magnitudes, and the same indices above the
    k-th magnitude.  Entries tied at the k-th magnitude (equal fp32
    values, or the exact zeros of embedding rows no token touched) may be
    picked either way.  Returns (same, entries above, entries at it)."""
    mag, mag_h = c["val"].abs().cpu(), h["val"].abs()
    if mag.numel() != mag_h.numel():
        return False, 0, 0
    if not torch.equal(mag.sort().values, mag_h.sort().values):
        return False, 0, 0
    kth = mag.min()
    above = c["idx"].cpu()[mag > kth].sort().values
    above_h = h["idx"][mag_h > kth].sort().values
    return (torch.equal(above, above_h), above.numel(),
            mag.numel() - above.numel())


def _node(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def step_flops(cfg, n_params: int, tokens: int, seq: int) -> float:
    """Operations of one train step: ``6 n_params`` a token for the
    parameters (forward and backward; the tied head is one tensor, counted
    once), and three times the causal attention products, ``4 (seq / 2)
    (heads x head_dim)`` a token and layer forward."""
    attn = 4 * (seq / 2) * cfg.n_heads * cfg.head_dim * cfg.n_layers
    return 6.0 * n_params * tokens + 3.0 * attn * tokens


def time_bf16(device, log, profile: Optional[Callable]) -> Dict:
    """(b)."""
    cfg = get_config(ARCH)
    seq = SHAPES["train_4k"].seq_len
    ts = TrainStepConfig(microbatches=BF16["microbatches"])
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_train_state(cfg, ts, gen, device)
    data = SyntheticLMData(cfg, BF16["batch"], seq, seed=0)
    step = make_train_step(cfg, ts)
    tokens = BF16["batch"] * seq
    n_params = sum(t.numel() for _, t in leaf_paths(state["params"]))
    flops = step_flops(cfg, n_params, tokens, seq)
    out = {"cut": (f"global batch {SHAPES['train_4k'].global_batch} -> "
                   f"{BF16['batch']} ({BF16['microbatches']} microbatches "
                   f"of {BF16['batch'] // BF16['microbatches']}); published "
                   "width and depth"),
           "dtype": str(cfg.dtype), "remat": cfg.remat, "seq": seq,
           "tokens_per_step": tokens, "params": n_params,
           "step_flops": flops, "bound_s": flops / BF16_FLOPS_PER_S}
    log(f"  qwen3-0.6b {cfg.dtype}, {cfg.n_layers} layers, remat: {out['cut']}; "
        f"{tokens:,} tokens a step, {flops / 1e12:.1f} TFLOP, bound "
        f"{out['bound_s']:.4f} s at 989 TFLOP/s")
    batches = [_batch(data, i, device) for i in range(BF16["steps"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, losses = [], []
    holder = {"state": state}

    def one_step(b):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        holder["state"], metrics = step(holder["state"], b)
        ev[1].record()
        events.append(ev)
        losses.append(metrics["loss"])

    t0 = time.perf_counter()
    for b in batches[:-1]:
        one_step(b)
    if profile is None:
        one_step(batches[-1])
    else:
        # the last step runs under the profiler, its CUDA events too: the
        # five before it warm it up
        log(f"  profile of step {BF16['steps']}:")
        out["profile"] = profile(lambda: one_step(batches[-1]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = [a.elapsed_time(z) for a, z in events]
    losses = [float(x) for x in losses]
    if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
        _fail(f"bf16 train_4k losses not finite: {losses}")
    median_ms = statistics.median(step_ms[-BF16["timed"]:])
    out.update(step_ms=step_ms, losses=losses, wall_s=wall,
               median_step_ms=median_ms,
               tokens_per_s=tokens / (median_ms / 1e3),
               peak_bytes=torch.cuda.max_memory_allocated() - live,
               bound_share=out["bound_s"] / (median_ms / 1e3))
    log(f"  {BF16['steps']} steps: {', '.join(f'{t:.1f}' for t in step_ms)} "
        f"ms (CUDA events; the last profiled); median of the last "
        f"{BF16['timed']} {median_ms:.1f} ms, {out['tokens_per_s']:,.0f} "
        f"tokens/s, {out['bound_share']:.3f} of the bound; peak memory "
        f"{out['peak_bytes'] / 2**30:.2f} GiB; losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}")
    return out


def check_loss_falls(device, log) -> Dict:
    """(c); returns the state too, for (d)."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=FALL["layers"])
    ts = TrainStepConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=5),
                         microbatches=FALL["microbatches"])
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_train_state(cfg, ts, gen, device)
    data = SyntheticLMData(cfg, FALL["batch"], FALL["seq"], seed=0)
    step = make_train_step(cfg, ts)
    losses = []
    for i in range(FALL["steps"]):
        state, metrics = step(state, _batch(data, i, device))
        losses.append(metrics["loss"])
    losses = [float(x) for x in losses]
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    ok = last < first
    log(f"  {'ok  ' if ok else 'FAIL'} bf16, {FALL['layers']} layers, "
        f"{FALL['steps']} steps: mean loss of the first 5 {first:.4f}, of "
        f"the last 5 {last:.4f}")
    if not ok:
        _fail("the loss did not fall")
    return {"losses": losses, "first5": first, "last5": last,
            "_state": state, "_cfg": cfg, "_ts": ts, "_data": data}


def check_resume(fall: Dict, device, log) -> Dict:
    """(d)."""
    state, cfg, ts, data = (fall["_state"], fall["_cfg"], fall["_ts"],
                            fall["_data"])
    step = make_train_step(cfg, ts)
    at = int(state["step"])
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(f"{tmp}/ck", keep_n=2)
        t0 = time.perf_counter()
        mgr.save_async(state, at)
        saved = _clone(state)
        mgr.wait()
        out["save_s"] = time.perf_counter() - t0
        batch = _batch(data, at, device)
        _, m_a = step(state, batch)                      # uninterrupted
        t0 = time.perf_counter()
        restored, got = mgr.restore(saved)
        out["restore_s"] = time.perf_counter() - t0
        if got != at:
            _fail(f"restored step {got}, saved {at}")
        for (path, r), (_, s) in zip(leaf_paths(restored), leaf_paths(saved)):
            if r.dtype != s.dtype or r.device != s.device or \
                    not torch.equal(r, s):
                _fail(f"restored leaf {path} is not the saved one")
        _, m_b = step(restored, batch)
        rel = abs(float(m_b["loss"]) - float(m_a["loss"])) / abs(
            float(m_a["loss"]))
        out.update(step=at, next_loss=float(m_a["loss"]),
                   next_loss_rel_err=rel)
        log(f"  ok   saved at step {at} ({out['save_s']:.2f} s) and restored "
            f"({out['restore_s']:.2f} s): every leaf bitwise; next loss "
            f"{float(m_b['loss']):.6f} vs {float(m_a['loss']):.6f} "
            f"uninterrupted (rel err {rel:.1e}, rtol {LOSS_RTOL})")
        if rel > LOSS_RTOL:
            _fail("the resumed run's next loss")

        args = ["--arch", ARCH, "--reduced", "--checkpoint-dir",
                f"{tmp}/cli", "--log-every", "1"]
        first = launch_train.run(launch_train.parse_args(args
                                                         + ["--steps", "2"]))
        again = launch_train.run(launch_train.parse_args(args
                                                         + ["--steps", "3"]))
        if first["start_step"] != 0 or again["start_step"] != 2 or \
                len(again["losses"]) != 1:
            _fail("launch/train.py did not resume at step 2")
        dev = {t.device.type for _, t in leaf_paths(again["state"])}
        if dev != {device.type}:
            _fail(f"launch/train.py without --device ran on {dev}")
        out["cli_resumed_at"] = again["start_step"]
        log("  ok   launch/train.py --reduced (on the card by default): 2 "
            "steps, then --steps 3 resumed at step 2")
    return out


def run(device="cuda", log: Callable = print,
        profile: Optional[Callable] = None) -> Dict:
    """All four parts on ``device`` (a card); ``profile`` (a callable that
    profiles one call of a function and returns a dict) is applied to one
    bf16 step of (b).  TF32 is off throughout."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the training phase measures a card: pass a CUDA "
                         "device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        log("  (a) qwen3-0.6b at full width, 2 layers, fp32: card vs CPU")
        fp32 = start_fp32(device, log, pool)
        log("  (b) qwen3-0.6b bf16 at full width and depth, train_4k")
        result["bf16_train_4k"] = time_bf16(device, log, profile)
        torch.cuda.empty_cache()
        log("  (a), continued: the card against the CPU")
        result["fp32"] = finish_fp32(fp32, log)
        del fp32
    log("  (c) the loss falls: bf16, 2 layers, 20 steps")
    fall = check_loss_falls(device, log)
    log("  (d) save, restore, continue")
    result["resume"] = check_resume(fall, device, log)
    result["loss_falls"] = {k: v for k, v in fall.items()
                            if not k.startswith("_")}
    del fall
    torch.cuda.empty_cache()
    result["seconds"] = time.perf_counter() - t0
    log(f"  the training phase took {result['seconds']:.1f} s")
    return result


if __name__ == "__main__":
    print(json.dumps(run(), default=str))

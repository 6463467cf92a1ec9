"""The LM serving path on one card: the checks and timings that
``chip_smoke.py`` runs in its LM phase.

:func:`run` raises :class:`LMCheckFailed` on the first failed check and
otherwise returns what it measured:

  (a) qwen3-0.6b at its published width and depth in fp32: T decode
      steps from an empty cache against the parallel forward (the
      tolerances of ``tests/test_model_consistency.py``), and the card's
      ``lm_prefill`` against the same call on the CPU, same weights and
      tokens;
  (b) qwen3-0.6b at its configuration's bf16: the continuous-batching
      server (16 requests, 4 slots, prompts of 4-128 tokens, 64 new
      tokens each): tokens/s, each decode step's time (CUDA events),
      ``lm_prefill`` at a 512-token prompt, peak memory, and a profile
      of a few decode steps;
  (c) every other family once in fp32, decode against the forward, at
      the sizes :data:`FAMILY_CASES` names (each cut printed).

Run it alone on a card with ``python -m repro_torch.testing.lm_card``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.launch.serve import make_prompts, serve
from repro_torch.models.lm import (ENCDEC_FAMILIES, encode, init_cache,
                                   init_lm, lm_decode_step, lm_forward,
                                   lm_prefill, tree_map)

__all__ = ["LMCheckFailed", "FamilyCase", "FAMILY_CASES", "run"]

# tests/test_model_consistency.py: decode against the parallel forward
CONSISTENCY_RTOL = 1e-3
CONSISTENCY_ATOL = 2e-3
CONSISTENCY_ATOL_MOE = 5e-3      # MoE and MLA
# the card's prefill against the CPU's: fp32 sums in another order
CARD_CPU_RTOL = 1e-4
CARD_CPU_ATOL = 1e-4             # of the largest entry
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet

SERVE = dict(requests=16, slots=4, prompt_len=128, max_new=64)
PREFILL_TOKENS = 512
PROFILE_STEPS = 4


class LMCheckFailed(RuntimeError):
    """A check of the LM phase failed."""


@dataclasses.dataclass(frozen=True)
class FamilyCase:
    """One architecture's decode-against-forward check: ``reduced`` takes
    ``get_reduced`` sizes, ``overrides`` replace fields of the
    configuration, ``tokens`` is (B, T); ``cut`` says what was cut."""

    arch: str
    cut: str
    overrides: tuple = ()
    reduced: bool = False
    tokens: tuple = (2, 16)
    atol: float = CONSISTENCY_ATOL
    name: str = ""

    @property
    def label(self) -> str:
        return self.name or (f"{self.arch} reduced" if self.reduced
                             else self.arch)


FAMILY_CASES = (
    FamilyCase("mamba2-2.7b", "none: published widths, full depth (64 "
               "layers)"),
    FamilyCase("zamba2-1.2b", "none: published widths, full depth (38 mamba "
               "layers, 6 shared-block calls)"),
    FamilyCase("seamless-m4t-medium", "none: published widths, full depth "
               "(12 + 12 layers); src_embeds (2, 16, 1024) from the seed"),
    FamilyCase("moonshot-v1-16b-a3b", "depth 48 -> 2 layers; capacity_factor "
               "4.0 and T = 4, so 8 tokens fit an expert's capacity of 8 "
               "(dropless)", overrides=(("n_layers", 2),
                                        ("capacity_factor", 4.0)),
               tokens=(2, 4), atol=CONSISTENCY_ATOL_MOE),
    FamilyCase("deepseek-v3-671b", "get_reduced sizes (one fp32 layer at "
               "published widths holds 45 GB of experts); capacity_factor 4.0 "
               "(dropless)",
               overrides=(("capacity_factor", 4.0),), reduced=True,
               atol=CONSISTENCY_ATOL_MOE),
    FamilyCase("internvl2-76b", "get_reduced sizes; decode against the "
               "forward over the tokens, and the prefill with the 8-patch "
               "prefix against the forward with it", reduced=True),
    FamilyCase("internvl2-76b", "depth 80 -> 2 layers at published widths "
               "(3.4 GB a layer and 8.4 GB of embedding and head in fp32); "
               "the same two checks with the 256-patch prefix",
               overrides=(("n_layers", 2),), name="internvl2-76b 2 layers"),
)


def _fail(msg: str):
    raise LMCheckFailed(msg)


def _close(label: str, out: torch.Tensor, ref: torch.Tensor, rtol: float,
           atol: float, log, show: bool = True) -> float:
    """Fail unless ``out`` is finite and within tolerance of ``ref``
    (compared on ``out``'s device); returns the max abs error.  The line
    is logged when ``show`` or on failure."""
    out, ref = out.float(), ref.to(out.device).float()
    if out.shape != ref.shape:
        _fail(f"{label}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    if not bool(torch.isfinite(out).all()):
        _fail(f"{label}: non-finite values")
    err = (out - ref).abs().max().item() if out.numel() else 0.0
    ok = torch.allclose(out, ref, rtol=rtol, atol=atol)
    if show or not ok:
        log(f"  {'ok  ' if ok else 'FAIL'} {label}: max abs err {err:.3e} "
            f"(rtol={rtol}, atol={atol:.3e})")
    if not ok:
        _fail(label)
    return err


def _config(case: FamilyCase):
    cfg = get_reduced(case.arch) if case.reduced else get_config(case.arch)
    return dataclasses.replace(cfg, dtype=torch.float32, **dict(case.overrides))


def _n_params(params) -> int:
    count = []
    tree_map(lambda x: count.append(x.numel()), params)
    return sum(count)


def _n_bytes(tree) -> int:
    sizes = []
    tree_map(lambda x: sizes.append(x.numel() * x.element_size()), tree)
    return sum(sizes)


def _tokens(cfg, b: int, t: int, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (b, t))).to(device)


def decode_against_forward(label: str, cfg, params, tokens, device, atol,
                           log, extra: Optional[Dict] = None) -> float:
    """T decode steps from an empty cache against the causal parallel
    forward's logits at every position."""
    b, t = tokens.shape
    extra = extra or {}
    par, _ = lm_forward(params, {"tokens": tokens, **extra}, cfg)
    cache = init_cache(cfg, b, t + 2, device=device)
    if cfg.family in ENCDEC_FAMILIES:
        cache["memory"] = encode(params, extra["src_embeds"], cfg)
    outs = []
    for i in range(t):
        lg, cache = lm_decode_step(params, tokens[:, i:i + 1], cache, cfg)
        outs.append(lg[:, 0])
    return _close(f"{label}: {t} decode steps vs the forward (B = {b})",
                  torch.stack(outs, dim=1), par, CONSISTENCY_RTOL, atol, log)


def _cuda_ms(fn, reps: int = 3) -> float:
    """Median over ``reps`` of one call's time by CUDA events, after one
    warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z))
    return statistics.median(times)


def check_qwen3_fp32(device, log) -> Dict:
    """(a): decode against the forward, and the card against the CPU."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), dtype=torch.float32)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_lm(cfg, gen, device)
    out = {"params": _n_params(params), "param_count": cfg.param_count()}
    log(f"  qwen3-0.6b fp32: {out['params']:,} parameters on the card "
        f"(param_count {out['param_count']:,}, the embedding counted once: "
        f"tied), padded vocab {cfg.padded_vocab:,}")
    tokens = _tokens(cfg, 2, 16, 1, device)
    out["decode_vs_forward_err"] = decode_against_forward(
        "qwen3-0.6b fp32", cfg, params, tokens, device, CONSISTENCY_ATOL, log)

    prompt = _tokens(cfg, 2, 32, 2, device)
    lg_card, cache_card = lm_prefill(params, {"tokens": prompt}, cfg, 40)
    params_cpu = tree_map(lambda x: x.cpu(), params)
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lg_cpu, cache_cpu = lm_prefill(params_cpu, {"tokens": prompt.cpu()}, cfg,
                                   40)
    out["cpu_prefill_s"] = time.perf_counter() - t0
    v = cfg.vocab
    if not (bool((lg_card[..., v:] == -1e30).all())
            and bool((lg_cpu[..., v:] == -1e30).all())):
        _fail("qwen3-0.6b prefill: the pad columns are not -1e30")
    scale = lg_cpu[..., :v].abs().max().item()
    out["card_vs_cpu_logits_err"] = _close(
        "qwen3-0.6b fp32 prefill logits, card vs CPU (2 x 32 tokens)",
        lg_card[..., :v], lg_cpu[..., :v], CARD_CPU_RTOL,
        CARD_CPU_ATOL * scale, log)
    for key in ("k", "v"):
        ref = cache_cpu["layers"][key]
        out[f"card_vs_cpu_{key}_err"] = _close(
            f"qwen3-0.6b fp32 prefill cache {key}, card vs CPU",
            cache_card["layers"][key], ref, CARD_CPU_RTOL,
            CARD_CPU_ATOL * ref.abs().max().item(), log)
    return out


def serve_qwen3_bf16(device, log, profile: Optional[Callable]) -> Dict:
    """(b): the server at bf16, the prefill at 512 tokens, the profile.
    Peak memory is counted above what was live before the weights (a
    caller's own tensors are not the server's)."""
    cfg = get_config("qwen3-0.6b")
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_lm(cfg, gen, device)
    weight_bytes = _n_bytes(params)
    capacity = SERVE["prompt_len"] + SERVE["max_new"]
    kv_per_token = (2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim
                    * torch.finfo(cfg.dtype).bits // 8)
    out = {"dtype": str(cfg.dtype), "weight_bytes": weight_bytes,
           "kv_bytes_per_token": kv_per_token, "capacity": capacity,
           "decode_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3}
    log(f"  qwen3-0.6b {cfg.dtype}: weights {weight_bytes / 1e9:.3f} GB, "
        f"KV {kv_per_token / 1024:.0f} KiB a token, decode bound (weights "
        f"read once at 3.35 TB/s) {out['decode_bound_ms']:.3f} ms")

    prompts = make_prompts(cfg, SERVE["requests"], SERVE["prompt_len"], 0)
    serve(params, cfg, [p[:4] for p in prompts[:2]], slots=SERVE["slots"],
          capacity=capacity, max_new=4, device=device)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = serve(params, cfg, prompts, slots=SERVE["slots"], capacity=capacity,
                max_new=SERVE["max_new"], device=device)
    out.update(
        requests=len(prompts), prompt_tokens=int(sum(len(p) for p in prompts)),
        new_tokens=res.new_tokens, seconds=res.seconds,
        tokens_per_s=res.tokens_per_s, decode_steps=res.steps,
        feed_steps=res.feed_steps, decode_step_ms_median=res.median_step_ms,
        decode_step_ms_p90=float(np.percentile(res.step_ms, 90)),
        peak_bytes=torch.cuda.max_memory_allocated() - live,
        logits_finite=res.logits_finite)
    log(f"  served {len(prompts)} requests ({out['prompt_tokens']} prompt "
        f"tokens, {res.new_tokens} new) in {res.seconds:.2f} s: "
        f"{res.tokens_per_s:.1f} tokens/s; {res.steps} decode steps, "
        f"{res.feed_steps} prompt-feed steps; decode step median "
        f"{res.median_step_ms:.3f} ms (p90 {out['decode_step_ms_p90']:.3f}; "
        f"CUDA events); peak memory {out['peak_bytes'] / 2**30:.3f} GiB "
        f"(weights, cache and transients)")
    if not res.logits_finite:
        _fail("qwen3-0.6b bf16 server: non-finite logits")
    if any(len(v) != SERVE["max_new"] for v in res.outputs.values()):
        _fail("qwen3-0.6b bf16 server: a request got the wrong token count")

    prompt = _tokens(cfg, 1, PREFILL_TOKENS, 3, device)
    torch.cuda.reset_peak_memory_stats()
    lg, _ = lm_prefill(params, {"tokens": prompt}, cfg, PREFILL_TOKENS)
    if not bool(torch.isfinite(lg).all()):
        _fail("qwen3-0.6b bf16 prefill: non-finite logits")
    out["prefill_ms"] = _cuda_ms(lambda: lm_prefill(
        params, {"tokens": prompt}, cfg, PREFILL_TOKENS))
    out["prefill_peak_bytes"] = torch.cuda.max_memory_allocated() - live
    log(f"  lm_prefill at {PREFILL_TOKENS} tokens: {out['prefill_ms']:.3f} ms "
        f"(CUDA events, median of 3), peak memory "
        f"{out['prefill_peak_bytes'] / 2**30:.3f} GiB")

    if profile is not None:
        cache = init_cache(cfg, SERVE["slots"], capacity, device=device)
        cache["pos"].fill_(SERVE["prompt_len"])
        tok = _tokens(cfg, SERVE["slots"], 1, 4, device)

        def steps():
            c = cache
            for _ in range(PROFILE_STEPS):
                _, c = lm_decode_step(params, tok, c, cfg)

        log(f"  profile of {PROFILE_STEPS} decode steps (4 slots at "
            f"position {SERVE['prompt_len']}):")
        out["profile"] = profile(steps)
    return out


def check_families(device, log) -> Dict:
    """(c): every other family once, in fp32."""
    out = {}
    for i, case in enumerate(FAMILY_CASES):
        t0 = time.perf_counter()
        cfg = _config(case)
        log(f"  {case.label} ({cfg.family}) cut: {case.cut}")
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_lm(cfg, gen, device)
        b, t = case.tokens
        tokens = _tokens(cfg, b, t, 10 + i, device)
        rng = np.random.default_rng(20 + i)
        extra = {}
        if cfg.family in ENCDEC_FAMILIES:
            extra["src_embeds"] = torch.from_numpy(rng.standard_normal(
                (b, t, cfg.d_model)).astype(np.float32)).to(device)
        rec = {"cut": case.cut, "params": _n_params(params),
               "tokens": [b, t]}
        rec["decode_vs_forward_err"] = decode_against_forward(
            f"{case.label} fp32", cfg, params, tokens, device, case.atol, log,
            extra)
        if cfg.family == "vlm":
            pe = torch.from_numpy(rng.standard_normal(
                (b, cfg.prefix_len, cfg.d_model)).astype(np.float32)).to(device)
            batch = {"tokens": tokens, "prefix_embeds": pe}
            par, _ = lm_forward(params, batch, cfg)
            pf, _ = lm_prefill(params, batch, cfg, t + 2)
            rec["prefix_prefill_vs_forward_err"] = _close(
                f"{case.label} fp32 prefill with the {cfg.prefix_len}-patch "
                "prefix vs the forward's last position", pf, par[:, -1:],
                CARD_CPU_RTOL, CARD_CPU_ATOL * par.abs().max().item(), log)
        del params
        torch.cuda.empty_cache()
        rec["seconds"] = time.perf_counter() - t0
        out[case.label] = rec
    return out


def run(device="cuda", log: Callable = print,
        profile: Optional[Callable] = None) -> Dict:
    """All three parts on ``device`` (a card); ``profile`` (a callable
    that profiles one call of a function and returns a dict) is applied
    to a few bf16 decode steps."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the LM phase measures a card: pass a CUDA device")
    result = {}
    t0 = time.perf_counter()
    with torch.inference_mode():
        log("  (a) qwen3-0.6b at full width and depth, fp32")
        result["qwen3_fp32"] = check_qwen3_fp32(device, log)
        log("  (b) qwen3-0.6b at bf16: the continuous-batching server")
        result["qwen3_bf16_serve"] = serve_qwen3_bf16(device, log, profile)
        log("  (c) the other families, fp32, decode against the forward")
        result["families"] = check_families(device, log)
    result["seconds"] = time.perf_counter() - t0
    log(f"  the LM phase took {result['seconds']:.1f} s")
    return result


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps(run(), default=str))

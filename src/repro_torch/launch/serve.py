"""Batched serving driver: continuous batching over decode slots.

Counterpart of ``repro.launch.serve`` (no HTTP; requests are synthetic):

  * ``slots`` decode slots share one KV cache (the stacked layout of
    ``models.lm.init_cache``);
  * each step decodes one token for every slot (one ``lm_decode_step``);
  * a finished request (its length budget spent) frees its slot; the next
    queued request is fed into it token by token through the same decode
    step, and only that slot's part of the cache is kept after each feed
    step (the per-slot splice): continuous batching.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --reduced --device cpu --requests 12 --slots 4 --max-new 16

Without ``--device`` it runs on the card.  :func:`serve` returns each
request's generated token ids and the timings.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.format import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import (ENCDEC_FAMILIES, init_cache, init_lm,
                                   lm_decode_step)

__all__ = ["ServeResult", "make_prompts", "serve", "main"]

# The batch axis of each cache entry: the server splices a slot along it.
_SLOT_AXIS = {"pos": 0, "memory": 0, "layers": 1, "shared_attn": 1}


@dataclasses.dataclass
class ServeResult:
    """What one :func:`serve` run produced and how long it took.

    ``step_ms``: each batched decode step of the main loop (CUDA events
    on the card, the host clock on the CPU); ``feed_steps``: the decode
    steps that fed prompts into freed slots.
    """

    outputs: Dict[int, List[int]]
    steps: int
    feed_steps: int
    seconds: float
    step_ms: List[float]
    logits_finite: bool
    device: str

    @property
    def new_tokens(self) -> int:
        return sum(len(v) for v in self.outputs.values())

    @property
    def tokens_per_s(self) -> float:
        return self.new_tokens / self.seconds

    @property
    def median_step_ms(self) -> float:
        return statistics.median(self.step_ms)


def make_prompts(cfg: ArchConfig, requests: int, prompt_len: int,
                 seed: int) -> List[np.ndarray]:
    """The reference's request queue: prompts of 4 to ``prompt_len``
    token ids drawn from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=rng.integers(4, prompt_len + 1))
            for _ in range(requests)]


def _splice_slot(old: Dict, new: Dict, slot: int) -> Dict:
    """Take slot ``slot``'s entries from ``new`` into ``old`` (in place),
    along each entry's batch axis."""
    for key, val in old.items():
        if val is None:
            continue
        axis = _SLOT_AXIS[key]
        if isinstance(val, dict):
            for name, t in val.items():
                t.select(axis, slot).copy_(new[key][name].select(axis, slot))
        else:
            val.select(axis, slot).copy_(new[key].select(axis, slot))
    return old


@torch.inference_mode()
def serve(params, cfg: ArchConfig, prompts: List[np.ndarray], *, slots: int,
          capacity: int, max_new: int, device=None) -> ServeResult:
    """Serve ``prompts`` with continuous batching over ``slots`` slots,
    ``max_new`` greedy tokens each; ``params`` must be on ``device``
    (default: the card)."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    cache = init_cache(cfg, slots, capacity, device=device)
    if cfg.family in ENCDEC_FAMILIES:
        cache["memory"] = torch.zeros((slots, 8, cfg.d_model), dtype=cfg.dtype,
                                      device=device)

    n_req = len(prompts)
    slot_req = [-1] * slots          # request id per slot
    slot_remaining = [0] * slots
    cur_tok = np.zeros((slots, 1), np.int64)
    outputs: Dict[int, List[int]] = {i: [] for i in range(n_req)}
    finite = torch.ones((), dtype=torch.bool, device=device)
    state = {"next": 0, "feed": 0}

    def step(tokens: np.ndarray, c: Dict):
        logits, c2 = lm_decode_step(params, torch.from_numpy(tokens).to(device),
                                    c, cfg)
        finite.logical_and_(torch.isfinite(logits).all())
        return logits, c2

    def assign(slot: int) -> None:
        """Feed a queued request into a free slot, token by token."""
        nonlocal cache
        if state["next"] >= n_req:
            slot_req[slot] = -1
            return
        rid = state["next"]
        state["next"] += 1
        prompt = prompts[rid]
        if len(prompt) + max_new > capacity + 1:
            raise ValueError(f"request {rid}: {len(prompt)} prompt tokens and "
                             f"{max_new} new ones exceed the cache capacity "
                             f"{capacity}")
        cache["pos"][slot] = 0
        for tok in prompt[:-1]:
            t = cur_tok.copy()
            t[slot, 0] = tok
            _, c2 = step(t, cache)
            cache = _splice_slot(cache, c2, slot)
            state["feed"] += 1
        cur_tok[slot, 0] = prompt[-1]
        slot_req[slot] = rid
        slot_remaining[slot] = max_new

    t0 = time.perf_counter()
    for slot in range(slots):
        assign(slot)

    step_ms, events = [], []
    done = steps = 0
    while done < n_req:
        if on_card:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        else:
            h0 = time.perf_counter()
        logits, cache = step(cur_tok, cache)
        if on_card:
            ev[1].record()
            events.append(ev)
        nxt = logits[:, 0].argmax(dim=-1).cpu().numpy()
        if not on_card:
            step_ms.append((time.perf_counter() - h0) * 1e3)
        steps += 1
        for slot in range(slots):
            rid = slot_req[slot]
            if rid < 0:
                continue
            outputs[rid].append(int(nxt[slot]))
            cur_tok[slot, 0] = nxt[slot]
            slot_remaining[slot] -= 1
            if slot_remaining[slot] <= 0:
                done += 1
                assign(slot)
    if on_card:
        torch.cuda.synchronize()
        step_ms = [a.elapsed_time(b) for a, b in events]
    seconds = time.perf_counter() - t0
    return ServeResult(outputs=outputs, steps=steps, feed_steps=state["feed"],
                       seconds=seconds, step_ms=step_ms,
                       logits_finite=bool(finite), device=str(device))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--requests", type=int, default=12)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--capacity", type=int, default=96)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; cpu to run here)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    from repro_torch.configs import get_config, get_reduced

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if cfg.family in ENCDEC_FAMILIES:
        print("[serve] enc-dec serving uses the decoder path with a fixed "
              "encoder memory")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_lm(cfg, gen, device)
    prompts = make_prompts(cfg, args.requests, args.prompt_len, args.seed)
    res = serve(params, cfg, prompts, slots=args.slots,
                capacity=args.capacity, max_new=args.max_new, device=device)
    print(f"[serve] {args.requests} requests, {res.new_tokens} tokens in "
          f"{res.seconds:.1f}s ({res.tokens_per_s:.1f} tok/s, {res.steps} "
          f"batched steps, slot efficiency "
          f"{res.new_tokens / (res.steps * args.slots):.0%}, median step "
          f"{res.median_step_ms:.2f} ms on {res.device})")
    for rid in range(min(3, args.requests)):
        print(f"  req{rid}: {res.outputs[rid][:8]}…")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

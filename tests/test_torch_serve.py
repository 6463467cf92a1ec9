"""The port's continuous-batching server (``repro_torch.launch.serve``)
against the JAX package's serving loop, on the CPU.

The reference server (``repro.launch.serve``) prints its outputs; the
loop below is its body (``serve.py:66-125``) over JAX's jitted
``lm_decode_step`` and its per-slot splice, on the same prompts and
weights, so the generated token ids can be compared one for one.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import lm as jlm
from repro_torch import configs as tcfg
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from _torch_threads import one_intraop_thread  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    "error::repro_torch.core.dispatch.FallbackWarning")


def jax_serve(params, cfg, prompts, slots, capacity, max_new):
    """The reference server's loop: token ids per request."""
    B = slots
    cache = jlm.init_cache(cfg, B, capacity=capacity)
    if cfg.family in ("encdec", "audio"):
        cache["memory"] = jnp.zeros((B, 8, cfg.d_model), cfg.dtype)
    step = jax.jit(lambda p, t, c: jlm.lm_decode_step(p, t, c, cfg))
    slot_req, slot_remaining = [-1] * B, [0] * B
    cur_tok = np.zeros((B, 1), np.int32)
    outputs = {i: [] for i in range(len(prompts))}
    state = {"next": 0, "cache": cache}

    def splice(old, new, slot):
        def pick(o, n):
            if o.ndim == 0:
                return n
            for axis in range(o.ndim):
                if o.shape[axis] == B and (o.ndim == 1 or axis <= 2):
                    idx = [slice(None)] * o.ndim
                    idx[axis] = slot
                    return o.at[tuple(idx)].set(n[tuple(idx)])
            return n
        return jax.tree.map(pick, old, new)

    def assign(slot):
        if state["next"] >= len(prompts):
            slot_req[slot] = -1
            return
        rid = state["next"]
        state["next"] += 1
        prompt = prompts[rid]
        c = state["cache"]
        pos = np.asarray(c["pos"]).copy()
        pos[slot] = 0
        c["pos"] = jnp.asarray(pos)
        for tok in prompt[:-1]:
            t = np.array(cur_tok)
            t[slot, 0] = tok
            _, c2 = step(params, jnp.asarray(t), c)
            c = splice(c, c2, slot)
        state["cache"] = c
        cur_tok[slot, 0] = prompt[-1]
        slot_req[slot] = rid
        slot_remaining[slot] = max_new

    for slot in range(B):
        assign(slot)
    done = 0
    while done < len(prompts):
        logits, state["cache"] = step(params, jnp.asarray(cur_tok),
                                      state["cache"])
        nxt = np.asarray(jnp.argmax(logits[:, 0], axis=-1), np.int32)
        for slot in range(B):
            rid = slot_req[slot]
            if rid < 0:
                continue
            outputs[rid].append(int(nxt[slot]))
            cur_tok[slot, 0] = nxt[slot]
            slot_remaining[slot] -= 1
            if slot_remaining[slot] <= 0:
                done += 1
                assign(slot)
    return outputs


def both(arch, requests, slots, capacity, max_new, prompt_len, seed=0):
    cfg_j, cfg_t = jcfg.get_reduced(arch), tcfg.get_reduced(arch)
    params_j = jlm.init_lm(jax.random.key(seed), cfg_j)
    params_t = tlm.lm_params_from_jax(
        cfg_t, jax.tree.map(np.asarray, params_j), device="cpu")
    prompts = tserve.make_prompts(cfg_t, requests, prompt_len, seed)
    ref = jax_serve(params_j, cfg_j, prompts, slots, capacity, max_new)
    res = tserve.serve(params_t, cfg_t, prompts, slots=slots,
                       capacity=capacity, max_new=max_new, device="cpu")
    return res, ref


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-2.7b"])
def test_generated_tokens_equal_the_jax_loop(arch):
    """6 requests over 3 slots (the layer count, 2, differs from the slot
    count, so the reference's splice takes the batch axis too); the SSM
    case carries its state across slot reuse, as the reference does."""
    res, ref = both(arch, requests=6, slots=3, capacity=40, max_new=8,
                    prompt_len=16)
    assert res.outputs == ref
    assert res.logits_finite


def test_result_accounting():
    cfg = tcfg.get_reduced("qwen3-0.6b")
    params = tlm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = tserve.make_prompts(cfg, 5, 12, seed=3)
    res = tserve.serve(params, cfg, prompts, slots=2, capacity=32, max_new=6,
                       device="cpu")
    assert sorted(res.outputs) == list(range(5))
    assert all(len(v) == 6 for v in res.outputs.values())
    assert res.new_tokens == 30
    assert res.steps == len(res.step_ms) >= 15
    assert res.feed_steps == sum(len(p) - 1 for p in prompts)
    assert res.tokens_per_s > 0 and res.device == "cpu"
    assert all(0 <= tok < cfg.vocab for v in res.outputs.values() for tok in v)


def test_prompts_are_the_reference_draw():
    cfg = tcfg.get_reduced("qwen3-0.6b")
    rng = np.random.default_rng(7)
    ref = [rng.integers(0, cfg.vocab, size=rng.integers(4, 16 + 1))
           for _ in range(9)]
    out = tserve.make_prompts(cfg, 9, 16, seed=7)
    assert all(np.array_equal(a, b) for a, b in zip(out, ref))


def test_splice_takes_the_batch_axis_when_layers_equal_slots():
    """With as many layers as slots (reduced qwen3, 2 slots) the port
    still splices the slot's batch entries and leaves the other slot."""
    cfg = tcfg.get_reduced("qwen3-0.6b")
    assert cfg.n_layers == 2
    old = tlm.init_cache(cfg, 2, 5, device="cpu")
    new = tlm.tree_map(lambda x: x + 1, old)
    out = tserve._splice_slot(tlm.tree_map(torch.clone, old), new, 1)
    for key in ("k", "v"):
        assert (out["layers"][key][:, 1] == 1).all()
        assert (out["layers"][key][:, 0] == 0).all()
    assert out["pos"].tolist() == [0, 1]


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "seamless-m4t-medium",
                                  "deepseek-v3-671b"])
def test_other_families_serve(arch):
    cfg = tcfg.get_reduced(arch)
    params = tlm.init_lm(cfg, torch.Generator().manual_seed(1), "cpu")
    prompts = tserve.make_prompts(cfg, 3, 8, seed=1)
    res = tserve.serve(params, cfg, prompts, slots=2, capacity=24, max_new=4,
                       device="cpu")
    assert res.logits_finite
    assert [len(res.outputs[i]) for i in range(3)] == [4, 4, 4]


def test_refuses_a_request_past_the_capacity():
    cfg = tcfg.get_reduced("qwen3-0.6b")
    params = tlm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="exceed the cache capacity"):
        tserve.serve(params, cfg, [np.arange(10)], slots=1, capacity=12,
                     max_new=4, device="cpu")


def test_cli_on_the_cpu(capsys):
    assert tserve.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                        "--requests", "3", "--slots", "2", "--max-new",
                        "4"]) == 0
    out = capsys.readouterr().out
    assert "[serve] 3 requests, 12 tokens" in out and "on cpu" in out

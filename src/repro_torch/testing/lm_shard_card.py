"""The sharded LM on one card: the checks and timings that
``chip_smoke.py`` runs in its sharded-LM phase.

:func:`run` raises :class:`~repro_torch.testing.lm_card.LMCheckFailed`
on the first failed check and otherwise returns what it measured:

  (a) qwen3-0.6b at its published width, 2 of its 28 layers, fp32 (TF32
      off), B = 2, T = 256, seed 0: three sharded train steps (the state
      as DTensors on a one-rank NCCL mesh, ``reshard_state``) against
      three plain steps from the same state and batches; the losses and
      every updated leaf within ``1e-6`` of the leaf's largest entry
      (bitwise is expected: one rank runs the plain ops on its whole
      shards); each step's time by CUDA events, both ways;
  (b) moonshot-v1-16b-a3b's MoE layer at its published width (d 2048, 64
      experts, top-6, expert d_ff 1408, 2 shared experts, bf16, capacity
      factor 1.25) over 4 x 1,024 tokens from seed 0: at "model" = 2, 4
      and 8 ("data" = 1), every rank's ``moe_ffn_ep_local`` run on the
      card and the fp32 partials summed there, against the dense
      ``moe_ffn`` within ``2e-2`` of the largest entry (routing is the
      dense path's at "data" = 1); at ("data", "model") = (2, 2) each
      rank's body on the card against the same body on the CPU; each
      rank's time and its expert-weight bytes;
  (c) ``ring_allgather_matmul``'s steps rank-local at n = 2 and 4 on
      (4,096 x 1,024) @ (1,024 x 3,072) fp32, against ``x @ w`` within
      ``1e-4`` of the largest entry;
  (d) (a)'s sharded state resharded onto a second one-rank mesh and
      back, bitwise; the per-rank resident parameter bytes of qwen3-0.6b
      and moonshot at (data, model) = (8, 1), (4, 2) and (2, 4), from
      ``param_shardings`` on meta shapes (nothing allocated);
  (e) the sharded serving step: qwen3-0.6b at its published width and
      depth, bf16, seed 0, a prefill of B = 4 prompts of 128 tokens at
      capacity 256, then 8 ``lm_decode_step``s on the one-rank mesh (the
      weights laid out by the serving rules, the cache by
      ``cache_shardings``) against 8 plain steps: each step's logits
      within ``1e-6`` of the largest logit (bitwise expected: at one
      rank the cache's sequence is whole and each rank runs the
      one-device attention), each step's time both ways; and the
      vocab-parallel ``lm_loss`` of the same weights on 2 x 512 tokens
      against the plain one, within ``1e-6`` (bitwise expected).

Run it alone on a card with ``python -m repro_torch.testing.lm_shard_card``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
from typing import Callable, Dict

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get_config
from repro_torch.distributed.ctx import activation_mesh
from repro_torch.distributed.elastic import reshard_state, reshard_tree, whole
from repro_torch.distributed.overlap import ring_matmul_step
from repro_torch.distributed.sharding import (batch_pspec, cache_shardings,
                                              local_shape, param_shardings,
                                              placements, serving_rules,
                                              spec_paths)
from repro_torch.launch.mesh import AXES, one_rank_mesh
from repro_torch.models.layers import (init_moe, mlp, moe_ep_capacity,
                                       moe_ffn, moe_ffn_ep_local)
from repro_torch.models.lm import (abstract_lm, init_lm, lm_decode_step,
                                   lm_loss, lm_prefill, stack_layers,
                                   unstack_layers)
from repro_torch.pytree import leaf_paths, tree_map
from repro_torch.testing.lm_card import LMCheckFailed, _fail
from repro_torch.train.train_step import (TrainStepConfig, _sharded,
                                          init_train_state, make_train_step)

__all__ = ["LMCheckFailed", "run"]

STEP = dict(layers=2, batch=2, seq=256, steps=3)
STEP_TOL = 1e-6               # of each leaf's largest entry
MOE_TOKENS = (4, 1024)
MOE_MODEL = (2, 4, 8)
MOE_TOL = 2e-2                # bf16: of the largest entry
MATMUL = (4096, 1024, 3072)
MATMUL_RANKS = (2, 4)
MATMUL_TOL = 1e-4
RESIDENT_MESHES = ((8, 1), (4, 2), (2, 4))
DECODE = dict(batch=4, prompt=128, capacity=256, steps=8)
LOSS_TOKENS = (2, 512)
DECODE_TOL = 1e-6             # of the largest logit, and of the loss


def _events_ms(fn) -> tuple:
    """``fn()``'s result and its time in ms by CUDA events."""
    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    z.record()
    z.synchronize()
    return out, a.elapsed_time(z)


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.to(got.device).double()
    if got.shape != want.shape:
        _fail(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        _fail("non-finite values")
    top = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if got.numel() else 0.0
    return err / top if top else err


def check_sharded_step(device, mesh, log) -> Dict:
    """(a); returns the numbers and leaves the sharded state in
    ``out["_state"]`` for (d)."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), dtype=torch.float32,
                              n_layers=STEP["layers"])
    ts = TrainStepConfig()
    state = init_train_state(cfg, ts, torch.Generator(device).manual_seed(0),
                             device)
    sharded = reshard_state(state, mesh)
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(
        0, cfg.vocab, (STEP["batch"], STEP["seq"])).astype(np.int32))
        .to(device) for _ in range(STEP["steps"])]
    step = make_train_step(cfg, ts)
    bspec = placements(batch_pspec(mesh), mesh)
    out = {"plain_ms": [], "sharded_ms": [], "losses": [],
           "losses_sharded": []}
    for tokens in batches:
        (state, met), ms = _events_ms(lambda: step(state, {"tokens": tokens}))
        out["plain_ms"].append(ms)
        out["losses"].append(float(met["loss"]))
        dt = distribute_tensor(tokens, mesh, bspec, src_data_rank=None)
        (sharded, met), ms = _events_ms(lambda: step(sharded,
                                                     {"tokens": dt}))
        out["sharded_ms"].append(ms)
        out["losses_sharded"].append(float(met["loss"]))
    worst, bitwise = 0.0, True
    for (path, want), (_, got) in zip(leaf_paths(state), leaf_paths(sharded)):
        g = whole(got)
        worst = max(worst, _rel_err(g, want))
        bitwise = bitwise and torch.equal(g, want)
    loss_err = max(abs(a - b) / abs(b) for a, b in
                   zip(out["losses_sharded"], out["losses"]))
    out.update(max_rel_err=worst, loss_rel_err=loss_err, bitwise=bitwise,
               local_embed=tuple(sharded["params"]["embed"].to_local().shape))
    log(f"  sharded step (1, 1) vs plain: losses {out['losses_sharded']} vs "
        f"{out['losses']}, max rel err {worst:.3e} (gate {STEP_TOL}), "
        f"bitwise {bitwise}")
    log(f"  step ms: plain {[round(x, 3) for x in out['plain_ms']]}, "
        f"sharded {[round(x, 3) for x in out['sharded_ms']]}")
    if worst > STEP_TOL or loss_err > STEP_TOL:
        _fail(f"sharded step: max rel err {worst:.3e}, loss {loss_err:.3e}")
    out["_state"] = sharded
    return out


def _expert_slice(p: Dict, j: int, e_loc: int) -> Dict:
    return {"router": p["router"],
            **{k: p[k][j * e_loc:(j + 1) * e_loc].contiguous()
               for k in ("w_gate", "w_up", "w_down")}}


def check_moe_ep(device, log) -> Dict:
    """(b)."""
    cfg = get_config("moonshot-v1-16b-a3b")
    gen = torch.Generator(device).manual_seed(0)
    p = init_moe(cfg, gen, device)
    b, s = MOE_TOKENS
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=device).to(
        cfg.dtype)
    xt = x.reshape(-1, cfg.d_model)
    dense, aux = moe_ffn(p, x, cfg)
    dense = dense.reshape(-1, cfg.d_model)
    shared = mlp(p["shared"], xt)
    out = {"tokens": b * s, "models": {}}
    for m in MOE_MODEL:
        e_loc = cfg.moe_experts // m
        cap = moe_ep_capacity(xt.shape[0], cfg)
        total, ranks = None, []
        for j in range(m):
            loc = _expert_slice(p, j, e_loc)
            (part, me, ce, _), ms = _events_ms(
                lambda: moe_ffn_ep_local(loc, xt, cfg, j0=j * e_loc,
                                         cap_loc=cap))
            total = part if total is None else total + part
            ranks.append({"ms": ms, "expert_bytes": sum(
                loc[k].numel() * loc[k].element_size()
                for k in ("w_gate", "w_up", "w_down"))})
        got = total.to(cfg.dtype) + shared
        err = _rel_err(got, dense)
        aux_err = abs(float(cfg.moe_experts * torch.sum(me * ce))
                      - float(aux)) / abs(float(aux))
        out["models"][m] = {"ranks": ranks, "rel_err": err,
                            "aux_rel_err": aux_err}
        log(f"  EP model={m}: sum of {m} rank bodies vs dense moe_ffn: "
            f"rel err {err:.3e} (gate {MOE_TOL}), aux {aux_err:.2e}; rank "
            f"ms {[round(r['ms'], 3) for r in ranks]}, expert bytes/rank "
            f"{ranks[0]['expert_bytes']:,}")
        if err > MOE_TOL or aux_err > MOE_TOL:
            _fail(f"EP model={m}: rel err {err:.3e}, aux {aux_err:.3e}")
    # (data, model) = (2, 2): each rank body on the card and on the CPU
    d, m = 2, 2
    e_loc = cfg.moe_experts // m
    shards = x.reshape(d, -1, cfg.d_model)
    cap = moe_ep_capacity(shards.shape[1], cfg)
    worst = 0.0
    for i in range(d):
        for j in range(m):
            loc = _expert_slice(p, j, e_loc)
            part, _, _, route = moe_ffn_ep_local(loc, shards[i], cfg,
                                                 j0=j * e_loc, cap_loc=cap)
            part_h, _, _, route_h = moe_ffn_ep_local(
                tree_map(lambda t: t.cpu(), loc), shards[i].cpu(), cfg,
                j0=j * e_loc, cap_loc=cap)
            worst = max(worst, _rel_err(part, part_h))
            if not torch.equal(route["keep"].cpu(), route_h["keep"]):
                _fail(f"EP (2, 2) rank ({i}, {j}): routing differs from "
                      "the CPU's")
    out["data2_card_vs_cpu_rel_err"] = worst
    log(f"  EP (data, model) = (2, 2): 4 rank bodies card vs CPU: rel err "
        f"{worst:.3e} (gate {MOE_TOL}), routing equal")
    if worst > MOE_TOL:
        _fail(f"EP (2, 2) card vs CPU: rel err {worst:.3e}")
    return out


def check_ring_matmul(device, log) -> Dict:
    """(c)."""
    t, k, n = MATMUL
    gen = torch.Generator(device).manual_seed(0)
    x = torch.randn((t, k), generator=gen, device=device)
    w = torch.randn((k, n), generator=gen, device=device)
    want = x @ w
    out = {}
    for ranks in MATMUL_RANKS:
        chunks = x.chunk(ranks, dim=1)
        cols = w.chunk(ranks, dim=1)
        ys = []
        for r in range(ranks):
            acc = torch.zeros((t, n // ranks), device=device)
            for s in range(ranks):
                src = (r + s) % ranks
                acc = ring_matmul_step(acc, chunks[src], cols[r], src)
            ys.append(acc)
        err = _rel_err(torch.cat(ys, dim=1), want)
        out[ranks] = err
        log(f"  ring all-gather matmul n={ranks}, rank-local steps vs x @ w: "
            f"rel err {err:.3e} (gate {MATMUL_TOL})")
        if err > MATMUL_TOL:
            _fail(f"ring matmul n={ranks}: rel err {err:.3e}")
    return out


def resident_bytes(arch: str, data: int, model: int) -> int:
    """Per-rank parameter bytes of ``arch`` at full size on a (data,
    model) mesh, from its specs on meta shapes."""
    params = abstract_lm(get_config(arch))
    sizes = {"data": data, "model": model}
    specs = param_shardings(params, sizes)
    return sum(int(np.prod(local_shape(t.shape, s, sizes))) * t.element_size()
               for (_, t), (_, s) in zip(leaf_paths(params),
                                         spec_paths(specs)))


def check_reshard(state, mesh, log) -> Dict:
    """(d)."""
    other = init_device_mesh(mesh.device_type, (1, 1), mesh_dim_names=AXES)
    back = reshard_state(reshard_state(state, other), mesh)
    same = all(torch.equal(whole(a), whole(b)) for (_, a), (_, b) in
               zip(leaf_paths(state), leaf_paths(back)))
    log(f"  reshard_state onto a second one-rank mesh and back: bitwise "
        f"{same}")
    if not same:
        _fail("reshard_state round trip is not bitwise")
    table = {}
    for arch in ("qwen3-0.6b", "moonshot-v1-16b-a3b"):
        total = resident_bytes(arch, 1, 1)
        table[arch] = {"whole": total}
        for d, m in RESIDENT_MESHES:
            table[arch][f"{d}x{m}"] = resident_bytes(arch, d, m)
        log(f"  resident parameter bytes per rank, {arch} (whole "
            f"{total:,}): " + ", ".join(
                f"({d}, {m}) {table[arch][f'{d}x{m}']:,}"
                for d, m in RESIDENT_MESHES))
    return {"roundtrip_bitwise": same, "resident_bytes": table}


def check_sharded_decode(device, mesh, log) -> Dict:
    """(e)."""
    cfg = get_config("qwen3-0.6b")
    b, t = DECODE["batch"], DECODE["prompt"]
    params = init_lm(cfg, torch.Generator(device).manual_seed(0), device)
    rng = np.random.default_rng(0)

    def tokens(shape):
        return torch.from_numpy(rng.integers(0, cfg.vocab, shape)
                                .astype(np.int32)).to(device)

    prompt = tokens((b, t))
    steps = [tokens((b, 1)) for _ in range(DECODE["steps"])]
    stacked = stack_layers(params)
    pd = unstack_layers(reshard_tree(
        stacked, param_shardings(stacked, mesh, serving_rules()), mesh))
    out = {"plain_ms": [], "sharded_ms": [], "rel_err": [], "bitwise": True}
    with torch.no_grad():
        _, cache = lm_prefill(params, {"tokens": prompt}, cfg,
                              DECODE["capacity"])
        cd = reshard_tree(cache, cache_shardings(cache, mesh, batch=b), mesh)
        out["cache_layout"] = str(cd["layers"]["k"].placements)
        tok_pl = placements(batch_pspec(mesh), mesh)
        for tok in steps:
            (lg, cache), ms = _events_ms(
                lambda: lm_decode_step(params, tok, cache, cfg))
            out["plain_ms"].append(ms)
            tok_d = distribute_tensor(tok, mesh, tok_pl, src_data_rank=None)
            with activation_mesh(mesh), implicit_replication():
                (lg_d, cd), ms = _events_ms(
                    lambda: lm_decode_step(pd, tok_d, cd, cfg))
            out["sharded_ms"].append(ms)
            got = whole(lg_d)[..., :cfg.vocab]
            out["rel_err"].append(_rel_err(got, lg[..., :cfg.vocab]))
            out["bitwise"] = out["bitwise"] and torch.equal(
                got, lg[..., :cfg.vocab])
        out["cache_bitwise"] = all(
            torch.equal(whole(cd["layers"][k]), cache["layers"][k])
            for k in ("k", "v"))
        batch = {"tokens": tokens(LOSS_TOKENS)}
        loss, _ = lm_loss(params, batch, cfg)
        with _sharded(mesh):
            loss_d, _ = lm_loss(pd, {"tokens": distribute_tensor(
                batch["tokens"], mesh, tok_pl, src_data_rank=None)}, cfg)
        loss_d = whole(loss_d)
    out["loss"], out["loss_sharded"] = float(loss), float(loss_d)
    out["loss_rel_err"] = abs(out["loss_sharded"] - out["loss"]) / abs(
        out["loss"])
    out["loss_bitwise"] = torch.equal(loss_d, loss)
    worst = max(out["rel_err"])
    log(f"  sharded decode (1, 1), qwen3-0.6b bf16 {cfg.n_layers} layers, "
        f"B = {b}, "
        f"cache {out['cache_layout']}: {DECODE['steps']} steps after a "
        f"{t}-token prefill, max rel err {worst:.3e} (gate {DECODE_TOL}), "
        f"bitwise {out['bitwise']}, cache bitwise {out['cache_bitwise']}")
    log(f"  decode step ms: plain {[round(x, 3) for x in out['plain_ms']]}, "
        f"sharded {[round(x, 3) for x in out['sharded_ms']]}")
    log(f"  vocab-parallel lm_loss on {LOSS_TOKENS[0]} x {LOSS_TOKENS[1]} "
        f"tokens: {out['loss_sharded']!r} vs plain {out['loss']!r}, rel err "
        f"{out['loss_rel_err']:.3e}, bitwise {out['loss_bitwise']}")
    if worst > DECODE_TOL or out["loss_rel_err"] > DECODE_TOL:
        _fail(f"sharded decode: max rel err {worst:.3e}, loss "
              f"{out['loss_rel_err']:.3e}")
    return out


def run(device="cuda", log: Callable = print) -> Dict:
    device = torch.device(device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with one_rank_mesh(device) as mesh:
            step = check_sharded_step(device, mesh, log)
            state = step.pop("_state")
            reshard = check_reshard(state, mesh, log)
            del state
            decode = check_sharded_decode(device, mesh, log)
        moe = check_moe_ep(device, log)
        ring = check_ring_matmul(device, log)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return {"sharded_step": step, "moe_ep": moe, "ring_matmul": ring,
            "reshard": reshard, "sharded_decode": decode,
            "plain_step_ms_median": statistics.median(step["plain_ms"][1:]),
            "sharded_step_ms_median": statistics.median(
                step["sharded_ms"][1:])}


if __name__ == "__main__":
    print(json.dumps(run(), default=str))

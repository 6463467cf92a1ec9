"""The sharded LM's cases for :func:`repro_torch.testing.multirank.spawn`.

Each case runs on the ranks of one ``(data, model)`` mesh of gloo ranks
on the CPU, takes numpy inputs (weights, states and batches, which a test also
hands to the JAX package) and returns tensors:

  ``moe_ep``            ``moe_ffn`` under the mesh, expert-parallel or
                        the default dispatch (output, aux), and each
                        rank's routing from ``moe_ffn_ep_local``;
  ``collective_matmul`` ``collective_matmul`` over "data" -> "model";
  ``reshard``           ``reshard_state`` onto the mesh: each rank's
                        local shards, and a round trip through a second
                        mesh;
  ``lm_train``          sharded train steps (gradient compression and
                        microbatches as ``inp`` says) and the local
                        shard shape of every parameter the loss saw;
  ``lm_8bit``           one sharded step with 8-bit moments;
  ``act_sp``            the ``act_sp`` forward and its layer layouts;
  ``lm_cli``            ``launch/train.py`` on the mesh with a checkpoint
                        (the resume runs as a second job on another mesh);
  ``lm_decode``         the sharded serving step: decode steps on a cache
                        laid out by ``cache_shardings``;
  ``lm_loss``           the vocab-parallel ``lm_loss`` and its gradients.

This module imports no JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import distribute_tensor

from repro_torch.configs import get_reduced
from repro_torch.distributed.ctx import activation_mesh
from repro_torch.distributed.elastic import reshard_state, reshard_tree, whole
from repro_torch.distributed.sharding import (batch_pspec, fit_pspec,
                                              local_shape, param_shardings,
                                              placements, spec_paths)
from repro_torch.pytree import leaf_paths, tree_map

__all__ = ["CASES"]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _lead(mesh: DeviceMesh) -> bool:
    return tuple(mesh.get_coordinate()) == (0,) * mesh.ndim


def _place(t: torch.Tensor, spec, mesh):
    return distribute_tensor(t, mesh, placements(spec, mesh),
                             src_data_rank=None)


def _whole_tree(tree) -> Dict[str, torch.Tensor]:
    """``{path: global tensor}`` of a tree of DTensors (a collective)."""
    return {p: whole(t).detach().clone() for p, t in leaf_paths(tree)}


def _moe_ep_case(mesh: DeviceMesh, inp: dict) -> Dict[str, object]:
    """``moe_ffn`` under the mesh (with ``moe_ep`` unless ``inp["ep"]`` is
    false: the default path's global dispatch): the output (whole) and
    aux; and this rank's ``moe_ffn_ep_local`` routing on its token shard
    and expert slice."""
    from repro_torch.models.layers import (moe_ep_capacity, moe_ffn,
                                           moe_ffn_ep_local)

    cfg = get_reduced(inp["arch"], moe_ep=inp.get("ep", True),
                      capacity_factor=inp["capacity_factor"])
    p = tree_map(_t, inp["params"])
    x = _t(inp["x"])
    pd = reshard_tree(p, param_shardings(p, mesh), mesh)
    xd = _place(x, batch_pspec(mesh, 2), mesh)
    with activation_mesh(mesh):
        out, aux = moe_ffn(pd, xd, cfg)
    out = whole(out)
    aux = whole(aux)
    # the rank-local body on this rank's shard, as the wrapper runs it
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    i, j = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    b, s, d = x.shape
    n_tok = sizes["data"] if b % sizes["data"] == 0 else 1
    e_loc = cfg.moe_experts // sizes["model"]
    xt = x.reshape(n_tok, -1, d)[i if n_tok > 1 else 0]
    loc = {"router": p["router"],
           **{k: p[k][j * e_loc:(j + 1) * e_loc]
              for k in ("w_gate", "w_up", "w_down")}}
    _, _, _, route = moe_ffn_ep_local(
        loc, xt, cfg, j0=j * e_loc,
        cap_loc=moe_ep_capacity(xt.shape[0], cfg))
    return {"out": out, "aux": aux, "pos": (i, j), **route}


def _collective_matmul_case(mesh: DeviceMesh, inp: dict
                            ) -> Dict[str, torch.Tensor]:
    from repro_torch.distributed.overlap import collective_matmul

    x, w = _t(inp["x"]), _t(inp["w"])
    y = collective_matmul(_place(x, (None, "data"), mesh),
                          _place(w, (None, "model"), mesh), mesh,
                          "data", "model")
    return {"y": whole(y)}


def _state(inp: dict, cfg):
    from repro_torch.train.train_step import train_state_from_jax

    return train_state_from_jax(cfg, inp["state"], device="cpu")


def _reshard_case(mesh: DeviceMesh, inp: dict) -> Dict[str, object]:
    """``inp["state"]`` laid out on the mesh: this rank's local shard of
    every leaf, and the leaves after a round trip through the mesh of the
    first ``inp["via"]`` ranks (global tensors, bitwise)."""
    cfg = get_reduced(inp["arch"])
    state = _state(inp, cfg)
    sa = reshard_state(state, mesh)
    local = {p: t.to_local().clone() for p, t in leaf_paths(sa)}
    d2, m2 = inp["via"]
    via = DeviceMesh("cpu", torch.arange(d2 * m2).reshape(d2, m2),
                     mesh_dim_names=mesh.mesh_dim_names)
    sb = reshard_state(sa, via)
    via_local = ({p: t.to_local().clone() for p, t in leaf_paths(sb)}
                 if via.get_coordinate() is not None else {})
    sc = reshard_state(sb, mesh)
    back = _whole_tree(sc)
    same = all(torch.equal(back[p], t) for p, t in leaf_paths(state))
    return {"pos": tuple(mesh.get_coordinate()), "local": local,
            "via_pos": via.get_coordinate(), "via_local": via_local,
            "roundtrip_bitwise": same}


def _lm_train_case(mesh: DeviceMesh, inp: dict) -> Dict[str, object]:
    """Sharded steps from ``inp["state"]``, one a batch of
    ``inp["batches"]``, under the compression ``inp["compress"]`` (none
    by default; the error buffers start at zero) in
    ``inp["microbatches"]`` microbatches (1); the local shard shape
    of each parameter the loss received against the spec's; the final
    state (whole, on the lead rank)."""
    from repro_torch.train import train_step as T
    from repro_torch.train.compression import CompressionConfig, init_error

    cfg = get_reduced(inp["arch"], **inp.get("overrides", {}))
    ts = T.TrainStepConfig(
        microbatches=inp.get("microbatches", 1),
        compression=CompressionConfig(kind=inp.get("compress", "none")))
    state = _state(inp, cfg)
    if ts.compression.kind != "none":
        state["err"] = init_error(state["params"])
    state = reshard_state(state, mesh)
    specs = param_shardings(state["params"], mesh)
    want = {p: local_shape(t.shape, s, mesh) for (p, t), (_, s) in
            zip(leaf_paths(state["params"]), spec_paths(specs))}
    seen = {}
    loss_fn = T.lm_loss

    def spy(params, batch, cfg_, **kw):
        for p, t in leaf_paths(params):
            seen[p] = tuple(t.to_local().shape)
        return loss_fn(params, batch, cfg_, **kw)

    step = T.make_train_step(cfg, ts)
    losses = []
    T.lm_loss = spy
    try:
        for tokens in inp["batches"]:
            batch = {"tokens": _place(_t(tokens), batch_pspec(mesh), mesh)}
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
    finally:
        T.lm_loss = loss_fn
    final = _whole_tree(state)
    return {"losses": losses, "seen": seen, "want": want,
            "state": final if _lead(mesh) else {}}


def _lm_8bit_case(mesh: DeviceMesh, inp: dict) -> Dict[str, object]:
    """One sharded step with 8-bit AdamW moments (blocks that straddle
    ranks included); the final state whole on the lead rank."""
    from repro_torch.train import train_step as T
    from repro_torch.train.optimizer import AdamWConfig

    cfg = get_reduced(inp["arch"])
    ts = T.TrainStepConfig(opt=AdamWConfig(quantize_state=True))
    state = T.init_train_state(cfg, ts, torch.Generator().manual_seed(0),
                               "cpu")
    state = reshard_state(state, mesh)
    tokens = _t(inp["batches"][0])
    state, _ = T.make_train_step(cfg, ts)(
        state, {"tokens": _place(tokens, batch_pspec(mesh), mesh)})
    final = _whole_tree(state)
    return {"state": final if _lead(mesh) else {}}


def _act_sp_case(mesh: DeviceMesh, inp: dict) -> Dict[str, torch.Tensor]:
    """The ``act_sp`` forward (each layer's output split over "model" on
    its sequence dim) of ``inp["state"]``'s params: the logits, whole,
    and the placements of the layers' outputs."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import lm

    cfg = get_reduced(inp["arch"], act_sp=True)
    state = reshard_state(_state(inp, cfg), mesh)
    tokens = _place(_t(inp["batches"][0]), batch_pspec(mesh), mesh)
    seen = []
    run_stack = lm._run_stack

    def spy(x, layers, body, remat=False, seq_ax=None):
        out = run_stack(x, layers, body, remat, seq_ax)
        seen.append(str(out[0].placements))
        return out

    lm._run_stack = spy
    try:
        with activation_mesh(mesh), implicit_replication(), \
                torch.no_grad():
            logits, _ = lm.lm_forward(lm.unstack_layers(state["params"]),
                                      {"tokens": tokens}, cfg)
    finally:
        lm._run_stack = run_stack
    return {"logits": whole(logits), "placements": seen}


def _lm_cli_case(mesh: DeviceMesh, inp: dict) -> Dict[str, object]:
    """``launch/train.py`` on this mesh (flags from its shape; with
    ``--compress inp["compress"]`` when given, and a checkpoint directory
    when ``inp["dir"]`` is)."""
    from repro_torch.launch import train as launch_train

    d, m = mesh.shape
    argv = ["--arch", inp["arch"], "--reduced", "--device", "cpu",
            "--data-axis", str(d), "--model-axis", str(m),
            "--steps", str(inp["steps"]), "--batch", "4", "--seq", "16",
            "--compress", inp.get("compress", "none")]
    if inp.get("dir"):
        argv += ["--checkpoint-dir", inp["dir"], "--checkpoint-every", "2"]
    args = launch_train.parse_args(argv)
    out = launch_train.run(args, mesh=mesh)
    return {"start": out["start_step"], "losses": out["losses"]}


def _lm_decode_case(mesh: DeviceMesh, inp: dict) -> Dict[str, object]:
    """The sharded serving step: the port's one-device ``lm_prefill`` of
    ``inp["batch"]`` at capacity ``inp["cap"]`` (``pos`` then set to
    ``inp["pos"]`` row by row), the cache laid out by ``cache_shardings``
    and the weights by the serving rules, then ``lm_decode_step`` on
    DTensors for each of ``inp["steps"]`` (B, 1) tokens.  Returns the
    cache before and after the steps and each step's logits, whole, and
    each cache leaf's placements and local shape."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import (cache_shardings,
                                                  serving_rules)
    from repro_torch.models import lm

    cfg = get_reduced(inp["arch"], **inp.get("overrides", {}))
    params = lm.lm_params_from_jax(cfg, inp["params"], device="cpu")
    batch = {k: _t(v) for k, v in inp["batch"].items()}
    with torch.no_grad():
        _, cache = lm.lm_prefill(params, batch, cfg, inp["cap"])
    cache["pos"] = _t(inp["pos"])
    b = cache["pos"].shape[0]
    stacked = lm.stack_layers(params)
    pd = reshard_tree(stacked, param_shardings(stacked, mesh,
                                               serving_rules()), mesh)
    cd = reshard_tree(cache, cache_shardings(cache, mesh, batch=b), mesh)
    layout = {p: (str(t.placements), tuple(t.to_local().shape))
              for p, t in leaf_paths(cd)}
    first = _whole_tree(cd)
    logits = []
    with activation_mesh(mesh), implicit_replication(), torch.no_grad():
        for tokens in inp["steps"]:
            tok = _place(_t(tokens), fit_pspec(("batch", None),
                                               tokens.shape, mesh), mesh)
            out, cd = lm.lm_decode_step(lm.unstack_layers(pd), tok, cd, cfg)
            logits.append(whole(out))
    return {"prefill": first, "logits": logits, "cache": _whole_tree(cd),
            "layout": layout}


def _lm_loss_case(mesh: DeviceMesh, inp: dict) -> Dict[str, object]:
    """The sharded ``lm_loss`` (vocab-parallel cross entropy) of
    ``inp["params"]`` (stacked, laid out by ``param_shardings``) on
    ``inp["tokens"]``, and its gradient of every parameter, whole."""
    from repro_torch.models import lm
    from repro_torch.train.train_step import _sharded

    cfg = get_reduced(inp["arch"], **inp.get("overrides", {}))
    stacked = tree_map(_t, inp["params"])
    pd = reshard_tree(stacked, param_shardings(stacked, mesh), mesh)
    live = tree_map(lambda t: t.detach().requires_grad_(), pd)
    flat = [t for _, t in leaf_paths(live)]
    tokens = _place(_t(inp["tokens"]), batch_pspec(mesh), mesh)
    with _sharded(mesh):
        loss, _ = lm.lm_loss(live, {"tokens": tokens}, cfg)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return {"loss": whole(loss.detach()),
            "grads": {p: None if g is None else whole(g)
                      for (p, _), g in zip(leaf_paths(live), grads)}}


CASES = {"moe_ep": _moe_ep_case, "collective_matmul": _collective_matmul_case,
         "reshard": _reshard_case, "lm_train": _lm_train_case,
         "lm_8bit": _lm_8bit_case, "act_sp": _act_sp_case,
         "lm_cli": _lm_cli_case, "lm_decode": _lm_decode_case,
         "lm_loss": _lm_loss_case}

"""The sharded LM on 4 gloo ranks of the CPU against the JAX package's
sharded LM (8 host devices in a child process) and against the port's
own one-device path.

The inputs are made here from seeds (the train states by the port's
``init_train_state``, carried to JAX leaf for leaf).  One JAX child makes
every reference (reduced configs, fp32) while one ``multirank.spawn`` of
4 ranks runs the port's side (``repro_torch.testing.lm_shard_cases``):
the expert-parallel MoE on meshes (2, 2) and (1, 4) with its per-device
routing, the default MoE under a mesh, the collective matmul,
``reshard_state``'s addressable shards, three sharded train steps of
qwen3 and of moonshot with ``moe_ep``, an 8-bit step, the ``act_sp``
forward and the trainer CLI with its resume onto another mesh.  Gates: routing (``slot``,
``keep``) exact; outputs, losses and moments within ``1e-5`` of the
largest entry, the parameters within ``1e-5`` of the state's largest
parameter entry (summation order differs between the sharded and the
one-device runs, and between the frameworks; see the train-step test);
resharded shards bitwise.  The compressed sharded steps are held
against the port's one-device compressed steps (which
``test_torch_lm_train.py`` holds to JAX): losses and parameters as
above; top-k's moments and error buffers within ``1e-5`` of each leaf's
largest entry (it selects the same entries); int8's error buffers and
moments within one quantization step of the leaf's largest corrected
gradient (an int8 code may round one step apart when the sums run in
another order), for the moments weighted by what AdamW carries of it.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.launch import train as launch_train
from repro_torch.models.layers import init_moe, moe_ffn
from repro_torch.pytree import leaf_paths, tree_map
from repro_torch.testing import multirank
from repro_torch.train.train_step import (TrainStepConfig, init_train_state,
                                          make_train_step,
                                          train_state_from_jax)
from _torch_threads import one_intraop_thread  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    "error::repro_torch.core.dispatch.FallbackWarning")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TOL = 1e-5
MOE = "moonshot-v1-16b-a3b"
DENSE = "qwen3-0.6b"
MOE_MESHES = ((2, 2), (1, 4))
CAPACITY = (4.0, 1.25)           # dropless, and with drops
CM_MESHES = ((4, 1), (2, 2))
STEPS, B, S = 3, 4, 16
# compression -> microbatches (top-k's steps split each rank's rows)
COMPRESS = {"int8": 1, "topk": 2}

_CHILD = """
import dataclasses, pickle, sys
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from repro.configs import get_reduced
from repro.distributed.collective_matmul import collective_matmul
from repro.distributed.ctx import activation_mesh
from repro.distributed.elastic import reshard_state
from repro.distributed.sharding import batch_pspec, param_shardings
from repro.models.layers import _moe_local_dispatch, moe_ffn
from repro.train.train_step import TrainStepConfig, make_train_step

MOE, DENSE = {moe!r}, {dense!r}
MOE_MESHES, CAPACITY, CM_MESHES = {moe_meshes}, {capacity}, {cm_meshes}
STEPS, B, S = {steps}, {b}, {s}
out = {{}}


def mesh_of(d, m):
    return Mesh(np.asarray(jax.devices()[:d * m]).reshape(d, m),
                ("data", "model"))


def npy(tree):
    return jax.tree.map(lambda a: np.asarray(jax.device_get(a)), tree)


def shard_index(arr, mesh):
    # {{(i, j): [[start, stop], ...]}} of every addressable shard, checked
    pos = {{dev.id: tuple(int(v) for v in np.argwhere(mesh.devices == dev)[0])
           for dev in mesh.devices.flat}}
    glob = np.asarray(arr)
    res = {{}}
    for sh in arr.addressable_shards:
        idx = [[sl.start or 0, glob.shape[k] if sl.stop is None else sl.stop]
               for k, sl in enumerate(sh.index)]
        assert np.array_equal(np.asarray(sh.data), glob[sh.index])
        res[pos[sh.device.id]] = idx
    return res


def paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in kp), leaf) for kp, leaf in flat]


with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
# (a) the expert-parallel MoE
cfg0 = get_reduced(MOE)
p = jax.tree.map(jnp.asarray, inp["moe_params"])
x = inp["moe_x"]
e, k, dm = cfg0.moe_experts, cfg0.moe_top_k, cfg0.d_model
for cf in CAPACITY:
    cfg = dataclasses.replace(cfg0, capacity_factor=cf)
    ref, aux = jax.jit(lambda p, x: moe_ffn(p, x, cfg))(p, x)
    out[f"dense_{{cf}}"] = (np.asarray(ref), float(aux))
    cfg_ep = dataclasses.replace(cfg, moe_ep=True)
    for d, m in MOE_MESHES:
        mesh = mesh_of(d, m)
        with mesh, activation_mesh(mesh):
            y, a = jax.jit(lambda p, x: moe_ffn(p, x, cfg_ep))(p, x)
        out[f"ep_{{cf}}_{{d}}{{m}}"] = (np.asarray(y), float(a))
        # the shard_map body's routing on device (i, j)
        n_tok = d if (d > 1 and B % d == 0) else 1
        e_loc = e // m
        t_loc = (B // n_tok) * S
        cap_loc = max(int(t_loc * k / e * cf), 4)
        for i in range(d):
            xt = jnp.asarray(x.reshape(n_tok, -1, dm)[i if n_tok > 1 else 0])
            probs = jax.nn.softmax((xt @ p["router"]).astype(jnp.float32), -1)
            gates, eidx = jax.lax.top_k(probs, k)
            gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
            for j in range(m):
                _, slot, keep, _, order = _moe_local_dispatch(
                    xt, gates, eidx, e_loc=e_loc, j0=j * e_loc, e=e, k=k,
                    cap_loc=cap_loc, d=dm)
                out[f"route_{{cf}}_{{d}}{{m}}_{{i}}{{j}}"] = (
                    np.asarray(slot), np.asarray(keep), np.asarray(order))

# (b) the collective matmul
xc, wc = inp["cm_x"], inp["cm_w"]
for d, m in CM_MESHES:
    mesh = mesh_of(d, m)
    with mesh:
        out[f"cm_{{d}}{{m}}"] = np.asarray(
            collective_matmul(xc, wc, mesh, "data", "model"))

# (c) reshard_state's shards, (d) sharded train steps
toks = inp["batches"]
ts = TrainStepConfig()
for arch, over in ((DENSE, {{}}), (MOE, {{"moe_ep": True,
                                        "capacity_factor": 4.0}})):
    cfg = get_reduced(arch, **over)
    state = jax.tree.map(jnp.asarray, inp[f"state_{{arch}}"])
    mesh = mesh_of(2, 2)
    if arch == DENSE:
        sa = reshard_state(state, mesh)
        sb = reshard_state(sa, mesh_of(2, 1))
        for tag, st, mm in (("22", sa, mesh), ("21", sb, mesh_of(2, 1))):
            out[f"shards_{{tag}}"] = {{
                path: shard_index(leaf, mm)
                for path, leaf in paths({{"params": st["params"],
                                         "opt": {{"m": st["opt"]["m"],
                                                 "v": st["opt"]["v"]}}}})}}
    p_sh = param_shardings(state["params"], mesh)
    state = dict(state, params=jax.tree.map(jax.device_put,
                                            state["params"], p_sh))
    step = jax.jit(make_train_step(cfg, ts))
    bsh = NamedSharding(mesh, batch_pspec(mesh, 1))
    losses = []
    with mesh, activation_mesh(mesh):
        for t in toks:
            state, met = step(state, {{"tokens": jax.device_put(
                jnp.asarray(t), bsh)}})
            losses.append(float(met["loss"]))
    out[f"steps_{{arch}}"] = (losses, npy(state))
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _numpy(tree):
    return tree_map(lambda t: t.numpy(), tree)


def _inputs():
    """Every input, made here from seeds: the MoE layer's weights and
    tokens, the matmul operands, the train states (the port's
    ``init_train_state``; the JAX side takes them leaf for leaf) and the
    batches."""
    cfg = get_reduced(MOE)
    rng = np.random.default_rng(1)
    out = {"moe_params": _numpy(init_moe(
               cfg, torch.Generator().manual_seed(0), "cpu")),
           "moe_x": rng.standard_normal((B, S, cfg.d_model)).astype(
               np.float32),
           "cm_x": rng.standard_normal((8, 64)).astype(np.float32),
           "cm_w": rng.standard_normal((64, 32)).astype(np.float32),
           "batches": rng.integers(0, 512, (STEPS, B, S)).astype(np.int32)}
    for arch in (DENSE, MOE):
        out[f"state_{arch}"] = _numpy(init_train_state(
            get_reduced(arch), TrainStepConfig(),
            torch.Generator().manual_seed(0), "cpu"))
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The inputs with the JAX child's references, and the 4 ranks'
    results: the child runs while the ranks do."""
    work = tmp_path_factory.mktemp("sharded_lm")
    inp = _inputs()
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    prog = ("import os\nos.environ['XLA_FLAGS'] = "
            "'--xla_force_host_platform_device_count=8'\n"
            + textwrap.dedent(_CHILD.format(
                moe=MOE, dense=DENSE, moe_meshes=MOE_MESHES,
                capacity=CAPACITY, cm_meshes=CM_MESHES, steps=STEPS, b=B,
                s=S)))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    child = subprocess.Popen(
        [sys.executable, "-c", prog, str(work / "inputs.pkl"),
         str(work / "ref.pkl")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    try:
        ranks = _run_ranks(inp, work)
        out, err = child.communicate(timeout=900)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == 0, f"child failed:\n{out}\n{err}"
    with open(work / "ref.pkl", "rb") as f:
        return {**inp, **pickle.load(f)}, ranks


@pytest.fixture(scope="module")
def jx(both):
    return both[0]


@pytest.fixture(scope="module")
def ranks(both):
    return both[1]


def _run_ranks(jx, work):
    ckpt = str(work / "ckpt")
    jobs = []
    for cf in CAPACITY:
        for d, m in MOE_MESHES:
            jobs.append((f"moe_{cf}_{d}{m}", (d, m), "moe_ep",
                         {"arch": MOE, "capacity_factor": cf,
                          "params": jx["moe_params"], "x": jx["moe_x"]}))
    jobs.append(("moe_dense", (2, 2), "moe_ep",
                 {"arch": MOE, "capacity_factor": 1.25, "ep": False,
                  "params": jx["moe_params"], "x": jx["moe_x"]}))
    for d, m in CM_MESHES:
        jobs.append((f"cm_{d}{m}", (d, m), "collective_matmul",
                     {"x": jx["cm_x"], "w": jx["cm_w"]}))
    jobs.append(("reshard", (2, 2), "reshard",
                 {"arch": DENSE, "state": jx[f"state_{DENSE}"],
                  "via": (2, 1)}))
    jobs.append((f"train_{DENSE}", (2, 2), "lm_train",
                 {"arch": DENSE, "state": jx[f"state_{DENSE}"],
                  "batches": jx["batches"]}))
    jobs.append((f"train_{MOE}", (2, 2), "lm_train",
                 {"arch": MOE, "state": jx[f"state_{MOE}"],
                  "batches": jx["batches"],
                  "overrides": {"moe_ep": True, "capacity_factor": 4.0}}))
    jobs.append(("8bit", (2, 2), "lm_8bit",
                 {"arch": DENSE, "batches": jx["batches"]}))
    jobs.append(("act_sp", (2, 2), "act_sp",
                 {"arch": DENSE, "state": jx[f"state_{DENSE}"],
                  "batches": jx["batches"]}))
    for kind in COMPRESS:
        jobs.append((f"train_{kind}", (2, 2), "lm_train",
                     {"arch": DENSE, "state": jx[f"state_{DENSE}"],
                      "batches": jx["batches"], "compress": kind,
                      "microbatches": COMPRESS[kind]}))
    jobs.append(("cli_int8", (2, 2), "lm_cli",
                 {"arch": DENSE, "steps": 2, "compress": "int8"}))
    jobs.append(("cli22", (2, 2), "lm_cli",
                 {"arch": DENSE, "steps": 4, "dir": ckpt}))
    jobs.append(("cli21", (2, 1), "lm_cli",
                 {"arch": DENSE, "steps": 6, "dir": ckpt}))
    return multirank.spawn(4, jobs, work)


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"max error {err:.3g} of the largest entry"


def _one_device_steps(jx, arch, **over):
    cfg = get_reduced(arch, **over)
    state = train_state_from_jax(cfg, jx[f"state_{arch}"], device="cpu")
    step = make_train_step(cfg, TrainStepConfig())
    losses = []
    for t in jx["batches"]:
        state, met = step(state, {"tokens": torch.from_numpy(t)})
        losses.append(float(met["loss"]))
    return losses, dict(leaf_paths(state))


@pytest.mark.parametrize("cf", CAPACITY)
@pytest.mark.parametrize("mesh", MOE_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_moe_ep_matches_jax(jx, ranks, cf, mesh):
    d, m = mesh
    want, aux = jx[f"ep_{cf}_{d}{m}"]
    for r in range(d * m):
        res = ranks[r][f"moe_{cf}_{d}{m}"]
        _close(res["out"], want)
        _close(res["aux"], aux)
        i, j = res["pos"]
        slot, keep, order = jx[f"route_{cf}_{d}{m}_{i}{j}"]
        assert np.array_equal(res["slot"].numpy(), slot)
        assert np.array_equal(res["keep"].numpy(), keep)
        assert np.array_equal(res["order"].numpy(), order)
    if cf == 4.0:         # dropless: the port's own dense path agrees
        cfg = get_reduced(MOE, capacity_factor=cf)
        p = {k: torch.from_numpy(np.asarray(v)) if not isinstance(v, dict)
             else {kk: torch.from_numpy(np.asarray(vv))
                   for kk, vv in v.items()}
             for k, v in jx["moe_params"].items()}
        dense, dense_aux = moe_ffn(p, torch.from_numpy(jx["moe_x"]), cfg)
        _close(ranks[0][f"moe_{cf}_{d}{m}"]["out"], dense)
        _close(ranks[0][f"moe_{cf}_{d}{m}"]["aux"], dense_aux)


def test_default_moe_under_a_mesh_is_the_one_device_path(jx, ranks):
    """The default (global-dispatch) MoE under a (2, 2) mesh, with drops
    (capacity 1.25): every rank routes all the tokens with the global
    capacity, so the output and aux match the one-device ``moe_ffn``."""
    cfg = get_reduced(MOE, capacity_factor=1.25)
    p = {k: torch.from_numpy(np.asarray(v)) if not isinstance(v, dict)
         else {kk: torch.from_numpy(np.asarray(vv)) for kk, vv in v.items()}
         for k, v in jx["moe_params"].items()}
    want, aux = moe_ffn(p, torch.from_numpy(jx["moe_x"]), cfg)
    for r in range(4):
        _close(ranks[r]["moe_dense"]["out"], want)
        _close(ranks[r]["moe_dense"]["aux"], aux)
    _close(want, jx["dense_1.25"][0])


@pytest.mark.parametrize("mesh", CM_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_collective_matmul_matches_jax(jx, ranks, mesh):
    d, m = mesh
    for r in range(d * m):
        _close(ranks[r][f"cm_{d}{m}"]["y"], jx[f"cm_{d}{m}"])
    _close(ranks[0][f"cm_{d}{m}"]["y"], jx["cm_x"] @ jx["cm_w"], 1e-5)


def test_reshard_state_shards_equal_jax_addressable_shards(jx, ranks):
    glob = {p: np.asarray(v) for p, v in leaf_paths(jx[f"state_{DENSE}"])}
    for tag, local_key, pos_key in (("22", "local", "pos"),
                                    ("21", "via_local", "via_pos")):
        checked = 0
        for r in range(4):
            res = ranks[r]["reshard"]
            if res[pos_key] is None:
                continue
            pos = tuple(res[pos_key])
            for path, by_pos in jx[f"shards_{tag}"].items():
                idx = tuple(slice(a, b) for a, b in by_pos[pos])
                want = glob[path][idx]
                got = res[local_key][path].numpy()
                assert got.shape == want.shape, (tag, path, pos)
                assert np.array_equal(got, want), (tag, path, pos)
                checked += 1
        assert checked
    assert all(ranks[r]["reshard"]["roundtrip_bitwise"] for r in range(4))


@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_sharded_train_steps_match_one_device_and_jax(jx, ranks, arch):
    over = {"moe_ep": True, "capacity_factor": 4.0} if arch == MOE else {}
    res = ranks[0][f"train_{arch}"]
    losses, state = _one_device_steps(jx, arch, **over)
    jax_losses, jax_state = jx[f"steps_{arch}"]
    _close(res["losses"], losses)
    _close(res["losses"], jax_losses)
    jax_flat = {p: np.asarray(v, np.float32)
                for p, v in leaf_paths(jax_state)}
    # AdamW moves every entry whose gradient is above eps by about lr a
    # step, however small the gradient: an entry whose gradient cancels
    # to near 0 carries its rounding (another summation order) into a
    # full step.  So the parameters are held within 1e-5 of the largest
    # parameter entry of the state, the moments within 1e-5 of each
    # leaf's largest.
    top = max(float(np.abs(v.numpy()).max()) for p, v in state.items()
              if p.startswith("params"))
    for path, got in res["state"].items():
        if path.startswith("params"):
            for want in (state[path].numpy(), jax_flat[path]):
                err = float(np.abs(got.numpy() - want).max())
                assert err <= TOL * top, (path, err / top)
        elif path.startswith(("opt/m", "opt/v")):
            _close(got, state[path])
            _close(got, jax_flat[path])
    for r in range(4):
        assert ranks[r][f"train_{arch}"]["losses"] == res["losses"]


@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_no_param_is_gathered_before_the_step(ranks, arch):
    for r in range(4):
        res = ranks[r][f"train_{arch}"]
        assert res["seen"] == res["want"]
    # the embedding is split over both axes on every rank: (V/2, d/2)
    assert ranks[0][f"train_{arch}"]["seen"]["embed"] == (256, 64)


def test_sharded_8bit_step_matches_one_device(jx, ranks):
    from repro_torch.train.optimizer import AdamWConfig
    cfg = get_reduced(DENSE)
    ts = TrainStepConfig(opt=AdamWConfig(quantize_state=True))
    state = init_train_state(cfg, ts, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(jx["batches"][0])
    state, _ = make_train_step(cfg, ts)(state, {"tokens": tokens})
    got = ranks[0]["8bit"]["state"]
    for path, want in leaf_paths(state):
        if path.startswith("params"):
            _close(got[path], want)
        elif path.startswith(("opt/m/", "opt/v/")):
            # int8 codes: within one step (an fp32 rounding apart)
            diff = (got[path].int() - want.int()).abs()
            assert int(diff.max()) <= 1, path
        elif "scale" in path:
            _close(got[path], want)


def test_act_sp_forward_matches_plain(jx, ranks):
    from repro_torch.models.lm import lm_forward, unstack_layers

    cfg = get_reduced(DENSE, act_sp=True)
    state = train_state_from_jax(cfg, jx[f"state_{DENSE}"], device="cpu")
    with torch.no_grad():
        want, _ = lm_forward(unstack_layers(state["params"]),
                             {"tokens": torch.from_numpy(jx["batches"][0])},
                             cfg)
    res = ranks[0]["act_sp"]
    _close(res["logits"], want)
    # between layers the sequence dim is split over "model"
    assert res["placements"] and all("Shard(dim=1)" in p
                                     for p in res["placements"])


def test_cli_trains_sharded_and_resumes_onto_another_mesh(ranks, tmp_path):
    first, resumed = ranks[0]["cli22"], ranks[0]["cli21"]
    assert first["start"] == 0 and len(first["losses"]) == 4
    assert resumed["start"] == 4 and len(resumed["losses"]) == 2
    assert "cli21" not in ranks[2]           # ranks 2, 3 stand outside
    args = launch_train.parse_args(
        ["--arch", DENSE, "--reduced", "--device", "cpu", "--steps", "6",
         "--batch", "4", "--seq", "16", "--log-every", "100"])
    plain = launch_train.run(args)["losses"]
    _close(first["losses"] + resumed["losses"], plain)


def test_one_by_one_axes_keep_the_one_device_path():
    """``--data-axis 1 --model-axis 1`` starts no process group and keeps
    plain tensors (the refusal of a larger mesh without torchrun is
    ``test_torch_lm_train.py::test_sharded_axes_are_refused``)."""
    import torch.distributed as dist

    args = launch_train.parse_args(
        ["--arch", DENSE, "--reduced", "--device", "cpu", "--data-axis",
         "1", "--model-axis", "1", "--steps", "1", "--batch", "2",
         "--seq", "8"])
    out = launch_train.run(args)
    assert not dist.is_initialized()
    assert all(type(t) is torch.Tensor for _, t in leaf_paths(out["state"]))


def test_constrain_is_the_identity_without_a_mesh():
    from repro_torch.distributed.ctx import activation_mesh, constrain

    x = torch.randn(4, 8)
    assert constrain(x, "act_batch", None) is x
    with activation_mesh(None):
        assert constrain(x, "act_batch") is x


def _one_device_compressed(jx, kind):
    """The port's one-device steps under ``kind`` compression from the
    same state and batches; and, per leaf, one quantization step of its
    largest corrected gradient over the steps (the int8 tolerance)."""
    from repro_torch.train.compression import CompressionConfig, init_error
    from repro_torch.train.train_step import accumulate_grads, \
        apply_gradients

    cfg = get_reduced(DENSE)
    ts = TrainStepConfig(compression=CompressionConfig(kind=kind),
                         microbatches=COMPRESS[kind])
    state = train_state_from_jax(cfg, jx[f"state_{DENSE}"], device="cpu")
    state["err"] = init_error(state["params"])
    losses, steps = [], {}
    for t in jx["batches"]:
        loss, _, grads = accumulate_grads(cfg, ts, state["params"],
                                          {"tokens": torch.from_numpy(t)})
        for path, g in leaf_paths(grads):
            e = dict(leaf_paths(state["err"]))[path]
            steps[path] = max(steps.get(path, 0.0),
                              float((g.float() + e).abs().max()) / 127.0)
        state, _ = apply_gradients(state, grads, ts)
        losses.append(float(loss))
    return losses, dict(leaf_paths(state)), steps


@pytest.mark.parametrize("kind", COMPRESS)
def test_sharded_compressed_steps_match_one_device(jx, ranks, kind):
    from repro_torch.train.optimizer import AdamWConfig

    res = ranks[0][f"train_{kind}"]
    losses, state, steps = _one_device_compressed(jx, kind)
    _close(res["losses"], losses)
    top = max(float(np.abs(v.numpy()).max()) for p, v in state.items()
              if p.startswith("params"))
    b1, b2 = AdamWConfig().b1, AdamWConfig().b2   # AdamW carries (1 - b)
    checked = set()
    for path, got in res["state"].items():
        want = state[path]
        if path.startswith("params"):
            err = float((got - want).abs().max())
            assert err <= TOL * top, (path, err / top)
        elif kind == "topk" and path.startswith(("err/", "opt/m/",
                                                 "opt/v/")):
            _close(got, want)
        elif path.startswith(("err/", "opt/m/", "opt/v/")):
            group, leaf = (("err", path[4:]) if path.startswith("err/")
                           else (path[:5], path[6:]))
            q = 1.01 * steps[leaf]
            tol = {"err": q, "opt/m": STEPS * (1 - b1) * q,
                   "opt/v": STEPS * (1 - b2) * q * 255 * q}[group]
            assert float((got - want).abs().max()) <= tol, path
        else:
            continue
        checked.add(path.split("/")[0])
    assert checked == {"params", "err", "opt"}
    for r in range(4):
        assert ranks[r][f"train_{kind}"]["losses"] == res["losses"]


def test_cli_trains_sharded_with_int8_compression(ranks):
    args = launch_train.parse_args(
        ["--arch", DENSE, "--reduced", "--device", "cpu", "--steps", "2",
         "--batch", "4", "--seq", "16", "--compress", "int8",
         "--log-every", "100"])
    plain = launch_train.run(args)["losses"]
    for r in range(4):
        _close(ranks[r]["cli_int8"]["losses"], plain)

"""The sharded serving step and the vocab-parallel loss on 4 gloo ranks
of the CPU, against the JAX package (one child process) and against the
port's one-device path.

Six families at ``get_reduced`` size, fp32, seed 0, their weights drawn
by the port's ``init_lm`` and handed to both packages as one numpy tree
(the port reads it through ``lm_params_from_jax``):

  qwen3-0.6b with one kv-head (divides no "model": the cache's sequence
  takes "model"), granite-3-2b with four (divide "model": heads over
  "model", the sequence whole or over "data"), deepseek-v3-671b (MLA +
  MoE), mamba2-2.7b, zamba2-1.2b at B = 1 (the sequence over every axis:
  ``long_500k``'s layout) and seamless-m4t-medium (enc-dec).

On meshes (2, 2) and (1, 4): the reference's ``lm_prefill`` then six
``lm_decode_step``s, against the port's one-device prefill laid out by
``cache_shardings`` and six steps on DTensors (``lm_shard_cases``'s
``lm_decode``), each step's logits and the cache after the six.  The rows start at positions 3, 7, 12 and ``CAP + 1``,
so the steps write both sides of every shard boundary (a local length of
4, 8 or 16: ``S_loc - 1`` and ``S_loc``), run a row past the capacity,
and keep one past it throughout.  Gates: each step's logits within
``1e-5`` of the largest logit; every cache leaf, gathered, within
``rtol=1e-4, atol=1e-5`` of JAX's; a row past the capacity keeps its
sequence-indexed cache bit for bit.

The loss: qwen3-0.6b with a vocab of 500 (12 pad columns of ``-1e30`` on
the last "model" rank) on (2, 2) and on a one-rank mesh: the
vocab-parallel ``lm_loss`` and every parameter's gradient within
``1e-5`` of the largest entry of the one-device port's and of
``jax.grad``'s; at one rank bit for bit the one-device ones; without a
mesh, ``lm_loss`` equals the one-device code it always ran.

On ``meta`` over a fake group of 4 ranks (``launch/mesh.fake_group``,
nothing allocated): no storage the traced ``train_4k`` step allocates is
as large as the global (B, S-1, V) fp32 logits gradient, and no
collective of a traced decode step returns the cache's sequence length.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, get_config, get_reduced
from repro_torch.models import lm
from repro_torch.pytree import leaf_paths, tree_map
from repro_torch.testing import multirank
from _torch_threads import one_intraop_thread  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    "error::repro_torch.core.dispatch.FallbackWarning")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
FAMILIES = {                      # arch: (overrides, batch)
    "qwen3-0.6b": ({"n_kv_heads": 1}, 4),
    "granite-3-2b": ({"n_kv_heads": 4}, 4),
    "deepseek-v3-671b": ({}, 4),
    "mamba2-2.7b": ({}, 4),
    "zamba2-1.2b": ({}, 1),
    "seamless-m4t-medium": ({}, 4),
}
MESHES = ((2, 2), (1, 4))
CAP, PROMPT, STEPS = 16, 3, 6
POS = (3, 7, 12, CAP + 1)
LOGIT_TOL, RTOL, ATOL = 1e-5, 1e-4, 1e-5
LOSS_ARCH, LOSS_OVER = "qwen3-0.6b", {"vocab": 500}
LOSS_B, LOSS_S = 4, 16
GRAD_TOL = 1e-5
SEQ_LEAVES = ("k", "v", "ckv", "k_rope")     # indexed by position

_CHILD = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_reduced
from repro.models import lm


def npy(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
out = {}
for arch, case in inp["decode"].items():
    cfg = get_reduced(arch, **case["overrides"])
    params = jax.tree.map(jnp.asarray, case["params"])
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    _, cache = jax.jit(lambda p, b, cfg=cfg, cap=case["cap"]: lm.lm_prefill(
        p, b, cfg, cap))(params, batch)
    cache["pos"] = jnp.asarray(case["pos"])
    step = jax.jit(lambda p, t, c, cfg=cfg: lm.lm_decode_step(p, t, c, cfg))
    logits = []
    for tokens in case["steps"]:
        lg, cache = step(params, jnp.asarray(tokens), cache)
        logits.append(np.asarray(lg))
    out[arch] = (logits, npy(cache))
case = inp["loss"]
cfg = get_reduced(case["arch"], **case["overrides"])
params = jax.tree.map(jnp.asarray, case["params"])
batch = {"tokens": jnp.asarray(case["tokens"])}
loss, grads = jax.jit(jax.value_and_grad(
    lambda p: lm.lm_loss(p, batch, cfg)[0]))(params)
out["loss"] = (float(loss), npy(grads))
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _numpy(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), tree)


def _stacked_params(cfg):
    return lm.stack_layers(lm.init_lm(cfg, torch.Generator().manual_seed(0),
                                      "cpu"))


def _inputs():
    rng = np.random.default_rng(1)
    out = {"decode": {}}
    for arch, (over, b) in FAMILIES.items():
        cfg = get_reduced(arch, **over)
        batch = {"tokens": rng.integers(0, cfg.vocab, (b, PROMPT))
                 .astype(np.int32)}
        if cfg.family == "encdec":
            batch["src_embeds"] = rng.standard_normal(
                (b, 6, cfg.d_model)).astype(np.float32)
        out["decode"][arch] = {
            "arch": arch, "overrides": over, "cap": CAP, "batch": batch,
            "params": _numpy(_stacked_params(cfg)),
            "pos": np.asarray(POS[:b], np.int32),
            "steps": rng.integers(0, cfg.vocab, (STEPS, b, 1))
            .astype(np.int32)}
    cfg = get_reduced(LOSS_ARCH, **LOSS_OVER)
    out["loss"] = {"arch": LOSS_ARCH, "overrides": LOSS_OVER,
                   "params": _numpy(_stacked_params(cfg)),
                   "tokens": rng.integers(0, cfg.vocab, (LOSS_B, LOSS_S))
                   .astype(np.int32)}
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The inputs with the JAX child's references, and rank 0's results
    of the 4 ranks: the child runs while the ranks do."""
    work = tmp_path_factory.mktemp("sharded_serve")
    inp = _inputs()
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    # XLA's backend at -O0: the references' compiles take a third less
    # CPU, and their values move by about 1e-6 of the largest logit
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_backend_optimization_level=0")
    child = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_CHILD),
         str(work / "inputs.pkl"), str(work / "ref.pkl")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        jobs = [(f"{arch}_{d}{m}", (d, m), "lm_decode", case)
                for arch, case in inp["decode"].items()
                for d, m in MESHES]
        jobs += [(f"loss_{d}{m}", (d, m), "lm_loss", inp["loss"])
                 for d, m in ((2, 2), (1, 1))]
        ranks = multirank.spawn(4, jobs, work)
        out, err = child.communicate(timeout=900)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == 0, f"child failed:\n{out}\n{err}"
    with open(work / "ref.pkl", "rb") as f:
        return inp, pickle.load(f), ranks[0]


def _flat(tree, prefix=""):
    """``{path: array}`` of a nest of dicts (JAX's output)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_sharded_decode_matches_jax(both, arch, mesh):
    _, ref, rank0 = both
    got = rank0[f"{arch}_{mesh[0]}{mesh[1]}"]
    cfg = get_reduced(arch, **FAMILIES[arch][0])
    logits, cache = ref[arch]
    for i, want in enumerate(logits):
        assert _rel(got["logits"][i][..., :cfg.vocab],
                    want[..., :cfg.vocab]) <= LOGIT_TOL, (arch, i)
    want = {p: a for p, a in _flat(cache).items() if a is not None}
    assert set(got["cache"]) == set(want), arch
    for path, arr in want.items():
        leaf = got["cache"][path].numpy()
        if path == "pos":
            assert np.array_equal(leaf, arr)
        else:
            np.testing.assert_allclose(leaf, arr, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{arch} {path}")
    pos = np.asarray(POS[:FAMILIES[arch][1]])
    written = {int(p) + s for p in pos for s in range(STEPS)
               if p + s < CAP}
    for path, (_, shape) in got["layout"].items():
        name = path.split("/")[-1]
        if name not in SEQ_LEAVES:
            continue
        s_loc = shape[2]                    # (L, B_loc, S_loc, ...)
        assert {s_loc - 1, s_loc} <= written | {CAP}, (path, s_loc)
        for row in np.nonzero(pos >= CAP)[0]:
            # a row past the capacity keeps its cache bit for bit
            assert torch.equal(got["cache"][path][:, row],
                               got["prefill"][path][:, row]), (path, row)


def test_a_split_sequence_is_exercised(both):
    """The layouts the decode test ran: the sequence split over "model"
    (qwen3), over "data" with heads over "model" (zamba2 at B = 1 on
    (2, 2)), not split (granite), and four ways (deepseek's latent cache
    on (1, 4))."""
    _, _, rank0 = both
    assert rank0["qwen3-0.6b_22"]["layout"]["layers/k"][0] == \
        "(Shard(dim=1), Shard(dim=2))"
    assert rank0["zamba2-1.2b_22"]["layout"]["shared_attn/k"][0] == \
        "(Shard(dim=2), Shard(dim=3))"
    assert rank0["granite-3-2b_22"]["layout"]["layers/k"][0] == \
        "(Shard(dim=1), Shard(dim=3))"
    assert rank0["deepseek-v3-671b_14"]["layout"]["layers/ckv"][1][2] == \
        CAP // 4


def _one_device_loss(case):
    cfg = get_reduced(case["arch"], **case["overrides"])
    params = tree_map(lambda a: torch.from_numpy(a).requires_grad_(),
                      case["params"])
    flat = [t for _, t in leaf_paths(params)]
    loss, _ = lm.lm_loss(params, {"tokens": torch.from_numpy(
        case["tokens"])}, cfg)
    grads = torch.autograd.grad(loss, flat)
    return loss.detach(), {p: g for (p, _), g in
                           zip(leaf_paths(params), grads)}


@pytest.mark.parametrize("mesh", ["22", "11"])
def test_vocab_parallel_loss_matches_one_device_and_jax(both, mesh):
    inp, ref, rank0 = both
    got = rank0[f"loss_{mesh}"]
    loss1, grads1 = _one_device_loss(inp["loss"])
    jloss, jgrads = ref["loss"]
    jflat = _flat(jgrads)
    assert abs(float(got["loss"]) - float(loss1)) <= GRAD_TOL * abs(
        float(loss1))
    assert abs(float(got["loss"]) - jloss) <= GRAD_TOL * abs(jloss)
    assert set(got["grads"]) == set(grads1) == set(jflat)
    for path, g in got["grads"].items():
        assert _rel(g, grads1[path]) <= GRAD_TOL, path
        assert _rel(g, jflat[path]) <= GRAD_TOL, path
    if mesh == "11":        # one rank: the one-device arithmetic, bitwise
        assert torch.equal(got["loss"], loss1)
        assert all(torch.equal(g, grads1[p]) for p, g in got["grads"].items())


def test_loss_without_a_mesh_is_the_one_device_code():
    """The code ``lm_loss`` ran before it had a vocab-parallel path, on
    plain tensors: the same bits."""
    cfg = get_reduced(LOSS_ARCH, **LOSS_OVER)
    params = _stacked_params(cfg)
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12))
                              .astype(np.int32))
    loss, parts = lm.lm_loss(params, {"tokens": tokens}, cfg)
    logits, aux = lm.lm_forward(lm.unstack_layers(params),
                                {"tokens": tokens}, cfg)
    targets = tokens[:, 1:].long()
    logits = logits[:, :-1].float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, targets.clamp(min=0)[..., None])[..., 0]
    mask = (targets >= 0).to(torch.float32)
    ce = ((lse - picked) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    assert torch.equal(parts["ce"], ce)
    assert torch.equal(loss, ce + 0.01 * aux)


def _fake_mesh(shape):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(4).reshape(shape),
                      mesh_dim_names=("data", "model"))


def _overrides(arch, **keep):
    full, red = get_config(arch), get_reduced(arch)
    over = {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if getattr(red, f.name) != getattr(full, f.name)}
    for name in keep:
        over.pop(name, None)
    return over


def test_train_step_holds_no_global_logits_gradient():
    """qwen3-0.6b's ``train_4k`` step (reduced widths, its full vocab of
    151,936) on a fake (2, 2) group: its largest storage is below the
    global (B, S-1, V) fp32 logits gradient, and at least its own shard
    of it."""
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import fake_group

    over = _overrides("qwen3-0.6b", vocab=True)
    shape = SHAPES["train_4k"]
    vp = get_config("qwen3-0.6b").padded_vocab
    with fake_group(4):
        mesh = _fake_mesh((2, 2))
        plan = cells.plan_cell("qwen3-0.6b", "train_4k", mesh,
                               cfg_overrides=over)
        res = cells.compile_cell(plan, mesh, "m2x2")
    glob = shape.global_batch * (shape.seq_len - 1) * vp * 4
    assert res.error is None
    assert glob // 4 <= res.trace.largest < glob, (res.trace.largest, glob)


@pytest.mark.parametrize("arch,shape,mesh,over", [
    ("qwen3-0.6b", "decode_32k", (2, 2), {"n_kv_heads": 1}),
    ("deepseek-v3-671b", "decode_32k", (1, 4), {}),
    ("zamba2-1.2b", "long_500k", (2, 2), {}),
])
def test_decode_trace_gathers_no_cache_sequence(arch, shape, mesh, over):
    """A decode step traced on a fake group: no collective returns a
    tensor with the cache's sequence length, and the merge's statistics
    (max and sum, shaped (..., 1, 1)) are all-reduced, two a layer."""
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import fake_group

    cfg_over = dict(_overrides(arch), **over)
    cap = SHAPES[shape].seq_len
    with fake_group(4):
        m = _fake_mesh(mesh)
        plan = cells.plan_cell(arch, shape, m, cfg_overrides=cfg_over)
        res = cells.compile_cell(plan, m, "fake")
    shapes = res.trace.collective_shapes
    assert res.error is None and res.trace.flops > 0
    assert not any(cap in s for outs in shapes for s in outs)
    cfg = get_reduced(arch, **over)
    n_attn = (cfg.n_layers // cfg.attn_every if cfg.attn_every
              else cfg.n_layers)
    reduces = sum(kind == "all-reduce" and s[0][-2:] == (1, 1)
                  for (kind, _, _), s in zip(res.trace.collectives, shapes))
    assert reduces >= 2 * n_attn

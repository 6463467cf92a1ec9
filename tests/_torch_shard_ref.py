"""Inputs, multi-rank runs and JAX references shared by the sharded-op
tests (``test_torch_shard.py``, ``test_torch_shard_overlap.py``).

Each file runs one 4-rank gloo spawn (:func:`run_jobs`) of the port's
sharded impl on meshes (4, 1), (2, 2) and (2, 1) and holds what comes
back against the JAX package's single-device functions on the same
seeded numpy inputs:

* fp32 within ``rtol=1e-5, atol=1e-6 ×`` the largest entry;
* bf16 within one bf16 ulp of the sum, rounded once, of the partials a
  sharded run rounds to bf16 (one per rank, or per rank and batch on the
  overlapped route; the partials are JAX fp32 products on the widened
  operands over the rank's blocks and rows of the JAX package's own
  partition); the attention is window-aligned, so its rows are whole;
* int8 within the conformance ladder of the JAX package's int8 SpMM.
"""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

import repro.core as jcore
import repro.sparse.graphs as jgraphs
from repro.core.autodiff import ad_plan as jax_ad_plan
from repro.core.sddmm import with_values as jax_with_values
from repro.data.datasets import load_vendored
from repro.distributed.sparse_shard import partition_schedule
from repro.models import gnn as jgnn
from repro.train.train_step import make_gnn_train_step as jax_train_step
from repro_torch.testing import multirank

MESHES = ((4, 1), (2, 2), (2, 1))
H, N, F, DV = 2, 16, 16, 12
LR = 0.05
ULP = 2.0 ** -7
ATOL_FP32 = 1e-6
# The gates of a GNN step against the JAX package's blocked step.
LOGIT_TOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4


def _r(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def ops_inputs(a: np.ndarray, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    m, k = a.shape
    return dict(a=a, b2=_r(rng, k, N), b3=_r(rng, H, k, N), q2=_r(rng, m, F),
                k2=_r(rng, k, F), v2=_r(rng, k, DV), q3=_r(rng, H, m, F),
                k3=_r(rng, H, k, F), v3=_r(rng, H, k, DV))


@functools.lru_cache(maxsize=None)
def hub_matrix() -> np.ndarray:
    """``tests/data/hub_96``: hub windows that the 4-rank cuts split."""
    return load_vendored(["hub_96"])[0].dense()


def tiny_matrix() -> np.ndarray:
    """One window of one K-block: fewer segments than ranks."""
    a = np.zeros((8, 8), np.float32)
    a[np.arange(8), np.arange(8)] = 1.0 + np.arange(8)
    a[0, 5] = -2.0
    return a


def _graph(n=56, deg=5, seed=7):
    rows, cols = jgraphs.erdos_renyi_graph(n, deg, seed=seed)
    loops = np.arange(n)
    rows, cols = np.concatenate([rows, loops]), np.concatenate([cols, loops])
    return rows, cols, jgraphs.gcn_normalized(rows, cols, n), n


def _cfg_kw(model):
    return dict(model=model, in_dim=16, hidden_dim=16 if model == "gcn" else 8,
                num_classes=4, num_layers=3 if model == "gcn" else 2)


def _task(n):
    rng = np.random.default_rng(3)
    return (rng.standard_normal((n, 16)).astype(np.float32),
            rng.integers(0, 4, size=n),
            (rng.random(n) < 0.7).astype(np.float32))


def _jax_params(model):
    jcfg = jgnn.GNNConfig(impl="blocked", **_cfg_kw(model))
    init = jgnn.init_gcn if model == "gcn" else jgnn.init_agnn
    params = init(jax.random.key(0), jcfg)
    if model == "agnn":   # a learned β away from its init
        params["beta"] = [jnp.asarray(1.7, jnp.float32),
                          jnp.asarray(0.6, jnp.float32)]
    return jcfg, params


def train_inputs(model: str, impl: str) -> dict:
    _, params = _jax_params(model)
    graph = _graph()
    return dict(impl=impl, cfg=_cfg_kw(model), graph=graph,
                params=jax.tree.map(np.asarray, params),
                task=_task(graph[3]), lr=LR)


def jobs(impl: str) -> list:
    """Every job of one file's spawn."""
    out = [(f"hub{d}{m}", (d, m), "ops", dict(ops_inputs(hub_matrix()),
                                              impl=impl))
           for d, m in MESHES]
    out.append(("tiny", (4, 1), "ops", dict(ops_inputs(tiny_matrix(), 1),
                                            impl=impl)))
    out.append(("empty", (4, 1), "ops",
                dict(ops_inputs(np.zeros((20, 20), np.float32), 2),
                     impl=impl)))
    out += [(f"train_{model}", (2, 1), "train", train_inputs(model, impl))
            for model in ("gcn", "agnn")]
    return out


def run_jobs(impl: str, workdir) -> list:
    return multirank.spawn(4, jobs(impl), workdir)


# ---------------------------------------------------------------------------
# JAX references
# ---------------------------------------------------------------------------


def _bf16(x) -> np.ndarray:
    """``x`` rounded to bf16, as fp32 numpy."""
    return torch.from_numpy(np.array(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _heads(fn, *ops):
    """``fn`` per head over operands that may carry a head dim."""
    h = next((x.shape[0] for x in ops if x.ndim == 3), None)
    if h is None:
        return np.asarray(fn(*ops))
    return np.stack([np.asarray(fn(*(x[i] if x.ndim == 3 else x
                                      for x in ops))) for i in range(h)])


@functools.lru_cache(maxsize=None)
def _jax_formats(key: bytes, shape):
    a = np.frombuffer(key, np.float32).reshape(shape)
    jfmt = jcore.from_dense(a)
    return jfmt, jcore.block_format(jfmt, 8)


@functools.lru_cache(maxsize=None)
def _pieces(key: bytes, shape, d: int, overlap: bool):
    """The (value-row mask, output-row mask) of each partial a sharded run
    rounds: one per rank, or per rank and batch on the overlapped route,
    from the JAX package's partition of the matrix ``key`` holds."""
    jb = _jax_formats(key, shape)[1]
    part = partition_schedule(jb, None, d, n_batches=2 if overlap else 1)
    nnzp, m = jb.cols.shape[0], jb.shape[0]
    if not overlap:
        return list(zip(np.asarray(part.blk_own), np.asarray(part.row_own)))
    out = []
    bval = np.asarray(part.bval_idx)
    brow = np.asarray(part.brow_idx)
    for bvi, bri in zip(bval.reshape(-1, bval.shape[-1]),
                        brow.reshape(-1, brow.shape[-1])):
        vmask, rmask = np.zeros(nnzp, bool), np.zeros(m, bool)
        vmask[bvi[bvi < nnzp]] = True
        rmask[bri[bri < m]] = True
        out.append((vmask, rmask))
    return out


def reference(name: str, inp: dict, d: int, model: int, overlap: bool):
    """``(want, rtol, atol)`` of one output of the ``ops`` case."""
    a = inp["a"]
    jfmt, jb = _jax_formats(a.tobytes(), a.shape)
    op, prec = name.split("_")
    x = {key: inp[key] for key in ("b2", "b3", "q2", "k2", "v2", "q3", "k3",
                                   "v3")}
    scale_q = 1.0 / np.sqrt(F)

    def spmm(vals, b):
        return jcore.spmm_blocked(jax_with_values(jb, jnp.asarray(vals)),
                                  jnp.asarray(b))

    def sddmm(q, k):
        return jcore.sddmm_blocked(jb, jnp.asarray(q), jnp.asarray(k))

    def attn(q, k, v, scale):
        return jcore.attention(jfmt, jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), impl="blocked", scale=scale)

    vals = np.asarray(jb.vals)
    b = x["b2"] if op == "spmm2" else x["b3"]
    if op.startswith("spmm") and prec == "int8":
        want = np.asarray(jcore.spmm(jfmt, jnp.asarray(b), impl="blocked",
                                     precision="int8"), np.float32)
        scale = max(float(np.abs(want).max()), 1.0)
        return want, 5e-2, 5e-2 * scale
    if op.startswith("spmm") and prec == "bf16":
        vals, b = _bf16(vals), _bf16(b)
        parts = [_bf16(_heads(lambda b_: spmm(vals * vm[:, None], b_), b)
                       * rm[:, None]) for vm, rm in _pieces(a.tobytes(), a.shape, d, overlap)]
        want = _bf16(np.sum(parts, axis=0))
    elif op.startswith("spmm"):
        want = _heads(lambda b_: spmm(vals, b_), b)
    elif op.startswith("sddmm"):
        q = x["q2"] if op == "sddmm2" else x["q3"]
        k = x["k2"]
        if prec == "bf16":
            q, k = _bf16(q), _bf16(k)
            if op == "sddmm2" and model > 1:   # "feat": F split, summed
                half = F // model
                want = _bf16(np.sum([_bf16(sddmm(q[:, i:i + half],
                                                 k[:, i:i + half]))
                                     for i in range(0, F, half)], axis=0))
            else:
                want = _bf16(_heads(sddmm, q, k))
        else:
            want = _heads(sddmm, q, k)
    else:
        q, k, v = ((x["q2"], x["k2"], x["v2"]) if op == "attn2"
                   else (x["q3"], x["k3"], x["v3"]))
        if prec == "bf16":   # Q scaled in fp32 and rounded, as the kernel
            q = _bf16(_bf16(q) * np.float32(scale_q))
            want = _bf16(_heads(lambda *t: attn(*t, 1.0), q, _bf16(k),
                                _bf16(v)))
        else:
            want = _heads(lambda *t: attn(*t, scale_q), q, k, v)
    want = np.asarray(want, np.float32)
    top = float(np.abs(want).max()) if want.size else 0.0
    if prec == "bf16":
        return want, ULP, ATOL_FP32 * top
    return want, 1e-5, ATOL_FP32 * top


def check_ops(out: dict, inp: dict, d: int, model: int, overlap: bool):
    """Every output of one ``ops`` job against its JAX reference."""
    assert out, "the job returned nothing"
    for name, got in out.items():
        want, rtol, atol = reference(name, inp, d, model, overlap)
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                                   atol=atol, err_msg=name)


def check_dense(out: dict, a: np.ndarray, inp: dict):
    """Outputs of a job on a pattern with store-only ranks against dense
    numpy products (fp32)."""
    mask = a != 0
    for name in ("spmm2_fp32", "sddmm2_fp32", "attn2_fp32"):
        got = out[name].numpy()
        if name.startswith("spmm"):
            np.testing.assert_allclose(got, a @ inp["b2"], rtol=1e-5,
                                       atol=1e-5)
        elif name.startswith("sddmm"):
            jb = jcore.block_format(jcore.from_dense(a), 8)
            want = np.asarray(jcore.sddmm_blocked(jb, jnp.asarray(inp["q2"]),
                                                  jnp.asarray(inp["k2"])))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            s = (inp["q2"] @ inp["k2"].T) / np.sqrt(F)
            s = np.where(mask, s, -np.inf)
            p = np.exp(s - np.where(mask.any(1), s.max(1), 0)[:, None]) * mask
            p /= np.maximum(p.sum(1, keepdims=True), 1e-30)
            np.testing.assert_allclose(got, p @ inp["v2"], rtol=1e-5,
                                       atol=1e-5)


def check_train(out: dict, model: str):
    """Logits, gradients and two steps' losses of a sharded GNN against
    the JAX package's blocked plan."""
    jcfg, params = _jax_params(model)
    rows, cols, vals, n = _graph()
    plan = jax_ad_plan(jcore.from_coo(rows, cols, vals, (n, n)),
                       impl="blocked")
    x, labels, mask = (jnp.asarray(t) for t in _task(n))
    labels = labels.astype(jnp.int32)
    fwd = jgnn.gcn_forward if model == "gcn" else jgnn.agnn_forward
    logits = np.asarray(fwd(params, plan, x, jcfg))
    top = float(np.abs(logits).max())
    np.testing.assert_allclose(out["logits"].numpy(), logits,
                               rtol=LOGIT_TOL, atol=LOGIT_TOL * top)
    grads = jax.grad(lambda p: jgnn.gnn_loss(p, plan, x, labels, mask,
                                             jcfg)[0])(params)
    want = []
    for name in out["names"]:       # "w.0", "w_in", "beta.1", ...
        key, _, idx = name.partition(".")
        g = grads[key]
        want.append(np.asarray(g[int(idx)] if idx else g))
    top = max(float(np.abs(g).max()) for g in want)
    for name, got, ref in zip(out["names"], out["grads"], want):
        np.testing.assert_allclose(got.numpy(), ref, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * top, err_msg=name)
    step = jax_train_step(jcfg, lr=LR)
    mom = jax.tree.map(jnp.zeros_like, params)
    losses = []
    for _ in range(2):
        params, mom, loss, _ = step(params, mom, plan, x, labels, mask)
        losses.append(float(loss))
    np.testing.assert_allclose(out["losses"].numpy(), losses, rtol=1e-4)

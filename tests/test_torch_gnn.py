"""Model parity: the port's GCN and AGNN, carrying the JAX package's
parameters through ``params_from_jax``, against JAX ``gcn_forward`` /
``agnn_forward`` with the Pallas kernels in interpret mode, over both
adjacency forms; plus the graph generators, the eval loss, the import
boundary of the port and its device default."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.core as jcore
import repro.sparse.graphs as jgraphs
from repro.core.autodiff import ad_plan as jax_ad_plan
from repro.models import gnn as jgnn
from repro_torch.core import ad_plan, block_format, from_coo
from repro_torch.models import gnn
from repro_torch.sparse import graphs
from _torch_threads import one_intraop_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
# fp32 sums re-ordered over several layers.
RTOL, ATOL = 1e-4, 1e-4


def _graph(n=56, deg=5, seed=7):
    rows, cols = jgraphs.erdos_renyi_graph(n, deg, seed=seed)
    loops = np.arange(n)
    rows, cols = np.concatenate([rows, loops]), np.concatenate([cols, loops])
    return rows, cols, jgraphs.gcn_normalized(rows, cols, n), n


@pytest.fixture(scope="module")
def adjacency():
    rows, cols, vals, n = _graph()
    plan = ad_plan(from_coo(rows, cols, vals, (n, n)), impl="cuda",
                   device="cpu")
    jplan = jax_ad_plan(jcore.from_coo(rows, cols, vals, (n, n)),
                        impl="pallas")
    x = np.random.default_rng(0).standard_normal((n, 16)).astype(np.float32)
    return {"plan": (plan, jplan), "blocked": (plan.fwd, jplan.fwd), "x": x}


def _configs(model, impl, jax_impl):
    kw = dict(model=model, in_dim=16, hidden_dim=16 if model == "gcn" else 8,
              num_classes=4, num_layers=3 if model == "gcn" else 2)
    return (gnn.GNNConfig(impl=impl, **kw),
            jgnn.GNNConfig(impl=jax_impl, interpret=True, **kw))


def _jax_params(model, jcfg):
    init = jgnn.init_gcn if model == "gcn" else jgnn.init_agnn
    params = init(jax.random.key(0), jcfg)
    if model == "agnn":   # a learned β away from its init
        params["beta"] = [jnp.asarray(1.7, jnp.float32), jnp.asarray(0.6, jnp.float32)]
    return params


@pytest.mark.parametrize("form", ["plan", "blocked"])
@pytest.mark.parametrize("model", ["gcn", "agnn"])
@pytest.mark.parametrize("impl, jax_impl", [("cuda", "pallas"),
                                            ("blocked", "blocked")])
def test_logits_match_jax(adjacency, model, form, impl, jax_impl):
    cfg, jcfg = _configs(model, impl, jax_impl)
    jparams = _jax_params(model, jcfg)
    module = gnn.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                 device="cpu")
    adj, jadj = adjacency[form]
    x = adjacency["x"]
    jfwd = jgnn.gcn_forward if model == "gcn" else jgnn.agnn_forward
    want = np.asarray(jfwd(jparams, jadj, jnp.asarray(x), jcfg))
    with torch.inference_mode():
        got = module(adj, torch.from_numpy(x)).numpy()
    assert got.shape == (x.shape[0], 4)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("model", ["gcn", "agnn"])
def test_eval_loss_matches_jax(adjacency, model):
    cfg, jcfg = _configs(model, "cuda", "pallas")
    jparams = _jax_params(model, jcfg)
    module = gnn.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                 device="cpu")
    plan, jplan = adjacency["plan"]
    x = adjacency["x"]
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 4, size=x.shape[0])
    mask = (rng.random(x.shape[0]) < 0.7).astype(np.float32)
    jloss, jacc = jgnn.gnn_loss(jparams, jplan, jnp.asarray(x),
                                jnp.asarray(labels), jnp.asarray(mask), jcfg)
    with torch.inference_mode():
        loss, acc = gnn.gnn_loss(module.params(), plan, torch.from_numpy(x),
                                 torch.from_numpy(labels),
                                 torch.from_numpy(mask), cfg)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(acc.item(), float(jacc), rtol=RTOL)


def test_agnn_routes_agree_and_dispatch_the_kernels(adjacency):
    from repro_torch.core import dispatch

    cfg, _ = _configs("agnn", "cuda", "pallas")
    module = gnn.AGNN(cfg, device="cpu", seed=3)
    x = torch.from_numpy(adjacency["x"])
    with torch.inference_mode(), dispatch.record_calls() as log:
        via_plan = module(adjacency["plan"][0], x)
        via_blocked = module(adjacency["blocked"][0], x)
    assert log == ([("attention", "cuda_fused_attn")] * 2
                   + [("sddmm", "cuda"), ("spmm", "cuda")] * 2)
    torch.testing.assert_close(via_plan, via_blocked, rtol=RTOL, atol=ATOL)


def test_gcn_dispatches_one_spmm_per_layer(adjacency):
    from repro_torch.core import dispatch

    cfg, _ = _configs("gcn", "cuda", "pallas")
    module = gnn.GCN(cfg, device="cpu")
    with torch.inference_mode(), dispatch.record_calls() as log:
        module(adjacency["plan"][0], torch.from_numpy(adjacency["x"]))
    assert log == [("spmm", "cuda")] * cfg.num_layers


def test_forward_with_grad_enabled_raises(adjacency):
    """With grad on, a ``cuda`` GCN over the bare blocked format still
    raises (its kernels have no backward there); over the ADPlan it
    backpropagates to every weight."""
    cfg, _ = _configs("gcn", "cuda", "pallas")
    module = gnn.GCN(cfg, device="cpu")
    x = torch.from_numpy(adjacency["x"])
    with pytest.raises(RuntimeError, match="forward-only"):
        module(adjacency["blocked"][0], x)
    module(adjacency["plan"][0], x).square().sum().backward()
    for w in module.w:
        assert w.grad is not None and bool(torch.isfinite(w.grad).all())
        assert bool(w.grad.abs().sum() > 0)


def test_params_from_jax_checks_shapes():
    cfg = gnn.GNNConfig(model="gcn", in_dim=4, hidden_dim=4, num_classes=2,
                        num_layers=2)
    with pytest.raises(ValueError, match="shape"):
        gnn.params_from_jax(cfg, {"w": [np.zeros((4, 4)), np.zeros((4, 3))]},
                            device="cpu")
    with pytest.raises(ValueError, match="weights"):
        gnn.params_from_jax(cfg, {"w": [np.zeros((4, 4))]}, device="cpu")


@pytest.mark.parametrize("name", ["GitHub", "Ell", "Amazon", "Yeast"])
def test_make_dataset_gives_the_same_arrays(name):
    port = graphs.make_dataset(name, 0.001, seed=2)
    ref = jgraphs.make_dataset(name, 0.001, seed=2)
    assert port.num_nodes == ref.num_nodes
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
    np.testing.assert_array_equal(port.dense(), ref.dense())


def test_hub_row_graph_gives_the_same_arrays():
    for a, b in zip(graphs.hub_row_graph(200, 4.0, seed=5),
                    jgraphs.hub_row_graph(200, 4.0, seed=5)):
        np.testing.assert_array_equal(a, b)
    assert graphs.DATASET_PRESETS == jgraphs.DATASET_PRESETS


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


@pytest.mark.parametrize("entry", ["block_format", "ad_plan", "GCN", "AGNN",
                                   "params_from_jax"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fmt = from_coo(np.array([0]), np.array([1]), np.ones(1), (8, 8))
    cfg = gnn.GNNConfig(in_dim=4, hidden_dim=4, num_classes=2, num_layers=1)
    calls = {
        "block_format": lambda: block_format(fmt),
        "ad_plan": lambda: ad_plan(fmt),
        "GCN": lambda: gnn.GCN(cfg),
        "AGNN": lambda: gnn.AGNN(dataclasses.replace(cfg, model="agnn")),
        "params_from_jax": lambda: gnn.params_from_jax(cfg, {"w": [np.zeros((4, 2))]}),
    }
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[entry]()

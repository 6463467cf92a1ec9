"""The autotuner and the tuned route against the JAX package.

  * ``window_skew`` and the structure class equal the reference's on every
    vendored matrix and its transpose;
  * the bucket fields of the stats key equal the reference's (op, dtype,
    batch), the key's tail names the device and what was timed;
  * the cache's hardening cases (schema first, salvage of torn files,
    other schemas discarded, malformed entries, unwritable paths, the
    sweep's keep-alive) and the failure counter;
  * a ``cuda_tuned`` plan on ``tests/data/hub_128`` whose directions differ
    (A on the window kernels at k_blk 16, Aᵀ on the balanced ones at k_blk
    8, each with its own column tile) against JAX's ``pallas_tuned`` plan:
    layouts, ``perm`` and schedules equal, a GCN step's loss and
    gradients within 1e-4 (interpret mode).  Both caches are seeded with
    the same winners, so neither package sweeps;
  * the port's sweep on the CPU (plain versions, host clock), its cache
    hits, the tuned entry points and the trainer's ``--impl cuda_tuned``.
"""

import functools
import itertools
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.core as jcore
from repro.core.autodiff import _blocked_perm as jax_blocked_perm
from repro.core.autodiff import ad_plan as jax_ad_plan
from repro.core.format import window_skew as jax_window_skew
from repro.data.datasets import load_vendored, vendored_names
from repro.kernels import autotune as jtune
from repro.models import gnn as jgnn
from repro.sparse.structure import classify_format as jax_classify_format
from repro_torch.launch.mesh import one_rank_mesh
from repro_torch.core import (BlockedMEBCRS, ad_plan, attention,
                              block_format, dispatch, from_coo, sddmm, spmm)
from repro_torch.core.autodiff import _blocked_perm
from repro_torch.core.format import window_skew
from repro_torch.kernels import autotune
from repro_torch.kernels.autotune import (SCHEMA_VERSION, AutotuneCache,
                                          TuneConfig, _salvage_configs,
                                          _sweep)
from repro_torch.models import gnn
from repro_torch.sparse.structure import classify_format
from repro_torch.train import gnn_train
from _torch_threads import one_intraop_thread  # noqa: F401

VENDORED = vendored_names()
BLOCKED = ("vals", "cols", "mask", "block_win", "win_ptr")
SCHEDULE = ("seg_win", "seg_meta", "blk_id", "blk_win")
CPU = torch.device("cpu")
# The seeded winners of the tuned plan, (k_blk, n_blk, split_blk): A on
# the window kernels, Aᵀ on the balanced ones, tiles apart.
N_EX, FWD, BWD = 16, (16, 64, 0), (8, 32, 1)
# fp32 gradients of sums taken in another order
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


@functools.lru_cache(maxsize=None)
def _hub():
    s = load_vendored(["hub_128"])[0]
    return (from_coo(s.rows, s.cols, s.vals, s.shape),
            jcore.from_coo(s.rows, s.cols, s.vals, s.shape))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same(port, ref, fields):
    for f in fields:
        np.testing.assert_array_equal(_np(getattr(port, f)),
                                      np.asarray(getattr(ref, f)), err_msg=f)


# ------------------------------------------------ statistics and the key ----


# One test each over the 14 vendored matrices and over the key's 12
# cases, not one per case: a file with fewer tests is queued after the
# suite's longest file by ``pytest -n --dist loadfile``, so it stays off
# the critical path.
def test_window_skew_and_structure_class_equal_jax():
    for name in VENDORED:
        s = load_vendored([name])[0]
        port = from_coo(s.rows, s.cols, s.vals, s.shape)
        ref = jcore.from_coo(s.rows, s.cols, s.vals, s.shape)
        for p, r in ((port, ref), (port.transpose(), ref.transpose())):
            assert window_skew(p) == jax_window_skew(r), name
            assert window_skew(block_format(p, 8, device="cpu")) == \
                jax_window_skew(jcore.block_format(r, 8)), name
            assert classify_format(p) == jax_classify_format(r), name
            assert p._structure_class == classify_format(p)   # memoized


def test_stats_key_bucket_fields_equal_jax():
    port, ref = _hub()
    for op, dtype, batch in itertools.product(
            ("spmm", "sddmm", "attn"), ("float32", "bfloat16"), (1, 12)):
        case = (op, dtype, batch)
        mine = autotune.matrix_stats_key(port, 48, op, device="cpu",
                                         dtype=getattr(torch, dtype),
                                         batch=batch).split("|")
        theirs = jtune.matrix_stats_key(ref, 48, op, interpret=True,
                                        dtype=getattr(jnp, dtype),
                                        batch=batch).split("|")
        assert mine[:9] == theirs[:9], case
        assert mine[9:] == ["cpu", "plain"], case
        on_card = autotune.matrix_stats_key(port, 48, op, device="cuda",
                                            dtype=getattr(torch, dtype),
                                            batch=batch).split("|")
        assert on_card[:9] == mine[:9], case
        assert on_card[9:] == ["cuda", "kernel"], case


# ------------------------------------------------------------ the cache ----


def _fill(path, n=3):
    c = AutotuneCache(str(path))
    for i in range(n):
        c.put(f"key{i}|spmm|k8|nb128|s0|pfp32|o0",
              TuneConfig(8, 64 << i, float(i + 1)))
    return c


def test_schema_is_written_first(tmp_path):
    p = tmp_path / "cache.json"
    _fill(p)
    text = p.read_text()
    assert text.index('"schema"') < text.index('"configs"')
    assert json.loads(text)["schema"] == SCHEMA_VERSION


def test_torn_file_salvages_parseable_entries(tmp_path):
    p = tmp_path / "cache.json"
    _fill(p, n=3)
    text = p.read_text()
    p.write_text(text[: int(len(text) * 0.6)])
    salvaged = AutotuneCache(str(p))._load()
    assert 1 <= len(salvaged) < 3
    for entry in salvaged.values():
        TuneConfig.from_json(entry)


@pytest.mark.parametrize("torn", [False, True], ids=["whole", "torn"])
def test_other_schema_is_discarded_wholesale(tmp_path, torn):
    p = tmp_path / "cache.json"
    if torn:
        _fill(p, n=2)
        text = p.read_text().replace(f'"schema": {SCHEMA_VERSION}',
                                     '"schema": 3')[:-10]
        assert _salvage_configs(text) == {}
    else:
        text = json.dumps({"schema": 2, "configs": {
            "k": TuneConfig(8, 128, 1.0).to_json()}})
    p.write_text(text)
    c = AutotuneCache(str(p))
    assert c._load() == {} and c.get("k") is None


def test_malformed_entry_dropped_not_fatal(tmp_path):
    p = tmp_path / "cache.json"
    p.write_text(json.dumps({"schema": SCHEMA_VERSION, "configs": {
        "good": TuneConfig(8, 128, 1.0).to_json(),
        "bad": {"nothing": "useful"}}}))
    c = AutotuneCache(str(p))
    assert c.get("good").n_blk == 128
    assert c.get("bad") is None


def test_unwritable_path_keeps_memory_cache(tmp_path):
    ro = tmp_path / "ro"
    ro.mkdir()
    os.chmod(ro, 0o500)
    try:
        c = AutotuneCache(str(ro / "sub" / "cache.json"))
        c.put("k", TuneConfig(8, 128, 1.0))
        assert c.get("k").k_blk == 8
    finally:
        os.chmod(ro, 0o700)


def test_cache_heals_on_next_put(tmp_path):
    p = tmp_path / "cache.json"
    _fill(p, n=2)
    p.write_text(p.read_text()[:-30])
    c = AutotuneCache(str(p))
    c.put("fresh", TuneConfig(16, 256, 0.5))
    assert "fresh" in AutotuneCache(str(p))._load()
    assert json.loads(p.read_text())["schema"] == SCHEMA_VERSION


def _tiny_fmt():
    rng = np.random.default_rng(0)
    a = ((rng.random((32, 32)) < 0.3)
         * rng.standard_normal((32, 32))).astype(np.float32)
    from repro_torch.core import from_dense
    return from_dense(a)


def test_sweep_survives_a_failing_candidate_and_counts_it(tmp_path):
    autotune.reset_counters()
    attempts = []

    def run_cfg(blocked, n_blk, split, prec, ob):
        attempts.append(n_blk)
        if n_blk == 64:
            raise RuntimeError("simulated launch failure")
        return lambda: torch.zeros(())

    cfg = _sweep(_tiny_fmt(), run_cfg, lambda n_blk: n_blk, "keepalive",
                 device=CPU, k_blks=(8,), n_blks=(64, 128), split_blks=(0,),
                 precisions=("fp32",), reps=1,
                 cache=AutotuneCache(str(tmp_path / "c.json")))
    assert cfg.n_blk == 128 and attempts == [64, 128]
    # the failure is counted, not hidden behind the winner
    assert autotune.failed_candidates == 1
    assert "simulated launch failure" in autotune.last_error
    assert [c.n_blk for _, c in autotune.timed] == [128]


def test_sweep_with_every_candidate_failing_raises(tmp_path):
    autotune.reset_counters()

    def boom(*_a):
        raise RuntimeError("no candidate can launch")

    with pytest.raises(RuntimeError, match="all .* candidates failed"):
        _sweep(_tiny_fmt(), boom, lambda n_blk: n_blk, "allfail", device=CPU,
               k_blks=(8, 16), n_blks=(64,), split_blks=(0,),
               precisions=("fp32",), reps=1,
               cache=AutotuneCache(str(tmp_path / "c.json")))
    assert autotune.failed_candidates == 2 and not autotune.timed


# ------------------------------------------- the tuned plan against JAX ----


def _seed(port_cache, jax_cache, port, ref):
    """The same winners in both caches, under each package's own keys."""
    grid = "|k8,16,32|nb64,128,256|s0,1|pfp32|o0"
    for (p, r), (k_blk, n_blk, split) in (((port, ref), FWD),
                                          ((port.transpose(),
                                            ref.transpose()), BWD)):
        mine = autotune.matrix_stats_key(p, N_EX, "spmm", device="cpu",
                                         dtype=torch.float32)
        theirs = jtune.matrix_stats_key(r, N_EX, "spmm", interpret=True,
                                        dtype=jnp.float32)
        assert autotune.sweep_key(mine) == mine + grid
        port_cache.put(mine + grid, TuneConfig(k_blk, n_blk, 1.0,
                                               split_blk=split))
        jax_cache.put(theirs + grid, jtune.TuneConfig(k_blk, n_blk, 1.0,
                                                      split_blk=split))
    sgrid = f"|k{FWD[0]}|nb64,128,256|s0|pfp32|o0"
    port_cache.put(autotune.matrix_stats_key(port, N_EX, "sddmm",
                                             device="cpu",
                                             dtype=torch.float32) + sgrid,
                   TuneConfig(FWD[0], N_EX, 1.0))
    jax_cache.put(jtune.matrix_stats_key(ref, N_EX, "sddmm", interpret=True,
                                         dtype=jnp.float32) + sgrid,
                  jtune.TuneConfig(FWD[0], N_EX, 1.0))


@pytest.fixture(scope="module")
def tuned_plans(tmp_path_factory):
    """The port's cuda_tuned and JAX's pallas_tuned plan of hub_128 from
    seeded caches.  A sweep in either package fails the fixture: the
    timers raise."""
    d = tmp_path_factory.mktemp("tuned")
    s = load_vendored(["hub_128"])[0]
    port = from_coo(s.rows, s.cols, s.vals, s.shape)
    ref = jcore.from_coo(s.rows, s.cols, s.vals, s.shape)
    cache, jcache = (AutotuneCache(str(d / "port.json")),
                     jtune.AutotuneCache(str(d / "jax.json")))
    _seed(cache, jcache, port, ref)

    def no_timing(*_a, **_k):
        raise AssertionError("a sweep ran: the seeded key was missed")

    mp = pytest.MonkeyPatch()
    mp.setattr(jtune, "_median_ms", no_timing)
    mp.setattr(autotune, "_median_ms", no_timing)
    try:
        autotune.reset_counters()
        plan = ad_plan(port, impl="cuda_tuned", n_example=N_EX, cache=cache,
                       device="cpu")
        jplan = jax_ad_plan(ref, impl="pallas_tuned", n_example=N_EX,
                            cache=jcache)
        assert autotune.failed_candidates == 0 and not autotune.timed
    finally:
        mp.undo()
    return plan, jplan, cache


def test_tuned_plan_layouts_perm_and_schedules_equal_jax(tuned_plans):
    plan, jplan, cache = tuned_plans
    assert (plan.fwd.k_blk, plan.bwd.k_blk) == (FWD[0], BWD[0])
    assert (plan.n_blk, plan.n_blk_t) == (jplan.n_blk, jplan.n_blk_t) == (
        FWD[1], BWD[1])
    _same(plan.fwd, jplan.fwd, BLOCKED)
    _same(plan.bwd, jplan.bwd, BLOCKED)
    np.testing.assert_array_equal(plan.perm.numpy(), np.asarray(jplan.perm))
    assert plan.fwd_sched is None and jplan.fwd_sched is None
    _same(plan.bwd_sched, jplan.bwd_sched, SCHEDULE)
    # a fresh format finds the winners in the file; its plan is memoized
    s = load_vendored(["hub_128"])[0]
    fresh = from_coo(s.rows, s.cols, s.vals, s.shape)
    again = ad_plan(fresh, impl="cuda_tuned", n_example=N_EX,
                    cache=AutotuneCache(cache.path), device="cpu")
    assert again is ad_plan(fresh, impl="cuda_tuned", n_example=N_EX,
                            cache=AutotuneCache(cache.path), device="cpu")
    assert (again.fwd.k_blk, again.bwd.k_blk) == (FWD[0], BWD[0])


@pytest.mark.parametrize("kf, kt", [(16, 8), (32, 8), (8, 32)])
def test_blocked_perm_across_k_blks_equals_jax(kf, kt):
    port, ref = _hub()
    a, t = (block_format(port, kf, device="cpu"),
            block_format(port.transpose(), kt, device="cpu"))
    perm = _blocked_perm(a, t)
    np.testing.assert_array_equal(perm, np.asarray(jax_blocked_perm(
        jcore.block_format(ref, kf), jcore.block_format(ref.transpose(), kt))))
    # the gather re-lays A's values into the transpose's layout
    relaid = a.vals.reshape(-1)[torch.from_numpy(perm).long()] * t.mask
    assert torch.equal(relaid, t.vals)


def test_tuned_gcn_step_matches_jax_pallas_tuned(tuned_plans):
    plan, jplan, _ = tuned_plans
    n = plan.shape[0]
    kw = dict(model="gcn", in_dim=N_EX, hidden_dim=N_EX, num_classes=4,
              num_layers=3)
    jcfg = jgnn.GNNConfig(impl="pallas_tuned", interpret=True, **kw)
    params = jgnn.init_gcn(jax.random.key(0), jcfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n, N_EX)).astype(np.float32)
    labels = rng.integers(0, 4, size=n)
    mask = (rng.random(n) < 0.7).astype(np.float32)
    loss_fn = lambda p: jgnn.gnn_loss(p, jplan, jnp.asarray(x),  # noqa: E731
                                      jnp.asarray(labels.astype(np.int32)),
                                      jnp.asarray(mask), jcfg)[0]
    want_loss, want = jax.value_and_grad(loss_fn)(params)
    cfg = gnn.GNNConfig(impl="cuda_tuned", **kw)
    net = gnn.params_from_jax(cfg, jax.tree.map(np.asarray, params),
                              device="cpu")
    with dispatch.record_calls() as log:
        loss, _ = gnn.gnn_loss(net.params(), plan, torch.from_numpy(x),
                               torch.from_numpy(labels),
                               torch.from_numpy(mask), cfg)
        loss.backward()
    # forward SpMMs on the window kernel, dB on the balanced one
    assert log == [("spmm", "cuda")] * 3 + [("spmm", "cuda_balanced")] * 2
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=GRAD_RTOL)
    for p, w in zip(net.w, want["w"]):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


# ------------------------------------------------ the port's own sweep ----


def test_cpu_sweep_times_plain_versions_and_hits_its_cache(tmp_path):
    fmt, _ = _hub()
    cache = AutotuneCache(str(tmp_path / "c.json"))
    autotune.reset_counters()
    b = torch.zeros((fmt.shape[1], 100))
    cfg = autotune.tune_spmm(fmt, b, cache=cache, reps=1)
    # 3 k_blks x 2 routes x the tiles 64 and 128 (256 clamps to N's 128)
    assert len(autotune.timed) == 12 and autotune.failed_candidates == 0
    assert all(key.split("|")[9:11] == ["cpu", "plain"]
               and "|pfp32|o0" in key for key, _ in autotune.timed)
    assert cfg in [c for _, c in autotune.timed]
    assert autotune.tune_spmm(fmt, b, cache=AutotuneCache(cache.path)) == cfg
    assert len(autotune.timed) == 12                       # a cache hit
    cfg8 = autotune.tune_spmm(fmt, b, cache=cache, reps=1,
                              precisions=("bf16", "int8"), k_blks=(8,),
                              split_blks=(0,))
    assert cfg8.precision in ("bf16", "int8") and len(autotune.timed) == 16
    # the SDDMM streams all of F: its f_blk candidates collapse to one
    q = torch.zeros((fmt.shape[0], 24))
    cfg_s = autotune.tune_sddmm(fmt, q, q, cache=cache, reps=1)
    assert cfg_s.n_blk == 24 and len(autotune.timed) == 19
    cfg_a = autotune.tune_attention(fmt, q, q, torch.zeros(
        (fmt.shape[0], 40)), cache=cache, reps=1)
    assert cfg_a.n_blk == 40 and len(autotune.timed) == 25
    # the overlap axis times the sharded pipeline over a mesh, whose data
    # size joins the key
    with pytest.raises(ValueError, match="need a mesh"):
        autotune.tune_spmm(fmt, b, cache=cache, overlap_batches=(0, 2))
    with one_rank_mesh("cpu") as mesh:
        cfg_o = autotune.tune_spmm(fmt, b, cache=cache, reps=1, k_blks=(8,),
                                   split_blks=(1,), n_blks=(128,),
                                   overlap_batches=(0, 2), mesh=mesh)
    assert len(autotune.timed) == 27 and autotune.failed_candidates == 0
    assert cfg_o.overlap_batches in (0, 2)
    assert all("|d1|" in key and key.endswith("|o0,2")
               for key, _ in autotune.timed[25:])


def test_tuned_entry_points_run_their_winners(tmp_path, monkeypatch):
    monkeypatch.setattr(autotune, "_DEFAULT_CACHE",
                        AutotuneCache(str(tmp_path / "c.json")))
    fmt, _ = _hub()
    rng = np.random.default_rng(8)
    b, q, v = (torch.from_numpy(rng.standard_normal(
        (fmt.shape[0], w)).astype(np.float32)) for w in (20, 12, 9))
    for op, impl in (("spmm", "cuda_tuned"), ("sddmm", "cuda_tuned"),
                     ("attention", "cuda_fused_attn_tuned")):
        entry = dispatch.get(op, impl)
        assert entry.needs_canonical
        assert entry.returns_format == (op == "sddmm")
        with pytest.raises(ValueError, match="needs the canonical MEBCRS"):
            dispatch.dispatch(op, impl, block_format(fmt, 8, device="cpu"),
                              *(b,) * {"spmm": 1, "sddmm": 2,
                                       "attention": 3}[op])
    torch.testing.assert_close(spmm(fmt, b, impl="cuda_tuned"),
                               spmm(fmt, b, impl="blocked"), rtol=1e-5,
                               atol=1e-5)
    narrow = spmm(fmt, b, impl="cuda_tuned", precision="bf16")
    assert narrow.dtype == torch.bfloat16
    torch.testing.assert_close(narrow.float(), spmm(
        fmt, b, impl="blocked", precision="bf16").float(), rtol=2 ** -7,
        atol=1e-3)
    scores = sddmm(fmt, q, q, impl="cuda_tuned")
    assert isinstance(scores, BlockedMEBCRS)
    torch.testing.assert_close(scores.vals, sddmm(scores, q, q), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(
        attention(fmt, q, q, v, impl="cuda_fused_attn_tuned", scale=0.5),
        attention(fmt, q, q, v, impl="blocked", scale=0.5), rtol=1e-5,
        atol=1e-5)


def test_tuned_plan_pins_its_precision_and_checks_every_route(tmp_path):
    fmt, _ = _hub()
    cache = AutotuneCache(str(tmp_path / "c.json"))
    autotune.reset_counters()
    plan = ad_plan(fmt, impl="cuda_tuned", n_example=8, cache=cache,
                   device="cpu", precision="int8")
    assert plan.precision == "int8"
    keys = {key.split("|")[0] + "|" + key.split("|p")[-1]
            for key, _ in autotune.timed}
    # the SpMMs swept at int8, the SDDMM at its dense level, bf16
    assert keys == {"spmm|int8|o0", "sddmm|bf16|o0"}
    assert ad_plan(fmt, impl="cuda_tuned", n_example=8, cache=cache,
                   device="cpu", precision="int8") is plan
    with pytest.raises(NotImplementedError, match="builds plans for"):
        ad_plan(fmt, impl="pallas_sharded", device="cpu")


def test_gnn_train_smoke_cli_tuned(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(autotune, "_DEFAULT_CACHE",
                        AutotuneCache(str(tmp_path / "c.json")))
    gnn_train.main(["--steps", "2", "--impl", "cuda_tuned", "--device",
                    "cpu"])
    assert "OK: finite decreasing loss" in capsys.readouterr().out

"""The multi-device layer's host half and plumbing, in one process.

* The partition against the JAX package's, in process (its partitioner is
  host numpy): every ``ShardedSchedule`` array equal, on the 14 vendored
  matrices, ``hub_row_graph`` and the all-empty matrix, at D in {1, 2, 4,
  8}, ``window_split`` on and off, ``n_batches`` in {1, 2, 3}; the cost
  model (``segment_costs``, ``device_balance``, ``batch_costs``) to 1e-12.
* Rank-local schedules: the pads stripped, and the three balanced
  wrappers' partials over them summing to the single-device result.
* The registry's flags, ``ad_plan``'s refusals, the mesh/device check and
  ``validate_sharded``'s four invariants.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.core as jcore
import repro.distributed.sparse_shard as jshard
from repro.core import dispatch as jdispatch
from repro.data.datasets import load_vendored
from repro.sparse.graphs import hub_row_graph
from repro_torch.core import (ValidationError, ad_plan, attention, dispatch,
                              from_dense, sddmm, spmm)
from repro_torch.core.format import block_format
from repro_torch.core.validate import validate, validate_sharded
from repro_torch.distributed import (activation_mesh, attention_sharded_local,
                                     batch_costs, device_balance,
                                     partition_schedule, sddmm_sharded_local,
                                     segment_costs, sharded_schedule,
                                     spmm_sharded, spmm_sharded_local)
from repro_torch.kernels import spmm_balanced_cuda
from repro_torch.launch.mesh import make_mesh, mesh_from_arg, one_rank_mesh
from _torch_threads import one_intraop_thread  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    "error::repro_torch.core.dispatch.FallbackWarning")

FIELDS = ("seg_win", "seg_meta", "blk_id", "blk_win", "row_own", "blk_own",
          "bseg_win", "bseg_meta", "brow_idx", "bblk_id", "bblk_win",
          "bval_idx")
AUX = ("num_devices", "num_windows", "split_blk", "window_split",
       "num_blocks", "n_batches")


def _hub_row_dense(n=200, seed=3):
    rows, cols = hub_row_graph(n, 6.0, seed=seed)
    a = np.zeros((n, n), np.float32)
    a[rows, cols] = 1.0 + (rows % 7)
    return a


MATRICES = {s.name: s.dense for s in load_vendored()}
MATRICES["hub_row_graph"] = _hub_row_dense
MATRICES["all_empty"] = lambda: np.zeros((20, 17), np.float32)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_partition_matches_jax(name):
    a = MATRICES[name]()
    tb = block_format(from_dense(a), 8, device="cpu")
    jb = jcore.block_format(jcore.from_dense(a), 8)
    sched, jsched = tb.schedule(1), jb.schedule(1)
    np.testing.assert_allclose(segment_costs(tb, sched),
                               jshard.segment_costs(jb, jsched), rtol=1e-12)
    for d in (1, 2, 4, 8):
        for ws in (True, False):
            bal = device_balance(tb, d, window_split=ws)
            jbal = jshard.device_balance(jb, d, window_split=ws)
            np.testing.assert_allclose(bal["costs"], jbal["costs"],
                                       rtol=1e-12)
            assert bal["max_over_mean"] == pytest.approx(
                jbal["max_over_mean"], rel=1e-12)
            for nb in (1, 2, 3):
                part = partition_schedule(tb, None, d, window_split=ws,
                                          n_batches=nb)
                want = jshard.partition_schedule(jb, None, d,
                                                 window_split=ws,
                                                 n_batches=nb)
                for f in FIELDS:
                    np.testing.assert_array_equal(
                        getattr(part, f).numpy(), np.asarray(getattr(want, f)),
                        err_msg=f"{name} D={d} ws={ws} nb={nb} {f}")
                assert ([getattr(part, f) for f in AUX]
                        == [getattr(want, f) for f in AUX])
                bc = batch_costs(tb, d, nb, window_split=ws)
                jbc = jshard.batch_costs(jb, d, nb, window_split=ws)
                np.testing.assert_allclose(bc["costs"], jbc["costs"],
                                           rtol=1e-12)
                np.testing.assert_array_equal(bc["rows"], jbc["rows"])


def test_local_schedules_strip_the_pads_and_sum_to_the_whole():
    a = _hub_row_dense()
    tb = block_format(from_dense(a), 8, device="cpu")
    rng = np.random.default_rng(4)
    b, q, k, v = (torch.from_numpy(rng.standard_normal((200, w)).astype(
        np.float32)) for w in (24, 16, 16, 12))
    want_c, want_s = spmm(tb, b), sddmm(tb, q, k)
    want_a = attention(tb, q, k, v)
    for d in (2, 4):
        part = sharded_schedule(tb, d)
        wa = sharded_schedule(tb, d, window_split=False)
        for r in range(d):
            loc = part.local(r)
            n = int((part.seg_win[r] < part.num_windows).sum())
            assert loc.num_segments == n and loc.local.view_blocks == \
                tb.schedule(1).num_blocks
            assert loc.seg_win.equal(part.seg_win[r, :n])
            assert loc.seg_meta.equal(part.seg_meta[r, :n])
            assert int(part.row_own[r].sum()) == min(
                loc.local.win_hi * 8, a.shape[0]) - loc.local.win_lo * 8
            assert part.local(r) is loc                     # memoized
        torch.testing.assert_close(
            sum(spmm_sharded_local(tb, b, part, r) for r in range(d)),
            want_c, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(
            sum(sddmm_sharded_local(tb, q, k, part, r) for r in range(d)),
            want_s, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(
            sum(attention_sharded_local(tb, q, k, v, wa, r)
                for r in range(d)), want_a, rtol=1e-5, atol=1e-5)
        with pytest.raises(ValueError, match="window-aligned"):
            attention_sharded_local(tb, q, k, v, part, 0)
        # a batch of a rank is a rank-local schedule of its own
        part3 = sharded_schedule(tb, d, n_batches=3)
        torch.testing.assert_close(
            sum(spmm_balanced_cuda(tb, b, schedule=part3.local_batch(r, t))
                for r in range(d) for t in range(3)),
            want_c, rtol=1e-5, atol=1e-5)


def test_local_schedule_refuses_a_foreign_view():
    a = _hub_row_dense()
    tb = block_format(from_dense(a), 8, device="cpu")
    other = block_format(from_dense(a[:, :100]), 8, device="cpu")
    loc = sharded_schedule(tb, 2).local(1)
    b = torch.ones(100, 4)
    with pytest.raises(ValueError, match="not this view's"):
        spmm_balanced_cuda(other, b, schedule=loc)


def test_sharded_schedule_memo_and_its_checks():
    tb = block_format(from_dense(_hub_row_dense()), 8, device="cpu")
    part = sharded_schedule(tb, 4)
    assert sharded_schedule(tb, 4) is part
    assert sharded_schedule(tb, 4, n_batches=2) is not part
    explicit = sharded_schedule(tb, 4, schedule=tb.schedule(1))
    assert explicit is not part and explicit.seg_win.equal(part.seg_win)
    with pytest.raises(ValueError, match="num_devices must be >= 1"):
        partition_schedule(tb, None, 0)
    with pytest.raises(ValueError, match="n_batches must be >= 1"):
        partition_schedule(tb, None, 2, n_batches=0)
    # check="full" runs validate_sharded on the result
    assert partition_schedule(tb, None, 2, check="full").num_devices == 2


def test_validate_sharded_names_each_invariant():
    tb = block_format(from_dense(_hub_row_dense()), 8, device="cpu")
    part = partition_schedule(tb, None, 4)
    assert validate(part, blocked=tb) is part
    assert validate_sharded(part, check="cheap") is part

    def broken(**fields):
        return dataclasses.replace(part, **fields)

    row_own = part.row_own.clone()
    row_own[1] = row_own[0]
    # window 1 dropped from every rank, its rows from every row_own
    no_win = part.seg_win.clone()
    no_win[no_win == 1] = part.num_windows
    nobody = part.row_own.clone()
    nobody[:, 8:16] = False
    twice = part.blk_own.clone()
    twice[:, :8] = True
    for bad, invariant in (
            (broken(seg_win=part.seg_win[:3]), "shard-shape"),
            (broken(row_own=row_own), "row-own-consistent"),
            (broken(seg_win=no_win, row_own=nobody), "row-own-cover"),
            (broken(blk_own=twice), "blk-own-unique")):
        with pytest.raises(ValidationError) as err:
            validate_sharded(bad, blocked=tb)
        assert err.value.invariant == invariant


def test_registry_flags_match_the_reference():
    for op in ("spmm", "sddmm", "attention"):
        for name, ref in (("cuda_sharded", "pallas_sharded"),
                          ("cuda_sharded_overlap", "pallas_sharded_overlap")):
            mine, theirs = dispatch.get(op, name), jdispatch.get(op, ref)
            for flag in ("differentiable", "batched", "load_balanced",
                         "multi_device", "overlapped", "needs_canonical",
                         "returns_format", "precisions"):
                assert getattr(mine, flag) == getattr(theirs, flag), \
                    (op, name, flag)
    # the ladder drops the mesh knobs on the rungs without the flags
    kw = {"mesh": 1, "part": 2, "n_batches": 2, "schedule": 3, "k_blk": 8}
    assert dispatch._adapt_kwargs(dispatch.get("spmm", "cuda_sharded"),
                                  kw) == {"mesh": 1, "part": 2,
                                          "schedule": 3, "k_blk": 8}
    assert dispatch._adapt_kwargs(dispatch.get("spmm", "cuda_balanced"),
                                  kw) == {"schedule": 3, "k_blk": 8}
    assert dispatch.fallback_chain("spmm", "cuda_sharded_overlap")[:2] == (
        "cuda_sharded", "cuda_tuned")


def test_ad_plan_refusals_and_the_ambient_mesh():
    fmt = from_dense(np.eye(16, dtype=np.float32))
    with pytest.raises(ValueError, match="sharded sparse ops need a mesh"):
        ad_plan(fmt, impl="cuda_sharded", device="cpu")
    with one_rank_mesh("cpu") as mesh:
        with pytest.raises(ValueError, match="only meaningful for a "
                           "multi-device impl like 'cuda_sharded'"):
            ad_plan(fmt, impl="cuda_balanced", device="cpu", mesh=mesh)
        with pytest.raises(ValueError, match="needs an overlapped impl"):
            ad_plan(fmt, impl="cuda_sharded", device="cpu", mesh=mesh,
                    overlap_batches=2)
        with activation_mesh(mesh):
            plan = ad_plan(fmt, impl="cuda_sharded_overlap", device="cpu")
        assert plan.mesh is mesh and plan.overlap_batches == 2
        assert plan.fwd_part.n_batches == 2 and not plan.fwd_part_wa.\
            window_split
        assert ad_plan(fmt, impl="cuda_sharded_overlap", device="cpu",
                       mesh=mesh) is plan
        bulk = ad_plan(fmt, impl="cuda_sharded", device="cpu", mesh=mesh)
        assert bulk.overlap_batches == 1 and bulk.bwd_part.num_devices == 1
        assert make_mesh(1, 1, device="cpu").mesh_dim_names == ("data",
                                                                "model")
        with pytest.raises(RuntimeError, match="needs 4 ranks"):
            make_mesh(2, 2, device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="DATA,MODEL"):
        mesh_from_arg("4")


def test_operands_off_the_mesh_device_raise():
    class CardMesh:          # what a mesh on the card tells the ops
        device_type = "cuda"
        mesh_dim_names = ("data", "model")

    fmt = from_dense(np.eye(16, dtype=np.float32))
    with pytest.raises(ValueError, match="the mesh is on 'cuda' but the "
                       "operands are on \\['cpu'\\]"):
        spmm_sharded(fmt, torch.ones(16, 4), mesh=CardMesh())
    with pytest.raises(ValueError, match="the mesh is on 'cuda', the plan "
                       "on 'cpu'"):
        ad_plan(fmt, impl="cuda_sharded", device="cpu", mesh=CardMesh())

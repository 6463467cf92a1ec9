"""Schedule parity: the port's ``build_schedule`` against the JAX
package's, array for array, on vendored matrices and the all-empty
matrix; the schedule checks that guard the balanced kernels; and the run
plans (runs, pieces, edge entries and their combine tree) that the
balanced SpMM and attention kernels walk."""

import dataclasses

import numpy as np
import pytest

import repro.core as jcore
from repro.core.autodiff import ad_plan as jax_ad_plan
from repro.data.datasets import load_vendored
from repro_torch.core import ad_plan
from repro_torch.core import format as tf
from repro_torch.core.validate import ValidationError, validate_schedule
from repro_torch.kernels._combine import COMBINE_FANIN, run_plan
from _torch_threads import one_intraop_thread  # noqa: F401

SCHEDULE = ("seg_win", "seg_meta", "blk_id", "blk_win")
# a power-law hub matrix, a banded one, a rectangular one
MATRICES = ["hub_128", "skewband_64", "rect_120x40"]
LONG = "long_window"  # one window longer than any run length below


def _coo(name):
    """``(rows, cols, vals, shape)`` of a vendored matrix, or of LONG: a
    dense first window of 150 vectors (38 K-blocks at k_blk = 4) beside
    short windows and an empty one."""
    if name != LONG:
        s = load_vendored([name])[0]
        return s.rows, s.cols, s.vals, s.shape
    rng = np.random.default_rng(3)
    a = ((rng.random((48, 160)) < 0.1) * rng.standard_normal((48, 160))
         ).astype(np.float32)
    a[:8, :150] = 1.0
    a[16:24] = 0.0
    rows, cols = np.nonzero(a)
    return rows, cols, a[rows, cols], a.shape


def _views(rows, cols, vals, shape, k_blk):
    port = tf.block_format(tf.from_coo(rows, cols, vals, shape), k_blk,
                           device="cpu")
    ref = jcore.block_format(jcore.from_coo(rows, cols, vals, shape), k_blk)
    return port, ref


def _same_schedule(port, ref):
    for f in SCHEDULE:
        got, want = getattr(port, f).numpy(), np.asarray(getattr(ref, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert (port.split_blk, port.num_blocks) == (ref.split_blk, ref.num_blocks)


@pytest.mark.parametrize("split_blk", [0, 1, 3])
@pytest.mark.parametrize("name", MATRICES)
def test_schedule_arrays_equal_jax(name, split_blk):
    s = load_vendored([name])[0]
    port, ref = _views(s.rows, s.cols, s.vals, s.shape, k_blk=4)
    sched = port.schedule(split_blk)
    _same_schedule(sched, ref.schedule(split_blk))
    assert port.schedule(split_blk) is sched                 # memoized
    _check_run_plan(sched, port.num_windows, run_blk=2)
    # the balanced plan schedules A and Aᵀ independently, as JAX's does
    plan = ad_plan(tf.from_coo(s.rows, s.cols, s.vals, s.shape),
                   impl="cuda_balanced", k_blk=4, split_blk=split_blk,
                   device="cpu")
    jplan = jax_ad_plan(jcore.from_coo(s.rows, s.cols, s.vals, s.shape),
                        impl="pallas_balanced", k_blk=4, split_blk=split_blk)
    _same_schedule(plan.fwd_sched, jplan.fwd_sched)
    _same_schedule(plan.bwd_sched, jplan.bwd_sched)


def _check_run_plan(sched, w, run_blk):
    """Walk the balanced kernels' run plan on random per-block values: each
    piece sums its blocks, a whole window stores its sum, the edge entries
    of a cut window go through the combine tree, and every window's output
    must be the sum of its blocks.  Also checks the plan's structure."""
    plan = run_plan("test", sched, w, run_blk)
    assert run_plan("test", sched, w, run_blk) is plan       # memoized
    with pytest.raises(ValueError, match="not this view's"):
        run_plan("test", sched, w + 1, run_blk)
    pieces, run_ptr = plan.pieces.numpy(), plan.run_ptr.numpy()
    win, lo, cnt, entry = pieces.T
    # every scheduled block in exactly one piece, pieces in block order,
    # runs in piece order, none empty
    np.testing.assert_array_equal(lo, np.cumsum(cnt) - cnt)
    assert cnt.sum() == sched.num_blocks
    assert run_ptr[0] == 0 and run_ptr[-1] == pieces.shape[0]
    assert (np.diff(run_ptr) > 0).all()
    # runs cut only at segment boundaries: every run starts where a segment
    # does; pieces of one run hold distinct windows in order
    meta = sched.seg_meta.numpy().astype(np.int64)
    seg_pos = np.concatenate([[0], np.cumsum(meta[:, 1])])
    assert np.isin(lo[run_ptr[:-1]], seg_pos).all()
    run_of = np.repeat(np.arange(plan.num_runs), np.diff(run_ptr))
    same_run = run_of[1:] == run_of[:-1]
    assert (np.diff(win)[same_run] > 0).all()
    # at most two edge entries per run: only its first and last piece
    cut = entry >= 0
    assert (np.bincount(run_of[cut], minlength=plan.num_runs) <= 2).all()
    inner = np.ones(pieces.shape[0], bool)
    inner[run_ptr[:-1]] = inner[run_ptr[1:] - 1] = False
    assert not cut[inner].any()
    np.testing.assert_array_equal(entry[cut], np.arange(plan.entries))
    if sched.split_blk == 0:      # a window is one segment, hence one run
        assert plan.entries == 0 and not plan.tree.levels
    # the sums through pieces, edge entries and the tree
    nb = sched.num_blocks
    vals = np.random.default_rng(0).standard_normal(nb)
    piece_sum = np.bincount(np.repeat(np.arange(pieces.shape[0]), cnt),
                            weights=vals, minlength=pieces.shape[0])
    out = np.zeros(w)
    out[win[~cut]] = piece_sum[~cut]
    src = piece_sum[cut]
    meta_t = plan.tree.meta.numpy()
    for g0, count in plan.tree.levels:
        dst = np.zeros(plan.tree.entries)
        for g_lo, g_cnt, g_win, d in meta_t[g0:g0 + count]:
            total = src[g_lo:g_lo + g_cnt].sum()
            if d < 0:
                out[g_win] = total
            else:
                dst[d] = total
        src = dst
    want = np.bincount(sched.blk_win.numpy(), weights=vals, minlength=w)
    np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-12)
    assert all(c <= COMBINE_FANIN for c in meta_t[:, 1])
    return plan


@pytest.mark.parametrize("run_blk", [2, 8])
@pytest.mark.parametrize("split_blk", [0, 1, 3])
@pytest.mark.parametrize("name", MATRICES + [LONG])
def test_run_plan_covers_the_schedule(name, split_blk, run_blk):
    rows, cols, vals, shape = _coo(name)
    port = tf.block_format(tf.from_coo(rows, cols, vals, shape), 4,
                           device="cpu")
    sched = port.schedule(split_blk)
    plan = _check_run_plan(sched, port.num_windows, run_blk)
    counts = np.diff(port.win_ptr.numpy())
    longest = int(counts.argmax())
    win = plan.pieces.numpy()[:, 0]
    run_of = np.repeat(np.arange(plan.num_runs), np.diff(plan.run_ptr.numpy()))
    hub_runs = np.unique(run_of[win == longest])
    if split_blk == 0 or counts[longest] < run_blk // 2:
        assert hub_runs.size == 1           # the longest window in one run
    elif name == LONG:
        # the 38-block window is cut near every run_blk K-blocks
        assert hub_runs.size >= counts[longest] // (run_blk + split_blk)
    # a run is about run_blk K-blocks: a cut moves less than run_blk // 2
    # to a window boundary or less than split_blk to a segment boundary,
    # so only a window that is one segment makes a run longer
    blocks = np.bincount(run_of, weights=plan.pieces.numpy()[:, 2],
                         minlength=plan.num_runs)
    if split_blk:
        assert blocks.max() < 2 * run_blk + split_blk


def test_run_plan_of_an_all_empty_matrix_stores_every_window():
    empty = np.array([], np.int64)
    port = tf.block_format(tf.from_coo(empty, empty, np.array([], np.float32),
                                       (20, 17)), 8, device="cpu")
    plan = _check_run_plan(port.schedule(1), port.num_windows, 8)
    np.testing.assert_array_equal(
        plan.pieces.numpy(), [[w, 0, 0, -1] for w in range(port.num_windows)])
    with pytest.raises(ValueError, match="run_blk"):
        run_plan("test", port.schedule(1), port.num_windows, 0)


@pytest.mark.parametrize("split_blk", [0, 1, 3])
def test_all_empty_matrix_is_a_zero_block_schedule(split_blk):
    empty = np.array([], np.int64)
    port, ref = _views(empty, empty, np.array([], np.float32), (20, 17), 8)
    sched = port.schedule(split_blk)
    _same_schedule(sched, ref.schedule(split_blk))
    assert sched.num_blocks == 0 and port.num_blocks == 1    # dummy block
    # one zero-length store-only segment per window
    np.testing.assert_array_equal(sched.seg_meta.numpy(),
                                  [[0, 0, 1, 1]] * port.num_windows)


def test_schedule_checks_name_the_broken_invariant():
    s = load_vendored(["hub_96"])[0]
    port, _ = _views(s.rows, s.cols, s.vals, s.shape, k_blk=4)
    sched = port.schedule(1)
    meta = sched.seg_meta.clone()
    meta[0, 2] = 0                                    # first flag dropped
    with pytest.raises(ValidationError, match="seg-flags"):
        validate_schedule(dataclasses.replace(sched, seg_meta=meta), port)
    meta = sched.seg_meta.clone()
    meta[1, 0] += 1                                   # a block skipped
    with pytest.raises(ValidationError, match="seg-coverage"):
        validate_schedule(dataclasses.replace(sched, seg_meta=meta), port)
    seg_win = sched.seg_win.clone()
    seg_win[1] = seg_win[-1]                          # windows interleaved
    with pytest.raises(ValidationError, match="seg-coverage"):
        validate_schedule(dataclasses.replace(sched, seg_win=seg_win), port)
    with pytest.raises(ValueError, match="split_blk"):
        tf.build_schedule(port, -1)

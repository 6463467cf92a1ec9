"""Schedule parity: the port's ``build_schedule`` against the JAX
package's, array for array, on vendored matrices and the all-empty
matrix, and the schedule checks that guard the balanced kernels."""

import dataclasses

import numpy as np
import pytest

import repro.core as jcore
from repro.core.autodiff import ad_plan as jax_ad_plan
from repro.data.datasets import load_vendored
from repro_torch.core import ad_plan
from repro_torch.core import format as tf
from repro_torch.core.validate import ValidationError, check_schedule
from repro_torch.kernels._combine import COMBINE_FANIN, combine_tree

SCHEDULE = ("seg_win", "seg_meta", "blk_id", "blk_win")
# a power-law hub matrix, a banded one, a rectangular one
MATRICES = ["hub_128", "skewband_64", "rect_120x40"]


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
    _check_combine_tree(sched, port.num_windows)
    # the balanced plan schedules A and Aᵀ independently, as JAX's does
    plan = ad_plan(tf.from_coo(s.rows, s.cols, s.vals, s.shape),
                   impl="cuda_balanced", k_blk=4, split_blk=split_blk,
                   device="cpu")
    jplan = jax_ad_plan(jcore.from_coo(s.rows, s.cols, s.vals, s.shape),
                        impl="pallas_balanced", k_blk=4, split_blk=split_blk)
    _same_schedule(plan.fwd_sched, jplan.fwd_sched)
    _same_schedule(plan.bwd_sched, jplan.bwd_sched)


def _check_combine_tree(sched, w):
    """Run the balanced kernels' combine tree on random per-segment values:
    every split window's last group must see the sum of its segments."""
    tree = combine_tree("test", sched, w)
    assert combine_tree("test", sched, w) is tree            # memoized
    nseg = np.bincount(sched.seg_win.numpy(), minlength=w)
    assert tree.splits_windows == bool((nseg > 1).any())
    with pytest.raises(ValueError, match="not this view's"):
        combine_tree("test", sched, w + 1)
    vals = np.random.default_rng(0).standard_normal(sched.num_segments)
    meta = tree.meta.numpy()
    src, out = vals, np.zeros(w)
    for g0, count in tree.levels:
        dst = np.zeros(tree.entries)
        for lo, cnt, win, d in meta[g0:g0 + count]:
            total = src[lo:lo + cnt].sum()
            if d < 0:
                out[win] = total
            else:
                dst[d] = total
        src = dst
    want = np.bincount(sched.seg_win.numpy(), weights=vals, minlength=w)
    np.testing.assert_allclose(out[nseg > 1], want[nseg > 1])
    assert not out[nseg <= 1].any()
    assert all(cnt <= COMBINE_FANIN for cnt in meta[:, 1])


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
    wp = port.win_ptr.numpy().astype(np.int64)
    meta = sched.seg_meta.clone()
    meta[0, 2] = 0                                    # first flag dropped
    with pytest.raises(ValidationError, match="seg-flags"):
        check_schedule(dataclasses.replace(sched, seg_meta=meta), wp)
    meta = sched.seg_meta.clone()
    meta[1, 0] += 1                                   # a block skipped
    with pytest.raises(ValidationError, match="seg-coverage"):
        check_schedule(dataclasses.replace(sched, seg_meta=meta), wp)
    seg_win = sched.seg_win.clone()
    seg_win[1] = seg_win[-1]                          # windows interleaved
    with pytest.raises(ValidationError, match="seg-coverage"):
        check_schedule(dataclasses.replace(sched, seg_win=seg_win), wp)
    with pytest.raises(ValueError, match="split_blk"):
        tf.build_schedule(port, -1)

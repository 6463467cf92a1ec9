"""The redesigned SpMM ablation baselines (PERF.md rows 2 and 5), on the CPU.

Row 2 (``csrc/spmm_noncoalesced.cu``) walks a lane plan
(``kernels/_window.lane_plan``): row 1's slices of the windows, one per
lane, 32 lanes a group; a window's slices in one group (a run) are added
by a segmented scan over the lanes, and the runs of a window that spans
groups by fp32 partials in run order.  Row 5 (``csrc/spmm_staged.cu``)
walks row 1's window plan over the staged copy ``G = B[cols]``, row ``t``
of G for vector ``t``.  Both walks are emulated here in numpy: row 2's
on the CUDA cores (fp32 sums, each product fused into its sum through
fp64), held to row 1's tensor-core walk (``tests/_torch_spmm_tile.py``:
k-steps of 8 vectors in 3xTF32, another order of summation) at the fp32
tolerance; row 5's, which is row 1's kernel over G, bitwise; both against
the JAX package's interpret-mode kernels.  The lane plan's host arrays
cover every K-block exactly once, on every vendored matrix and its
transpose.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import _torch_spmm_tile as tile
import repro.core as jcore
from repro.data.datasets import load_vendored
from repro.kernels.spmm_pallas import (spmm_pallas_noncoalesced,
                                       spmm_pallas_staged)
from repro_torch.core.format import block_format, from_coo, from_dense
from repro_torch.core.sddmm import with_values
from repro_torch.kernels._window import (LANES, SPLIT_BLK, lane_plan,
                                         window_plan)
from _torch_threads import one_intraop_thread  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    "error::repro_torch.core.dispatch.FallbackWarning")

# fp32 emulation against the JAX kernels: sums in another order.
RTOL, ATOL = 1e-5, 1e-5
ULP_RTOL = 2.0 ** -7          # one bf16 ulp
K_BLK = 2
SAMPLES = {s.name: s for s in load_vendored()}


def _pair(rows, cols, vals, shape, k_blk=K_BLK):
    """One matrix blocked in both packages."""
    port = block_format(from_coo(rows, cols, vals, shape), k_blk,
                        device="cpu")
    jb = jcore.block_format(jcore.from_coo(rows, cols, vals, shape), k_blk)
    return port, jb


def _transpose(name):
    s = SAMPLES[name]
    return _pair(s.cols, s.rows, s.vals, (s.shape[1], s.shape[0]))


def _fma(a, b, c):
    """fp32 fused multiply-add: the product exact in fp64, one rounding
    of the sum to fp32 (through fp64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _running_sum(vals, rows_of, t_lo, t_hi, n):
    """One fp32 running sum over vectors [t_lo, t_hi), in vector order:
    acc[v] = fma(vals[t, v], B_row(t), acc[v])."""
    acc = np.zeros((vals.shape[1], n), np.float32)
    for t in range(t_lo, t_hi):
        acc = _fma(vals[t][:, None], rows_of(t)[None, :], acc)
    return acc


def _emulate_window(blocked, vals, b, rows_of=None):
    """Row 1's walk over its window plan (``spmm_window.cuh``, emulated by
    ``tests/_torch_spmm_tile.py``): k-steps of 8 vectors on the tensor
    cores, a slice's sums folded in order, a window's groups in order
    within a block, its blocks in rank order.  ``rows_of(idx)``: the B rows
    vectors ``idx`` read (default ``B[cols[idx]]``)."""
    return tile.window_emulated(with_values(blocked, torch.from_numpy(vals)),
                                torch.from_numpy(b), SPLIT_BLK, n_tile=128,
                                rows_of=rows_of)


def _emulate_lanes(blocked, plan, b):
    """Row 2's walk over its lane plan: each lane's slice one running sum;
    in each group of 32 lanes a segmented inclusive scan (lane l adds lane
    l - d's value when both are on one window, d = 1, 2, 4, 8, 16); each
    run's last lane stores its window, or a partial that a second pass adds
    in run order."""
    kb, v, n = blocked.k_blk, blocked.vector_size, b.shape[1]
    vals, cols = blocked.vals.numpy(), blocked.cols.numpy()
    sp, sw, so = (x.numpy() for x in (plan.slice_ptr, plan.slice_win,
                                      plan.slice_out))
    sums = np.stack([_running_sum(vals, lambda t: b[cols[t]], sp[s] * kb,
                                  sp[s + 1] * kb, n)
                     for s in range(plan.num_slices)])
    for g0 in range(0, plan.num_slices, LANES):
        x, w = sums[g0:g0 + LANES], sw[g0:g0 + LANES]
        for d in (1, 2, 4, 8, 16):
            y = x.copy()
            for lane in range(d, len(x)):
                if w[lane - d] == w[lane]:
                    y[lane] = x[lane] + x[lane - d]
            x = y
        sums[g0:g0 + LANES] = x
    out = np.zeros((blocked.num_windows * v, n), np.float32)
    for s in np.nonzero(so == -1)[0]:
        out[sw[s] * v:(sw[s] + 1) * v] = sums[s]
    part = {int(so[s]): sums[s] for s in np.nonzero(so >= 0)[0]}
    pw, pp = plan.part_win.numpy(), plan.part_ptr.numpy()
    for i, w in enumerate(pw):
        acc = np.zeros((v, n), np.float32)
        for p in range(pp[i], pp[i + 1]):
            acc = acc + part[p]
        out[w * v:(w + 1) * v] = acc
    return out[:blocked.shape[0]]


@pytest.mark.parametrize("split_blk", [1, SPLIT_BLK])
@pytest.mark.parametrize("name", ["hub_128", "hubgraph_100"])
def test_noncoalesced_walk_matches_row1_and_pallas(name, split_blk):
    port, jb = _transpose(name)
    b = np.random.default_rng(7).standard_normal(
        (port.shape[1], 12)).astype(np.float32)
    plan = lane_plan("test", port.win_ptr, split_blk)
    out = _emulate_lanes(port, plan, b)
    if split_blk == 1:  # runs within a group and across groups
        assert plan.num_partials > 0 and (plan.slice_out.numpy() == -1).any()
    # row 1 sums in tensor-core k-steps, row 2 in vector order
    row1 = _emulate_window(port, port.vals.numpy(), b)
    np.testing.assert_allclose(out, row1, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, np.asarray(spmm_pallas_noncoalesced(
        jb, jnp.asarray(b), interpret=True)), rtol=RTOL, atol=ATOL)


def _empty_windows_pair():
    """24 x 320: a window of 320 vectors (160 K-blocks, split above
    SPLIT_BLK), an empty window, a sparse one."""
    rng = np.random.default_rng(9)
    a = ((rng.random((24, 320)) < 0.1)
         * rng.standard_normal((24, 320))).astype(np.float32)
    a[:8] = rng.standard_normal((8, 320)).astype(np.float32)
    a[8:16] = 0.0
    r, c = np.nonzero(a)
    return _pair(r, c, a[r, c], a.shape), a


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_staged_walk_over_g_matches_row1_and_pallas(precision):
    (port, jb), a = _empty_windows_pair()
    assert int(np.diff(port.win_ptr.numpy()).max()) > SPLIT_BLK
    b = np.random.default_rng(8).standard_normal((320, 16)).astype(np.float32)
    vals = port.vals.numpy()
    if precision == "bf16":  # operands widened from bf16, as the kernel
        vals, b = (torch.from_numpy(x).to(torch.bfloat16).float().numpy()
                   for x in (vals, b))
    g = b[port.cols.numpy()]                   # the staged copy
    out = _emulate_window(port, vals, b, rows_of=lambda idx: g[idx])
    np.testing.assert_array_equal(out, _emulate_window(port, vals, b))
    assert not out[8:16].any()
    want = np.asarray(spmm_pallas_staged(jb, jnp.asarray(b), interpret=True,
                                         precision=precision),
                      np.float32)
    if precision == "fp32":
        np.testing.assert_allclose(out, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(out, a @ b, rtol=1e-4, atol=1e-4)
    else:
        got = torch.from_numpy(out).to(torch.bfloat16).float().numpy()
        np.testing.assert_allclose(got, want, rtol=ULP_RTOL, atol=1e-6 * (
            np.abs(want).max()))


def _views(transpose):
    for name, s in sorted(SAMPLES.items()):
        if transpose:
            yield name, block_format(from_coo(s.cols, s.rows, s.vals,
                                              (s.shape[1], s.shape[0])),
                                     K_BLK, device="cpu")
        else:
            yield name, block_format(from_coo(s.rows, s.cols, s.vals,
                                              s.shape), K_BLK, device="cpu")
    yield "all-empty", block_format(from_dense(np.zeros((30, 30),
                                                        np.float32)),
                                    K_BLK, device="cpu")


@pytest.mark.parametrize("split_blk", [1, 3, SPLIT_BLK])
@pytest.mark.parametrize("transpose", [False, True], ids=["A", "At"])
def test_lane_plan_covers_every_block_once(transpose, split_blk):
    for name, blocked in _views(transpose):
        wp = blocked.win_ptr.numpy().astype(np.int64)
        plan = lane_plan("test", blocked.win_ptr, split_blk)
        assert lane_plan("test", blocked.win_ptr, split_blk) is plan
        sp, sw, so = (x.numpy().astype(np.int64) for x in (
            plan.slice_ptr, plan.slice_win, plan.slice_out))
        pw, pp = plan.part_win.numpy(), plan.part_ptr.numpy()
        # consecutive ranges from block 0 to the last: every K-block once
        assert sp[0] == 0 and sp[-1] == wp[-1], name
        assert (np.diff(sp) >= 0).all() and (np.diff(sp) <= split_blk).all()
        # the slices are row 1's, window by window, in order
        rows = window_plan("test", blocked.win_ptr, split_blk,
                           128).slices(blocked.win_ptr)
        np.testing.assert_array_equal(sw, rows[:, 0], err_msg=name)
        np.testing.assert_array_equal(sp[:-1], rows[:, 2], err_msg=name)
        np.testing.assert_array_equal(np.diff(sp), rows[:, 3], err_msg=name)
        # one storing lane per run (a window's slices in one group), the
        # run's last; C for a window within one group, else partials in
        # slice order, window by window
        grp = np.arange(plan.num_slices) // LANES
        run = np.unique(np.stack([sw, grp]), axis=1)
        stores = so != -2
        assert stores.sum() == run.shape[1], name
        last = np.append((sw[1:] != sw[:-1]) | (grp[1:] != grp[:-1]), True)
        np.testing.assert_array_equal(stores, last, err_msg=name)
        spans = np.bincount(run[0], minlength=len(wp) - 1)
        np.testing.assert_array_equal(so[stores] == -1, spans[sw[stores]] == 1)
        np.testing.assert_array_equal(so[so >= 0],
                                      np.arange(plan.num_partials))
        np.testing.assert_array_equal(pw, np.nonzero(spans > 1)[0])
        np.testing.assert_array_equal(np.diff(pp), spans[pw])
        np.testing.assert_array_equal(np.repeat(pw, np.diff(pp)),
                                      sw[so >= 0])

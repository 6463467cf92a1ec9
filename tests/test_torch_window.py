"""The redesigned window-parallel SpMM and fused attention, on the CPU.

The window plan of ``spmm_window.cuh`` (``kernels/_window.py``) on every
vendored matrix, its transpose and the all-empty matrix: every K-block in
exactly one slice, no slice longer than ``split_blk``, short windows
unsplit, the slices of a window in a fixed order over groups and ranks.
The kernel's order of summation over the plan (its tensor-core k-steps,
slice folds and group and rank sums, ``tests/_torch_spmm_tile.py``),
emulated, against the dense product.  The 3xTF32 products of the
tensor-core attention (``attention.cu``), emulated with TF32 rounding,
against fp64: within the kernel tolerance, where plain TF32 is not.  And
the plain versions on windows the kernel splits against the JAX
package's interpret-mode kernels.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import _torch_spmm_tile as tile
import repro.core as jcore
from repro.core.sddmm import with_values as jax_with_values
from repro.data.datasets import load_vendored
from repro.kernels import ops as jops
from repro.kernels.spmm_pallas import spmm_pallas_batched
from repro_torch.core.format import block_format, from_coo, from_dense
from repro_torch.core.sddmm import with_values
from repro_torch.kernels import attention_cuda, spmm_batched_cuda, spmm_cuda
from repro_torch.kernels._window import (MAX_CLUSTER, PACK_WARPS,
                                         SPLIT_BLK, slice_groups, window_plan)
from _torch_threads import one_intraop_thread  # noqa: F401

# The kernels' tolerance against their plain versions (fp32, sums in
# another order), which the emulated 3xTF32 attention must meet.
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# fp32 against the dense oracle or the JAX kernels, sums in another order.
RTOL, ATOL = 1e-5, 1e-5

SAMPLES = {s.name: s for s in load_vendored()}
# (split_blk, column tile): every window of two or more K-blocks split
# over blocks of one group, medium and long windows at 4 groups of 128
# threads, 16 groups of one warp, and the kernel's own split length.
PLANS = [(1, 512), (2, 128), (3, 32), (SPLIT_BLK, 128)]


def _blocked(name, transpose, k_blk=2):
    if name == "all-empty":
        return block_format(from_dense(np.zeros((30, 30), np.float32)),
                            k_blk, device="cpu")
    s = SAMPLES[name]
    fmt = from_coo(s.rows, s.cols, s.vals, s.shape)
    return block_format(fmt.transpose() if transpose else fmt, k_blk,
                        device="cpu")


@pytest.mark.parametrize("split_blk, n_tile", PLANS)
@pytest.mark.parametrize("transpose", [False, True], ids=["A", "At"])
@pytest.mark.parametrize("name", sorted(SAMPLES) + ["all-empty"])
def test_window_plan_slices_cover_every_block(name, transpose, split_blk,
                                              n_tile):
    blocked = _blocked(name, transpose)
    wp = blocked.win_ptr.numpy().astype(np.int64)
    lens = np.diff(wp)
    plan = window_plan("test", blocked.win_ptr, split_blk, n_tile)
    assert window_plan("test", blocked.win_ptr, split_blk, n_tile) is plan
    # a view with other values shares the pattern, and the plan
    assert window_plan("test", with_values(blocked, blocked.vals * 2).win_ptr,
                       split_blk, n_tile) is plan
    sl = plan.slices(blocked.win_ptr)
    win, idx, first, count, task, rank, grp = sl.T
    # every K-block of every window in exactly one slice; the dummy block
    # of the all-empty matrix in none
    covered = np.concatenate([np.arange(f, f + c) for f, c in
                              zip(first, count)] + [np.zeros(0, np.int64)])
    np.testing.assert_array_equal(np.sort(covered), np.arange(wp[-1]))
    assert (count <= split_blk).all()
    # every window has slices 0 .. ns - 1, contiguous and ascending
    np.testing.assert_array_equal(np.unique(win), np.arange(len(lens)))
    ns = np.maximum(1, -(-lens // split_blk))
    np.testing.assert_array_equal(np.bincount(win), ns)
    starts = np.concatenate([[0], np.cumsum(np.bincount(win))[:-1]])
    np.testing.assert_array_equal(idx, np.arange(len(sl)) - np.repeat(
        starts, ns))
    np.testing.assert_array_equal(first, wp[win] + idx * lens[win] // ns[win])
    # windows of at most split_blk K-blocks stay one slice of one group,
    # in the pack of their index
    short = lens[win] <= split_blk
    c, g = plan.cluster, plan.groups
    first_pack = plan.num_tasks - -(-plan.num_windows // (c * g))
    np.testing.assert_array_equal(task[short],
                                  first_pack + win[short] // (c * g))
    np.testing.assert_array_equal(rank[short] * g + grp[short],
                                  win[short] % (c * g))
    # a split window's slices are summed in a fixed order: each group takes
    # consecutive slices, groups in order within a block, blocks in rank
    # order
    order = rank * g + grp
    for w in np.unique(win[~short]):
        assert (np.diff(order[win == w]) >= 0).all()
        assert len(set(task[win == w])) == 1
    # long windows (more than groups * split_blk) before medium ones, each
    # longest first, one cluster per long window
    ids = plan.split_ids.numpy()
    long_, medium = ids[:plan.num_long], ids[plan.num_long:]
    assert (lens[long_] > g * split_blk).all()
    assert ((lens[medium] > split_blk) & (lens[medium] <= g * split_blk)).all()
    assert set(ids) == set(np.nonzero(lens > split_blk)[0])
    for part in (long_, medium):
        assert (np.diff(lens[part]) <= 0).all()
    assert c in (1, 2, 4, 8, 16) and c <= MAX_CLUSTER
    assert (c > 1) == (plan.num_long > 0)
    # blocks of 512 threads for split windows; without, 4 one-warp groups
    # or one wider group
    assert g == (slice_groups(n_tile) if ids.size else
                 (PACK_WARPS if n_tile == 32 else 1))


def test_slice_groups_fill_a_block_of_512_threads():
    assert [slice_groups(n) for n in (32, 64, 96, 128, 256, 512)] == [
        16, 8, 4, 4, 2, 1]


@pytest.mark.parametrize("split_blk, n_tile", PLANS[:3])
@pytest.mark.parametrize("name", ["hub_128", "hubgraph_100"])
def test_kernel_order_over_the_plan_matches_dense(name, split_blk, n_tile):
    blocked = _blocked(name, True)
    s = SAMPLES[name]
    dense = np.zeros(s.shape, np.float32)
    np.add.at(dense, (s.rows, s.cols), s.vals)
    b = np.random.default_rng(5).standard_normal(
        (s.shape[0], 6)).astype(np.float32)
    plan = window_plan("test", blocked.win_ptr, split_blk, n_tile)
    assert plan.num_long + plan.num_medium > 0
    got = tile.window_emulated(blocked, torch.from_numpy(b), split_blk,
                               n_tile)
    np.testing.assert_allclose(got, dense.T @ b, rtol=RTOL, atol=ATOL)


def _tf32(x):
    """Round fp32 to TF32 (10 explicit mantissa bits): the low 13 bits,
    to nearest even."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0xFFF + ((u >> 13) & 1)) & ~np.uint64(0x1FFF)
    return u.astype(np.uint32).view(np.float32)


def _mma(a, b, split):
    """a (M, K) @ b (K, N) as the tensor cores take it: TF32 operands
    (with ``split``, 3xTF32: big.big + big.small + small.big), exact
    products, fp32 sums in K order."""
    def parts(x):
        big = _tf32(x)
        return big, _tf32((x - big).astype(np.float32))

    (ab, as_), (bb, bs) = parts(a), parts(b)
    terms = [(ab, bb)] + ([(ab, bs), (as_, bb)] if split else [])
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for kk in range(a.shape[1]):
        for x, y in reversed(terms):
            acc = (acc + np.outer(x[:, kk].astype(np.float64),
                                  y[kk].astype(np.float64)).astype(np.float32)
                   ).astype(np.float32)
    return acc


def _attention_window(q, k, v, split):
    """One window's attention as attention.cu walks it: chunks of 32
    vectors, S^T = K Q^T and acc^T += V^T P^T on the emulated tensor
    cores, the online softmax in fp32."""
    rows = q.shape[0]
    m = np.full(rows, -np.finfo(np.float32).max, np.float32)
    l = np.zeros(rows, np.float32)
    acc = np.zeros((v.shape[1], rows), np.float32)
    for t0 in range(0, k.shape[0], 32):
        s_t = _mma(k[t0:t0 + 32], q.T, split)              # (32, V)
        m_new = np.maximum(m, s_t.max(0))
        alpha = np.exp(m - m_new).astype(np.float32)
        p_t = np.exp(s_t - m_new).astype(np.float32)
        l = (l * alpha + p_t.sum(0)).astype(np.float32)
        acc = (acc * alpha + _mma(v[t0:t0 + 32].T, p_t, split)).astype(
            np.float32)
        m = m_new
    return (acc / np.maximum(l, 1e-20)).T


@pytest.mark.parametrize("d, dv", [(64, 64), (32, 32)])
def test_3xtf32_attention_meets_the_kernel_tolerance(d, dv):
    """A window of 8 rows over 128 vectors at the widths of the
    multi-head attention (64) and of AGNN (32), scaled scores as the
    kernel gets them: 3xTF32 within rtol 1e-4, atol 1e-5 of fp64, plain
    TF32 not."""
    rng = np.random.default_rng(d)
    q = (rng.standard_normal((8, d)) / np.sqrt(d)).astype(np.float32)
    k = rng.standard_normal((128, d)).astype(np.float32)
    v = rng.standard_normal((128, dv)).astype(np.float32)
    s = q.astype(np.float64) @ k.T.astype(np.float64)
    p = np.exp(s - s.max(1, keepdims=True))
    want = (p / p.sum(1, keepdims=True)) @ v.astype(np.float64)
    got = _attention_window(q, k, v, split=True)
    np.testing.assert_allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    plain = _attention_window(q, k, v, split=False)
    assert not np.allclose(plain, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


def _split_matrix():
    """24 x 320 at k_blk = 4: a dense first window of 320 vectors (80
    K-blocks, split by the kernel), short windows and an empty one."""
    rng = np.random.default_rng(11)
    a = ((rng.random((24, 320)) < 0.2) * rng.standard_normal((24, 320))
         ).astype(np.float32)
    a[:8] = rng.standard_normal((8, 320)).astype(np.float32)
    a[8:16] = 0.0
    return a


def test_plain_spmm_on_split_windows_matches_pallas():
    a = _split_matrix()
    port = block_format(from_dense(a), 4, device="cpu")
    assert int(port.win_ptr[1]) > SPLIT_BLK
    jb = jcore.block_format(jcore.from_dense(a), 4)
    rng = np.random.default_rng(12)
    b = rng.standard_normal((320, 16)).astype(np.float32)
    out = spmm_cuda(port, torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(
        jops.spmm(jb, jnp.asarray(b))), rtol=RTOL, atol=ATOL)
    vals = rng.standard_normal((2, *port.vals.shape)).astype(
        np.float32) * port.mask.numpy()
    b2 = rng.standard_normal((2, 320, 16)).astype(np.float32)
    out = spmm_batched_cuda(with_values(port, torch.from_numpy(vals)),
                            torch.from_numpy(b2))
    np.testing.assert_allclose(out.numpy(), np.asarray(spmm_pallas_batched(
        jax_with_values(jb, jnp.asarray(vals)), jnp.asarray(b2))),
        rtol=RTOL, atol=ATOL)


def test_plain_attention_on_a_long_window_matches_pallas():
    a = _split_matrix()
    port = block_format(from_dense(a), 4, device="cpu")
    jb = jcore.block_format(jcore.from_dense(a), 4)
    rng = np.random.default_rng(13)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((24, 9), (320, 9), (320, 5)))
    out = attention_cuda(port, *map(torch.from_numpy, (q, k, v)), scale=0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jops.attention(
        jb, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.5)),
        rtol=RTOL, atol=ATOL)

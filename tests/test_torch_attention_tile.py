"""The run-carried attention's tensor-core tile and walk, on the CPU.

Row 10 (``csrc/attention_balanced.cu``) takes its products on
``mma.sync`` m16n8k8 with FlashSparse's swap and transpose, in the chunk
step it shares with row 9 (``csrc/attention_chunk.cuh``): per chunk of 32
of a piece's vectors, Sᵀ = K[cols] Q_wᵀ and accᵀ = α accᵀ + Vmat[cols]ᵀ
Pᵀ, the window's V query rows on the n side, fp32 operands in 3xTF32
(big.big and the small products in two chains), bf16 ones exact.  The
kernel cannot run here, so its arithmetic and its walk over the run plan
are emulated (``_torch_attention_tile.py``): TF32 rounding as ``cvt.rna``,
exact products and one fp32 rounding per mma, the online softmax in fp32,
chunks from each piece's first vector, a piece's end storing its rows or
its edge entry (acc, m, l), and the combine tree's fp64 merge.

Held against fp64 and against the unchanged plain version
(``attention_balanced_plain``, itself held to the JAX package) at the
kernel tolerance, on vendored matrices and a long window cut into many
runs; once against ``attention_pallas_balanced`` in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_attention_tile as tile
import repro.core as jcore
from repro.data.datasets import load_vendored
from repro.kernels.attention_pallas import attention_pallas_balanced
from repro_torch.core.format import block_format, from_coo, from_dense
from repro_torch.kernels import attention_balanced_plain
from repro_torch.kernels._combine import run_plan
from _torch_spmm_tile import rna
from _torch_threads import one_intraop_thread  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    "error::repro_torch.core.dispatch.FallbackWarning")

# The kernel's tolerance against its plain version (fp32, sums in another
# order), which the emulated tile must meet against fp64 too.
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# bf16 outputs: one bf16 ulp (plus 1e-6 of the largest entry), at least
# 99% of the entries bitwise equal.
ULP_RTOL, ULP_ATOL_OF_MAX, BITWISE_SHARE = 2.0 ** -7, 1e-6, 0.99

SAMPLES = {s.name: s for s in load_vendored()}
D, DV = 20, 12       # D not a multiple of 8: zero-padded k-steps
SCALE = 0.6


def _blocked(name, transpose=False, k_blk=4):
    s = SAMPLES[name]
    rows, cols, shape = s.rows, s.cols, s.shape
    if transpose:
        rows, cols, shape = cols, rows, shape[::-1]
    return block_format(from_coo(rows, cols, s.vals, shape), k_blk,
                        device="cpu")


def _qkv(rng, blocked, d=D, dv=DV, dtype=torch.float32, spread=1.0):
    m, mc = blocked.shape
    q, k, v = (torch.from_numpy((spread * rng.standard_normal(s)).astype(
        np.float32)).to(dtype) for s in ((m, d), (mc, d), (mc, dv)))
    return q, k, v


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


def _one_ulp(got, want):
    got, want = got.float(), want.float()
    atol = ULP_ATOL_OF_MAX * max(want.abs().max().item(), 1e-30)
    torch.testing.assert_close(got, want, rtol=ULP_RTOL, atol=atol)
    assert (got == want).float().mean().item() >= BITWISE_SHARE


# (matrix, transposed): the hub matrix both ways, a block diagonal with
# windows longer than a run, short banded windows, a rectangular one
WALKS = [("hub_128", False), ("hub_128", True), ("blockdiag_96", False),
         ("pentadiag_96", True), ("rect_120x40", False),
         ("hubgraph_100", True)]


@pytest.mark.parametrize("name, transpose", WALKS)
def test_tile_walk_meets_the_kernel_tolerance(name, transpose):
    """The emulated kernel against fp64 and against the plain version
    over split_blk 0 (a window one piece) and 1 in runs of 3 K-blocks
    (runs cut windows: edge entries and the combine tree)."""
    rng = np.random.default_rng(len(name) + transpose)
    blocked = _blocked(name, transpose)
    q, k, v = _qkv(rng, blocked)
    want = tile.fp64(blocked, q, k, v, SCALE)
    for split, run_blk in ((0, 16), (1, 3)):
        sched = blocked.schedule(split)
        got = tile.balanced_emulated(blocked, q, k, v, sched, run_blk, SCALE)
        _close(got, want)
        _close(got, attention_balanced_plain(blocked, q, k, v, sched, SCALE,
                                             run_blk).numpy())


def _long_window():
    """40 x 400 at k_blk = 4: a dense first window of 400 vectors (100
    K-blocks), a second of about 120, an empty third, short ones after."""
    rng = np.random.default_rng(7)
    a = ((rng.random((40, 400)) < 0.05) * rng.standard_normal((40, 400))
         ).astype(np.float32)
    a[:8] = rng.standard_normal((8, 400)).astype(np.float32)
    a[8:16] = ((rng.random((8, 400)) < 0.3)
               * rng.standard_normal((8, 400))).astype(np.float32)
    a[16:24] = 0.0
    return block_format(from_dense(a), 4, device="cpu")


def test_a_long_window_cut_into_many_runs():
    """Runs of 2 K-blocks cut the first window into 50 edge entries (a
    combine tree of two levels) and leave empty pieces: the emulated
    kernel meets the tolerance against fp64 and the plain version, and
    the empty window's rows are zeros."""
    blocked = _long_window()
    sched = blocked.schedule(1)
    plan = run_plan("test", sched, blocked.num_windows, 2)
    assert len(plan.tree.levels) == 2
    assert (plan.pieces[:, 2] == 0).any()
    rng = np.random.default_rng(8)
    q, k, v = _qkv(rng, blocked, d=33, dv=40)
    got = tile.balanced_emulated(blocked, q, k, v, sched, 2, SCALE)
    _close(got, tile.fp64(blocked, q, k, v, SCALE))
    _close(got, attention_balanced_plain(blocked, q, k, v, sched, SCALE,
                                         2).numpy())
    assert not got[16:24].any()


def test_tile_walk_agrees_with_pallas():
    """Once against the JAX package's ``attention_pallas_balanced`` in
    interpret mode (the way its own tests run it on the CPU)."""
    rng = np.random.default_rng(21)
    a = ((rng.random((40, 36)) < 0.3) * rng.standard_normal((40, 36))
         ).astype(np.float32)
    a[8:16] = 0.0
    blocked = block_format(from_dense(a), 4, device="cpu")
    jb = jcore.block_format(jcore.from_dense(a), 4)
    q, k, v = _qkv(rng, blocked, d=6, dv=5)
    got = tile.balanced_emulated(blocked, q, k, v, blocked.schedule(1), 3,
                                 0.7)
    want = attention_pallas_balanced(jb, jnp.asarray(q.numpy()),
                                     jnp.asarray(k.numpy()),
                                     jnp.asarray(v.numpy()), scale=0.7,
                                     split_blk=1)
    _close(got, np.asarray(want))


@pytest.mark.parametrize("name", ["hub_128", "mesh2d_10"])
def test_bf16_operands_take_the_fp32_tile_exactly(name):
    """bf16 Q, K and Vmat widened to fp32 are exact in TF32 (small part
    0), so the tile that skips their small products is the fp32 tile on
    the widened operands, bit for bit; rounded once to bf16 it is within
    one bf16 ulp of the plain version on bf16 operands."""
    rng = np.random.default_rng(5)
    blocked = _blocked(name, True)
    q, k, v = _qkv(rng, blocked, dtype=torch.bfloat16)
    for x in (q, k, v):
        assert np.array_equal(rna(x.float().numpy()), x.float().numpy())
    sched = blocked.schedule(1)
    got = tile.balanced_emulated(blocked, q, k, v, sched, 3, SCALE)
    qs = (q.float() * SCALE).to(torch.bfloat16).float()
    assert np.array_equal(got, tile.balanced_emulated(
        blocked, qs, k.float(), v.float(), sched, 3, 1.0))
    _one_ulp(torch.from_numpy(got).to(torch.bfloat16),
             attention_balanced_plain(blocked, q, k, v, sched, SCALE, 3))


@pytest.mark.parametrize("name", ["hub_128", "uniform_80"])
def test_plain_tf32_misses_the_tolerance_where_3xtf32_meets_it(name):
    """One TF32 product a k-step (big.big alone) misses the kernel
    tolerance against fp64 on fp32 operands of unit spread; the 3xTF32
    split meets it."""
    rng = np.random.default_rng(3)
    blocked = _blocked(name)
    q, k, v = _qkv(rng, blocked, d=32, dv=32, spread=2.0)
    want = tile.fp64(blocked, q, k, v, SCALE)
    sched = blocked.schedule(1)
    _close(tile.balanced_emulated(blocked, q, k, v, sched, 3, SCALE), want)
    plain_tf32 = tile.balanced_emulated(blocked, q, k, v, sched, 3, SCALE,
                                        split=False)
    assert not np.allclose(plain_tf32, want, rtol=KERNEL_RTOL,
                           atol=KERNEL_ATOL)


def test_every_chunk_keeps_inside_its_piece():
    """On every vendored matrix and its transpose, over the split_blk = 1
    schedule in runs of 3 K-blocks and the split_blk = 0 one in runs of
    16: the chunks cover every vector of the view exactly once, each at
    most 32 vectors of one piece and so of one window; zero-length pieces
    (empty windows) take no chunk."""
    for name in sorted(SAMPLES):
        for transpose in (False, True):
            blocked = _blocked(name, transpose)
            nnzp = blocked.cols.shape[0]
            win_of = np.repeat(blocked.block_win.numpy(), blocked.k_blk)
            for split, run_blk in ((1, 3), (0, 16)):
                plan = run_plan("test", blocked.schedule(split),
                                blocked.num_windows, run_blk)
                seen = np.zeros(nnzp, np.int64)
                for w, blk0, nblk, _ in plan.pieces.numpy():
                    lo, hi = blk0 * blocked.k_blk, (blk0 + nblk) * blocked.k_blk
                    cs = tile.chunks(lo, hi)
                    assert (len(cs) == 0) == (nblk == 0)
                    for t, cnt in cs:
                        assert 1 <= cnt <= tile.CHUNK and t + cnt <= hi
                        assert (win_of[t:t + cnt] == w).all()
                        seen[t:t + cnt] += 1
                assert (seen == 1).all(), name

"""The tensor-core SpMM tile (``csrc/spmm_window.cuh``, ``mma_range``), on
the CPU.

Rows 1, 3 and 5 (the window SpMM) and row 4 (``csrc/spmm_balanced.cu``)
take their products on ``mma.sync`` m16n8k8 with FlashSparse's swap and
transpose: a k-step multiplies 8 vectors' gathered B rows (the mma's A
operand, 16 output columns a tile) by their values (its B operand, the
window's V rows on the n side).  The kernel cannot run here, so its
arithmetic and its walk are emulated:

* the arithmetic of a k-step: TF32 rounding as ``cvt.rna`` (nearest, ties
  away from zero), fp32 operands split into big + small (3xTF32: lo +=
  big.small, lo += small.big in the mma's chain, and big.big from a zero
  accumulator, rounded to fp32 and added to hi by an fp32 add), exact
  products and one fp32 rounding per mma; a slice's sum is hi + lo;
  bf16 operands are exact in TF32 and take only big.big; int8 values are
  ``q * scale`` in fp32;
* the walk: chunks of 32 vectors from the start of a group's range (the
  balanced kernel: of a run), cut where a slice (a run piece) ends, k-steps
  of 8 from each cut, the last one short; the slice sums folded in order,
  a window's groups in order, its blocks in rank order (the balanced
  kernel: each k-step's big.big product added to fp64 sums and a chunk
  range's small products where the range ends, a window's run edges
  summed in fp64).

Held against fp64 and the unchanged plain versions (``spmm_plain``,
``spmm_balanced_plain``) at the kernel tolerance, on the 14 vendored
matrices and their transposes at V = 8, k_blk 8 and 4, N = 37 (a ragged
column tile), with split windows and runs that cut windows.
"""

import numpy as np
import pytest
import torch

import _torch_spmm_tile as tile
from repro.data.datasets import load_vendored
from repro_torch.core.format import block_format, from_coo
from repro_torch.core.quantize import quantize_format
from repro_torch.core.sddmm import with_values
from repro_torch.core.spmm import dequantized
from repro_torch.kernels import spmm_balanced_plain, spmm_plain
from repro_torch.kernels._combine import run_plan
from repro_torch.kernels._window import SPLIT_BLK, window_plan
from _torch_threads import one_intraop_thread  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    "error::repro_torch.core.dispatch.FallbackWarning")

# The kernels' tolerance against their plain versions (fp32, sums in
# another order), which the emulated tile must meet against fp64 too.
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# bf16 outputs: one bf16 ulp (plus 1e-6 of the largest entry), at least
# 99% of the entries bitwise equal.
ULP_RTOL, ULP_ATOL_OF_MAX, BITWISE_SHARE = 2.0 ** -7, 1e-6, 0.99

SAMPLES = {s.name: s for s in load_vendored()}
N = 37            # columns: a tile of 64 with 27 masked
K_BLKS = (8, 4)
# split lengths of the window plan (every window of more than 3 K-blocks
# split, and the kernel's own) and the balanced kernel's runs (K-blocks)
SPLITS = (3, SPLIT_BLK)
RUN_BLK = 3


def _blocked(name, transpose, k_blk):
    s = SAMPLES[name]
    rows, cols, shape = s.rows, s.cols, s.shape
    if transpose:
        rows, cols, shape = cols, rows, shape[::-1]
    return block_format(from_coo(rows, cols, s.vals, shape), k_blk,
                        device="cpu")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


def _one_ulp(got, want):
    got, want = got.float(), want.float()
    atol = ULP_ATOL_OF_MAX * max(want.abs().max().item(), 1e-30)
    torch.testing.assert_close(got, want, rtol=ULP_RTOL, atol=atol)
    assert (got == want).float().mean().item() >= BITWISE_SHARE


def _b(rng, k, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal((k, N)).astype(
        np.float32)).to(dtype)


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_tile_meets_the_kernel_tolerance(name):
    """The emulated 3xTF32 tile of both kernels against fp64 and against
    their plain versions, on A and Aᵀ at k_blk 8 and 4, the window SpMM
    at split_blk 3 and SPLIT_BLK, the balanced one over the split_blk = 1
    schedule in runs of 3 K-blocks."""
    rng = np.random.default_rng(len(name))
    for transpose in (False, True):
        for k_blk in K_BLKS:
            view = _blocked(name, transpose, k_blk)
            b = _b(rng, view.shape[1])
            want = tile.fp64(view, b)
            plain = spmm_plain(view, b).numpy()
            for split_blk in SPLITS:
                got = tile.window_emulated(view, b, split_blk)
                _close(got, want)
                _close(got, plain)
            sched = view.schedule(1)
            got = tile.balanced_emulated(view, b, sched, RUN_BLK)
            _close(got, want)
            _close(got, spmm_balanced_plain(view, b, sched,
                                            RUN_BLK).numpy())


@pytest.mark.parametrize("name", ["hub_128", "blockdiag_96", "uniform_80"])
def test_plain_tf32_misses_the_tolerance_where_3xtf32_meets_it(name):
    """One TF32 product a k-step (big.big alone) misses the kernel
    tolerance against fp64 on fp32 operands; the 3xTF32 split meets it."""
    rng = np.random.default_rng(3)
    view = _blocked(name, True, 8)
    b = _b(rng, view.shape[1])
    want = tile.fp64(view, b)
    _close(tile.window_emulated(view, b, 3), want)
    for plain_tf32 in (tile.window_emulated(view, b, 3, split=False),
                       tile.balanced_emulated(view, b, view.schedule(1),
                                              RUN_BLK, split=False)):
        assert not np.allclose(plain_tf32, want, rtol=KERNEL_RTOL,
                               atol=KERNEL_ATOL)


def test_tails_take_each_product_to_fp32_accuracy():
    """big + small + tail is x exactly, the tail exact in TF32; the six
    products (3xTF32's three and big.tail, tail.big, small.small) take
    every product a b to within 2^-32 of |a b|, where the three of 3xTF32
    are off by more than 2^-24 on some (a sum of 400,000 such products on
    a hub row of Amazon's transpose shows it)."""
    rng = np.random.default_rng(28)
    a, b = (rng.standard_normal(100_000).astype(np.float32) for _ in "ab")
    (ab, as_, at), (bb, bs, bt) = (tile.tf32_parts(x, False) for x in (a, b))
    for x, parts in ((a, (ab, as_, at)), (b, (bb, bs, bt))):
        assert np.array_equal(tile.rna(parts[2]), parts[2])
        assert np.array_equal(
            (parts[0].astype(np.float64) + parts[1]) + parts[2], x)
    exact = a.astype(np.float64) * b
    three = ab.astype(np.float64) * bb + ab.astype(np.float64) * bs \
        + as_.astype(np.float64) * bb
    six = three + ab.astype(np.float64) * bt + at.astype(np.float64) * bb \
        + as_.astype(np.float64) * bs
    assert (np.abs(six - exact) <= 2.0 ** -32 * np.abs(exact)).all()
    assert (np.abs(three - exact) > 2.0 ** -24 * np.abs(exact)).any()


@pytest.mark.parametrize("name", ["hub_128", "rect_120x40", "mesh2d_10"])
def test_bf16_operands_take_the_fp32_tile_exactly(name):
    """bf16 values and B widened to fp32 are exact in TF32 (small part 0),
    so the tile on them is the fp32 tile on the widened operands: rounded
    once to bf16, within one bf16 ulp of the plain version on bf16
    operands and at least 99% bitwise equal."""
    rng = np.random.default_rng(5)
    for k_blk in K_BLKS:
        view = _blocked(name, True, k_blk)
        v16 = with_values(view, view.vals.to(torch.bfloat16))
        b16 = _b(rng, view.shape[1], torch.bfloat16)
        vw = with_values(view, v16.vals.float())
        assert np.array_equal(tile.rna(vw.vals.numpy()), vw.vals.numpy())
        for emulate in (lambda x, y: tile.window_emulated(x, y, 3),
                        lambda x, y: tile.balanced_emulated(
                            x, y, view.schedule(1), RUN_BLK)):
            got = emulate(v16, b16)
            assert np.array_equal(got, emulate(vw, b16.float()))
            _one_ulp(torch.from_numpy(got).to(torch.bfloat16),
                     spmm_plain(v16, b16))


@pytest.mark.parametrize("name", ["hub_128", "hubgraph_100"])
def test_int8_values_take_the_tile_on_q_times_scale(name):
    """int8 values dequantized to q * scale in fp32: with bf16 B (exact)
    two products a k-step, bitwise the fp32 tile on (q * scale, widened
    B) and within one bf16 ulp of the plain version; with fp32 B three,
    within the kernel tolerance of fp64 and of the plain version."""
    rng = np.random.default_rng(9)
    for k_blk in K_BLKS:
        q8 = quantize_format(_blocked(name, True, k_blk))
        b = _b(rng, q8.shape[1])
        b16 = b.to(torch.bfloat16)
        deq = dequantized(q8)
        got = tile.window_emulated(q8, b16, 3)
        assert np.array_equal(got, tile.window_emulated(deq, b16.float(), 3))
        _one_ulp(torch.from_numpy(got).to(torch.bfloat16),
                 spmm_plain(q8, b16))
        got = tile.window_emulated(q8, b, 3)
        _close(got, tile.fp64(q8, b))
        _close(got, spmm_plain(q8, b).numpy())


@pytest.mark.parametrize("k_blk", [4, 8])
def test_every_kstep_keeps_inside_its_boundaries(k_blk):
    """On every vendored matrix and its transpose: the k-steps of both
    kernels cover every vector of the view exactly once, each at most 8
    vectors of one chunk, one window and one slice (window kernel, every
    plan) or one run piece (balanced kernel), cut short only where its
    range ends; they start and end on K-blocks, so at k_blk = 4 a step is
    two whole K-blocks of one slice, or the last one."""
    for name in sorted(SAMPLES):
        for transpose in (False, True):
            view = _blocked(name, transpose, k_blk)
            nnzp = view.cols.shape[0]
            win_of = np.repeat(view.block_win.numpy(), k_blk)
            walks = []
            for split_blk in (1, 3, SPLIT_BLK):
                plan = window_plan("test", view.win_ptr, split_blk, 64)
                sl = plan.slices(view.win_ptr)
                slice_of = np.full(nnzp, -1)
                for i, (_, _, first, count, *_) in enumerate(sl):
                    slice_of[first * k_blk:(first + count) * k_blk] = i
                steps = []
                for w in np.unique(sl[:, 0]):
                    rows = sl[sl[:, 0] == w]
                    for key in sorted({(r[5], r[6]) for r in rows}):
                        grp = rows[(rows[:, 5] == key[0])
                                   & (rows[:, 6] == key[1])]
                        t_lo = grp[0, 2] * k_blk
                        ends = list((grp[:, 2] + grp[:, 3]) * k_blk)
                        steps += [(t, c, e, t_lo) for t, c, e in
                                  tile.ksteps(t_lo, ends[-1], ends)]
                walks.append((steps, slice_of))
            sched = view.schedule(1)
            rp = run_plan("test", sched, view.num_windows, RUN_BLK)
            ptr, pieces = rp.run_ptr.numpy(), rp.pieces.numpy()
            piece_of = np.full(nnzp, -1)
            steps = []
            for r in range(rp.num_runs):
                ps = pieces[ptr[r]:ptr[r + 1]]
                for i, p in enumerate(ps):
                    piece_of[p[1] * k_blk:(p[1] + p[2]) * k_blk] = ptr[r] + i
                ends = [(p[1] + p[2]) * k_blk for p in ps]
                steps += [(t, c, e, ps[0][1] * k_blk) for t, c, e in
                          tile.ksteps(ps[0][1] * k_blk, ends[-1], ends)]
            walks.append((steps, piece_of))
            for steps, unit in walks:
                seen = np.zeros(nnzp, np.int64)
                for t, cnt, cut, t_lo in steps:
                    idx = np.arange(t, t + cnt)
                    seen[idx] += 1
                    assert 1 <= cnt <= tile.KSTEP and t + cnt <= cut
                    assert cnt == tile.KSTEP or t + cnt == cut
                    assert ((t - t_lo) // tile.CHUNK
                            == (t + cnt - 1 - t_lo) // tile.CHUNK)
                    assert len(set(win_of[idx])) == 1
                    assert len(set(unit[idx])) == 1 and unit[t] >= 0
                    assert t % k_blk == 0 and cnt % k_blk == 0
                assert (seen == 1).all(), name

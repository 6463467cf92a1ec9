"""The tensor-core SDDMM tile (``csrc/sddmm_rows.cuh``), on the CPU.

The kernel cannot run here, so its arithmetic and its walk are emulated:

* the arithmetic of a sampled row: TF32 rounding as ``cvt.rna`` (nearest,
  ties away from zero), fp32 operands split into big + small (3xTF32:
  big.big, big.small and small.big, the small products in their own
  accumulator), exact products and one fp32 sum per k-step of 8
  features, the k-steps in the kernel's order (chunks of 32 features,
  step s = 0 .. 3 of a chunk taking features 8 t + 2 s and + 1, t = 0 .. 3).  Held against fp64 and
  against the unchanged plain versions of the window, head-grid and
  balanced SDDMMs at the kernel tolerance, on every vendored matrix, at
  F in {1, 7, 8, 32, 33, 64, 720}, V in {8, 16} and k_blk in {4, 8, 16},
  on rows of unit norm (``_inputs``);
  bf16 operands are exact in TF32, so their tile is the fp32 tile on the
  widened operands, within one bf16 ulp of the plain version once rounded;
* the walk: each warp over a contiguous run of 16-row tiles, the distinct
  windows of each tile, and the select that keeps a row's result only from
  its own window's product, for the window rows and for the balanced
  SDDMM's scheduled rows.
"""

import pathlib
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import repro.core as jcore
from repro.data.datasets import load_vendored
from repro.kernels import ref as jref
from repro_torch.core.format import block_format, from_dense
from repro_torch.kernels import (sddmm_balanced_plain, sddmm_batched_plain,
                                 sddmm_plain)

# The kernels' tolerance against their plain versions (fp32, sums in
# another order), which the emulated tile must meet against fp64 too.
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# bf16 outputs: one bf16 ulp (plus 1e-6 of the largest entry), at least
# 99% of the entries bitwise equal.
ULP_RTOL, ULP_ATOL_OF_MAX, BITWISE_SHARE = 2.0 ** -7, 1e-6, 0.99

SAMPLES = {s.name: s for s in load_vendored()}
WIDTHS = [1, 7, 8, 32, 33, 64, 720]
SHAPES = [(v, k_blk) for v in (8, 16) for k_blk in (4, 8, 16)]

_CSRC = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
         / "kernels" / "csrc" / "sddmm_rows.cuh").read_text()


def _constant(name):
    """A ``constexpr int`` of the kernel's source."""
    return int(re.search(rf"constexpr int {name} = (\d+);", _CSRC).group(1))


WARPS, TILE = _constant("kSddmmWarps"), _constant("kSddmmTile")
TILES_PER_WARP = _constant("kSddmmTilesPerWarp")


def _dense(name):
    s = SAMPLES[name]
    a = np.zeros(s.shape, np.float32)
    a[s.rows, s.cols] = s.vals
    return a


def _blocked(name, v, k_blk):
    return block_format(from_dense(_dense(name), vector_size=v), k_blk,
                        device="cpu")


def _rna(x):
    """fp32 to TF32 as ``cvt.rna``: round the low 13 bits away, to nearest,
    ties away from zero (the float is sign and magnitude)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _ksteps(f):
    """Feature indices of each k-step in the kernel's order; features past
    F are zeros and add nothing, so they are left out."""
    steps = []
    for c in range(0, f, 32):
        for s in range(4):
            idx = [c + 8 * t + 2 * s + e for t in range(4) for e in (0, 1)]
            steps.append([i for i in idx if i < f])
    return [s for s in steps if s]


def _tile(q, k, win, cols, v, split=True):
    """Unmasked S (R, V) of sampled rows with windows ``win`` and columns
    ``cols`` as the tile computes it: rows past M of Q are zero; with
    ``split``, 3xTF32 (lo += big.small, lo += small.big, hi += big.big per
    k-step, S = hi + lo), else plain TF32 (hi += big.big)."""
    m, f = q.shape
    qrows = win[:, None].astype(np.int64) * v + np.arange(v)
    qpad = np.zeros((max(m, int(qrows.max(initial=0)) + 1), f), np.float32)
    qpad[:m] = q
    qw, kr = qpad[qrows], k[cols]

    def parts(x):
        big = _rna(x)
        return big, _rna((x - big).astype(np.float32))

    (kb, ks), (qb, qs) = parts(kr), parts(qw)
    hi = np.zeros(qrows.shape, np.float32)
    lo = np.zeros(qrows.shape, np.float32)

    def prod(a, b, idx):
        return np.einsum("rf,rvf->rv", a[:, idx].astype(np.float64),
                         b[:, :, idx].astype(np.float64))

    for idx in _ksteps(f):
        if split:
            lo = (lo + prod(kb, qs, idx)).astype(np.float32)
            lo = (lo + prod(ks, qb, idx)).astype(np.float32)
        hi = (hi + prod(kb, qb, idx)).astype(np.float32)
    return hi + lo


def _window_rows(blocked):
    """(window, column) of every sampled row of the blocked view."""
    nnzp = blocked.cols.shape[0]
    win = blocked.block_win.numpy()[np.arange(nnzp) // blocked.k_blk]
    return win, blocked.cols.numpy()


def _emulate(blocked, q, k, split=True):
    """The window SDDMM's output (NNZP, V) in fp32, as the tile computes it."""
    win, cols = _window_rows(blocked)
    return _tile(q, k, win, cols, blocked.vector_size, split) * \
        blocked.mask.numpy()


def _fp64(blocked, q, k):
    win, cols = _window_rows(blocked)
    v = blocked.vector_size
    qrows = win[:, None].astype(np.int64) * v + np.arange(v)
    qpad = np.zeros((max(q.shape[0], int(qrows.max()) + 1), q.shape[1]))
    qpad[: q.shape[0]] = q
    return np.einsum("rf,rvf->rv", k[cols].astype(np.float64),
                     qpad[qrows]) * blocked.mask.numpy()


def _inputs(rng, blocked, f, heads=()):
    """Q ([H,] M, F) and K (Mc, F) with rows of unit norm, as the main path
    gives them to the SDDMM (AGNN's normalized features; the attention's
    queries scaled by 1 / sqrt(D)): S is then a cosine, and an fp32 sum in
    any order stays within the kernel tolerance of fp64 at any F.  (At
    unit-normal entries and F = 1,500 the plain version's own fp32 sum is
    off fp64 by more than atol 1e-5 on rows that cancel.)"""
    m, mc = blocked.shape

    def unit(*shape):
        x = rng.standard_normal(shape)
        return (x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True),
                               1e-6)).astype(np.float32)

    return unit(*heads, m, f), unit(mc, f)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_tile_arithmetic_meets_the_kernel_tolerance(name, f):
    """The emulated 3xTF32 tile against fp64 and against the plain window,
    head-grid (two heads of Q, K shared) and balanced (split_blk 1)
    versions, at every (V, k_blk)."""
    rng = np.random.default_rng(f * 1000 + len(name))
    for v, k_blk in SHAPES:
        blocked = _blocked(name, v, k_blk)
        q, k = _inputs(rng, blocked, f, heads=(2,))
        got = np.stack([_emulate(blocked, q[i], k) for i in range(2)])
        _close(got, np.stack([_fp64(blocked, q[i], k) for i in range(2)]))
        qt, kt = torch.from_numpy(q), torch.from_numpy(k)
        _close(got[0], sddmm_plain(blocked, qt[0], kt).numpy())
        _close(got, sddmm_batched_plain(blocked, qt, kt).numpy())
        sched = blocked.schedule(1)
        _close(got[1], sddmm_balanced_plain(blocked, qt[1], kt,
                                            sched).numpy())


@pytest.mark.parametrize("name", ["hub_128", "rect_120x40"])
@pytest.mark.parametrize("f", [7, 64])
def test_tile_matches_the_jax_oracle(name, f):
    """The emulated tile against the JAX package's oracle
    (``repro.kernels.ref.sddmm_ref``) on the same blocked pattern."""
    rng = np.random.default_rng(f + 7)
    a = _dense(name)
    blocked = block_format(from_dense(a), 8, device="cpu")
    jb = jcore.block_format(jcore.from_dense(a), 8)
    q, k = _inputs(rng, blocked, f)
    want = np.asarray(jref.sddmm_ref(jb, jnp.asarray(q), jnp.asarray(k)))
    _close(_emulate(blocked, q, k), want)


@pytest.mark.parametrize("name", ["hub_128", "blockdiag_96", "uniform_80"])
def test_plain_tf32_misses_the_tolerance_where_3xtf32_meets_it(name):
    """At F = 64 (the attention's head width) one TF32 product a k-step
    misses the kernel tolerance; the 3xTF32 split meets it."""
    rng = np.random.default_rng(64)
    blocked = _blocked(name, 8, 8)
    q, k = _inputs(rng, blocked, 64)
    want = _fp64(blocked, q, k)
    _close(_emulate(blocked, q, k), want)
    assert not np.allclose(_emulate(blocked, q, k, split=False), want,
                           rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


@pytest.mark.parametrize("f", [8, 33])
@pytest.mark.parametrize("name", ["hub_128", "rect_120x40", "mesh2d_10"])
def test_bf16_operands_take_the_fp32_tile_exactly(name, f):
    """bf16 Q and K widened to fp32 are exact in TF32 (small part 0), so
    the tile on them is the fp32 tile on the widened operands: rounded once
    to bf16, within one bf16 ulp of the plain version on bf16 operands and
    at least 99% bitwise equal."""
    rng = np.random.default_rng(f + 3)
    for v, k_blk in SHAPES:
        blocked = _blocked(name, v, k_blk)
        q, k = _inputs(rng, blocked, f)
        q16, k16 = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k))
        qw, kw = q16.float().numpy(), k16.float().numpy()
        assert np.array_equal(_rna(qw), qw) and np.array_equal(_rna(kw), kw)
        exact = _emulate(blocked, qw, kw, split=False)
        assert np.array_equal(_emulate(blocked, qw, kw), exact)
        got = torch.from_numpy(exact).to(torch.bfloat16).float()
        want = sddmm_plain(blocked, q16, k16).float()
        atol = ULP_ATOL_OF_MAX * max(want.abs().max().item(), 1e-30)
        torch.testing.assert_close(got, want, rtol=ULP_RTOL, atol=atol)
        assert (got == want).float().mean().item() >= BITWISE_SHARE


def _walk(rows, tpw):
    """The tiles each (block, warp) of the kernel takes, in order: warp w of
    block b the tpw tiles from (b W + w) tpw on (W warps a block)."""
    ntiles = -(-rows // TILE)
    for b in range(-(-ntiles // (WARPS * tpw))):
        for w in range(WARPS):
            first = (b * WARPS + w) * tpw
            yield (b, w), range(first, min(first + tpw, ntiles))


def _scheduled_rows(blocked, sched):
    """(output row, window) of each scheduled row of the balanced SDDMM."""
    k_blk = blocked.k_blk
    u = np.arange(sched.num_blocks * k_blk)
    i = u // k_blk
    return (sched.blk_id.numpy()[i].astype(np.int64) * k_blk + u % k_blk,
            sched.blk_win.numpy()[i])


@pytest.mark.parametrize("tpw", [1, 3, TILES_PER_WARP])
@pytest.mark.parametrize("k_blk", [1, 3, 4, 8, 16])
@pytest.mark.parametrize("name", ["hub_128", "rect_120x40", "blockdiag_96"])
def test_tile_walk_covers_every_row_once_against_its_own_window(name, k_blk,
                                                               tpw):
    """Every sampled row, of the window SDDMMs and of the balanced one, is
    in exactly one warp's tile; a tile takes one product per distinct
    window among its rows (at most ceil(16 / k_blk) + 1, one at k_blk = 16
    since tiles start on a block), and each row keeps the product of its
    own window: the lane passes its accumulator into every product and
    keeps the result only on a match."""
    blocked = _blocked(name, 8, k_blk)
    win_rows = _window_rows(blocked)[0]
    sched_rows, sched_win = _scheduled_rows(blocked, blocked.schedule(1))
    for out_row, win in ((np.arange(win_rows.shape[0]), win_rows),
                         (sched_rows, sched_win)):
        rows = win.shape[0]
        seen = np.zeros(rows, np.int64)
        kept = np.full(rows, -1, np.int64)
        limit = -(-TILE // k_blk) + (TILE % k_blk != 0)
        for _, tiles in _walk(rows, tpw):
            for t in tiles:
                u = np.arange(t * TILE, min((t + 1) * TILE, rows))
                seen[u] += 1
                windows = list(dict.fromkeys(win[u].tolist()))  # lane order
                assert len(windows) <= limit
                acc = np.full(u.shape, -1, np.int64)
                for w in windows:
                    acc = np.where(win[u] == w, w, acc)
                kept[u] = acc
        assert (seen == 1).all()
        assert np.array_equal(kept, win)
        assert np.array_equal(np.sort(out_row), np.arange(rows))

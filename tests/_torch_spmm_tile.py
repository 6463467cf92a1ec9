"""The tensor-core SpMM tile (``csrc/spmm_window.cuh``, ``mma_range``)
emulated in numpy: the arithmetic of its k-steps and the walks of the
window SpMM (rows 1, 3 and 5) and the balanced SpMM (row 4) over their
host plans.  Shared by ``test_torch_spmm_tile.py`` and
``test_torch_baselines_plan.py``.
"""

import pathlib
import re

import numpy as np
import torch

from repro_torch.core.spmm import dequantized
from repro_torch.kernels._combine import run_plan
from repro_torch.kernels._window import window_plan

CSRC = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc" / "spmm_window.cuh").read_text()


def constant(name):
    """A ``constexpr int`` of the kernel's source."""
    return int(re.search(rf"constexpr int {name} = (\d+);", CSRC).group(1))


CHUNK, KSTEP = constant("kSpmmChunk"), constant("kSpmmKStep")
TAIL_BLOCKS = int(re.search(
    r"constexpr int kTailBlocks = (\d+);",
    (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
     / "kernels" / "csrc" / "spmm_balanced.cu").read_text()).group(1))


def rna(x):
    """fp32 to TF32 as ``cvt.rna``: round the low 13 bits away, to nearest,
    ties away from zero (the float is sign and magnitude)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_parts(x, exact):
    """(big, small, tail) of a TF32 operand, big + small + tail = x; an
    exact one has neither small part nor tail."""
    if exact:
        return x, None, None
    big = rna(x)
    rest = (x - big).astype(np.float32)
    small = rna(rest)
    return big, small, (rest - small).astype(np.float32)


def mma(acc, vals, rows):
    """acc + vals^T @ rows as one mma: exact products, one fp32 rounding."""
    return (acc + vals.T.astype(np.float64) @ rows.astype(np.float64)
            ).astype(np.float32)


def kstep(hi, lo, vals, rows, exact_v, exact_b, split=True, tail=False):
    """One k-step: vals (L, V) and gathered B rows (L, N), L <= 8, into the
    (V, N) sums hi and lo, as ``mma_3xtf32`` takes them: with ``tail``
    the products of order 2^-22 first (big.tail, tail.big, small.small,
    each where no factor is of an exact operand), then 3xTF32's small
    products into lo, then big.big from zero into hi.
    ``split=False``: big.big alone (plain TF32)."""
    vb, vs, vt = tf32_parts(vals, exact_v)
    bb, bs, bt = tf32_parts(rows, exact_b)
    if split and tail and vs is not None:
        lo = mma(lo, vt, bb)
    if split and tail and bs is not None:
        lo = mma(lo, vb, bt)
    if split and tail and vs is not None and bs is not None:
        lo = mma(lo, vs, bs)
    if split and vs is not None:
        lo = mma(lo, vs, bb)
    if split and bs is not None:
        lo = mma(lo, vb, bs)
    d = mma(np.zeros_like(hi), vb, bb)
    return (hi + d).astype(np.float32), lo


def ksteps(t_lo, t_hi, cuts):
    """The kernel's k-steps over vectors [t_lo, t_hi): chunks of CHUNK from
    t_lo, each cut where a range ends inside it (the ``cuts``: slice or
    piece ends), k-steps of KSTEP from each range's start, the last one
    short.  Yields (first vector, count, end of its range)."""
    cuts = sorted(set(cuts))
    for t0 in range(t_lo, t_hi, CHUNK):
        end = min(t0 + CHUNK, t_hi)
        r0 = t0
        for cut in [c for c in cuts if t0 < c < end] + [end]:
            for t in range(r0, cut, KSTEP):
                yield t, min(KSTEP, cut - t), cut
            r0 = cut


def operands(view, b):
    """The fp32 values the ring holds ((NNZP, V): int8 dequantized) and
    whether the values and B are exact in TF32 (widened bf16)."""
    vals = dequantized(view).vals.float().numpy()
    return (vals, view.vals.dtype == torch.bfloat16,
            b.dtype == torch.bfloat16)


def window_emulated(view, b, split_blk, n_tile=64, split=True,
                    rows_of=None):
    """C (M, N) in fp32 as the window SpMM computes it over its plan;
    ``rows_of(idx)``: the B rows vectors ``idx`` read (by default
    ``B[cols[idx]]``; the staged SpMM reads its copy, ``G[idx]``)."""
    vals, exact_v, exact_b = operands(view, b)
    bw = b.float().numpy()
    cols = view.cols.numpy()
    if rows_of is None:
        def rows_of(idx):
            return bw[cols[idx]]
    kb, v = view.k_blk, view.vector_size
    plan = window_plan("test", view.win_ptr, split_blk, n_tile)
    out = np.zeros((plan.num_windows * v, bw.shape[1]), np.float32)
    sl = plan.slices(view.win_ptr)
    for w in np.unique(sl[:, 0]):
        groups = {}
        for _, _, first, count, _, rank, grp in sl[sl[:, 0] == w]:
            groups.setdefault((rank, grp), []).append((first * kb,
                                                       (first + count) * kb))
        block = {}
        for (rank, grp), ranges in sorted(groups.items()):
            part = np.zeros((v, bw.shape[1]), np.float32)
            hi = np.zeros_like(part)
            lo = np.zeros_like(part)
            ends = [e for _, e in ranges]
            for t, cnt, cut in ksteps(ranges[0][0], ranges[-1][1], ends):
                idx = np.arange(t, t + cnt)
                hi, lo = kstep(hi, lo, vals[idx], rows_of(idx), exact_v,
                               exact_b, split)
                if t + cnt == cut and cut in ends:  # a slice ends: fold it
                    part = (part + (hi + lo)).astype(np.float32)
                    hi, lo = np.zeros_like(part), np.zeros_like(part)
            block[rank] = part if rank not in block else block[rank] + part
        total = block[min(block)]
        for rank in sorted(block)[1:]:
            total = total + block[rank]
        out[w * v:(w + 1) * v] = total
    return out[:view.shape[0]]


def balanced_emulated(view, b, sched, run_blk, split=True):
    """C (M, N) as the balanced SpMM computes it over its run plan: the
    pieces of long windows (cut by the plan, or of more than TAIL_BLOCKS
    K-blocks) with the operands' tails, each k-step's big.big product added
    to fp64 sums, a chunk range's small products (lo) added where the range
    ends, a piece's sum rounded to fp32 (C or an edge entry), a window's
    entries summed in fp64."""
    vals, exact_v, exact_b = operands(view, b)
    bw = b.float().numpy()
    cols = view.cols.numpy()
    kb, v = view.k_blk, view.vector_size
    plan = run_plan("test", sched, view.num_windows, run_blk)
    run_ptr, pieces = plan.run_ptr.numpy(), plan.pieces.numpy()
    win = np.zeros((view.num_windows, v, bw.shape[1]), np.float64)
    zero = np.zeros((v, bw.shape[1]), np.float32)
    for r in range(plan.num_runs):
        ps = pieces[run_ptr[r]:run_ptr[r + 1]]
        ends = [(p[1] + p[2]) * kb for p in ps]
        acc, p = zero.astype(np.float64), 0

        def flush(upto):
            nonlocal acc, p
            while p < len(ps) and ends[p] <= upto:
                win[ps[p][0]] += acc.astype(np.float32)
                acc, p = np.zeros_like(acc), p + 1

        flush(ps[0][1] * kb)
        lo = zero
        for t, cnt, cut in ksteps(ps[0][1] * kb, ends[-1], ends):
            idx = np.arange(t, t + cnt)
            piece = ps[p]
            d, lo = kstep(zero, lo, vals[idx], bw[cols[idx]], exact_v,
                          exact_b, split,
                          tail=piece[3] >= 0 or piece[2] > TAIL_BLOCKS)
            acc += d
            if t + cnt == cut:  # the range ends: its small products
                acc += lo
                lo = zero
                flush(cut)
        flush(ends[-1])
    return win.astype(np.float32).reshape(-1, bw.shape[1])[:view.shape[0]]


def fp64(view, b):
    """A @ B in fp64 over the view's (dequantized) values."""
    vals = dequantized(view).vals.double().numpy()
    bw = b.double().numpy()
    v = view.vector_size
    out = np.zeros((view.num_windows * v, bw.shape[1]))
    rows = (np.repeat(view.block_win.numpy(), view.k_blk)[:, None] * v
            + np.arange(v))
    np.add.at(out, rows, vals[:, :, None] * bw[view.cols.numpy()][:, None])
    return out[:view.shape[0]]

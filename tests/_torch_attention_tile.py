"""The tensor-core chunk step of the fused attentions
(``csrc/attention_chunk.cuh``, ``Tile::step``) emulated in numpy, and the
run-carried attention's walk over its run plan (``csrc/attention_balanced.cu``):
pieces, chunks, edge entries and the combine tree.  Used by
``test_torch_attention_tile.py``.
"""

import pathlib
import re

import numpy as np
import torch

from _torch_spmm_tile import tf32_parts
from repro_torch.kernels._combine import run_plan

CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "kernels" / "csrc"
CHUNK = int(re.search(r"constexpr int kChunk = (\d+);",
                      (CSRC / "attention_chunk.cuh").read_text()).group(1))
NEG = np.float32(-np.finfo(np.float32).max)


def _mma(acc, a, b):
    """acc + a @ b as one mma: exact products, one fp32 rounding."""
    return (acc + a.astype(np.float64) @ b.astype(np.float64)).astype(
        np.float32)


def mma3(hi, lo, a, b, exact_a, exact_b, split=True):
    """hi, lo after ``Tile::product<true>`` of a (M, 8) and b (8, N):
    big.small and small.big into lo's mma chain (none with an exact
    operand), big.big from a zero accumulator added to hi by an fp32 add.
    ``split=False``: big.big alone (plain TF32)."""
    ab, as_, _ = tf32_parts(a, exact_a)
    bb, bs, _ = tf32_parts(b, exact_b)
    if split and bs is not None:
        lo = _mma(lo, ab, bs)
    if split and as_ is not None:
        lo = _mma(lo, as_, bb)
    return (hi + _mma(np.zeros_like(hi), ab, bb)).astype(np.float32), lo


class Tile:
    """One warp's state over a piece: the row maxima m, the sums l and
    acc^T (DV, V) in two parts (big.big, the small products)."""

    def __init__(self, v, dv):
        self.m = np.full(v, NEG, np.float32)
        self.l = np.zeros(v, np.float32)
        self.acc = np.zeros((dv, v), np.float32)
        self.acc_lo = np.zeros((dv, v), np.float32)

    def step(self, k_rows, q_rows, v_rows, keep, exact, split=True):
        """One chunk: k_rows (32, D) and v_rows (32, DV) (zero past the
        chunk), the window's Q rows (V, D), keep (32, V) the mask bytes of
        the chunk's vectors; ``exact``: bf16 operands."""
        d = k_rows.shape[1]
        d8 = -(-d // 8) * 8
        kp = np.zeros((CHUNK, d8), np.float32)
        kp[:, :d] = k_rows
        qp = np.zeros((d8, q_rows.shape[0]), np.float32)
        qp[:d] = q_rows.T
        hi = np.zeros((CHUNK, q_rows.shape[0]), np.float32)
        lo = np.zeros_like(hi)
        for ks in range(0, d8, 8):   # S^T = K Q^T, D in steps of 8
            hi, lo = mma3(hi, lo, kp[:, ks:ks + 8], qp[ks:ks + 8], exact,
                          exact, split)
        s = np.where(keep, (hi + lo).astype(np.float32), NEG)
        m_new = np.maximum(self.m, s.max(0))
        alpha = np.exp(self.m - m_new).astype(np.float32)
        p = (np.exp((s - m_new).astype(np.float32)).astype(np.float32)
             * keep).astype(np.float32)
        self.l = (self.l * alpha + p.sum(0, dtype=np.float32)).astype(
            np.float32)
        self.m = m_new
        self.acc = (self.acc * alpha).astype(np.float32)
        self.acc_lo = (self.acc_lo * alpha).astype(np.float32)
        vt = v_rows.T
        for ks in range(0, CHUNK, 8):   # acc^T += Vmat^T P^T, 8 vectors
            self.acc, self.acc_lo = mma3(self.acc, self.acc_lo,
                                         vt[:, ks:ks + 8], p[ks:ks + 8],
                                         exact, False, split)

    def value(self):
        """acc (V, DV), unnormalised."""
        return (self.acc + self.acc_lo).astype(np.float32).T


def chunks(t_lo, t_hi):
    """The chunks of a piece of vectors [t_lo, t_hi): (first, count)."""
    return [(t, min(CHUNK, t_hi - t)) for t in range(t_lo, t_hi, CHUNK)]


def _tree(plan, part, out, v):
    """The combine tree over the edge entries ``part`` ((acc, m, l) each),
    into ``out`` (W * V, DV) fp32: per group M = max m_e, weights
    float(exp_f32(m_e - M)), L and A summed in fp64."""
    meta = plan.tree.meta.numpy()
    upper = {}
    for li, (g0, ng) in enumerate(plan.tree.levels):
        src = part if li == 0 else upper
        nxt = {}
        for first, cnt, w, dst in meta[g0:g0 + ng]:
            ents = [src[e] for e in range(first, first + cnt)]
            mx = np.max([e[1] for e in ents], axis=0)
            wt = [np.exp((e[1] - mx).astype(np.float32)).astype(np.float64)
                  for e in ents]
            big_l = sum(e[2].astype(np.float64) * x for e, x in zip(ents, wt))
            big_a = sum(e[0].astype(np.float64) * x[:, None]
                        for e, x in zip(ents, wt))
            if dst < 0:
                out[w * v:(w + 1) * v] = (big_a.astype(np.float32) / np.maximum(
                    big_l.astype(np.float32), np.float32(1e-20))[:, None])
            else:
                nxt[dst] = (big_a, mx, big_l)
        upper = nxt


def balanced_emulated(blocked, q, k, v, sched, run_blk, scale, split=True):
    """out (M, DV) in fp32 as the run-carried attention computes it over
    its run plan: Q scaled in fp32 and rounded to its dtype, chunks of
    CHUNK from each piece's first vector, a piece's end storing its rows
    or its edge entry, the entries merged by the combine tree.  The bf16
    kernel's result is this output (of bf16 operands) rounded once."""
    exact = q.dtype == torch.bfloat16
    qs = (q.float() * scale).to(q.dtype).float().numpy()
    kw, vw = k.float().numpy(), v.float().numpy()
    cols, mask = blocked.cols.numpy(), blocked.mask.numpy()
    vsz, kb, w = blocked.vector_size, blocked.k_blk, blocked.num_windows
    dv = vw.shape[1]
    plan = run_plan("test", sched, w, run_blk)
    run_ptr, pieces = plan.run_ptr.numpy(), plan.pieces.numpy()
    qpad = np.zeros((w * vsz, qs.shape[1]), np.float32)
    qpad[:qs.shape[0]] = qs
    out = np.zeros((w * vsz, dv), np.float32)
    part = {}
    for r in range(plan.num_runs):
        for win, blk0, nblk, entry in pieces[run_ptr[r]:run_ptr[r + 1]]:
            tile = Tile(vsz, dv)
            for t, cnt in chunks(blk0 * kb, (blk0 + nblk) * kb):
                kr = np.zeros((CHUNK, kw.shape[1]), np.float32)
                vr = np.zeros((CHUNK, dv), np.float32)
                keep = np.zeros((CHUNK, vsz), bool)
                kr[:cnt] = kw[cols[t:t + cnt]]
                vr[:cnt] = vw[cols[t:t + cnt]]
                keep[:cnt] = mask[t:t + cnt]
                tile.step(kr, qpad[win * vsz:(win + 1) * vsz], vr, keep,
                          exact, split)
            if entry < 0:
                out[win * vsz:(win + 1) * vsz] = (
                    tile.value() / np.maximum(tile.l, np.float32(1e-20))[:, None])
            else:
                part[entry] = (tile.value(), tile.m, tile.l)
    _tree(plan, part, out, vsz)
    return out[:blocked.shape[0]]


def fp64(blocked, q, k, v, scale):
    """The attention over the blocked pattern in fp64, on Q scaled in fp32
    and rounded to its dtype (the kernel's operand)."""
    qs = (q.float() * scale).to(q.dtype).double().numpy()
    kw, vw = k.double().numpy(), v.double().numpy()
    vsz, kb = blocked.vector_size, blocked.k_blk
    cols, mask = blocked.cols.numpy(), blocked.mask.numpy()
    win = np.repeat(blocked.block_win.numpy(), kb)
    out = np.zeros((blocked.num_windows * vsz, vw.shape[1]))
    qpad = np.zeros((blocked.num_windows * vsz, qs.shape[1]))
    qpad[:qs.shape[0]] = qs
    for r in range(blocked.shape[0]):
        w, j = divmod(r, vsz)
        sel = (win == w) & mask[:, j]
        if sel.any():
            s = kw[cols[sel]] @ qpad[r]
            p = np.exp(s - s.max())
            out[r] = (p / p.sum()) @ vw[cols[sel]]
    return out[:blocked.shape[0]]

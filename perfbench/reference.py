"""The plain reference the cells' outputs are judged against.

Plain PyTorch in float64 (TF32 off), over the COO graph the benchmark
generated: no format, no plan, no kernel and nothing of the program.
Float64 and not float32: on the Amazon replica a float32 reference's own
rounding (atomic sums over hub rows, the softmax's cancellations in
AGNN's backward) reads 1e-5 to 3e-4 off float64 in a leaf's gradient,
as far off as the TF32 control, while the program reads 1e-6 or less;
against float64 the gap is the program's own.
Sparse products run over edge blocks (``index_add_`` of gathered rows),
so a Reddit-sized graph fits beside the rest; the backward of
``C = A B`` is ``dB = Aᵀ G``, the same edge blocks with rows and columns
swapped, and ``dA = (G Bᵀ)`` sampled on the edges.

The SGD-with-momentum update is written out (``m = 0.9 m + g``,
``p -= lr m``, from ``m = 0``), as the paper's training loop has it.

``rounding="tf32"`` puts the whole computation at the control's
precision, the next below the cells' float32: every operand of every
product (dense and sparse, forward and backward) is rounded to TF32 (10
mantissa bits, the tensor cores' TF32) before it is multiplied, and the
products are summed in float32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch

__all__ = ["RefGraph", "Rounding", "spmm", "matmul",
           "edge_dot", "row_softmax", "masked_nll", "train_readings",
           "no_tf32"]

EDGE_BLOCK = 1 << 21   # edges per gather: 2M x 128 fp32 = 1 GiB


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest."""
    xi = x.contiguous().view(torch.int32)
    return ((xi + 0x1000) & ~0x1FFF).view(torch.float32)


_ROUND = {"tf32": _tf32}


class Rounding:
    """``R(x)``: the value at the control's precision, and a gradient that
    is rounded on its way back; identity for the float32 reference."""

    def __init__(self, kind: Optional[str]):
        if kind is not None and kind not in _ROUND:
            raise ValueError(f"unknown rounding {kind!r}")
        self.kind = kind

    def value(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.kind is None else _ROUND[self.kind](x.float())

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind is None:
            return x
        return _RoundFn.apply(x, self)


class _RoundFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rnd):
        ctx.rnd = rnd
        return rnd.value(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.rnd.value(g), None


@dataclasses.dataclass
class RefGraph:
    """The COO graph on the device, int64 ids (``index_add_``'s)."""
    n: int
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor

    @classmethod
    def from_numpy(cls, n, rows, cols, vals, device) -> "RefGraph":
        t = lambda a, dt: torch.as_tensor(a).to(device=device, dtype=dt)
        return cls(n, t(rows, torch.int64), t(cols, torch.int64),
                   t(vals, torch.float32))

    def blocks(self):
        nnz = self.rows.shape[0]
        for s in range(0, nnz, EDGE_BLOCK):
            yield slice(s, min(s + EDGE_BLOCK, nnz))


def _agg(dst, src_idx, dst_idx, vals, h, g_graph, rnd: Rounding):
    """``dst[dst_idx[e]] += vals[e] * h[src_idx[e]]`` over edge blocks."""
    hv = rnd.value(h)
    vv = rnd.value(vals).to(dst.dtype)
    for b in g_graph.blocks():
        dst.index_add_(0, dst_idx[b], vv[b, None] * hv[src_idx[b]])
    return dst


class _Spmm(torch.autograd.Function):
    """``C = A⟨vals⟩ H`` with ``dH = Aᵀ⟨vals⟩ G`` and
    ``dvals[e] = <G[row e], H[col e]>``."""

    @staticmethod
    def forward(ctx, vals, h, graph, rnd):
        ctx.graph, ctx.rnd = graph, rnd
        ctx.save_for_backward(vals, h)
        out = torch.zeros(graph.n, h.shape[1], dtype=h.dtype,
                          device=h.device)
        return _agg(out, graph.cols, graph.rows, vals, h, graph, rnd)

    @staticmethod
    def backward(ctx, g):
        vals, h = ctx.saved_tensors
        graph, rnd = ctx.graph, ctx.rnd
        dvals = dh = None
        if ctx.needs_input_grad[1]:
            dh = torch.zeros_like(h)
            _agg(dh, graph.rows, graph.cols, vals, g, graph, rnd)
        if ctx.needs_input_grad[0]:
            dvals = _edge_dot_values(graph, rnd.value(g), rnd.value(h))
        return dvals, dh, None, None


def _edge_dot_values(graph: RefGraph, a, b) -> torch.Tensor:
    out = torch.empty(graph.rows.shape[0], dtype=a.dtype, device=a.device)
    for blk in graph.blocks():
        out[blk] = (a[graph.rows[blk]] * b[graph.cols[blk]]).sum(-1)
    return out


class _EdgeDot(torch.autograd.Function):
    """``s[e] = <Q[row e], K[col e]>`` (SDDMM on the pattern), with
    ``dQ = A⟨g⟩ K`` and ``dK = Aᵀ⟨g⟩ Q``."""

    @staticmethod
    def forward(ctx, q, k, graph, rnd):
        ctx.graph, ctx.rnd = graph, rnd
        ctx.save_for_backward(q, k)
        return _edge_dot_values(graph, rnd.value(q), rnd.value(k))

    @staticmethod
    def backward(ctx, g):
        q, k = ctx.saved_tensors
        graph, rnd = ctx.graph, ctx.rnd
        dq = torch.zeros_like(q)
        dk = torch.zeros_like(k)
        _agg(dq, graph.cols, graph.rows, g, k, graph, rnd)
        _agg(dk, graph.rows, graph.cols, g, q, graph, rnd)
        return dq, dk, None, None


def spmm(graph: RefGraph, vals, h, rnd: Rounding) -> torch.Tensor:
    return _Spmm.apply(vals, h, graph, rnd)


def edge_dot(graph: RefGraph, q, k, rnd: Rounding) -> torch.Tensor:
    return _EdgeDot.apply(q, k, graph, rnd)


def matmul(a, b, rnd: Rounding) -> torch.Tensor:
    return rnd(rnd(a) @ rnd(b))


def row_softmax(graph: RefGraph, s: torch.Tensor) -> torch.Tensor:
    """Softmax of the edge scores over each row's edges.  The row maximum
    only keeps ``exp`` in range and is taken without a gradient."""
    with torch.no_grad():
        m = torch.full((graph.n,), -math.inf, dtype=s.dtype, device=s.device)
        m = m.scatter_reduce(0, graph.rows, s, "amax")
    e = torch.exp(s - m[graph.rows])
    den = torch.zeros(graph.n, dtype=s.dtype, device=s.device).index_add(
        0, graph.rows, e)
    return e / torch.clamp(den[graph.rows], min=1e-20)


def masked_nll(logits, labels, mask) -> torch.Tensor:
    """Masked mean cross-entropy (``gnn_loss``'s)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)


@contextlib.contextmanager
def no_tf32():
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def train_readings(forward: Callable, params: Dict[str, torch.Tensor],
                   graph: RefGraph, x, labels, mask, *, lr: float,
                   momentum: float, steps: int, rnd: Rounding,
                   dtype: torch.dtype = torch.float32) -> dict:
    """``steps`` reference SGD-momentum steps from ``params`` (copied to
    ``dtype``, float32 but where a look at the reference's own rounding
    asks for float64): each step's loss, each leaf's first gradient norm,
    and each leaf's change after the steps; with each leaf's starting
    norm, its size and ``lr``, which the comparison's rule on the leaves
    that count reads."""
    p = {k: v.detach().to(dtype).clone().requires_grad_(True)
         for k, v in params.items()}
    p0 = {k: v.detach().clone() for k, v in p.items()}
    mom: Dict[str, torch.Tensor] = {}
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    xf = x.to(dtype)
    graph = dataclasses.replace(graph, vals=graph.vals.to(dtype))
    with no_tf32():
        for i in range(steps):
            loss = masked_nll(forward(p, graph, xf, rnd), labels,
                              mask.to(dtype))
            grads = torch.autograd.grad(loss, list(p.values()))
            losses.append(float(loss.detach()))
            with torch.no_grad():
                for (k, v), g in zip(p.items(), grads):
                    if i == 0:
                        grad_norms[k] = float(torch.linalg.vector_norm(g))
                    mom[k] = g.clone() if k not in mom else momentum * mom[k] + g
                    v -= lr * mom[k]
    change = {k: float(torch.linalg.vector_norm(p[k].detach() - p0[k]))
              for k in p}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change,
            "start_norms": {k: float(torch.linalg.vector_norm(v))
                            for k, v in p0.items()},
            "sizes": {k: v.numel() for k, v in p0.items()}, "lr": lr}

"""AdamW with optional block-quantized (int8) moment state.

Counterpart of ``repro.train.optimizer``, written out by hand rather than
taken from ``torch.optim.AdamW``, whose state, clipping and decay rule
are not the reference's: here the global-norm clip comes first, decay is
decoupled and applies only to leaves of two or more dimensions, and the
learning rate follows :func:`lr_schedule`.  The 8-bit state stores each
moment as int8 with an fp32 absmax scale per block of ``quant_block``
along the last dim; the update dequantizes, runs in fp32 and quantizes
again.

State layout (a dict, so checkpoints stay structural):
  {"m": tree, "v": tree, "m_scale": tree | None, "v_scale": tree | None,
   "count": 0-d int32}

:func:`adamw_update` writes the new parameters and state into the given
tensors, in place under ``torch.no_grad()``: the counterpart of the
reference's ``jax.jit(..., donate_argnums=0)``, which lets XLA reuse the
old state's buffers.

A sharded state (``DTensor`` leaves, ``distributed/elastic.py``) is
updated shard by shard: the update is elementwise, so each rank writes
its own shards; the global norm all-reduces each leaf's sum of squares.
An 8-bit block straddles two ranks where a leaf's last dim is sharded
and its local width is not a multiple of ``quant_block``: such a leaf
is updated on its last dim made whole (a redistribution of that leaf)
and cut back to its shards.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.elastic import whole
from repro_torch.pytree import leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "lr_schedule",
           "global_norm"]

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantize_state: bool = False   # int8 moments (8-bit Adam)
    quant_block: int = 256
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


# ----------------------------------------------------------- quantization --


def _quant_shape(shape: Tuple[int, ...], block: int) -> Tuple[int, ...]:
    last = max(shape[-1] if shape else 1, 1)
    return tuple(shape[:-1]) + (-(-last // block),)


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """``x`` with its last dim zero-padded to a multiple of ``block`` and
    split into ``(..., n_blocks, block)``."""
    pad = (-x.shape[-1]) % block
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(x.shape[:-1] + (-1, block))


def _quantize(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 -> (int8 of ``x``'s shape, fp32 scale per last-dim block)."""
    if x.dim() == 0:
        scale = torch.clamp(x.abs(), min=1e-12) / 127.0
        return torch.round(x / scale).to(torch.int8), scale
    last = x.shape[-1]
    xb = _blocks(x, block)
    scale = torch.clamp(xb.abs().amax(dim=-1, keepdim=True) / 127.0,
                        min=1e-12)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q.reshape(q.shape[:-2] + (-1,))[..., :last], scale[..., 0]


def _dequantize(q: torch.Tensor, scale: torch.Tensor, orig_last: int,
                block: int) -> torch.Tensor:
    if q.dim() == 0:
        return q.to(f32) * scale
    xb = _blocks(q, block).to(f32) * scale[..., None]
    return xb.reshape(xb.shape[:-2] + (-1,))[..., :orig_last]


# ------------------------------------------------------------------ adamw --


def adamw_init(params: Any, cfg: AdamWConfig) -> Dict:
    """Zero moments (int8 codes and fp32 scales under ``quantize_state``)
    beside each leaf of ``params``, on its device."""
    if cfg.quantize_state:
        def zeros_s(p):
            shape = () if p.dim() == 0 else _quant_shape(p.shape,
                                                         cfg.quant_block)
            return torch.zeros(shape, dtype=f32, device=p.device)

        zeros_q = lambda p: torch.zeros(p.shape, dtype=torch.int8,  # noqa: E731
                                        device=p.device)
        scales = (tree_map(zeros_s, params), tree_map(zeros_s, params))
    else:
        zeros_q = lambda p: torch.zeros(p.shape, dtype=f32,  # noqa: E731
                                        device=p.device)
        scales = (None, None)
    device = leaves(params)[0].device
    return {"m": tree_map(zeros_q, params), "v": tree_map(zeros_q, params),
            "m_scale": scales[0], "v_scale": scales[1],
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio`` (fp32)."""
    step = step.to(f32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf (fp32); a ``DTensor``
    leaf's local sums are all-reduced, so the norm is a plain tensor."""
    return torch.sqrt(sum(whole(torch.sum(torch.square(x.to(f32))))
                          for x in leaves(tree)))


def _update(g, p, m, v, ms, vs, *, clip, lr, bc1, bc2, cfg: AdamWConfig
            ) -> None:
    """One leaf's AdamW update on plain tensors, in place."""
    b1, b2 = cfg.b1, cfg.b2
    quant = ms is not None
    g = g.to(f32) * clip
    if quant:
        last = p.shape[-1] if p.dim() else 1
        m_f = _dequantize(m, ms, last, cfg.quant_block)
        v_f = _dequantize(v, vs, last, cfg.quant_block)
    else:
        m_f, v_f = m, v
    m_f = b1 * m_f + (1 - b1) * g
    v_f = b2 * v_f + (1 - b2) * g * g
    upd = (m_f / bc1) / (torch.sqrt(v_f / bc2) + cfg.eps)
    pf = p.to(f32)
    if p.dim() >= 2:
        upd = upd + cfg.weight_decay * pf
    p.copy_(pf - lr * upd)
    if quant:
        for store, scale, val in ((m, ms, m_f), (v, vs, v_f)):
            q, s = _quantize(val, cfg.quant_block)
            store.copy_(q)
            scale.copy_(s)
    else:
        m.copy_(m_f)
        v.copy_(v_f)


def _last_whole(t):
    """``t``'s placements with its last dim no longer split."""
    last = t.dim() - 1
    return [Replicate() if isinstance(pl, Shard) and pl.dim == last else pl
            for pl in t.placements]


def _update_sharded(g, p, m, v, ms, vs, *, cfg: AdamWConfig, **kw) -> None:
    """:func:`_update` on the shards of DTensor leaves (see the module
    docstring for the 8-bit blocks)."""
    tensors = (g, p, m, v, ms, vs)
    if ms is not None and p.dim() and p.to_local().shape[-1] != p.shape[-1] \
            and p.to_local().shape[-1] % cfg.quant_block:
        mesh = p.device_mesh
        work = [t.redistribute(mesh, _last_whole(t)) for t in tensors]
        _update(*(t.to_local() for t in work), cfg=cfg, **kw)
        for dst, src in zip(tensors[1:], work[1:]):
            dst.to_local().copy_(
                src.redistribute(mesh, dst.placements).to_local())
        return
    _update(*(None if t is None else t.to_local() for t in tensors),
            cfg=cfg, **kw)


@torch.no_grad()
def adamw_update(grads: Any, opt: Dict, params: Any, cfg: AdamWConfig
                 ) -> Tuple[Any, Dict, Dict]:
    """One AdamW step, in place: ``params`` and every tensor of ``opt``
    take their new values.  Returns ``(params, opt, metrics)`` with
    ``metrics = {"grad_norm", "lr"}`` (0-d tensors; nothing here waits
    for the device)."""
    count = opt["count"]
    count.add_(1)
    count = count.to_local() if isinstance(count, DTensor) else count
    lr = lr_schedule(cfg, count)

    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    kw = dict(clip=clip, lr=lr, bc1=1 - cfg.b1 ** count.to(f32),
              bc2=1 - cfg.b2 ** count.to(f32), cfg=cfg)
    quant = cfg.quantize_state

    leaves_p = leaves(params)
    n = len(leaves_p)
    leaves_ms = leaves(opt["m_scale"]) if quant else [None] * n
    leaves_vs = leaves(opt["v_scale"]) if quant else [None] * n
    for g, p, m, v, ms, vs in zip(leaves(grads), leaves_p, leaves(opt["m"]),
                                  leaves(opt["v"]), leaves_ms, leaves_vs):
        if isinstance(p, DTensor):
            _update_sharded(g, p, m, v, ms, vs, **kw)
        else:
            _update(g, p, m, v, ms, vs, **kw)
    return params, opt, {"grad_norm": gnorm, "lr": lr}

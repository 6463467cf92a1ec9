"""Gradient compression for the data-parallel reduction, with error
feedback.

Counterpart of ``repro.train.compression``.  Two compressors:

  int8   per-block absmax quantization of each whole leaf (blocks of
         ``block`` elements over the flattened leaf): 4x less traffic
  topk   magnitude top-k per leaf, ``k = topk_frac`` of its size

Both carry an error-feedback buffer: what compression dropped is added
back into the next step's gradient (Karimireddy et al., 2019).  The
functions are pure: ``compress`` maps a gradient tree to (compressed
tree, new error tree); the caller reduces the compressed form and then
decompresses.  Leaves are whole tensors, so on the training state's
stacked layer leaves a block or a top-k spans every layer, as in the
reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.core.quantize import dequantize_blocked, quantize_blocked

from repro_torch.pytree import leaves, tree_map

__all__ = ["CompressionConfig", "init_error", "compress_int8",
           "decompress_int8", "compress_topk", "decompress_topk",
           "compressed_bytes", "raw_bytes"]

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "int8"       # "int8" | "topk" | "none"
    block: int = 256
    topk_frac: float = 0.05


def init_error(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=f32,
                                          device=p.device), params)


def _map_pairs(fn, grads: Any, err: Any) -> Tuple[Any, Any]:
    """``fn(leaf, error)`` -> ``(compressed, new error)`` over the leaves;
    returns the two trees."""

    def walk(g, e):
        if isinstance(g, dict):
            pairs = {k: walk(v, e[k]) for k, v in g.items()}
            return ({k: c for k, (c, _) in pairs.items()},
                    {k: r for k, (_, r) in pairs.items()})
        if isinstance(g, (list, tuple)):
            pairs = [walk(v, e[i]) for i, v in enumerate(g)]
            return [c for c, _ in pairs], [r for _, r in pairs]
        if g is None:
            return None, None
        return fn(g, e)

    return walk(grads, err)


# ------------------------------------------------------------------- int8 --


def compress_int8(grads: Any, err: Any, cfg: CompressionConfig
                  ) -> Tuple[Any, Any]:
    """-> (``{"q", "scale"}`` per leaf, new error buffers)."""

    def leaf(g, e):
        corrected = g.to(f32) + e
        q, scale = quantize_blocked(corrected, cfg.block)
        g_hat = dequantize_blocked(q, scale, g.shape)
        return {"q": q, "scale": scale}, corrected - g_hat

    return _map_pairs(leaf, grads, err)


def decompress_int8(comp: Any, like: Any) -> Any:
    return tree_map(lambda g, c: dequantize_blocked(c["q"], c["scale"],
                                                    g.shape), like, comp)


# ------------------------------------------------------------------- topk --


def compress_topk(grads: Any, err: Any, cfg: CompressionConfig
                  ) -> Tuple[Any, Any]:
    """-> (``{"idx", "val"}`` per leaf, new error buffers)."""

    def leaf(g, e):
        corrected = (g.to(f32) + e).reshape(-1)
        k = max(int(corrected.shape[0] * cfg.topk_frac), 1)
        idx = torch.topk(corrected.abs(), k).indices
        sel = corrected[idx]
        g_hat = torch.zeros_like(corrected).index_put_((idx,), sel)
        return ({"idx": idx.to(torch.int32), "val": sel},
                (corrected - g_hat).reshape(g.shape))

    return _map_pairs(leaf, grads, err)


def decompress_topk(comp: Any, like: Any) -> Any:
    def leaf(g, c):
        flat = torch.zeros(g.numel(), dtype=f32, device=c["val"].device)
        return flat.index_put_((c["idx"].long(),), c["val"]).reshape(g.shape)

    return tree_map(leaf, like, comp)


# ---------------------------------------------------------------- account --


def raw_bytes(grads: Any) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(grads))


def compressed_bytes(comp: Any) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(comp))

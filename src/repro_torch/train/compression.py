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

A sharded gradient (``DTensor`` leaves, the sharded train step) goes
through :func:`roundtrip_sharded`: the compressed form and straight back,
on each rank's shard where no int8 block straddles two ranks, else on
the leaf made whole and cut back to its shards.  The result is the
one-device compressor's on the global leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.core.quantize import dequantize_blocked, quantize_blocked

from repro_torch.pytree import leaves, tree_map

__all__ = ["CompressionConfig", "init_error", "compress_int8",
           "decompress_int8", "compress_topk", "decompress_topk",
           "roundtrip_sharded", "compressed_bytes", "raw_bytes"]

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


def _int8_leaf(g, e, cfg: CompressionConfig):
    corrected = g.to(f32) + e
    q, scale = quantize_blocked(corrected, cfg.block)
    g_hat = dequantize_blocked(q, scale, g.shape)
    return {"q": q, "scale": scale}, corrected - g_hat


def _int8_restore(g, c):
    return dequantize_blocked(c["q"], c["scale"], g.shape)


def compress_int8(grads: Any, err: Any, cfg: CompressionConfig
                  ) -> Tuple[Any, Any]:
    """-> (``{"q", "scale"}`` per leaf, new error buffers)."""
    return _map_pairs(lambda g, e: _int8_leaf(g, e, cfg), grads, err)


def decompress_int8(comp: Any, like: Any) -> Any:
    return tree_map(_int8_restore, like, comp)


# ------------------------------------------------------------------- topk --


def _topk_leaf(g, e, cfg: CompressionConfig):
    corrected = (g.to(f32) + e).reshape(-1)
    k = max(int(corrected.shape[0] * cfg.topk_frac), 1)
    idx = torch.topk(corrected.abs(), k).indices
    sel = corrected[idx]
    g_hat = torch.zeros_like(corrected).index_put_((idx,), sel)
    return ({"idx": idx.to(torch.int32), "val": sel},
            (corrected - g_hat).reshape(g.shape))


def _topk_restore(g, c):
    flat = torch.zeros(g.numel(), dtype=f32, device=c["val"].device)
    return flat.index_put_((c["idx"].long(),), c["val"]).reshape(g.shape)


def compress_topk(grads: Any, err: Any, cfg: CompressionConfig
                  ) -> Tuple[Any, Any]:
    """-> (``{"idx", "val"}`` per leaf, new error buffers)."""
    return _map_pairs(lambda g, e: _topk_leaf(g, e, cfg), grads, err)


def decompress_topk(comp: Any, like: Any) -> Any:
    return tree_map(_topk_restore, like, comp)


# ---------------------------------------------------------------- sharded --

_CODECS = {"int8": (_int8_leaf, _int8_restore),
           "topk": (_topk_leaf, _topk_restore)}


def _on_shards(g, cfg: CompressionConfig) -> bool:
    """Whether ``g``'s compression is its shards' own: the leaf is not
    split at all, or (int8) it is split on its leading dim only, into
    shards of whole blocks, so each block lies in one rank's contiguous
    slice of the flattened leaf.  Top-k's ``k`` spans the whole leaf."""
    from torch.distributed.tensor import Shard

    dims = {p.dim for p in g.placements if isinstance(p, Shard)}
    if not dims:
        return True
    return (cfg.kind == "int8" and dims == {0}
            and g.to_local().numel() % cfg.block == 0)


def roundtrip_sharded(grads: Any, err: Any, cfg: CompressionConfig
                      ) -> Tuple[Any, Any]:
    """Compress and decompress a tree of ``DTensor`` gradients with error
    feedback (``err`` placed like them): -> (the decompressed gradients,
    the new error buffers), both placed as ``grads``.  A leaf whose
    int8 blocks or top-k straddle ranks is made whole (a collective over
    its mesh), compressed on every rank and cut back to its shards."""
    from torch.distributed.tensor import DTensor, Replicate

    squeeze, restore = _CODECS[cfg.kind]

    def leaf(g, e):
        mesh, pl = g.device_mesh, g.placements
        work = pl if _on_shards(g, cfg) else [Replicate()] * mesh.ndim
        gl = g.redistribute(mesh, work).to_local()
        comp, new_e = squeeze(gl, e.redistribute(mesh, work).to_local(), cfg)

        def back(t):
            return DTensor.from_local(t, mesh, work, run_check=False,
                                      shape=g.shape, stride=g.stride()
                                      ).redistribute(mesh, pl)

        return back(restore(gl, comp)), back(new_e)

    return _map_pairs(leaf, grads, err)


# ---------------------------------------------------------------- account --


def raw_bytes(grads: Any) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(grads))


def compressed_bytes(comp: Any) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(comp))

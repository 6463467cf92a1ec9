"""Sharding rules: logical axes -> mesh axes, fitted to actual shapes.

Counterpart of ``repro.distributed.sharding``.  The mesh is ``("data",
"model")`` (``launch/mesh.py``); the parallelism styles compose as the
reference's:

  DP / FSDP   batch over ("pod", "data"); every weight's *non-TP* matrix
              dim over "data" (resident weight memory is 1/|data| of the
              model; the forward gathers a layer's weights as it uses them)
  TP          heads / ffn-hidden / vocab over "model"
  EP          MoE expert dim over "model" (``layers.moe_ffn_ep``)
  SP          decode-cache sequence dim over "data" (``cache_shardings``)

A **spec** is the reference's ``PartitionSpec`` as a tuple: one entry per
leading tensor dim, each ``None``, a mesh axis name or a tuple of axis
names (the dim is split over their product, the first axis major), with
trailing ``None``s stripped.  :func:`placements` turns one into the
``DTensor`` placements of a ``DeviceMesh`` (``Shard(d)`` on every mesh
dim that splits tensor dim ``d``: a dim over ``("data", "model")`` is
split data-major, as JAX lays it out).

The rule functions read only the mesh's axis names and sizes: they take
a ``DeviceMesh`` or a plain ``{axis: size}`` mapping, and a leaf is
anything with a ``.shape`` (a tensor, a ``meta`` tensor).  Trees are the
nests of dicts and lists of :mod:`repro_torch.pytree`, walked in JAX's
order with JAX's key paths, so the specs of a stacked train state are the
reference's leaf for leaf.  Resolve them on the stacked ``(L, ...)``
layout (``models.lm.stack_layers``): ``logical_spec_for`` tells a
stacked dense MLP weight from an expert weight by path and rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.pytree import leaf_paths, unflatten

__all__ = [
    "LOGICAL_AXIS_RULES",
    "logical_spec_for",
    "fit_pspec",
    "serving_rules",
    "param_shardings",
    "shardings_like",
    "batch_pspec",
    "cache_shardings",
    "sparse_format_shardings",
    "sparse_operand_pspec",
    "axis_sizes",
    "placements",
    "local_shape",
    "shard_range",
    "spec_paths",
]

Spec = Tuple[Any, ...]

# logical axis -> mesh axes (a tuple means "shard over the product")
LOGICAL_AXIS_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "embed": ("data",),      # FSDP dim of every weight
    "vocab": ("model",),     # TP: vocab-sharded embedding + lm head
    "heads": ("model",),     # TP: attention heads / fused head*dim
    "ffn": ("model",),       # TP: MLP hidden
    "expert": ("model",),    # EP: MoE expert dim
    # SP: decode-cache sequence dim takes every axis batch didn't claim
    "kv_seq": ("pod", "data", "model"),
    # SP variant when kv-heads already take the model axis (cheaper comm)
    "kv_seq_dp": ("pod", "data"),
    "layers": (),            # stacked-layer leading dim: never sharded
}

# param leaf name -> logical axes of its *trailing* dims; leading dims
# beyond the rule (the stacked layer dim) are unsharded, and 1-D leaves
# not listed here are replicated.
_PARAM_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    "embed": ("vocab", "embed"),
    "lm_head": ("embed", "vocab"),
    "wq": ("embed", "heads"),
    "wk": ("embed", "heads"),
    "wv": ("embed", "heads"),
    "wo": ("heads", "embed"),
    # MLA: low-rank downs are data-sharded, ups are head-sharded
    "w_dq": ("embed", None),
    "w_uq": (None, "heads"),
    "w_dkv": ("embed", None),
    "w_uk": (None, "heads"),
    "w_uv": (None, "heads"),
    "w_gate": ("embed", "ffn"),
    "w_up": ("embed", "ffn"),
    "w_down": ("ffn", "embed"),
    # MoE router: replicated (tiny, and the EP dispatch needs it whole)
    "router": (None, None),
    "in_proj": ("embed", "ffn"),
    "out_proj": ("ffn", "embed"),
    "conv_w": (None, "ffn"),
    "conv_b": ("ffn",),
}

_MOE_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    "w_gate": ("expert", "embed", "ffn"),
    "w_up": ("expert", "embed", "ffn"),
    "w_down": ("expert", "ffn", "embed"),
}

# decode-cache leaf name -> logical axes (per cache layout in models/lm.py)
_CACHE_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    "k": (None, "batch", "kv_seq", "heads", None),       # (L,B,S,Hkv,D)
    "v": (None, "batch", "kv_seq", "heads", None),
    "ckv": (None, "batch", "kv_seq", None),              # MLA latent (L,B,S,C)
    "k_rope": (None, "batch", "kv_seq", None),
    "conv": (None, "batch", None, "ffn"),                # (L,B,W-1,conv_dim)
    "ssm": (None, "batch", "heads", None, None),         # (L,B,H,P,N)
    "memory": ("batch", None, None),                     # (B,S_src,D) enc-dec
}

MeshLike = Union[Mapping[str, int], Any]


def axis_sizes(mesh: MeshLike) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _canonical(parts: List[Any]) -> Spec:
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _entry(axes: Sequence[str]):
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def logical_spec_for(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    """Logical axes for a param leaf, from its "/"-joined key path and
    rank.  An expert weight is rank 3 unstacked or rank 4 stacked; a
    rank-3 ``w_gate`` under ``layers`` is a stacked dense MLP weight and
    takes the dense rule."""
    name = path.split("/")[-1]
    rule = _PARAM_RULES.get(name)
    if name in _MOE_RULES:
        stacked = path.startswith("layers") or "/layers/" in path
        if ndim >= 4 or (ndim == 3 and not stacked):
            rule = _MOE_RULES[name]
    if rule is None or ndim < len(rule):
        return (None,) * ndim
    return (None,) * (ndim - len(rule)) + tuple(rule)


def _mesh_axes_that_fit(dim: int, axes: Sequence[str], sizes: Dict[str, int],
                        used: set) -> Tuple[str, ...]:
    """Greedy prefix of ``axes`` present in the mesh whose product
    divides ``dim``."""
    picked = []
    prod = 1
    for a in axes:
        if a not in sizes or a in used:
            continue
        if dim % (prod * sizes[a]) == 0:
            picked.append(a)
            prod *= sizes[a]
    return tuple(picked)


def fit_pspec(logical: Sequence[Optional[str]], shape: Sequence[int],
              mesh: MeshLike,
              rules: Optional[Dict[str, Tuple[str, ...]]] = None) -> Spec:
    """Resolve logical axes to a spec valid for ``shape`` on ``mesh``:
    drops any mesh axis that does not divide its dim, and never gives one
    mesh axis to two dims of the same tensor."""
    rules = rules or LOGICAL_AXIS_RULES
    sizes = axis_sizes(mesh)
    used: set = set()
    parts = []
    for dim, name in zip(shape, logical):
        if name is None:
            parts.append(None)
            continue
        axes = _mesh_axes_that_fit(dim, rules.get(name, ()), sizes, used)
        used.update(axes)
        parts.append(_entry(axes))
    return _canonical(parts)


def _map_paths(fn, tree: Any) -> Any:
    """``fn(path, leaf)`` over the leaves of a nest, same structure."""
    flat = leaf_paths(tree)
    return unflatten(tree, [fn(path, leaf) for path, leaf in flat])


def serving_rules() -> Dict[str, Tuple[str, ...]]:
    """Weight rules for decode: TP only, no FSDP dim (one token cannot
    amortize a per-step weight gather)."""
    return dict(LOGICAL_AXIS_RULES, embed=())


def param_shardings(params: Any, mesh: MeshLike,
                    rules: Optional[Dict[str, Tuple[str, ...]]] = None) -> Any:
    """The spec of every leaf of a params nest (stacked layout)."""
    return _map_paths(
        lambda path, leaf: fit_pspec(
            logical_spec_for(path, len(leaf.shape)), leaf.shape, mesh, rules),
        params)


def _refit(spec: Spec, shape: Sequence[int], sizes: Dict[str, int]) -> Spec:
    if len(shape) == 0:
        return ()
    spec = tuple(spec[: len(shape)]) + (None,) * (len(shape) - len(spec))
    fitted = []
    for dim, entry in zip(shape, spec):
        keep, prod = [], 1
        for a in _entry_axes(entry):
            if dim % (prod * sizes[a]) == 0:
                keep.append(a)
                prod *= sizes[a]
        fitted.append(_entry(keep))
    return _canonical(fitted)


def shardings_like(specs: Any, target: Any, mesh: MeshLike) -> Any:
    """Param specs mapped onto a same-structure state (the AdamW moments,
    their 8-bit scales, the error buffers): every inherited axis is
    re-checked for divisibility against the *target* leaf's shape (the
    scales shrink the last dim); 0-d leaves replicate."""
    sizes = axis_sizes(mesh)
    flat_s = [s for _, s in spec_paths(specs)]
    flat_t = leaf_paths(target)
    if len(flat_s) != len(flat_t):
        raise ValueError(f"{len(flat_s)} specs for {len(flat_t)} leaves")
    return unflatten(target, [_refit(s, leaf.shape, sizes)
                              for s, (_, leaf) in zip(flat_s, flat_t)])


def spec_paths(specs: Any) -> List[Tuple[str, Spec]]:
    """``(path, spec)`` of a tree of specs, in :func:`leaf_paths` order
    (a spec is a tuple, which the walk would otherwise open)."""
    return leaf_paths(specs, is_leaf=lambda x: isinstance(x, tuple))


def batch_pspec(mesh: MeshLike, extra_dims: int = 1) -> Spec:
    """(B, ...) batch sharding: batch over every data-like axis present
    (the reference's ``P(bdim, None, ...)``, trailing Nones stripped)."""
    sizes = axis_sizes(mesh)
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    return (_entry(axes),) if axes else ()


def cache_shardings(cache: Any, mesh: MeshLike, *, batch: int) -> Any:
    """Specs of a decode-cache nest (path-aware, divisibility-fitted):
    the batch takes the data axes when it divides, the sequence dim every
    remaining axis ("kv_seq"); a K/V cache whose kv-heads divide the
    model axis gives heads "model" and the sequence only the data axes."""
    sizes = axis_sizes(mesh)

    def leaf_spec(path: str, leaf) -> Spec:
        shape = leaf.shape
        name = path.split("/")[-1]
        for part in reversed(path.split("/")):
            if part in _CACHE_RULES:
                name = part
                break
        rule = _CACHE_RULES.get(name)
        if rule is None or len(shape) < len(rule):
            return ()
        logical = (None,) * (len(shape) - len(rule)) + rule
        if name in ("k", "v") and "model" in sizes:
            if shape[len(shape) - 2] % sizes["model"] == 0:
                logical = logical[:-3] + ("kv_seq_dp", "heads", None)
        return fit_pspec(logical, shape, sizes)

    return _map_paths(leaf_spec, cache)


# ---------------------------------------------------------------------------
# Sparse-op shardings
# ---------------------------------------------------------------------------


def _format_leaves(node: Any, prefix: str, in_part: bool,
                   out: Dict[str, Spec]) -> None:
    from .sparse_shard import ShardedSchedule

    if isinstance(node, torch.Tensor):
        out[prefix] = ("data",) if in_part else ()
    elif dataclasses.is_dataclass(node):
        part = in_part or isinstance(node, ShardedSchedule)
        for f in dataclasses.fields(node):
            _format_leaves(getattr(node, f.name),
                           f"{prefix}/{f.name}" if prefix else f.name,
                           part, out)


def sparse_format_shardings(fmt: Any) -> Dict[str, Spec]:
    """Specs of the tensors of a sparse format (``MEBCRS``,
    ``BlockedMEBCRS``, ``ADPlan``, anything holding a
    ``ShardedSchedule``), keyed by dataclass field path
    (``"fwd/vals"``, ``"fwd_part/seg_win"``).

    The pattern metadata is tiny next to the dense operands and every
    kernel reads it whole, so it replicates; the arrays of a
    ``ShardedSchedule`` are stacked per rank and take ``("data",)``, each
    rank holding its own sub-schedule.  (``mesh`` is accepted for the
    reference's signature; the specs do not depend on it.)"""
    out: Dict[str, Spec] = {}
    _format_leaves(fmt, "", False, out)
    return out


def sparse_operand_pspec(mesh: MeshLike, *, batched: bool = False,
                         heads_over_model: bool = False) -> Spec:
    """Spec of the dense operand of a sparse op: rows (the contracted K
    dim) stay whole, the feature dim takes "model", an optional leading
    head/batch dim the data axes; ``heads_over_model`` is the sharded
    sparse ops' placement (heads over "model", the rest replicated)."""
    sizes = axis_sizes(mesh)
    feat = "model" if "model" in sizes else None
    if heads_over_model:
        return (feat,) if (batched and feat) else ()
    if not batched:
        return _canonical([None, feat])
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    return _canonical([_entry(axes), None, feat])


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------


def placements(spec: Spec, mesh) -> Tuple[Any, ...]:
    """The DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``),
    one per mesh dim: ``Shard(d)`` where the mesh dim splits tensor dim
    ``d``, ``Replicate()`` elsewhere.  A dim split over several axes must
    name them in mesh order (DTensor splits it major-to-minor along the
    mesh dims, which is JAX's layout of such a spec)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def shard_range(t, dim: int) -> Tuple[int, int, List[int]]:
    """``(start, stop, mesh dims)`` of this rank's shard of dim ``dim``
    of the DTensor ``t``: DTensor splits a dim over its mesh dims major
    to minor, in even chunks (the rules split only dims they divide; an
    uneven split raises)."""
    from torch.distributed.tensor import Shard

    mesh = t.device_mesh
    start, n, dims = 0, t.shape[dim], []
    for i, pl in enumerate(t.placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            if n % mesh.size(i):
                raise ValueError(f"dim {dim} of {t.shape[dim]} split "
                                 f"unevenly over mesh dim {i}")
            n //= mesh.size(i)
            start += mesh.get_local_rank(i) * n
            dims.append(i)
    return start, start + n, dims


def local_shape(shape: Sequence[int], spec: Spec, mesh: MeshLike
                ) -> Tuple[int, ...]:
    """The per-rank shard shape of a ``shape`` tensor laid out by ``spec``
    (the rules only split dims the axes divide)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in _entry_axes(entry):
            out[d] //= sizes[a]
    return tuple(out)

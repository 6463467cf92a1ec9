"""Nests of dicts and lists of tensors, walked as JAX walks its pytrees.

The training state is such a nest.  Its leaves are visited in JAX's
order (dict keys sorted, list items in order, ``None`` an empty subtree),
and named by JAX's key paths (``"params/layers/attn/wq"``), so sums over
the leaves and the checkpoint manifest match the reference's.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

__all__ = ["leaf_paths", "leaves", "tree_map", "unflatten"]


def leaf_paths(tree: Any, prefix: str = "",
               is_leaf: Optional[Callable[[Any], bool]] = None
               ) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` for every leaf, in JAX's flattening order; a node
    for which ``is_leaf`` is true is a leaf (JAX's ``is_leaf``)."""
    if tree is None:
        return []
    if is_leaf is not None and is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, val in items:
        out.extend(leaf_paths(val, f"{prefix}/{key}" if prefix else key,
                              is_leaf))
    return out


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaf_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure); ``None`` in ``tree`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def unflatten(like: Any, flat: List[Any]) -> Any:
    """A tree of ``like``'s structure holding ``flat`` (in the order of
    :func:`leaves` of ``like``)."""
    it = iter(flat)

    def build(tree):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        if isinstance(tree, (list, tuple)):
            return [build(v) for v in tree]
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out

"""Trees of tensors: nested dicts, lists / tuples and NamedTuples (a
ClusteredTensor, the optimizer's AdamState) with tensors at the leaves.

Flattening follows `jax.tree_util` so that paths, order and leaves are the
JAX package's: dict keys sorted, a NamedTuple's fields in declaration order,
`None` an empty subtree. A path is spelled as `jax.tree_util.keystr` spells
it: `['blocks']['attn']['wq'].codes`, `.m['embed']`, `[0]`. The optimizer
maps over trees with `tree_map`, the checkpoint stores leaves by path.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple


def dict_key(k: Any) -> str:
    """A dict key as `jax.tree_util.keystr` spells it: `['wq']`."""
    return f"[{k!r}]"


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node: Any) -> List[Tuple[str, Any]]:
    """(key spelling, child) pairs of an inner node; [] for a leaf."""
    if isinstance(node, dict):
        return [(dict_key(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields
                if not isinstance(getattr(node, f), (int, str))]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return []


def _is_inner(node: Any) -> bool:
    return isinstance(node, (dict, list, tuple))


def flatten_with_paths(tree: Any, prefix: str = "", *,
                       is_leaf: Optional[Callable[[Any], bool]] = None
                       ) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in the order of `jax.tree_util.tree_flatten_with_path`.
    A NamedTuple's plain-int fields (a ClusteredTensor's `nbits`) are static
    data, not leaves, as in the JAX package's pytree registration. A node
    for which `is_leaf` holds is one leaf, as with jax's `is_leaf`."""
    if is_leaf is not None and is_leaf(tree):
        return [(prefix, tree)]
    if tree is None:
        return []
    if not _is_inner(tree):
        return [(prefix, tree)]
    return [pl for key, child in _children(tree)
            for pl in flatten_with_paths(child, prefix + key, is_leaf=is_leaf)]


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(like: Any, new_leaves) -> Any:
    """`like`'s structure with its leaves replaced, in flattening order, by
    `new_leaves`."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if not _is_inner(node):
            return next(it)
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(**{f: (getattr(node, f) if isinstance(getattr(node, f), (int, str))
                                     else build(getattr(node, f))) for f in node._fields})
        return type(node)(build(c) for c in node)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the structure holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn(leaf, *leaves of rest at the same path)` over every leaf of `tree`;
    `rest` must have `tree`'s structure."""
    others = [leaves(r) for r in rest]
    mine = leaves(tree)
    if any(len(o) != len(mine) for o in others):
        raise ValueError("tree_map: the trees' structures differ")
    return unflatten(tree, [fn(x, *(o[i] for o in others)) for i, x in enumerate(mine)])

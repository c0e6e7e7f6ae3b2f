"""Nested containers of tensors ("trees"), walked in JAX's pytree order.

The parameter trees are dicts of dicts, the optimizer state a NamedTuple of
such trees.  JAX flattens a dict in sorted key order and a NamedTuple (or
tuple, list) in field order, and drops ``None``; its ``keystr`` names a
leaf by its path, ``['layers']['wq']`` for dict keys, ``.mu`` for a
NamedTuple field and ``[0]`` for a sequence index.  The checkpoint format
(`repro_torch.checkpoint.store`) keys its arrays by those names.

``is_leaf``, where a walker takes it, stops the walk at any subtree it
accepts (``None`` included), as JAX's ``is_leaf`` does: the logical-axis
trees (`repro_torch.distributed.shardings`) hold their leaves as tuples of
axis names.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

IsLeaf = Optional[Callable[[Any], bool]]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_paths(tree, prefix: str = "", is_leaf: IsLeaf = None) -> List[Tuple[str, Any]]:
    """``(keystr path, leaf)`` pairs in JAX's flattening order."""
    if is_leaf is not None and is_leaf(tree):
        return [(prefix, tree)]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in
                leaves_with_paths(tree[k], f"{prefix}[{k!r}]", is_leaf)]
    if _is_namedtuple(tree):
        return [pair for name in tree._fields for pair in
                leaves_with_paths(getattr(tree, name), f"{prefix}.{name}", is_leaf)]
    if isinstance(tree, (tuple, list)):
        return [pair for i, x in enumerate(tree) for pair in
                leaves_with_paths(x, f"{prefix}[{i}]", is_leaf)]
    return [(prefix, tree)]


def leaves(tree, is_leaf: IsLeaf = None) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree, is_leaf=is_leaf)]


def leaves_up_to(struct, tree, is_leaf: IsLeaf = None) -> list:
    """The subtrees of ``tree`` found where ``struct`` has its leaves, in
    :func:`leaves` order (JAX's ``flatten_up_to``): ``tree`` has
    ``struct``'s containers down to them."""
    if is_leaf is not None and is_leaf(struct):
        return [tree]
    if struct is None:
        return []
    if isinstance(struct, dict):
        return [x for k in sorted(struct) for x in leaves_up_to(struct[k], tree[k], is_leaf)]
    if isinstance(struct, (tuple, list)):  # a NamedTuple by position
        return [x for i, s in enumerate(struct) for x in leaves_up_to(s, tree[i], is_leaf)]
    return [tree]


def unflatten_like(like, values, is_leaf: IsLeaf = None):
    """A tree of ``like``'s structure holding ``values`` (an iterable, in
    :func:`leaves` order) in place of its leaves."""
    it = iter(values)

    def build(t):
        if is_leaf is not None and is_leaf(t):
            return next(it)
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}  # keep the caller's key order
        if _is_namedtuple(t):
            return type(t)(*(build(getattr(t, name)) for name in t._fields))
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree, *rest, is_leaf: IsLeaf = None):
    """``fn`` over the leaves of ``tree`` and the matching subtrees of the
    trees in ``rest`` (of ``tree``'s structure down to its leaves), leaf by
    leaf."""
    others = [leaves_up_to(tree, r, is_leaf) for r in rest]
    return unflatten_like(tree, (fn(x, *(o[i] for o in others))
                                 for i, x in enumerate(leaves(tree, is_leaf))), is_leaf)

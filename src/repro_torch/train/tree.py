"""Nested containers of tensors ("trees"), walked in JAX's pytree order.

The parameter trees are dicts of dicts, the optimizer state a NamedTuple of
such trees.  JAX flattens a dict in sorted key order and a NamedTuple (or
tuple, list) in field order, and drops ``None``; its ``keystr`` names a
leaf by its path, ``['layers']['wq']`` for dict keys, ``.mu`` for a
NamedTuple field and ``[0]`` for a sequence index.  The checkpoint format
(`repro_torch.checkpoint.store`) keys its arrays by those names.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(keystr path, leaf)`` pairs in JAX's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in
                leaves_with_paths(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [pair for name in tree._fields for pair in
                leaves_with_paths(getattr(tree, name), f"{prefix}.{name}")]
    if isinstance(tree, (tuple, list)):
        return [pair for i, x in enumerate(tree) for pair in
                leaves_with_paths(x, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten_like(like, values):
    """A tree of ``like``'s structure holding ``values`` (an iterable, in
    :func:`leaves` order) in place of its leaves."""
    it = iter(values)

    def build(t):
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


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees of the same
    structure in ``rest``, leaf by leaf."""
    others = [leaves(r) for r in rest]
    return unflatten_like(tree, (fn(x, *(o[i] for o in others))
                                 for i, x in enumerate(leaves(tree))))

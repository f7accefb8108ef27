"""Tree helpers of the port: one flattening order for the checkpoints, the
converters, the models and the optimizers.

Trees are flattened as the reference's pytrees flatten: ``None`` holds no
leaf; a dict's entries go in key order (``['key']``); a tuple's or list's in
position (``[i]``); a dataclass's or named tuple's fields in declaration
order (``.field``), a dataclass listing only the fields named by its
``tree_fields`` attribute when it has one; anything else is a leaf.  The
recursions are module-level functions: a nested recursive function would
hold itself, and through its cell the leaves, in a reference cycle that only
the garbage collector frees, keeping a step's tensors alive.
"""

from __future__ import annotations

import dataclasses

__all__ = ["flatten_up_to", "tree_flatten_with_names", "tree_leaves", "tree_map",
           "tree_unflatten"]


def _children(node):
    """``[(path suffix, child), ...]`` of an inner node, or None for a leaf."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(f"[{i}]", x) for i, x in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        names = getattr(node, "tree_fields", None)
        if names is None:
            names = [f.name for f in dataclasses.fields(node)]
        return [(f".{f}", getattr(node, f)) for f in names]
    return None


def _walk(node, path: str, names: list, leaves: list) -> None:
    kids = _children(node)
    if kids is None:
        names.append(path)
        leaves.append(node)
        return
    for suffix, child in kids:
        _walk(child, path + suffix, names, leaves)


def tree_flatten_with_names(tree) -> tuple[list[str], list]:
    """``(names, leaves)`` of ``tree`` in flattening order (leaves as given)."""
    names, leaves = [], []
    _walk(tree, "", names, leaves)
    return names, leaves


def tree_leaves(tree) -> list:
    return tree_flatten_with_names(tree)[1]


def _build(node, it):
    kids = _children(node)
    if kids is None:
        return next(it)
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return node._replace(**{f: _build(getattr(node, f), it) for f in node._fields})
    if isinstance(node, (tuple, list)):
        return type(node)(_build(x, it) for x in node)
    return dataclasses.replace(node, **{s[1:]: _build(c, it) for s, c in kids})


def tree_unflatten(skeleton, leaves):
    """``skeleton``'s structure with its leaves replaced, in order, by
    ``leaves``."""
    it = iter(leaves)
    out = _build(skeleton, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` of each leaf of ``tree`` (and the leaves of ``rest`` at the
    same positions), in ``tree``'s structure."""
    cols = [tree_leaves(tree)] + [tree_leaves(r) for r in rest]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*cols)])


def flatten_up_to(skeleton, tree) -> list:
    """``tree``'s entries at the leaf positions of the dict tree ``skeleton``,
    in its order (whatever they are: states, tuples, None)."""
    if isinstance(skeleton, dict):
        return [x for k in sorted(skeleton) for x in flatten_up_to(skeleton[k], tree[k])]
    return [tree]

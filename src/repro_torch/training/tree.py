"""Flattening of the port's parameter and optimizer trees: nested dicts
and lists of tensors, walked in ``jax.tree.leaves`` order (dict keys
sorted, lists in order), so that sums over leaves add in the reference's
order and a leaf's index names the same array on both sides."""
from __future__ import annotations


def flatten(tree, prefix: str = "") -> tuple[list[str], list]:
    """(key paths, leaves) of ``tree``; an empty dict or list has none."""
    if isinstance(tree, dict):
        items = [(f"{prefix}/{k}", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"{prefix}/{i}", v) for i, v in enumerate(tree)]
    else:
        return [prefix], [tree]
    paths, leaves = [], []
    for path, sub in items:
        p, v = flatten(sub, path)
        paths += p
        leaves += v
    return paths, leaves


def leaves(tree) -> list:
    return flatten(tree)[1]


def unflatten(template, new_leaves):
    """A tree of ``template``'s structure holding ``new_leaves`` in
    ``flatten`` order."""
    new_leaves = list(new_leaves)
    n = len(leaves(template))
    if len(new_leaves) != n:
        raise ValueError(f"unflatten: {len(new_leaves)} leaves for a "
                         f"template of {n}")
    return _build(template, iter(new_leaves))


def _build(t, it):
    # a module-level function, not a closure over ``it``: a recursive
    # closure is a reference cycle, and the cycle would keep the leaves
    # (a step's gradients) alive until the cyclic collector ran
    if isinstance(t, dict):
        built = {k: _build(t[k], it) for k in sorted(t)}
        return {k: built[k] for k in t}           # the template's key order
    if isinstance(t, (list, tuple)):
        return type(t)([_build(v, it) for v in t])
    return next(it)


def tree_map(fn, tree):
    return unflatten(tree, [fn(x) for x in leaves(tree)])

"""Trees of tensors: nested dicts, lists and tuples with anything else as
a leaf.  Dict keys are walked in sorted order, as the JAX package's tree
walk does, so leaf order (and each leaf's ``/``-joined path) is the same in
both packages: checkpoints carry across, and the optimizer sums its leaves
in the reference's order."""

from __future__ import annotations

from typing import Any, Callable


def flatten_with_paths(tree, prefix=()) -> tuple[list[str], list]:
    """(paths, leaves): ``"opt/m/embed"``-style paths, in walk order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return ["/".join(prefix)], [tree]
    paths, leaves = [], []
    for name, sub in items:
        p, lv = flatten_with_paths(sub, prefix + (name,))
        paths += p
        leaves += lv
    return paths, leaves


def leaves(tree) -> list:
    return flatten_with_paths(tree)[1]


def map_leaves(fn: Callable, tree) -> Any:
    """The tree with every leaf replaced by ``fn(leaf)``, in walk order."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v) for v in tree)
    return fn(tree)


def unflatten_like(tree, new_leaves) -> Any:
    """``tree``'s structure with ``new_leaves`` (walk order) as leaves."""
    it = iter(new_leaves)
    return map_leaves(lambda _: next(it), tree)

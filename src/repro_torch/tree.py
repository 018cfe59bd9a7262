"""The port's pytrees: params, grads and optimizer states are nested dicts
of tensors, walked in the dicts' own key order."""
from __future__ import annotations


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure -> a tree of its
    results."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_items(tree, prefix: str = ""):
    """(path, leaf) pairs, depth first; a path joins the keys with '/'."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def tree_leaves(tree):
    """The leaves, depth first."""
    for _, leaf in tree_items(tree):
        yield leaf


def layer_slices(x):
    """Index expressions that cut a leaf into its layers: one per layer of
    a stacked leaf (>= 3 dims, layers first), else the whole leaf."""
    return range(x.shape[0]) if x.dim() >= 3 else (Ellipsis,)

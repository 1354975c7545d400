"""Nested parameter trees in the JAX package's leaf order.

The JAX package flattens its pytrees with ``jax.tree.leaves``: dict keys in
sorted order, lists and tuples (NamedTuples included) in order, ``None``
holding no leaf.  Checkpoints store leaves in that order
(train/checkpoint.py), so the port's adapters, parameter trees and
optimizer states flatten the same way here.  A leaf is a tensor or a
numpy array; a :class:`~vietnamese_qa_system_tpu_torch.train.optim.QTensor`
contributes its codes then its scales, as its JAX pytree node does.
"""

from __future__ import annotations


def _children(node):
    """(kind, children) of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return "dict", [node[k] for k in sorted(node)]
    if hasattr(node, "tree_children"):
        return "custom", node.tree_children()
    if isinstance(node, (list, tuple)):
        return "seq", list(node)
    return None


def tree_leaves(tree, is_leaf=None) -> list:
    """Every leaf of ``tree`` in the JAX package's order; ``is_leaf``
    stops the descent at the nodes it accepts."""
    if tree is None:
        return []
    kids = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if kids is None:
        return [tree]
    return [leaf for child in kids[1] for leaf in tree_leaves(child, is_leaf)]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` in order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            return next(it)
        kind, children = kids
        built = [build(c) for c in children]
        if kind == "dict":
            return dict(zip(sorted(node), built))
        if kind == "custom":
            return node.tree_rebuild(built)
        if hasattr(node, "_fields"):  # NamedTuple
            return type(node)(*built)
        return type(node)(built)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure)."""
    columns = [tree_leaves(t) for t in (tree, *rest)]
    if any(len(c) != len(columns[0]) for c in columns):
        raise ValueError("trees differ in their number of leaves")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*columns)])


def nest(flat: dict) -> dict:
    """{"blocks.0.attn.wq.w": leaf, ...} -> nested dicts, with every dict
    whose keys are all digits turned into a list (the JAX package keeps
    its blocks as a list)."""
    root: dict = {}
    for name, leaf in flat.items():
        node = root
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        out = {k: lists(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[k] for k in sorted(out, key=int)]
        return out

    return lists(root)


def flatten_paths(tree, prefix: str = "") -> dict:
    """Inverse of :func:`nest`: {dotted path: leaf}."""
    out = {}
    if isinstance(tree, dict):
        for key, sub in tree.items():
            out.update(flatten_paths(sub, f"{prefix}{key}."))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            out.update(flatten_paths(sub, f"{prefix}{i}."))
    elif tree is not None:
        out[prefix[:-1]] = tree
    return out

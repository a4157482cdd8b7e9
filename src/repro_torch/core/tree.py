"""Nested-dict parameter trees (the port's stand-in for JAX pytrees).

A tree is a ``dict`` of trees or leaves.  Leaves are visited in sorted key
order, the order ``jax.tree_util`` gives a dict, so a tree carried across
from the reference lines up leaf for leaf.  A leaf's path is its keys
joined by ``/`` (``"layers/w_z"``); the round RNG tags per-leaf draws with
it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple

Tree = Any


def items(tree: Tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs in sorted key order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from items(tree[key], f"{prefix}{key}/")
    else:
        yield prefix[:-1], tree


def leaves(tree: Tree) -> List[Any]:
    return [leaf for _, leaf in items(tree)]


def get(tree: Tree, path: str) -> Any:
    """The leaf at ``path``; the empty path is a bare leaf itself."""
    if not path:
        return tree
    for key in path.split("/"):
        tree = tree[key]
    return tree


def release(tree: Tree, path: str) -> None:
    """Drop the leaf at ``path`` (it becomes None), so its memory goes as
    soon as nothing else holds it."""
    *parents, last = path.split("/")
    for key in parents:
        tree = tree[key]
    tree[last] = None


def from_items(pairs) -> Dict:
    """The tree holding each ``(path, leaf)`` of ``pairs``."""
    out: Dict = {}
    for path, leaf in pairs:
        *parents, last = path.split("/")
        node = out
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


def map_leaves(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` applied leaf-wise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)

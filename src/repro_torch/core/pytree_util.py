"""Tree <-> flat-vector plumbing (port of ``repro.core.pytree_util``).

DASHA's math lives on flat d-vectors; model parameters are trees
(:mod:`repro_torch.core.tree`).  ``ravel`` concatenates the leaves in the
tree's leaf order, in their common dtype, as ``jax.flatten_util.
ravel_pytree`` does.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Tuple

import torch

from repro_torch.core import tree as _tree

Tree = Any


def ravel(tree: Tree) -> Tuple[torch.Tensor, Callable[[torch.Tensor], Tree]]:
    """(flat, unravel): the leaves flattened and concatenated in leaf
    order (promoted to their common dtype), and the function that cuts a
    flat vector back into the tree, each leaf in its own dtype."""
    items = list(_tree.items(tree))
    leaves = [leaf for _, leaf in items]
    dtype = functools.reduce(torch.promote_types,
                             [leaf.dtype for leaf in leaves])
    flat = torch.cat([leaf.reshape(-1).to(dtype) for leaf in leaves])
    sizes = [leaf.numel() for leaf in leaves]

    def unravel(vec: torch.Tensor) -> Tree:
        parts = torch.split(vec, sizes)
        out = [(path, part.reshape(leaf.shape).to(leaf.dtype))
               for (path, leaf), part in zip(items, parts)]
        if len(out) == 1 and out[0][0] == "":
            return out[0][1]
        return _tree.from_items(out)

    return flat, unravel


def tree_dim(tree: Tree) -> int:
    return sum(int(leaf.numel()) for leaf in _tree.leaves(tree))


def tree_zeros_like_flat(tree: Tree) -> torch.Tensor:
    """A float32 zero vector of the tree's dimension, on its first leaf's
    device."""
    leaves = _tree.leaves(tree)
    return torch.zeros((tree_dim(tree),), dtype=torch.float32,
                       device=leaves[0].device)

"""Parameter-tree adapter of the compression subsystem (port of
``repro.compress.treelevel``).

Model training thinks in parameter trees whose leaves carry a leading node
axis.  This module bridges them to the compressors:

* :func:`leaf_keys`          — per-leaf seeds or generators (API only);
* :func:`leaf_mask` / :func:`tree_masks` — the per-leaf (n, *shape) {0,1}
  masks and the unbiasedness scale; :func:`leaf_support` — the same draw
  as the kernels read it (bool, one row for ``shared_coords``);
* :func:`bernoulli_compress` — tree-level independent / shared_coords;
* :func:`permk_compress`     — tree-level PermK with its exact aggregate;
* :func:`fused_leaf_updates` / :func:`fused_tree_update` — the CUDA kernel
  path for every mode x variant (dasha | mvr).

Each takes ``lanes=True`` for a sweep's lane trees, whose leaves carry a
leading (G,) lane axis before the node axis: every lane shares the
round's one draw per leaf, and a kernel launch covers all G * n rows.

Every mask comes from the round's :class:`repro_torch.core.rng.RoundRandom`
(one generator per leaf, tagged with the leaf's path, or the injected
``Draws.masks``), so the dense and fused paths see the same randomness.
"""
from __future__ import annotations

from typing import Any, Iterator, Optional, Tuple

import torch

from repro_torch.compress.plan import draw_mask, permk_owner
from repro_torch.core import tree
from repro_torch.core.rng import derive_seed, generator
from repro_torch.kernels import ops as kops

Tree = Any


def leaf_keys(seed: int, per_leaf: Tree, *, device=None) -> Tree:
    """One seed per leaf of ``per_leaf``, in its structure:
    ``derive_seed(seed, path)``; with ``device``, a ``torch.Generator`` on
    it seeded so.  The port's counterpart of the reference's
    ``split(key, n_leaves)`` fanout, kept for its API: the trainer itself
    draws each leaf's mask from the round's
    :class:`repro_torch.core.rng.RoundRandom` (``leaf_mask``, seeded by
    ``(seed, t, "mask", path)``), and a registry compressor's per-leaf plans
    from ``RoundRandom.leaf_plan``."""
    def one(path):
        if device is None:
            return derive_seed(seed, path)
        return generator(device, seed, path)
    return tree.from_items((path, one(path))
                           for path, _ in tree.items(per_leaf)) \
        if isinstance(per_leaf, dict) else one("")


def _node_ids(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[0]
    return torch.arange(n, device=x.device).reshape((n,) + (1,) *
                                                    (x.dim() - 1))


def _leaf_draw(path: str, x: torch.Tensor, *, mode: str, p: float, n: int,
               lanes: bool = False):
    """(generator device, draw) of leaf ``x``'s support before its float
    conversion: bool, (n, *shape), or (1, *shape) for ``shared_coords``.
    ``lanes``: ``x`` is (G, n, *shape), a sweep's G lanes, which share the
    one draw of lane 0's shape (as G sequential runs from one seed draw
    the same mask)."""
    if lanes:
        x = x[0]
    if mode == "permk":
        # the scale is the tree-wide n: a leaf whose node axis disagrees
        # would be silently mis-scaled (a biased estimator)
        if x.shape[0] != n:
            raise ValueError(f"permk leaf {path!r} has node axis "
                             f"{x.shape[0]} != n={n}")

        def draw(gen):
            owner = permk_owner(gen, x.shape[1:], n, device=x.device)
            return owner[None] == _node_ids(x)
        return "cpu", draw
    if mode == "shared_coords":
        return x.device, lambda gen: draw_mask(gen, x.shape[1:], p)[None]
    if mode != "independent":
        raise ValueError(f"unknown tree compression mode {mode!r}")
    return x.device, lambda gen: draw_mask(gen, x.shape, p)


def leaf_mask(rnd, path: str, x: torch.Tensor, *, mode: str, p: float,
              n: int, lanes: bool = False) -> torch.Tensor:
    """The (n, *shape) float32 {0,1} mask of leaf ``x`` (shape (n, ...),
    or (G, n, ...) with ``lanes``, whose lanes share the mask).

    ``permk``: node i keeps the coordinates it owns under the leaf's
    cyclic-shift partition; ``shared_coords``: one Bernoulli(p) mask per
    leaf, the same for every node; ``independent``: Bernoulli(p) per node
    and coordinate."""
    dev, draw = _leaf_draw(path, x, mode=mode, p=p, n=n, lanes=lanes)
    shape = x.shape[1:] if lanes else x.shape
    return rnd.leaf_mask(path, dev, lambda gen: draw(gen).expand(shape)
                         .to(torch.float32))


def leaf_support(rnd, path: str, x: torch.Tensor, *, mode: str, p: float,
                 n: int, lanes: bool = False) -> torch.Tensor:
    """:func:`leaf_mask`'s draw before its float conversion, as the
    kernels read it: bool (n, *shape), or the single (1, *shape) row of
    ``shared_coords`` (the kernels read row r % 1).  The same generator
    calls, so the same values; an injected mask is returned as given."""
    dev, draw = _leaf_draw(path, x, mode=mode, p=p, n=n, lanes=lanes)
    return rnd.leaf_mask(path, dev, draw)


def mask_scale(mode: str, p: float, n: int) -> float:
    return float(n) if mode == "permk" else 1.0 / p


def tree_masks(rnd, per_node: Tree, *, mode: str, p: float, n: int
               ) -> Tuple[Tree, float]:
    """One (n, *shape) float32 {0,1} mask per leaf, and the scale."""
    masks = tree.from_items(
        (path, leaf_mask(rnd, path, x, mode=mode, p=p, n=n))
        for path, x in tree.items(per_node))
    return masks, mask_scale(mode, p, n)


# ---------------------------------------------------------------------------
# dense tree-level execution
# ---------------------------------------------------------------------------

def bernoulli_compress(rnd, delta: Tree, p: float,
                       shared: bool = False, lanes: bool = False) -> Tree:
    """delta leaves: (n, *shape), or (G, n, *shape) with ``lanes`` (one
    mask for every lane).  An independent Bernoulli(p) mask per node and
    coordinate; ``shared=True`` draws one mask per leaf for all nodes (the
    ``shared_coords`` mode).  Kept values are scaled by 1/p."""
    mode = "shared_coords" if shared else "independent"
    node_axis = 1 if lanes else 0

    def leaf(path, x):
        mask = leaf_mask(rnd, path, x, mode=mode, p=p,
                         n=x.shape[node_axis], lanes=lanes)
        return torch.where(mask != 0, x / p, torch.zeros_like(x)).to(x.dtype)

    return tree.from_items((path, leaf(path, x))
                           for path, x in tree.items(delta))


def permk_compress(rnd, delta: Tree, n: int,
                   lanes: bool = False) -> Tuple[Tree, Tree]:
    """Returns (messages m_i (n, *shape), exact aggregate mean_i m_i
    (*shape)): node i keeps the coordinates it owns, times n.  With
    ``lanes`` the leaves are (G, n, *shape), one partition for every
    lane."""
    ms, aggs = [], []
    for path, x in tree.items(delta):
        mask = leaf_mask(rnd, path, x, mode="permk", p=1.0, n=n, lanes=lanes)
        m = x * mask.to(x.dtype) * n
        ms.append((path, m))
        aggs.append((path, torch.mean(m.to(torch.float32), 1 if lanes
                                      else 0)))
    return tree.from_items(ms), tree.from_items(aggs)


# ---------------------------------------------------------------------------
# fused (CUDA kernel) tree-level execution
# ---------------------------------------------------------------------------

def fused_leaf_updates(rnd, grads_new: Tree, h: Tree, g_local: Tree, *,
                       mode: str, a: float, p: float, n: int,
                       variant: str = "dasha", b: float = 0.0,
                       grads_old: Optional[Tree] = None, lanes: bool = False,
                       c=None) -> Iterator[Tuple[str, torch.Tensor, torch.Tensor,
                                           torch.Tensor]]:
    """Alg. 1 lines 8-10 leaf by leaf, one kernel launch per leaf: yields
    ``(path, m, h_new, g_local_new)``.  Each kernel reads the leaf's draw
    as it comes (:func:`leaf_support`, a byte a coordinate, no float
    conversion pass); it lives only while its kernel runs, so the masks of
    the whole tree never exist at once.

    ``variant="dasha"``: h_new = grads_new.  ``variant="mvr"``: the kernel
    fuses the momentum h-update h_new = gn + (1-b)(h - go) as well
    (``grads_old`` required).  With ``lanes`` the leaves are (G, n,
    *shape), a sweep's lanes: one launch covers the G * n rows, each
    reading its node's row of the one (n, *shape) draw (row r % n); ``a``
    may then be the lanes' (G,) fp32 values, and ``c``, the lanes' (G,)
    fp32 ``1 - b``, replaces ``b``."""
    if variant == "mvr" and grads_old is None:
        raise ValueError("the mvr fused path needs grads_old")
    if variant not in ("dasha", "mvr"):
        raise ValueError(f"unknown fused variant {variant!r}")
    scale = mask_scale(mode, p, n)
    for path, gn in tree.items(grads_new):
        support = leaf_support(rnd, path, gn, mode=mode, p=p, n=n,
                               lanes=lanes)
        hh, gl = tree.get(h, path), tree.get(g_local, path)
        if variant == "mvr":
            ts = (gn, tree.get(grads_old, path), hh, gl)
            if lanes:
                ts = tuple(_lane_rows(t) for t in ts)
                support = support.reshape(support.shape[0], -1)
            if c is None:
                out = kops.dasha_mvr_update(*ts, support, a, b, scale)
            else:
                out = kops.dasha_mvr_update(*ts, support, a, None, scale,
                                            c=c)
            out = tuple(o.view(gn.shape) for o in out)
        else:
            out = _sparsify_leaf(gn, hh, gl, support, a, scale, lanes)
        yield (path, *out)


def _lane_rows(t: torch.Tensor) -> torch.Tensor:
    """A (G, n, *shape) lane leaf as G * n rows."""
    return t.reshape(t.shape[0] * t.shape[1], -1)


def _sparsify_leaf(gn, hh, gl, support, a: float, scale: float,
                   lanes: bool = False):
    """Kernel 1's sparsifier entry on a leaf as n rows (G * n with
    ``lanes``): (m, gn, g_new)."""
    def rows(t):
        return t.reshape(t.shape[0], -1)
    leaf_rows = _lane_rows if lanes else rows
    m, _, g_new = kops.dasha_sparsify_update(
        leaf_rows(gn), leaf_rows(hh), leaf_rows(gl), a, scale,
        mask=rows(support))
    return m.view(gn.shape), gn, g_new.view(gn.shape)


def fused_tree_update(rnd, grads_new: Tree, h: Tree, g_local: Tree, *,
                      mode: str, a: float, p: float, n: int,
                      variant: str = "dasha", b: float = 0.0,
                      grads_old: Optional[Tree] = None
                      ) -> Tuple[Tree, Tree, Tree]:
    """:func:`fused_leaf_updates` gathered into (m, h_new, g_local_new)
    trees."""
    outs = list(fused_leaf_updates(rnd, grads_new, h, g_local, mode=mode,
                                   a=a, p=p, n=n, variant=variant, b=b,
                                   grads_old=grads_old))
    return tuple(tree.from_items((o[0], o[i]) for o in outs)
                 for i in (1, 2, 3))

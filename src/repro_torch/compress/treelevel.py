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

``specs=`` (a tree of per-node specs, ``P(spmd_axes, *param_spec)``, the
reference's sharding-pinned masks) lays a DTensor leaf's mask out as the
leaf: each rank draws only its shard, at the shard's shape, from a
generator tagged with the shard's offsets as well (a shard that is the
whole leaf draws the unsharded mask), so the data ranks draw different
masks and every mask keeps density p.  PermK's ownership map is computed
for the shard's coordinates alone, the same map as the unsharded one.  An
injected mask, a full tensor, is cut to the shard.  The fused path then
runs kernels 1 and 3 on the local shards through ``local_map``
(:func:`repro_torch.kernels.ops.dasha_update_sharded`,
:func:`~repro_torch.kernels.ops.dasha_mvr_update_sharded`).  Plain
tensors ignore ``specs``.
"""
from __future__ import annotations

from typing import Any, Iterator, Optional, Tuple

import torch

from repro_torch.compress.plan import (draw_mask, permk_owner,
                                       permk_owner_block)
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


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _sharded(x, spec, lanes: bool) -> bool:
    """True where leaf ``x`` takes the sharded draw: a DTensor with its
    spec.  A DTensor without one, or a sweep's lanes, raise."""
    if not _is_dtensor(x):
        return False
    if spec is None:
        raise ValueError("a sharded per-node leaf needs its spec (specs=)")
    if lanes:
        raise ValueError("a sweep's lanes have no sharded form")
    return True


def _shard_draw(rnd, path: str, x, spec, *, mode: str, p: float, n: int):
    """(local draw, global shape, spec) of leaf ``x``'s support on this
    rank's shard: bool (or the injected mask's dtype) at the shard's
    shape; the global shape and spec are ``x``'s, or with a single node
    row for ``shared_coords`` (its node axis replicated)."""
    from repro_torch.models import sharding as sh
    mesh = x.device_mesh
    shape = tuple(x.shape)
    if mode == "shared_coords":
        shape, spec = (1,) + shape[1:], sh.P(None, *tuple(spec)[1:])
    elif mode == "permk" and shape[0] != n:
        raise ValueError(f"permk leaf {path!r} has node axis {shape[0]} "
                         f"!= n={n}")
    elif mode not in ("independent", "permk"):
        raise ValueError(f"unknown tree compression mode {mode!r}")
    local = sh.local_shape(shape, spec, mesh)
    offsets = sh.shard_offsets(shape, spec, mesh)
    dev = x.to_local().device
    if rnd.draws.masks is not None:
        full = tree.get(rnd.draws.masks, path)
        if mode == "shared_coords":
            full = full[:1]
        draw = full[tuple(slice(o, o + k) for o, k in zip(offsets, local))]
        return draw.to(dev), shape, spec
    if mode == "permk":
        gen = generator("cpu", rnd.seed, rnd.t, "mask", path)
        owner = permk_owner_block(gen, shape[1:], n, local[1:], offsets[1:],
                                  device=dev)
        ids = offsets[0] + torch.arange(local[0], device=dev)
        return owner[None] == ids.reshape((-1,) + (1,) * (len(shape) - 1)), \
            shape, spec
    if dev.type == "meta":          # a trace: shapes, no values
        return torch.empty(local, dtype=torch.bool, device=dev), shape, spec
    parts = () if local == shape else offsets
    gen = generator(dev, rnd.seed, rnd.t, "mask", path, *parts)
    return draw_mask(gen, local, p), shape, spec


def _as_dtensor(local, x, shape, spec):
    from torch.distributed.tensor import DTensor
    from repro_torch.models import sharding as sh
    mesh = x.device_mesh
    return DTensor.from_local(local, mesh, sh.to_placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=sh._contiguous(shape))


def leaf_mask(rnd, path: str, x: torch.Tensor, *, mode: str, p: float,
              n: int, lanes: bool = False, spec=None) -> torch.Tensor:
    """The (n, *shape) float32 {0,1} mask of leaf ``x`` (shape (n, ...),
    or (G, n, ...) with ``lanes``, whose lanes share the mask).

    ``permk``: node i keeps the coordinates it owns under the leaf's
    cyclic-shift partition; ``shared_coords``: one Bernoulli(p) mask per
    leaf, the same for every node; ``independent``: Bernoulli(p) per node
    and coordinate.  A DTensor ``x`` with its ``spec`` gets a DTensor mask
    laid out as ``x`` (module docstring)."""
    if _sharded(x, spec, lanes):
        draw, _, _ = _shard_draw(rnd, path, x, spec, mode=mode, p=p, n=n)
        local = draw.expand(x.to_local().shape).to(torch.float32)
        return _as_dtensor(local, x, x.shape, spec)
    dev, draw = _leaf_draw(path, x, mode=mode, p=p, n=n, lanes=lanes)
    shape = x.shape[1:] if lanes else x.shape
    return rnd.leaf_mask(path, dev, lambda gen: draw(gen).expand(shape)
                         .to(torch.float32))


def leaf_support(rnd, path: str, x: torch.Tensor, *, mode: str, p: float,
                 n: int, lanes: bool = False, spec=None) -> torch.Tensor:
    """:func:`leaf_mask`'s draw before its float conversion, as the
    kernels read it: bool (n, *shape), or the single (1, *shape) row of
    ``shared_coords`` (the kernels read row r % 1).  The same generator
    calls, so the same values; an injected mask is returned as given.  A
    DTensor ``x`` with its ``spec`` gets a DTensor draw laid out as ``x``
    (one node row for ``shared_coords``, its node axis replicated)."""
    if _sharded(x, spec, lanes):
        draw, shape, mspec = _shard_draw(rnd, path, x, spec, mode=mode,
                                         p=p, n=n)
        return _as_dtensor(draw, x, shape, mspec)
    dev, draw = _leaf_draw(path, x, mode=mode, p=p, n=n, lanes=lanes)
    return rnd.leaf_mask(path, dev, draw)


def mask_scale(mode: str, p: float, n: int) -> float:
    return float(n) if mode == "permk" else 1.0 / p


def _spec(specs, path: str):
    return None if specs is None else tree.get(specs, path)


def tree_masks(rnd, per_node: Tree, *, mode: str, p: float, n: int,
               specs: Optional[Tree] = None) -> Tuple[Tree, float]:
    """One (n, *shape) float32 {0,1} mask per leaf, and the scale; a
    DTensor leaf's laid out by its spec in ``specs``."""
    masks = tree.from_items(
        (path, leaf_mask(rnd, path, x, mode=mode, p=p, n=n,
                         spec=_spec(specs, path)))
        for path, x in tree.items(per_node))
    return masks, mask_scale(mode, p, n)


def node_mean(per_node, node_axis: int = 0):
    """The float32 mean of a per-node leaf over its node axis.  On a
    DTensor whose node axis is sharded: each rank sums its own rows, the
    partial sums are all-reduced over the node axis's mesh dims (a sum:
    every backend has one) and divided by n, laid out as the leaf's
    other dims; the only traffic is the one reduction the size of a
    row."""
    f32 = per_node.to(torch.float32)
    if not _is_dtensor(per_node):
        return torch.mean(f32, node_axis)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.models.sharding import _contiguous
    if node_axis != 0:
        raise ValueError("a sharded per-node leaf has its node axis first")
    mesh = per_node.device_mesh
    part, whole = [], []
    for p in per_node.placements:
        if p == Shard(0):
            part.append(Partial())
            whole.append(Replicate())
        else:
            q = Shard(p.dim - 1) if isinstance(p, Shard) else p
            part.append(q)
            whole.append(q)
    shape = tuple(per_node.shape[1:])
    total = DTensor.from_local(torch.sum(f32.to_local(), 0), mesh, part,
                               run_check=False, shape=torch.Size(shape),
                               stride=_contiguous(shape))
    return total.redistribute(mesh, whole) / per_node.shape[0]



# ---------------------------------------------------------------------------
# dense tree-level execution
# ---------------------------------------------------------------------------

def bernoulli_compress(rnd, delta: Tree, p: float,
                       shared: bool = False, lanes: bool = False,
                       specs: Optional[Tree] = None) -> Tree:
    """delta leaves: (n, *shape), or (G, n, *shape) with ``lanes`` (one
    mask for every lane).  An independent Bernoulli(p) mask per node and
    coordinate; ``shared=True`` draws one mask per leaf for all nodes (the
    ``shared_coords`` mode).  Kept values are scaled by 1/p.  ``specs``:
    a DTensor leaf's mask is laid out by its spec."""
    mode = "shared_coords" if shared else "independent"
    node_axis = 1 if lanes else 0

    def leaf(path, x):
        mask = leaf_mask(rnd, path, x, mode=mode, p=p,
                         n=x.shape[node_axis], lanes=lanes,
                         spec=_spec(specs, path))
        return torch.where(mask != 0, x / p, torch.zeros_like(x)).to(x.dtype)

    return tree.from_items((path, leaf(path, x))
                           for path, x in tree.items(delta))


def permk_compress(rnd, delta: Tree, n: int, lanes: bool = False,
                   specs: Optional[Tree] = None) -> Tuple[Tree, Tree]:
    """Returns (messages m_i (n, *shape), exact aggregate mean_i m_i
    (*shape)): node i keeps the coordinates it owns, times n.  With
    ``lanes`` the leaves are (G, n, *shape), one partition for every
    lane; ``specs``: a DTensor leaf's ownership mask is laid out by its
    spec."""
    ms, aggs = [], []
    for path, x in tree.items(delta):
        mask = leaf_mask(rnd, path, x, mode="permk", p=1.0, n=n, lanes=lanes,
                         spec=_spec(specs, path))
        m = x * mask.to(x.dtype) * n
        ms.append((path, m))
        aggs.append((path, node_mean(m, 1 if lanes else 0)))
    return tree.from_items(ms), tree.from_items(aggs)


# ---------------------------------------------------------------------------
# fused (CUDA kernel) tree-level execution
# ---------------------------------------------------------------------------

def fused_leaf_updates(rnd, grads_new: Tree, h: Tree, g_local: Tree, *,
                       mode: str, a: float, p: float, n: int,
                       variant: str = "dasha", b: float = 0.0,
                       grads_old: Optional[Tree] = None, lanes: bool = False,
                       c=None, specs: Optional[Tree] = None
                       ) -> Iterator[Tuple[str, torch.Tensor, torch.Tensor,
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
    fp32 ``1 - b``, replaces ``b``.  ``specs``: a DTensor leaf draws its
    shard's mask by its spec, and its kernel runs on the local shards
    through ``local_map``."""
    if variant == "mvr" and grads_old is None:
        raise ValueError("the mvr fused path needs grads_old")
    if variant not in ("dasha", "mvr"):
        raise ValueError(f"unknown fused variant {variant!r}")
    scale = mask_scale(mode, p, n)
    for path, gn in tree.items(grads_new):
        spec = _spec(specs, path)
        support = leaf_support(rnd, path, gn, mode=mode, p=p, n=n,
                               lanes=lanes, spec=spec)
        hh, gl = tree.get(h, path), tree.get(g_local, path)
        if _is_dtensor(gn):
            if variant == "mvr":
                out = kops.dasha_mvr_update_sharded(
                    gn, tree.get(grads_old, path), hh, gl, support, a,
                    None if c is not None else b, scale, c=c)
            else:
                out = kops.dasha_update_sharded(gn, hh, gl, support, a,
                                                scale)
            yield (path, *out)
            continue
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
                      grads_old: Optional[Tree] = None,
                      specs: Optional[Tree] = None
                      ) -> Tuple[Tree, Tree, Tree]:
    """:func:`fused_leaf_updates` gathered into (m, h_new, g_local_new)
    trees."""
    outs = list(fused_leaf_updates(rnd, grads_new, h, g_local, mode=mode,
                                   a=a, p=p, n=n, variant=variant, b=b,
                                   grads_old=grads_old, specs=specs))
    return tuple(tree.from_items((o[0], o[i]) for o in outs)
                 for i in (1, 2, 3))

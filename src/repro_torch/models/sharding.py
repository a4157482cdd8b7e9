"""Sharding policy: partition specs for params, caches and batches (port of
``repro.models.sharding``).

Megatron-style 2D: batch over ("pod", "data"), tensor dims over "model" —
but only when the dimension is divisible by the model-axis size; otherwise
the tensor is replicated (recorded by :func:`sharding_report`).
Stacked-layer leading axes are always unsharded (the model loops over
them).

A spec is a :class:`P`, a tuple with one entry per tensor dim, entry for
entry the reference's ``PartitionSpec``: an axis name, a tuple of axis
names (the dim is split over their product, major to minor), or None.  The
rules read only axis names and sizes, so they run on an
:func:`~repro_torch.launch.mesh.abstract_mesh` as on a ``DeviceMesh``.
:func:`to_placements` turns a spec into DTensor placements on a
``DeviceMesh`` and :func:`distribute_tree` lays a tree out by its specs
(the counterpart of ``to_shardings``).

The expert constraints (:func:`expert_sharding`,
:func:`constrain_expert_major`, :func:`constrain_token_major`) redistribute
a DTensor while an axis is set, as the reference's
``with_sharding_constraint`` pins its intermediates, and are identities on
plain tensors or with no axis set.
"""
from __future__ import annotations

import contextvars
from contextlib import contextmanager
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.launch.mesh import mesh_axes
from repro_torch.models.common import ArchConfig

DP_AXES = ("pod", "data")   # logical batch axes (pod may be absent)


class P(tuple):
    """A partition spec: ``P("model", None)``; equal to the plain tuple of
    its entries.  An entry of one axis name in a tuple is that name, and an
    empty tuple is None, as the reference's ``PartitionSpec`` normalises
    them."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def is_spec(x) -> bool:
    return isinstance(x, P)


# ---------------------------------------------------------------------------
# trees: nested dicts, NamedTuples, tuples and lists of leaves
# ---------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def map_with_path(fn: Callable, tree: Any, *rest: Any, path=(),
                  is_leaf: Optional[Callable] = None) -> Any:
    """``fn(path, leaf, *rest_leaves)`` over a tree, ``path`` the tuple of
    keys (dict keys, NamedTuple field names, sequence indices) from the
    root.  ``rest`` trees share the structure of ``tree``.  None is an
    empty subtree, as in a JAX pytree."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree, *rest)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], *(r[k] for r in rest),
                                 path=path + (k,), is_leaf=is_leaf)
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(
            fn, getattr(tree, f), *(getattr(r, f) for r in rest),
            path=path + (f,), is_leaf=is_leaf) for f in tree._fields))
    if isinstance(tree, (list, tuple)) and not is_spec(tree):
        return type(tree)(map_with_path(fn, v, *(r[i] for r in rest),
                                        path=path + (i,), is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def leaves_with_path(tree: Any, is_leaf: Optional[Callable] = None):
    """(path, leaf) pairs in the tree's order."""
    out = []
    map_with_path(lambda p, x: out.append((p, x)), tree, is_leaf=is_leaf)
    return out


# ---------------------------------------------------------------------------
# trace-time expert-sharding context
# ---------------------------------------------------------------------------

_EXPERT_AXIS: "contextvars.ContextVar" = contextvars.ContextVar(
    "expert_shard_axis", default=None)


@contextmanager
def expert_sharding(axis):
    """Set the mesh axis that expert-major MoE intermediates shard over
    (None = no constraints; the single-device default)."""
    tok = _EXPERT_AXIS.set(axis)
    try:
        yield
    finally:
        _EXPERT_AXIS.reset(tok)


def expert_axis():
    """The mesh axis :func:`expert_sharding` set, or None."""
    return _EXPERT_AXIS.get()


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, spec: Tuple, mesh=None):
    """``x`` laid out by ``spec``: a DTensor is redistributed; a plain
    tensor is made a replicated DTensor on ``mesh`` first (a plain tensor
    with no mesh given is returned as it is)."""
    if not is_dtensor(x):
        if mesh is None:
            return x
        from torch.distributed.tensor import DTensor, Replicate
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return x.redistribute(x.device_mesh, to_placements(spec, x.device_mesh))


def einsum(eq: str, a, b):
    """``torch.einsum(eq, a, b)`` of two operands; on DTensors (a plain
    operand joining as replicated) computed on the local shards.  Each mesh
    dim is read on its own: an index both operands shard there stays
    sharded in the output (a contracted one makes the output a partial
    sum); an index only one operand shards there, the other is sliced to
    match (a local chunk of a replicated operand, no communication); where
    the two shard different indices, ``b``'s (the weight's) wins; a
    partial or strided placement is resolved first.  DTensor's own einsum
    flattens index groups into one matmul dim, and a dim sharded inside
    such a group (the head_dim of a (H, hd) pair) becomes a strided shard
    whose redistribution plan takes minutes to search on a 3-D mesh; a
    local einsum never flattens a sharded dim."""
    if not (is_dtensor(a) or is_dtensor(b)):
        return torch.einsum(eq, a, b)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = (a if is_dtensor(a) else b).device_mesh
    a, b = (t if is_dtensor(t) else constrain(t, (None,) * t.ndim, mesh)
            for t in (a, b))
    ins, out = eq.replace(" ", "").split("->")
    la, lb = ins.split(",")
    pa, pb, po = [], [], []
    for m in range(mesh.ndim):
        qa, qb = a.placements[m], b.placements[m]
        xa = la[qa.dim] if type(qa) is Shard else None
        xb = lb[qb.dim] if type(qb) is Shard else None
        idx = xb or xa
        if idx is None:
            pa.append(Replicate())
            pb.append(Replicate())
            po.append(Replicate())
            continue
        pa.append(Shard(la.index(idx)) if idx in la else Replicate())
        pb.append(Shard(lb.index(idx)) if idx in lb else Replicate())
        po.append(Shard(out.index(idx)) if idx in out else Partial())
    a = a.redistribute(mesh, pa)
    b = b.redistribute(mesh, pb)
    size = dict(zip(la, a.shape))
    size.update(zip(lb, b.shape))
    # an operand replicated over a mesh dim that splits the product gets
    # only its rank's share of the gradient there: a partial sum
    cols = [[q] for q in po]
    ga, gb = _split_grads(pa, cols), _split_grads(pb, cols)
    local = torch.einsum(eq, a.to_local(grad_placements=ga),
                         b.to_local(grad_placements=gb))
    shape = torch.Size(size[c] for c in out)
    return DTensor.from_local(local, mesh, po, run_check=False, shape=shape,
                              stride=_contiguous(shape))


def _split_grads(inp, cols) -> tuple:
    """The gradient placements of a local computation's input placed
    ``inp``: ``Partial`` on each mesh dim ``m`` where it is replicated
    while a placement in ``cols[m]`` (the other inputs' or the outputs'
    on that dim) splits the computation, so each rank's local gradient is
    only its share; its own placement elsewhere."""
    from torch.distributed.tensor import Partial, Replicate
    return tuple(Partial() if isinstance(p, Replicate) and any(
        not isinstance(o, Replicate) for o in col) else p
        for p, col in zip(inp, cols))


def local_map(fn, out_placements, in_placements, mesh):
    """``torch.distributed.tensor.experimental.local_map`` with the
    inputs' gradient placements declared (:func:`_split_grads`): an input
    replicated over a mesh dim where another input or an output is split
    gets its gradient as a partial sum there, as each rank's local
    backward computes only its share.  Inputs are never moved: one laid
    out otherwise than declared raises."""
    from torch.distributed.tensor.experimental import local_map as _lm
    every = [pl for pl in tuple(in_placements) + tuple(out_placements)
             if pl is not None]
    cols = [[pl[m] for pl in every] for m in range(mesh.ndim)]
    grads = tuple(None if pl is None else _split_grads(pl, cols)
                  for pl in in_placements)
    return _lm(fn, out_placements=out_placements,
               in_placements=in_placements, in_grad_placements=grads,
               redistribute_inputs=False, device_mesh=mesh)


def matmul(a, b):
    """``a @ b`` for a 2-D ``b``; on DTensors :func:`einsum` over the same
    indices (DTensor's own matmul rules differ between torch releases: one
    asks an input to become a partial sum, which it cannot)."""
    if not (is_dtensor(a) or is_dtensor(b)):
        return a @ b
    lead = "abcdefgh"[:a.ndim - 1]
    return einsum(f"{lead}k,kn->{lead}n", a, b)


def _contiguous(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def residual(x, seq_axis: Optional[str] = None):
    """A (B, S, d) residual stream in Megatron's layout on DTensors: batch
    over the data axes where it divides, replicated over "model" (or, with
    ``seq_axis``, its sequence dim over that axis); an identity on plain
    tensors.  DTensor picks each op's output layout on its own: a partial
    sum out of a row-parallel product comes out sequence-split over
    "model", say, and carried into the next matmul makes a strided shard
    whose plan takes minutes to search; pinning the stream after each
    residual add keeps the layouts the policy means."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    b = dp_axes(mesh) if x.shape[0] % dp_size(mesh) == 0 else None
    return constrain(x, (b, seq_axis, None))


def constrain_expert_major(x):
    """Pin an (E, ...) tensor's leading dim to the active expert axis, every
    other mesh axis replicated."""
    axis = _EXPERT_AXIS.get()
    if axis is None:
        return x
    return constrain(x, (axis,) + (None,) * (x.ndim - 1))


def constrain_token_major(x):
    """Pin an (N_tokens, ...) tensor to be replicated over the mesh."""
    axis = _EXPERT_AXIS.get()
    if axis is None:
        return x
    return constrain(x, (None,) * x.ndim)


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------

def dp_axes(mesh) -> Tuple[str, ...]:
    names = mesh_axes(mesh)
    return tuple(a for a in DP_AXES if a in names)


def dp_size(mesh) -> int:
    sizes = mesh_axes(mesh)
    n = 1
    for a in dp_axes(mesh):
        n *= sizes[a]
    return n


def tp_size(mesh) -> int:
    return int(mesh_axes(mesh).get("model", 1))


def divides(n: int, tp: int) -> bool:
    """``n`` splits evenly over a model axis of ``tp`` > 1."""
    return tp > 1 and n % tp == 0


def param_specs(cfg: ArchConfig, params: Any, mesh,
                fsdp: bool = False, hd_fallback: bool = True) -> Any:
    """Mirror the params tree with specs (path-name rules).

    ``fsdp=True`` additionally shards, for every matrix leaf, the first
    trailing dim not already taken by "model" over the data axes (ZeRO-3:
    params / g gathered on use).  Never applied to per-node DASHA state
    whose leading node axis already occupies the data axes.

    ``hd_fallback=False`` disables the head_dim-sharding fallback for
    non-divisible head counts: attention weights replicate instead (the
    serve paths of long-context archs, where the per-layer all-reduce of
    hd-partial logits costs more link traffic than the replicated
    weights' memory)."""
    tp = tp_size(mesh)
    dp = dp_axes(mesh)
    dpn = dp_size(mesh)
    H, G = cfg.num_heads, cfg.num_kv_heads
    Hs = cfg.ssm_nheads if cfg.ssm_state else 0
    E = cfg.num_experts

    def model_if(ok: bool):
        return "model" if ok else None

    hd_ok = divides(cfg.head_dim or 0, tp) and hd_fallback

    def qkv_spec(n_heads: int) -> Tuple:
        """(d, heads, hd): shard heads when divisible, else head_dim."""
        if divides(n_heads, tp):
            return (None, "model", None)
        if hd_ok:
            return (None, None, "model")
        return (None, None, None)

    def o_spec(n_heads: int) -> Tuple:
        if divides(n_heads, tp):
            return ("model", None, None)
        if hd_ok:
            return (None, "model", None)
        return (None, None, None)

    def bias_spec(n_heads: int) -> Tuple:
        if divides(n_heads, tp):
            return ("model", None)
        if hd_ok:
            return (None, "model")
        return (None, None)

    ff_ok = divides(cfg.d_ff, tp)
    ssm_ok = divides(Hs, tp)
    conv_ok = ssm_ok and cfg.ssm_state % tp == 0
    # base specs keyed by leaf name; rank excludes stacked leading dims
    base: Dict[str, Tuple] = {
        "embed": ("model", None),
        "lm_head": (None, "model"),
        "final_norm": (None,), "enc_norm": (None,),
        "ln": (None,), "ln1": (None,), "ln2": (None,),
        "attn_gate": (None,), "mlp_gate": (None,),
        "wq": qkv_spec(H), "wk": qkv_spec(G), "wv": qkv_spec(G),
        "wo": o_spec(H),
        "bq": bias_spec(H), "bk": bias_spec(G), "bv": bias_spec(G),
        # MLA: the latent dim shards over model when divisible (the ckv
        # cache takes the same rule, so the decode products line up)
        "w_dkv": (None, model_if(cfg.kv_lora_rank % tp == 0 and tp > 1
                                 and cfg.kv_lora_rank >= tp)),
        "w_krope": (None, None),
        "w_uk": (None, model_if(divides(H, tp)), None),
        "w_uv": (None, model_if(divides(H, tp)), None),
        "w_gate": (None, model_if(ff_ok)),
        "w_in": (None, model_if(ff_ok)),
        "w_out": (model_if(ff_ok), None),
        "b_in": (model_if(ff_ok),), "b_out": (None,),
        "router": (None, None),
        "w_z": (None, model_if(ssm_ok), None),
        "w_xbc": (None, model_if(conv_ok)),
        "w_dt": (None, model_if(ssm_ok)),
        "dt_bias": (model_if(ssm_ok),),
        "conv_w": (None, model_if(conv_ok)),
        "conv_b": (model_if(conv_ok),),
        "A_log": (model_if(ssm_ok),), "D": (model_if(ssm_ok),),
        "norm": (model_if(ssm_ok),),
    }
    moe_expert = {name: (model_if(divides(E, tp)), None, None)
                  for name in ("w_gate", "w_in", "w_out")}
    if cfg.num_shared_experts:
        sf = cfg.d_ff * cfg.num_shared_experts
        base.update({
            "shared_w_gate": (None, model_if(divides(sf, tp))),
            "shared_w_in": (None, model_if(divides(sf, tp))),
            "shared_w_out": (model_if(divides(sf, tp)), None)})
    if cfg.ssm_state and cfg.arch_type in ("ssm", "hybrid"):
        base["w_out"] = (model_if(ssm_ok), None)       # mamba w_out (H*P, d)

    def rule(path, leaf):
        name = path[-1]
        is_expert = (E > 0 and name in moe_expert and leaf.ndim >= 3
                     and "ffn" in path and leaf.shape[-3] == E)
        spec = moe_expert[name] if is_expert else base.get(name)
        if spec is None:
            return P(*((None,) * leaf.ndim))
        # hybrid / ssm: the transformer blocks' dense mlp w_out is (ff, d)
        # where mamba's is (HP, d), the same rank: told apart by the path
        if (name == "w_out" and cfg.arch_type in ("ssm", "hybrid")
                and any(k in ("shared_attn", "ffn", "cross_layers")
                        for k in path) and not is_expert):
            spec = (model_if(ff_ok), None)
        if name in ("w_gate", "w_in") and not is_expert:
            spec = (None, model_if(ff_ok))
        lead = leaf.ndim - len(spec)
        spec = list((None,) * lead + tuple(spec))
        if fsdp and leaf.ndim >= 2 and dp:
            for i in range(lead, leaf.ndim):
                if spec[i] is None and leaf.shape[i] % dpn == 0 \
                        and leaf.shape[i] >= dpn:
                    spec[i] = dp if len(dp) > 1 else dp[0]
                    break
        return P(*spec)

    return map_with_path(rule, params)


def batch_specs(cfg: ArchConfig, mesh, batch_size: int) -> Dict:
    dp = dp_axes(mesh)
    b = dp if batch_size % dp_size(mesh) == 0 else None
    return {"tokens": P(b, None), "labels": P(b, None),
            "image_embeds": P(b, None, None), "frames": P(b, None, None)}


def cache_specs(cfg: ArchConfig, cache: Any, mesh, batch_size: int) -> Any:
    """Decode-cache specs.  Batch axis over ("pod", "data") when divisible;
    otherwise (long_500k, B = 1) the cache SEQUENCE axis is sharded over
    "data" (context-parallel decode) and SSM states stay replicated."""
    sizes = mesh_axes(mesh)
    dp = dp_axes(mesh)
    tp = tp_size(mesh)
    batch_ok = batch_size % dp_size(mesh) == 0
    G = cfg.num_kv_heads
    hd_div = (cfg.head_dim or 0) % tp == 0 and tp > 1

    def rule(path, leaf):
        nd = leaf.ndim
        spec = [None] * nd
        if "cross" in path:
            # cross K/V over image / audio tokens (n, B, T_src, G, hd):
            # T_src (1,601 / 1,500) does not divide; batch and heads / hd
            if batch_ok:
                spec[nd - 4] = dp
            if divides(G, tp):
                spec[nd - 2] = "model"
            elif hd_div:
                spec[nd - 1] = "model"
            return P(*spec)
        if "ssm" in path or "conv" in path:     # (L, B, ...) mamba states
            if batch_ok:
                spec[1] = dp
            if "ssm" in path and divides(cfg.ssm_nheads, tp):
                spec[2] = "model"                 # (L, B, H, N, P)
            if "conv" in path and divides(cfg.ssm_nheads, tp) \
                    and cfg.ssm_state % tp == 0:
                spec[-1] = "model"                # channel dim
            return P(*spec)
        if "ckv" in path or "krope" in path:      # MLA (L, B, T, r)
            if batch_ok:
                spec[1] = dp
            elif "data" in sizes and leaf.shape[2] % sizes["data"] == 0:
                spec[2] = "data"
            if "ckv" in path and cfg.kv_lora_rank % tp == 0 and tp > 1:
                spec[-1] = "model"                # latent dim
            return P(*spec)
        # K/V caches: (..., B, T, G, hd)
        if batch_ok:
            spec[nd - 4] = dp
        elif "data" in sizes and leaf.shape[nd - 3] % sizes["data"] == 0:
            spec[nd - 3] = "data"                 # shard the sequence
        if divides(G, tp):
            spec[nd - 2] = "model"
        elif hd_div:
            spec[nd - 1] = "model"                # few kv heads: shard hd
        return P(*spec)

    return map_with_path(rule, cache)


def sharding_report(cfg: ArchConfig, params: Any, mesh) -> str:
    """Human-readable summary of which tensors replicate."""
    specs = leaves_with_path(param_specs(cfg, params, mesh), is_leaf=is_spec)
    shapes = leaves_with_path(params)
    n_rep = sum(1 for (_, s), (_, leaf) in zip(specs, shapes)
                if all(a is None for a in s) and leaf.ndim >= 2)
    return (f"{cfg.name}: {n_rep}/{len(specs)} matrix params replicated "
            f"on model axis (size {tp_size(mesh)})")


# ---------------------------------------------------------------------------
# from specs to DTensors
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec: Tuple, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: mesh dim ``a`` takes
    ``Shard(i)`` where spec entry ``i`` names ``a`` (a dim over ("pod",
    "data") takes ``Shard(i)`` on both, split major to minor in mesh-dim
    order, as the reference's tuple entry is), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axes(mesh))
    place = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        axes = _entry_axes(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry!r} is not in mesh-dim order "
                             f"{tuple(names)}")
        for j in pos:
            if not isinstance(place[j], Replicate):
                raise ValueError(f"mesh axis {names[j]!r} shards two dims "
                                 f"of {spec!r}")
            place[j] = Shard(i)
    return place


def local_shape(shape, spec: Tuple, mesh) -> Tuple[int, ...]:
    """One rank's shard shape of a ``shape`` tensor laid out by ``spec``;
    raises where a sharded dim does not divide."""
    sizes = mesh_axes(mesh)
    out = []
    for i, n in enumerate(shape):
        k = 1
        for a in _entry_axes(spec[i] if i < len(spec) else None):
            k *= sizes[a]
        if n % k:
            raise ValueError(f"dim {i} ({n}) of {tuple(shape)} does not "
                             f"divide over {spec[i]!r} ({k})")
        out.append(n // k)
    return tuple(out)


def shard_offsets(shape, spec: Tuple, mesh) -> Tuple[int, ...]:
    """Where this rank's shard of a ``shape`` tensor laid out by ``spec``
    starts, dim by dim: a dim split over several mesh axes is split major
    to minor in mesh-dim order, as :func:`to_placements` lays it out."""
    sizes = mesh_axes(mesh)
    names = list(sizes)
    coord = mesh.get_coordinate()
    out = []
    for i, n in enumerate(shape):
        idx, k = 0, 1
        for a in sorted(_entry_axes(spec[i] if i < len(spec) else None),
                        key=names.index):
            idx = idx * sizes[a] + coord[names.index(a)]
            k *= sizes[a]
        out.append(idx * (n // k))
    return tuple(out)


def node_spec(spmd_axes, spec: Tuple) -> "P":
    """The spec of a per-node leaf (n, *shape): the node axis over
    ``spmd_axes``, the rest as the parameter's ``spec`` (the reference's
    ``P(spmd_axes, *spec)``)."""
    return P(tuple(spmd_axes) if spmd_axes else None, *tuple(spec))


def distribute_tree(tree: Any, specs: Any, mesh, *,
                    make_local: Optional[Callable] = None) -> Any:
    """Every tensor leaf of ``tree`` as a DTensor on ``mesh`` laid out by
    its spec.  Without ``make_local`` each rank keeps its own chunk of the
    full leaf it holds, with no communication (the leaves must agree
    across ranks, as leaves made from one seed do).  With ``make_local``,
    ``make_local(path, local_shape, dtype)`` makes this rank's shard and
    the full leaf only gives the global shape (a ``meta`` tree, say): no
    full-size tensor is ever allocated.  Leaves that are not tensors pass
    through."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(path, leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        place = to_placements(spec, mesh)
        if make_local is None:
            return distribute_tensor(leaf, mesh, place, src_data_rank=None)
        local = make_local(path, local_shape(leaf.shape, spec, mesh),
                           leaf.dtype)
        return DTensor.from_local(local, mesh, place, run_check=False,
                                  shape=leaf.shape, stride=leaf.stride())

    return map_with_path(one, tree, specs)

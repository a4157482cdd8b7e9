"""Mixture-of-experts FFN (port of ``repro.models.moe``): a top-k router,
capacity-based dispatch and optional shared experts (DeepSeek-V2).

Dispatch is the dropping formulation: each expert takes at most
``capacity`` tokens; a token's slot past it falls through to the residual
(plus the shared experts).  The load-balance auxiliary loss is returned
for training.  Two dispatch modes, as in the reference:

* ``gather`` — a slot -> token map built from the routing, the experts'
  buffers gathered through it and the outputs gathered back, K gathers;
* ``einsum`` — one-hot matmul dispatch over chunks of ``moe_chunk``
  tokens (Switch Transformer), capacity per chunk.

The reference computes both in ``jnp``, in no Pallas kernel; so does the
port, in torch ops (``bmm``, ``einsum``, ``softmax``, index ops), in the
reference's order:

* the router product runs in float32 (the router is float32 in a bf16
  model; ``xt @ router`` promotes in JAX and the port casts ``xt``);
* top-k breaks ties toward the lower expert index, as ``lax.top_k`` does
  (a stable descending sort; ``torch.topk`` promises no order for ties,
  and ties are real: a zero router, the einsum path's zero pad rows);
* slot positions count the (token, k) pairs token-major, then k (by a
  stable sort, the same integers as the reference's one-hot cumsum);
* the combine adds the K gathers in k order from zeros in the input
  dtype, and the aux loss reads only each token's first choice.

Under a mesh (DTensor activations) the reference's sharding constraints
act as there: ``sharding.constrain_expert_major`` pins the (E, C, ...)
buffers, the expert weights at use and the expert outputs to the expert
axis, and ``constrain_token_major`` replicates the combined output and the
einsum path's dispatch tensor, while :func:`sharding.expert_sharding` names
an axis; on plain tensors they are identities.  The routing (the top-k
sort, the count of each expert's pairs, the slot map) runs on a
replicated token axis, as plain tensors every rank holds whole (DTensor has
no sharding rule for them), and re-enters the sharded program as
replicated DTensors.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ArchConfig, mlp_apply, silu
from repro_torch.models.sharding import (constrain, constrain_expert_major,
                                         constrain_token_major, expert_axis,
                                         is_dtensor)


def _capacity(cfg: ArchConfig, num_tokens: int) -> int:
    """``int(cf * N * K / E)``, at least 1: the reference truncates
    (its docstring says ceil, its code floors)."""
    cap = int(cfg.capacity_factor * num_tokens * cfg.experts_per_token
              / cfg.num_experts)
    return max(cap, 1)


def _route(logits: torch.Tensor, K: int):
    """float32 router logits (N, E) -> (probs, normalised gate values (N,
    K), expert indices (N, K)), ties to the lower index as in
    ``lax.top_k``."""
    probs = torch.softmax(logits, -1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    gate_idx = order[:, :K]
    gate_vals = torch.gather(probs, -1, gate_idx)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, gate_idx


def _slot_positions(gate_idx: torch.Tensor, E: int) -> torch.Tensor:
    """The position of each (token, k) in its expert's buffer: how many
    pairs before it, token-major then k, chose the same expert.  The
    reference counts them with a cumsum over the (N*K, E) one-hot; a
    stable sort of the flat expert ids lists each expert's pairs in that
    same order, so a pair's rank within its expert's run is the same
    integer, without the one-hot (whose int64 scan over dim 0 took 75 ms
    a layer of deepseek-v2-lite's 4 x 8,192 prefill on the H100)."""
    e = gate_idx.reshape(-1)
    order = torch.sort(e, stable=True).indices
    # integer counts by scatter_add_ (exact; ``bincount`` has no ``meta``
    # kernel, and a dry run traces this on ``meta``)
    counts = torch.zeros(E, dtype=e.dtype, device=e.device).scatter_add_(
        0, e, torch.ones_like(e))
    start = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(e)
    pos[order] = torch.arange(e.numel(), device=e.device) - start[e[order]]
    return pos.reshape(gate_idx.shape)


def _aux_loss(probs: torch.Tensor, first: torch.Tensor, E: int
              ) -> torch.Tensor:
    """Switch-style load balance: E * sum(mean prob * first-choice
    share)."""
    me = torch.mean(probs, 0)
    ce = torch.mean(F.one_hot(first, E).to(torch.float32), 0)
    return E * torch.sum(me * ce)


def _experts(p: Dict, buf: torch.Tensor) -> torch.Tensor:
    """(E, C, d) buffers through each expert's SwiGLU: (E, C, d), the
    buffers, the weights at use, the hidden and the output pinned
    expert-major."""
    buf = constrain_expert_major(buf)
    wg, wi, wo = (constrain_expert_major(p[k])
                  for k in ("w_gate", "w_in", "w_out"))
    h = constrain_expert_major(silu(torch.bmm(buf, wg)) * torch.bmm(buf, wi))
    return constrain_expert_major(torch.bmm(h, wo))


def _as_tokens_of(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The (N, d) output laid out for its reshape to x's (B, S, d): each
    mesh dim that shards x's batch shards the tokens (B-major, so the same
    rows), any other replicates.  An identity on plain tensors."""
    if not is_dtensor(out):
        return out
    from torch.distributed.tensor import Replicate, Shard
    place = [Shard(0) if pl == Shard(0) else Replicate()
             for pl in x.placements]
    return out.redistribute(out.device_mesh, place)


def _whole(t: torch.Tensor):
    """(the plain tensor every rank holds whole, a function putting a plain
    tensor back as a replicated DTensor on ``t``'s mesh); for a plain ``t``
    (t, identity)."""
    if not is_dtensor(t):
        return t, lambda u: u
    from torch.distributed.tensor import DTensor, Replicate
    mesh = t.device_mesh
    local = constrain(t, (None,) * t.ndim).to_local()
    return local, lambda u: DTensor.from_local(
        u, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _shared(p: Dict, xt: torch.Tensor) -> torch.Tensor:
    return mlp_apply({"w_gate": p["shared_w_gate"],
                      "w_in": p["shared_w_in"],
                      "w_out": p["shared_w_out"]}, xt, "swiglu")


def _router_logits(p: Dict, xt: torch.Tensor) -> torch.Tensor:
    """(N, d) tokens -> float32 (N, E) logits."""
    return xt.to(p["router"].dtype) @ p["router"]


def moe_ffn(p: Dict, x: torch.Tensor, cfg: ArchConfig,
            dropless: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> (out (B,S,d), aux_loss float32 scalar).

    ``dropless=True`` sets the capacity to the number of tokens (no expert
    can overflow) and always takes the gather path: the decode step's
    semantics then do not depend on the batch's composition.  Otherwise
    ``cfg.moe_dispatch`` picks ``gather`` or ``einsum``."""
    if cfg.moe_dispatch == "einsum" and not dropless:
        return _moe_ffn_einsum(p, x, cfg)
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    N = B * S
    xt = x.reshape(N, d)
    C = N if dropless else _capacity(cfg, N)

    logits, back = _whole(_router_logits(p, xt).to(torch.float32))
    probs, gate_vals, gate_idx = _route(logits, K)
    pos = _slot_positions(gate_idx, E)
    keep = pos < C
    c_nk = torch.where(keep, pos, torch.full_like(pos, C))     # C = dropped
    # slot -> token map (E, C+1); the sentinel N points at a zero pad row.
    # Every dropped pair writes to column C, which is cut off.
    dev = logits.device
    tok_idx = torch.arange(N, device=dev)[:, None].expand(N, K)
    slot_tok = torch.full((E, C + 1), N, dtype=torch.int64, device=dev)
    slot_tok[gate_idx.reshape(-1), c_nk.reshape(-1)] = tok_idx.reshape(-1)
    w_nk = gate_vals * keep                                    # (N, K) f32
    ids = torch.arange(E, device=dev)
    weights = [p[k] for k in ("w_gate", "w_in", "w_out")]
    if is_dtensor(xt):
        out = _gather_sharded(xt, weights, ids, slot_tok, gate_idx, c_nk,
                              w_nk, back, C)
    else:
        out = _gather_experts(ids, *weights, xt, slot_tok, gate_idx, c_nk,
                              w_nk, C=C)
    out = constrain_token_major(out)
    if cfg.num_shared_experts:
        out = out + _shared(p, xt)
    # the aux loss is computed whole on every rank: it joins the loss as
    # a replicated DTensor through ``back``, so its gradient flows back
    # to the router's logits as a plain tensor
    return _as_tokens_of(out, x).reshape(B, S, d), \
        back(_aux_loss(probs, gate_idx[:, 0], E))


def _gather_experts(ids, wg, wi, wo, xt, slot_tok, gate_idx, c_nk, w_nk, *,
                    C: int) -> torch.Tensor:
    """The gather dispatch and combine over the experts ``ids`` (a run of
    consecutive expert ids; all E on one device, this rank's under a mesh),
    whose weights are ``wg`` / ``wi`` / ``wo``: the experts' (E_loc, C, d)
    buffers gathered through their rows of the slot map ``slot_tok`` (E,
    C+1) from ``xt`` (N, d), through the experts, and back, one (N, d)
    gather per k, in k order, each token weighted by ``w_nk`` (its gate
    value, 0 where dropped) where its k-th expert is one of ``ids`` and by
    0 elsewhere.  With all E ids every weight is the gate value as it was,
    so one device gets the reference's sums bit for bit."""
    N, d = xt.shape
    n_loc = wg.shape[0]
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))], 0)
    y = _experts({"w_gate": wg, "w_in": wi, "w_out": wo},
                 xt_pad[slot_tok[ids, :C]])                    # (E_loc, C, d)
    y_pad = torch.cat([y, y.new_zeros((n_loc, 1, d))], 1)
    out = torch.zeros((N, d), dtype=xt.dtype, device=xt.device)
    for k in range(gate_idx.shape[1]):
        e = gate_idx[:, k] - ids[0]
        here = (e >= 0) & (e < n_loc)
        w_k = (w_nk[:, k] * here).to(xt.dtype)
        out = out + y_pad[e.clamp(0, n_loc - 1), c_nk[:, k]] * w_k[:, None]
    return out


def _gather_sharded(xt, weights, ids, slot_tok, gate_idx, c_nk, w_nk, back,
                    C: int) -> torch.Tensor:
    """:func:`_gather_experts` under a mesh, through ``local_map``: the
    tokens and the routing tables whole on every rank, the expert ids and
    weights expert-major over the active expert axis (``sharding.
    expert_sharding``; every rank holds every expert without one), so each
    rank dispatches to and combines from its own experts, and the (N, d)
    output is a partial sum over that axis."""
    from torch.distributed.tensor import Partial, Replicate
    from repro_torch.models.sharding import local_map as sharding_local_map
    mesh = xt.device_mesh
    axis = expert_axis()
    e_spec = (axis,)
    args = [constrain(back(ids), e_spec)] + \
        [constrain(w, e_spec + (None,) * (w.ndim - 1)) for w in weights] + \
        [constrain(xt, (None, None))] + \
        [back(t) for t in (slot_tok, gate_idx, c_nk, w_nk)]
    out_pl = tuple(Partial() if axis is not None and name == axis
                   else Replicate() for name in mesh.mesh_dim_names)
    fn = sharding_local_map(functools.partial(_gather_experts, C=C),
                            (out_pl,), tuple(tuple(a.placements)
                                             for a in args), mesh)
    return fn(*args)


def _moe_ffn_einsum(p: Dict, x: torch.Tensor, cfg: ArchConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-hot matmul dispatch over token chunks of ``G = min(moe_chunk,
    N)`` (the last padded with zero rows, which route like any token and
    take capacity).  Capacity is per chunk: ``int(cf * G * K / E)``; the
    aux loss is the mean of the chunks'."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    N = B * S
    G = min(cfg.moe_chunk, N)
    n_chunks = -(-N // G)
    pad = n_chunks * G - N
    xt = x.reshape(N, d)
    if pad:
        xt = torch.cat([xt, xt.new_zeros((pad, d))], 0)
    C = max(int(cfg.capacity_factor * G * K / E), 1)
    logits_all, back = _whole(_router_logits(p, xt).to(torch.float32))

    outs, auxs = [], []
    for i in range(n_chunks):
        xg = xt[i * G:(i + 1) * G]
        probs, gate_vals, gate_idx = _route(logits_all[i * G:(i + 1) * G], K)
        pos = _slot_positions(gate_idx, E)
        keep = pos < C
        oh_e = F.one_hot(gate_idx, E).to(xg.dtype)             # (G, K, E)
        oh_c = F.one_hot(torch.where(keep, pos, torch.full_like(pos, C)),
                         C + 1).to(xg.dtype)[..., :C]          # (G, K, C)
        disp = constrain_token_major(back(
            torch.einsum("gke,gkc->gec", oh_e, oh_c)))         # (G, E, C)
        buf = torch.einsum("gec,gd->ecd", disp, xg)            # (E, C, d)
        y = _experts(p, buf)
        wk = (gate_vals * keep).to(xg.dtype)                   # (G, K)
        comb = back(torch.einsum("gke,gkc->gec", oh_e * wk[..., None],
                                 oh_c))
        outs.append(torch.einsum("gec,ecd->gd", comb, y))
        auxs.append(_aux_loss(probs, gate_idx[:, 0], E))
    out = torch.cat(outs, 0)[:N]
    if cfg.num_shared_experts:
        out = out + _shared(p, xt[:N])
    return _as_tokens_of(out, x).reshape(B, S, d), \
        back(torch.mean(torch.stack(auxs)))

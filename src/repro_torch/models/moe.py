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

The reference's sharding constraints (``constrain_expert_major`` /
``_token_major``) are identities on one device and have no counterpart.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ArchConfig, mlp_apply, silu


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
    counts = torch.bincount(e, minlength=E)
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
    """(E, C, d) buffers through each expert's SwiGLU: (E, C, d)."""
    h = silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_in"])
    return torch.bmm(h, p["w_out"])


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

    probs, gate_vals, gate_idx = _route(
        _router_logits(p, xt).to(torch.float32), K)
    pos = _slot_positions(gate_idx, E)
    keep = pos < C
    c_nk = torch.where(keep, pos, torch.full_like(pos, C))     # C = dropped
    # slot -> token map (E, C+1); the sentinel N points at a zero pad row.
    # Every dropped pair writes to column C, which is cut off.
    tok_idx = torch.arange(N, device=x.device)[:, None].expand(N, K)
    slot_tok = torch.full((E, C + 1), N, dtype=torch.int64, device=x.device)
    slot_tok[gate_idx.reshape(-1), c_nk.reshape(-1)] = tok_idx.reshape(-1)
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))], 0)
    y = _experts(p, xt_pad[slot_tok[:, :C]])                   # (E, C, d)

    # combine: one (N, d) gather per k, in k order
    y_pad = torch.cat([y, y.new_zeros((E, 1, d))], 1)
    out = torch.zeros((N, d), dtype=xt.dtype, device=x.device)
    for k in range(K):
        w_k = (gate_vals[:, k] * keep[:, k]).to(xt.dtype)
        out = out + y_pad[gate_idx[:, k], c_nk[:, k]] * w_k[:, None]
    if cfg.num_shared_experts:
        out = out + _shared(p, xt)
    return out.reshape(B, S, d), _aux_loss(probs, gate_idx[:, 0], E)


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
    logits_all = _router_logits(p, xt).to(torch.float32)       # (N', E)

    outs, auxs = [], []
    for i in range(n_chunks):
        xg = xt[i * G:(i + 1) * G]
        probs, gate_vals, gate_idx = _route(logits_all[i * G:(i + 1) * G], K)
        pos = _slot_positions(gate_idx, E)
        keep = pos < C
        oh_e = F.one_hot(gate_idx, E).to(xg.dtype)             # (G, K, E)
        oh_c = F.one_hot(torch.where(keep, pos, torch.full_like(pos, C)),
                         C + 1).to(xg.dtype)[..., :C]          # (G, K, C)
        disp = torch.einsum("gke,gkc->gec", oh_e, oh_c)        # (G, E, C)
        buf = torch.einsum("gec,gd->ecd", disp, xg)            # (E, C, d)
        y = _experts(p, buf)
        wk = (gate_vals * keep).to(xg.dtype)                   # (G, K)
        comb = torch.einsum("gke,gkc->gec", oh_e * wk[..., None], oh_c)
        outs.append(torch.einsum("gec,ecd->gd", comb, y))
        auxs.append(_aux_loss(probs, gate_idx[:, 0], E))
    out = torch.cat(outs, 0)[:N]
    if cfg.num_shared_experts:
        out = out + _shared(p, xt[:N])
    return out.reshape(B, S, d), torch.mean(torch.stack(auxs))

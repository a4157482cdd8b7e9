"""Attention (port of the GQA and MLA parts of
``repro.models.attention``): grouped-query attention with RoPE, a sliding
window, a logit softcap and QKV bias, and DeepSeek-V2's multi-head latent
attention (MLA), each for a full sequence (``gqa_prefill`` /
``mla_prefill``, causal) and for one new token against a fixed-size cache
(``gqa_decode`` on K/V, ``mla_decode`` with the absorbed matrices on the
latent ``(ckv, krope)`` cache).

The reference computes attention in ``jnp``, in no Pallas kernel, and so
does the port, in torch ops (``einsum``, ``softmax``, a loop over blocks),
in the reference's order of casts:

* the dense path (``_sdpa``, S < ``QBLOCK_THRESHOLD``) scales the logits in
  the input dtype, by the scale rounded to it as JAX rounds a Python
  scalar, and casts them to float32 only at the mask;
* the streaming path (``_flash_sdpa``, S >= ``QBLOCK_THRESHOLD``, taken in
  ``QBLOCK``-query blocks over ``KBLOCK``-key blocks with an online
  softmax) casts to float32 before it scales;
* on both, the probabilities go back to the input dtype before the PV
  product.

No (S, T) logits matrix exists on the streaming path: one (B, G, R,
QBLOCK, KBLOCK) block at a time.  The reference rematerialises each block
in its backward pass; inside :func:`remat_rows` (which ``lm``'s
``remat=True`` sets in each checkpointed body) and where autograd
records, the port checkpoints each query block's row of key blocks
(``torch.utils.checkpoint``), so the backward keeps one row's
probabilities at a time and recomputes them from the row's inputs, the
same floats (a trainer's memory, not its numbers).  Outside it autograd
keeps every block's probabilities.  The reference
scans every key block; the port skips the blocks whose every key the mask
hides from the query block (causally later, or past the window), which
leaves the carry exactly as it was: such a block adds p = 0 and rescales
by alpha = 1 (or keeps the empty carry at zero).  MLA takes the same two
paths with the same cast orders, but for one step: its streaming path
adds its two logit products (the latent part and the RoPE part) in
float32, as the reference's compiled scan body does.

Cross attention (``cross_attn`` from fresh K/V, ``cross_attn_cached``
against K/V made once by ``cross_kv``) serves the VLM's image layers and
the encoder-decoder's decoder: no mask and no RoPE, the logits scaled in
the input dtype by the rounded scale, the softmax in float32, the
probabilities back in the input dtype.  With no mask each query's row is
independent of the others, so a long query sequence is taken in blocks
of ``CROSS_QBLOCK`` queries, which caps the (B, G, R, S, T) logits'
transient at one block's and leaves every row's sums as they were.
"""
from __future__ import annotations

import contextvars
import functools
from contextlib import contextmanager
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import sharding
from repro_torch.models.common import ArchConfig, dtype_scalar, rope, softcap

NEG_INF = -2.0e38
#: ``torch.einsum`` on plain tensors; on DTensors a local-shard einsum
_einsum = sharding.einsum

#: sequences at or above this length take the streaming softmax
QBLOCK_THRESHOLD = 2048
QBLOCK = 512
KBLOCK = 512
#: cross attention takes its queries in blocks of this many
CROSS_QBLOCK = 1024


def _gqa_logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,S,G,R,hd), k: (B,T,G,hd) -> (B,G,R,S,T)."""
    return _einsum("bsgrk,btgk->bgrst", q, k)


def _causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                        window: int) -> torch.Tensor:
    """True where attention is allowed.  q_pos: (S,), k_pos: (T,);
    ``window`` 0 is full causal attention."""
    causal = k_pos[None, :] <= q_pos[:, None]
    if window <= 0:
        return causal
    return causal & ((q_pos[:, None] - k_pos[None, :]) < window)


def _masked(mask: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """float32 ``logits`` where ``mask`` (broadcast over the leading
    (B, G, R) axes), NEG_INF elsewhere."""
    return torch.where(mask, logits.to(torch.float32),
                       torch.full((), NEG_INF, dtype=torch.float32,
                                  device=logits.device))


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          q_pos: torch.Tensor, k_pos: torch.Tensor, window: int, cap: float,
          scale: float) -> torch.Tensor:
    """q: (B,Sq,G,R,hd); k/v: (B,T,G,hd) -> (B,Sq,G,R,hd)."""
    logits = softcap(_gqa_logits(q, k) * dtype_scalar(scale, q.dtype), cap)
    logits = _masked(_causal_window_mask(q_pos, k_pos, window), logits)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return _einsum("bgrst,btgk->bsgrk", probs, v)


def _visible_blocks(S: int, window: int) -> list:
    """(S // QBLOCK) lists of (S // KBLOCK) bools: whether the mask lets any
    query of q block i see any key of key block j, for the positions
    0..S-1 of a prefill (``lm._positions`` is an arange).  Reckoned from
    the ints alone, so it reads no tensor (a ``meta`` or sharded trace has
    no position values): block i's query minus block j's key position
    takes every integer from ``i QBLOCK - (j + 1) KBLOCK + 1`` to ``(i + 1)
    QBLOCK - 1 - j KBLOCK``, and a pair is visible where that difference
    is in [0, window) (in [0, inf) with no window)."""
    nq, nk = S // QBLOCK, S // KBLOCK
    rows = []
    for i in range(nq):
        row = []
        for j in range(nk):
            lo = i * QBLOCK - (j + 1) * KBLOCK + 1
            hi = (i + 1) * QBLOCK - 1 - j * KBLOCK
            top = hi if window <= 0 else min(hi, window - 1)
            row.append(max(lo, 0) <= top)
        rows.append(row)
    return rows


def _flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
                cap: float, scale: float, blocks=None) -> torch.Tensor:
    """Streaming (online-softmax) attention for one q block.

    q: (B,Q,G,R,hd); k/v: (B,T,G,hd) with T % KBLOCK == 0.  The loop walks
    the key blocks carrying (acc, running max, running denominator);
    ``blocks`` (one bool a key block) skips the blocks the mask hides
    entirely, which would leave the carry as it is."""
    B, Q, G, R, hd = q.shape
    T = k.shape[1]
    f32 = torch.float32
    acc = torch.zeros((B, G, R, Q, hd), dtype=f32, device=q.device)
    mx = torch.full((B, G, R, Q), NEG_INF, dtype=f32, device=q.device)
    den = torch.zeros((B, G, R, Q), dtype=f32, device=q.device)
    neg = torch.full((), NEG_INF, dtype=f32, device=q.device)
    zero = torch.zeros((), dtype=f32, device=q.device)
    for j in range(T // KBLOCK):
        if blocks is not None and not blocks[j]:
            continue
        sl = slice(j * KBLOCK, (j + 1) * KBLOCK)
        logits = _einsum("bqgrk,btgk->bgrqt", q, k[:, sl]).to(f32) \
            * scale
        logits = softcap(logits, cap)
        mask = _causal_window_mask(q_pos, k_pos[sl], window)   # (Q, KBLOCK)
        logits = torch.where(mask, logits, neg)
        new_mx = torch.maximum(mx, torch.amax(logits, -1))
        # new_mx == NEG_INF only while no key is visible yet; keep alpha
        # and p finite there (the row contributes nothing)
        safe_mx = torch.where(new_mx <= NEG_INF, zero, new_mx)
        alpha = torch.exp(torch.where(mx <= NEG_INF, neg, mx) - safe_mx)
        p = torch.exp(logits - safe_mx[..., None])
        p = torch.where(mask, p, zero)
        den = den * alpha + torch.sum(p, -1)
        acc = acc * alpha[..., None] + _einsum(
            "bgrqt,btgk->bgrqk", p.to(q.dtype), v[:, sl]).to(f32)
        mx = new_mx
    out = acc / torch.clamp(den, min=1e-30)[..., None]
    return torch.movedim(out, 3, 1).to(q.dtype)          # (B,Q,G,R,hd)


def _project_qkv(p: Dict, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ArchConfig):
    q = _einsum("bsd,dhk->bshk", x, p["wq"])
    k = _einsum("bsd,dgk->bsgk", x, p["wk"])
    v = _einsum("bsd,dgk->bsgk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def _on_local_heads(core, heads, shared, k_pos: Optional[torch.Tensor]):
    """``core(*heads, *shared, k_pos)`` where the tensors are DTensors: on
    this rank's batch rows and heads, through ``local_map``, so the
    attention's block loop runs as plain local ops (the same ops, on the
    local shards).  ``heads`` are (B,S,n,hd) tensors, the queries' (n = H)
    first and the keys' / values' (n = G) after them; ``shared`` are
    (B,S,r) tensors every head reads (MLA's RoPE key); ``k_pos`` (S,) the
    key positions, replicated (None: the core takes none).  Batch lies
    over the data axes where it divides; heads over "model" where G
    divides (H then does too, in whole groups), or where only H divides,
    the keys and values repeated to H heads first (each query head beside
    its group's K/V); otherwise the batch rows over "model" as well where
    they divide (a row's attention is its own: the rank computes every
    head of its rows, not every head of every row), or every rank holds
    every head of its rows.  Returns the core's (B,S,H,hd') output as a
    DTensor laid out as the queries are."""
    from repro_torch.models import sharding as sh
    q = heads[0]
    mesh = q.device_mesh
    B, H, G = q.shape[0], q.shape[2], heads[-1].shape[2]
    tp = sh.tp_size(mesh)
    b_ax = sh.dp_axes(mesh) if B % sh.dp_size(mesh) == 0 else None
    kv = list(heads[1:])
    if sh.divides(G, tp):
        h_ax = "model"
    elif sh.divides(H, tp):
        h_ax = "model"
        kv = [t.repeat_interleave(H // G, 2) if t.shape[2] == G else t
              for t in kv]
    else:
        h_ax = None
        if tp > 1 and B % (sh.dp_size(mesh) * tp) == 0:
            b_ax = tuple(b_ax or ()) + ("model",)
    head_spec, shared_spec = (b_ax, None, h_ax, None), (b_ax, None, None)
    args = [sh.constrain(t, head_spec, mesh) for t in [q] + kv] + \
        [sh.constrain(t, shared_spec, mesh) for t in shared] + \
        ([] if k_pos is None else [sh.constrain(k_pos, (None,), mesh)])
    fn = sh.local_map(core, (tuple(sh.to_placements(head_spec, mesh)),),
                      tuple(tuple(a.placements) for a in args), mesh)
    return fn(*args)


def _gqa_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              k_pos: torch.Tensor, *, window: int, cap: float,
              scale: float) -> torch.Tensor:
    """Causal attention of q (B,S,H,hd) over k/v (B,S,G,hd) at positions
    ``k_pos`` (S,) (0..S-1): (B,S,H,hd), dense below QBLOCK_THRESHOLD and
    streaming from there."""
    B, S, H, hd = q.shape
    G = k.shape[2]
    q = q.reshape(B, S, G, H // G, hd)
    if S < QBLOCK_THRESHOLD or S % QBLOCK != 0 or S % KBLOCK != 0:
        out = _sdpa(q, k, v, k_pos, k_pos, window, cap, scale)
    else:
        remat = _records(q)
        visible = _stream_rows(q, _visible_blocks(S, window), remat)
        out = _cat_rows([
            _row(remat, functools.partial(_flash_sdpa, window=window,
                                          cap=cap, scale=scale, blocks=row),
                 q[:, i * QBLOCK:(i + 1) * QBLOCK], k, v,
                 k_pos[i * QBLOCK:(i + 1) * QBLOCK], k_pos)
            if row is not None else None
            for i, row in enumerate(visible)])
    return out.reshape(B, S, H, hd)


_REMAT_ROWS: "contextvars.ContextVar" = contextvars.ContextVar(
    "attention_remat_rows", default=False)


@contextmanager
def remat_rows():
    """Checkpoint the streaming loop's rows where autograd records (the
    switch ``lm``'s ``remat=True`` sets inside each checkpointed body, so
    the backward's recompute sets it too)."""
    tok = _REMAT_ROWS.set(True)
    try:
        yield
    finally:
        _REMAT_ROWS.reset(tok)


def _records(q: torch.Tensor) -> bool:
    """True inside :func:`remat_rows` where autograd records the
    attention (a train step under ``remat``)."""
    return _REMAT_ROWS.get() and torch.is_grad_enabled() and q.requires_grad


def _row(remat: bool, fn, *args):
    """One query block's row of the streaming loop, ``fn(*args)``; with
    ``remat`` under ``torch.utils.checkpoint``: its blocks' temporaries
    are not kept for the backward, which recomputes them."""
    if not remat:
        return fn(*args)
    from torch.utils.checkpoint import checkpoint
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _stream_rows(q: torch.Tensor, visible: list, remat: bool) -> list:
    """The streaming loop's rows of visible key blocks.  On ``meta`` (a dry
    run's trace: shapes, no values) the trace keeps a few ops a layer
    where every block would be thousands, each a Python-level meta op,
    and the live-bytes peak stays what every block gives: without
    ``remat``, the first query block keeps one key block and the
    others none (None), as a block's temporaries have the same shapes
    whichever block it is and are freed with it (a forward's count);
    with ``remat`` (each row checkpointed, its temporaries alive only while
    the backward recomputes that row, one row at a time), the row with
    the most visible blocks keeps them all, which is the most the
    backward holds at once, and the others none."""
    if q.device.type != "meta":
        return visible
    if remat:
        top = max(range(len(visible)), key=lambda i: sum(visible[i]))
        return [row if i == top else None for i, row in enumerate(visible)]
    return [[j == 0 for j in range(len(visible[0]))]] + \
        [None] * (len(visible) - 1)


def _cat_rows(outs: list) -> torch.Tensor:
    """Query blocks' outputs joined on the sequence dim, a block that
    :func:`_stream_rows` left out (None) as an empty block of a computed
    one's shape."""
    like = next(o for o in outs if o is not None)
    return torch.cat([o if o is not None else torch.empty_like(like)
                      for o in outs], 1)


def gqa_prefill(p: Dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig, *, window: int = 0,
                scale: Optional[float] = None) -> torch.Tensor:
    """x: (B,S,d) -> (B,S,d); positions: (B,S), each row 0..S-1.  On
    DTensors the attention core runs on the local heads
    (:func:`_on_local_heads`)."""
    q, k, v = _project_qkv(p, x, positions, cfg)
    core = functools.partial(_gqa_core, window=window,
                             cap=cfg.attn_logit_softcap,
                             scale=scale or cfg.head_dim ** -0.5)
    if sharding.is_dtensor(q):
        out = _on_local_heads(core, (q, k, v), (), positions[0])
    else:
        out = core(q, k, v, positions[0])
    return _einsum("bshk,hkd->bsd", out, p["wo"])


def gqa_decode(p: Dict, x: torch.Tensor, t: int, cache: Dict,
               cfg: ArchConfig, *, window: int = 0, ring: bool = False,
               scale: Optional[float] = None
               ) -> Tuple[torch.Tensor, Dict]:
    """x: (B,1,d); cache {"k","v"}: (B,T,G,hd), written in place; t: the
    ABSOLUTE position (a Python int).

    ``ring=True`` treats the cache as a rolling buffer of the last T tokens
    (sliding-window decode: write at ``t % T``; keys carry their absolute
    RoPE phase, so the mask is only 'slot already written').  Without a
    ring the token is written at ``t``, clamped to T - 1 as
    ``lax.dynamic_update_slice`` clamps its start index, and the window
    mask applies."""
    B = x.shape[0]
    H, G, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    R = H // G
    T = cache["k"].shape[1]
    t = int(t)
    write_at = t % T if ring else min(max(t, 0), T - 1)
    pos = torch.full((B, 1), t, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, pos, cfg)
    cache["k"][:, write_at] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, write_at] = v[:, 0].to(cache["v"].dtype)
    if sharding.is_dtensor(cache["k"]):
        q = _like_cache(q, cache["k"])
    q = q.reshape(B, 1, G, R, hd)
    logits = _gqa_logits(q, cache["k"]) * dtype_scalar(scale or hd ** -0.5,
                                                        q.dtype)
    logits = softcap(logits, cfg.attn_logit_softcap)
    k_pos = torch.arange(T, device=x.device)
    ok = k_pos <= t                       # ring: all-true once t >= T
    if not ring and window > 0:
        ok = ok & ((t - k_pos) < window)
    probs = torch.softmax(_masked(ok, logits), dim=-1).to(x.dtype)
    out = _einsum("bgrst,btgk->bsgrk", probs,
                       cache["v"]).reshape(B, 1, H, hd)
    return _einsum("bshk,hkd->bsd", out, p["wo"]), cache


def _like_cache(q, k_cache):
    """The decode query (B,1,H,hd) laid out as the (B,T,G,hd) cache it reads:
    over each mesh dim that shards the cache's batch, its heads (G divides
    there, so H does, in whole groups) or its head_dim, the query's same
    dim; replicated where the cache shards its sequence (context-parallel
    decode) or nothing.  The grouped view (B,1,G,R,hd) then keeps the
    shards, where heads split over more ranks than there are groups could
    not."""
    from torch.distributed.tensor import Replicate, Shard
    place = [Shard(p.dim) if type(p) is Shard and p.dim in (0, 2, 3)
             else Replicate() for p in k_cache.placements]
    return q.redistribute(q.device_mesh, place)


# ---------------------------------------------------------------------------
# MLA — DeepSeek-V2 multi-head latent attention
# ---------------------------------------------------------------------------

def _mla_flash(qn: torch.Tensor, qr: torch.Tensor, k_nope: torch.Tensor,
               k_rope: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
               k_pos: torch.Tensor, scale: float, blocks=None
               ) -> torch.Tensor:
    """Streaming softmax of one q block over the KBLOCK-key blocks.
    qn: (B,Q,H,dn), qr: (B,Q,H,dr); k_nope: (B,T,H,dn), k_rope: (B,T,dr),
    v: (B,T,H,dv) -> (B,Q,H,dv).  ``blocks`` skips the key blocks the
    causal mask hides entirely, as :func:`_flash_sdpa` does.  The two
    logit products are added in float32: the reference's compiled scan
    body keeps their sum there (XLA drops the sum's round trip through
    bf16, which the dense path, run op by op, makes)."""
    B, Q, H, _ = qn.shape
    T, dv = k_nope.shape[1], v.shape[-1]
    f32 = torch.float32
    acc = torch.zeros((B, H, Q, dv), dtype=f32, device=qn.device)
    mx = torch.full((B, H, Q), NEG_INF, dtype=f32, device=qn.device)
    den = torch.zeros((B, H, Q), dtype=f32, device=qn.device)
    neg = torch.full((), NEG_INF, dtype=f32, device=qn.device)
    zero = torch.zeros((), dtype=f32, device=qn.device)
    for j in range(T // KBLOCK):
        if blocks is not None and not blocks[j]:
            continue
        sl = slice(j * KBLOCK, (j + 1) * KBLOCK)
        logits = (_einsum("bqhk,bthk->bhqt", qn, k_nope[:, sl]).to(f32)
                  + _einsum("bqhk,btk->bhqt", qr, k_rope[:, sl]).to(f32)
                  ) * scale
        mask = _causal_window_mask(q_pos, k_pos[sl], 0)         # (Q, KBLOCK)
        logits = torch.where(mask, logits, neg)
        new_mx = torch.maximum(mx, torch.amax(logits, -1))
        safe_mx = torch.where(new_mx <= NEG_INF, zero, new_mx)
        alpha = torch.exp(torch.where(mx <= NEG_INF, neg, mx) - safe_mx)
        pr = torch.exp(logits - safe_mx[..., None])
        pr = torch.where(mask, pr, zero)
        den = den * alpha + torch.sum(pr, -1)
        acc = acc * alpha[..., None] + _einsum(
            "bhqt,bthk->bhqk", pr.to(qn.dtype), v[:, sl]).to(f32)
        mx = new_mx
    out = acc / torch.clamp(den, min=1e-30)[..., None]
    return torch.movedim(out, 2, 1).to(qn.dtype)          # (B,Q,H,dv)


def mla_prefill(p: Dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    """x: (B,S,d) -> (B,S,d); positions: (B,S).  K and V come up from the
    rank-r latent ``ckv`` (no norm on it, as in the reference); the RoPE
    part of the key is one head shared by all."""
    B, S, _ = x.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = _einsum("bsd,dhk->bshk", x, p["wq"])          # (B,S,H,dn+dr)
    q_nope = q[..., :dn]
    q_rope = rope(q[..., dn:], positions, cfg.rope_theta)
    ckv = _einsum("bsd,dr->bsr", x, p["w_dkv"])       # (B,S,r)
    k_rope = rope(_einsum("bsd,dk->bsk", x, p["w_krope"])[:, :, None],
                  positions, cfg.rope_theta)[:, :, 0]      # (B,S,dr)
    k_nope = _einsum("bsr,rhk->bshk", ckv, p["w_uk"])
    v = _einsum("bsr,rhk->bshk", ckv, p["w_uv"])
    if sharding.is_dtensor(q_nope):
        out = _on_local_heads(_mla_core, (q_nope, q_rope, k_nope, v),
                              (k_rope,), positions[0])
    else:
        out = _mla_core(q_nope, q_rope, k_nope, v, k_rope, positions[0])
    return _einsum("bshk,hkd->bsd", out, p["wo"])


def _mla_core(q_nope: torch.Tensor, q_rope: torch.Tensor,
              k_nope: torch.Tensor, v: torch.Tensor, k_rope: torch.Tensor,
              k_pos: torch.Tensor) -> torch.Tensor:
    """MLA's causal attention: q_nope (B,S,H,dn), q_rope (B,S,H,dr), k_nope
    (B,S,H,dn), v (B,S,H,dv), the shared k_rope (B,S,dr) -> (B,S,H,dv),
    dense below QBLOCK_THRESHOLD and streaming from there."""
    S = q_nope.shape[1]
    scale = (q_nope.shape[-1] + q_rope.shape[-1]) ** -0.5
    if S < QBLOCK_THRESHOLD or S % QBLOCK != 0 or S % KBLOCK != 0:
        logits = (_einsum("bshk,bthk->bhst", q_nope, k_nope)
                  + _einsum("bshk,btk->bhst", q_rope, k_rope)) \
            * dtype_scalar(scale, q_nope.dtype)
        logits = _masked(_causal_window_mask(k_pos, k_pos, 0), logits)
        probs = torch.softmax(logits, -1).to(q_nope.dtype)
        return _einsum("bhst,bthk->bshk", probs, v)
    remat = _records(q_nope)
    visible = _stream_rows(q_nope, _visible_blocks(S, 0), remat)
    return _cat_rows([
        _row(remat, functools.partial(_mla_flash, scale=scale, blocks=row),
             q_nope[:, i * QBLOCK:(i + 1) * QBLOCK],
             q_rope[:, i * QBLOCK:(i + 1) * QBLOCK], k_nope, k_rope, v,
             k_pos[i * QBLOCK:(i + 1) * QBLOCK], k_pos)
        if row is not None else None
        for i, row in enumerate(visible)])


def mla_decode(p: Dict, x: torch.Tensor, t: int, cache: Dict,
               cfg: ArchConfig) -> Tuple[torch.Tensor, Dict]:
    """Absorbed-matrix decode: attention runs in the rank-r latent space
    and the cache holds only ``ckv`` (B,T,r) and ``krope`` (B,T,dr),
    written in place at ``t`` (clamped to T - 1, as
    ``lax.dynamic_update_slice`` clamps its start index)."""
    B = x.shape[0]
    dn = cfg.qk_nope_head_dim
    dr = cfg.qk_rope_head_dim
    T = cache["ckv"].shape[1]
    t = int(t)
    write_at = min(max(t, 0), T - 1)
    pos = torch.full((B, 1), t, dtype=torch.int32, device=x.device)
    q = _einsum("bsd,dhk->bshk", x, p["wq"])
    q_nope = q[..., :dn]
    q_rope = rope(q[..., dn:], pos, cfg.rope_theta)
    ckv_new = _einsum("bsd,dr->bsr", x, p["w_dkv"])
    krope_new = rope(_einsum("bsd,dk->bsk", x, p["w_krope"])[:, :, None],
                     pos, cfg.rope_theta)[:, :, 0]
    cache["ckv"][:, write_at] = ckv_new[:, 0].to(cache["ckv"].dtype)
    cache["krope"][:, write_at] = krope_new[:, 0].to(cache["krope"].dtype)
    ckv, krope = cache["ckv"], cache["krope"]
    # absorb W_uk into the query: q_lat (B,1,H,r)
    q_lat = _einsum("bshk,rhk->bshr", q_nope, p["w_uk"])
    logits = (_einsum("bshr,btr->bhst", q_lat, ckv)
              + _einsum("bshk,btk->bhst", q_rope, krope)) \
        * dtype_scalar((dn + dr) ** -0.5, x.dtype)
    ok = torch.arange(T, device=x.device) <= t
    probs = torch.softmax(_masked(ok, logits), -1).to(x.dtype)
    out_lat = _einsum("bhst,btr->bshr", probs, ckv)    # latent output
    out = _einsum("bshr,rhk->bshk", out_lat, p["w_uv"])
    return _einsum("bshk,hkd->bsd", out, p["wo"]), cache


# ---------------------------------------------------------------------------
# cross attention — the VLM's image layers and the whisper decoder
# ---------------------------------------------------------------------------

def _cross_core(p: Dict, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    """x: (B,S,d) queries against k/v: (B,T,G,hd) -> (B,S,d): the logits
    scaled in x's dtype by the rounded scale, the softmax in float32, the
    probabilities cast back before the PV product."""
    q = _einsum("bsd,dhk->bshk", x, p["wq"])
    if sharding.is_dtensor(q):
        out = _on_local_heads(_cross_attend, (q, k, v), (), None)
    else:
        out = _cross_attend(q, k, v)
    return _einsum("bshk,hkd->bsd", out, p["wo"])


def _cross_attend(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Unmasked attention of q (B,S,H,hd) over k/v (B,T,G,hd): (B,S,H,hd)."""
    B, S, H, hd = q.shape
    G = k.shape[2]
    q = q.reshape(B, S, G, H // G, hd)
    logits = _gqa_logits(q, k) * dtype_scalar(hd ** -0.5, q.dtype)
    probs = torch.softmax(logits.to(torch.float32), -1).to(q.dtype)
    return _einsum("bgrst,btgk->bsgrk", probs, v).reshape(B, S, H, hd)


def _cross_blocks(p: Dict, x: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """:func:`_cross_core` over blocks of ``CROSS_QBLOCK`` queries, or in
    one piece when S fits one block."""
    qb, S = CROSS_QBLOCK, x.shape[1]
    if S <= qb:
        return _cross_core(p, x, k, v, cfg)
    return torch.cat([_cross_core(p, x[:, i:i + qb], k, v, cfg)
                      for i in range(0, S, qb)], 1)


def cross_kv(p: Dict, kv_src: torch.Tensor, cfg: ArchConfig) -> Dict:
    """K and V (B,T,G,hd) of the encoder / image states kv_src (B,T,d)."""
    return {"k": _einsum("btd,dgk->btgk", kv_src, p["wk"]),
            "v": _einsum("btd,dgk->btgk", kv_src, p["wv"])}


def cross_attn(p: Dict, x: torch.Tensor, kv_src: torch.Tensor,
               cfg: ArchConfig) -> torch.Tensor:
    """x: (B,S,d) queries; kv_src: (B,T,d) encoder / image states."""
    kv = cross_kv(p, kv_src, cfg)
    return _cross_blocks(p, x, kv["k"], kv["v"], cfg)


def cross_attn_cached(p: Dict, x: torch.Tensor, kv: Dict,
                      cfg: ArchConfig) -> torch.Tensor:
    """Cross attention against precomputed K/V ({"k", "v"}: (B,T,G,hd),
    from :func:`cross_kv`)."""
    return _cross_blocks(p, x, kv["k"], kv["v"], cfg)

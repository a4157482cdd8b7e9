"""Language-model assembly (port of ``repro.models.lm``: the ``ssm``
family, the homogeneous transformer stack — dense GQA, or MLA and routed
experts for the ``moe`` family — gemma3's grouped local/global stack,
the ``hybrid`` family, Mamba2 layers with one shared transformer block
run before every ``hybrid_attn_every``-th of them, the ``vlm`` family, a
gated cross-attention block to the image embeddings after every
``cross_attn_every``-th layer, and the ``audio`` family, an encoder over
the frame embeddings and a decoder with a cross block to the encoder's
states after every layer): the training / prefill forward and loss, and
the serving cache and decode step.

    forward(cfg, params, tokens, image_embeds=None, frames=None,
            last_only=False, seq_shard=None, remat=False) -> (logits, aux)
    loss_fn(cfg, params, batch, seq_shard=None, remat=False)
            -> (scalar, metrics)
    init_cache(cfg, batch, seq, image_kv=None, enc_kv=None, device=...)
    make_image_kv(cfg, params, image_embeds) / make_enc_kv(cfg, params,
                  frames) -> the cross K/V of every cross block
    decode_step(cfg, params, cache, token, t) -> (logits (B,V), cache)

The reference scans the stacked layers under ``jax.checkpoint``; the port
loops over them, and with ``remat=True`` runs each scanned body (a layer,
with its cross or shared block; one of gemma3's groups; an encoder layer)
under ``torch.utils.checkpoint``: the backward keeps only each body's
input and recomputes the rest, the same floats in the same order, so the
gradients are those of ``remat=False`` bit for bit.  Inside such a body
the streaming attention also checkpoints each query block's row
(:func:`attention.remat_rows`), as the reference's blocks remat.  The
default is ``remat=False`` (every activation kept); the sharded trainer's loss
(:func:`repro_torch.launch.specs.train_spec`) sets it, as the
reference's train path does.  Each stacked leaf is ``unbind``-ed once,
so its gradient is assembled by one stack rather than one full-size
scatter per layer; the
hybrid family's shared block is one tree used at every one of its
positions, so autograd sums its gradient over the uses.  The decode step
updates the stacked cache in place, layer by layer: the SSM family's conv
window and state, the transformer's KV cache (ring buffers of the sliding
window where the config has one), MLA's latent cache, gemma3's local
rings and global caches, the hybrid family's Mamba2 caches and the
shared block's K/V cache of each use, or the cross families' self K/V
under ``kv`` beside the cross K/V under ``cross``, which the decode reads
and never writes.  The whisper encoder is the causal transformer block
with RoPE positions, as the reference's is (a stub it keeps on purpose).
Any other ``arch_type`` raises NotImplementedError, naming it.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import sharding
from repro_torch.models.blocks import (block_decode, block_prefill,
                                       cross_block, mamba_block_decode,
                                       mamba_block_prefill)
from repro_torch.models.common import ArchConfig, dtype_scalar, rms_norm
from repro_torch.models.init import require_ported


def _embed(cfg: ArchConfig, params: Dict, tokens: torch.Tensor
           ) -> torch.Tensor:
    """The token embeddings; gemma's are scaled by sqrt(d_model) rounded
    to the model dtype first (the reference multiplies by
    ``jnp.asarray(d ** 0.5, x.dtype)``: 62.0 for d = 3,840 in bf16)."""
    table = params["embed"]
    x = _vocab_parallel_embed(table, tokens) if sharding.is_dtensor(table) \
        else table[tokens]
    if cfg.arch_type == "dense" and cfg.global_every:
        x = x * dtype_scalar(cfg.d_model ** 0.5, x.dtype)
    return x


def _lookup(ids: torch.Tensor, table: torch.Tensor,
            tokens: torch.Tensor) -> torch.Tensor:
    """Rows of a table shard: ``table`` holds the vocabulary rows ``ids``
    (consecutive); each token outside them takes a zero row."""
    local = tokens.to(torch.int64) - ids[0]
    here = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    return torch.where(here[..., None], rows, torch.zeros_like(rows))


def _vocab_parallel_embed(table: torch.Tensor,
                          tokens: torch.Tensor) -> torch.Tensor:
    """The embedding lookup on DTensors, through ``local_map``: each rank
    looks its tokens up in its own vocabulary rows (the table's spec
    splits the vocabulary over "model"), the others' rows zero, and the
    (B, S, d) result is a partial sum over the mesh dims that split the
    vocabulary (Megatron's vocab-parallel embedding; DTensor's own rule
    for a row-split gather is missing in some torch releases)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    table = table.redistribute(mesh, [Shard(0) if i in vocab else
                                      Replicate() for i in range(mesh.ndim)])
    tokens = sharding.constrain(tokens, (None,) * tokens.ndim, mesh) \
        if not sharding.is_dtensor(tokens) else tokens
    tokens = tokens.redistribute(mesh, [
        Replicate() if i in vocab else p
        for i, p in enumerate(tokens.placements)])
    ids = sharding.constrain(torch.arange(table.shape[0],
                                          device=tokens.to_local().device),
                             (None,), mesh)
    ids = ids.redistribute(mesh, list(table.placements))
    out = tuple(Partial() if i in vocab else p
                for i, p in enumerate(tokens.placements))
    fn = sharding.local_map(_lookup, (out,), (tuple(ids.placements),
                                              tuple(table.placements),
                                              tuple(tokens.placements)),
                            mesh)
    return fn(ids, table, tokens)


def _logits(cfg: ArchConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].t()
    return x @ params["lm_head"]


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32,
                        device=device)[None].expand(B, S)


def _per_layer(tree: Dict, n: int):
    """The stacked leaves of ``tree`` (nested dicts allowed) as one tree
    per layer (one ``unbind`` per leaf)."""
    per = {k: _per_layer(v, n) if isinstance(v, dict) else v.unbind(0)
           for k, v in tree.items()}
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


def _groups(cfg: ArchConfig, local: Dict, glob: Dict):
    """gemma3's stacked (n_groups, n_local, ...) local and (n_groups, ...)
    global trees as one (local layers, global layer) pair per group."""
    n_groups = cfg.num_layers // cfg.global_every
    n_local = cfg.global_every - 1
    return [(_per_layer(lg, n_local), gg) for lg, gg in
            zip(_per_layer(local, n_groups), _per_layer(glob, n_groups))]


def _hybrid_slot(cfg: ArchConfig, idx: int) -> Optional[int]:
    """The hybrid family's shared block runs before Mamba2 layer ``idx``
    when ``idx % hybrid_attn_every == 0``; this returns the K/V cache of
    that use, ``idx // hybrid_attn_every``, or None where it does not
    run."""
    every = cfg.hybrid_attn_every
    return idx // every if idx % every == 0 else None


def _cross_slot(cfg: ArchConfig, idx: int) -> Optional[int]:
    """The VLM's cross block ``idx // cross_attn_every`` runs after layer
    ``idx`` when ``idx % cross_attn_every == cross_attn_every - 1`` (layers
    4, 9, ..., 39 of llama-3.2-vision's 40); None where none runs."""
    every = cfg.cross_attn_every
    return idx // every if idx % every == every - 1 else None


def _encoder_forward(cfg: ArchConfig, params: Dict,
                     frames: torch.Tensor, *, remat: bool = False
                     ) -> torch.Tensor:
    """The whisper encoder over the (stubbed) frame embeddings (B,F,d):
    the transformer block with RoPE positions and the causal mask, as the
    reference's encoder runs it, then ``enc_norm``; ``remat`` checkpoints
    each layer."""
    B, F, _ = frames.shape
    pos = _positions(B, F, frames.device)

    def body(h, lp):
        return block_prefill(lp, h, pos, cfg)[0]

    body = _maybe_remat(body, remat)
    x = frames
    for lp in _per_layer(params["enc_layers"], cfg.num_encoder_layers):
        x = body(x, lp)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _require(value, what: str, cfg: ArchConfig):
    if value is None:
        raise ValueError(f"{cfg.name} ({cfg.arch_type}) needs {what}")
    return value


def _maybe_remat(fn, remat: bool):
    """``fn`` itself, or ``fn`` whose activations the backward recomputes
    from its inputs (the reference's ``jax.checkpoint`` of a scanned
    body).  Nothing in a body draws random numbers, so no RNG state is
    kept; the expert axis (:func:`sharding.expert_sharding`) the forward
    ran under is set again for the recompute, which runs in the
    backward."""
    if not remat:
        return fn

    def run(*args):
        axis = sharding.expert_axis()

        def body(*a):
            with sharding.expert_sharding(axis), attn_lib.remat_rows():
                return fn(*a)
        return checkpoint(body, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return run


def forward(cfg: ArchConfig, params: Dict, tokens: torch.Tensor, *,
            image_embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            last_only: bool = False,
            seq_shard: Optional[str] = None,
            remat: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B,S,V_padded), aux_loss scalar).  The ``vlm``
    family needs ``image_embeds`` (B,T_img,d), the ``audio`` family
    ``frames`` (B,F,d).  ``last_only`` slices the hidden states to the
    final position BEFORE the vocab projection (serving prefill: no
    (B,S,V) logits).  ``seq_shard`` names the mesh axis the residual
    stream's sequence dim lies on between blocks (Megatron-SP;
    :func:`sharding.residual`).  ``remat`` checkpoints each scanned body
    (module docstring)."""
    require_ported(cfg)
    B, S = tokens.shape
    # the residual stream's layout between blocks on DTensors (the
    # sequence over ``seq_shard`` where set), where the reference
    # constrains it; an identity on plain tensors
    sc = functools.partial(sharding.residual, seq_axis=seq_shard)
    x = sc(_embed(cfg, params, tokens))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    pos = _positions(B, S, x.device)
    if cfg.arch_type == "vlm":
        image_embeds = _require(image_embeds, "image_embeds", cfg)
        cross = _per_layer(params["cross_layers"],
                           cfg.num_layers // cfg.cross_attn_every)

        def body(h, lp, cp):
            h, a = block_prefill(lp, sc(h), pos, cfg)
            if cp is not None:
                h = cross_block(cp, h, image_embeds, cfg)
            return h, a

        body = _maybe_remat(body, remat)
        for idx, lp in enumerate(_per_layer(params["layers"],
                                            cfg.num_layers)):
            slot = _cross_slot(cfg, idx)
            x, a = body(x, lp, None if slot is None else cross[slot])
            aux = aux + a
    elif cfg.arch_type == "audio":
        # remat passed only when set: the 3-argument form stays the one a
        # plain forward calls
        enc = _encoder_forward(cfg, params, _require(frames, "frames", cfg),
                               **({"remat": True} if remat else {}))

        def body(h, lp, cp):
            h, a = block_prefill(lp, sc(h), pos, cfg)
            return cross_block(cp, h, enc, cfg), a

        body = _maybe_remat(body, remat)
        for lp, cp in zip(_per_layer(params["layers"], cfg.num_layers),
                          _per_layer(params["cross_layers"],
                                     cfg.num_layers)):
            x, a = body(x, lp, cp)
            aux = aux + a
    elif cfg.arch_type == "ssm":
        def body(h, lp):
            return mamba_block_prefill(lp, sc(h), cfg)

        body = _maybe_remat(body, remat)
        for lp in _per_layer(params["layers"], cfg.num_layers):
            x = body(x, lp)
    elif cfg.arch_type == "hybrid":   # the shared block: full attention
        def body(h, lp, shared: bool):
            h = sc(h)
            if shared:
                h, _ = block_prefill(params["shared_attn"], h, pos, cfg)
            return mamba_block_prefill(lp, h, cfg)

        body = _maybe_remat(body, remat)
        for idx, lp in enumerate(_per_layer(params["layers"],
                                            cfg.num_layers)):
            x = body(x, lp, _hybrid_slot(cfg, idx) is not None)
    elif cfg.global_every:      # gemma3: groups of local layers + 1 global
        def group(h, local, glob):
            a1 = torch.zeros((), dtype=torch.float32, device=h.device)
            h = sc(h)
            for lp in local:
                h, a = block_prefill(lp, sc(h), pos, cfg,
                                     window=cfg.sliding_window)
                a1 = a1 + a
            h, a2 = block_prefill(glob, h, pos, cfg, window=0)
            return h, a1 + a2

        group = _maybe_remat(group, remat)
        for local, glob in _groups(cfg, params["local_layers"],
                                   params["global_layers"]):
            x, a = group(x, local, glob)
            aux = aux + a
    else:                       # the homogeneous stack (uniform window)
        def body(h, lp):
            return block_prefill(lp, sc(h), pos, cfg,
                                 window=cfg.sliding_window)

        body = _maybe_remat(body, remat)
        for lp in _per_layer(params["layers"], cfg.num_layers):
            x, a = body(x, lp)
            aux = aux + a
    if last_only:
        x = x[:, -1:]
    return _logits(cfg, params, x), aux


def loss_fn(cfg: ArchConfig, params: Dict, batch: Dict, *,
            seq_shard: Optional[str] = None, remat: bool = False
            ) -> Tuple[torch.Tensor, Dict]:
    logits, aux = forward(cfg, params, batch["tokens"],
                          image_embeds=batch.get("image_embeds"),
                          frames=batch.get("frames"), seq_shard=seq_shard,
                          remat=remat)
    labels = batch["labels"]
    # out-of-range labels are masked below; clamp them for the gather as
    # the reference's take_along_axis does
    idx = labels.clamp(0, logits.shape[-1] - 1).to(torch.int64)
    if _vocab_split(logits):
        nll = _vocab_parallel_nll(logits, idx)
    else:
        logp = F.log_softmax(logits.to(torch.float32), -1)
        nll = -torch.gather(logp, -1, idx[..., None])[..., 0]
    mask = (labels >= 0) & (labels < cfg.vocab_size)
    nll = torch.where(mask, nll, torch.zeros_like(nll))
    loss = torch.sum(nll) / torch.clamp(torch.sum(mask), min=1)
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux": aux}


def _vocab_split(logits) -> bool:
    """True where DTensor ``logits`` split their vocabulary over a mesh
    dim of more than one rank."""
    if not sharding.is_dtensor(logits):
        return False
    from torch.distributed.tensor import Shard
    mesh = logits.device_mesh
    return any(p == Shard(logits.ndim - 1) and mesh.size(m) > 1
               for m, p in enumerate(logits.placements))


def _pick(ids: torch.Tensor, logits: torch.Tensor,
          idx: torch.Tensor) -> torch.Tensor:
    """Each token's logit at ``idx`` from a vocabulary shard holding the
    ids ``ids`` (consecutive); zero where the label lies elsewhere."""
    local = idx - ids[0]
    here = (local >= 0) & (local < logits.shape[-1])
    val = torch.gather(logits, -1,
                       local.clamp(0, logits.shape[-1] - 1)[..., None])
    return torch.where(here, val[..., 0], torch.zeros_like(val[..., 0]))


def _vocab_parallel_nll(logits, idx):
    """-log softmax(logits)[idx] for logits split over the vocabulary
    (Megatron's vocab-parallel cross entropy, where the reference's
    compiler partitions the softmax): the max and the sum of exponentials
    are reduced over the vocabulary's mesh dims (one (B, S) all-reduce
    each) and each rank picks the labels in its own ids, so the logits are
    never gathered whole on a rank.  The max is a constant of the
    backward, as it cancels there."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = logits.device_mesh
    v = logits.ndim - 1
    lf = logits.to(torch.float32)
    m = torch.amax(lf.detach(), -1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.sum(torch.exp(lf - m), -1))
    ids = sharding.constrain(
        torch.arange(logits.shape[-1], device=lf.to_local().device),
        (None,), mesh)
    ids = ids.redistribute(mesh, [Shard(0) if p == Shard(v) else Replicate()
                                  for p in lf.placements])
    idx = sharding.constrain(idx, (None,) * idx.ndim, mesh) \
        if not sharding.is_dtensor(idx) else idx
    idx = idx.redistribute(mesh, [Replicate() if p == Shard(v) else p
                                  for p in lf.placements])
    out = tuple(Partial() if p == Shard(v) else q
                for p, q in zip(lf.placements, idx.placements))
    fn = sharding.local_map(_pick, (out,), (tuple(ids.placements),
                                            tuple(lf.placements),
                                            tuple(idx.placements)), mesh)
    return lse - fn(ids, lf, idx)


def _ssm_cache(cfg: ArchConfig, B: int, dev: torch.device) -> Dict:
    H, P, N, W = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state, cfg.conv_width
    cd = H * P + 2 * N
    L = cfg.num_layers
    return {"conv": torch.zeros((L, B, W - 1, cd), dtype=cfg.torch_dtype,
                                device=dev),
            "ssm": torch.zeros((L, B, H, N, P), dtype=torch.float32,
                               device=dev)}


def make_image_kv(cfg: ArchConfig, params: Dict,
                  image_embeds: torch.Tensor, *,
                  device=DEFAULT_DEVICE) -> Dict:
    """The VLM decode's cross K/V: each cross block's K and V of the image
    embeddings (B,T_img,d), stacked {"k", "v"}: (n_cross,B,T_img,G,hd), on
    ``device`` (where the parameters are)."""
    dev = resolve_device(device)
    return _stacked_cross_kv(cfg, params, image_embeds.to(dev))


def make_enc_kv(cfg: ArchConfig, params: Dict, frames: torch.Tensor, *,
                device=DEFAULT_DEVICE) -> Dict:
    """The whisper decode's cross K/V: the encoder over the frames
    (B,F,d), then each decoder layer's cross K and V of its states,
    stacked {"k", "v"}: (L,B,F,G,hd), on ``device``."""
    dev = resolve_device(device)
    enc = _encoder_forward(cfg, params, frames.to(dev))
    return _stacked_cross_kv(cfg, params, enc)


def _stacked_cross_kv(cfg: ArchConfig, params: Dict,
                      states: torch.Tensor) -> Dict:
    """:func:`attention.cross_kv` of ``states`` for every cross block,
    each written into its slot of one (n,B,T,G,hd) tensor as it is
    made."""
    cross = params["cross_layers"]
    n = cross["attn"]["wk"].shape[0]
    B, T, _ = states.shape
    shape = (n, B, T, cfg.num_kv_heads, cfg.head_dim)
    out = {k: torch.empty(shape, dtype=states.dtype, device=states.device)
           for k in ("k", "v")}
    for i, cp in enumerate(_per_layer(cross, n)):
        kv = attn_lib.cross_kv(cp["attn"], states, cfg)
        out["k"][i], out["v"][i] = kv["k"], kv["v"]
    return out


def init_cache(cfg: ArchConfig, batch: int, seq: int, *,
               image_kv: Optional[Dict] = None,
               enc_kv: Optional[Dict] = None,
               device=DEFAULT_DEVICE) -> Dict:
    """The decode cache for ``seq`` total positions on ``device``, in the
    model dtype but the SSM state: for the ``ssm`` family a conv window
    (L,B,W-1,Cd) and a float32 state (L,B,H,N,P), neither of which grows
    with ``seq``; for the ``hybrid`` family those under ``mamba`` and the
    shared block's K and V under ``attn``, (ceil(L / every),B,T,G,hd), T =
    ``seq``, one cache per use; for MLA the latent ``ckv`` (L,B,T,r) and ``krope``
    (L,B,T,dr), T = ``seq``; for gemma3's groups ``local`` rings
    (n_groups,n_local,B,min(W, seq),G,hd) and ``global`` K/V
    (n_groups,B,seq,G,hd); for the ``vlm`` and ``audio`` families the
    self K/V under ``kv``, (L,B,seq,G,hd), and the cross K/V they need
    under ``cross`` (``image_kv`` from :func:`make_image_kv`, ``enc_kv``
    from :func:`make_enc_kv`; held, not copied); else K and V of
    (L,B,T,G,hd), T = ``seq``, or ring buffers of T = min(sliding_window,
    seq) slots."""
    require_ported(cfg)
    dev = resolve_device(device)
    if cfg.arch_type == "ssm":
        return _ssm_cache(cfg, batch, dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)

    G, hd, L = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    if cfg.arch_type in ("vlm", "audio"):
        cross = image_kv if cfg.arch_type == "vlm" else enc_kv
        cross = _require(cross, "image_kv" if cfg.arch_type == "vlm"
                         else "enc_kv", cfg)
        return {"kv": {"k": zeros(L, batch, seq, G, hd),
                       "v": zeros(L, batch, seq, G, hd)},
                "cross": cross}
    if cfg.arch_type == "hybrid":
        uses = -(-L // cfg.hybrid_attn_every)
        return {"mamba": _ssm_cache(cfg, batch, dev),
                "attn": {"k": zeros(uses, batch, seq, G, hd),
                         "v": zeros(uses, batch, seq, G, hd)}}
    if cfg.use_mla:
        return {"ckv": zeros(L, batch, seq, cfg.kv_lora_rank),
                "krope": zeros(L, batch, seq, cfg.qk_rope_head_dim)}
    if cfg.global_every:
        n_groups = cfg.num_layers // cfg.global_every
        n_local = cfg.global_every - 1
        Wr = min(cfg.sliding_window, seq)
        return {"local": {"k": zeros(n_groups, n_local, batch, Wr, G, hd),
                          "v": zeros(n_groups, n_local, batch, Wr, G, hd)},
                "global": {"k": zeros(n_groups, batch, seq, G, hd),
                           "v": zeros(n_groups, batch, seq, G, hd)}}
    T = min(cfg.sliding_window, seq) if cfg.sliding_window else seq
    return {"k": zeros(L, batch, T, G, hd), "v": zeros(L, batch, T, G, hd)}


def decode_step(cfg: ArchConfig, params: Dict, cache: Dict,
                token: torch.Tensor, t) -> Tuple[torch.Tensor, Dict]:
    """token: (B,) int; t: the absolute position, a Python int (an SSM
    does not read it).  Returns (logits (B, V_padded), cache); the cache's
    tensors are updated in place and returned."""
    require_ported(cfg)
    x = _embed(cfg, params, token[:, None])
    if cfg.global_every:
        # local layers decode on their rings (ring=True, no window: the
        # ring holds the window); global layers on the full cache
        for (local, glob), (lcs, gc) in zip(
                _groups(cfg, params["local_layers"],
                        params["global_layers"]),
                _groups(cfg, cache["local"], cache["global"])):
            for lp, lc in zip(local, lcs):
                x, _ = block_decode(lp, x, t, lc, cfg, ring=True)
            x, _ = block_decode(glob, x, t, gc, cfg)
        return _logits(cfg, params, x)[:, 0], cache
    layers = _per_layer(params["layers"], cfg.num_layers)
    if cfg.arch_type in ("vlm", "audio"):
        n_cross = cache["cross"]["k"].shape[0]
        cross = _per_layer(params["cross_layers"], n_cross)
        cross_kv = _per_layer(cache["cross"], n_cross)
        for idx, (lp, lc) in enumerate(zip(
                layers, _per_layer(cache["kv"], cfg.num_layers))):
            x, _ = block_decode(lp, x, t, lc, cfg)
            slot = idx if cfg.arch_type == "audio" \
                else _cross_slot(cfg, idx)
            if slot is not None:
                x = cross_block(cross[slot], x, None, cfg,
                                kv=cross_kv[slot])
        return _logits(cfg, params, x)[:, 0], cache
    if cfg.arch_type == "hybrid":
        attn = _per_layer(cache["attn"], cache["attn"]["k"].shape[0])
        for idx, (lp, lc) in enumerate(zip(
                layers, _per_layer(cache["mamba"], cfg.num_layers))):
            slot = _hybrid_slot(cfg, idx)
            if slot is not None:
                x, _ = block_decode(params["shared_attn"], x, t,
                                    attn[slot], cfg)
            x, _ = mamba_block_decode(lp, x, lc, cfg)
        return _logits(cfg, params, x)[:, 0], cache
    caches = _per_layer(cache, cfg.num_layers)
    if cfg.arch_type == "ssm":
        for lp, lc in zip(layers, caches):
            x, _ = mamba_block_decode(lp, x, lc, cfg)
    else:
        ring = bool(cfg.sliding_window)
        for lp, lc in zip(layers, caches):
            x, _ = block_decode(lp, x, t, lc, cfg,
                                window=cfg.sliding_window, ring=ring)
    return _logits(cfg, params, x)[:, 0], cache

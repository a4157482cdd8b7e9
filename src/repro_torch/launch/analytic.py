"""Analytic compute / memory models for the roofline (port of
``repro.launch.analytic``; the same formulas, giving the same floats).

Why analytic: a trace on ``meta`` tensors computes nothing and counts no
FLOPs, and the reference's compiler counts loop bodies once.  The compute
and memory terms are therefore explicit formulas over the configs (below);
only the collective term comes from the traced program
(:mod:`repro_torch.launch.collectives`).  All numbers are TOTALS across
ranks per step; the roofline divides by (ranks x peak).

Formulas (B=batch, S=seq, T=context, H=q heads, G=kv heads, hd=head_dim):
  matmul flops      train 6·N_active·tokens; prefill 2·N_active·tokens;
                    decode 2·N_active·B
  attention flops   per layer fwd = 4·B·S·T_eff·H·hd x 0.5 (causal);
                    train x3 (bwd = 2x fwd); T_eff = min(window, T)
  SSD flops         per layer fwd ≈ B·S·(6·chunk·(H·P+N) + 8·H·N·P)
  HBM bytes         params: 2 reads + 1 grad write (train) / 1 read
                    (serve); DASHA state: ~8 passes over n·d state_dtype
                    (h, g_l r+w, grads, masks, g r+w); activations:
                    3·L·tokens·d·2B (save + readback + recompute) for
                    train, 1x for prefill; decode: params + full KV-cache
                    read + O(B·d) activations.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.models.common import ArchConfig


def _attn_layers(cfg: ArchConfig, T: int):
    """(count, T_eff, T_kv_src) triples for every attention group."""
    full = T
    win = min(cfg.sliding_window, T) if cfg.sliding_window else T
    at = cfg.arch_type
    if at == "ssm":
        return []
    if at == "hybrid":
        n_attn = -(-cfg.num_layers // cfg.hybrid_attn_every)
        return [(n_attn, full, None)]
    if at == "vlm":
        n_cross = cfg.num_layers // cfg.cross_attn_every
        return [(cfg.num_layers, full, None),
                (n_cross, cfg.num_image_tokens, cfg.num_image_tokens)]
    if at == "audio":
        return [(cfg.num_encoder_layers, cfg.num_audio_frames, None),
                (cfg.num_layers, full, None),
                (cfg.num_layers, cfg.num_audio_frames,
                 cfg.num_audio_frames)]
    if cfg.global_every:
        n_groups = cfg.num_layers // cfg.global_every
        n_local = n_groups * (cfg.global_every - 1)
        return [(n_local, win, None), (n_groups, full, None)]
    return [(cfg.num_layers, win, None)]


def attn_flops_fwd(cfg: ArchConfig, B: int, S: int, T: int) -> float:
    """QK^T + PV matmul flops for one forward over S query positions
    against T context positions (0.5 causal discount for self-attn)."""
    H = cfg.num_heads
    hd = cfg.head_dim or (cfg.d_model // max(H, 1))
    if cfg.use_mla:
        hd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    total = 0.0
    for count, t_eff, t_src in _attn_layers(cfg, T):
        causal = 0.5 if t_src is None and S > 1 else 1.0
        t_here = t_eff if t_src is None else t_src
        total += count * 4.0 * B * S * t_here * H * hd * causal
    return total


def ssd_flops_fwd(cfg: ArchConfig, B: int, S: int) -> float:
    if not cfg.ssm_state or cfg.arch_type not in ("ssm", "hybrid"):
        return 0.0
    H, P, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    chunk = min(cfg.ssd_chunk, S)
    per_tok = 6.0 * chunk * (H * P + N) + 8.0 * H * N * P
    return cfg.num_layers * B * S * per_tok


def train_analytics(cfg: ArchConfig, *, seq: int, global_batch: int,
                    n_active: int, params_bytes: float, state_bytes: float,
                    state_itemsize: int) -> Dict[str, float]:
    tokens = global_batch * seq
    flops = (6.0 * n_active * tokens
             + 3.0 * attn_flops_fwd(cfg, global_batch, seq, seq)
             + 3.0 * ssd_flops_fwd(cfg, global_batch, seq))
    act = 3.0 * cfg.num_layers * tokens * cfg.d_model * 2.0
    logits = tokens * cfg.padded_vocab * 4.0 * 2.0
    hbm = (3.0 * params_bytes          # fwd read + bwd read + grad write
           + 8.0 * state_bytes         # h/g_local r+w, g r+w, masks, m
           + act + logits)
    return {"flops": flops, "hbm_bytes": hbm}


def prefill_analytics(cfg: ArchConfig, *, seq: int, global_batch: int,
                      n_active: int, params_bytes: float
                      ) -> Dict[str, float]:
    tokens = global_batch * seq
    flops = (2.0 * n_active * tokens
             + attn_flops_fwd(cfg, global_batch, seq, seq)
             + ssd_flops_fwd(cfg, global_batch, seq))
    act = cfg.num_layers * tokens * cfg.d_model * 2.0
    hbm = params_bytes + act
    return {"flops": flops, "hbm_bytes": hbm}


def decode_analytics(cfg: ArchConfig, *, seq: int, global_batch: int,
                     n_active: int, params_bytes: float,
                     cache_bytes: float) -> Dict[str, float]:
    flops = (2.0 * n_active * global_batch
             + attn_flops_fwd(cfg, global_batch, 1, seq)
             + ssd_flops_fwd(cfg, global_batch, 1))
    hbm = params_bytes + cache_bytes \
        + 4.0 * global_batch * cfg.d_model * cfg.num_layers
    return {"flops": flops, "hbm_bytes": hbm}

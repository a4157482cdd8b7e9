"""Mamba2 / SSD (state-space duality, arXiv:2405.21060) in torch (port of
``repro.models.ssm``).

Chunked SSD for training / prefill: intra-chunk attention-like products
plus a loop over chunk states, written as explicit broadcasts and batched
matmuls (``ssd_chunked``), or, with ``cfg.use_ssd_kernel``, the
hand-written ``ssd_chunk`` kernel through ``kernels.ops.ssd_chunk_scan``
(forward only).  And an O(1)-per-token recurrent decode step, which
updates the caller's SSM state and conv window in place (the serving
cache is ~76 MB a sequence at 780M, so no second copy is made).

Layout: d_inner = H * P (heads x headdim); B/C are single-group (state
size N); the scalar-per-head A follows Mamba2.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import ssd_chunk_scan
from repro_torch.models.common import ArchConfig, rms_norm, silu, softplus


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) log-decays -> (..., Q, Q) with [q, k] = sum_{j=k+1..q}
    a_j for q >= k, -inf otherwise."""
    cs = torch.cumsum(a, -1)
    diff = cs[..., :, None] - cs[..., None, :]
    q = a.shape[-1]
    keep = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~keep, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, D: torch.Tensor,
                chunk: int, s0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-group SSD.

    x: (B,S,H,P), dt: (B,S,H) (post-softplus), A: (H,) (negative),
    b/c: (B,S,N), D: (H,).  Returns (y: (B,S,H,P), final_state: (B,H,N,P)).
    """
    Bb, S, H, P = x.shape
    N = b.shape[-1]
    nc = S // chunk
    f32 = torch.float32
    xv = (x * dt[..., None]).to(f32)                       # dt-weighted input
    a = (dt * A[None, None, :]).to(f32)                    # (B,S,H) log decay

    xc = xv.reshape(Bb, nc, chunk, H, P)
    ac = a.reshape(Bb, nc, chunk, H)
    bc = b.to(f32).reshape(Bb, nc, chunk, N)
    cc = c.to(f32).reshape(Bb, nc, chunk, N)
    xh = xc.permute(0, 1, 3, 2, 4)                         # (B,nc,H,Q,P)

    acs = torch.cumsum(ac, 2)                              # (B,nc,Q,H) incl.
    L = torch.exp(_segsum(ac.transpose(-1, -2)))           # (B,nc,H,Q,Q)
    scores = cc @ bc.transpose(-1, -2)                     # (B,nc,Q,Q)
    y_diag = ((L * scores[:, :, None]) @ xh)               # (B,nc,H,Q,P)

    # states contributed by each chunk: decay to end of chunk
    decay_end = torch.exp(acs[:, :, -1:, :] - acs)         # (B,nc,Q,H)
    w = xh * decay_end.transpose(-1, -2)[..., None]        # (B,nc,H,Q,P)
    chunk_states = bc.transpose(-1, -2)[:, :, None] @ w    # (B,nc,H,N,P)

    # inter-chunk recurrence
    decay_chunk = torch.exp(acs[:, :, -1, :])              # (B,nc,H)
    s = torch.zeros((Bb, H, N, P), dtype=f32, device=x.device) \
        if s0 is None else s0.to(f32)
    prev = []
    for j in range(nc):
        prev.append(s)
        s = s * decay_chunk[:, j, :, None, None] + chunk_states[:, j]
    prev_states = torch.stack(prev, 1)                     # (B,nc,H,N,P)

    state_decay = torch.exp(acs).transpose(-1, -2)[..., None]  # (B,nc,H,Q,1)
    y_off = (cc[:, :, None] @ prev_states) * state_decay   # (B,nc,H,Q,P)
    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(Bb, S, H, P)
    y = y + x.to(f32) * D[None, None, :, None]
    return y.to(x.dtype), s


def ssd_decode(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               b: torch.Tensor, c: torch.Tensor, D: torch.Tensor,
               state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token: x (B,H,P), dt (B,H), b/c (B,N), state (B,H,N,P) float32,
    updated in place (``state * exp(dt A) + b (x dt)``) and returned."""
    f32 = torch.float32
    a = torch.exp((dt * A[None, :]).to(f32))                # (B,H)
    xdt = (x * dt[..., None]).to(f32)                       # (B,H,P)
    state.mul_(a[..., None, None])
    state.addcmul_(b.to(f32)[:, None, :, None], xdt[:, :, None, :])
    # c (B,1,1,N) @ state (B,H,N,P): a batched matmul over the state as it
    # lies (an einsum would permute a copy of it)
    y = (c.to(f32)[:, None, None, :] @ state)[:, :, 0]
    y = y + x.to(f32) * D[None, :, None]
    return y.to(x.dtype), state


# ---------------------------------------------------------------------------
# full Mamba2 mixer layer
# ---------------------------------------------------------------------------

def _conv1d_prefill(xbc: torch.Tensor, w: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv. xbc: (B,S,Cd); w: (W,Cd)."""
    W, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + S] * w[i][None, None] for i in range(W))
    return silu(out + bias[None, None])


def mamba_mixer_prefill(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                        s0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B,S,d) -> (B,S,d).  The kernel path runs under the reference's
    condition: ``use_ssd_kernel``, no initial state and S a multiple of
    the chunk."""
    B, S, d = x.shape
    H, P, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    z = (x @ p["w_z"].reshape(d, H * P)).reshape(B, S, H, P)
    xbc = x @ p["w_xbc"]                                   # (B,S,HP+2N)
    dt = softplus(x @ p["w_dt"] + p["dt_bias"])
    xbc = _conv1d_prefill(xbc, p["conv_w"], p["conv_b"])
    xs = xbc[..., :H * P].reshape(B, S, H, P)
    bmat = xbc[..., H * P:H * P + N]
    cmat = xbc[..., H * P + N:]
    A = -torch.exp(p["A_log"].to(torch.float32))
    chunk = min(cfg.ssd_chunk, S)
    if cfg.use_ssd_kernel and s0 is None and S % chunk == 0:
        y, _ = ssd_chunk_scan(xs, dt, A, bmat, cmat, p["D"], chunk)
    else:
        y, _ = ssd_chunked(xs, dt, A, bmat, cmat, p["D"], chunk, s0)
    y = y * silu(z)
    y = rms_norm(y.reshape(B, S, H * P), p["norm"], cfg.norm_eps)
    return y @ p["w_out"]


def mamba_mixer_decode(p: Dict, x: torch.Tensor, cache: Dict,
                       cfg: ArchConfig) -> Tuple[torch.Tensor, Dict]:
    """x: (B,1,d); cache: {"conv": (B,W-1,Cd), "ssm": (B,H,N,P) float32},
    both updated in place and returned."""
    B, _, d = x.shape
    H, P, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    xt = x[:, 0]
    z = (xt @ p["w_z"].reshape(d, H * P)).reshape(B, H, P)
    xbc = xt @ p["w_xbc"]
    dt = softplus(xt @ p["w_dt"] + p["dt_bias"])          # (B,H)
    # conv cache: the window of the last W-1 inputs
    conv_in = torch.cat([cache["conv"], xbc[:, None]], 1)   # (B,W,Cd)
    conv_out = silu(torch.einsum("bwc,wc->bc", conv_in, p["conv_w"])
                    + p["conv_b"])
    cache["conv"].copy_(conv_in[:, 1:])
    xs = conv_out[:, :H * P].reshape(B, H, P)
    bmat = conv_out[:, H * P:H * P + N]
    cmat = conv_out[:, H * P + N:]
    A = -torch.exp(p["A_log"].to(torch.float32))
    y, _ = ssd_decode(xs, dt, A, bmat, cmat, p["D"], cache["ssm"])
    y = y * silu(z)
    y = rms_norm(y.reshape(B, 1, H * P), p["norm"], cfg.norm_eps)
    return y @ p["w_out"], cache

"""Mamba2 / SSD (state-space duality, arXiv:2405.21060) in plain torch
(port of ``repro.models.ssm``, the training / prefill path).

Chunked SSD: intra-chunk attention-like products plus a loop over chunk
states, written as explicit broadcasts and batched matmuls.  The
``use_ssd_kernel`` path (the hand-written ``ssd_chunk`` kernel) and the
recurrent decode step come with the serving slice.

Layout: d_inner = H * P (heads x headdim); B/C are single-group (state
size N); the scalar-per-head A follows Mamba2.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ArchConfig, rms_norm


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


# ---------------------------------------------------------------------------
# full Mamba2 mixer layer
# ---------------------------------------------------------------------------

def _conv1d_prefill(xbc: torch.Tensor, w: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv. xbc: (B,S,Cd); w: (W,Cd)."""
    W, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + S] * w[i][None, None] for i in range(W))
    return F.silu(out + bias[None, None])


def mamba_mixer_prefill(p: Dict, x: torch.Tensor,
                        cfg: ArchConfig) -> torch.Tensor:
    """x: (B,S,d) -> (B,S,d)."""
    B, S, d = x.shape
    H, P, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    z = (x @ p["w_z"].reshape(d, H * P)).reshape(B, S, H, P)
    xbc = x @ p["w_xbc"]                                   # (B,S,HP+2N)
    dt = F.softplus(x @ p["w_dt"] + p["dt_bias"])
    xbc = _conv1d_prefill(xbc, p["conv_w"], p["conv_b"])
    xs = xbc[..., :H * P].reshape(B, S, H, P)
    bmat = xbc[..., H * P:H * P + N]
    cmat = xbc[..., H * P + N:]
    A = -torch.exp(p["A_log"].to(torch.float32))
    if cfg.use_ssd_kernel:
        raise NotImplementedError("ssd_chunk kernel: next slice")
    y, _ = ssd_chunked(xs, dt, A, bmat, cmat, p["D"], min(cfg.ssd_chunk, S))
    y = y * F.silu(z)
    y = rms_norm(y.reshape(B, S, H * P), p["norm"], cfg.norm_eps)
    return y @ p["w_out"]

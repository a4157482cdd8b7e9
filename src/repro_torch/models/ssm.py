"""Mamba2 / SSD (state-space duality, arXiv:2405.21060) in torch (port of
``repro.models.ssm``).

Chunked SSD for training / prefill: intra-chunk attention-like products
plus a loop over chunk states, written as explicit broadcasts and batched
matmuls (``ssd_chunked``), or, with ``cfg.use_ssd_kernel``, the
hand-written ``ssd_chunk`` kernel through ``kernels.ops.ssd_chunk_scan``
(forward only; on DTensors through ``kernels.ops.ssd_chunk_scan_sharded``,
the kernel on this rank's batch rows and heads, its inputs first pinned to
the policy's layout).  The training forward takes ``ssd_chunked`` (kernel
5 has no backward), on DTensors through ``local_map`` on the same local
rows and heads, so its backward runs on them too.  And an O(1)-per-token
recurrent decode step, which updates the caller's SSM state and conv
window in place (the serving cache is ~76 MB a sequence at 780M, so no
second copy is made).

Layout: d_inner = H * P (heads x headdim); B/C are single-group (state
size N); the scalar-per-head A follows Mamba2.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import (ssd_chunk_scan, ssd_chunk_scan_sharded,
                                     ssd_placements)
from repro_torch.models import sharding
from repro_torch.models.common import ArchConfig, rms_norm, silu, softplus

_mm = sharding.matmul          # ``a @ b``; on DTensors a local-shard einsum


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


def _conv1d(xbc, w, bias):
    """:func:`_conv1d_prefill`; on DTensors through ``local_map`` on this
    rank's batch rows and channels (a depthwise conv is per channel), the
    sequence whole: the channels as the conv weight splits them, the batch
    over the data axes where it divides."""
    if not sharding.is_dtensor(xbc):
        return _conv1d_prefill(xbc, w, bias)
    from torch.distributed.tensor import Shard
    mesh = xbc.device_mesh
    c_ax = "model" if Shard(1) in tuple(w.placements) else None
    pin = functools.partial(sharding.constrain, mesh=mesh)
    args = (pin(xbc, (_batch_axes(xbc), None, c_ax)), pin(w, (None, c_ax)),
            pin(bias, (c_ax,)))
    fn = sharding.local_map(_conv1d_prefill, (tuple(args[0].placements),),
                            tuple(tuple(a.placements) for a in args), mesh)
    return fn(*args)


def _batch_axes(x):
    """The data axes over which DTensor ``x``'s batch dim splits, or
    None where it does not divide."""
    mesh = x.device_mesh
    return sharding.dp_axes(mesh) \
        if x.shape[0] % sharding.dp_size(mesh) == 0 else None


def _pin_ssd(xs, dt, A, bmat, cmat, D):
    """The SSD's DTensor inputs laid out as the policy means: batch over
    the data axes where it divides, heads over "model" where they divide
    (a Replicate-to-Shard move is a local slice), b and c replicated over
    the heads."""
    mesh = xs.device_mesh
    b_ax = _batch_axes(xs)
    h_ax = "model" if sharding.divides(xs.shape[2], sharding.tp_size(mesh)) \
        else None
    pin = functools.partial(sharding.constrain, mesh=mesh)
    return (pin(xs, (b_ax, None, h_ax, None)), pin(dt, (b_ax, None, h_ax)),
            pin(A, (h_ax,)), pin(bmat, (b_ax, None, None)),
            pin(cmat, (b_ax, None, None)), pin(D, (h_ax,)))


def _ssd_plain_sharded(xs, dt, A, bmat, cmat, D, chunk: int):
    """:func:`ssd_chunked` on DTensors (the training forward: kernel 5 has
    no backward), through ``local_map`` on this rank's batch rows and
    heads, as kernel 5 runs: DTensor's own batched matmuls would flatten
    the sharded heads into a strided shard whose plans take minutes.  The
    gradients of b and c, which every local head reads, come back as
    partial sums over the heads' mesh dims."""
    args = _pin_ssd(xs, dt, A, bmat, cmat, D)
    in_pl, out_pl = ssd_placements(args[0])
    fn = sharding.local_map(ssd_chunked, out_pl, in_pl, xs.device_mesh)
    return fn(*args, chunk)


def _ssd_kernel(xs, dt, A, bmat, cmat, D, chunk: int):
    """Kernel 5's SSD forward.  On DTensors the inputs are pinned to the
    policy's layout first — batch over the data axes where it divides,
    heads over "model" where they divide (a Replicate-to-Shard move is a
    local slice) — and the kernel runs on the local shards."""
    if not sharding.is_dtensor(xs):
        return ssd_chunk_scan(xs, dt, A, bmat, cmat, D, chunk)
    return ssd_chunk_scan_sharded(*_pin_ssd(xs, dt, A, bmat, cmat, D),
                                  chunk)


def _ssd_decode_sharded(x, dt, A, b, c, D, state):
    """:func:`ssd_decode` on DTensors, through ``local_map`` on this rank's
    batch rows and heads (the recurrence is per row and head), the state
    updated in place in its local shard.  The inputs are pinned to the
    state's layout, the cache's spec: batch over the data axes where it
    divides, heads over "model" where they divide."""
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    b_ax = _batch_axes(x)
    h_ax = "model" if sharding.divides(x.shape[1], sharding.tp_size(mesh)) \
        else None
    pin = functools.partial(sharding.constrain, mesh=mesh)
    args = (pin(x, (b_ax, h_ax, None)), pin(dt, (b_ax, h_ax)),
            pin(A, (h_ax,)), pin(b, (b_ax, None)), pin(c, (b_ax, None)),
            pin(D, (h_ax,)), pin(state, (b_ax, h_ax, None, None)))
    fn = local_map(ssd_decode,
                   out_placements=(tuple(args[0].placements),
                                   tuple(args[-1].placements)),
                   in_placements=tuple(tuple(a.placements) for a in args),
                   redistribute_inputs=False, device_mesh=mesh)
    return fn(*args)


def mamba_mixer_prefill(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                        s0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B,S,d) -> (B,S,d).  The kernel path runs under the reference's
    condition: ``use_ssd_kernel``, no initial state and S a multiple of
    the chunk."""
    B, S, d = x.shape
    H, P, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    z = _mm(x, p["w_z"].reshape(d, H * P)).reshape(B, S, H, P)
    xbc = _mm(x, p["w_xbc"])                               # (B,S,HP+2N)
    dt = softplus(_mm(x, p["w_dt"]) + p["dt_bias"])
    xbc = _conv1d(xbc, p["conv_w"], p["conv_b"])
    if sharding.is_dtensor(xbc):
        # the channels whole (x, b and c are slices of them), batch as x's
        xbc = sharding.constrain(xbc, (_batch_axes(x), None, None))
    xs = xbc[..., :H * P].reshape(B, S, H, P)
    bmat = xbc[..., H * P:H * P + N]
    cmat = xbc[..., H * P + N:]
    A = -torch.exp(p["A_log"].to(torch.float32))
    chunk = min(cfg.ssd_chunk, S)
    if cfg.use_ssd_kernel and s0 is None and S % chunk == 0:
        y, _ = _ssd_kernel(xs, dt, A, bmat, cmat, p["D"], chunk)
    elif sharding.is_dtensor(xs) and s0 is None:
        y, _ = _ssd_plain_sharded(xs, dt, A, bmat, cmat, p["D"], chunk)
    else:
        y, _ = ssd_chunked(xs, dt, A, bmat, cmat, p["D"], chunk, s0)
    y = y * silu(z)
    y = rms_norm(y.reshape(B, S, H * P), p["norm"], cfg.norm_eps)
    return _mm(y, p["w_out"])


def mamba_mixer_decode(p: Dict, x: torch.Tensor, cache: Dict,
                       cfg: ArchConfig) -> Tuple[torch.Tensor, Dict]:
    """x: (B,1,d); cache: {"conv": (B,W-1,Cd), "ssm": (B,H,N,P) float32},
    both updated in place and returned."""
    B, _, d = x.shape
    H, P, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    xt = x[:, 0]
    z = _mm(xt, p["w_z"].reshape(d, H * P)).reshape(B, H, P)
    xbc = _mm(xt, p["w_xbc"])
    dt = softplus(_mm(xt, p["w_dt"]) + p["dt_bias"])      # (B,H)
    # conv cache: the window of the last W-1 inputs
    conv_in = torch.cat([cache["conv"], xbc[:, None]], 1)   # (B,W,Cd)
    conv_out = silu(sharding.einsum("bwc,wc->bc", conv_in, p["conv_w"])
                    + p["conv_b"])
    cache["conv"].copy_(conv_in[:, 1:])
    xs = conv_out[:, :H * P].reshape(B, H, P)
    bmat = conv_out[:, H * P:H * P + N]
    cmat = conv_out[:, H * P + N:]
    A = -torch.exp(p["A_log"].to(torch.float32))
    if sharding.is_dtensor(xs):
        y, _ = _ssd_decode_sharded(xs, dt, A, bmat, cmat, p["D"],
                                   cache["ssm"])
    else:
        y, _ = ssd_decode(xs, dt, A, bmat, cmat, p["D"], cache["ssm"])
    y = y * silu(z)
    y = rms_norm(y.reshape(B, 1, H * P), p["norm"], cfg.norm_eps)
    return y @ p["w_out"], cache

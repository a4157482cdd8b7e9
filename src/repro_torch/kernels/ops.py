"""Dispatch of the port's kernels (port of ``repro.kernels.ops``).

A CPU tensor takes the plain torch version (:mod:`repro_torch.kernels.ref`),
and so does a ``meta`` tensor (a dry run traces shapes, it computes
nothing); a CUDA tensor launches the hand-written kernel
(:mod:`repro_torch.kernels.dasha_update`, :mod:`repro_torch.kernels.
ssd_chunk`, :mod:`repro_torch.kernels.slab_writeback`) or raises.  No lane
padding: the DASHA kernels cover the storage by rows (the dense-mask
``dasha_update`` by a 1-D grid).
:func:`ssd_chunk_scan` is the SSD forward that ``models.ssm`` calls with
``use_ssd_kernel``.

A DTensor never reaches a kernel: every entry raises on one.  A sharded
caller goes through ``torch.distributed.tensor.experimental.local_map``
with its placements declared, and the entry sees the local shards:
:func:`ssd_chunk_scan_sharded` runs kernel 5 on the local batch rows and
heads, :func:`dasha_update_sharded` and :func:`dasha_mvr_update_sharded`
kernels 1 and 3 on this rank's shard of a per-node state leaf.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import dasha_update as cuda_kernels
from repro_torch.kernels import ref
from repro_torch.kernels import slab_writeback as slab_kernel
from repro_torch.kernels import ssd_chunk as ssd_kernel


def _on_cpu(name: str, t: torch.Tensor) -> bool:
    """True where ``t`` takes the plain version (CPU, ``meta``), False where
    it launches the kernel (CUDA); raises on a DTensor and on any other
    device."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        raise ValueError(
            f"{name}: a DTensor reaches a kernel only through local_map with "
            "its placements declared (ssd_chunk_scan_sharded)")
    if t.device.type in ("cpu", "meta"):
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{name}: no kernel for device {t.device}")


def dasha_update(grad: torch.Tensor, h: torch.Tensor, g_local: torch.Tensor,
                 mask: torch.Tensor, a: float, scale: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused DASHA update; returns (m, h_new, g_local_new)."""
    if _on_cpu("dasha_update", grad):
        return ref.dasha_update_ref(grad, h, g_local, mask, a, scale)
    return cuda_kernels.dasha_update(grad, h, g_local, mask, a, scale)


def dasha_sparsify_update(grad: torch.Tensor, h: torch.Tensor,
                          g_local: torch.Tensor, a: float, scale, *,
                          indices=None, mask=None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The sparsifier (RandK, PermK, Bernoulli) or passthrough estimator
    update on rows of grad's last axis, the support built from
    ``indices`` or read from ``mask`` (row r at r % their rows; neither:
    passthrough) and a float or per-row ``scale``; ``a`` a float or a
    sweep's (G,) fp32 lane values; returns (m, grad, g_new).  On the card
    one launch of kernel 1's sparsifier entry."""
    if _on_cpu("dasha_sparsify_update", grad):
        return ref.dasha_sparsify_update_ref(grad, h, g_local, a, scale,
                                             indices=indices, mask=mask)
    return cuda_kernels.dasha_sparsify_update(grad, h, g_local, a, scale,
                                              indices=indices, mask=mask)


def dasha_mvr_update(grad_new: torch.Tensor, grad_old: torch.Tensor,
                     h: torch.Tensor, g_local: torch.Tensor,
                     mask: torch.Tensor, a: float, b: float, scale: float,
                     *, c=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused DASHA-MVR update; returns (m, h_new, g_local_new).  ``mask``
    float32, bool or uint8, of the leaf's shape or (1, ...) for every
    node; ``a`` a float or a sweep's (G,) fp32 lane values over the leading
    rows, and ``c`` the lanes' (G,) fp32 ``1 - b``, which replaces ``b``."""
    if _on_cpu("dasha_mvr_update", grad_new):
        return ref.dasha_mvr_update_ref(grad_new, grad_old, h, g_local, mask,
                                        a, b, scale, c=c)
    return cuda_kernels.dasha_mvr_update(grad_new, grad_old, h, g_local,
                                         mask, a, b, scale, c=c)


def quantize_with_u(x: torch.Tensor, u: torch.Tensor,
                    levels: int = 15) -> torch.Tensor:
    """Row-wise quantization with external uniforms (the plan layer draws
    them once so the dense and fused backends dither identically)."""
    if _on_cpu("quantize_with_u", x):
        return ref.quantize_ref(x, u, levels)
    return cuda_kernels.quantize(x, u, levels)


def dasha_quantize_update(h_new: torch.Tensor, h: torch.Tensor,
                          g_local: torch.Tensor, u: torch.Tensor, a: float,
                          scale, levels: int
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The QDither estimator update m = quantize(h_new - h - a (g_local -
    h), u) * scale, g_new = g_local + m in one launch; returns (m, h_new,
    g_new).  ``u`` (n, d) is broadcast over leading lane axes; ``scale``
    is a float or an (n, 1) tensor; ``a`` a float or a sweep's (G,) fp32
    lane values."""
    if _on_cpu("dasha_quantize_update", h_new):
        return ref.dasha_quantize_update_ref(h_new, h, g_local, u, a, scale,
                                             levels)
    return cuda_kernels.dasha_quantize_update(h_new, h, g_local, u, a,
                                              scale, levels)


def quantize(x: torch.Tensor, generator: torch.Generator,
             levels: int = 15) -> torch.Tensor:
    """Unbiased row-wise stochastic quantization of x: (R, C), drawing the
    uniforms from ``generator`` (on x's device)."""
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return quantize_with_u(x, u, levels)


def slab_writeback(full: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
                   *, accumulate: bool = False) -> torch.Tensor:
    """Write a chunk slab back into the persistent (n, d) store, in place,
    and return the store.  ``idx`` (U,) int32: sorted unique global row
    ids padded with the sentinel ``n`` (dropped); ``rows`` (U, d): the
    slab.  Unlike the reference's wrapper, which is jitted without
    donation and returns a new array, this writes into ``full``: callers
    pass a store they own."""
    if _on_cpu("slab_writeback", full):
        if full.device.type == "meta":
            return full     # a write in place: nothing to write on meta
        return ref.slab_writeback_ref(full, idx, rows, accumulate=accumulate)
    return slab_kernel.slab_writeback(full, idx, rows, accumulate=accumulate)


def chunk_layout(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, chunk: int):
    """The model's (x (B,S,H,P), dt (B,S,H), A (H,), b/c (B,S,N)) in the
    reference kernel's layout: x (G,nc,Q,P), dt (G,nc,Q), A (G,), b/c
    (G,nc,Q,N) with G = B * H (b and c copied once per head, as the
    reference's wrapper broadcasts them)."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    G, nc = B * H, S // chunk
    xg = x.permute(0, 2, 1, 3).reshape(G, nc, chunk, P)
    dtg = dt.permute(0, 2, 1).reshape(G, nc, chunk)
    Ag = A[None].expand(B, H).reshape(G)

    def per_head(m):
        return m[:, None].expand(B, H, S, N).reshape(G, nc, chunk, N)

    return xg, dtg, Ag, per_head(b), per_head(c)


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor, chunk: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """The SSD intra-chunk pass over the model's tensors (x (B,S,H,P), dt
    (B,S,H), A (H,), b/c (B,S,N)); returns float32 (y_diag (G,nc,Q,P),
    states (G,nc,N,P), decays (G,nc), acs (G,nc,Q)) in the reference
    kernel's layout."""
    if _on_cpu("ssd_chunk", x):
        return ref.ssd_chunk_ref(*chunk_layout(x, dt, A, b, c, chunk))
    return ssd_kernel.ssd_chunk(x, dt, A, b, c, chunk)


def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, D: torch.Tensor,
                   chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel SSD forward (drop-in for ``models.ssm.ssd_chunked`` without
    an initial state; port of the reference's ``ops.ssd_chunk_scan``).

    x: (B,S,H,P), dt: (B,S,H), A: (H,), b/c: (B,S,N), D: (H,); S a
    multiple of ``chunk``.  The intra-chunk blocks run in :func:`ssd_chunk`;
    the inter-chunk recurrence is a loop over chunks; the off-diagonal
    ``exp(acs) * (c @ prev_state)`` is one batched matmul per (batch,
    chunk) with every head's state side by side, so c is never copied per
    head.  Returns (y (B,S,H,P) in x's dtype, final_state (B,H,N,P)
    float32)."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    nc = S // chunk
    G = B * H
    y_diag, states, decays, acs = ssd_chunk(x, dt, A, b, c, chunk)

    # each intermediate is dropped as soon as it is used: at the serving
    # prefill shape y_diag is 1.6 GB and the states 0.8 GB a layer
    s = torch.zeros((G, N, P), dtype=torch.float32, device=x.device)
    prev = torch.empty_like(states)                      # (G,nc,N,P)
    for j in range(nc):
        prev[:, j] = s
        s = s * decays[:, j, None, None] + states[:, j]
    del states

    # y_off[b,j,q,h,p] = exp(acs[b,h,j,q]) * sum_n c[b,j,q,n] prev[b,h,j,n,p]
    prev = prev.view(B, H, nc, N, P).permute(0, 2, 3, 1, 4) \
        .reshape(B, nc, N, H * P)
    cc = c.to(torch.float32).reshape(B, nc, chunk, N)
    y = (cc @ prev).view(B, nc, chunk, H, P)
    del prev, cc
    y.mul_(torch.exp(acs).view(B, H, nc, chunk).permute(0, 2, 3, 1)[..., None])
    y.add_(y_diag.view(B, H, nc, chunk, P).permute(0, 2, 3, 1, 4))
    del y_diag
    y = y.view(B, S, H, P)
    y.add_(x.to(torch.float32) * D[None, None, :, None])
    return y.to(x.dtype), s.view(B, H, N, P)


def ssd_placements(x) -> Tuple[tuple, tuple]:
    """The placements :func:`ssd_chunk_scan_sharded` declares, read off the
    DTensor ``x`` (B,S,H,P): each mesh dim that shards x's batch (dim 0)
    shards x, dt, b, c and both outputs by batch; each that shards its
    heads (dim 2) shards x, dt (B,S,H), A and D (H,), y (B,S,H,P) and the
    state (B,H,N,P) by head and replicates b and c; any other is
    replicated.  Returns (in placements of (x, dt, A, b, c, D, chunk),
    out placements of (y, state))."""
    from torch.distributed.tensor import Replicate, Shard
    rep = Replicate()
    cols = []
    for pl in x.placements:
        if pl == Shard(0):
            cols.append((Shard(0), Shard(0), rep, Shard(0), Shard(0), rep,
                         Shard(0), Shard(0)))
        elif pl == Shard(2):
            cols.append((Shard(2), Shard(2), Shard(0), rep, rep, Shard(0),
                         Shard(2), Shard(1)))
        elif isinstance(pl, Replicate):
            cols.append((rep,) * 8)
        else:
            raise ValueError(f"ssd_chunk_scan_sharded: x placed {pl} on a "
                             "mesh dim; only batch and heads shard")
    per = [tuple(c[i] for c in cols) for i in range(8)]
    return tuple(per[:6]) + (None,), (per[6], per[7])


def ssd_chunk_scan_sharded(x, dt, A, b, c, D, chunk: int):
    """:func:`ssd_chunk_scan` on DTensors: through ``local_map`` with the
    placements of :func:`ssd_placements`, so kernel 5 runs on this rank's
    batch rows and heads.  The inputs must already lie as declared (the
    caller pins them; nothing is moved here), else ``local_map`` raises."""
    from torch.distributed.tensor.experimental import local_map
    in_pl, out_pl = ssd_placements(x)
    fn = local_map(ssd_chunk_scan, out_placements=out_pl,
                   in_placements=in_pl, redistribute_inputs=False,
                   device_mesh=x.device_mesh)
    return fn(x, dt, A, b, c, D, chunk)


def _state_local_map(fn, state, mask, n_in: int, mask_at: int,
                     n_other: int):
    """``fn`` through ``local_map`` for ``n_in`` per-node state DTensors
    laid out as ``state`` and a mask inserted at ``mask_at``, then
    ``n_other`` undeclared scalar arguments.  The state arguments and the
    three outputs are declared with ``state``'s placements, and so is the
    mask, unless it is one row for every node (``shared_coords``): then
    with the node axis's mesh dims replicated.  Nothing is moved: an
    argument laid out otherwise makes ``local_map`` raise."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    pl = tuple(state.placements)
    mpl = pl
    if mask.shape[0] == 1 and state.shape[0] != 1:
        mpl = tuple(Replicate() if p == Shard(0) else p for p in pl)
    in_pl = [pl] * n_in
    in_pl.insert(mask_at, mpl)
    return local_map(fn, out_placements=(pl, pl, pl),
                     in_placements=tuple(in_pl) + (None,) * n_other,
                     redistribute_inputs=False,
                     device_mesh=state.device_mesh)


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(t.shape[0], -1)


def _sparsify_local(grad, h, g_local, mask, a, scale):
    """Kernel 1's sparsifier entry on a local (n, *shape) shard as n rows,
    the mask read row r % its rows; (m, grad, g_new) in the shard's
    shape."""
    m, _, g_new = dasha_sparsify_update(_rows(grad), _rows(h),
                                        _rows(g_local), a, scale,
                                        mask=_rows(mask))
    return m.view(grad.shape), grad, g_new.view(grad.shape)


def dasha_update_sharded(grad, h, g_local, mask, a, scale):
    """The DASHA estimator update (kernel 1's sparsifier entry, h_new =
    grad) on per-node DTensors: through ``local_map``, one launch on this
    rank's shard.  ``grad``, ``h``, ``g_local`` and ``mask`` must share
    one layout (a ``shared_coords`` mask is one row, replicated over the
    node axis); returns (m, h_new, g_local_new) DTensors laid out as
    ``h``."""
    fn = _state_local_map(_sparsify_local, h, mask, 3, 3, 2)
    return fn(grad, h, g_local, mask, a, scale)


def dasha_mvr_update_sharded(grad_new, grad_old, h, g_local, mask, a, b,
                             scale, *, c=None):
    """:func:`dasha_mvr_update` (kernel 3) on per-node DTensors: through
    ``local_map``, one launch on this rank's shard.  Both gradients,
    ``h``, ``g_local`` and ``mask`` must share one layout (a
    ``shared_coords`` mask is one row, replicated over the node axis);
    returns (m, h_new, g_local_new) DTensors laid out as ``h``."""
    def local(gn, go, hh, gl, mk, a_, b_, scale_, c_):
        return dasha_mvr_update(gn, go, hh, gl, mk, a_, b_, scale_, c=c_)
    fn = _state_local_map(local, h, mask, 4, 4, 4)
    return fn(grad_new, grad_old, h, g_local, mask, a, b, scale, c)

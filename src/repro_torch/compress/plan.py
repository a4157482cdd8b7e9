"""Layer 2 of the compression subsystem: per-round randomness ("plans").

Port of ``repro.compress.plan``.  Every compressor draws its randomness
here, once per round, through these primitives, each from an explicit
``torch.Generator``:

* :func:`draw_mask`          — Bernoulli(p) 0/1 mask;
* :func:`randk_indices`      — uniform K-subsets without replacement (RandK);
* :func:`perm_partition`     — the cyclic-shift PermK partition into n node
  blocks (flat path);
* :func:`permk_owner`        — the same cyclic-shift ownership as a map per
  coordinate (tree path);
* :func:`participation_coins` — Appendix-D per-node coins.

The :class:`Plan` is backend-agnostic: the dense, sparse and fused
backends all consume the same plan.  A plan drawn by the reference can be
handed to the port as it is (see ``repro_torch.convert.plan_from_numpy``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

#: sentinel index padding ragged PermK blocks (>= d; dropped by scatters,
#: masked out of gathers) — the same value as the reference's int32 max
PAD = 2 ** 31 - 1


class Plan(NamedTuple):
    """Per-round compression randomness, shared by every backend.

    ``kind`` is ``"sparsify"`` (``indices`` and/or ``mask`` carry the
    support, ``scale`` the unbiasedness rescale), ``"dither"``
    (``dither_u`` carries the external uniforms) or ``"passthrough"``.
    ``scale`` is a float, or an (n, 1) tensor under partial participation.
    """

    kind: str
    scale: Union[float, torch.Tensor]
    indices: Optional[torch.Tensor] = None    # (n, k) int64, PAD-padded
    mask: Optional[torch.Tensor] = None       # (n, d) 0/1 float32
    dither_u: Optional[torch.Tensor] = None   # (n, d) uniforms
    levels: int = 0
    payload_coords: float = 0.0
    wire_coords: float = 0.0


def draw_mask(generator: torch.Generator, shape, p: float) -> torch.Tensor:
    """Bernoulli(p) boolean mask on the generator's device."""
    return torch.rand(shape, generator=generator,
                      device=generator.device) < p


def randk_indices(generator: torch.Generator, d: int, k: int,
                  rows: int = 1) -> torch.Tensor:
    """``rows`` independent uniform K-subsets of [d]: (rows, k) int64.

    Top-k of iid uniforms == a uniform K-subset without replacement."""
    u = torch.rand((rows, d), generator=generator, device=generator.device)
    return torch.topk(u, k, dim=1).indices


def perm_partition(generator: torch.Generator, d: int, n: int, *,
                   device, private: bool = False) -> torch.Tensor:
    """PermK partition of [d] into n node blocks: (n, ceil(d/n)) int64.

    Node i owns ``c = (i*blk + j - shift) mod n*blk`` for j in [0, blk);
    out-of-range slots carry :data:`PAD`.  ``generator`` is a CPU generator
    (the shift is a host scalar).  ``private=True`` draws one shift per
    node (the paper-faithful independent mode: node i keeps block i of its
    own partition)."""
    blk = -(-d // n)
    nb = n * blk
    shift = torch.randint(0, nb, (n, 1) if private else (),
                          generator=generator)
    c = (torch.arange(nb, device=device).reshape(n, blk)
         - shift.to(device)) % nb
    return torch.where(c < d, c, torch.full_like(c, PAD))


def _permk_shift(generator: torch.Generator, size: int, n: int):
    """(block, shift) of a PermK ownership map over ``size`` coordinates:
    one host draw from ``generator``."""
    blk = -(-size // n)
    return blk, int(torch.randint(0, n * blk, (), generator=generator))


def permk_owner(generator: torch.Generator, shape, n: int, *,
                device) -> torch.Tensor:
    """PermK ownership map for one leaf of shape ``shape`` (no node axis):
    coordinate c belongs to node ``owner(c) = ((c + shift) // blk) % n``,
    the inverse view of :func:`perm_partition`'s blocks.  ``generator`` is
    a CPU generator (the shift is a host scalar); the map is int64 on
    ``device``."""
    size = 1
    for s in shape:
        size *= int(s)
    blk, shift = _permk_shift(generator, size, n)
    owner = ((torch.arange(size, device=device) + shift) // blk) % n
    return owner.reshape(tuple(shape))


def permk_owner_block(generator: torch.Generator, shape, n: int, local,
                      offsets, *, device) -> torch.Tensor:
    """The ``local``-shaped block of ``permk_owner(generator, shape, n)``
    that starts at ``offsets`` (a shard of the leaf), computed from its
    own coordinates: the same shift, and no full-size map."""
    size = 1
    for s in shape:
        size *= int(s)
    blk, shift = _permk_shift(generator, size, n)
    flat = torch.zeros(tuple(local), dtype=torch.int64, device=device)
    stride = 1
    for i in reversed(range(len(shape))):
        view = [1] * len(shape)
        view[i] = int(local[i])
        idx = torch.arange(int(offsets[i]), int(offsets[i]) + int(local[i]),
                           device=device)
        flat = flat + (idx * stride).reshape(view)
        stride *= int(shape[i])
    return ((flat + shift) // blk) % n


def indices_to_masks(indices: torch.Tensor, d: int,
                     dtype=torch.float32) -> torch.Tensor:
    """(n, k) PAD-padded indices -> contiguous (n, d) 0/1 masks."""
    n = indices.shape[0]
    wide = torch.zeros((n, d + 1), dtype=dtype, device=indices.device)
    wide.scatter_(1, indices.clamp(max=d), 1.0)
    return wide[:, :d].contiguous()


def participation_coins(generator: torch.Generator, n: int,
                        p: float) -> torch.Tensor:
    """Per-node Bernoulli(p) coins as an (n, 1) float32 factor ``coin / p``
    (Appendix D wrapper C_{p'})."""
    coins = draw_mask(generator, (n,), p)
    return (coins.to(torch.float32) / p)[:, None]

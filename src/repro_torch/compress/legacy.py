"""Seed-era object API over the spec / plan / backends layers (port of
``repro.compress.legacy``).

These classes keep the seed's call shapes, ``C(gen, x) -> x_hat`` on flat
vectors and ``NodeCompressor(base, n, mode)`` on (n, d) stacks, with a
``torch.Generator`` (or, for the round compressor's methods, an integer
round seed) in place of the reference's key.  Every draw and every omega
comes from :mod:`repro_torch.compress.plan` and :mod:`repro_torch.compress.
spec`.  New code should use :class:`repro_torch.compress.RoundCompressor`;
this module keeps the paper-faithful loops (``repro_torch.core.dasha`` /
``marina``) reading like the paper.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch

from repro_torch.compress.backends import RoundCompressor
from repro_torch.compress.plan import (indices_to_masks, perm_partition,
                                       randk_indices)
from repro_torch.compress.spec import CompressorSpec, make_spec
from repro_torch.core.device import DEFAULT_DEVICE
from repro_torch.kernels.ref import quantize_ref


class Compressor:
    """Base class: an element of U(omega) (Definition 1.1)."""

    #: variance parameter omega such that C in U(omega)
    omega: float
    #: expected number of nonzero coords returned (zeta_C, Definition 1.3)
    expected_density: float

    def as_spec(self, n: int = 1) -> CompressorSpec:
        """The registry spec this object is a view of."""
        raise NotImplementedError

    def __call__(self, gen: torch.Generator, x: torch.Tensor) -> torch.Tensor:
        """The decompressed estimate C(x) (a dense d-vector), drawing its
        randomness from ``gen`` (on x's device, or the CPU for PermK's
        shift)."""
        raise NotImplementedError

    def payload(self, d: int) -> float:
        """Scalar coordinates sent over the wire per message of dimension
        d."""
        return self.expected_density


def _spec_property(name):
    def get(self):
        return getattr(self.as_spec(getattr(self, "n", 1)), name)
    return property(get)


@dataclasses.dataclass(frozen=True)
class Identity(Compressor):
    """No compression: C(x) = x, omega = 0 (DASHA becomes GD)."""

    d: int

    omega = _spec_property("omega")
    expected_density = _spec_property("expected_density")

    def as_spec(self, n: int = 1) -> CompressorSpec:
        return make_spec("identity", self.d)

    def __call__(self, gen, x):
        return x


@dataclasses.dataclass(frozen=True)
class RandK(Compressor):
    """RandK sparsifier (Definition F.1): keep K uniformly random coords,
    scale by d/K.  C in U(d/K - 1) (Theorem F.2)."""

    d: int
    k: int

    omega = _spec_property("omega")
    expected_density = _spec_property("expected_density")

    def as_spec(self, n: int = 1) -> CompressorSpec:
        return make_spec("randk", self.d, k=self.k)

    def mask(self, gen: torch.Generator) -> torch.Tensor:
        """(d,) 0/1 float32 mask with exactly K ones (without replacement),
        on the generator's device."""
        return indices_to_masks(randk_indices(gen, self.d, self.k),
                                self.d)[0]

    def __call__(self, gen, x):
        return x * self.mask(gen).to(x.dtype) * (self.d / self.k)


@dataclasses.dataclass(frozen=True)
class PermK(Compressor):
    """PermK (Szlendak, Tyurin & Richtarik 2021): the d coordinates are
    split into n blocks by a per-round cyclic shift; node ``node_idx``
    sends its block scaled by n.  Unbiased with omega = n - 1 as a
    collection."""

    d: int
    n: int
    node_idx: int = 0

    omega = _spec_property("omega")
    expected_density = _spec_property("expected_density")

    def as_spec(self, n: Optional[int] = None) -> CompressorSpec:
        # the collection size is this object's n; a caller's n (the
        # PartialParticipation wrapper's default) must not override it
        return make_spec("permk", self.d, n=self.n)

    def mask(self, gen: torch.Generator, device=None) -> torch.Tensor:
        """(d,) 0/1 float32 mask of node ``node_idx``'s block; ``gen`` is a
        CPU generator (the shift is a host scalar), the mask lies on
        ``device`` (default the CPU)."""
        device = torch.device("cpu") if device is None else device
        blocks = perm_partition(gen, self.d, self.n, device=device)
        return indices_to_masks(blocks[self.node_idx][None], self.d)[0]

    def __call__(self, gen, x):
        return x * self.mask(gen, x.device).to(x.dtype) * self.n


@dataclasses.dataclass(frozen=True)
class QDither(Compressor):
    """Unbiased stochastic quantization (QSGD-style, s levels, per-vector
    L2 scale): omega <= min(d/s^2, sqrt(d)/s) (Alistarh et al. 2017).
    Payload: d small ints and one float, counted as d * bits(s)/32 + 1
    fp32-equivalent coordinates."""

    d: int
    s: int = 15

    omega = _spec_property("omega")
    expected_density = _spec_property("expected_density")

    def as_spec(self, n: int = 1) -> CompressorSpec:
        return make_spec("qdither", self.d, s=self.s)

    def __call__(self, gen, x):
        u = torch.rand(x.shape, generator=gen, device=gen.device)
        return quantize_ref(x[None], u[None].to(x.device), self.s)[0]


@dataclasses.dataclass(frozen=True)
class PartialParticipation(Compressor):
    """C_{p'} wrapper (Appendix D, Theorem D.1): with prob p' send
    C(x)/p', else nothing.  If C in U(omega) then C_{p'} in
    U((omega+1)/p' - 1).  The coin is the generator's first draw, the base
    compressor's randomness the draws after it."""

    base: Compressor
    p_participate: float

    @property
    def omega(self) -> float:
        return self.as_spec().omega

    @property
    def expected_density(self) -> float:
        return self.as_spec().expected_density

    def as_spec(self, n: int = 1) -> CompressorSpec:
        return dataclasses.replace(self.base.as_spec(n),
                                   p_participate=self.p_participate)

    def __call__(self, gen, x):
        take = bool(torch.rand((), generator=gen, device=gen.device)
                    < self.p_participate)
        out = self.base(gen, x)
        return out / self.p_participate if take else torch.zeros_like(x)


def make_compressor(name: str, d: int, *, k: Optional[int] = None,
                    n: int = 1, node_idx: int = 0, s: int = 15,
                    p_participate: float = 1.0) -> Compressor:
    """Factory used by configs and the seed-era loops (registry-validated).

    .. deprecated:: use :func:`repro_torch.compress.make_round_compressor`,
       which returns the spec / plan / backends front door directly."""
    warnings.warn(
        "make_compressor is deprecated; use "
        "repro_torch.compress.make_round_compressor instead.",
        DeprecationWarning, stacklevel=2)
    name = name.lower()
    make_spec(name, d, k=k, n=n, s=s)      # validate against the registry
    if name == "identity":
        base: Compressor = Identity(d)
    elif name == "randk":
        base = RandK(d, k)
    elif name == "permk":
        base = PermK(d, n, node_idx)
    elif name == "qdither":
        base = QDither(d, s)
    else:
        raise ValueError(f"no legacy class for {name!r}; use "
                         "repro_torch.compress.make_round_compressor")
    if p_participate < 1.0:
        return PartialParticipation(base, p_participate)
    return base


def empirical_omega(comp, gen: torch.Generator, x: torch.Tensor,
                    trials: int = 512) -> float:
    """Monte-Carlo estimate of E||C(x) - x||^2 / ||x||^2 over ``trials``
    draws of ``gen`` (a diagnostic)."""
    err = torch.stack([torch.sum((comp(gen, x) - x) ** 2)
                       for _ in range(trials)])
    return float(torch.mean(err) / torch.sum(x ** 2))


@dataclasses.dataclass(frozen=True)
class NodeCompressor:
    """Seed-era (n, d) entry point: a view over :class:`RoundCompressor`.

    Modes (DESIGN.md §3): ``independent`` (per-node randomness),
    ``shared_coords`` (one RandK index set for all nodes a round) and
    ``permk`` (the disjoint blocks of one per-round shift); ``backend``
    picks dense | sparse | fused execution (§5); plans are drawn on
    ``device``.  Its methods take the round's integer seed.
    """

    base: Compressor
    n: int
    mode: str = "independent"  # independent | shared_coords | permk
    backend: str = "dense"     # dense | sparse | fused
    device: torch.device = torch.device(DEFAULT_DEVICE)

    def __post_init__(self):
        warnings.warn(
            "NodeCompressor is a deprecated legacy view; construct "
            "repro_torch.compress.RoundCompressor (make_round_compressor) "
            "directly.", DeprecationWarning, stacklevel=2)

    @property
    def rc(self) -> RoundCompressor:
        return RoundCompressor(self.base.as_spec(self.n), self.n, self.mode,
                               self.backend, self.device)

    @property
    def omega(self) -> float:
        return self.rc.omega

    @property
    def payload_per_node(self) -> float:
        return self.rc.payload_per_node

    def plan(self, seed: int):
        return self.rc.plan(seed)

    def compress(self, seed: int, deltas):
        return self.rc.compress(seed, deltas)

    def estimator_update(self, seed: int, h_new, h, g_local, a):
        return self.rc.estimator_update(seed, h_new, h, g_local, a)

    def __call__(self, seed: int, deltas: torch.Tensor) -> torch.Tensor:
        """deltas (n, d) -> messages m_i (n, d), dense."""
        return self.rc(seed, deltas)

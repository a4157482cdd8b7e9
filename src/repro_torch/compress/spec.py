"""Layer 1 of the compression subsystem: specs, omega calculus, registry.

Port of ``repro.compress.spec``.  A :class:`CompressorSpec` is pure
metadata from which the registry computes the variance parameter omega
(Definition 1.1), the expected density zeta_C (Definition 1.3) and the two
payload numbers (DESIGN.md §6).  A registry entry's ``make_plan`` draws a
round's randomness from explicit generators seeded by the round seed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.compress.plan import (Plan, draw_mask, participation_coins,
                                       perm_partition, randk_indices)
from repro_torch.core.rng import generator

MODES = ("independent", "shared_coords", "permk")


@dataclasses.dataclass(frozen=True)
class CompressorSpec:
    """What to compress with; all analytics derive from the registry."""

    name: str
    d: int                        # message dimension
    k: Optional[int] = None       # randk: kept coords
    n: int = 1                    # permk: collection size
    s: int = 15                   # qdither: quantization levels
    p: float = 1.0                # bernoulli: keep probability
    p_participate: float = 1.0    # Appendix D partial-participation wrapper

    @property
    def omega(self) -> float:
        """Variance parameter: C in U(omega), wrapped for partial
        participation per Theorem D.1."""
        base = REGISTRY[self.name].omega(self)
        if self.p_participate < 1.0:
            return omega_participation(base, self.p_participate)
        return base

    @property
    def expected_density(self) -> float:
        """zeta_C: expected nonzero (or fp32-equivalent) coords per message."""
        return self.p_participate * REGISTRY[self.name].expected_density(self)

    @property
    def payload_coords(self) -> float:
        """Ideal-wire scalars per message (values only)."""
        return self.expected_density

    def wire_coords(self, mode: str = "independent") -> float:
        """Scalars the sparse wire format moves per node message: values,
        plus the support when the receiver cannot rederive it."""
        return self.p_participate * REGISTRY[self.name].wire_coords(self,
                                                                    mode)

    def wire_bits(self, mode: str = "independent") -> float:
        """fp32 bits the sparse wire format moves."""
        return 32.0 * self.wire_coords(mode)


@dataclasses.dataclass(frozen=True)
class CompressorDef:
    """Registry entry: the full analytic + randomness definition."""

    name: str
    omega: Callable[[CompressorSpec], float]
    expected_density: Callable[[CompressorSpec], float]
    #: (spec, seed, n_nodes, mode, device) -> Plan
    make_plan: Callable[..., Plan]
    wire_coords: Callable[[CompressorSpec, str], float]
    modes: Tuple[str, ...] = MODES
    supports_sparse: bool = False


REGISTRY: Dict[str, CompressorDef] = {}


def register(defn: CompressorDef) -> CompressorDef:
    REGISTRY[defn.name] = defn
    return defn


def make_spec(name: str, d: int, *, k: Optional[int] = None, n: int = 1,
              s: int = 15, p: float = 1.0,
              p_participate: float = 1.0) -> CompressorSpec:
    name = name.lower()
    if name not in REGISTRY:
        raise ValueError(f"unknown compressor {name!r}; "
                         f"registered: {sorted(REGISTRY)}")
    if name == "randk" and (k is None or not 0 < k <= d):
        raise ValueError(f"randk needs 0 < k <= d, got k={k} d={d}")
    return CompressorSpec(name=name, d=d, k=k, n=n, s=s, p=p,
                          p_participate=p_participate)


def _wrap_participation(plan: Plan, spec: CompressorSpec, seed: int, n: int,
                        device) -> Plan:
    """Fold Appendix D coins into the plan's per-node scale."""
    if spec.p_participate >= 1.0:
        return plan
    factor = participation_coins(generator(device, seed, "participation"),
                                 n, spec.p_participate)
    return plan._replace(scale=plan.scale * factor,
                         payload_coords=plan.payload_coords
                         * spec.p_participate,
                         wire_coords=plan.wire_coords * spec.p_participate)


def make_plan(spec: CompressorSpec, seed: int, n: int,
              mode: str = "independent", *, device) -> Plan:
    """Draw all of this round's compression randomness, for n nodes, from
    generators seeded by the round seed."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    plan = REGISTRY[spec.name].make_plan(spec, seed, n, mode, device)
    return _wrap_participation(plan, spec, seed, n, device)


# ---------------------------------------------------------------------------
# registrations
# ---------------------------------------------------------------------------

def _identity_plan(spec, seed, n, mode, device):
    return Plan(kind="passthrough", scale=1.0,
                payload_coords=float(spec.d), wire_coords=float(spec.d))


register(CompressorDef(
    name="identity",
    omega=lambda s: 0.0,
    expected_density=lambda s: float(s.d),
    make_plan=_identity_plan,
    wire_coords=lambda s, m: float(s.d),
))


def _randk_plan(spec, seed, n, mode, device):
    d, k = spec.d, spec.k
    gen = generator(device, seed, "plan")
    if mode == "shared_coords":
        idx = randk_indices(gen, d, k).expand(n, k)
        wire = float(k)                       # support rederivable from seed
    else:
        idx = randk_indices(gen, d, k, rows=n)
        wire = 2.0 * k                        # private support: idx + values
    return Plan(kind="sparsify", scale=float(d) / k, indices=idx,
                payload_coords=float(k), wire_coords=wire)


register(CompressorDef(
    name="randk",
    omega=lambda s: s.d / s.k - 1.0,          # Theorem F.2
    expected_density=lambda s: float(s.k),
    make_plan=_randk_plan,
    wire_coords=lambda s, m: (float(s.k) if m == "shared_coords"
                              else 2.0 * s.k),
    modes=("independent", "shared_coords"),
    supports_sparse=True,
))


def _permk_plan(spec, seed, n, mode, device):
    gen = generator("cpu", seed, "plan")
    private = mode == "independent"
    idx = perm_partition(gen, spec.d, n, device=device, private=private)
    # independent: values + the private shift; shared: the shift follows
    # the round seed, so only values ship
    wire = float(idx.shape[1]) + (1.0 if private else 0.0)
    return Plan(kind="sparsify", scale=float(n), indices=idx,
                payload_coords=spec.d / n, wire_coords=wire)


register(CompressorDef(
    name="permk",
    omega=lambda s: s.n - 1.0,                # as a collection (Szlendak+21)
    expected_density=lambda s: s.d / s.n,
    make_plan=_permk_plan,
    wire_coords=lambda s, m: (float(-(-s.d // s.n))
                              + (1.0 if m == "independent" else 0.0)),
    modes=("independent", "permk"),
    supports_sparse=True,
))


def _bernoulli_wire(spec, mode) -> float:
    factor = 1.0 if mode == "shared_coords" else 2.0
    return factor * spec.p * spec.d


def _bernoulli_plan(spec, seed, n, mode, device):
    d, p = spec.d, spec.p
    gen = generator(device, seed, "plan")
    if mode == "shared_coords":
        mask = draw_mask(gen, (1, d), p).expand(n, d)
    else:
        mask = draw_mask(gen, (n, d), p)
    return Plan(kind="sparsify", scale=1.0 / p,
                mask=mask.to(torch.float32).contiguous(),
                payload_coords=p * d,
                wire_coords=_bernoulli_wire(spec, mode))


register(CompressorDef(
    name="bernoulli",
    omega=lambda s: 1.0 / s.p - 1.0,          # RandP sparsifier
    expected_density=lambda s: s.p * s.d,
    make_plan=_bernoulli_plan,
    wire_coords=_bernoulli_wire,
    modes=("independent", "shared_coords"),
))


def _qdither_payload(spec) -> float:
    bits = math.ceil(math.log2(spec.s + 1)) + 1   # levels + sign
    return float(spec.d * bits / 32.0 + 1.0)      # + the fp32 norm


def _qdither_plan(spec, seed, n, mode, device):
    u = torch.rand((n, spec.d), generator=generator(device, seed, "plan"),
                   device=device)
    pay = _qdither_payload(spec)
    return Plan(kind="dither", scale=1.0, dither_u=u, levels=spec.s,
                payload_coords=pay, wire_coords=pay)


register(CompressorDef(
    name="qdither",
    # omega <= min(d/s^2, sqrt(d)/s)  (Alistarh et al. 2017, Lemma 3.1)
    omega=lambda s: float(min(s.d / s.s ** 2, math.sqrt(s.d) / s.s)),
    expected_density=_qdither_payload,
    make_plan=_qdither_plan,
    wire_coords=lambda s, m: _qdither_payload(s),
    modes=("independent",),
))


# -- omega calculus ----------------------------------------------------------

def omega_bernoulli(p: float) -> float:
    """Bernoulli-RandP: omega = 1/p - 1."""
    return 1.0 / p - 1.0


def omega_permk(n: int) -> float:
    """PermK collection: omega = n - 1."""
    return float(n - 1)


def momentum_a(omega: float) -> float:
    """The compressor momentum a = 1/(2 omega + 1) (Theorem 6.1)."""
    return 1.0 / (2.0 * omega + 1.0)


def omega_participation(omega: float, p: float) -> float:
    """Theorem D.1: a probability-p participation layer around a U(omega)
    compressor is U((omega+1)/p - 1)."""
    return (omega + 1.0) / p - 1.0

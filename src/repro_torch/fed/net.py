"""Layer 2 of the federated transport subsystem: network models (port of
``repro.fed.net``, numpy on both sides, so every multiplier matches the
reference's bit for bit).

A :class:`LinkModel` turns message bytes into seconds: fixed latency plus
bytes / bandwidth, scaled by a per-client per-round straggler multiplier
drawn from a pluggable distribution.  Multipliers are SLOWDOWNS (>= 1,
with 1 = the nominal link): a straggler delays, never accelerates, and
for a fixed underlying draw the multiplier is monotone in the severity
knob — so under common random numbers, raising severity degrades every
round time pointwise.  That is exactly the regime where MARINA's
all-client dense sync rounds lose to DASHA's never-synchronized
compressed uploads (benchmarks/fed_bench.py measures this).

Randomness is host-side ``numpy.random.Generator`` — the simulator models
the network, it never touches the method's random streams.
"""
from __future__ import annotations

import dataclasses

import numpy as np


class Straggler:
    """Slowdown-multiplier distribution (>= 1); ``draw(rng, size)`` where
    ``size`` is an int or a shape tuple (campaign matrices draw
    ``(rounds, n)`` in one call — for a PCG64 generator that consumes the
    stream exactly like ``rounds`` sequential ``(n,)`` draws, which is the
    heap-vs-vectorized CRN contract)."""

    def draw(self, rng: np.random.Generator, size) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Constant(Straggler):
    """No stragglers (severity floor): every multiplier is exactly 1."""

    def draw(self, rng, size):
        return np.ones(size)


@dataclasses.dataclass(frozen=True)
class Lognormal(Straggler):
    """exp(sigma |Z|), Z ~ N(0, 1): a half-lognormal slowdown >= 1 whose
    tail weight grows with sigma (sigma = 0 recovers the nominal link)."""

    sigma: float = 1.0

    def draw(self, rng, size):
        z = np.abs(rng.standard_normal(size))
        return np.exp(self.sigma * z) if self.sigma > 0 else np.ones(size)


@dataclasses.dataclass(frozen=True)
class Pareto(Straggler):
    """Heavy tail: Pareto(alpha, x_m=1), a slowdown >= 1.  Smaller alpha =
    heavier tail = worse stragglers (alpha <= 1 has infinite mean)."""

    alpha: float = 2.0

    def draw(self, rng, size):
        u = rng.random(size)
        return (1.0 - u) ** (-1.0 / self.alpha)


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """seconds = latency + bytes / bandwidth * straggler_multiplier.

    Defaults model a 100 Mbit/s WAN client link with 20 ms latency —
    coarse, but the simulator's comparisons are relative (same link for
    every method)."""

    latency_s: float = 0.02
    bandwidth_Bps: float = 12.5e6
    straggler: Straggler = Constant()

    def __post_init__(self):
        # a zero/negative/NaN bandwidth silently turns every barrier into
        # inf/NaN wall-clock; fail at construction, not mid-campaign
        if not (float(self.bandwidth_Bps) > 0.0):
            raise ValueError(
                f"bandwidth_Bps must be positive and finite, got "
                f"{self.bandwidth_Bps!r}")
        if not np.isfinite(self.bandwidth_Bps):
            raise ValueError(
                f"bandwidth_Bps must be finite, got {self.bandwidth_Bps!r}")
        if not (float(self.latency_s) >= 0.0):
            raise ValueError(
                f"latency_s must be >= 0 and finite, got "
                f"{self.latency_s!r}")

    def delays(self, rng: np.random.Generator,
               nbytes: np.ndarray) -> np.ndarray:
        """Per-client transfer times for one round; ``nbytes`` is (n,)."""
        nbytes = np.asarray(nbytes, np.float64)
        mult = self.straggler.draw(rng, nbytes.size)
        return self.transfer_s(nbytes, mult)

    def transfer_s(self, nbytes, mult) -> np.ndarray:
        """Transfer time from pre-drawn multipliers (any matching shape):
        latency + bytes / bandwidth * slowdown."""
        return self.latency_s + np.asarray(nbytes, np.float64) \
            / self.bandwidth_Bps * mult


def round_barrier(delays, active, empty: float = 0.0) -> float:
    """Wall-clock of one barrier round: the slowest ACTIVE client, or
    ``empty`` when the cohort is empty (C=0 after mass dropout — the
    degenerate round must cost a finite constant, never the NaN/-inf a
    bare masked max would produce)."""
    delays = np.asarray(delays, np.float64)
    active = np.asarray(active, bool)
    if not active.any():
        return float(empty)
    return float(delays[active].max())


def campaign_streams(rng: np.random.Generator, rounds: int):
    """One spawned child generator per round: the campaign's
    common-random-number plan, O(rounds) PCG states instead of an
    O(rounds * n) float64 matrix, and — because every round owns its own
    stream — identical draws no matter how a simulator chunks the
    campaign."""
    return rng.spawn(rounds)


def round_multipliers(stream: np.random.Generator, downlink: LinkModel,
                      uplink: LinkModel, n: int):
    """One round's straggler multipliers from its campaign stream — the
    DOWNLINK vector first, then the UPLINK vector (the fixed order both
    simulators share, so the heap oracle and the vectorized engine face
    bit-identical networks under one seed).  Every round draws for every
    client whether or not it participates — the CRN contract that makes
    two methods' wall-clock difference the methods', not the noise's."""
    return (downlink.straggler.draw(stream, n),
            uplink.straggler.draw(stream, n))


def campaign_multipliers(rng: np.random.Generator, rounds: int,
                         downlink: LinkModel, uplink: LinkModel, n: int):
    """All of a campaign's straggler draws up front: (rounds, n) downlink
    and uplink matrices assembled from the per-round spawned streams.

    Because the draws are keyed by (round, client) — never by arrival
    order — they are valid common random numbers even when rounds OVERLAP
    in time (asynchronous pipelined rounds keep messages from several
    rounds in flight at once), so a barrier run and an async run under one
    seed face the exact same per-round network."""
    md = np.empty((rounds, n), np.float64)
    mu = np.empty((rounds, n), np.float64)
    for t, stream in enumerate(campaign_streams(rng, rounds)):
        md[t], mu[t] = round_multipliers(stream, downlink, uplink, n)
    return md, mu


def severity_grid(kind: str = "lognormal", levels=(0.0, 0.5, 1.0, 1.5, 2.0)):
    """The bench's straggler-severity axis: a list of (label, Straggler)."""
    if kind == "lognormal":
        return [(f"sigma={s:g}", Lognormal(s) if s > 0 else Constant())
                for s in levels]
    if kind == "pareto":
        return [(f"alpha={a:g}", Pareto(a)) for a in levels]
    raise ValueError(kind)

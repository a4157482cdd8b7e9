"""Fault injection for the federated simulators (port of
``repro.fed.faults``, DESIGN.md §18; numpy on both sides, so every
realization equals the reference's bit for bit).

A :class:`FaultModel` is a deterministic, seeded description of what goes
wrong in a campaign: per-round client crashes with rejoin after k rounds
(the rejoining client's local state is stale or reset), uplink and
downlink message drops, message corruption (caught by the wire checksum,
:class:`repro_torch.fed.wire.WireCorruptionError`), and a per-round
deadline with bounded exponential-backoff retries for the rules that must
hear from everyone.

Randomness is host-side and laid out like the network layer's
(:func:`repro_torch.fed.net.campaign_streams`): one spawned child
generator per round, a fixed draw order inside each round (crash,
drop_down, drop_up, corrupt, then the retry uniforms), and thresholding,
so the same seed under a higher drop rate realizes a superset of the same
drop events, and two simulators (or a killed-and-restored campaign) face
the same fault streams however they chunk the rounds.

Bit-exactness contract.  The heap oracle
(:class:`repro_torch.fed.sim.FedSim`) and the vectorized simulator
(:class:`repro_torch.fed.vecsim.VecFedSim`) must realize identical fault
masks, or their integer byte traces diverge.  Every mask is therefore a
pure function of pre-drawn booleans and of one float comparison,
``m_up > deadline_mult`` (the float32 straggler multiplier against a
float32 cap), never of accumulated float arithmetic.  The deadline policy
is thus: a client is late when its uplink slowdown exceeds
``deadline_mult``, and a round that cut someone costs ``deadline_mult x
nominal_dense_round`` of wall clock.  Wall clock stays native per
simulator (float64 heap, float32 vectorized) under the usual tolerance;
the masks, and with them the math and the bytes, are bit-identical.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np

from repro_torch.fed import wire
from repro_torch.fed.net import LinkModel

REJOIN_MODES = ("stale", "reset")


class FaultCampaign(NamedTuple):
    """One campaign's realized faults, host-precomputed as (rounds, n)
    arrays — chunk-invariant, shared verbatim by both simulators.

    * ``crash_start`` — client goes down THIS round (stays down
      ``crash_rounds`` rounds);
    * ``crashed``     — client is down this round (window-OR of starts);
    * ``rejoin``      — first up-round after a crash (where the
      stale/reset rejoin semantics apply);
    * ``crash_left``  — rounds of crash remaining INCLUDING this one
      (0 when up) — how many retry attempts a sync re-request must
      outlast;
    * ``drop_down`` / ``drop_up`` / ``corrupt`` — per-link loss coins
      (corruption is a delivered-but-mangled upload: the heap oracle
      really flips a byte and proves the checksum catches it);
    * ``first_success`` — 1-based retry attempt at which a sync
      re-request finally lands (clamped at ``max_retries`` — see
      ``capped``); defined for every (t, i), consumed only where the
      round actually misses a client;
    * ``up_attempts``  — how many of those attempts transmitted an
      uplink payload (attempts that hit a still-crashed client bill the
      downlink re-request only);
    * ``capped``       — the retry budget ran out; the simulator
      declares the attempt delivered anyway (bounding the sim) and
      counts the event.
    """

    crash_start: np.ndarray
    crashed: np.ndarray
    rejoin: np.ndarray
    crash_left: np.ndarray
    drop_down: np.ndarray
    drop_up: np.ndarray
    corrupt: np.ndarray
    first_success: Optional[np.ndarray]
    up_attempts: Optional[np.ndarray]
    capped: Optional[np.ndarray]


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Seeded fault configuration for one campaign.

    ``rejoin="stale"`` freezes a crashed client's (h_i, g_i) across the
    outage (its rounds are simply discarded — the engine's drop gating);
    ``rejoin="reset"`` additionally zeroes the client's local state on
    reboot, with the server applying the matching ``-g_i/n`` correction
    (modeled as a reliable out-of-band reset notice) so the invariant
    ``g = mean_i(g_local_i)`` survives — see
    :class:`repro_torch.methods.engine.FaultStep`.

    ``deadline_mult`` derives the per-round deadline from the link model:
    the server cuts uplinks slower than ``deadline_mult`` x nominal and
    closes a short-handed round at ``deadline_mult`` x the nominal dense
    round-trip.  None disables the deadline (the server then proceeds
    with whatever was deliverable).  For ``sync_requires_all`` rules
    (MARINA / SYNC-MVR) missing clients are re-requested with exponential
    backoff (``backoff0_s`` doubling up to ``backoff_cap_s``), re-paying
    downlink ``x`` bytes per attempt and the uplink payload per attempt
    that reaches a live client, up to ``max_retries`` per round.
    """

    p_crash: float = 0.0
    crash_rounds: int = 3
    rejoin: str = "stale"
    p_drop_up: float = 0.0
    p_drop_down: float = 0.0
    p_corrupt: float = 0.0
    deadline_mult: Optional[float] = 4.0
    max_retries: int = 30
    backoff0_s: float = 0.05
    backoff_cap_s: float = 5.0
    seed: int = 0

    def __post_init__(self):
        for name in ("p_crash", "p_drop_up", "p_drop_down", "p_corrupt"):
            p = float(getattr(self, name))
            if not (0.0 <= p < 1.0):
                raise ValueError(f"{name}={p} must be in [0, 1)")
        if int(self.crash_rounds) < 1:
            raise ValueError(f"crash_rounds={self.crash_rounds} must be "
                             ">= 1")
        if self.rejoin not in REJOIN_MODES:
            raise ValueError(f"rejoin={self.rejoin!r} must be one of "
                             f"{REJOIN_MODES}")
        if self.deadline_mult is not None \
                and not (float(self.deadline_mult) > 1.0):
            raise ValueError(f"deadline_mult={self.deadline_mult} must "
                             "exceed 1 (1 = the nominal link, which "
                             "every transfer needs) or be None")
        if int(self.max_retries) < 1:
            raise ValueError(f"max_retries={self.max_retries} must be "
                             ">= 1")
        if not (float(self.backoff0_s) > 0.0
                and float(self.backoff_cap_s) >= float(self.backoff0_s)):
            raise ValueError("need 0 < backoff0_s <= backoff_cap_s")

    # ------------------------------------------------------------------
    # realization
    # ------------------------------------------------------------------

    def draw_campaign(self, rounds: int, n: int, *,
                      retries: bool = False) -> FaultCampaign:
        """Realize the whole campaign's faults: one spawned stream per
        round, fixed in-round draw order (crash, drop_down, drop_up,
        corrupt, retry matrix), thresholded after the fact — the CRN
        layout that keeps fault sets monotone in each probability knob
        and identical across chunkings/restores.  ``retries`` draws the
        (max_retries, n) per-round retry-failure uniforms too (only the
        sync-barrier rules consume them; skipping the draw for graceful
        rules cannot perturb the earlier draws — the order is fixed)."""
        rng = np.random.default_rng(self.seed)
        k = int(self.crash_rounds)
        a_max = int(self.max_retries)
        u_crash = np.empty((rounds, n))
        u_dd = np.empty((rounds, n))
        u_du = np.empty((rounds, n))
        u_co = np.empty((rounds, n))
        u_retry = np.empty((rounds, a_max, n)) if retries else None
        for t, stream in enumerate(rng.spawn(rounds)):
            u_crash[t] = stream.random(n)
            u_dd[t] = stream.random(n)
            u_du[t] = stream.random(n)
            u_co[t] = stream.random(n)
            if retries:
                u_retry[t] = stream.random((a_max, n))
        crash_start = u_crash < self.p_crash
        drop_down = u_dd < self.p_drop_down
        drop_up = u_du < self.p_drop_up
        corrupt = u_co < self.p_corrupt

        crashed = np.zeros((rounds, n), bool)
        crash_left = np.zeros((rounds, n), np.int32)
        for o in range(min(k, rounds)):
            win = crash_start[:rounds - o]
            crashed[o:] |= win
            crash_left[o:] = np.maximum(crash_left[o:],
                                        np.where(win, k - o, 0))
        rejoin = np.zeros((rounds, n), bool)
        rejoin[1:] = ~crashed[1:] & crashed[:-1]

        first = up_att = capped = None
        if retries:
            # one retry attempt per recovery slot: attempt a reaches the
            # client iff a >= crash_left, and its request/response round
            # trip survives with prob (1-p_drop_down)(1-p_drop_up)
            # (1-p_corrupt) — the same loss processes, re-drawn per
            # attempt from the round's own stream
            p_fail = 1.0 - (1.0 - self.p_drop_down) \
                * (1.0 - self.p_drop_up) * (1.0 - self.p_corrupt)
            fail = u_retry < p_fail                      # (R, A, n)
            att = np.arange(1, a_max + 1, dtype=np.int32)[None, :, None]
            c_eff = np.maximum(crash_left, 1)[:, None, :]
            ok = (att >= c_eff) & ~fail
            any_ok = ok.any(axis=1)
            first = np.where(any_ok, ok.argmax(axis=1) + 1,
                             a_max).astype(np.int32)
            capped = ~any_ok
            up_att = np.maximum(first - c_eff[:, 0, :] + 1, 0) \
                .astype(np.int32)
        return FaultCampaign(crash_start=crash_start, crashed=crashed,
                             rejoin=rejoin, crash_left=crash_left,
                             drop_down=drop_down, drop_up=drop_up,
                             corrupt=corrupt, first_success=first,
                             up_attempts=up_att, capped=capped)

    # ------------------------------------------------------------------
    # deadline / retry policy constants (shared by both simulators)
    # ------------------------------------------------------------------

    def late_cap(self) -> Optional[np.float32]:
        """The straggler-multiplier cutoff: a sender whose (float32)
        uplink multiplier exceeds this misses the deadline.  A static
        f32 compared against the stored f32 draws — the heap and the
        vectorized simulator realize the SAME late set bit for bit, with
        no float arithmetic in the decision."""
        if self.deadline_mult is None:
            return None
        return np.float32(self.deadline_mult)

    def deadline_s(self, downlink: LinkModel, uplink: LinkModel,
                   compute_s: float, d: int) -> Optional[np.float32]:
        """Wall-clock cost of a round that cut (or is re-requesting)
        someone: ``deadline_mult`` x the nominal dense round-trip
        (broadcast + compute + dense upload, multiplier 1) — a static
        f32 both simulators share (the heap widens it to f64 exactly)."""
        if self.deadline_mult is None:
            return None
        f = np.float32
        nominal = f(downlink.latency_s) \
            + f(X_BCAST_BYTES * d) / f(downlink.bandwidth_Bps) \
            + f(compute_s) + f(uplink.latency_s) \
            + f(wire.HEADER_BYTES + 4 * d) / f(uplink.bandwidth_Bps)
        return f(self.deadline_mult) * nominal

    def backoff_cumsum(self) -> np.ndarray:
        """(max_retries + 1,) f64 cumulative backoff: entry a is the
        total wait before attempt a lands (attempt spacing doubles from
        ``backoff0_s`` up to ``backoff_cap_s``); entry 0 is 0."""
        b = np.minimum(self.backoff0_s
                       * 2.0 ** np.arange(self.max_retries),
                       self.backoff_cap_s)
        return np.concatenate([[0.0], np.cumsum(b)])


X_BCAST_BYTES = 4                      # dense fp32 broadcast, per coord


def corrupt_bytes(buf: bytes, t: int, i: int) -> bytes:
    """Deterministically mangle one wire record (the heap oracle's
    corruption realization): XOR one body byte — position derived from
    (round, client), no RNG stream consumed — so
    :func:`repro_torch.fed.wire.verify` must raise WireCorruptionError.
    Header-only records (an empty Bernoulli support) flip the node field
    instead; the crc covers the header too."""
    if len(buf) > wire.HEADER_BYTES:
        pos = wire.HEADER_BYTES + (2654435761 * (t + 1) + 97 * i) \
            % (len(buf) - wire.HEADER_BYTES)
    else:
        pos = 2
    out = bytearray(buf)
    out[pos] ^= 0x5A
    return bytes(out)

"""Post-hoc timeline reconstruction for the vectorized simulator (port of
``repro.obs.vecreplay``, DESIGN.md §17).

:class:`repro_torch.fed.vecsim.VecFedSim` never materializes per-arrival
events: its chunks bring per-round scalars to the host only, which is why
it scales.  But every per-client quantity the heap oracle records is a
deterministic function of what the host already has:

* straggler multipliers replay from the campaign's common-random-number
  streams (:func:`repro_torch.fed.net.campaign_multipliers` under the
  sim's seed: the draws the chunks consumed, in the same order);
* per-client wire bytes come from the static wire schema (uniform
  counts), or, for Bernoulli compressors, whose realized counts are
  engine randomness, from re-drawing each round's plan through the port's
  stateless per-round randomness (``RoundRandom(seed, t, draws)``) and
  asking the substrate for the round's counts;
* coin rounds come from the result's traces (``sync_round``), and a
  sampled cohort from the substrate's ``cohort_schedule`` over the same
  ``(seed, t)`` draws;
* arrival times re-run the heap oracle's own float64 expressions on those
  inputs, so the reconstructed timestamps are bit-equal to what
  :class:`repro_torch.fed.sim.FedSim` records live
  (``tests/test_torch_obs.py`` holds them event for event).

``draws`` is the injected-randomness hook the campaign ran with
(``VecFedSim.run(..., draws=...)``), so a campaign that replayed the
reference's draws is rebuilt on those draws too.

Limits (raise, never approximate): barrier campaigns only (``tau``
pipelining interleaves rounds: record live through the heap oracle's
``obs=`` instead), and full-participation or sampled-cohort substrates
(Appendix-D presence coins, ``p_participate < 1``, are per-client engine
randomness that the round traces do not identify).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np

from repro_torch.core.rng import RoundRandom
from repro_torch.obs.timeline import Timeline, record_fed_round


def reconstruct_vec_timeline(sim, init_state, result: Any,
                             label: Optional[str] = None,
                             draws: Optional[Callable] = None) -> Timeline:
    """Rebuild the per-client event timeline of a finished
    :class:`~repro_torch.fed.vecsim.VecFedSim` barrier campaign.

    ``init_state`` is the state the campaign started from (its ``seed``
    and ``t`` anchor the replayed per-round randomness); ``result`` is the
    campaign's :class:`~repro_torch.fed.sim.SimResult`; ``draws`` the
    ``draws=`` the campaign ran with.  The reconstruction checks itself
    against the result's billed ``bytes_up`` round by round: a mismatch
    raises rather than exporting a timeline that disagrees with what was
    billed."""
    if sim.tau is not None:
        raise NotImplementedError(
            "vec timeline reconstruction covers barrier campaigns only: "
            "pipelined (tau) rounds interleave in time — record live "
            "through the heap sim's obs= handle instead")
    if sim.comp.spec.p_participate < 1.0:
        raise NotImplementedError(
            "Appendix-D presence coins (p_participate < 1) are per-"
            "client engine randomness the round traces do not identify; "
            "use the heap sim for per-client timelines of those runs")
    # the federated package imports this one: import it when called
    from repro_torch.fed.net import campaign_multipliers
    from repro_torch.fed.sim import X_BYTES_PER_COORD
    from repro_torch.fed.wire import HEADER_BYTES
    tr = result.traces
    rounds = len(tr["sim_wall_clock"])
    n, d = sim.n, int(sim.comp.spec.d)
    schema = sim.schema
    x_bytes = X_BYTES_PER_COORD * d
    dense_up = HEADER_BYTES + 4 * d
    seed, t0 = int(init_state.seed), int(init_state.t)

    md_all, mu_all = campaign_multipliers(
        np.random.default_rng(sim.seed), rounds, sim.downlink, sim.uplink, n)
    sels = None
    if sim.sampled:
        sels = sim.substrate.cohort_schedule(seed, t0, rounds, draws)
    counts_all = None
    if schema.static_count is None:
        # Bernoulli: realized counts are engine randomness — re-draw each
        # round's plan and re-ask the substrate (host loop; small-n tool)
        counts_all = np.stack([
            sim._bound.round_wire_counts(RoundRandom(
                seed, t0 + t, None if draws is None else draws(t0 + t)))
            .cpu().numpy().astype(np.int64) for t in range(rounds)])

    tl = Timeline(label or f"vec/{sim.variant}")
    now = 0.0
    for t in range(rounds):
        coin = bool(tr["sync_round"][t])
        active = np.zeros(n, bool)
        if sels is not None:
            active[sels[t]] = True
        else:
            active[:] = True
        if coin:
            per_node = np.where(active, dense_up, 0).astype(np.int64)
        elif counts_all is not None:
            per_node = np.where(
                active,
                schema.header_bytes
                + schema.bytes_per_value * counts_all[t], 0)
        else:
            per_node = np.where(
                active,
                schema.header_bytes
                + schema.bytes_per_value * schema.static_count, 0)
        billed = int(tr["bytes_up"][t])
        if int(per_node.sum()) != billed:
            raise AssertionError(
                f"vec timeline reconstruction drifted from the billed "
                f"bytes at round {t}: rebuilt {int(per_node.sum())} vs "
                f"traced {billed}")
        down_bytes = np.where(active, x_bytes, 0)
        # the heap oracle's own float64 arrival chain, term for term
        t_down = sim.downlink.transfer_s(down_bytes.astype(np.float64),
                                         md_all[t])
        t_up = sim.uplink.transfer_s(per_node.astype(np.float64),
                                     mu_all[t])
        delay = t_down + sim.compute_s + t_up
        arrivals = now + delay
        completion = float(arrivals[active].max()) if active.any() \
            else now + sim.downlink.latency_s
        record_fed_round(
            tl, round=t, bcast=now, completion=completion, active=active,
            arrivals=arrivals, t_down=t_down, t_up=t_up,
            per_node_bytes=per_node, down_bytes=down_bytes,
            compute_s=sim.compute_s, coin=coin,
            server_down_bytes=int(tr["bytes_down"][t]),
            cohort=None if sels is None else sels[t])
        now = completion
    return tl

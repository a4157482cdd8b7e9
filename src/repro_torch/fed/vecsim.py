"""The vectorized federated simulator with round barriers (port of
``repro.fed.vecsim``, DESIGN.md §12 and §16): a whole campaign (engine
math, wire bytes, network time) as chunks of rounds on the device.

* **Bytes** are analytic: :func:`repro_torch.fed.wire.wire_schema`
  classifies the compressor's wire format (header bytes, bytes per
  shipped value, static count); Bernoulli masks' data-dependent counts
  come from the round's plan (the substrate's ``round_wire_counts`` /
  ``cohort_counts``).  Per-round totals are exact integers.
* **Time** is a masked max.  Straggler multipliers come from the
  per-round spawned numpy streams of :mod:`repro_torch.fed.net`
  (downlink first, then uplink), so they equal the reference's bit for
  bit; each client's arrival is ``latency_down + bytes_down / bw *
  mult_down + compute + latency_up + bytes_up / bw * mult_up`` in float32,
  and a round ends at the max over the clients that take part (all n on a
  ``sync_requires_all`` coin round; an empty round costs the downlink
  latency).
* **Chunks.**  The reference scans each chunk in one compiled
  ``lax.scan``; here a chunk is a Python loop over rounds whose per-round
  scalars (metric, participants, value count, round time) stay on the
  device until the chunk ends: one device-to-host transfer per chunk.

Two client-state stores, bit-identical in every trace and in the final
state: ``"scatter"`` steps the (n, d) store every round (each round's
cohort rows are scattered into a new store, so a state handed in is never
written); ``"slab"`` (the default under client sampling) takes each
chunk's cohort schedule ahead of the chunk, gathers the union of the rows
it touches into a compact (U, d) slab, runs the chunk on the slab alone and
writes the slab back once per chunk with the slab-writeback kernel
(:func:`repro_torch.kernels.ops.slab_writeback`).  The slab store writes
into the campaign's own copy of the (n, d) store, made once at the start
of :meth:`VecFedSim.run`: the caller's state is never written.

Not ported yet: asynchronous pipelined rounds (``tau=``), fault injection
(``faults=``) and the observability handle (``obs=``); each raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.rng import Draws, RoundRandom
from repro_torch.fed import wire
from repro_torch.fed.net import LinkModel, campaign_streams, round_multipliers
from repro_torch.fed.sim import DEFAULT_CHUNK, X_BYTES_PER_COORD, SimResult
from repro_torch.kernels import ops
from repro_torch.methods.accounting import downlink_receivers
from repro_torch.methods.engine import Hyper, Method
from repro_torch.methods.rules import get_rule
from repro_torch.methods.substrates import gather_slab_rows, slab_layout

DrawsFn = Callable[[int], Optional[Draws]]

#: the per-round device scalars a chunk stacks, in column order
_DEVICE_YS = ("metric", "participants", "counts_sum", "round_t")


@dataclasses.dataclass
class VecFedSim:
    """Vectorized federated run of one variant x compressor x substrate,
    for n = 10^4-10^5 clients x 10^3 rounds, including the sampled-client
    substrate whose rounds cost O(C*d)."""

    variant: str
    comp: Any                          # RoundCompressor
    substrate: Any                     # FlatSubstrate / SampledFlatSubstrate
    hyper: Hyper
    uplink: LinkModel = LinkModel()
    downlink: LinkModel = LinkModel()
    compute_s: float = 0.01
    seed: int = 0
    chunk: int = DEFAULT_CHUNK
    #: staleness bound of asynchronous pipelined rounds: not ported yet
    tau: Optional[int] = None
    #: client-state store for sampled substrates (DESIGN.md §16): "slab",
    #: "scatter", or "auto" (slab exactly when the substrate samples
    #: clients, c < n)
    store: str = "auto"
    #: fault injection: not ported yet
    faults: Any = None

    def __post_init__(self):
        self.rule = get_rule(self.variant)
        if self.rule.sync_requires_all and self.comp.spec.p_participate < 1:
            raise ValueError(
                f"{self.rule.name!r} has a client-synchronization barrier "
                "(sync_requires_all): Appendix-D partial participation "
                "does not apply; every client must answer sync rounds")
        if not hasattr(self.substrate, "estimator_update_full"):
            raise ValueError(
                "VecFedSim needs a substrate exposing estimator_update_full"
                f", got {type(self.substrate).__name__}")
        if self.tau is not None:
            raise NotImplementedError(
                "tau= (asynchronous pipelined rounds) belongs to a later "
                "slice of the port; run with round barriers (tau=None)")
        if self.faults is not None:
            raise NotImplementedError(
                "faults= (fault injection) belongs to a later slice of the "
                "port")
        self.sampled = bool(getattr(self.substrate, "samples_clients",
                                    False))
        if self.store not in ("auto", "scatter", "slab"):
            raise ValueError(f"store={self.store!r} must be 'auto', "
                             "'scatter' or 'slab'")
        if self.store == "slab" and not self.sampled:
            raise ValueError("store='slab' needs a sampled-client "
                             "substrate (c < n); at c == n the scatter "
                             "store IS the degenerate slab")
        self.slab = self.sampled and self.store != "scatter"
        self.n = int(getattr(self.substrate, "n", self.comp.n))
        self._bound = self.substrate.with_compressor(self.comp)
        self.schema = wire.wire_schema(
            self._bound.cohort_rc if self.sampled else self.comp,
            slot_keyed=self.sampled)
        self.method: Method = Method.build(self.variant, self.comp,
                                           self.substrate, self.hyper)
        self._default_metric = None

    def init(self, x0, seed: int, **kw):
        return self.method.init(x0, seed, **kw)

    def _metric_fn(self, metric_fn):
        if metric_fn is not None:
            return metric_fn
        if self._default_metric is None:
            self._default_metric = self.substrate.default_metric()
        return self._default_metric

    # ------------------------------------------------------------------
    # one round
    # ------------------------------------------------------------------

    def _delay(self, down_b, up_b, m_down, m_up):
        """Per-client float32 arrival times of one round."""
        return self.downlink.latency_s \
            + down_b / self.downlink.bandwidth_Bps * m_down \
            + self.compute_s \
            + self.uplink.latency_s \
            + up_b / self.uplink.bandwidth_Bps * m_up

    def _comp_bytes(self, counts):
        schema = self.schema
        return schema.header_bytes \
            + schema.bytes_per_value * counts.to(torch.float32)

    def _round_scatter(self, st, m_down, m_up, draws, metric_fn):
        """One round on the (n, d) store; returns (state, coin, device
        scalars in :data:`_DEVICE_YS` order)."""
        n, d = self.n, int(self.comp.spec.d)
        new, info = self.method.step_full(st, None, draws=draws)
        coin = bool(info.coin) if info.coin is not None else False
        dev = m_down.device
        if info.present is not None and not (
                coin and self.rule.sync_requires_all):
            active = info.present
        else:
            # full participation, or the barrier: every client answers
            active = torch.ones((n,), dtype=torch.bool, device=dev)
        if self.schema.static_count is None:
            counts = self._bound.round_wire_counts(
                RoundRandom(st.seed, st.t, draws))
        else:
            counts = torch.full((n,), self.schema.static_count,
                                dtype=torch.int32, device=dev)
        counts = counts * active                           # absent: 0
        act = active.to(torch.float32)
        if coin:
            up_b = float(wire.HEADER_BYTES + 4 * d) * act
        else:
            up_b = self._comp_bytes(counts) * act
        down_b = float(X_BYTES_PER_COORD * d) * act
        delay = self._delay(down_b, up_b, m_down, m_up)
        masked = torch.where(active, delay,
                             torch.full_like(delay, float("-inf")))
        n_active = torch.sum(active.to(torch.int64))
        round_t = torch.where(n_active > 0, torch.max(masked),
                              torch.full_like(masked[0],
                                              self.downlink.latency_s))
        return new, coin, (torch.as_tensor(metric_fn(new), device=dev),
                           n_active, torch.sum(counts), round_t)

    def _round_slab(self, st, m_down_c, m_up_c, window, draws, metric_fn):
        """One round on the chunk slab: every quantity in (C,) space,
        bit-equal to the scatter round's (n,)-masked one (integer sums and
        a max over the same per-client float32 values)."""
        c, d = int(self.substrate.c), int(self.comp.spec.d)
        new, info = self.method.step_full(st, None, draws=draws,
                                          window=window)
        # sampled-capable variants have no sync coin (Method.build rejects
        # sync_requires_all on sampled substrates)
        coin = bool(info.coin) if info.coin is not None else False
        dev = m_down_c.device
        if self.schema.static_count is None:
            counts = self._bound.cohort_counts(
                RoundRandom(st.seed, st.t, draws))
        else:
            counts = torch.full((c,), self.schema.static_count,
                                dtype=torch.int32, device=dev)
        ones = torch.ones((c,), dtype=torch.float32, device=dev)
        if coin:
            up_b = float(wire.HEADER_BYTES + 4 * d) * ones
        else:
            up_b = self._comp_bytes(counts) * ones
        down_b = float(X_BYTES_PER_COORD * d) * ones
        delay = self._delay(down_b, up_b, m_down_c, m_up_c)
        return new, coin, (torch.as_tensor(metric_fn(new), device=dev),
                           torch.full((), c, dtype=torch.int64, device=dev),
                           torch.sum(counts), torch.max(delay))

    # ------------------------------------------------------------------
    # one chunk
    # ------------------------------------------------------------------

    def _chunk_multipliers(self, streams, done: int, length: int):
        """This chunk's (length, n) float32 straggler multipliers, each
        round's spawned stream drawing downlink then uplink."""
        n = self.n
        md = np.empty((length, n), np.float32)
        mu = np.empty((length, n), np.float32)
        for j in range(length):
            md[j], mu[j] = round_multipliers(
                streams[done + j], self.downlink, self.uplink, n)
        return md, mu

    @staticmethod
    def _draws_at(draws: Optional[DrawsFn], t: int) -> Optional[Draws]:
        return None if draws is None else draws(t)

    @staticmethod
    def _chunk_ys(rows, coins, bits) -> Dict[str, np.ndarray]:
        """The chunk's per-round outputs on the host: the device scalars
        stacked into one (length, 4) float64 tensor (exact for float32
        values and the integer counts) and moved in one transfer."""
        cols = [torch.stack([r[k] for r in rows]).to(torch.float64)
                for k in range(len(_DEVICE_YS))]
        host = torch.stack(cols, dim=1).cpu().numpy()
        ys = {name: host[:, k] for k, name in enumerate(_DEVICE_YS)}
        ys["coin"] = np.asarray(coins, bool)
        ys["bits"] = np.asarray(bits, np.float32)
        return ys

    def _chunk_scatter(self, state, length: int, md, mu, metric_fn, draws):
        dev = state.x.device
        m_down = torch.as_tensor(md, device=dev)
        m_up = torch.as_tensor(mu, device=dev)
        rows, coins, bits = [], [], []
        for j in range(length):
            state, coin, vals = self._round_scatter(
                state, m_down[j], m_up[j], self._draws_at(draws, state.t),
                metric_fn)
            rows.append(vals)
            coins.append(coin)
            bits.append(state.bits_sent)
        return state, self._chunk_ys(rows, coins, bits)

    def _slab_chunk_xs(self, state, length: int, md: np.ndarray,
                       mu: np.ndarray, draws: Optional[DrawsFn] = None):
        """One chunk's slab plumbing on the host: the cohort schedule (the
        same draws the rounds would make), the slab layout and the
        cohort's own multipliers."""
        sels = self.substrate.cohort_schedule(state.seed, state.t, length,
                                              draws)
        uniq_pad, loc = slab_layout(sels, self.n)
        md_c = np.take_along_axis(md, sels, axis=1)
        mu_c = np.take_along_axis(mu, sels, axis=1)
        return sels, uniq_pad, loc, md_c, mu_c

    @staticmethod
    def _slab_enter(state, idx: torch.Tensor):
        """Gather the chunk's touched rows into the slab.  Returns
        (slab_state, full_h, full_g): the (n, d) stores wait untouched
        until :meth:`_slab_exit`."""
        st = state._replace(h_local=gather_slab_rows(state.h_local, idx),
                            g_local=gather_slab_rows(state.g_local, idx))
        return st, state.h_local, state.g_local

    @staticmethod
    def _slab_exit(state, idx: torch.Tensor, full_h, full_g):
        """Per-chunk writeback: one O(U*d) in-place scatter into each
        store through the slab-writeback kernel."""
        return state._replace(
            h_local=ops.slab_writeback(full_h, idx, state.h_local),
            g_local=ops.slab_writeback(full_g, idx, state.g_local))

    def _chunk_slab(self, state, length: int, md, mu, metric_fn, draws):
        dev = state.x.device
        sels, uniq, loc, md_c, mu_c = self._slab_chunk_xs(
            state, length, md, mu, draws)
        idx = torch.as_tensor(uniq, device=dev)
        sels_t = torch.as_tensor(sels, device=dev).to(torch.int64)
        loc_t = torch.as_tensor(loc, device=dev).to(torch.int64)
        m_down = torch.as_tensor(md_c, device=dev)
        m_up = torch.as_tensor(mu_c, device=dev)
        st, full_h, full_g = self._slab_enter(state, idx)
        rows, coins, bits = [], [], []
        for j in range(length):
            st, coin, vals = self._round_slab(
                st, m_down[j], m_up[j], (sels[j], sels_t[j], loc_t[j]),
                self._draws_at(draws, st.t), metric_fn)
            rows.append(vals)
            coins.append(coin)
            bits.append(st.bits_sent)
        state = self._slab_exit(st, idx, full_h, full_g)
        return state, self._chunk_ys(rows, coins, bits)

    # ------------------------------------------------------------------
    # the campaign
    # ------------------------------------------------------------------

    def run(self, state, rounds: int, *,
            metric_fn: Optional[Callable] = None, obs=None,
            start_round: int = 0, clock0: float = 0.0,
            checkpoint: Optional[Callable] = None,
            draws: Optional[DrawsFn] = None) -> SimResult:
        """Run campaign rounds ``start_round .. rounds - 1`` from
        ``state``.

        ``start_round`` / ``clock0`` / ``checkpoint`` are the kill-and-
        restore contract: the per-round network streams are keyed by the
        absolute round, the wall clock accumulates sequentially from
        ``clock0``, and ``checkpoint(state, next_round, wall_clock)``
        fires after each chunk with a snapshot the campaign no longer
        writes.  ``draws(t)`` injects round t's randomness (plan, coins,
        samples, cohort) for the parity tests; None draws it.  ``state``
        is never written."""
        if obs is not None:
            raise NotImplementedError(
                "obs= (the observability handle) belongs to a later slice "
                "of the port")
        metric_fn = self._metric_fn(metric_fn)
        if not (0 <= int(start_round) <= rounds):
            raise ValueError(f"start_round={start_round} outside "
                             f"[0, {rounds}]")
        return self._run_barrier(state, rounds, metric_fn, start_round,
                                 clock0, checkpoint, draws)

    @staticmethod
    def _seq_wall(round_t: np.ndarray, clock0: float) -> np.ndarray:
        """Per-round absolute wall clock by sequential float64
        accumulation from ``clock0``: the exact chain an uninterrupted run
        produces, so a resumed campaign continues bit-identically."""
        out = np.empty(round_t.shape, np.float64)
        c = float(clock0)
        for i, r in enumerate(round_t.astype(np.float64)):
            c = c + r
            out[i] = c
        return out

    @staticmethod
    def _snapshot(state):
        """A copy of the state's stores that the campaign will not write."""
        return state._replace(h_local=state.h_local.clone(),
                              g_local=state.g_local.clone())

    def _run_barrier(self, state, rounds: int, metric_fn,
                     start_round: int = 0, clock0: float = 0.0,
                     checkpoint: Optional[Callable] = None,
                     draws: Optional[DrawsFn] = None) -> SimResult:
        rng = np.random.default_rng(self.seed)
        streams = campaign_streams(rng, rounds)
        if rounds <= 0 or start_round >= rounds:
            return SimResult(state=state, traces={}, events=None,
                             summary={"rounds": 0.0,
                                      "wall_clock_s": float(clock0)})
        if self.slab:
            # the campaign's own copy of the two stores, made once: every
            # chunk's slab is written back into it in place
            state = self._snapshot(state)
        parts = []
        now = float(clock0)
        done = start_round
        while done < rounds:
            length = min(self.chunk, rounds - done)
            md, mu = self._chunk_multipliers(streams, done, length)
            run_chunk = self._chunk_slab if self.slab else \
                self._chunk_scatter
            state, part = run_chunk(state, length, md, mu, metric_fn, draws)
            parts.append(part)
            done += length
            if checkpoint is not None:
                now = float(self._seq_wall(part["round_t"], now)[-1])
                checkpoint(self._snapshot(state) if self.slab else state,
                           done, now)
        ys = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

        n_run = rounds - start_round
        wall = self._seq_wall(ys["round_t"], clock0)
        bcast = np.concatenate([[clock0], wall[:-1]])
        traces, summary = self._bill_round_bytes(
            ys, n_run, wall, bcast, wall_clock_s=float(wall[-1]))
        return SimResult(state=state, traces=traces, events=None,
                         summary=summary)

    def _bill_round_bytes(self, ys, rounds: int, wall: np.ndarray,
                          bcast: np.ndarray, wall_clock_s: float):
        """Exact byte billing and trace/summary assembly from a campaign's
        per-round outputs; totals are int64 on the host."""
        n, d = self.n, int(self.comp.spec.d)
        coin = ys["coin"].astype(bool)
        part = ys["participants"].astype(np.int64)
        csum = ys["counts_sum"].astype(np.int64)
        head, bpv = self.schema.header_bytes, self.schema.bytes_per_value
        dense_total = n * (wire.HEADER_BYTES + 4 * d)
        bytes_up = np.where(coin, dense_total, head * part + bpv * csum)
        value_bytes = np.where(coin, n * 4 * d, 4 * csum)
        # cohort-only downlink: the broadcast reaches the clients that
        # compute this round (the C-cohort under sampling, all n otherwise)
        recv = downlink_receivers(n, self.substrate.c if self.sampled
                                  else None)
        bytes_down = np.full(rounds, X_BYTES_PER_COORD * d * recv,
                             np.int64)
        traces = {
            "metric": ys["metric"].astype(np.float64),
            "bits_sent": ys["bits"].astype(np.float64),
            "bytes_up": bytes_up.astype(np.float64),
            "value_bytes": value_bytes.astype(np.float64),
            "bytes_down": bytes_down.astype(np.float64),
            "sim_wall_clock": wall,
            "bcast_clock": bcast,
            "sync_round": coin.astype(np.float64),
            "participants": part.astype(np.float64),
        }
        summary = {
            "rounds": float(rounds),
            "wall_clock_s": wall_clock_s,
            "bytes_up": float(bytes_up.sum()),
            "bytes_down": float(bytes_down.sum()),
            "sync_rounds": float(coin.sum()),
            "mean_participants": float(part.mean()),
            "mean_bytes_up_per_round": float(bytes_up.sum()) / rounds,
        }
        return traces, summary

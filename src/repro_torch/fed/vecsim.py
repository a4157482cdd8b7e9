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

With ``faults=`` the campaign is faulted (DESIGN.md §18) on the heap
oracle's own host-drawn :class:`repro_torch.fed.faults.FaultCampaign`:
each chunk's fault booleans go to the device in one transfer, each
round's masks are pure boolean functions of them and of the round's
participation (:func:`repro_torch.fed.sim.fault_masks`), and the byte
traces equal the heap's bit for bit (:meth:`VecFedSim._run_faulted`).

With ``tau=`` the rounds are asynchronous and pipelined (DESIGN.md §14):
the server broadcasts round t once every round older than t - tau has
landed, and steps from ``g`` minus the messages still in flight
(:class:`_Pipeline`, :meth:`VecFedSim._run_async`).

With ``obs=`` (a :class:`repro_torch.obs.Obs`, DESIGN.md §17) a live
timeline gets each chunk and the slab store's gather and writeback as
HOST spans, and a metrics registry the campaign counters the heap oracle
emits; the per-client view is rebuilt after the run by
:func:`repro_torch.obs.reconstruct_vec_timeline`.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.rng import RoundRandom
from repro_torch.fed import wire
from repro_torch.fed.net import LinkModel, campaign_streams, round_multipliers
from repro_torch.fed import faults as faultslib
from repro_torch.fed.sim import (DEFAULT_CHUNK, X_BYTES_PER_COORD, DrawsFn,
                                 SimResult, _obs_fault_metrics,
                                 _obs_fed_metrics, check_faults,
                                 check_resume, check_tau, chunk_faults,
                                 draws_at, fault_masks, faults_to, slab_enter,
                                 slab_exit, snapshot)
from repro_torch.methods.accounting import downlink_receivers
from repro_torch.methods.engine import FaultStep, Hyper, Method
from repro_torch.methods.rules import get_rule
from repro_torch.methods.substrates import slab_layout
from repro_torch.obs.handle import (NULL, host_span, maybe as _obs_scope,
                                    record_chunk)

#: the per-round device scalars a chunk stacks, in column order
_DEVICE_YS = ("metric", "participants", "counts_sum", "round_t")
#: ... and those of a faulted chunk, gracefully degrading or sync rules
_GRACEFUL_YS = _DEVICE_YS + ("senders", "dropped", "late", "lost",
                             "offline", "wasted_n", "wasted_counts")
_SYNC_YS = _DEVICE_YS + ("senders", "counts_send", "dropped", "late",
                         "lost", "offline", "retries", "retry_up_n",
                         "retry_counts", "capped", "wasted_n",
                         "wasted_counts")
#: ... and those of an asynchronous chunk: how far each round's broadcast
#: moved the clock, and when the round's own uploads finished after it
_ASYNC_YS = ("metric", "participants", "counts_sum", "bcast_rel",
             "land_rel")


class _Pipeline:
    """The device state of an asynchronous campaign (DESIGN.md §14), every
    clock float32 and relative to the latest broadcast, rebased each round
    as the reference's scan carry is:

    * ``free`` (n,): when each client finishes its last upload;
    * ``arrivals`` (tau + 1, n) and ``floors`` (tau + 1,): each of the
      last tau + 1 rounds' per-client landings (-inf for a client that
      sent nothing) and its completion; slot 0 is round t - 1 - tau, whose
      completion gates broadcast t;
    * ``flush``: a ``pipeline_coin_flush`` rule's pending gate, the
      completion of its last coin round;
    * for tau >= 1, ``msgs`` (tau, C, d) and ``ids`` (tau, C): the message
      rows of rounds t - tau .. t - 1 and their clients' global ids (C = n
      and the ids ``arange(n)`` on a dense store, the cohort under
      sampling).

    The deficit is one masked ``torch.sum`` over ``msgs`` with the
    in-flight landings gathered at ``ids``: the same tensors and the same
    reduction on the scatter and the slab store, so the two stores agree
    bit for bit, and no (n, d) transient is ever built."""

    def __init__(self, tau: int, n: int, c: int, d: int, dev):
        f32, inf = torch.float32, float("-inf")
        self.tau = int(tau)
        self.free = torch.zeros((n,), dtype=f32, device=dev)
        self.arrivals = torch.full((tau + 1, n), inf, dtype=f32, device=dev)
        self.floors = torch.full((tau + 1,), inf, dtype=f32, device=dev)
        self.flush = torch.full((), inf, dtype=f32, device=dev)
        self.msgs = self.ids = None
        if tau >= 1:
            self.msgs = torch.zeros((tau, c, d), dtype=f32, device=dev)
            self.ids = torch.zeros((tau, c), dtype=torch.int64, device=dev)

    def rebase(self):
        """Broadcast the next round: wait for slot 0's completion and any
        pending flush, and move every clock so that the broadcast is 0.
        Returns how far the broadcast advanced (a device scalar, >= 0)."""
        adv = torch.clamp_min(torch.maximum(self.floors[0], self.flush), 0.0)
        self.free = self.free - adv
        self.arrivals = self.arrivals - adv
        self.floors = self.floors - adv
        self.flush = torch.full_like(self.flush, float("-inf"))
        return adv

    def deficit(self, n: int):
        """(1/n) times the sum of the ring's messages still in flight at the
        broadcast (landing after it), or None at tau = 0."""
        if self.tau == 0:
            return None
        in_flight = torch.gather(self.arrivals[1:] > 0.0, 1, self.ids)
        return torch.sum(torch.where(in_flight[..., None], self.msgs, 0.0),
                         dim=(0, 1)) / n

    def push(self, landed, close, rows, ids) -> None:
        """Retire slot 0 and append the round just broadcast: its (n,)
        landings, its completion and (tau >= 1) its message rows."""
        self.arrivals = torch.cat([self.arrivals[1:], landed[None]])
        self.floors = torch.cat([self.floors[1:], close[None]])
        if self.tau >= 1:
            self.msgs = torch.cat([self.msgs[1:], rows[None]])
            self.ids = torch.cat([self.ids[1:], ids[None]])

    def flush_at(self, close) -> None:
        """A coin round of a ``pipeline_coin_flush`` rule: the sync reset
        discards every message in flight, and the next broadcast waits for
        this round's completion."""
        inf = float("-inf")
        self.flush = close
        self.arrivals = torch.full_like(self.arrivals, inf)
        self.floors = torch.full_like(self.floors, inf)
        if self.tau >= 1:
            self.msgs = torch.zeros_like(self.msgs)


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
    #: staleness bound of asynchronous pipelined rounds (DESIGN.md §14):
    #: None keeps the round barrier; tau >= 0 lets rounds t - tau .. t - 1
    #: still be in flight when round t is broadcast
    tau: Optional[int] = None
    #: client-state store for sampled substrates (DESIGN.md §16): "slab",
    #: "scatter", or "auto" (slab exactly when the substrate samples
    #: clients, c < n)
    store: str = "auto"
    #: fault injection (DESIGN.md §18): the same seeded
    #: :class:`repro_torch.fed.faults.FaultModel` the heap oracle takes;
    #: round barriers (``tau=None``) and dense substrates only
    faults: Optional[faultslib.FaultModel] = None

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
        self.sampled = bool(getattr(self.substrate, "samples_clients",
                                    False))
        check_faults(self)
        check_tau(self)
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

    def _close(self, delay, mask):
        """(how many clients ``mask`` holds, the latest of their arrival
        times ``delay``; the downlink latency when it holds none)."""
        masked = torch.where(mask, delay,
                             torch.full_like(delay, float("-inf")))
        count = torch.sum(mask.to(torch.int64))
        return count, torch.where(count > 0, torch.max(masked),
                                  torch.full_like(masked[0],
                                                  self.downlink.latency_s))

    def _comp_bytes(self, counts):
        schema = self.schema
        return schema.header_bytes \
            + schema.bytes_per_value * counts.to(torch.float32)

    def _arrivals(self, free, down_b, up_b, m_down, m_up):
        """Per-client float32 landings of an asynchronous round, relative
        to its broadcast: a client starts once the broadcast reaches it and
        its previous upload is done.  The not-busy branch is
        :meth:`_delay` itself, so at tau = 0 (where no client is ever
        busy) the landings are the barrier round's bit for bit."""
        reach = self.downlink.latency_s \
            + down_b / self.downlink.bandwidth_Bps * m_down
        busy = free + self.compute_s + self.uplink.latency_s \
            + up_b / self.uplink.bandwidth_Bps * m_up
        return torch.where(free > reach, busy,
                           self._delay(down_b, up_b, m_down, m_up))

    def _step_active(self, st, draws, dev, deficit=None):
        """The engine's fault-free step and who answers it: (state, the
        step's info, coin, the (n,) active set, its shipped value counts
        (zero outside it), each client's float32 upload record bytes).
        Every client answers at full participation and on a coin round of
        a ``sync_requires_all`` rule; the record is dense on a coin
        round."""
        n, d = self.n, int(self.comp.spec.d)
        new, info = self.method.step_full(st, None, draws=draws,
                                          deficit=deficit)
        coin = bool(info.coin) if info.coin is not None else False
        if info.present is not None and not (
                coin and self.rule.sync_requires_all):
            active = info.present
        else:
            active = torch.ones((n,), dtype=torch.bool, device=dev)
        counts = self._counts(RoundRandom(st.seed, st.t, draws), active,
                              dev)
        if coin:
            record = torch.full((n,), float(wire.HEADER_BYTES + 4 * d),
                                dtype=torch.float32, device=dev)
        else:
            record = self._comp_bytes(counts)
        return new, info, coin, active, counts, record

    def _link_bytes(self, record, mask):
        """(uplink, downlink) float32 bytes a client moves this round: its
        upload record and the broadcast iterate, zero outside ``mask``."""
        m = mask.to(torch.float32)
        return record * m, \
            float(X_BYTES_PER_COORD * int(self.comp.spec.d)) * m

    def _round_scatter(self, st, m_down, m_up, draws, metric_fn,
                       pipe: Optional[_Pipeline] = None, ids=None):
        """One round on the (n, d) store; returns (state, coin, device
        scalars in :data:`_DEVICE_YS` order).  With ``pipe`` the round is
        asynchronous: broadcast at the pipeline's gate, stepped with its
        deficit, its landings and messages (clients ``ids``) pushed into
        it; the scalars are then :data:`_ASYNC_YS`."""
        dev = m_down.device
        adv = deficit = None
        if pipe is not None:
            adv = pipe.rebase()
            deficit = pipe.deficit(self.n)
        new, info, coin, active, counts, record = self._step_active(
            st, draws, dev, deficit)
        up_b, down_b = self._link_bytes(record, active)
        metric = torch.as_tensor(metric_fn(new), device=dev)
        if pipe is None:
            n_active, round_t = self._close(
                self._delay(down_b, up_b, m_down, m_up), active)
            return new, coin, (metric, n_active, torch.sum(counts), round_t)
        land = self._arrivals(pipe.free, down_b, up_b, m_down, m_up)
        n_active, close = self._close(land, active)
        pipe.free = torch.where(active, land, pipe.free)
        landed = torch.where(active, land, torch.full_like(land,
                                                           float("-inf")))
        self._pipe_commit(pipe, coin, landed, close, info, ids)
        return new, coin, (metric, n_active, torch.sum(counts), adv, close)

    def _pipe_commit(self, pipe: _Pipeline, coin: bool, landed, close, info,
                     ids) -> None:
        """The round's entry into the pipeline: a flush on a coin round of
        a ``pipeline_coin_flush`` rule, else its landings, completion and
        (tau >= 1) float32 message rows."""
        if coin and self.rule.pipeline_coin_flush:
            pipe.flush_at(close)
        else:
            rows = None if pipe.tau == 0 else \
                info.messages.dense().to(torch.float32)
            pipe.push(landed, close, rows, ids)

    def _round_slab(self, st, m_down_c, m_up_c, window, draws, metric_fn,
                    pipe: Optional[_Pipeline] = None):
        """One round on the chunk slab: every quantity in (C,) space,
        bit-equal to the scatter round's (n,)-masked one (integer sums and
        a max over the same per-client float32 values).  ``pipe`` makes it
        asynchronous, as in :meth:`_round_scatter`: the cohort's clocks
        are read from and written to the pipeline's (n,) ones at the
        cohort's ids."""
        c, d = int(self.substrate.c), int(self.comp.spec.d)
        adv = deficit = None
        if pipe is not None:
            adv = pipe.rebase()
            deficit = pipe.deficit(self.n)
        new, info = self.method.step_full(st, None, draws=draws,
                                          window=window, deficit=deficit)
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
        metric = torch.as_tensor(metric_fn(new), device=dev)
        part = torch.full((), c, dtype=torch.int64, device=dev)
        if pipe is None:
            delay = self._delay(down_b, up_b, m_down_c, m_up_c)
            return new, coin, (metric, part, torch.sum(counts),
                               torch.max(delay))
        sel = window[1]
        land = self._arrivals(pipe.free.index_select(0, sel), down_b, up_b,
                              m_down_c, m_up_c)
        close = torch.max(land)                # C >= 1 clients answer
        pipe.free = pipe.free.index_copy(0, sel, land)
        landed = torch.full((self.n,), float("-inf"), dtype=torch.float32,
                            device=dev).index_copy_(0, sel, land)
        self._pipe_commit(pipe, coin, landed, close, info, sel)
        return new, coin, (metric, part, torch.sum(counts), adv, close)

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
    def _chunk_ys(rows, coins, bits,
                  names=_DEVICE_YS) -> Dict[str, np.ndarray]:
        """The chunk's per-round outputs on the host: the device scalars
        stacked into one (length, len(names)) float64 tensor (exact for
        float32 values and the integer counts) and moved in one
        transfer."""
        cols = [torch.stack([r[k] for r in rows]).to(torch.float64)
                for k in range(len(names))]
        host = torch.stack(cols, dim=1).cpu().numpy()
        ys = {name: host[:, k] for k, name in enumerate(names)}
        ys["coin"] = np.asarray(coins, bool)
        ys["bits"] = np.asarray(bits, np.float32)
        return ys

    def _chunk_scatter(self, state, length: int, md, mu, metric_fn, draws,
                       pipe: Optional[_Pipeline] = None):
        dev = state.x.device
        m_down = torch.as_tensor(md, device=dev)
        m_up = torch.as_tensor(mu, device=dev)
        ids = None
        if pipe is not None and pipe.tau >= 1:
            # the clients behind each round's message rows: the cohorts
            # under sampling (the draws each round makes), else all n
            if self.sampled:
                ids = torch.as_tensor(self.substrate.cohort_schedule(
                    state.seed, state.t, length, draws),
                    device=dev).to(torch.int64)
            else:
                ids = torch.arange(self.n, device=dev).expand(length, -1)
        rows, coins, bits = [], [], []
        for j in range(length):
            state, coin, vals = self._round_scatter(
                state, m_down[j], m_up[j], draws_at(draws, state.t),
                metric_fn, pipe, None if ids is None else ids[j])
            rows.append(vals)
            coins.append(coin)
            bits.append(state.bits_sent)
        return state, self._chunk_ys(rows, coins, bits,
                                     _DEVICE_YS if pipe is None
                                     else _ASYNC_YS)

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

    def _chunk_runner(self, h):
        """The chunk function of the active store; the slab store's gets
        the handle's timeline for its gather and writeback spans."""
        if self.slab:
            return functools.partial(self._chunk_slab, tl=h.timeline)
        return self._chunk_scatter

    # the slab store's gather and writeback (an instance attribute may
    # wrap the writeback to watch it)
    _slab_enter = staticmethod(slab_enter)
    _slab_exit = staticmethod(slab_exit)

    def _chunk_slab(self, state, length: int, md, mu, metric_fn, draws,
                    pipe: Optional[_Pipeline] = None, tl=None):
        dev = state.x.device
        sels, uniq, loc, md_c, mu_c = self._slab_chunk_xs(
            state, length, md, mu, draws)
        idx = torch.as_tensor(uniq, device=dev)
        sels_t = torch.as_tensor(sels, device=dev).to(torch.int64)
        loc_t = torch.as_tensor(loc, device=dev).to(torch.int64)
        m_down = torch.as_tensor(md_c, device=dev)
        m_up = torch.as_tensor(mu_c, device=dev)
        with host_span(tl, "slab_gather", rows=int(uniq.size)):
            st, full_h, full_g = self._slab_enter(state, idx)
        rows, coins, bits = [], [], []
        for j in range(length):
            st, coin, vals = self._round_slab(
                st, m_down[j], m_up[j], (sels[j], sels_t[j], loc_t[j]),
                draws_at(draws, st.t), metric_fn, pipe)
            rows.append(vals)
            coins.append(coin)
            bits.append(st.bits_sent)
        with host_span(tl, "slab_writeback", rows=int(uniq.size)):
            state = self._slab_exit(st, idx, full_h, full_g)
        return state, self._chunk_ys(rows, coins, bits,
                                     _DEVICE_YS if pipe is None
                                     else _ASYNC_YS)

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
        is never written.  With ``tau`` set the campaign is asynchronous
        (:meth:`_run_async`), and the resume arguments raise ValueError:
        the pipeline's ring is not part of a checkpoint.

        ``obs`` is an optional :class:`repro_torch.obs.Obs` handle.  The
        chunks bring per-round scalars to the host only, so a live
        timeline here gets HOST-track chunk and slab spans (wall time)
        plus kernel-build spans; the per-client simulated-time view is
        rebuilt after the run by
        :func:`repro_torch.obs.reconstruct_vec_timeline`.  A metrics
        registry gets the campaign aggregates the heap oracle emits."""
        metric_fn = self._metric_fn(metric_fn)
        if not (0 <= int(start_round) <= rounds):
            raise ValueError(f"start_round={start_round} outside "
                             f"[0, {rounds}]")
        with _obs_scope(obs) as h:
            if self.tau is not None and rounds > 0:
                check_resume(start_round, clock0, checkpoint)
                return self._run_async(state, rounds, metric_fn, draws, h)
            run = self._run_faulted if self.faults is not None \
                else self._run_barrier
            return run(state, rounds, metric_fn, start_round, clock0,
                       checkpoint, draws, h)

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

    def _run_barrier(self, state, rounds: int, metric_fn,
                     start_round: int = 0, clock0: float = 0.0,
                     checkpoint: Optional[Callable] = None,
                     draws: Optional[DrawsFn] = None, h=NULL) -> SimResult:
        rng = np.random.default_rng(self.seed)
        streams = campaign_streams(rng, rounds)
        if rounds <= 0 or start_round >= rounds:
            return SimResult(state=state, traces={}, events=None,
                             summary={"rounds": 0.0,
                                      "wall_clock_s": float(clock0)})
        if self.slab:
            # the campaign's own copy of the two stores, made once: every
            # chunk's slab is written back into it in place
            state = snapshot(state)
        parts = []
        now = float(clock0)
        run_chunk = self._chunk_runner(h)
        done = start_round
        while done < rounds:
            length = min(self.chunk, rounds - done)
            md, mu = self._chunk_multipliers(streams, done, length)
            t0 = time.perf_counter() if h else 0.0
            state, part = run_chunk(state, length, md, mu, metric_fn, draws)
            parts.append(part)
            if h:
                record_chunk(h, t0, done, length, "vec.chunk_s")
            done += length
            if checkpoint is not None:
                now = float(self._seq_wall(part["round_t"], now)[-1])
                checkpoint(snapshot(state) if self.slab else state,
                           done, now)
        ys = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

        n_run = rounds - start_round
        wall = self._seq_wall(ys["round_t"], clock0)
        bcast = np.concatenate([[clock0], wall[:-1]])
        traces, summary = self._bill_round_bytes(
            ys, n_run, wall, bcast, wall_clock_s=float(wall[-1]))
        _obs_fed_metrics(h, traces, summary)
        return SimResult(state=state, traces=traces, events=None,
                         summary=summary)

    def _run_async(self, state, rounds: int, metric_fn,
                   draws: Optional[DrawsFn] = None, h=NULL) -> SimResult:
        """The asynchronous campaign (DESIGN.md §14): the barrier's chunks
        with a :class:`_Pipeline` threaded through their rounds.  Absolute
        clocks are rebuilt on the host: the broadcasts are the float64
        cumsum of the per-round advances, and a round's completion lands
        ``land_rel`` after its broadcast.  At tau = 0 the advance is the
        previous round's completion exactly, so both clocks reproduce the
        barrier's float64 chain bit for bit."""
        n, d, tau = self.n, int(self.comp.spec.d), int(self.tau)
        streams = campaign_streams(np.random.default_rng(self.seed), rounds)
        if self.slab:
            state = snapshot(state)
        c = int(self.substrate.c) if self.sampled else n
        pipe = _Pipeline(tau, n, c, d, state.x.device)
        run_chunk = self._chunk_runner(h)
        parts = []
        done = 0
        while done < rounds:
            length = min(self.chunk, rounds - done)
            md, mu = self._chunk_multipliers(streams, done, length)
            t0 = time.perf_counter() if h else 0.0
            state, part = run_chunk(state, length, md, mu, metric_fn, draws,
                                    pipe)
            parts.append(part)
            if h:
                record_chunk(h, t0, done, length, "vec.chunk_s")
            done += length
        ys = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        bcast = np.cumsum(ys["bcast_rel"])
        wall = bcast + ys["land_rel"]
        traces, summary = self._bill_round_bytes(
            ys, rounds, wall, bcast, wall_clock_s=float(wall.max()))
        summary["tau"] = float(tau)
        _obs_fed_metrics(h, traces, summary)
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
        return self._traces_summary(ys, rounds, bytes_up, value_bytes,
                                    bytes_down, wall, bcast, wall_clock_s)

    @staticmethod
    def _traces_summary(ys, rounds: int, bytes_up, value_bytes, bytes_down,
                        wall: np.ndarray, bcast: np.ndarray,
                        wall_clock_s: float):
        """The traces and summary keys every campaign reports, from its
        per-round outputs and its int64 byte arrays."""
        coin = ys["coin"].astype(bool)
        part = ys["participants"].astype(np.int64)
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

    # ------------------------------------------------------------------
    # fault injection (DESIGN.md §18)
    # ------------------------------------------------------------------

    def _counts(self, rnd, mask, dev):
        """(n,) int32 shipped value counts of the round's plan, zero
        outside ``mask``."""
        if self.schema.static_count is None:
            counts = self._bound.round_wire_counts(rnd)
        else:
            counts = torch.full((self.n,), self.schema.static_count,
                                dtype=torch.int32, device=dev)
        return counts * mask

    def _round_graceful_faulted(self, st, m_down, m_up, f, dl, draws,
                                metric_fn):
        """One faulted round of a gracefully degrading rule: the round's
        masks from its participation (the plan the engine then draws) and
        the chunk's fault booleans, the engine's commit gated by them, and
        the byte and time scalars summed over the sender set; a
        short-handed round costs the static float32 deadline ``dl``."""
        dev = m_down.device
        rnd = RoundRandom(st.seed, st.t, draws)
        present = self._bound.round_present(rnd)
        senders, late, lost, drop = fault_masks(present, f)
        new, _info = self.method.step_full(
            st, None, draws=draws, faults=FaultStep(drop=drop,
                                                    reset=f.reset))
        delivered = senders & ~lost & ~late
        miss = present & ~delivered
        counts = self._counts(rnd, senders, dev)       # only senders ship
        up_b, down_b = self._link_bytes(self._comp_bytes(counts), senders)
        n_del, base = self._close(self._delay(down_b, up_b, m_down, m_up),
                                  delivered)
        if dl is not None:
            round_t = torch.where(torch.any(miss),
                                  torch.full_like(base, float(dl)), base)
        else:
            round_t = base
        waste = lost | late
        i64 = torch.int64
        return new, False, (
            torch.as_tensor(metric_fn(new), device=dev), n_del,
            torch.sum(counts), round_t, torch.sum(senders.to(i64)),
            torch.sum(miss.to(i64)), torch.sum(late.to(i64)),
            torch.sum(lost.to(i64)),
            torch.sum((present & f.crash_off).to(i64)),
            torch.sum(waste.to(i64)), torch.sum(counts * waste))

    def _round_sync_faulted(self, st, m_down, m_up, f, retry, dl, cumbk,
                            draws, metric_fn):
        """One faulted round of a ``sync_requires_all`` rule (MARINA /
        SYNC-MVR): the fault-free engine step (the server's backoff
        re-requests recover every missing upload, so the math is the
        fault-free campaign's), and the faults in bytes and wall clock:
        the round closes at the deadline, then each missing client's
        recovered upload lands after its backoff plus one nominal round
        trip, every attempt billed (downlink ``x`` per attempt, the uplink
        record per attempt that reaches a live client).  ``cumbk`` is the
        float32 cumulative backoff on the device."""
        d = int(self.comp.spec.d)
        dev = m_down.device
        fs, ua, capped = retry
        new, _, coin, active, counts, nb = self._step_active(st, draws,
                                                             dev)
        senders, late, lost, _ = fault_masks(active, f)
        delivered = senders & ~lost & ~late
        miss = ~delivered                              # all n must land
        f32 = np.float32
        up_b, down_b = self._link_bytes(nb, senders)
        _, base = self._close(self._delay(down_b, up_b, m_down, m_up),
                              delivered)
        any_miss = torch.any(miss)
        close = base if dl is None else torch.where(
            any_miss, torch.full_like(base, float(dl)), base)
        # recovered upload of client i: close + backoff(first success) +
        # one nominal round trip of its own record, in float32
        rt0 = f32(self.downlink.latency_s) \
            + f32(X_BYTES_PER_COORD * d) / f32(self.downlink.bandwidth_Bps) \
            + f32(self.compute_s) + f32(self.uplink.latency_s)
        rt = float(rt0) + nb / float(f32(self.uplink.bandwidth_Bps))
        land = torch.where(miss, close + cumbk[fs.to(torch.int64)] + rt,
                           torch.full_like(rt, float("-inf")))
        round_t = torch.where(any_miss, torch.maximum(close, torch.max(land)),
                              close)
        i64 = torch.int64
        mi = miss.to(i64)
        waste = lost | late
        return new, coin, (
            torch.as_tensor(metric_fn(new), device=dev),
            torch.sum(active.to(i64)), torch.sum(counts), round_t,
            torch.sum(senders.to(i64)), torch.sum(counts * senders),
            torch.sum(mi), torch.sum(late.to(i64)), torch.sum(lost.to(i64)),
            torch.sum(f.crash_off.to(i64)), torch.sum(fs * mi),
            torch.sum(ua * mi), torch.sum(counts * ua * mi),
            torch.sum((capped & miss).to(i64)), torch.sum(waste.to(i64)),
            torch.sum(counts * waste))

    def _chunk_faulted(self, state, length: int, md, mu, fc, sl, cap,
                       metric_fn, draws):
        """One faulted chunk: its fault booleans (and, for sync rules, the
        retry matrices) go to the device in one transfer each, the rounds
        run as a Python loop whose scalars stay on the device, and one
        transfer brings them back."""
        fm, dev = self.faults, state.x.device
        sync = self.rule.sync_requires_all
        cf = faults_to(chunk_faults(fc, sl, mu, cap, fm.rejoin == "reset"),
                       dev)
        m_down = torch.as_tensor(md, device=dev)
        m_up = torch.as_tensor(mu, device=dev)
        dl = fm.deadline_s(self.downlink, self.uplink, self.compute_s,
                           int(self.comp.spec.d))
        if sync:
            retry = torch.as_tensor(np.stack([
                fc.first_success[sl], fc.up_attempts[sl],
                fc.capped[sl].astype(np.int32)])).to(dev)
            cumbk = torch.as_tensor(fm.backoff_cumsum().astype(np.float32),
                                    device=dev)
        rows, coins, bits = [], [], []
        for j in range(length):
            dr = draws_at(draws, state.t)
            if sync:
                fs, ua, capped = retry[:, j]
                state, coin, vals = self._round_sync_faulted(
                    state, m_down[j], m_up[j], cf.at(j),
                    (fs, ua, capped.to(torch.bool)), dl, cumbk, dr,
                    metric_fn)
            else:
                state, coin, vals = self._round_graceful_faulted(
                    state, m_down[j], m_up[j], cf.at(j), dl, dr, metric_fn)
            rows.append(vals)
            coins.append(coin)
            bits.append(state.bits_sent)
        return state, self._chunk_ys(rows, coins, bits,
                                     _SYNC_YS if sync else _GRACEFUL_YS)

    def _run_faulted(self, state, rounds: int, metric_fn,
                     start_round: int = 0, clock0: float = 0.0,
                     checkpoint: Optional[Callable] = None,
                     draws: Optional[DrawsFn] = None, h=NULL) -> SimResult:
        """The faulted barrier campaign, vectorized: the fault realization
        is the heap oracle's own host-drawn
        :class:`repro_torch.fed.faults.FaultCampaign` (keyed by absolute
        round, so chunking and kill-and-restore cannot move it), handed to
        each chunk's rounds as device booleans."""
        fm = self.faults
        rng = np.random.default_rng(self.seed)
        streams = campaign_streams(rng, rounds)
        if rounds <= 0 or start_round >= rounds:
            return SimResult(state=state, traces={}, events=None,
                             summary={"rounds": 0.0,
                                      "wall_clock_s": float(clock0)})
        sync = self.rule.sync_requires_all
        fc = fm.draw_campaign(rounds, self.n, retries=sync)
        cap = fm.late_cap()
        parts = []
        now = float(clock0)
        done = start_round
        while done < rounds:
            length = min(self.chunk, rounds - done)
            md, mu = self._chunk_multipliers(streams, done, length)
            t0 = time.perf_counter() if h else 0.0
            state, part = self._chunk_faulted(
                state, length, md, mu, fc, slice(done, done + length), cap,
                metric_fn, draws)
            parts.append(part)
            if h:
                record_chunk(h, t0, done, length, "vec.chunk_s")
            done += length
            if checkpoint is not None:
                now = float(self._seq_wall(part["round_t"], now)[-1])
                checkpoint(state, done, now)
        ys = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

        n_run = rounds - start_round
        wall = self._seq_wall(ys["round_t"], clock0)
        bcast = np.concatenate([[clock0], wall[:-1]])
        traces, summary = self._bill_round_bytes_faulted(
            ys, fc, sync, n_run, start_round, wall, bcast,
            wall_clock_s=float(wall[-1]))
        _obs_fed_metrics(h, traces, summary)
        _obs_fault_metrics(h, traces)
        return SimResult(state=state, traces=traces, events=None,
                         summary=summary)

    def _bill_round_bytes_faulted(self, ys, fc, sync: bool, n_run: int,
                                  start_round: int, wall: np.ndarray,
                                  bcast: np.ndarray, wall_clock_s: float):
        """Faulted-campaign billing from the per-round outputs: the exact
        integer formulas the heap oracle realizes from its raw buffers
        (``len(buf_i) = header + bytes_per_value * count_i``, or the dense
        record on a coin round) summed over the sender set, plus the sync
        rules' retry re-payments.  Every operand is an int64 host array of
        per-round integer sums, so heap and vec byte traces are
        bit-exact."""
        n, d = self.n, int(self.comp.spec.d)
        x_bytes = X_BYTES_PER_COORD * d
        head, bpv = self.schema.header_bytes, self.schema.bytes_per_value
        dense_up = wire.HEADER_BYTES + 4 * d
        i64 = np.int64
        coin = ys["coin"].astype(bool)
        senders = ys["senders"].astype(i64)
        csum = ys["counts_sum"].astype(i64)
        csend = ys["counts_send"].astype(i64) if sync else csum
        wasted_n = ys["wasted_n"].astype(i64)
        wasted_c = ys["wasted_counts"].astype(i64)
        sl = slice(start_round, start_round + n_run)

        if sync:
            retries = ys["retries"].astype(i64)
            retry_up_n = ys["retry_up_n"].astype(i64)
            retry_c = ys["retry_counts"].astype(i64)
            capped = ys["capped"].astype(i64)
            sent = np.where(coin, dense_up * senders,
                            head * senders + bpv * csend)
            retry_up_b = np.where(coin, dense_up * retry_up_n,
                                  head * retry_up_n + bpv * retry_c)
            retry_down_b = retries * x_bytes
            value_bytes = np.where(coin, n * 4 * d, 4 * csum)
            wasted_b = np.where(coin, dense_up * wasted_n,
                                head * wasted_n + bpv * wasted_c)
        else:
            retries = capped = np.zeros(n_run, i64)
            retry_up_b = retry_down_b = np.zeros(n_run, i64)
            sent = head * senders + bpv * csend
            value_bytes = 4 * csend
            wasted_b = head * wasted_n + bpv * wasted_c
        bytes_up = sent + retry_up_b
        bytes_down = n * x_bytes + retry_down_b

        traces, summary = self._traces_summary(
            ys, n_run, bytes_up, value_bytes, bytes_down, wall, bcast,
            wall_clock_s)
        traces.update({
            "senders": senders.astype(np.float64),
            "dropped": ys["dropped"].astype(np.float64),
            "late": ys["late"].astype(np.float64),
            "lost": ys["lost"].astype(np.float64),
            "offline": ys["offline"].astype(np.float64),
            "rejoins": fc.rejoin[sl].sum(axis=1).astype(np.float64),
            "retries": retries.astype(np.float64),
            "retry_bytes_up": retry_up_b.astype(np.float64),
            "retry_bytes_down": retry_down_b.astype(np.float64),
            "wasted_bytes_up": wasted_b.astype(np.float64),
            "retry_capped": capped.astype(np.float64),
        })
        summary.update({
            "dropped_rounds": float((traces["dropped"] > 0).sum()),
            "retries": float(retries.sum()),
            "retry_capped": float(capped.sum()),
            "wasted_bytes_up": float(wasted_b.sum()),
        })
        return traces, summary

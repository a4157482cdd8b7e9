"""Layer 3 of the federated transport subsystem: the event-driven
client/server simulator (port of ``repro.fed.sim``, DESIGN.md §12), the
small-n oracle, and what both simulators share.

The method math is exactly the engine's: every round executes
``Method.step_full``, so the simulated run's iterates, randomness and
``bits_sent`` are those of the lockstep driver.  What the simulator adds
is time and bytes:

* each client's upload is encoded onto the byte-exact wire
  (:mod:`repro_torch.fed.wire`) and shipped through a
  :class:`~repro_torch.fed.net.LinkModel` (latency + bytes / bandwidth x
  straggler multiplier);
* the server applies client i's message the moment it lands, an ordered
  event log: DASHA's server state is the sum ``g^{t+1} = g^t + (1/n)
  sum_i m_i``, so arrival order never changes the math (the paper's "no
  client synchronization");
* a round completes when the server has everything it needs: the
  participating clients only for DASHA / PAGE / MVR (Appendix-D absentees
  send nothing and nobody waits for them); for rules with
  ``sync_requires_all`` (SYNC-MVR, MARINA) a sync-coin round is a barrier
  that all n clients' dense uploads must reach, so the slowest straggler
  gates it.

Participation is the engine's own randomness (the plan's Appendix-D
coins, or the sampled substrate's C-of-n cohort), so the bytes billed and
the math run agree about who was absent.  Straggler draws are common
random numbers drawn per campaign through
:func:`~repro_torch.fed.net.campaign_multipliers` (downlink, then uplink,
float64), the streams the vectorized simulator draws too.

Execution is chunked: a chunk's rounds run on the device and their
observables (messages, the plan's support, coins, participation, metric)
leave it in one transfer at the chunk's end; the byte-exact encoding and
the arrival heap replay them on the host.  MARINA's dense sync upload is
kept only for its coin rounds.

With ``faults=`` (a :class:`repro_torch.fed.faults.FaultModel`) the
campaign is faulted (DESIGN.md §18): seeded crashes with stale or reset
rejoins, lossy links, corruption (a byte really flipped, caught by the
wire checksum), a deadline and, for ``sync_requires_all`` rules, bounded
backoff retries; see :meth:`FedSim._run_faulted`.

With ``tau=`` the rounds are asynchronous and pipelined (DESIGN.md §14):
per-client clocks replace the round barrier, the server broadcasts round t
once the rounds older than t - tau have landed, and its step subtracts the
messages still in flight; see :meth:`FedSim._run_async`.

With ``obs=`` (a :class:`repro_torch.obs.Obs`, DESIGN.md §17) the host
loop records each round's per-client message lifetimes on a timeline
(:func:`repro_torch.obs.timeline.record_fed_round`), a faulted round's
marks, the slab store's gather and writeback as HOST spans, and the
campaign's counters, all from arrays the loop already holds on the host.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.rng import Draws, RoundRandom
from repro_torch.fed import faults as faultslib
from repro_torch.fed import wire
from repro_torch.fed.net import LinkModel, campaign_multipliers
from repro_torch.kernels import ops
from repro_torch.methods.accounting import downlink_receivers
from repro_torch.methods.engine import FaultStep, Hyper, Method
from repro_torch.methods.rules import get_rule
from repro_torch.methods.substrates import gather_slab_rows, slab_layout
from repro_torch.obs.handle import NULL, host_span, maybe as _obs_scope
from repro_torch.obs.timeline import SERVER, client_track, record_fed_round

X_BYTES_PER_COORD = 4                  # the server broadcast is dense fp32

DEFAULT_CHUNK = 128                    # rounds per chunk (memory knob)

DrawsFn = Callable[[int], Optional[Draws]]

#: extra per-round traces of faulted campaigns (DESIGN.md §18): both
#: simulators fill all of them (graceful rules keep the retry columns at
#: zero; sync rules keep ``dropped`` = the pre-retry missing set, every
#: member of which the retries then recover)
FAULT_TRACES = ("senders", "dropped", "late", "lost", "offline",
                "rejoins", "retries", "retry_bytes_up",
                "retry_bytes_down", "wasted_bytes_up", "retry_capped")


class FedEvent(NamedTuple):
    """One server-side event: ``m_i`` applied the moment it lands, a
    round's completion, or (asynchronous rounds) a broadcast."""

    time: float
    kind: str                          # "bcast" | "apply" | "round"
    client: int
    round: int
    nbytes: int


class SimResult(NamedTuple):
    state: Any                         # final MethodState
    traces: Dict[str, np.ndarray]      # driver-style named metric traces
    events: Optional[List[FedEvent]]   # the heap oracle's event log
    summary: Dict[str, float]


# ---------------------------------------------------------------------------
# observability (both simulators, DESIGN.md §17)
# ---------------------------------------------------------------------------

def _obs_fault_metrics(h, tr) -> None:
    """Flush a faulted campaign's event totals into the obs metrics
    registry (shared with :class:`repro_torch.fed.vecsim.VecFedSim`):
    counters ``fed.faults.offline`` / ``dropped`` / ``late`` / ``lost`` /
    ``rejoins`` / ``retries`` / ``retry_capped`` (client-round events) and
    ``fed.faults.retry_bytes_up`` / ``wasted_bytes_up``."""
    if h.metrics is None:
        return
    m = h.metrics
    for name in ("offline", "dropped", "late", "lost", "rejoins",
                 "retries", "retry_capped", "retry_bytes_up",
                 "wasted_bytes_up"):
        m.counter(f"fed.faults.{name}").inc(float(tr[name].sum()))


def _record_fault_marks(tl, *, t, bcast, completion, arrivals,
                        crash_start, rejoin, rejoin_mode, drop_down,
                        lost, late, miss=None, retries=None,
                        retry_capped=None) -> None:
    """One faulted round's timeline marks (heap oracle only: the vec
    engine's per-client view is reconstructed post hoc): ``crash`` /
    ``rejoin`` instants at the broadcast, ``drop_down`` at the broadcast
    (the client never heard it), ``drop_up`` at the would-have-landed
    arrival, ``deadline_cut`` at the round close, and, for sync rules, one
    SERVER ``retries`` span over the backoff window."""
    for i in np.flatnonzero(crash_start):
        tl.instant(client_track(i), "crash", bcast, round=t)
    for i in np.flatnonzero(rejoin):
        tl.instant(client_track(i), "rejoin", bcast, round=t,
                   mode=rejoin_mode)
    for i in np.flatnonzero(drop_down):
        tl.instant(client_track(i), "drop_down", bcast, round=t)
    for i in np.flatnonzero(lost):
        tl.instant(client_track(i), "drop_up", float(arrivals[i]),
                   round=t)
    for i in np.flatnonzero(late):
        tl.instant(client_track(i), "deadline_cut", completion, round=t)
    if retries is not None and miss is not None and miss.any():
        tl.span(SERVER, "retries", bcast, completion, round=t,
                clients=int(miss.sum()),
                attempts=int(retries[miss].sum()),
                capped=int(retry_capped[miss].sum()))


def _obs_fed_metrics(h, tr, summary) -> None:
    """Flush one finished campaign's aggregates into the obs metrics
    registry (no-op on a metrics-less handle).  Shared with
    :class:`repro_torch.fed.vecsim.VecFedSim` so both engines emit the
    same instrument names: ``fed.rounds`` / ``fed.bytes_up`` /
    ``fed.bytes_down`` / ``fed.sync_rounds`` counters, the
    ``fed.round_wall_s`` histogram (per-round barrier span, completion
    minus broadcast), and ``fed.sim_wall_clock_s`` /
    ``fed.mean_participants`` gauges."""
    if h.metrics is None:
        return
    m = h.metrics
    m.counter("fed.rounds").inc(summary["rounds"])
    m.counter("fed.bytes_up").inc(summary["bytes_up"])
    m.counter("fed.bytes_down").inc(summary["bytes_down"])
    m.counter("fed.sync_rounds").inc(summary["sync_rounds"])
    hist = m.histogram("fed.round_wall_s")
    for w in tr["sim_wall_clock"] - tr["bcast_clock"]:
        hist.observe(float(w))
    m.gauge("fed.sim_wall_clock_s").set(summary["wall_clock_s"])
    m.gauge("fed.mean_participants").set(summary["mean_participants"])


# ---------------------------------------------------------------------------
# the slab store's chunk plumbing (both simulators)
# ---------------------------------------------------------------------------

def slab_enter(state, idx: torch.Tensor):
    """Gather the chunk's touched rows into the slab.  Returns
    (slab_state, full_h, full_g): the (n, d) stores wait untouched until
    :func:`slab_exit`."""
    st = state._replace(h_local=gather_slab_rows(state.h_local, idx),
                        g_local=gather_slab_rows(state.g_local, idx))
    return st, state.h_local, state.g_local


def slab_exit(state, idx: torch.Tensor, full_h, full_g):
    """Per-chunk writeback: one O(U*d) in-place scatter into each store
    through the slab-writeback kernel."""
    return state._replace(
        h_local=ops.slab_writeback(full_h, idx, state.h_local),
        g_local=ops.slab_writeback(full_g, idx, state.g_local))


def snapshot(state):
    """A copy of the state's stores that the campaign will not write."""
    return state._replace(h_local=state.h_local.clone(),
                          g_local=state.g_local.clone())


def draws_at(draws: Optional[DrawsFn], t: int) -> Optional[Draws]:
    return None if draws is None else draws(t)


# ---------------------------------------------------------------------------
# fault masks (both simulators)
# ---------------------------------------------------------------------------

class ChunkFaults(NamedTuple):
    """One chunk's fault inputs, (length, n) booleans on the host or on
    the device: ``crash_off`` (crashed, or missed the broadcast),
    ``lostx`` (the upload is dropped or corrupted), ``slow`` (the uplink
    multiplier exceeds the deadline's cap) and ``reset`` (a reset rejoin;
    None under rejoin="stale")."""

    crash_off: Any
    lostx: Any
    slow: Any
    reset: Any = None

    def at(self, j: int) -> "ChunkFaults":
        return ChunkFaults(*(None if a is None else a[j] for a in self))


def chunk_faults(fc, sl: slice, mu32: np.ndarray, cap,
                 reset_mode: bool) -> ChunkFaults:
    """A chunk's fault inputs on the host from the campaign ``fc`` and the
    chunk's float32 uplink multipliers: the one float comparison
    ``mu32 > cap`` is made here, once, for both simulators."""
    slow = mu32 > cap if cap is not None else np.zeros(mu32.shape, bool)
    return ChunkFaults(crash_off=fc.crashed[sl] | fc.drop_down[sl],
                       lostx=fc.drop_up[sl] | fc.corrupt[sl], slow=slow,
                       reset=fc.rejoin[sl] if reset_mode else None)


def faults_to(cf: ChunkFaults, device) -> ChunkFaults:
    """A host :class:`ChunkFaults` on ``device``, in one transfer."""
    host = np.stack([a for a in cf if a is not None])
    return ChunkFaults(*torch.as_tensor(host).to(device).unbind(0))


def fault_masks(present, f: ChunkFaults):
    """One round's (senders, late, lost, drop) from its participation and
    fault inputs; numpy arrays or tensors alike (booleans only)."""
    senders = present & ~f.crash_off
    late = senders & f.slow
    lost = senders & f.lostx
    return senders, late, lost, f.crash_off | lost | late


def round_fault_step(bound, state, draws: Optional[Draws],
                     f: ChunkFaults) -> FaultStep:
    """The engine's :class:`FaultStep` for the round ``state`` is about to
    run: its participation is the plan that round draws (or is handed),
    read by the bound substrate's ``round_present``."""
    present = bound.round_present(RoundRandom(state.seed, state.t, draws))
    return FaultStep(drop=fault_masks(present, f)[3], reset=f.reset)


def check_faults(sim) -> None:
    """The scope of fault injection, shared by both simulators: round
    barriers on dense substrates."""
    if sim.faults is None:
        return
    if sim.tau is not None:
        raise ValueError(
            "faults= does not compose with asynchronous pipelined rounds "
            "(tau): the deadline and retry policies are defined against "
            "the round barrier")
    if sim.sampled:
        raise ValueError(
            "faults= does not compose with sampled-client substrates: "
            "cohort sampling already models absence")


def check_tau(sim) -> None:
    """The staleness bound of asynchronous rounds, shared by both
    simulators: None (round barriers) or an integer >= 0."""
    if sim.tau is not None and (int(sim.tau) != sim.tau or sim.tau < 0):
        raise ValueError(f"tau={sim.tau!r} must be None or an integer >= 0")


def check_resume(start_round: int, clock0: float, checkpoint) -> None:
    """Kill-and-restore is defined for round barriers only: an
    asynchronous campaign's in-flight ring is not part of a checkpoint."""
    if start_round or clock0 or checkpoint is not None:
        raise ValueError("checkpoint/resume is barrier-only (tau=None)")


def host_deficit(ring, bcast: float, n: int, d: int) -> np.ndarray:
    """The heap oracle's in-flight deficit at a broadcast at ``bcast``:
    the (1/n)-scaled float32 sum, on the host, of the messages of ring
    slots 1..tau whose client lands after it.  Each slot holds its
    clients' absolute landings (``arr``) and float32 message rows
    (``msgs``) in client order, or None when empty; the rows are summed
    slot by slot in that order, the reference's arithmetic."""
    deficit = np.zeros(d, np.float32)
    for e in list(ring)[1:]:
        if e["arr"] is None:
            continue
        in_flight = e["arr"] > bcast
        if in_flight.any():
            deficit += e["msgs"][in_flight].sum(0)
    return deficit / np.float32(n)


# ---------------------------------------------------------------------------
# the heap oracle
# ---------------------------------------------------------------------------

class _HostMessages(NamedTuple):
    """Host-side stand-in for the backend message containers: the codec
    reads only ``.values`` / ``.indices``."""

    values: np.ndarray
    indices: Optional[np.ndarray]


class _HostPlan(NamedTuple):
    """The part of a round's plan the codec reads: its support."""

    indices: Optional[np.ndarray]
    mask: Optional[np.ndarray]


def _expand_cohort(arr: np.ndarray, sel: np.ndarray, n: int) -> np.ndarray:
    """Scatter a (C, ...) cohort array onto (n, ...) rows (absent rows 0:
    they are never encoded)."""
    out = np.zeros((n,) + arr.shape[1:], arr.dtype)
    out[sel] = arr
    return out


def _to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """One device-to-host copy for a dict of tensors: each is viewed as
    bytes, the views are concatenated on the device and copied at once,
    and the host buffer is split back into typed arrays.  Wider elements
    go first, so every array starts aligned to its own width."""
    if not tensors:
        return {}
    items = sorted(tensors.items(), key=lambda kv: -kv[1].element_size())
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for _, t in items]
    host = torch.cat(flat).cpu().numpy()
    out, off = {}, 0
    for (name, t), f in zip(items, flat):
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        out[name] = host[off:off + f.numel()].view(dtype).reshape(
            tuple(t.shape))
        off += f.numel()
    return out


@dataclasses.dataclass
class FedSim:
    """Event-driven federated run of one variant x compressor x substrate.

    ``uplink`` / ``downlink`` are :class:`repro_torch.fed.net.LinkModel`;
    ``compute_s`` is the per-client local compute time a round.  Traces
    use the driver's named-metric convention, with ``bytes_up`` /
    ``bytes_down`` / ``sim_wall_clock`` next to ``bits_sent``.
    """

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
    #: clients, c < n); both are bit-identical
    store: str = "auto"
    #: fault injection (DESIGN.md §18): a :class:`repro_torch.fed.faults.
    #: FaultModel` realizes seeded client crashes (stale or reset rejoin),
    #: lossy links, corruption (really flipped bytes, caught by the wire
    #: checksum), a deadline and, for ``sync_requires_all`` rules,
    #: bounded-backoff retries.  None leaves every path untouched.  Round
    #: barriers (``tau=None``) and dense substrates only.
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
                "FedSim needs a substrate exposing estimator_update_full "
                f"(per-node wire messages), got "
                f"{type(self.substrate).__name__}")
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
        self.method: Method = Method.build(self.variant, self.comp,
                                           self.substrate, self.hyper)
        # the codec reads the plan only when the support is not already in
        # the message records (PermK slice headers, shared seeds, the
        # dense and fused backends' masks): skip moving it otherwise
        spec = self.comp.spec
        self._need_plan = not (spec.name == "randk"
                               and self.comp.mode == "independent"
                               and self.comp.backend == "sparse")
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
    # one chunk on the device
    # ------------------------------------------------------------------

    def _observe(self, rows: Dict[str, list], syncs: Dict[int, Any], j: int,
                 new, info, metric_fn) -> None:
        """Keep round j's observables, on the device, for the chunk's one
        transfer."""
        rows["metric"].append(torch.as_tensor(metric_fn(new)))
        rows["values"].append(info.messages.values)
        if getattr(info.messages, "indices", None) is not None:
            rows["indices"].append(info.messages.indices)
        if info.present is not None:
            rows["present"].append(info.present)
        if self._need_plan:
            for field in ("indices", "mask"):
                arr = getattr(info.plan, field)
                if arr is not None:
                    rows["plan_" + field].append(arr)
        if info.coin:
            syncs[j] = info.sync_dense
        rows["coin"].append(bool(info.coin))
        rows["bits"].append(new.bits_sent)

    def _run_chunk(self, state, length: int, metric_fn,
                   draws: Optional[DrawsFn],
                   faults: Optional[ChunkFaults] = None, deficit=None,
                   tl=None):
        """``length`` engine rounds on the active store; returns (state,
        the chunk's observables on the host).  The slab store gathers the
        rows the chunk's cohorts touch, runs the rounds on that slab and
        writes it back once; the cohort schedule (the substrate's
        ``cohort_schedule``) is the one each round would draw.
        ``faults`` (the chunk's fault inputs on the device; dense
        substrates only) gates each round's commit with the
        :class:`~repro_torch.methods.engine.FaultStep` that
        :func:`round_fault_step` builds from the round's participation.
        ``deficit`` (a one-round chunk of an asynchronous campaign) is the
        engine's in-flight correction of the round's server step.  A live
        timeline ``tl`` gets the slab gather and writeback as HOST
        spans."""
        rows: Dict[str, list] = {k: [] for k in (
            "metric", "values", "indices", "present", "plan_indices",
            "plan_mask", "coin", "bits")}
        syncs: Dict[int, Any] = {}
        sels = None
        if self.sampled:
            sels = self.substrate.cohort_schedule(state.seed, state.t,
                                                  length, draws)
        if self.slab:
            dev = state.x.device
            uniq, loc = slab_layout(sels, self.n)
            idx = torch.as_tensor(uniq, device=dev)
            sels_t = torch.as_tensor(sels, device=dev).to(torch.int64)
            loc_t = torch.as_tensor(loc, device=dev).to(torch.int64)
            with host_span(tl, "slab_gather", rows=int(uniq.size)):
                st, full_h, full_g = slab_enter(state, idx)
            for j in range(length):
                new, info = self.method.step_full(
                    st, None, draws=draws_at(draws, st.t),
                    window=(sels[j], sels_t[j], loc_t[j]), deficit=deficit)
                self._observe(rows, syncs, j, new, info, metric_fn)
                st = new
            with host_span(tl, "slab_writeback", rows=int(uniq.size)):
                state = slab_exit(st, idx, full_h, full_g)
        else:
            for j in range(length):
                dr = draws_at(draws, state.t)
                fs = None if faults is None else round_fault_step(
                    self._bound, state, dr, faults.at(j))
                new, info = self.method.step_full(state, None, draws=dr,
                                                  faults=fs, deficit=deficit)
                self._observe(rows, syncs, j, new, info, metric_fn)
                state = new
        dev_rows = {k: torch.stack(v) for k, v in rows.items()
                    if v and k not in ("coin", "bits")}
        if syncs:
            dev_rows["sync"] = torch.stack(list(syncs.values()))
        ys = _to_host(dev_rows)
        if syncs:
            ys["sync"] = dict(zip(syncs, ys["sync"]))
        ys["coin"] = np.asarray(rows["coin"], bool)
        ys["bits"] = np.asarray(rows["bits"], np.float32)
        if sels is not None:
            ys["sel"] = sels.astype(np.int64)
        return state, ys

    # ------------------------------------------------------------------
    # one round on the wire
    # ------------------------------------------------------------------

    def _expand_plan(self, plan: _HostPlan, sel: np.ndarray,
                     n: int) -> _HostPlan:
        """Re-key a cohort plan's per-row support by client id so
        :func:`~repro_torch.fed.wire.encode_round` (which walks client
        rows) reads the right support: shared supports broadcast (every
        row is the same), private ones scatter through the cohort."""
        shared = (self.comp.mode == "shared_coords"
                  and self.comp.spec.name != "permk")
        rep = {}
        for field in ("indices", "mask"):
            arr = getattr(plan, field)
            if arr is None:
                continue
            if shared:
                rep[field] = np.broadcast_to(arr[0], (n,) + arr.shape[1:])
            else:
                # PermK rows are per slot even under a shared permutation
                # seed: each cohort slot owns a different block
                rep[field] = _expand_cohort(arr, sel, n)
        return plan._replace(**rep)

    def _round_wire(self, ys, j: int, t: int, sender_mask=None):
        """Encode round ``t`` (chunk slot ``j``) onto the wire: returns
        (coin, active, RoundBytes, raw buffers, (values, indices)), the
        message rows re-keyed by client.  ``sender_mask`` (faulted
        graceful rounds) overrides the encoded set: only the clients that
        actually upload get a record."""
        n = self.n
        coin = bool(ys["coin"][j])
        if "present" in ys:
            present = ys["present"][j].astype(bool)
        else:
            present = np.ones(n, bool)
        if sender_mask is not None:
            active = np.asarray(sender_mask, bool)
        elif coin and self.rule.sync_requires_all:
            active = np.ones(n, bool)        # the barrier: all answer
        else:
            active = present
        vals = ys["values"][j]
        idxs = ys["indices"][j] if "indices" in ys else None
        plan = None
        if self._need_plan:
            plan = _HostPlan(
                ys["plan_indices"][j] if "plan_indices" in ys else None,
                ys["plan_mask"][j] if "plan_mask" in ys else None)
        slots = None
        if self.sampled:
            sel = ys["sel"][j]
            vals = _expand_cohort(vals, sel, n)
            if idxs is not None:
                idxs = _expand_cohort(idxs, sel, n)
            if plan is not None:
                plan = self._expand_plan(plan, sel, n)
            # slot-keyed headers: under sampling every record carries the
            # client's slot in this round's cohort (bounded by C, so
            # u16-safe at any n; the global id follows from the round's
            # replayable cohort draw)
            slots = np.full(n, -1, np.int64)
            slots[sel] = np.arange(sel.size)
        bufs = wire.encode_round(
            self.comp, plan, _HostMessages(vals, idxs), t, coin=coin,
            sync_values=ys["sync"][j] if coin else None,
            present=active, slots=slots)
        return coin, active, wire.round_bytes(bufs), bufs, (vals, idxs)

    def _dense_rows(self, vals, idxs) -> np.ndarray:
        """The dense float32 rows of one round's messages, one per row of
        ``vals`` (the asynchronous in-flight ledger): scatter-ADD for the
        sparse backend, mirroring ``SparseMessages.dense()``; PAD indices
        (>= d) drop."""
        d = int(self.comp.spec.d)
        if idxs is None:
            return np.asarray(vals, np.float32)
        out = np.zeros((len(vals), d), np.float32)
        keep = idxs < d
        rows = np.broadcast_to(np.arange(len(vals))[:, None], idxs.shape)
        np.add.at(out, (rows[keep], idxs[keep].astype(np.int64)),
                  np.asarray(vals, np.float32)[keep])
        return out

    # ------------------------------------------------------------------
    # the campaign
    # ------------------------------------------------------------------

    def run(self, state, rounds: int, *,
            metric_fn: Optional[Callable] = None,
            log_events: bool = False, max_events: int = 100_000,
            obs=None, start_round: int = 0, clock0: float = 0.0,
            checkpoint: Optional[Callable] = None,
            draws: Optional[DrawsFn] = None) -> SimResult:
        """Run campaign rounds ``start_round .. rounds - 1`` from
        ``state``.

        ``start_round`` / ``clock0`` resume a campaign mid-way: the
        per-round network streams are keyed by the absolute round, so a
        restored campaign replays the exact tail an uninterrupted one
        would, its wall clock starting at ``clock0``; traces cover the
        resumed segment only.  ``checkpoint(state, next_round,
        wall_clock)`` fires after every chunk with a state the campaign no
        longer writes.  ``draws(t)`` injects round t's randomness (plan,
        coins, samples, cohort) for the parity tests; None draws it.
        ``log_events`` keeps the server's event log (at most
        ``max_events``).  ``state`` is never written.  With ``tau`` set the
        campaign is asynchronous (:meth:`_run_async`), and the resume
        arguments raise ValueError.

        ``obs`` is an optional :class:`repro_torch.obs.Obs` handle: a live
        timeline gets every round's per-client message lifetimes (and a
        faulted round's marks), a metrics registry the campaign counters,
        both recorded by this host loop on arrays it already holds."""
        metric_fn = self._metric_fn(metric_fn)
        if not (0 <= int(start_round) <= rounds):
            raise ValueError(f"start_round={start_round} outside "
                             f"[0, {rounds}]")
        with _obs_scope(obs) as h:
            if self.tau is not None:
                check_resume(start_round, clock0, checkpoint)
                return self._run_async(state, rounds, metric_fn,
                                       log_events, max_events, draws, h)
            run = self._run_faulted if self.faults is not None \
                else self._run_barrier
            return run(state, rounds, metric_fn, log_events, max_events,
                       start_round, clock0, checkpoint, draws, h)

    def _run_barrier(self, state, rounds: int, metric_fn,
                     log_events: bool, max_events: int,
                     start_round: int = 0, clock0: float = 0.0,
                     checkpoint: Optional[Callable] = None,
                     draws: Optional[DrawsFn] = None, h=NULL) -> SimResult:
        rng = np.random.default_rng(self.seed)
        n = self.n
        d = int(self.comp.spec.d)
        x_bytes = X_BYTES_PER_COORD * d
        md_all, mu_all = campaign_multipliers(
            rng, rounds, self.downlink, self.uplink, n)
        # the dense broadcast reaches every client that computes this
        # round: the sampled cohort only (unsampled rows freeze), all n
        # otherwise (Appendix-D absentees still refresh h_i locally)
        recv = downlink_receivers(n, self.substrate.c if self.sampled
                                  else None)

        names = ("metric", "bits_sent", "bytes_up", "value_bytes",
                 "bytes_down", "sim_wall_clock", "bcast_clock",
                 "sync_round", "participants")
        n_run = rounds - start_round
        tr = {k: np.zeros(n_run) for k in names}
        events: List[FedEvent] = []
        now = float(clock0)
        bytes_up_total = 0
        sync_rounds = 0
        if self.slab and n_run > 0:
            # the campaign's own copy of the two stores, made once: every
            # chunk's slab is written back into it in place
            state = snapshot(state)

        done = start_round
        while done < rounds:
            length = min(self.chunk, rounds - done)
            state, ys = self._run_chunk(state, length, metric_fn, draws,
                                        tl=h.timeline)
            for j in range(length):
                t = done + j
                rel = t - start_round
                coin, active, rb, _bufs, _ = self._round_wire(ys, j, t)
                up_bytes = np.asarray(rb.per_node, np.float64)
                down_bytes = np.where(active, x_bytes, 0) \
                    .astype(np.float64)
                # common random numbers: every client holds a draw on both
                # links this round, participant or not
                t_down = self.downlink.transfer_s(down_bytes, md_all[t])
                t_up = self.uplink.transfer_s(up_bytes, mu_all[t])
                delay = t_down + self.compute_s + t_up
                tr["bcast_clock"][rel] = now
                heap = [(now + delay[i], int(i))
                        for i in np.flatnonzero(active)]
                heapq.heapify(heap)
                # drain arrivals in time order: the server applies m_i the
                # moment it lands; the last required arrival completes the
                # round
                completion = now + self.downlink.latency_s
                while heap:
                    at, i = heapq.heappop(heap)
                    completion = at
                    if log_events and len(events) < max_events:
                        events.append(FedEvent(at, "apply", i, t,
                                               rb.per_node[i]))
                if log_events and len(events) < max_events:
                    events.append(FedEvent(completion, "round", -1, t,
                                           rb.total_bytes))
                if h.timeline is not None:
                    record_fed_round(
                        h.timeline, round=t, bcast=now,
                        completion=completion, active=active,
                        arrivals=now + delay, t_down=t_down, t_up=t_up,
                        per_node_bytes=np.asarray(rb.per_node),
                        down_bytes=down_bytes, compute_s=self.compute_s,
                        coin=coin, server_down_bytes=recv * x_bytes,
                        cohort=ys["sel"][j] if self.sampled else None)
                now = completion

                bytes_up_total += rb.total_bytes
                sync_rounds += int(coin)
                tr["metric"][rel] = float(ys["metric"][j])
                tr["bits_sent"][rel] = float(ys["bits"][j])
                tr["bytes_up"][rel] = rb.total_bytes
                tr["value_bytes"][rel] = rb.value_bytes
                tr["bytes_down"][rel] = recv * x_bytes
                tr["sim_wall_clock"][rel] = now
                tr["sync_round"][rel] = float(coin)
                tr["participants"][rel] = float(active.sum())
            done += length
            if checkpoint is not None:
                checkpoint(snapshot(state) if self.slab else state, done,
                           now)

        summary = {
            "rounds": float(n_run),
            "wall_clock_s": float(now),
            "bytes_up": float(bytes_up_total),
            "bytes_down": float(tr["bytes_down"].sum()),
            "sync_rounds": float(sync_rounds),
            "mean_participants": float(tr["participants"].mean())
            if n_run else 0.0,
            "mean_bytes_up_per_round":
                float(bytes_up_total) / max(n_run, 1),
        }
        _obs_fed_metrics(h, tr, summary)
        return SimResult(state=state, traces=tr,
                         events=events if log_events else None,
                         summary=summary)

    # ------------------------------------------------------------------
    # the faulted campaign (DESIGN.md §18)
    # ------------------------------------------------------------------

    def _verify_round_buffers(self, bufs, t: int, senders: np.ndarray,
                              fc) -> None:
        """The heap oracle's wire-integrity drill: every upload that
        reaches the server is checksum-verified
        (:func:`repro_torch.fed.wire.verify`), and a corrupted one has a
        byte really flipped first
        (:func:`repro_torch.fed.faults.corrupt_bytes`), so the crc must
        catch exactly the corrupt set and pass the pristine one.  A miss
        either way is a simulator bug, not a fault: RuntimeError."""
        arrive = senders & ~fc.drop_up[t]
        for i in np.flatnonzero(arrive):
            buf = bufs[i]
            if buf is None:
                raise RuntimeError(f"round {t}: sender {i} produced no "
                                   "wire record")
            if fc.corrupt[t, i]:
                mangled = faultslib.corrupt_bytes(buf, t, int(i))
                try:
                    wire.verify(mangled)
                except wire.WireDecodeError:
                    continue               # caught: treated as dropped
                raise RuntimeError(
                    f"round {t}: corrupted record from client {i} passed "
                    "wire.verify: the checksum missed a real bit flip")
            wire.verify(buf)               # pristine must pass

    def _run_faulted(self, state, rounds: int, metric_fn,
                     log_events: bool, max_events: int,
                     start_round: int = 0, clock0: float = 0.0,
                     checkpoint: Optional[Callable] = None,
                     draws: Optional[DrawsFn] = None, h=NULL) -> SimResult:
        """The faulted barrier campaign.

        The fault realization is drawn on the host for the whole campaign
        (:meth:`repro_torch.fed.faults.FaultModel.draw_campaign`, keyed by
        absolute round, so chunking and kill/restore cannot move it) and
        split by rule family:

        * gracefully degrading rules (DASHA / PAGE / MVR): each round's
          drop mask (crashes, downlink losses, uplink losses, checksum-
          caught corruption, deadline-cut stragglers) gates the engine's
          commit (``Method.step_full(..., faults=FaultStep)``); the server
          proceeds with whatever was delivered.  Only actual senders are
          encoded and billed; a short-handed round costs the deadline.
        * ``sync_requires_all`` rules (MARINA / SYNC-MVR): the method's
          math never sees a fault.  The server re-requests every missing
          client with exponential backoff until its upload lands
          (re-paying the downlink ``x`` and the uplink record per
          attempt), so the state trace is the fault-free run's and the
          whole fault cost lands in bytes and wall clock.

        The masks are pure functions of pre-drawn booleans and of the one
        comparison ``m_up > deadline_mult`` (:func:`chunk_faults`), so
        :class:`repro_torch.fed.vecsim.VecFedSim` realizes the identical
        masks and the integer byte traces match bit for bit."""
        fm = self.faults
        rng = np.random.default_rng(self.seed)
        n = self.n
        d = int(self.comp.spec.d)
        x_bytes = X_BYTES_PER_COORD * d
        md_all, mu_all = campaign_multipliers(
            rng, rounds, self.downlink, self.uplink, n)
        sync = self.rule.sync_requires_all
        reset_mode = fm.rejoin == "reset"
        fc = fm.draw_campaign(rounds, n, retries=sync)
        cap = fm.late_cap()
        deadline = fm.deadline_s(self.downlink, self.uplink,
                                 self.compute_s, d)
        cumbk = fm.backoff_cumsum() if sync else None
        lat_d = self.downlink.latency_s

        names = ("metric", "bits_sent", "bytes_up", "value_bytes",
                 "bytes_down", "sim_wall_clock", "bcast_clock",
                 "sync_round", "participants") + FAULT_TRACES
        n_run = rounds - start_round
        tr = {k: np.zeros(n_run) for k in names}
        events: List[FedEvent] = []
        now = float(clock0)
        bytes_up_total = 0
        bytes_down_total = 0
        sync_rounds = 0

        done = start_round
        while done < rounds:
            length = min(self.chunk, rounds - done)
            sl = slice(done, done + length)
            cf = chunk_faults(fc, sl, mu_all[sl].astype(np.float32), cap,
                              reset_mode)
            if sync:
                # retries recover every message: the engine runs the
                # fault-free rounds, states equal to no faults
                state, ys = self._run_chunk(state, length, metric_fn, draws)
            else:
                state, ys = self._run_chunk(state, length, metric_fn, draws,
                                            faults_to(cf, state.x.device))
            for j in range(length):
                t = done + j
                rel = t - start_round
                if sync:
                    coin, active, rb, bufs, _ = self._round_wire(ys, j, t)
                    present_j = active          # all n answer
                    senders, late, lost, _ = fault_masks(active, cf.at(j))
                else:
                    present_j = ys["present"][j].astype(bool) \
                        if "present" in ys else np.ones(n, bool)
                    senders, late, lost, _ = fault_masks(present_j,
                                                         cf.at(j))
                    coin, active, rb, bufs, _ = self._round_wire(
                        ys, j, t, sender_mask=senders)
                delivered = senders & ~lost & ~late
                self._verify_round_buffers(bufs, t, senders, fc)

                up_bytes = np.asarray(rb.per_node, np.float64)
                down_bytes = np.where(senders, x_bytes, 0) \
                    .astype(np.float64)
                t_down = self.downlink.transfer_s(down_bytes, md_all[t])
                t_up = self.uplink.transfer_s(up_bytes, mu_all[t])
                delay = t_down + self.compute_s + t_up
                tr["bcast_clock"][rel] = now

                if sync:
                    miss = ~delivered           # all n must land
                else:
                    miss = present_j & ~delivered
                any_miss = bool(miss.any())

                # round close: the normal drain over what was delivered,
                # or the deadline when the server had to cut someone
                if delivered.any():
                    base = max(now + delay[i]
                               for i in np.flatnonzero(delivered))
                else:
                    base = now + lat_d
                if any_miss and deadline is not None:
                    close = now + float(deadline)
                else:
                    close = base

                retries_n = capped_n = 0
                retry_up_b = retry_down_b = 0
                if sync and any_miss:
                    # bounded-backoff re-requests: client i's recovered
                    # upload lands at close + backoff(first_success) + one
                    # nominal round trip of its own record
                    land = close
                    for i in np.flatnonzero(miss):
                        fs = int(fc.first_success[t, i])
                        ua = int(fc.up_attempts[t, i])
                        nb = len(bufs[i])
                        rt = self.downlink.latency_s \
                            + x_bytes / self.downlink.bandwidth_Bps \
                            + self.compute_s + self.uplink.latency_s \
                            + nb / self.uplink.bandwidth_Bps
                        land = max(land, close + cumbk[fs] + rt)
                        retries_n += fs
                        retry_up_b += ua * nb
                        retry_down_b += fs * x_bytes
                        capped_n += int(fc.capped[t, i])
                    completion = land
                else:
                    completion = close

                sent_b = int(up_bytes[senders].sum())
                wasted_b = int(up_bytes[lost | late].sum())
                round_up = sent_b + retry_up_b
                round_down = n * x_bytes + retry_down_b

                if log_events:
                    for i in np.flatnonzero(delivered):
                        if len(events) >= max_events:
                            break
                        events.append(FedEvent(float(now + delay[i]),
                                               "apply", int(i), t,
                                               rb.per_node[i]))
                    if len(events) < max_events:
                        events.append(FedEvent(completion, "round", -1,
                                               t, round_up))
                if h.timeline is not None:
                    record_fed_round(
                        h.timeline, round=t, bcast=now,
                        completion=completion, active=senders,
                        arrivals=now + delay, t_down=t_down, t_up=t_up,
                        per_node_bytes=np.asarray(rb.per_node),
                        down_bytes=down_bytes, compute_s=self.compute_s,
                        coin=coin, server_down_bytes=n * x_bytes)
                    _record_fault_marks(
                        h.timeline, t=t, bcast=now, completion=completion,
                        arrivals=now + delay,
                        crash_start=fc.crash_start[t], rejoin=fc.rejoin[t],
                        rejoin_mode=fm.rejoin, drop_down=fc.drop_down[t],
                        lost=lost, late=late,
                        miss=miss if sync else None,
                        retries=fc.first_success[t] if sync else None,
                        retry_capped=fc.capped[t] if sync else None)
                now = completion

                bytes_up_total += round_up
                bytes_down_total += round_down
                sync_rounds += int(coin)
                tr["metric"][rel] = float(ys["metric"][j])
                tr["bits_sent"][rel] = float(ys["bits"][j])
                tr["bytes_up"][rel] = round_up
                tr["value_bytes"][rel] = rb.value_bytes
                tr["bytes_down"][rel] = round_down
                tr["sim_wall_clock"][rel] = now
                tr["sync_round"][rel] = float(coin)
                tr["participants"][rel] = float(n if sync
                                                else delivered.sum())
                tr["senders"][rel] = float(senders.sum())
                tr["dropped"][rel] = float(miss.sum())
                tr["late"][rel] = float(late.sum())
                tr["lost"][rel] = float(lost.sum())
                tr["offline"][rel] = float((present_j
                                            & cf.crash_off[j]).sum())
                tr["rejoins"][rel] = float(fc.rejoin[t].sum())
                tr["retries"][rel] = float(retries_n)
                tr["retry_bytes_up"][rel] = float(retry_up_b)
                tr["retry_bytes_down"][rel] = float(retry_down_b)
                tr["wasted_bytes_up"][rel] = float(wasted_b)
                tr["retry_capped"][rel] = float(capped_n)
            done += length
            if checkpoint is not None:
                checkpoint(state, done, now)

        summary = {
            "rounds": float(n_run),
            "wall_clock_s": float(now),
            "bytes_up": float(bytes_up_total),
            "bytes_down": float(bytes_down_total),
            "sync_rounds": float(sync_rounds),
            "mean_participants": float(tr["participants"].mean())
            if n_run else 0.0,
            "mean_bytes_up_per_round":
                float(bytes_up_total) / max(n_run, 1),
            "dropped_rounds": float((tr["dropped"] > 0).sum()),
            "retries": float(tr["retries"].sum()),
            "retry_capped": float(tr["retry_capped"].sum()),
            "wasted_bytes_up": float(tr["wasted_bytes_up"].sum()),
        }
        _obs_fed_metrics(h, tr, summary)
        _obs_fault_metrics(h, tr)
        return SimResult(state=state, traces=tr,
                         events=events if log_events else None,
                         summary=summary)

    # ------------------------------------------------------------------
    # asynchronous pipelined rounds (DESIGN.md §14)
    # ------------------------------------------------------------------

    def _run_async(self, state, rounds: int, metric_fn, log_events: bool,
                   max_events: int, draws: Optional[DrawsFn] = None,
                   h=NULL) -> SimResult:
        """The asynchronous pipelined replay: per-client next-free clocks,
        messages in flight across rounds, and a staleness-bounded
        broadcast gate, in float64 absolute time on the host.

        Round t is broadcast at ``T = max(T, completion(t - 1 - tau),
        flush)`` and the server steps from ``g - deficit``, the deficit
        being the (1/n)-scaled sum of the messages still in flight at T
        (:func:`host_deficit`, numpy float32).  Client i starts round t
        at ``max(T + downlink_i, free_i)`` and lands at ``start + compute
        + uplink_i``; the server applies each message as it lands (g is a
        sum, so landings commute), and a slow client's round-t message
        may land after round t + k was broadcast.

        At tau = 0 nothing is ever in flight and no client is ever busy,
        so the engine runs the barrier's own chunks (states bit-identical)
        and the clock arithmetic repeats the barrier's float64 chain term
        for term.  At tau >= 1 every round is a one-round chunk with its
        deficit.  A coin round of a ``pipeline_coin_flush`` rule (MARINA,
        SYNC-MVR) discards every message in flight and makes the next
        broadcast wait for all n dense sync uploads."""
        tau = int(self.tau)
        n = self.n
        d = int(self.comp.spec.d)
        x_bytes = X_BYTES_PER_COORD * d
        md_all, mu_all = campaign_multipliers(
            np.random.default_rng(self.seed), rounds, self.downlink,
            self.uplink, n)
        recv = downlink_receivers(n, self.substrate.c if self.sampled
                                  else None)
        flush_rule = self.rule.pipeline_coin_flush
        lat_d = self.downlink.latency_s
        dev = state.x.device

        names = ("metric", "bits_sent", "bytes_up", "value_bytes",
                 "bytes_down", "sim_wall_clock", "bcast_clock",
                 "sync_round", "participants")
        tr = {k: np.zeros(rounds) for k in names}
        events: List[FedEvent] = []

        def empty():
            return {"floor": -np.inf, "arr": None, "msgs": None}

        T = 0.0                         # the latest broadcast
        free = np.zeros(n)              # per-client next-free clocks
        flush_T = -np.inf               # a pending sync flush's gate
        # the last tau + 1 rounds: slot 0 (round t - 1 - tau) gates the
        # broadcast, slots 1..tau may still be in flight; each keeps its
        # active clients' landings and message rows in client order
        ring = collections.deque([empty() for _ in range(tau + 1)],
                                 maxlen=tau + 1)
        if self.slab and rounds > 0:
            state = snapshot(state)
        buf = None
        buf_off = buf_len = 0
        bytes_up_total = 0
        sync_rounds = 0

        for t in range(rounds):
            T_new = max(T, ring[0]["floor"], flush_T)
            if tau == 0:
                # nothing can be in flight: the barrier's own chunks
                if buf_off == buf_len:
                    buf_len = min(self.chunk, rounds - t)
                    state, buf = self._run_chunk(state, buf_len, metric_fn,
                                                 draws, tl=h.timeline)
                    buf_off = 0
                ys, j = buf, buf_off
                buf_off += 1
            else:
                deficit = host_deficit(ring, T_new, n, d)
                state, ys = self._run_chunk(
                    state, 1, metric_fn, draws,
                    deficit=torch.as_tensor(deficit, device=dev),
                    tl=h.timeline)
                j = 0

            coin, active, rb, _bufs, (vals, idxs) = self._round_wire(ys, j,
                                                                     t)
            up_bytes = np.asarray(rb.per_node, np.float64)
            down_bytes = np.where(active, x_bytes, 0).astype(np.float64)
            t_down = self.downlink.transfer_s(down_bytes, md_all[t])
            t_up = self.uplink.transfer_s(up_bytes, mu_all[t])
            # a client starts once the broadcast reaches it and its last
            # upload is done; the not-busy branch is the barrier's float64
            # chain (tau = 0 parity)
            busy = free > T_new + t_down
            arr = np.where(busy, (free + self.compute_s) + t_up,
                           T_new + (t_down + self.compute_s + t_up))
            floor_t = float(arr[active].max()) if active.any() \
                else T_new + lat_d
            free = np.where(active, arr, free)

            if log_events:
                if len(events) < max_events:
                    events.append(FedEvent(T_new, "bcast", -1, t,
                                           recv * x_bytes))
                act_idx = np.flatnonzero(active)
                for i in act_idx[np.argsort(arr[act_idx], kind="stable")]:
                    if len(events) >= max_events:
                        break
                    events.append(FedEvent(float(arr[i]), "apply", int(i),
                                           t, rb.per_node[i]))
                if len(events) < max_events:
                    events.append(FedEvent(floor_t, "round", -1, t,
                                           rb.total_bytes))
            if h.timeline is not None:
                # async rounds interleave in wall time; the per-track
                # round ids still advance monotonically, which is the
                # invariant Timeline.validate() checks
                record_fed_round(
                    h.timeline, round=t, bcast=T_new, completion=floor_t,
                    active=active, arrivals=arr, t_down=t_down, t_up=t_up,
                    per_node_bytes=np.asarray(rb.per_node),
                    down_bytes=down_bytes, compute_s=self.compute_s,
                    coin=coin, server_down_bytes=recv * x_bytes,
                    cohort=ys["sel"][j] if self.sampled else None)

            ring.popleft()
            if coin and flush_rule:
                # the sync reset g <- mean(h_sync) discards every message
                # in flight; the next broadcast waits for this round
                flush_T = max(flush_T, floor_t)
                for e in ring:
                    e.update(empty())
                ring.append(empty())
            else:
                ring.append({
                    "floor": floor_t, "arr": arr[active],
                    "msgs": self._dense_rows(
                        vals[active], None if idxs is None
                        else idxs[active]) if tau >= 1 else None})
            T = T_new

            bytes_up_total += rb.total_bytes
            sync_rounds += int(coin)
            tr["metric"][t] = float(ys["metric"][j])
            tr["bits_sent"][t] = float(ys["bits"][j])
            tr["bytes_up"][t] = rb.total_bytes
            tr["value_bytes"][t] = rb.value_bytes
            tr["bytes_down"][t] = recv * x_bytes
            tr["sim_wall_clock"][t] = floor_t
            tr["bcast_clock"][t] = T_new
            tr["sync_round"][t] = float(coin)
            tr["participants"][t] = float(active.sum())

        summary = {
            "rounds": float(rounds),
            "wall_clock_s": float(tr["sim_wall_clock"].max())
            if rounds else 0.0,
            "bytes_up": float(bytes_up_total),
            "bytes_down": float(tr["bytes_down"].sum()),
            "sync_rounds": float(sync_rounds),
            "mean_participants": float(tr["participants"].mean())
            if rounds else 0.0,
            "mean_bytes_up_per_round":
                float(bytes_up_total) / max(rounds, 1),
            "tau": float(tau),
        }
        _obs_fed_metrics(h, tr, summary)
        return SimResult(state=state, traces=tr,
                         events=events if log_events else None,
                         summary=summary)


def simulate(variant: str, comp, substrate, hyper: Hyper, x0,
             init_seed: int, *, rounds: int,
             uplink: Optional[LinkModel] = None,
             downlink: Optional[LinkModel] = None, compute_s: float = 0.01,
             seed: int = 0, init_kw: Optional[dict] = None,
             metric_fn=None, log_events: bool = False,
             engine: str = "heap", tau: Optional[int] = None,
             store: str = "auto", obs=None,
             faults: Optional[faultslib.FaultModel] = None) -> SimResult:
    """One-shot convenience: build the simulator, init the method from
    ``x0`` and ``init_seed`` (the port's counterpart of the reference's
    init key), run it.

    ``engine="heap"`` (default) is this module's event-driven oracle;
    ``engine="vec"`` runs :class:`repro_torch.fed.vecsim.VecFedSim`: the
    same bytes and network draws, billed analytically.  ``seed`` seeds the
    network.  ``store`` picks the client-state store on sampled
    substrates; ``faults`` injects a seeded
    :class:`repro_torch.fed.faults.FaultModel` (crashes, lossy links,
    corruption, deadlines and retries); ``tau`` runs asynchronous
    pipelined rounds of that staleness bound; ``obs`` (a
    :class:`repro_torch.obs.Obs`) records the campaign.
    ``init_kw`` goes to ``Method.init`` (``device=`` among them)."""
    if engine == "vec":
        from repro_torch.fed.vecsim import VecFedSim
        cls = VecFedSim
    elif engine == "heap":
        cls = FedSim
    else:
        raise ValueError(f"unknown sim engine {engine!r}")
    sim = cls(variant=variant, comp=comp, substrate=substrate,
              hyper=hyper, uplink=uplink or LinkModel(),
              downlink=downlink or LinkModel(), compute_s=compute_s,
              seed=seed, tau=tau, store=store, faults=faults)
    state = sim.init(x0, init_seed, **(init_kw or {}))
    kw = {} if engine == "vec" else {"log_events": log_events}
    return sim.run(state, rounds, metric_fn=metric_fn, obs=obs, **kw)

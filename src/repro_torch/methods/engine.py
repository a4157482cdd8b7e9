"""The one method skeleton (port of ``repro.methods.engine``):
``Method.build(variant, compressor, substrate, hyper) -> (init, step, run,
step_full)``.

Algorithm 1 (and Algorithm 2's sync round, and MARINA's) written once:

    x^{t+1}  = server_update(x^t, g^t)                      # line 4
    h^{t+1}  = rule.h_update(...)                           # line 8  (varies)
    m, g_i   = substrate.estimator_update_full(...)         # lines 9-10
    g^{t+1}  = g^t + (1/n) sum_i m_i                        # line 14
    [coin]   with prob p: dense sync round                  # Alg. 2 / MARINA

Randomness is stateless: round t draws from generators seeded by
``(state.seed, state.t, tag)`` (:mod:`repro_torch.core.rng`), or takes the
arrays passed as ``draws=``.  ``t`` and ``bits_sent`` live on the host, so
a round never waits for the device.

A :class:`Hyper` whose ``gamma``, ``a``, ``b`` or ``p`` holds G per-lane
values (:class:`repro_torch.methods.lanes.Lanes`, or a 1-D array) builds a
method of G lanes on the substrate's lane view, flat, sampled or tree (a
sweep; see :class:`repro_torch.methods.driver.Sweeper`).  A per-lane ``p``
compares the round's one coin uniform with each lane's p, so lane j gets
the coin its sequential run draws; a round whose coins differ by lane
computes both branches and selects per lane.  It only steps: its state is
a one-lane method's ``init`` that the Sweeper broadcasts, so its device
fields carry a leading (G,) axis and ``bits_sent`` is a (G,) float32 array.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.compress.spec import momentum_a
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.rng import Draws, RoundRandom
from repro_torch.core.theory import ProblemConstants
from repro_torch.methods import accounting
from repro_torch.methods.lanes import Lanes, host_value
from repro_torch.methods.rules import VariantRule, get_rule, select_lanes

#: Hyper fields that may not vary by lane, and why (the reference's vmapped
#: sweep cannot take them either: a traced shape)
_LANE_FIXED = {
    "batch": "it sets the samples' shape",
    "batch_sync": "it sets the sync megabatch's shape",
}


def _lane_hyper(hp: "Hyper"):
    """``hp`` with its per-lane fields as :class:`Lanes`, and the lane
    count G (None when no field varies by lane).  Raises ValueError, naming
    the field, for a field that cannot vary by lane."""
    lanes = {}
    for f in dataclasses.fields(hp):
        v = getattr(hp, f.name)
        if isinstance(v, Lanes) or (
                isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim == 1):
            lanes[f.name] = v if isinstance(v, Lanes) else Lanes(v)
    if not lanes:
        return hp, None
    for name, why in _LANE_FIXED.items():
        if name in lanes:
            raise ValueError(f"Hyper.{name} cannot vary by lane: {why}")
    counts = {len(v) for v in lanes.values()}
    if len(counts) != 1:
        raise ValueError(f"per-lane Hyper fields of different lengths: "
                         f"{ {k: len(v) for k, v in lanes.items()} }")
    return dataclasses.replace(hp, **lanes), counts.pop()


def _sweep_only(*args, **kwargs):
    raise ValueError("a method of G lanes has no init or run of its own: "
                     "sweep it (repro_torch.methods.sweep broadcasts the "
                     "one-lane method's init state to the lanes)")


class StepInfo(NamedTuple):
    """Per-round internals exposed by ``Method.step_full``:

    * ``messages``  — the per-node compressed messages (backend format);
    * ``coin``      — the sync-round coin (None for no-sync variants; a
      (G,) bool array for a per-lane ``p``);
    * ``sync_dense``— the dense per-node sync upload (None unless this was
      a sync round);
    * ``present``   — (n,) Appendix-D participation (None when
      p_participate == 1);
    * ``payload``   — the compressed branch's payload coords per node;
    * ``plan``      — the compression plan the round used (injected or
      drawn; a sampled round's is the cohort's, before the n/C scale), or
      None when the substrate draws no round plan (the tree path).  The
      wire codec reads a message's support from it.
    """

    messages: Any = None
    coin: Optional[bool] = None
    sync_dense: Any = None
    present: Optional[torch.Tensor] = None
    payload: float = 0.0
    plan: Any = None


class FaultStep(NamedTuple):
    """Per-round fault gating for ``Method.step_full`` (DESIGN.md §18),
    realized on the host by :mod:`repro_torch.fed.faults` and handed in as
    (n,) boolean tensors on the state's device.

    * ``drop``  — client i's round is discarded end to end: its message
      never reaches the server (``g`` loses the ``m_i / n`` term) and the
      client keeps its pre-round ``(h_i, g_i)``.  Crashes, lost or
      corrupted uploads, missed broadcasts and deadline cuts all land
      here.  The gating runs after the estimator, so the round's math and
      its randomness are the fault-free round's; only the commit is
      masked.
    * ``reset`` — client i rebooted with blank state this round
      (rejoin="reset"): its ``(h_i, g_i)`` are zeroed before the
      h-update, and the server subtracts the forgotten ``g_i / n`` (a
      reliable out-of-band reset notice), so ``g = mean_i(g_local_i)``
      survives.  None means rejoin="stale": the outage freezes state.

    ``bits_sent`` still counts dropped uploads: the client did transmit;
    the wire lost it.  Only gracefully degrading rules accept faults:
    ``sync_requires_all`` rules recover every message through the
    simulators' billed retries, so their math never sees a fault.
    """

    drop: torch.Tensor
    reset: Optional[torch.Tensor] = None


class MethodState(NamedTuple):
    """Unified method state.  The substrate decides what the device fields
    hold: (n, d) tensors and a (d,) iterate, or node-axis trees and a
    parameter tree.  The round seed, round index and payload count live on
    the host."""

    x: Any                    # server iterate
    g: Any                    # server gradient estimator
    g_local: Any              # per-node g_i
    h_local: Any              # per-node h_i
    opt_state: Any            # server optimizer state (() for plain SGD)
    seed: int                 # root of every round's generators
    t: int                    # global round index
    bits_sent: np.float32     # cumulative coords sent per node ((G,) lanes)


@dataclasses.dataclass(frozen=True)
class Hyper:
    """Method hyperparameters, shared by every variant."""

    gamma: float                    # stepsize
    a: float                        # compressor momentum, 1/(2 omega + 1)
    variant: str = "dasha"          # dasha | page | mvr | sync_mvr | marina
    b: float = 1.0                  # MVR momentum
    p: float = 1.0                  # PAGE / SYNC-MVR / MARINA coin prob
    batch: int = 1                  # B   (0 = exact full-gradient oracle)
    batch_sync: int = 1             # B'  (sync-round megabatch)

    @classmethod
    def from_theory(cls, variant: str, omega: float, n: int, *, L: float,
                    L_hat: Optional[float] = None,
                    L_max: Optional[float] = None,
                    L_sigma: Optional[float] = None,
                    B: int = 1, m: int = 1, eps: float = 0.01,
                    sigma2: float = 0.0, zeta: float = 1.0, d: int = 1,
                    batch_sync: int = 1, gamma_mult: float = 1.0) -> "Hyper":
        """The Section-6 constants for ``variant``: gamma from the matching
        theorem, a = 1/(2 omega + 1), and the derived p / b / B.
        ``gamma_mult`` is the paper's powers-of-two stepsize fine-tune."""
        rule = get_rule(variant)
        if rule.theory_gamma is None:
            raise ValueError(f"variant {rule.name!r} has no theory_gamma")
        consts = ProblemConstants(
            eps=eps, n=n, omega=omega, L=L, L_hat=L_hat or L,
            L_max=L_max or L, L_sigma=L_sigma or L, m=m, B=B,
            sigma2=sigma2, d=d, zeta=zeta)
        gamma, extras = rule.theory_gamma(consts)
        return cls(gamma=gamma_mult * gamma, a=momentum_a(omega),
                   variant=rule.name, batch_sync=batch_sync, **extras)


class Method(NamedTuple):
    """``init(x0, seed, ...) -> MethodState``; ``step(state, data=None) ->
    MethodState``; ``run(state, num_rounds, ...)`` drives the chunked
    driver; ``step_full(state, data=None, *, draws=None) -> (MethodState,
    StepInfo)`` is ``step`` plus the round's internals."""

    init: Callable[..., MethodState]
    step: Callable[..., MethodState]
    run: Callable[..., Any]
    step_full: Callable[..., Any]

    @classmethod
    def build(cls, variant, compressor, substrate, hyper: Hyper) -> "Method":
        """One entrypoint for every variant x substrate x compressor."""
        rule: VariantRule = get_rule(variant)
        sub = substrate.with_compressor(compressor)
        hp, lanes = _lane_hyper(hyper)
        if lanes is not None:
            sub = sub.with_lanes(lanes)
        a_eff = rule.force_a if rule.force_a is not None else hp.a
        # the sampled-client substrate (DESIGN.md §13) windows each round
        # onto a cohort; a C-of-n cohort can never answer an all-client
        # dense synchronization round, so barrier rules are rejected
        samples = bool(getattr(sub, "samples_clients", False))
        if samples and not rule.supports_client_sampling:
            raise ValueError(
                f"variant {rule.name!r} has a client-synchronization "
                "barrier (sync_requires_all): it cannot run on a sampled-"
                "client substrate; every client must answer sync rounds")

        def init(x0, seed: int, *, device=DEFAULT_DEVICE,
                 init_mode: str = "exact", batch_init: int = 1,
                 grads0=None, data=None) -> MethodState:
            """Cor. 6.2/6.5: g_i^0 = h_i^0 = grad f_i(x^0); Cor. 6.8/6.10:
            a size-B_init minibatch; zeros also allowed (PL setting)."""
            dev = resolve_device(device)
            x0 = sub.place(x0, dev)
            rnd = RoundRandom(seed, -1)
            if rule.init_h is not None:
                h0 = rule.init_h(sub, rnd, hp, x0, data)
                bits0 = sub.dense_coords(h0)
            elif grads0 is not None:
                h0 = sub.place_per_node(grads0, dev)
                bits0 = sub.dense_coords(h0)
            elif init_mode == "zeros" or \
                    getattr(sub, "problem", True) is None:
                h0 = sub.zeros_per_node(x0)
                bits0 = 0.0
            elif init_mode == "exact":
                h0 = sub.grad(rnd, x0, data, batch_init)
                bits0 = sub.dense_coords(h0)
            elif init_mode == "stoch":
                h0 = sub.grad_minibatch(rnd, x0, batch_init, data)
                bits0 = sub.dense_coords(h0)
            else:
                raise ValueError(init_mode)
            return MethodState(x=x0, g=sub.mean_nodes(h0), g_local=h0,
                               h_local=h0, opt_state=sub.init_opt(x0),
                               seed=int(seed), t=0,
                               bits_sent=np.float32(bits0))

        def step_full(state: MethodState, data=None, *,
                      draws: Optional[Draws] = None, deficit=None,
                      window=None, faults=None
                      ) -> Tuple[MethodState, StepInfo]:
            """One round, returning the round's internals too.  ``draws``
            injects the round's randomness (plan, coins, samples, cohort);
            fields left None are drawn from the round's own generators.
            A state handed in is never written.

            ``window`` is the slab-store hook (DESIGN.md §16): a
            ``(clients, sel, loc)`` triple of (C,) index vectors replacing
            the round's own cohort draw.  ``clients`` must hold the global
            ids the round would draw, on the host (the campaign driver
            takes them from the substrate's ``cohort_schedule``), ``sel``
            the same ids on the device (int64), and ``loc`` their rows
            (int64) inside the chunk slab that ``state.h_local`` / ``state.g_local`` then hold in
            place of the (n, d) store.  The cohort rows are written back
            into that slab in place: it belongs to the caller's chunk.

            ``faults`` is the fault-injection hook (DESIGN.md §18): a
            :class:`FaultStep` of (n,) masks.  Reset rows are zeroed
            before the h-update (with the matching server correction);
            drop rows are reverted after the estimator, so the round's
            math up to the commit is untouched and ``faults=None`` is the
            fault-free round.  The reverted rows are taken from the
            pre-round tensors with ``torch.where``: the state handed in
            is still never written.

            ``deficit`` is the asynchronous-rounds hook (DESIGN.md §14):
            the (1/n)-scaled sum of the compressed messages that ``state.g``
            already counts but the server has not yet received.  The server
            step then uses ``g - deficit`` (the substrate's
            ``sub_deficit``), which is what an asynchronous server holds,
            since g is a sum and every landing adds its term back.  Clients
            are unaffected: their recursions depend only on the broadcast
            iterates.  ``deficit=None`` is the synchronous round."""
            if faults is not None:
                if rule.sync_requires_all:
                    raise ValueError(
                        f"variant {rule.name!r} synchronizes all clients "
                        "(sync_requires_all): the simulator recovers its "
                        "missing messages by retries, so its math never "
                        "sees a fault; faults= is for gracefully "
                        "degrading rules")
                if samples or window is not None:
                    raise ValueError(
                        "faults= is not supported on sampled-client "
                        "substrates (cohort sampling already models "
                        "absence; composing both is future work)")
            rnd = RoundRandom(state.seed, state.t, draws)
            # line 4 (server) + broadcast
            g_vis = state.g if deficit is None \
                else sub.sub_deficit(state.g, deficit)
            x_new, opt_state = sub.server_update(state.x, g_vis,
                                                 state.opt_state, hp)
            # a sampled-client substrate windows the round onto its (C, d)
            # cohort slice: the h-update and estimator run at O(C*d), then
            # scatter back; at C == n round_view returns the substrate
            # itself and the round takes the unsliced path
            if window is not None:
                if not samples:
                    raise ValueError("window= requires a sampled-client "
                                     "substrate (samples_clients)")
                rsub = sub.window_view(*window)
            elif samples:
                rsub = sub.round_view(rnd)
            else:
                rsub = sub
            if rsub is sub:
                h_prev, g_prev = state.h_local, state.g_local
            else:
                h_prev = rsub.gather_nodes(state.h_local)
                g_prev = rsub.gather_nodes(state.g_local)
            reset_corr = None
            if faults is not None and faults.reset is not None:
                # rejoin="reset": the client reboots blank before this
                # round's h-update, and the server forgets its g_i/n term
                rmask = faults.reset[:, None]
                zeros = torch.zeros_like(g_prev)
                reset_corr = sub.mean_nodes(torch.where(rmask, g_prev,
                                                        zeros))
                h_prev = torch.where(rmask, zeros, h_prev)
                g_prev = torch.where(rmask, zeros, g_prev)
            # line 8: THE variant-specific line
            h_new, aux = rule.h_update(rsub, rnd, hp, x_new, state.x,
                                       h_prev, data)
            # lines 9-10: m_i = C_i(drift); g_i <- g_i + m_i
            agg, h_out, g_local, payload, msgs, present = \
                rsub.estimator_update_full(rnd, h_new, h_prev, g_prev,
                                           a_eff, aux)
            if rsub is not sub:
                # unsampled rows freeze: offline clients compute nothing
                h_out = rsub.scatter_nodes(state.h_local, h_out)
                g_local = rsub.scatter_nodes(state.g_local, g_local)
            g = sub.add_server(state.g, agg)                   # line 14
            if faults is not None:
                # drop = discard the round: the server never receives m_i
                # (un-add its mean term) and client i reverts to its
                # pre-round, post-reset (h_i, g_i)
                dmask = faults.drop[:, None]
                dense = msgs.dense()
                g = g - sub.mean_nodes(torch.where(
                    dmask, dense, torch.zeros_like(dense)))
                h_out = torch.where(dmask, h_prev, h_out)
                g_local = torch.where(dmask, g_prev, g_local)
                if reset_corr is not None:
                    g = g - reset_corr
            coin = h_sync = None
            if rule.has_sync:
                # Alg. 2 lines 9-11 / MARINA: with prob p ALL nodes upload
                # a fresh dense megabatch gradient instead
                coin = rnd.coin(host_value(hp.p), "sync")
                if isinstance(coin, np.ndarray):
                    # per-lane coins: the sync branch where any is up,
                    # selected lane by lane
                    if coin.any():
                        h_sync = rule.sync_update(sub, rnd, hp, x_new, data)
                        h_out = select_lanes(coin, h_sync, h_out)
                        g_local = select_lanes(coin, h_sync, g_local)
                        g = select_lanes(coin, sub.mean_nodes(h_sync), g)
                elif coin:
                    h_sync = rule.sync_update(sub, rnd, hp, x_new, data)
                    h_out = g_local = h_sync
                    g = sub.mean_nodes(h_sync)
            round_pay = accounting.round_payload(
                payload, sub.dense_coords(h_out), coin)
            new = MethodState(x=x_new, g=g, g_local=g_local,
                              h_local=h_out, opt_state=opt_state,
                              seed=state.seed, t=state.t + 1,
                              bits_sent=np.asarray(state.bits_sent,
                                                   np.float32)
                              + np.float32(round_pay))
            return new, StepInfo(messages=msgs, coin=coin, sync_dense=h_sync,
                                 present=present, payload=payload,
                                 plan=rnd.drawn_plan)

        def step(state: MethodState, data=None) -> MethodState:
            return step_full(state, data)[0]

        def run(state: MethodState, num_rounds: int, *,
                metric_every: int = 1, metric_fn=None, data=None,
                chunk=None, checkpoint=None, checkpoint_every: int = 1):
            """T rounds through the chunked driver; returns (final, metric
            trace, cumulative payload trace).  ``metric_fn(state) ->
            scalar`` defaults to ||grad f(x)||^2."""
            from repro_torch.methods.driver import run as drive
            if metric_fn is None:
                metric_fn = sub.default_metric()
            final, traces = drive(
                step, state, num_rounds, data=data,
                metrics={"metric": lambda s, d: metric_fn(s)},
                metric_every=metric_every, chunk=chunk,
                checkpoint=checkpoint, checkpoint_every=checkpoint_every)
            return final, traces["metric"], traces["bits_sent"]

        if lanes is not None:
            init = run = _sweep_only
        return cls(init=init, step=step, run=run, step_full=step_full)

"""State substrates (port of ``repro.methods.substrates``).

* :class:`FlatSubstrate` holds stacked ``(n, d)`` per-node state on one
  device and compresses through a
  :class:`repro_torch.compress.RoundCompressor` (dense | sparse | fused);
* :class:`SampledFlatSubstrate` is the cross-device flat substrate: each
  round a c-of-n cohort is gathered, stepped and scattered back
  (DESIGN.md §13), and under the federated slab store the round runs on
  a compact chunk slab instead of the (n, d) store (§16);
* :class:`TreeSubstrate` holds parameter-shaped trees with a leading node
  axis (the LM trainer), with per-node gradients from a
  :class:`BatchLossOracle` (or a flat problem on a single-leaf tree,
  :class:`LeafProblemOracle`) and compression through
  :class:`TreeCompression` (:mod:`repro_torch.compress.treelevel`) or, leaf
  by leaf, through a registry :class:`RoundCompressor`
  (:class:`LeafSpecCompressor`);
* :class:`LaneFlatSubstrate`, :class:`LaneSampledFlatSubstrate` and
  :class:`LaneTreeSubstrate` are a sweep's G lanes of the flat, sampled and
  tree substrates, a leading lane axis on every state field.

Substrate parity: a single-leaf :class:`TreeSubstrate` over
:class:`LeafProblemOracle` with a registry compressor is
:class:`FlatSubstrate` bit for bit (the same round plan, the same
arithmetic).

Randomness reaches a substrate as the round's
:class:`repro_torch.core.rng.RoundRandom` in place of the reference's key.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
from torch.func import grad as func_grad
from torch.func import vmap

from repro_torch.compress import as_round_compressor
from repro_torch.compress.backends import (RoundCompressor,
                                           estimator_update_with_plan)
from repro_torch.compress.spec import omega_participation
from repro_torch.compress.treelevel import (bernoulli_compress,
                                            fused_leaf_updates, node_mean,
                                            permk_compress)
from repro_torch.core import rng, tree
from repro_torch.core.oracles import _lanes_inside
from repro_torch.methods.lanes import Lanes, kernel_value
from repro_torch.methods.rules import MvrFusion
from repro_torch.optim.base import apply_updates


# ---------------------------------------------------------------------------
# shared oracle semantics over the Section 1.2 problem classes
# ---------------------------------------------------------------------------

def _oracle(problem, name: str, lanes: bool):
    """The problem's oracle ``name``, or its ``*_lanes`` form (G iterates
    in, (G, n, d) out) for a lane substrate."""
    return getattr(problem, name + "_lanes" if lanes else name)


def _problem_grad(problem, rnd, x, size, lanes=False):
    """Finite-sum: the exact nabla f_i; stochastic: a fresh size-B batch."""
    if hasattr(problem, "full_grad"):
        return _oracle(problem, "full_grad", lanes)(x)
    return _oracle(problem, "stoch_grad", lanes)(x, rnd.samples(problem,
                                                                size))


def _problem_grad_pair(problem, rnd, x_new, x_old, size, lanes=False):
    """Same-sample gradients at two points (MVR / SARAH)."""
    samples = rnd.samples(problem, size)
    if hasattr(problem, "stoch_grad_pair"):
        return _oracle(problem, "stoch_grad_pair", lanes)(x_new, x_old,
                                                          samples)
    minibatch_grad = _oracle(problem, "minibatch_grad", lanes)
    return minibatch_grad(x_new, samples), minibatch_grad(x_old, samples)


def _problem_grad_diff(problem, rnd, x_new, x_old, size, lanes=False):
    """Shared-sample difference (PAGE / MARINA).  ``size == 0`` requests the
    exact full-gradient difference (plain MARINA on finite sums)."""
    if hasattr(problem, "minibatch_diff"):
        if size == 0:
            full_grad = _oracle(problem, "full_grad", lanes)
            return full_grad(x_new) - full_grad(x_old)
        return _oracle(problem, "minibatch_diff", lanes)(
            x_new, x_old, rnd.samples(problem, size))
    gn, go = _oracle(problem, "stoch_grad_pair", lanes)(
        x_new, x_old, rnd.samples(problem, size))
    return gn - go


def _problem_megabatch(problem, rnd, x, size, lanes=False):
    """The sync round's dense upload: exact gradient when the oracle has
    one, else a fresh B' megabatch."""
    if hasattr(problem, "full_grad"):
        return _oracle(problem, "full_grad", lanes)(x)
    return _oracle(problem, "stoch_grad", lanes)(
        x, rnd.samples(problem, size, tag="sync"))


def _problem_grad_minibatch(problem, rnd, x, size, lanes=False):
    """An honest size-B minibatch gradient on either oracle (the Cor.
    6.8/6.10 B_init initialisation)."""
    samples = rnd.samples(problem, size, tag="init")
    if hasattr(problem, "stoch_grad"):
        return _oracle(problem, "stoch_grad", lanes)(x, samples)
    return _oracle(problem, "minibatch_grad", lanes)(x, samples)


def _update_with_plan(backend: str, plan, h_new, h, g_local, a):
    """``estimator_update_with_plan``, a sweep's per-lane ``a`` handed to
    the fused kernels as its (G,) fp32 values (the dense and sparse
    backends meet the :class:`Lanes` itself with their tensors)."""
    if backend == "fused":
        a = kernel_value(a, h_new.device)
    return estimator_update_with_plan(backend, plan, h_new, h, g_local, a)


# ---------------------------------------------------------------------------
# FlatSubstrate
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FlatSubstrate:
    """Stacked (n, d) per-node state on one device (vmap-ed oracles)."""

    problem: Any
    n: int
    d: int
    rc: Optional[RoundCompressor] = None

    #: the flat fused backend takes h_new as it is, so rules materialise it
    fuses_mvr = False
    #: oracles take one iterate; a :class:`LaneFlatSubstrate` takes G
    _lanes = False

    def with_compressor(self, comp) -> "FlatSubstrate":
        """Bind a :class:`RoundCompressor` or a legacy view of one
        (:func:`repro_torch.compress.as_round_compressor`)."""
        return dataclasses.replace(self, rc=as_round_compressor(comp))

    def with_lanes(self, lanes: int) -> "LaneFlatSubstrate":
        """This substrate with a leading lane axis of ``lanes`` on every
        device field (a sweep's G lanes; see :class:`LaneFlatSubstrate`)."""
        return LaneFlatSubstrate(self.problem, self.n, self.d, self.rc,
                                 lanes=int(lanes))

    def place(self, x, device) -> torch.Tensor:
        """An iterate (or per-node rows) as float32 on ``device``."""
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    place_per_node = place

    # -- oracle ops --------------------------------------------------------
    def grad(self, rnd, x, data=None, size: int = 1):
        return _problem_grad(self.problem, rnd, x, size, self._lanes)

    def grad_pair(self, rnd, x_new, x_old, size: int, data=None):
        return _problem_grad_pair(self.problem, rnd, x_new, x_old, size,
                                  self._lanes)

    def grad_diff(self, rnd, x_new, x_old, size: int, data=None):
        return _problem_grad_diff(self.problem, rnd, x_new, x_old, size,
                                  self._lanes)

    def megabatch(self, rnd, x, size: int, data=None):
        return _problem_megabatch(self.problem, rnd, x, size, self._lanes)

    def grad_minibatch(self, rnd, x, size: int, data=None):
        return _problem_grad_minibatch(self.problem, rnd, x, size,
                                       self._lanes)

    # -- arithmetic --------------------------------------------------------
    def lin(self, fn: Callable, *tensors):
        return fn(*tensors)

    def mean_nodes(self, per_node):
        return per_node.mean(0)

    def add_server(self, g, agg):
        return g + agg

    def sub_deficit(self, g, deficit):
        """g minus the in-flight message sum (asynchronous rounds,
        DESIGN.md §14): what the server has actually received.  Exact
        because g is a sum: subtracting the unlanded terms commutes with
        every landing."""
        return g - deficit

    def zeros_per_node(self, x0):
        return torch.zeros((self.n, self.d), dtype=x0.dtype,
                           device=x0.device)

    def dense_coords(self, per_node=None) -> float:
        return float(self.d)

    # -- server ------------------------------------------------------------
    def init_opt(self, x0):
        return ()

    def server_update(self, x, g, opt_state, hp):
        return x - hp.gamma * g, opt_state

    # -- compression (Alg. 1 lines 9-10) -----------------------------------
    def estimator_update_full(self, rnd, h_new, h, g_local, a: float,
                              aux=None):
        """Alg. 1 lines 9-10 with the round's plan: returns (aggregate,
        h_out, g_local_new, payload per node, the per-node messages, the
        Appendix-D participation or None at full participation)."""
        plan = rnd.plan(self.rc)
        msgs, h_out, gl = _update_with_plan(self.rc.backend, plan, h_new,
                                            h, g_local, a)
        present = None
        if self.rc.spec.p_participate < 1.0:
            # a zero scale row IS an absent node
            present = torch.ravel(plan.scale) != 0
        return (msgs.mean(), h_out, gl, self.rc.payload_per_node, msgs,
                present)

    def round_present(self, rnd):
        """(n,) Appendix-D participation of the round whose randomness is
        ``rnd``: the plan :meth:`estimator_update_full` then uses (drawn
        once per round, or injected), read without running the step.
        All ones at full participation, with no plan drawn.  The fault
        layer needs it to tell a crashed absentee (nothing expected,
        nothing lost) from a crashed participant (the server waits, then
        degrades)."""
        if self.rc.spec.p_participate >= 1.0:
            return torch.ones((self.n,), dtype=torch.bool,
                              device=self.rc.device)
        return torch.ravel(rnd.plan(self.rc).scale) != 0

    def round_wire_counts(self, rnd):
        """(n,) int32 shipped value scalars per node for the round whose
        randomness is ``rnd`` (the plan the engine draws).  Only mask
        (Bernoulli) plans have data-dependent counts; every other format's
        count is static (:func:`repro_torch.fed.wire.wire_schema`)."""
        plan = rnd.plan(self.rc)
        if plan.mask is None:
            raise ValueError("round_wire_counts is only defined for mask "
                             "(Bernoulli) plans; static-count formats come "
                             "from repro_torch.fed.wire.wire_schema")
        return torch.sum(plan.mask != 0, dim=1).to(torch.int32)

    # -- metrics -----------------------------------------------------------
    def default_metric(self):
        """||grad f(x)||^2 from whichever exact gradient the problem has."""
        p = self.problem
        if hasattr(p, "grad_f"):
            return lambda s: torch.sum(p.grad_f(s.x) ** 2)
        if getattr(p, "true_grad", None) is not None:
            return lambda s: torch.sum(p.true_grad(s.x) ** 2)
        return lambda s: torch.zeros((), device=s.x.device)


@dataclasses.dataclass(frozen=True)
class LaneFlatSubstrate(FlatSubstrate):
    """G lanes of a :class:`FlatSubstrate` side by side, for a sweep: the
    iterate and server estimator are (G, d), the per-node fields (G, n, d).

    * the oracles are the problem's ``*_lanes`` entry points, which read
      the features once for all lanes (:mod:`repro_torch.core.oracles`);
      every lane shares the round's samples, as G sequential runs from
      one seed draw the same ones;
    * the round draws ONE compression plan, shared by every lane, and the
      backends broadcast its (n, d) support over the lane axis: the fused
      backend updates all G * n rows in one kernel launch;
    * a hyperparameter that varies by lane is a
      :class:`repro_torch.methods.lanes.Lanes`, which meets lane j's rows
      with lane j's value (the server step ``x - gamma * g`` included).
    """

    lanes: int = 1
    _lanes = True

    def with_lanes(self, lanes: int) -> "LaneFlatSubstrate":
        return dataclasses.replace(self, lanes=int(lanes))

    def mean_nodes(self, per_node):
        return per_node.mean(-2)

    def sub_deficit(self, g, deficit):
        raise ValueError("deficit= (asynchronous rounds) has no lane form: "
                         "the simulators run one method, not a sweep")


# ---------------------------------------------------------------------------
# SampledFlatSubstrate: the cross-device O(C*d) round (DESIGN.md §13)
# ---------------------------------------------------------------------------

def gather_slab_rows(full: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Slab gather: rows of ``full`` at ``idx`` (a new tensor); the pad
    sentinel (== n, one past the end) reads as zeros."""
    n = full.shape[0]
    out = full.index_select(0, idx.clamp(max=n - 1))
    return out.masked_fill_((idx >= n)[:, None], 0.0)


def slab_layout(sels: np.ndarray, n: int):
    """The chunk's slab layout from its (length, C) cohort schedule.

    Returns ``(uniq_pad, loc)``: ``uniq_pad`` (U_pad,) int32, the sorted
    union of touched global rows padded to the static length ``U_pad =
    min(length * C, n)`` with the sentinel ``n``; ``loc`` (length, C)
    int32, each round's cohort as slab rows (``uniq_pad[loc[t]] ==
    sels[t]``)."""
    length, c = sels.shape
    u_pad = min(length * c, n)
    uniq = np.unique(sels)
    loc = np.searchsorted(uniq, sels).astype(np.int32)
    uniq_pad = np.full((u_pad,), n, np.int32)
    uniq_pad[:uniq.size] = uniq
    return uniq_pad, loc


def _rows_stoch_grad(problem, x, xi, rows, lanes: bool = False):
    """Row-restricted ``StochasticProblem.stoch_grad``: each cohort row's
    gradient with its global client id as the node index (the same xi give
    the same-sample pair of MVR).  ``lanes``: x is (G, d) and the result
    (G, C, d), the lane vmap inside the node vmap as the problem's own lane
    forms."""
    if lanes:
        return _lanes_inside(func_grad(problem._node_mean), x, xi, rows)
    return vmap(func_grad(problem._node_mean), in_dims=(None, 0, 0))(
        x, xi, rows)


class _CohortView:
    """One round's (C, d) window onto a :class:`SampledFlatSubstrate`.

    It exposes the ops the variant rules consume, but every oracle call and
    the estimator update run on the cohort's rows only, so the round costs
    O(C*d) while the (n, d) client state stays put.  ``scatter_nodes``
    writes the cohort rows back; unsampled rows freeze (an offline client
    computes nothing).

    ``clients`` holds the cohort's global client ids on the host and
    ``sel`` the same ids on the problem's device: every data gather,
    sample draw and participation mask is keyed by them.  Under the slab
    store the view also gets ``loc``, the cohort's rows inside the chunk's
    (U, d) slab, which ``gather_nodes`` / ``scatter_nodes`` then address
    instead of the (n, d) store.  The slab belongs to the simulator's
    chunk, so it is written in place; the (n, d) store of a state handed
    to ``step_full`` never is."""

    fuses_mvr = False

    def __init__(self, base: "SampledFlatSubstrate", clients: np.ndarray,
                 sel: torch.Tensor, loc: Optional[torch.Tensor] = None):
        self.base = base
        self.clients = clients
        self.sel = sel
        self.loc = loc
        self._rows = None
        # a sweep's lanes: (G, n, d) state, oracles in their lane forms
        self._lanes = base._lanes

    # -- node-axis windowing (the node axis is -2, after any lane axis) ----
    def gather_nodes(self, per_node):
        idx = self.sel if self.loc is None else self.loc
        return per_node.index_select(-2, idx)

    def scatter_nodes(self, full, rows):
        if self.loc is None:
            return full.index_copy(-2, self.sel, rows)
        return full.index_copy_(-2, self.loc, rows)

    def _rows_problem(self):
        """The finite-sum problem restricted to the cohort's data rows."""
        if self._rows is None:
            p = self.base.problem
            self._rows = dataclasses.replace(
                p, features=p.features.index_select(0, self.sel),
                labels=p.labels.index_select(0, self.sel))
        return self._rows

    def _stoch(self, rnd, x, size, tag):
        p = self.base.problem
        xi = rnd.client_samples(p, size, self.clients, tag)
        return _rows_stoch_grad(p, x, xi, self.sel, self._lanes)

    def _full(self, x):
        return _oracle(self._rows_problem(), "full_grad", self._lanes)(x)

    # -- oracle ops (cohort rows only) ------------------------------------
    def grad(self, rnd, x, data=None, size: int = 1):
        if hasattr(self.base.problem, "full_grad"):
            return self._full(x)
        return self._stoch(rnd, x, size, "h")

    def grad_pair(self, rnd, x_new, x_old, size: int, data=None):
        p = self.base.problem
        if hasattr(p, "stoch_grad_pair"):
            xi = rnd.client_samples(p, size, self.clients)
            return (_rows_stoch_grad(p, x_new, xi, self.sel, self._lanes),
                    _rows_stoch_grad(p, x_old, xi, self.sel, self._lanes))
        return _problem_grad_pair(self._rows_problem(), rnd, x_new, x_old,
                                  size, self._lanes)

    def grad_diff(self, rnd, x_new, x_old, size: int, data=None):
        if hasattr(self.base.problem, "minibatch_diff"):
            return _problem_grad_diff(self._rows_problem(), rnd, x_new,
                                      x_old, size, self._lanes)
        gn, go = self.grad_pair(rnd, x_new, x_old, size, data)
        return gn - go

    def megabatch(self, rnd, x, size: int, data=None):
        if hasattr(self.base.problem, "full_grad"):
            return self._full(x)
        return self._stoch(rnd, x, size, "sync")

    def grad_minibatch(self, rnd, x, size: int, data=None):
        if hasattr(self.base.problem, "stoch_grad"):
            return self._stoch(rnd, x, size, "init")
        return _problem_grad_minibatch(self._rows_problem(), rnd, x, size,
                                       self._lanes)

    # -- arithmetic ---------------------------------------------------------
    def lin(self, fn: Callable, *tensors):
        return fn(*tensors)

    # -- compression (cohort slice; inflation folded into the plan) --------
    def estimator_update_full(self, rnd, h_new, h, g_local, a: float,
                              aux=None):
        base = self.base
        rc = base.cohort_rc
        # the unbiasedness inflation n/C (Theorem D.1 with p' = C/n) folds
        # into the plan scale: messages carry it, so g_i += m_i keeps
        # g = mean_i(g_i)
        plan = rnd.plan(rc)
        plan = plan._replace(scale=plan.scale * (base.n / float(base.c)))
        msgs, h_out, gl = _update_with_plan(rc.backend, plan, h_new, h,
                                            g_local, a)
        # server aggregate (1/n) sum_{i in S} m_i = (C/n) * mean_S(m_i)
        agg = msgs.mean() * (float(base.c) / base.n)
        present = torch.zeros((base.n,), dtype=torch.bool,
                              device=self.sel.device).index_fill_(
            0, self.sel, True)
        payload = rc.payload_per_node * (float(base.c) / base.n)
        return agg, h_out, gl, payload, msgs, present


@dataclasses.dataclass(frozen=True)
class SampledFlatSubstrate(FlatSubstrate):
    """Cross-device FlatSubstrate: each round a uniform cohort of ``c`` of
    the ``n`` clients is gathered, stepped and scattered back.

    Gradients, compression and estimator updates touch only the (c, d)
    cohort slice while unsampled clients freeze (they compute and send
    nothing; the variance cost is the Theorem-D.1 omega inflation with
    p' = c/n).  With ``c == n`` the substrate is FlatSubstrate
    (``round_view`` returns ``self``), the bit-identical anchor.  Rules
    with a client-synchronization barrier (``sync_requires_all``) are
    rejected by ``Method.build``."""

    c: int = 0

    def __post_init__(self):
        if not 0 < self.c <= self.n:
            raise ValueError(f"cohort size c={self.c} must be in [1, "
                             f"n={self.n}]")
        if self.rc is not None and self.rc.spec.p_participate < 1.0:
            raise ValueError(
                "SampledFlatSubstrate IS the participation model: combine "
                "it with a p_participate < 1 compressor and clients would "
                "be sampled twice; use one or the other")

    @property
    def samples_clients(self) -> bool:
        return self.c < self.n

    def with_lanes(self, lanes: int) -> "LaneSampledFlatSubstrate":
        """This substrate with a leading lane axis of ``lanes`` on every
        device field (see :class:`LaneSampledFlatSubstrate`)."""
        return LaneSampledFlatSubstrate(self.problem, self.n, self.d,
                                        self.rc, c=self.c, lanes=int(lanes))

    @property
    def participation_frac(self) -> float:
        return self.c / float(self.n)

    @property
    def cohort_rc(self) -> RoundCompressor:
        """The round's compressor over the cohort: same spec, mode, backend
        and device, re-dimensioned to c nodes (PermK partitions [d] over
        the active cohort, so its collection omega becomes c - 1)."""
        rc = self.rc
        spec = rc.spec
        if spec.name == "permk":
            spec = dataclasses.replace(spec, n=self.c)
        return RoundCompressor(spec, self.c, rc.mode, rc.backend, rc.device)

    def effective_omega(self) -> float:
        """Theorem-D.1 inflated omega for ``Hyper.from_theory``:
        (omega_cohort + 1) / (c/n) - 1."""
        return omega_participation(self.cohort_rc.omega,
                                   self.participation_frac)

    def round_view(self, rnd):
        """The engine's per-round window: ``self`` at c == n (the
        bit-identical full path), else a :class:`_CohortView` over the
        round's cohort (:meth:`repro_torch.core.rng.RoundRandom.cohort`)."""
        if self.c >= self.n:
            return self
        clients = rnd.cohort(self.n, self.c)
        return _CohortView(self, clients, torch.as_tensor(
            clients, device=self.problem.device))

    def window_view(self, clients, sel, loc) -> _CohortView:
        """The slab-store round window (DESIGN.md §16): ``clients`` is the
        round's global cohort on the host, the same ids :meth:`round_view`
        would draw, taken from :meth:`cohort_schedule` ahead of the chunk;
        ``sel`` is that row already on the device (int64) and ``loc`` its
        rows inside the chunk slab (int64)."""
        return _CohortView(self, np.asarray(clients, np.int64), sel, loc)

    def round_cohort(self, seed: int, t: int, draws=None) -> np.ndarray:
        """The (c,) int32 cohort of the round whose randomness is ``(seed,
        t)`` (``draws``' injected cohort where it has one): the ids
        :meth:`round_view` draws, recovered without running the step (one
        round of :meth:`cohort_schedule`), for observers such as the
        federated simulators."""
        return self.cohort_schedule(
            seed, t, 1, None if draws is None else (lambda _: draws))[0]

    def cohort_schedule(self, seed: int, t0: int, length: int,
                        draws=None) -> np.ndarray:
        """The cohorts of rounds ``t0 .. t0 + length - 1``, (length, c)
        int32 on the host: the same draws :meth:`round_view` makes."""
        return rng.cohort_schedule(seed, t0, length, self.n, self.c, draws)

    def cohort_counts(self, rnd):
        """(c,) per-cohort Bernoulli wire counts: the slab round's form of
        :meth:`round_wire_counts` (the same plan, no (n,) scatter)."""
        plan = rnd.plan(self.cohort_rc)
        if plan.mask is None:
            raise ValueError("cohort_counts is only defined for mask "
                             "(Bernoulli) plans")
        return torch.sum(plan.mask != 0, dim=1).to(torch.int32)

    def round_wire_counts(self, rnd):
        if not self.samples_clients:
            return FlatSubstrate.round_wire_counts(self, rnd)
        sel = torch.as_tensor(rnd.cohort(self.n, self.c),
                              device=self.rc.device)
        cnt = self.cohort_counts(rnd)
        return torch.zeros((self.n,), dtype=torch.int32,
                           device=cnt.device).index_copy_(0, sel, cnt)


@dataclasses.dataclass(frozen=True)
class LaneSampledFlatSubstrate(SampledFlatSubstrate):
    """G lanes of a :class:`SampledFlatSubstrate` side by side, for a
    sweep: the iterate and server estimator are (G, d), the per-node store
    (G, n, d).

    Every lane samples the round's one cohort (drawn from the round seed,
    as G sequential runs from one seed draw the same cohort), gathers its
    (G, C, d) rows, runs the problem's lane oracles on the cohort's data
    rows, and compresses them with the cohort's one plan: the fused backend
    updates all G * C rows in one kernel launch, each reading its node's
    row of the plan (row r % C).  Unsampled rows of every lane freeze.
    """

    lanes: int = 1
    _lanes = True

    def with_lanes(self, lanes: int) -> "LaneSampledFlatSubstrate":
        return dataclasses.replace(self, lanes=int(lanes))

    def mean_nodes(self, per_node):
        return per_node.mean(-2)

    def sub_deficit(self, g, deficit):
        raise ValueError("deficit= (asynchronous rounds) has no lane form: "
                         "the simulators run one method, not a sweep")

    def window_view(self, clients, sel, loc):
        raise ValueError("window= (the slab store) has no lane form: the "
                         "simulators run one method, not a sweep")


# ---------------------------------------------------------------------------
# tree oracle
# ---------------------------------------------------------------------------

def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _node_rows(data, node_dims):
    """This rank's rows of a batch tree's node axis: each DTensor leaf's
    local shard, its node axis on the node dims of its mesh."""
    from torch.distributed.tensor import Shard

    def one(x):
        if not _is_dtensor(x) or any(x.placements[j] != Shard(0)
                                     for j in node_dims):
            raise ValueError("a sharded step's batch leaves must be "
                             "DTensors with their node axis on the node "
                             f"axes, got {type(x).__name__} "
                             f"{getattr(x, 'placements', '')}")
        return x.to_local()
    return tree.map_leaves(one, data)


@dataclasses.dataclass(frozen=True)
class BatchLossOracle:
    """Per-node gradients of ``loss_fn(params, node_batch)`` (training).

    ``data`` is a batch tree with a leading node axis (n, ...).  The nodes
    are looped over with ``torch.autograd.grad`` (the reference vmaps; the
    ctypes kernels cannot be batched through ``vmap``).  Gradients come out
    in the parameters' dtype and are cast to ``state_dtype`` into one
    preallocated (n, *shape) buffer per leaf.  The same batch evaluates both
    points of a pair — the "same samples" requirement of MVR/PAGE — and the
    megabatch sync round reuses the round's batch (B' = B at this layer).

    ``lanes=G`` (a sweep's :class:`LaneTreeSubstrate`): the parameters
    carry a leading (G,) lane axis, and lane j's gradients on every node's
    batch fill row (j, i) of one (G, n, *shape) buffer per leaf; the lanes
    share the round's batch.

    On a mesh (DTensor parameters) the node axis lies on ``spmd_axes``
    (the reference's vmap ``spmd_axis_name``) and each rank computes only
    its own nodes' gradients, on its shard of the batch's node axis:

    * each parameter is laid out by its ``grad_specs`` entry (a spec with
      no node axes; by default its own layout with the node axes
      replicated) outside autograd, so an FSDP leaf is gathered over the
      data axes once, forward and backward see no data-axis traffic, and
      no gradient is reduced over the nodes;
    * the loss runs on the mesh's other axes (the "model" sub-mesh),
      tensor-parallel, on the rank's node rows;
    * the gradient of each leaf comes back as the local shard of its
      ``grad_specs`` layout (a partial sum over "model" is reduced there)
      and fills this rank's rows of an (n, *shape) DTensor laid out by
      ``P(spmd_axes, *grad_spec)``.  No rank builds another node's rows.
    """

    loss_fn: Callable[[Any, Any], torch.Tensor]
    state_dtype: torch.dtype = torch.float32
    spmd_axes: Optional[Tuple[str, ...]] = None
    grad_specs: Any = None

    def per_node_grads(self, params, data, lanes: int = 0):
        paths, leaves = zip(*tree.items(params))
        if _is_dtensor(leaves[0]):
            if lanes:
                raise ValueError("a sweep's lanes have no sharded form")
            return self._sharded_grads(paths, leaves, data)
        n = tree.leaves(data)[0].shape[0]
        lead = (lanes, n) if lanes else (n,)
        out = [torch.empty(lead + tuple(p.shape[1 if lanes else 0:]),
                           dtype=self.state_dtype, device=p.device)
               for p in leaves]
        for j in range(max(lanes, 1)):
            lane = [p[j] for p in leaves] if lanes else leaves
            for i in range(n):
                ps = [p.detach().requires_grad_(True) for p in lane]
                node_batch = tree.map_leaves(lambda x: x[i], data)
                with torch.enable_grad():
                    loss = self.loss_fn(tree.from_items(zip(paths, ps)),
                                        node_batch)
                    grads = torch.autograd.grad(loss, ps)
                for buf, g in zip(out, grads):
                    (buf[j, i] if lanes else buf[i]).copy_(g)
        return tree.from_items(zip(paths, out))

    def _sharded_grads(self, paths, leaves, data):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.models import sharding as sh
        mesh = leaves[0].device_mesh
        if not self.spmd_axes:
            raise ValueError("DTensor parameters need spmd_axes, the mesh "
                             "axes of the node axis")
        names = list(mesh.mesh_dim_names)
        node_dims = sorted(names.index(a) for a in self.spmd_axes)
        rest = tuple(a for a in names if names.index(a) not in node_dims)
        sub = mesh[rest] if rest else None
        n_ranks = 1
        for j in node_dims:
            n_ranks *= mesh.size(j)

        def layout(path, p):
            if self.grad_specs is not None:
                pl = sh.to_placements(tree.get(self.grad_specs, path), mesh)
            else:
                pl = [Replicate() if j in node_dims else q
                      for j, q in enumerate(p.placements)]
            if any(not isinstance(pl[j], Replicate) for j in node_dims):
                raise ValueError(f"the gradient spec of {path!r} shards "
                                 f"over a node axis {self.spmd_axes}")
            return pl

        pls = [layout(path, p) for path, p in zip(paths, leaves)]
        # the FSDP gather, outside autograd: a parameter leaf is the same
        # on every node, so no gradient flows back over the data axes
        locs = [p.detach().redistribute(mesh, pl).to_local()
                for p, pl in zip(leaves, pls)]
        subs = [[q for j, q in enumerate(pl) if j not in node_dims]
                for pl in pls]
        rows = _node_rows(data, node_dims)
        n_local = tree.leaves(rows)[0].shape[0]
        n = n_local * n_ranks
        out = [torch.empty((n_local,) + tuple(x.shape),
                           dtype=self.state_dtype, device=x.device)
               for x in locs]
        for i in range(n_local):
            ps = [t.detach().requires_grad_(True) for t in locs]
            node_batch = tree.map_leaves(
                lambda x: x[i] if sub is None else DTensor.from_local(
                    x[i], sub, [Replicate()] * sub.ndim, run_check=False),
                rows)
            with torch.enable_grad():
                args = ps if sub is None else [
                    DTensor.from_local(x, sub, spl, run_check=False,
                                       shape=p.shape, stride=p.stride())
                    for x, spl, p in zip(ps, subs, leaves)]
                loss = self.loss_fn(tree.from_items(zip(paths, args)),
                                    node_batch)
                if _is_dtensor(loss):
                    loss = loss.full_tensor()
                grads = torch.autograd.grad(loss, ps)
            for buf, g in zip(out, grads):
                buf[i].copy_(g)
        res = []
        for buf, pl, p in zip(out, pls, leaves):
            npl = [Shard(0) if j in node_dims else
                   (Shard(q.dim + 1) if isinstance(q, Shard) else q)
                   for j, q in enumerate(pl)]
            shape = (n,) + tuple(p.shape)
            res.append(DTensor.from_local(buf, mesh, npl, run_check=False,
                                          shape=torch.Size(shape),
                                          stride=sh._contiguous(shape)))
        return tree.from_items(zip(paths, res))

    def grad(self, rnd, x, data, size: int = 1, lanes: int = 0):
        return self.per_node_grads(x, data, lanes)

    def grad_pair(self, rnd, x_new, x_old, size: int, data, lanes: int = 0):
        return (self.per_node_grads(x_new, data, lanes),
                self.per_node_grads(x_old, data, lanes))

    def grad_diff(self, rnd, x_new, x_old, size: int, data, lanes: int = 0):
        gn, go = self.grad_pair(rnd, x_new, x_old, size, data, lanes)
        return tree.map_leaves(
            lambda a, b: (a.to(torch.float32)
                          - b.to(torch.float32)).to(self.state_dtype),
            gn, go)

    def megabatch(self, rnd, x, size: int, data, lanes: int = 0):
        return self.per_node_grads(x, data, lanes)

    def grad_minibatch(self, rnd, x, size: int, data, lanes: int = 0):
        return self.per_node_grads(x, data, lanes)


@dataclasses.dataclass(frozen=True)
class LeafProblemOracle:
    """A flat Section-1.2 problem on a single-leaf tree substrate.

    The parity bridge: per-node quantities are the problem's (n, d)
    tensors wrapped back into the iterate's single-leaf tree, so a
    :class:`TreeSubstrate` over it with a registry compressor reproduces
    :class:`FlatSubstrate` bit for bit.  ``path`` is the leaf's path (``""``
    for a bare tensor).  With a sweep's lanes the leaf is (G, d) and the
    problem's lane oracles answer.
    """

    problem: Any
    path: str = ""

    @classmethod
    def wrapping(cls, problem, x0_tree) -> "LeafProblemOracle":
        """The oracle of ``problem`` on trees shaped like ``x0_tree``,
        which must have exactly one leaf."""
        items = list(tree.items(x0_tree))
        if len(items) != 1:
            raise ValueError(f"LeafProblemOracle is single-leaf only, got "
                             f"{len(items)} leaves")
        return cls(problem=problem, path=items[0][0])

    def _leaf(self, t):
        return tree.get(t, self.path)

    def _wrap(self, arr):
        return arr if self.path == "" else tree.from_items([(self.path, arr)])

    def grad(self, rnd, x, data=None, size: int = 1, lanes: int = 0):
        return self._wrap(_problem_grad(self.problem, rnd, self._leaf(x),
                                        size, bool(lanes)))

    def grad_pair(self, rnd, x_new, x_old, size: int, data=None,
                  lanes: int = 0):
        gn, go = _problem_grad_pair(self.problem, rnd, self._leaf(x_new),
                                    self._leaf(x_old), size, bool(lanes))
        return self._wrap(gn), self._wrap(go)

    def grad_diff(self, rnd, x_new, x_old, size: int, data=None,
                  lanes: int = 0):
        return self._wrap(_problem_grad_diff(
            self.problem, rnd, self._leaf(x_new), self._leaf(x_old), size,
            bool(lanes)))

    def megabatch(self, rnd, x, size: int, data=None, lanes: int = 0):
        return self._wrap(_problem_megabatch(self.problem, rnd,
                                             self._leaf(x), size,
                                             bool(lanes)))

    def grad_minibatch(self, rnd, x, size: int, data=None, lanes: int = 0):
        return self._wrap(_problem_grad_minibatch(
            self.problem, rnd, self._leaf(x), size, bool(lanes)))


# ---------------------------------------------------------------------------
# tree compression
# ---------------------------------------------------------------------------

def _leaf_size(leaf, lanes: bool = False) -> float:
    """Coordinates per node of a per-node leaf (n, *shape), or (G, n,
    *shape) with ``lanes``."""
    sz = 1.0
    for s in leaf.shape[2 if lanes else 1:]:
        sz *= s
    return sz


@dataclasses.dataclass(frozen=True)
class TreeCompression:
    """Tree-native compression: the trainer's mode knob over
    :mod:`repro_torch.compress.treelevel` (fused-capable).  ``specs`` lays
    a DTensor state's masks out as its leaves (each rank draws its shard;
    the fused path runs on the local shards through ``local_map``); the
    aggregate is then a DTensor mean over the node axis, the one
    reduction over the data axes."""

    mode: str = "independent"     # independent | shared_coords | permk
    p: float = 1.0                # Bernoulli-RandP keep probability
    n: int = 1
    use_kernel: bool = False
    specs: Any = None             # per-node specs P(spmd_axes, *spec)

    @property
    def static_frac(self) -> float:
        """Payload / dense, per node (the trainer's payload_frac metric)."""
        return 1.0 / self.n if self.mode == "permk" else self.p

    def payload_per_node(self, per_node_tree, lanes: bool = False) -> float:
        return sum(self.static_frac * _leaf_size(l, lanes)
                   for l in tree.leaves(per_node_tree))

    def estimator_update(self, rnd, h_new, h, g_local, a: float, aux=None,
                         lanes: bool = False):
        """Returns (aggregate, h_out, g_local_new, payload per node).  The
        kernel path reduces each leaf's messages to their mean as soon as
        its kernel has run, so the (n, *shape) messages of the whole tree
        never exist at once.  ``h_new`` is None when the MVR h-update is
        left to the kernel; ``aux`` is then the round's :class:`MvrFusion`,
        whose two gradient trees this path consumes: each leaf is released
        once its kernel has read it, so they never coexist with all of the
        round's outputs.  ``lanes``: the trees' leaves are (G, n, *shape),
        a sweep's G lanes, which share the round's masks."""
        f32 = torch.float32
        node_axis = 1 if lanes else 0
        if self.use_kernel:
            fusion = aux if isinstance(aux, MvrFusion) else None
            dev = tree.leaves(g_local)[0].device
            a = kernel_value(a, dev)
            if fusion is not None:
                b, c = fusion.b, None
                if isinstance(b, Lanes):
                    b, c = None, (1.0 - b).as_vector(dev)
                leaves = fused_leaf_updates(
                    rnd, fusion.grads_new, h, g_local, mode=self.mode, a=a,
                    p=self.p, n=self.n, variant="mvr", b=b,
                    grads_old=fusion.grads_old, lanes=lanes, c=c,
                    specs=self.specs)
            else:
                leaves = fused_leaf_updates(
                    rnd, h_new, h, g_local, mode=self.mode, a=a, p=self.p,
                    n=self.n, variant="dasha", lanes=lanes,
                    specs=self.specs)
            aggs, h_outs, gls = [], [], []
            for path, m, hn, gl in leaves:
                aggs.append((path, node_mean(m, node_axis)))
                h_outs.append((path, hn))
                gls.append((path, gl))
                if fusion is not None:
                    tree.release(fusion.grads_new, path)
                    tree.release(fusion.grads_old, path)
            return (tree.from_items(aggs), tree.from_items(h_outs),
                    tree.from_items(gls), self.payload_per_node(h, lanes))

        delta = tree.map_leaves(lambda hn, hh, gl_: hn - hh - a * (gl_ - hh),
                                h_new, h, g_local)
        if self.mode == "permk":
            m, agg = permk_compress(rnd, delta, self.n, lanes=lanes,
                                    specs=self.specs)
        else:
            m = bernoulli_compress(rnd, delta, self.p,
                                   shared=self.mode == "shared_coords",
                                   lanes=lanes, specs=self.specs)
            agg = tree.map_leaves(lambda mm: node_mean(mm, node_axis), m)
        gl_new = tree.map_leaves(torch.add, g_local, m)
        return agg, h_new, gl_new, self.payload_per_node(h_new, lanes)


@dataclasses.dataclass(frozen=True)
class LeafSpecCompressor:
    """A registry :class:`RoundCompressor` run leaf by leaf: each per-node
    leaf reshaped to (n, d_leaf) and compressed by the round compressor
    re-dimensioned to d_leaf (same spec, mode, backend and device).  This is
    how RandK, PermK, Bernoulli, QDither and partial participation run on a
    tree substrate.

    Randomness: a single-leaf tree draws the round's own plan
    (``rnd.plan``), the plan :class:`FlatSubstrate`'s round draws, so the
    two are bit-identical; with several leaves each leaf draws its plan
    from a generator seeded by the round and the leaf's path
    (:meth:`repro_torch.core.rng.RoundRandom.leaf_plan`), or takes the one
    injected for it (``Draws.leaf_plans``).

    The MVR h-update is never fused here (the fused tree kernel is
    :class:`TreeCompression`'s): ``h_new`` arrives materialised and the
    fused backend runs kernel 1 (or kernel 2 for QDither) once per leaf.
    """

    rc: RoundCompressor

    @property
    def static_frac(self) -> float:
        return self.rc.payload_per_node / float(self.rc.spec.d)

    def _leaf_rc(self, d_leaf: int) -> RoundCompressor:
        spec = self.rc.spec
        if spec.name == "randk" and not 0 < (spec.k or 0) <= d_leaf:
            raise ValueError(f"randk needs 0 < k <= d, got k={spec.k} "
                             f"d={d_leaf}")
        return RoundCompressor(dataclasses.replace(spec, d=d_leaf),
                               self.rc.n, self.rc.mode, self.rc.backend,
                               self.rc.device)

    def payload_per_node(self, per_node_tree, lanes: bool = False) -> float:
        return sum(self._leaf_rc(int(_leaf_size(l, lanes))).payload_per_node
                   for l in tree.leaves(per_node_tree))

    def leaf_plans(self, rnd, per_node_tree, lanes: bool = False):
        """``{path: plan}``: each leaf's plan of the round whose randomness
        is ``rnd``, as :meth:`estimator_update` draws them."""
        items = list(tree.items(per_node_tree))
        out = {}
        for path, leaf in items:
            rc = self._leaf_rc(int(_leaf_size(leaf, lanes)))
            out[path] = rnd.plan(rc) if len(items) == 1 \
                else rnd.leaf_plan(path, rc)
        return out

    def estimator_update(self, rnd, h_new, h, g_local, a: float, aux=None,
                         lanes: bool = False):
        """Returns (aggregate, h_out, g_local_new, payload per node).
        ``lanes``: the leaves are (G, n, *shape), a sweep's lanes, which
        share each leaf's plan."""
        node_axis = 1 if lanes else 0
        plans = self.leaf_plans(rnd, h_new, lanes)
        aggs, h_outs, gls, payload = [], [], [], 0.0
        for path, hn in tree.items(h_new):
            lead = tuple(hn.shape[:node_axis + 1])
            shape = tuple(hn.shape[node_axis + 1:])
            d_leaf = int(_leaf_size(hn, lanes))
            rc = self._leaf_rc(d_leaf)

            def flat(t, lead=lead, d_leaf=d_leaf):
                return t.reshape(lead + (d_leaf,))

            msgs, h_out, gl_new = _update_with_plan(
                rc.backend, plans[path], flat(hn), flat(tree.get(h, path)),
                flat(tree.get(g_local, path)), a)
            aggs.append((path, msgs.mean().reshape(lead[:-1] + shape)))
            h_outs.append((path, h_out.reshape(hn.shape)))
            gls.append((path, gl_new.reshape(hn.shape)))
            payload += rc.payload_per_node
        if len(aggs) == 1 and aggs[0][0] == "":
            return aggs[0][1], h_outs[0][1], gls[0][1], payload
        return (tree.from_items(aggs), tree.from_items(h_outs),
                tree.from_items(gls), payload)


# ---------------------------------------------------------------------------
# TreeSubstrate
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TreeSubstrate:
    """Parameter-shaped trees with a leading node axis (the trainer)."""

    oracle: Any
    n: int
    server_opt: Any                     # repro_torch.optim.base SGD / Adam
    state_dtype: torch.dtype = torch.float32
    comp: Any = None                    # TreeCompression | LeafSpecCompressor

    def with_compressor(self, comp) -> "TreeSubstrate":
        """Bind a :class:`TreeCompression` or a
        :class:`LeafSpecCompressor`; a :class:`RoundCompressor` (or a legacy
        view of one) runs leaf by leaf as a :class:`LeafSpecCompressor`."""
        if isinstance(comp, (TreeCompression, LeafSpecCompressor)):
            bound = comp
        else:
            bound = LeafSpecCompressor(as_round_compressor(comp))
        return dataclasses.replace(self, comp=bound)

    def with_lanes(self, lanes: int) -> "LaneTreeSubstrate":
        """This substrate with a leading lane axis of ``lanes`` on every
        state leaf (a sweep's G lanes; see :class:`LaneTreeSubstrate`)."""
        return LaneTreeSubstrate(self.oracle, self.n, self.server_opt,
                                 self.state_dtype, self.comp,
                                 lanes=int(lanes))

    @property
    def fuses_mvr(self) -> bool:
        """The fused tree kernel recomputes the MVR h-update in its own
        pass (a :class:`TreeCompression` with ``use_kernel``)."""
        return isinstance(self.comp, TreeCompression) and \
            self.comp.use_kernel

    def place(self, x, device):
        return tree.map_leaves(lambda t: torch.as_tensor(t, device=device),
                               x)

    def place_per_node(self, per_node, device):
        return tree.map_leaves(lambda t: torch.as_tensor(
            t, dtype=self.state_dtype, device=device), per_node)

    # -- oracle ops (delegated) --------------------------------------------
    def grad(self, rnd, x, data=None, size: int = 1):
        return self.oracle.grad(rnd, x, data, size)

    def grad_pair(self, rnd, x_new, x_old, size: int, data=None):
        return self.oracle.grad_pair(rnd, x_new, x_old, size, data)

    def grad_diff(self, rnd, x_new, x_old, size: int, data=None):
        return self.oracle.grad_diff(rnd, x_new, x_old, size, data)

    def megabatch(self, rnd, x, size: int, data=None):
        return self.oracle.megabatch(rnd, x, size, data)

    def grad_minibatch(self, rnd, x, size: int, data=None):
        return self.oracle.grad_minibatch(rnd, x, size, data)

    # -- arithmetic --------------------------------------------------------
    def lin(self, fn: Callable, *trees):
        sdt = self.state_dtype
        return tree.map_leaves(
            lambda *ls: fn(*[l.to(torch.float32) for l in ls]).to(sdt),
            *trees)

    def mean_nodes(self, per_node):
        return tree.map_leaves(node_mean, per_node)

    def add_server(self, g, agg):
        return tree.map_leaves(torch.add, g, agg)

    def sub_deficit(self, g, deficit):
        """Leaf-wise g - deficit (the asynchronous in-flight correction,
        DESIGN.md §14)."""
        return tree.map_leaves(torch.subtract, g, deficit)

    def zeros_per_node(self, x0):
        return tree.map_leaves(lambda p: torch.zeros(
            (self.n,) + tuple(p.shape), dtype=self.state_dtype,
            device=p.device), x0)

    def dense_coords(self, per_node_tree) -> float:
        return sum(_leaf_size(l) for l in tree.leaves(per_node_tree))

    # -- server ------------------------------------------------------------
    def init_opt(self, x0):
        return self.server_opt.init(x0)

    def server_update(self, x, g, opt_state, hp):
        updates, opt_state = self.server_opt.update(g, opt_state, x)
        return apply_updates(x, updates), opt_state

    # -- compression -------------------------------------------------------
    def estimator_update_full(self, rnd, h_new, h, g_local, a: float,
                              aux=None):
        """(aggregate, h_out, g_local_new, payload per node, messages,
        participation): the tree path exposes no per-node messages and has
        full participation, so the last two are None."""
        agg, h_out, gl, payload = self.comp.estimator_update(
            rnd, h_new, h, g_local, a, aux)
        return agg, h_out, gl, payload, None, None

    # -- metrics -----------------------------------------------------------
    def default_metric(self):
        def metric(s):
            return sum(torch.sum(torch.square(x)) for x in tree.leaves(s.g))
        return metric


@dataclasses.dataclass(frozen=True)
class LaneTreeSubstrate(TreeSubstrate):
    """G lanes of a :class:`TreeSubstrate` side by side, for a sweep (the
    reference's vmapped ``sweep`` over a tree method): every state leaf
    carries a leading (G,) lane axis, so the iterate and server estimator
    are (G, *shape), the per-node fields (G, n, *shape) and Adam's moments
    (G, *shape); its step count and the round seed are shared.

    * the oracle takes each lane's gradients on every node's batch (the
      lanes share the round's batch, as G sequential runs from one data
      seed draw the same ones);
    * the round draws ONE mask per leaf, shared by every lane, and the
      fused path launches its kernel once per leaf over all G * n rows;
    * a hyperparameter that varies by lane is a
      :class:`repro_torch.methods.lanes.Lanes`: the stepsize enters the
      server optimizer's learning rate (``Adam(lr=Lanes)``), ``a`` and
      ``b`` the rules' arithmetic, or on the kernel path the kernels'
      per-lane arguments (row r of the G * n rows reads lane r // n).

    Lane j is then a sequential run at ``values[j]``: the same masks and
    batches, the same floats up to the last ulp.
    """

    lanes: int = 1

    def with_lanes(self, lanes: int) -> "LaneTreeSubstrate":
        return dataclasses.replace(self, lanes=int(lanes))

    # -- oracle ops (every lane on the round's batch) ---------------------
    def grad(self, rnd, x, data=None, size: int = 1):
        return self.oracle.grad(rnd, x, data, size, lanes=self.lanes)

    def grad_pair(self, rnd, x_new, x_old, size: int, data=None):
        return self.oracle.grad_pair(rnd, x_new, x_old, size, data,
                                     lanes=self.lanes)

    def grad_diff(self, rnd, x_new, x_old, size: int, data=None):
        return self.oracle.grad_diff(rnd, x_new, x_old, size, data,
                                     lanes=self.lanes)

    def megabatch(self, rnd, x, size: int, data=None):
        return self.oracle.megabatch(rnd, x, size, data, lanes=self.lanes)

    def grad_minibatch(self, rnd, x, size: int, data=None):
        return self.oracle.grad_minibatch(rnd, x, size, data,
                                          lanes=self.lanes)

    # -- arithmetic --------------------------------------------------------
    def mean_nodes(self, per_node):
        return tree.map_leaves(lambda h: torch.mean(h.to(torch.float32), 1),
                               per_node)

    def sub_deficit(self, g, deficit):
        raise ValueError("deficit= (asynchronous rounds) has no lane form: "
                         "the simulators run one method, not a sweep")

    def dense_coords(self, per_node_tree) -> float:
        return sum(_leaf_size(l, lanes=True)
                   for l in tree.leaves(per_node_tree))

    # -- compression -------------------------------------------------------
    def estimator_update_full(self, rnd, h_new, h, g_local, a: float,
                              aux=None):
        agg, h_out, gl, payload = self.comp.estimator_update(
            rnd, h_new, h, g_local, a, aux, lanes=True)
        return agg, h_out, gl, payload, None, None

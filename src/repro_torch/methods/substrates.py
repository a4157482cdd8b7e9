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
  :class:`BatchLossOracle` and compression through
  :class:`TreeCompression` (:mod:`repro_torch.compress.treelevel`).

Randomness reaches a substrate as the round's
:class:`repro_torch.core.rng.RoundRandom` in place of the reference's key.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.func import grad as func_grad
from torch.func import vmap

from repro_torch.compress.backends import (RoundCompressor,
                                           estimator_update_with_plan)
from repro_torch.compress.spec import omega_participation
from repro_torch.compress.treelevel import (bernoulli_compress,
                                            fused_leaf_updates,
                                            permk_compress)
from repro_torch.core import rng, tree
from repro_torch.methods.rules import MvrFusion
from repro_torch.optim.base import apply_updates


# ---------------------------------------------------------------------------
# shared oracle semantics over the Section 1.2 problem classes
# ---------------------------------------------------------------------------

def _problem_grad(problem, rnd, x, size):
    """Finite-sum: the exact nabla f_i; stochastic: a fresh size-B batch."""
    if hasattr(problem, "full_grad"):
        return problem.full_grad(x)
    return problem.stoch_grad(x, rnd.samples(problem, size))


def _problem_grad_pair(problem, rnd, x_new, x_old, size):
    """Same-sample gradients at two points (MVR / SARAH)."""
    samples = rnd.samples(problem, size)
    if hasattr(problem, "stoch_grad_pair"):
        return problem.stoch_grad_pair(x_new, x_old, samples)
    return (problem.minibatch_grad(x_new, samples),
            problem.minibatch_grad(x_old, samples))


def _problem_grad_diff(problem, rnd, x_new, x_old, size):
    """Shared-sample difference (PAGE / MARINA).  ``size == 0`` requests the
    exact full-gradient difference (plain MARINA on finite sums)."""
    if hasattr(problem, "minibatch_diff"):
        if size == 0:
            return problem.full_grad(x_new) - problem.full_grad(x_old)
        return problem.minibatch_diff(x_new, x_old,
                                      rnd.samples(problem, size))
    gn, go = problem.stoch_grad_pair(x_new, x_old,
                                     rnd.samples(problem, size))
    return gn - go


def _problem_megabatch(problem, rnd, x, size):
    """The sync round's dense upload: exact gradient when the oracle has
    one, else a fresh B' megabatch."""
    if hasattr(problem, "full_grad"):
        return problem.full_grad(x)
    return problem.stoch_grad(x, rnd.samples(problem, size, tag="sync"))


def _problem_grad_minibatch(problem, rnd, x, size):
    """An honest size-B minibatch gradient on either oracle (the Cor.
    6.8/6.10 B_init initialisation)."""
    samples = rnd.samples(problem, size, tag="init")
    if hasattr(problem, "stoch_grad"):
        return problem.stoch_grad(x, samples)
    return problem.minibatch_grad(x, samples)


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

    def with_compressor(self, comp: RoundCompressor) -> "FlatSubstrate":
        return dataclasses.replace(self, rc=comp)

    def place(self, x, device) -> torch.Tensor:
        """An iterate (or per-node rows) as float32 on ``device``."""
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    place_per_node = place

    # -- oracle ops --------------------------------------------------------
    def grad(self, rnd, x, data=None, size: int = 1):
        return _problem_grad(self.problem, rnd, x, size)

    def grad_pair(self, rnd, x_new, x_old, size: int, data=None):
        return _problem_grad_pair(self.problem, rnd, x_new, x_old, size)

    def grad_diff(self, rnd, x_new, x_old, size: int, data=None):
        return _problem_grad_diff(self.problem, rnd, x_new, x_old, size)

    def megabatch(self, rnd, x, size: int, data=None):
        return _problem_megabatch(self.problem, rnd, x, size)

    def grad_minibatch(self, rnd, x, size: int, data=None):
        return _problem_grad_minibatch(self.problem, rnd, x, size)

    # -- arithmetic --------------------------------------------------------
    def lin(self, fn: Callable, *tensors):
        return fn(*tensors)

    def mean_nodes(self, per_node):
        return per_node.mean(0)

    def add_server(self, g, agg):
        return g + agg

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
        msgs, h_out, gl = estimator_update_with_plan(
            self.rc.backend, plan, h_new, h, g_local, a)
        present = None
        if self.rc.spec.p_participate < 1.0:
            # a zero scale row IS an absent node
            present = torch.ravel(plan.scale) != 0
        return (msgs.mean(), h_out, gl, self.rc.payload_per_node, msgs,
                present)

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


def _rows_stoch_grad(problem, x, xi, rows):
    """Row-restricted ``StochasticProblem.stoch_grad``: each cohort row's
    gradient with its global client id as the node index (the same xi give
    the same-sample pair of MVR)."""
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

    # -- node-axis windowing ----------------------------------------------
    def gather_nodes(self, per_node):
        idx = self.sel if self.loc is None else self.loc
        return per_node.index_select(0, idx)

    def scatter_nodes(self, full, rows):
        if self.loc is None:
            return full.index_copy(0, self.sel, rows)
        return full.index_copy_(0, self.loc, rows)

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
        return _rows_stoch_grad(p, x, xi, self.sel)

    # -- oracle ops (cohort rows only) ------------------------------------
    def grad(self, rnd, x, data=None, size: int = 1):
        if hasattr(self.base.problem, "full_grad"):
            return self._rows_problem().full_grad(x)
        return self._stoch(rnd, x, size, "h")

    def grad_pair(self, rnd, x_new, x_old, size: int, data=None):
        p = self.base.problem
        if hasattr(p, "stoch_grad_pair"):
            xi = rnd.client_samples(p, size, self.clients)
            return (_rows_stoch_grad(p, x_new, xi, self.sel),
                    _rows_stoch_grad(p, x_old, xi, self.sel))
        return _problem_grad_pair(self._rows_problem(), rnd, x_new, x_old,
                                  size)

    def grad_diff(self, rnd, x_new, x_old, size: int, data=None):
        if hasattr(self.base.problem, "minibatch_diff"):
            return _problem_grad_diff(self._rows_problem(), rnd, x_new,
                                      x_old, size)
        gn, go = self.grad_pair(rnd, x_new, x_old, size, data)
        return gn - go

    def megabatch(self, rnd, x, size: int, data=None):
        if hasattr(self.base.problem, "full_grad"):
            return self._rows_problem().full_grad(x)
        return self._stoch(rnd, x, size, "sync")

    def grad_minibatch(self, rnd, x, size: int, data=None):
        if hasattr(self.base.problem, "stoch_grad"):
            return self._stoch(rnd, x, size, "init")
        return _problem_grad_minibatch(self._rows_problem(), rnd, x, size)

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
        msgs, h_out, gl = estimator_update_with_plan(
            rc.backend, plan, h_new, h, g_local, a)
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


# ---------------------------------------------------------------------------
# tree oracle
# ---------------------------------------------------------------------------

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
    """

    loss_fn: Callable[[Any, Any], torch.Tensor]
    state_dtype: torch.dtype = torch.float32

    def per_node_grads(self, params, data):
        paths, leaves = zip(*tree.items(params))
        n = tree.leaves(data)[0].shape[0]
        out = [torch.empty((n,) + tuple(p.shape), dtype=self.state_dtype,
                           device=p.device) for p in leaves]
        for i in range(n):
            ps = [p.detach().requires_grad_(True) for p in leaves]
            node_batch = tree.map_leaves(lambda x: x[i], data)
            with torch.enable_grad():
                loss = self.loss_fn(tree.from_items(zip(paths, ps)),
                                    node_batch)
                grads = torch.autograd.grad(loss, ps)
            for buf, g in zip(out, grads):
                buf[i].copy_(g)
        return tree.from_items(zip(paths, out))

    def grad(self, rnd, x, data, size: int = 1):
        return self.per_node_grads(x, data)

    def grad_pair(self, rnd, x_new, x_old, size: int, data):
        return (self.per_node_grads(x_new, data),
                self.per_node_grads(x_old, data))

    def grad_diff(self, rnd, x_new, x_old, size: int, data):
        gn, go = self.grad_pair(rnd, x_new, x_old, size, data)
        return tree.map_leaves(
            lambda a, b: (a.to(torch.float32)
                          - b.to(torch.float32)).to(self.state_dtype),
            gn, go)

    def megabatch(self, rnd, x, size: int, data):
        return self.per_node_grads(x, data)

    def grad_minibatch(self, rnd, x, size: int, data):
        return self.per_node_grads(x, data)


# ---------------------------------------------------------------------------
# tree compression
# ---------------------------------------------------------------------------

def _leaf_size(leaf) -> float:
    sz = 1.0
    for s in leaf.shape[1:]:
        sz *= s
    return sz


@dataclasses.dataclass(frozen=True)
class TreeCompression:
    """Tree-native compression: the trainer's mode knob over
    :mod:`repro_torch.compress.treelevel` (fused-capable)."""

    mode: str = "independent"     # independent | shared_coords | permk
    p: float = 1.0                # Bernoulli-RandP keep probability
    n: int = 1
    use_kernel: bool = False

    @property
    def static_frac(self) -> float:
        """Payload / dense, per node (the trainer's payload_frac metric)."""
        return 1.0 / self.n if self.mode == "permk" else self.p

    def payload_per_node(self, per_node_tree) -> float:
        return sum(self.static_frac * _leaf_size(l)
                   for l in tree.leaves(per_node_tree))

    def estimator_update(self, rnd, h_new, h, g_local, a: float, aux=None):
        """Returns (aggregate, h_out, g_local_new, payload per node).  The
        kernel path reduces each leaf's messages to their mean as soon as
        its kernel has run, so the (n, *shape) messages of the whole tree
        never exist at once.  ``h_new`` is None when the MVR h-update is
        left to the kernel; ``aux`` is then the round's :class:`MvrFusion`,
        whose two gradient trees this path consumes: each leaf is released
        once its kernel has read it, so they never coexist with all of the
        round's outputs."""
        f32 = torch.float32
        if self.use_kernel:
            fusion = aux if isinstance(aux, MvrFusion) else None
            if fusion is not None:
                leaves = fused_leaf_updates(
                    rnd, fusion.grads_new, h, g_local, mode=self.mode, a=a,
                    p=self.p, n=self.n, variant="mvr", b=fusion.b,
                    grads_old=fusion.grads_old)
            else:
                leaves = fused_leaf_updates(
                    rnd, h_new, h, g_local, mode=self.mode, a=a, p=self.p,
                    n=self.n, variant="dasha")
            aggs, h_outs, gls = [], [], []
            for path, m, hn, gl in leaves:
                aggs.append((path, torch.mean(m.to(f32), 0)))
                h_outs.append((path, hn))
                gls.append((path, gl))
                if fusion is not None:
                    tree.release(fusion.grads_new, path)
                    tree.release(fusion.grads_old, path)
            return (tree.from_items(aggs), tree.from_items(h_outs),
                    tree.from_items(gls), self.payload_per_node(h))

        delta = tree.map_leaves(lambda hn, hh, gl_: hn - hh - a * (gl_ - hh),
                                h_new, h, g_local)
        if self.mode == "permk":
            m, agg = permk_compress(rnd, delta, self.n)
        else:
            m = bernoulli_compress(rnd, delta, self.p,
                                   shared=self.mode == "shared_coords")
            agg = tree.map_leaves(lambda mm: torch.mean(mm.to(f32), 0), m)
        gl_new = tree.map_leaves(torch.add, g_local, m)
        return agg, h_new, gl_new, self.payload_per_node(h_new)


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
    comp: Optional[TreeCompression] = None

    def with_compressor(self, comp) -> "TreeSubstrate":
        if not isinstance(comp, TreeCompression):
            raise NotImplementedError(
                "registry compressors on the tree path (the reference's "
                "LeafSpecCompressor) are not ported yet; pass a "
                "TreeCompression")
        return dataclasses.replace(self, comp=comp)

    @property
    def fuses_mvr(self) -> bool:
        """The fused kernel recomputes the MVR h-update in its own pass."""
        return self.comp is not None and self.comp.use_kernel

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
        return tree.map_leaves(lambda h: torch.mean(h.to(torch.float32), 0),
                               per_node)

    def add_server(self, g, agg):
        return tree.map_leaves(torch.add, g, agg)

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

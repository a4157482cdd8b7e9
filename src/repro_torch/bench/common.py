"""Shared plumbing of the port's paper benchmarks (port of
``benchmarks/common.py``): the paper's synthetic problems, stepsize tunes
as one sweep each, CSV emission.

Problems are made on ``device`` (default the card; raises without one)
from the port's seeded generators, with the reference's seeds.  Torch's
generators cannot replay JAX's, so the data are another draw of the same
distributions, and a figure's numbers are another sample of the
reference's, not the same numbers.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import grad

from repro_torch.compress import RoundCompressor, make_round_compressor
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.oracles import FiniteSumProblem, StochasticProblem
from repro_torch.data.pipeline import synthetic_classification
from repro_torch.methods import (FlatSubstrate, Hyper, Method, Sweeper,
                                 lane_metric)

N_NODES = 5          # the paper uses 5 nodes throughout Appendix A


def randk_compressor(d: int, k: int, n: int = N_NODES, *,
                     mode: str = "independent", backend: str = "dense",
                     device=DEFAULT_DEVICE) -> RoundCompressor:
    """The figure benches' standard compressor, on any execution backend."""
    return make_round_compressor("randk", d, n, k=k, mode=mode,
                                 backend=backend, device=device)


def build_method(variant: str, problem, comp: RoundCompressor,
                 hyper: Hyper) -> Method:
    """One entrypoint for every figure: variant rule x compressor x the
    flat (n, d) substrate (DESIGN.md §7).  A Hyper holding per-lane values
    builds the sweep's G-lane method."""
    sub = FlatSubstrate(problem=problem, n=comp.n, d=comp.spec.d)
    return Method.build(variant, comp, sub, hyper)


def glm_loss(x, a, y):
    """The nonconvex GLM loss of the paper's A.1/A.2 experiments."""
    return (1.0 - 1.0 / (1.0 + torch.exp(y * torch.dot(a, x)))) ** 2


def glm_problem(d: int = 60, m: int = 64, key: int = 0, *,
                device=DEFAULT_DEVICE) -> FiniteSumProblem:
    """Nonconvex GLM classification (paper A.1/A.2), synthetic stand-in for
    mushrooms / real-sim."""
    feats, labels = synthetic_classification(key, N_NODES, m, d,
                                             device=device)
    return FiniteSumProblem(loss=glm_loss, features=feats, labels=labels)


def logreg_nonconvex_problem(d: int = 60, m: int = 64, key: int = 1,
                             lam: float = 1e-3, sigma: float = 0.3, *,
                             device=DEFAULT_DEVICE) -> StochasticProblem:
    """Logistic regression + nonconvex regularizer (paper A.3) with additive
    gradient noise standing in for the sampling noise.

    The loss reads node i's rows with ``index_select`` on the node axis:
    under vmap ``i`` is a 0-d tensor, which has a batching rule there and
    cannot become a Python int.  ``-log sigmoid(t)`` is written
    ``softplus(-t)``: on the card ``log_sigmoid_forward`` returns an empty
    buffer that torch 2.11's vmap cannot batch."""
    dev = resolve_device(device)
    feats, labels = synthetic_classification(key, N_NODES, m, d, device=dev)

    def loss(x, xi, i):
        row = torch.reshape(i, (1,))
        a = torch.index_select(feats, 0, row)[0]
        y = torch.index_select(labels, 0, row)[0]
        z = F.softplus(-(y * (a @ x)))
        reg = lam * torch.sum(x * x / (1 + x * x))
        return torch.mean(z) + reg + xi @ x

    def sample(gen, i, batch):
        return sigma * torch.randn((batch, d), generator=gen,
                                   device=dev) / math.sqrt(d)

    zeros = torch.zeros(d, device=dev)
    nodes = [torch.tensor(i, device=dev) for i in range(N_NODES)]

    def full_grad_f(x):
        gfun = grad(lambda xx, i: loss(xx, zeros, i))
        return torch.mean(torch.stack([gfun(x, i) for i in nodes]), 0)

    return StochasticProblem(loss=loss, sample=sample, n=N_NODES,
                             device=dev, true_grad=full_grad_f)


def lipschitz_glm(problem: FiniteSumProblem) -> float:
    """2 x the mean squared feature norm, ``sum(a * a)`` over each row,
    squared one node at a time: the temporary is one node's features, not
    all of them (6.06 GB at the real-sim shape)."""
    a = problem.features
    sq = torch.stack([torch.sum(node * node, -1) for node in a])
    return float(torch.mean(sq) * 2.0)


def theory_hyper(variant: str, omega: float, L: float, *, d: int, k: int,
                 n: int = N_NODES, m: int = 64, B: int = 8,
                 gamma_mult: float = 4.0):
    """The fed bench/tests' per-variant ``Hyper.from_theory`` kwargs table
    in ONE place: mvr-family variants get the stochastic constants, page
    gets the finite-sum pair, sync-round variants get zeta/d for their
    coin probability."""
    kw = {}
    if variant in ("mvr", "sync_mvr"):
        kw = dict(B=B, sigma2=0.1, L_sigma=L)
    if variant == "page":
        kw = dict(B=B, m=m)
    if variant in ("sync_mvr", "marina"):
        kw.update(zeta=float(k), d=d)
    return Hyper.from_theory(variant, omega, n, L=L, gamma_mult=gamma_mult,
                             **kw)


def problem_metric(problem):
    """||grad f(x)||^2 from whichever exact gradient the problem exposes,
    as a metric of one lane's state with its lane form attached: a sweep
    evaluates it for all lanes through the problem's lane oracles
    (``grad_f_lanes`` reads the features once for every lane)."""
    if hasattr(problem, "grad_f"):
        return lane_metric(
            lambda s: torch.sum(problem.grad_f(s.x) ** 2),
            lambda s: torch.sum(problem.grad_f_lanes(s.x) ** 2, -1))
    if getattr(problem, "true_grad", None) is not None:
        return lane_metric(
            lambda s: torch.sum(problem.true_grad(s.x) ** 2),
            lambda s: torch.sum(problem.true_grad_lanes(s.x) ** 2, -1))
    raise ValueError("problem exposes no exact gradient for the metric")


def metric_of_state(metric_fn):
    """A ``metric_fn(state)`` as a driver metric ``(state, data)``, its lane
    form kept."""
    lanes = getattr(metric_fn, "lanes", None)
    fn = lambda s, d: metric_fn(s)                      # noqa: E731
    return fn if lanes is None else lane_metric(fn, lambda s, d: lanes(s))


def sweep_tune(method_fn, values, state, rounds, *, metric_fn,
               final_of=None, chunk: int = None) -> Dict:
    """Paper protocol (Appendix A): fine-tune the stepsize over powers of
    two, keep the run with the best final metric — ONE sweep of G lanes
    (:class:`repro_torch.methods.Sweeper`) on the state's device.

    ``method_fn(value) -> Method`` (value may be the gammas or a dict like
    ``{"gamma": ..., "b": ...}``); ``state`` is the shared init state;
    ``final_of(trace_row) -> float`` selects the figure's summary statistic
    (default: the last trace entry)."""
    _, traces = Sweeper(method_fn, metrics={
        "metric": metric_of_state(metric_fn)}, chunk=chunk).run(
        values, state, rounds, device=state.x.device)
    tr = np.asarray(traces["metric"], np.float64)
    bits = np.asarray(traces["bits_sent"])
    finals = np.array([(final_of(row) if final_of else row[-1])
                       for row in tr])
    finite = np.isfinite(finals)
    if not finite.any():
        return {"final": float("nan"), "gamma": None}
    i = int(np.argmin(np.where(finite, finals, np.inf)))
    axis = values["gamma"] if isinstance(values, dict) and \
        "gamma" in values else (values if not isinstance(values, dict)
                                else next(iter(values.values())))
    return {"final": float(finals[i]), "gamma": float(axis[i]),
            "trace": tr[i], "bits": bits[i], "index": i}


def tune_gamma(run_fn, gammas) -> Dict:
    """Sequential legacy tune (one run per gamma); prefer
    :func:`sweep_tune`, which runs the whole grid as one sweep."""
    best = None
    for g in gammas:
        out = run_fn(g)
        if not math.isfinite(float(out["final"])):
            continue
        if best is None or out["final"] < best["final"]:
            best = dict(out, gamma=g)
    return best or {"final": float("nan"), "gamma": None}


def scaled(rounds: int, rounds_scale: float) -> int:
    """A figure's rounds times ``rounds_scale`` (CPU smoke runs), at least
    one."""
    return max(int(rounds * rounds_scale), 1)


def emit(rows: List[Dict]) -> None:
    if not rows:
        return
    keys = list(rows[0].keys())
    print(",".join(keys))
    for r in rows:
        print(",".join(str(r.get(k, "")) for k in keys))

"""Figures 5-8 (Appendix I): tightness of the DASHA-MVR analysis on the
synthetic stochastic quadratic under PL (port of
``benchmarks/fig5_quadratic_pl.py``).  Two momentum choices:

* b_theory = min{ (1/w) sqrt(mu n eps B / s2), mu n eps B / s2 }  (Cor. H.16)
  -> converges to the requested eps but slower;
* b_large  = min{ 1/w, mu n eps B / s2 }
  -> converges as fast as DASHA-SYNC-MVR but to a LARGER floor.

The measured floors must order accordingly (that ordering is the paper's
evidence the analysis is tight).  Both settings run as one sweep over the
{gamma, b} axis.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.bench.common import (build_method, emit, metric_of_state,
                                      problem_metric, randk_compressor,
                                      scaled)
from repro_torch.core import theory
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.oracles import StochasticProblem
from repro_torch.data.pipeline import synthetic_quadratic
from repro_torch.methods import Hyper, Sweeper

D, K, ROUNDS, B = 256, 2, 3000, 1
MU, SIGMA2 = 1.0, 1.0
RATIO = 1e3          # sigma^2 / (mu n eps B)


def _problem(device) -> StochasticProblem:
    dev = resolve_device(device)
    A, b_vec = synthetic_quadratic(0, D, mu=MU, L=2.0, device=dev)
    sig = math.sqrt(SIGMA2 / D)

    def loss(x, xi, i):
        return 0.5 * x @ A @ x - b_vec @ x + xi @ x

    def sample(gen, i, batch):
        return sig * torch.randn((batch, D), generator=gen, device=dev)

    def true_grad(x):
        return A @ x - b_vec

    return StochasticProblem(loss=loss, sample=sample, n=1, device=dev,
                             true_grad=true_grad)


def run(*, device=DEFAULT_DEVICE, rounds_scale: float = 1.0):
    rounds = scaled(ROUNDS, rounds_scale)
    problem = _problem(device)
    comp = randk_compressor(D, K, n=1, device=device)
    omega = comp.omega
    eps = SIGMA2 / (MU * 1 * RATIO * B)
    b_theory = theory.mvr_b(omega, 1, B, MU * eps, SIGMA2)   # Cor. H.16 form
    b_large = min(1.0 / omega, 1.0)

    names = ["b_theory", "b_large"]
    bs = [b_theory, b_large]
    gs = [theory.gamma_dasha_mvr(2.0, 2.0, 2.0, omega, 1, B, b) * 4
          for b in bs]

    def method_fn(v):
        hp = Hyper(gamma=v["gamma"], a=theory.momentum_a(omega),
                   variant="mvr", b=v["b"], batch=B)
        return build_method("mvr", problem, comp, hp)

    st = method_fn({"gamma": 0.0, "b": 0.0}).init(
        torch.zeros(D, device=problem.device), 1, device=problem.device,
        init_mode="stoch", batch_init=64)
    metric = metric_of_state(problem_metric(problem))
    _, traces = Sweeper(method_fn, metrics={"metric": metric}).run(
        {"gamma": np.array(gs), "b": np.array(bs)}, st, rounds,
        device=problem.device)
    rows = []
    for i, name in enumerate(names):
        floor = float(np.mean(traces["metric"][i, -300:]))
        rows.append({"bench": "fig5_quadratic_pl", "momentum": name,
                     "b": round(bs[i], 6), "gamma": round(gs[i], 5),
                     "grad_sq_floor": floor})
    # tightness: larger b converges to a higher noise floor
    ok = rows[1]["grad_sq_floor"] >= rows[0]["grad_sq_floor"]
    rows.append({"bench": "fig5_quadratic_pl", "momentum": "floor_ordering",
                 "b": "", "gamma": "", "grad_sq_floor": "ok" if ok else "X"})
    return rows


if __name__ == "__main__":
    emit(run())

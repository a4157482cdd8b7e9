"""Figure 1: gradient setting — DASHA vs MARINA on the nonconvex GLM,
communication (coords sent per node) to reach an eps-stationary point
(port of ``benchmarks/fig1_gradient.py``).

Paper claim: DASHA converges ~2x faster in communication.  Each 8-gamma
stepsize tune is one sweep.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench.common import (N_NODES, build_method, emit,
                                      glm_problem, lipschitz_glm,
                                      problem_metric, randk_compressor,
                                      scaled, sweep_tune)
from repro_torch.core import theory
from repro_torch.core.device import DEFAULT_DEVICE
from repro_torch.methods import Hyper

D, K, ROUNDS = 60, 10, 800
TARGET_FRAC = 0.02     # eps = 2% of ||grad f(x0)||^2


def bits_to_target(trace, bits, target) -> float:
    """Coords sent per node when the trace first reaches ``target``, inf if
    it never does."""
    hit = np.nonzero(np.asarray(trace) <= target)[0]
    return float(np.asarray(bits)[hit[0]]) if len(hit) else float("inf")


def run(*, device=DEFAULT_DEVICE, rounds_scale: float = 1.0):
    rounds = scaled(ROUNDS, rounds_scale)
    problem = glm_problem(D, device=device)
    comp = randk_compressor(D, K, device=device)
    L = lipschitz_glm(problem)
    x0 = torch.zeros(D, device=problem.device)
    g0 = float(torch.sum(problem.grad_f(x0) ** 2))
    target = TARGET_FRAC * g0
    gammas = np.array([theory.gamma_dasha(L, L, comp.omega, N_NODES) * 2 ** i
                       for i in range(0, 8)])

    def method_fn(variant, **kw):
        # gamma is the sweep's Lanes inside method_fn, a float outside
        return lambda gamma: build_method(
            variant, problem, comp,
            Hyper(gamma=gamma, a=theory.momentum_a(comp.omega),
                  variant=variant, **kw))

    def init_state(variant, **kw):
        return method_fn(variant, **kw)(0.0).init(x0, 1,
                                                  device=problem.device)

    metric = problem_metric(problem)
    best_d = sweep_tune(method_fn("dasha"), gammas, init_state("dasha"),
                        rounds, metric_fn=metric)
    # batch=0: exact full-gradient differences (plain MARINA)
    mar = dict(p=theory.marina_p(K, D), batch=0)
    best_m = sweep_tune(method_fn("marina", **mar), gammas,
                        init_state("marina", **mar), rounds,
                        metric_fn=metric)
    rows = []
    for name, best in [("dasha", best_d), ("marina", best_m)]:
        rows.append({
            "bench": "fig1_gradient", "method": name,
            "gamma": best["gamma"],
            "grad_sq_final": best["final"],
            "coords_to_eps": bits_to_target(best["trace"], best["bits"],
                                            target),
            "rounds": rounds, "k": K, "d": D, "n": N_NODES})
    speedup = rows[1]["coords_to_eps"] / max(rows[0]["coords_to_eps"], 1e-9)
    rows.append({"bench": "fig1_gradient",
                 "method": "speedup_dasha_over_marina",
                 "gamma": "", "grad_sq_final": "",
                 "coords_to_eps": round(speedup, 3), "rounds": "", "k": "",
                 "d": "", "n": ""})
    return rows


if __name__ == "__main__":
    emit(run())

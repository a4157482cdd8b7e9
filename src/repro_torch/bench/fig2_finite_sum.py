"""Figure 2: finite-sum setting — DASHA-PAGE vs VR-MARINA (B=1) for several
RandK K values (port of ``benchmarks/fig2_finite_sum.py``).  Paper claim:
DASHA-PAGE converges faster; the gap closes for large K (the
1+omega/sqrt(n) term dominates).

Each 8-gamma stepsize tune is one sweep."""
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

D, M, ROUNDS, B = 60, 64, 1200, 1


def run(*, device=DEFAULT_DEVICE, rounds_scale: float = 1.0):
    rounds = scaled(ROUNDS, rounds_scale)
    problem = glm_problem(D, M, key=2, device=device)
    L = lipschitz_glm(problem)
    metric = problem_metric(problem)
    x0 = torch.zeros(D, device=problem.device)
    tail = lambda row: float(np.mean(row[-50:]))          # noqa: E731
    rows = []
    for K in (2, 10, 30):
        comp = randk_compressor(D, K, device=device)
        p = theory.page_p(B, M)

        def mfn_page(gamma):
            return build_method("page", problem, comp,
                                Hyper(gamma=gamma,
                                      a=theory.momentum_a(comp.omega),
                                      variant="page", p=p, batch=B))

        def mfn_marina(gamma):
            # VR-MARINA: shared-sample minibatch difference (batch=B)
            return build_method("marina", problem, comp,
                                Hyper(gamma=gamma, a=0.0, variant="marina",
                                      p=theory.marina_p(K, D), batch=B))

        base = theory.gamma_dasha_page(L, L, L, comp.omega, N_NODES, B, p)
        gammas = np.array([base * 2 ** i for i in range(0, 8)])
        st_p = mfn_page(0.0).init(x0, 1, device=problem.device)
        st_m = mfn_marina(0.0).init(x0, 1, device=problem.device)
        best_p = sweep_tune(mfn_page, gammas, st_p, rounds,
                            metric_fn=metric, final_of=tail)
        best_m = sweep_tune(mfn_marina, gammas, st_m, rounds,
                            metric_fn=metric, final_of=tail)
        rows.append({"bench": "fig2_finite_sum", "k": K,
                     "method": "dasha_page", "gamma": best_p["gamma"],
                     "grad_sq_tail": best_p["final"],
                     "coords_sent": float(best_p["bits"][-1])})
        rows.append({"bench": "fig2_finite_sum", "k": K,
                     "method": "vr_marina", "gamma": best_m["gamma"],
                     "grad_sq_tail": best_m["final"],
                     "coords_sent": float(best_m["bits"][-1])})
    return rows


if __name__ == "__main__":
    emit(run())

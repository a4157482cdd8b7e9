"""Figure 3: stochastic setting — DASHA-MVR / DASHA-SYNC-MVR / VR-MARINA
(online), B=1, parameters tied to the common ratio sigma^2/(n eps B) as in
the paper (footnote 4); port of ``benchmarks/fig3_stochastic.py``.

Each 9-gamma stepsize tune is one sweep."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench.common import (N_NODES, build_method, emit,
                                      logreg_nonconvex_problem,
                                      problem_metric, randk_compressor,
                                      scaled, sweep_tune)
from repro_torch.core import theory
from repro_torch.core.device import DEFAULT_DEVICE
from repro_torch.methods import Hyper

D, ROUNDS, B = 60, 1500, 1
SIGMA2 = 0.09        # additive-noise variance (see common.py)


def run(*, device=DEFAULT_DEVICE, rounds_scale: float = 1.0):
    rounds = scaled(ROUNDS, rounds_scale)
    problem = logreg_nonconvex_problem(D, device=device)
    metric = problem_metric(problem)
    x0 = torch.zeros(D, device=problem.device)
    tail = lambda row: float(np.mean(row[-100:]))         # noqa: E731
    rows = []
    for ratio in (1e2, 1e3):          # sigma^2 / (n eps B)
        eps = SIGMA2 / (N_NODES * ratio * B)
        for K in (6, 20):
            comp = randk_compressor(D, K, device=device)
            omega = comp.omega
            b = theory.mvr_b(omega, N_NODES, B, eps, SIGMA2)
            p_sync = theory.sync_mvr_p(K, D, N_NODES, B, eps, SIGMA2)
            p_mar = min(K / D, N_NODES * eps * B / SIGMA2)

            def mfn(variant, **kw):
                return lambda gamma: build_method(
                    variant, problem, comp,
                    Hyper(gamma=gamma, a=theory.momentum_a(omega),
                          variant=variant, batch=B, **kw))

            cases = [
                ("dasha_mvr", mfn("mvr", b=b),
                 dict(init_mode="stoch",
                      batch_init=max(int(B / max(b, 1e-3)), 1))),
                ("dasha_sync_mvr", mfn("sync_mvr", p=p_sync, batch_sync=32),
                 dict(init_mode="stoch", batch_init=32)),
                # VR-MARINA (online): stochastic same-sample pair oracle
                ("vr_marina_online",
                 lambda gamma: build_method(
                     "marina", problem, comp,
                     Hyper(gamma=gamma, a=0.0, variant="marina", p=p_mar,
                           batch=B, batch_sync=32)),
                 dict(init_mode="stoch", batch_init=64)),
            ]
            gamma0 = theory.gamma_dasha_mvr(2.0, 2.0, 1.0, omega, N_NODES,
                                            B, b)
            gammas = np.array([gamma0 * 2 ** i for i in range(0, 9)])
            for name, method_fn, init_kw in cases:
                st = method_fn(0.0).init(x0, 1, device=problem.device,
                                         **init_kw)
                best = sweep_tune(method_fn, gammas, st, rounds,
                                  metric_fn=metric, final_of=tail)
                rows.append({"bench": "fig3_stochastic", "ratio": ratio,
                             "k": K, "method": name, "gamma": best["gamma"],
                             "grad_sq_tail": best["final"],
                             "coords_sent": float(best["bits"][-1])})
    return rows


if __name__ == "__main__":
    emit(run())

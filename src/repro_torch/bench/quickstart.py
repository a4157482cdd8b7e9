"""Quickstart: DASHA (Algorithm 1) on a nonconvex classification problem
(port of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.bench.quickstart [--device cpu]

Five nodes, RandK compression, theory hyperparameters — the gradient-setting
experiment of the paper (Appendix A.1) at laptop scale, through the
one-method API (DESIGN.md §7): pick a variant rule, a compressor, a state
substrate, and let ``Hyper.from_theory`` assemble the Section-6 constants.
The run goes through the chunked driver, which returns NAMED traces
(``traces["grad_sq"]``, ``traces["bits_sent"]``).

``REPRO_EXAMPLE_ROUNDS`` shrinks the run for smoke jobs; ``--device``
defaults to the card.
"""
from __future__ import annotations

import argparse
import os

import torch

from repro_torch.compress import make_round_compressor
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.oracles import FiniteSumProblem
from repro_torch.data.pipeline import synthetic_classification
from repro_torch.methods import Driver, FlatSubstrate, Hyper, Method

N_NODES, M, D, K = 5, 64, 60, 10


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rounds = int(os.environ.get("REPRO_EXAMPLE_ROUNDS", "500"))

    # 1. a problem: f_i held by node i (nonconvex GLM, paper A.1)
    feats, labels = synthetic_classification(0, N_NODES, M, D, device=dev)
    problem = FiniteSumProblem(
        loss=lambda x, a, y: (1 - 1 / (1 + torch.exp(y * torch.dot(a, x))))
        ** 2, features=feats, labels=labels)

    # 2. a compressor per node: RandK in U(d/K - 1), from the spec registry
    comp = make_round_compressor("randk", D, N_NODES, k=K, device=dev)

    # 3. theory hyperparameters (Theorem 6.1), stepsize fine-tuned x16
    L = float(torch.mean(torch.sum(feats ** 2, -1)) * 2)
    hyper = Hyper.from_theory("dasha", comp.omega, N_NODES, L=L,
                              gamma_mult=16)

    # 4. one method = variant rule x compressor x substrate
    method = Method.build("dasha", comp, FlatSubstrate(problem, N_NODES, D),
                          hyper)

    # 5. run: nodes only ever send K floats per round; no synchronization
    x0 = torch.zeros(D, device=dev)
    state = method.init(x0, 1, device=dev)
    state, traces = Driver(method, metrics={
        "grad_sq": lambda s, d: torch.sum(problem.grad_f(s.x) ** 2)}).run(
        state, rounds)

    grad_sq, bits = traces["grad_sq"], traces["bits_sent"]
    for t in range(0, rounds, max(rounds // 5, 1)):
        print(f"round {t:4d}  ||grad f||^2 = {float(grad_sq[t]):.3e}  "
              f"coords sent/node = {float(bits[t]):.0f}")
    g0 = float(torch.sum(problem.grad_f(x0) ** 2))
    print(f"final ||grad f||^2 = {float(grad_sq[-1]):.3e} (vs {g0:.3e} at "
          "x0)")
    return {"grad_sq_final": float(grad_sq[-1]), "grad_sq_x0": g0,
            "bits_sent": float(bits[-1]), "rounds": rounds}


if __name__ == "__main__":
    main()

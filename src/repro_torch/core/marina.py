"""MARINA / VR-MARINA / VR-MARINA (online) baselines over the methods layer
(port of ``repro.core.marina``).

MARINA (Gorbunov et al., 2021) is the fifth rule of the registry: h_i^t =
G_i(x^t) by telescoping the oracle difference, the compressor momentum
forced to a = 0 so the drift is exactly C_i(G_i(x^{t+1}) - G_i(x^t)), and
the probability-p coin for the uncompressed synchronization round:

    g^{t+1} = (1/n) sum_i [ c=1 ?  G_i(x^{t+1})
                                :  g^t + C_i(G_i(x^{t+1}) - G_i(x^t)) ]

The three seed variants map onto the one rule through the oracle:
``marina`` takes exact full-gradient differences (batch = 0), ``vr`` a
shared-sample minibatch difference, ``vr_online`` the stochastic
same-sample pair.
"""
from __future__ import annotations

import dataclasses

from repro_torch.compress import make_round_compressor
from repro_torch.core.device import DEFAULT_DEVICE
from repro_torch.methods import FlatSubstrate, Hyper, Method, MethodState

#: the unified method state; h_local carries G_i(x^t)
MarinaState = MethodState

_VARIANTS = ("marina", "vr", "vr_online")


@dataclasses.dataclass(frozen=True)
class MarinaHyper:
    gamma: float
    p: float                     # sync probability
    variant: str = "marina"      # marina | vr | vr_online
    batch: int = 1
    batch_sync: int = 1          # megabatch B' for the vr_online sync step


def _hyper(hp: MarinaHyper) -> Hyper:
    if hp.variant not in _VARIANTS:
        raise ValueError(hp.variant)
    # batch = 0 asks the oracle for the exact full-gradient difference
    batch = 0 if hp.variant == "marina" else hp.batch
    return Hyper(gamma=hp.gamma, a=0.0, variant="marina", p=hp.p,
                 batch=batch, batch_sync=hp.batch_sync)


def _check_oracle(problem, variant: str) -> None:
    """The seed dispatched on the variant and failed loudly on a
    mismatched oracle; the dispatch now lives in the oracle ops, and so
    does the check."""
    if variant == "vr_online" and not hasattr(problem, "stoch_grad"):
        raise ValueError("variant='vr_online' needs a StochasticProblem-"
                         "style oracle (stoch_grad / stoch_grad_pair)")
    if variant in ("marina", "vr") and not hasattr(problem, "full_grad"):
        raise ValueError(f"variant={variant!r} needs a FiniteSumProblem-"
                         "style oracle (full_grad / minibatch_diff)")


def _method(hp: MarinaHyper, problem, comp, n: int, d: int) -> Method:
    _check_oracle(problem, hp.variant)
    sub = FlatSubstrate(problem=problem, n=n, d=d)
    return Method.build("marina", comp, sub, _hyper(hp))


def init(x0, seed: int, problem, *, device=DEFAULT_DEVICE) -> MarinaState:
    """h_i^0 = g_i^0 = G_i(x^0): the exact gradient of a finite-sum
    problem, else a size-64 minibatch, on ``device`` (default the card)."""
    n = problem.n
    d = x0.shape[0]
    sub = FlatSubstrate(problem=problem, n=n, d=d)
    m = Method.build("marina",
                     make_round_compressor("identity", d, n, device=device),
                     sub, Hyper(gamma=0.0, a=0.0, variant="marina"))
    mode = "exact" if hasattr(problem, "full_grad") else "stoch"
    return m.init(x0, seed, device=device, init_mode=mode, batch_init=64)


def step(state: MarinaState, hp: MarinaHyper, problem, comp, *,
         draws=None) -> MarinaState:
    """One MARINA round; ``draws`` injects its randomness."""
    n, d = state.g_local.shape
    return _method(hp, problem, comp, n, d).step_full(state,
                                                      draws=draws)[0]


def run(state: MarinaState, hp: MarinaHyper, problem, comp,
        num_rounds: int, metric_fn=None):
    n, d = state.g_local.shape
    return _method(hp, problem, comp, n, d).run(state, num_rounds,
                                                metric_fn=metric_fn)

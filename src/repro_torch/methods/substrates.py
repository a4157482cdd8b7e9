"""The flat state substrate (port of ``repro.methods.substrates``,
``FlatSubstrate`` and the ``_problem_*`` helpers).

:class:`FlatSubstrate` holds stacked ``(n, d)`` per-node state on one
device and compresses through a
:class:`repro_torch.compress.RoundCompressor` (dense | sparse | fused).
Randomness reaches it as the round's
:class:`repro_torch.core.rng.RoundRandom` in place of the reference's key.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.compress.backends import (RoundCompressor,
                                           estimator_update_with_plan)


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

    def with_compressor(self, comp: RoundCompressor) -> "FlatSubstrate":
        return dataclasses.replace(self, rc=comp)

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

    # -- metrics -----------------------------------------------------------
    def default_metric(self):
        """||grad f(x)||^2 from whichever exact gradient the problem has."""
        p = self.problem
        if hasattr(p, "grad_f"):
            return lambda s: torch.sum(p.grad_f(s.x) ** 2)
        if getattr(p, "true_grad", None) is not None:
            return lambda s: torch.sum(p.true_grad(s.x) ** 2)
        return lambda s: torch.zeros((), device=s.x.device)

"""The variant-rule registry: each method is ONE h-update (Alg. 1 line 8).
Port of ``repro.methods.rules``.

DASHA, DASHA-PAGE, DASHA-MVR and DASHA-SYNC-MVR differ only in how node i
refreshes h_i; MARINA fits the same skeleton with a = 0.  A
:class:`VariantRule` holds that line plus its analytics:

* ``h_update``   — (sub, rnd, hp, x_new, x_old, h, data) -> (h_new, aux),
  where ``rnd`` is the round's :class:`repro_torch.core.rng.RoundRandom`.
  The arithmetic goes through ``sub.lin``, so one rule serves the flat and
  the tree substrates.  ``aux`` may be an :class:`MvrFusion`; when the
  substrate's kernel recomputes the MVR h-update in its own pass
  (``sub.fuses_mvr``), ``h_new`` is None and is never materialised;
* ``sync_update`` — the probability-p dense synchronization round, if any;
* ``force_a``    — overrides the compressor momentum (MARINA: 0);
* ``init_h``     — optional initialisation override, ``(sub, rnd, hp, x0,
  data) -> h0`` (default: the oracle gradient at x^0, Cor. 6.2/6.5);
* ``theory_gamma`` — Section 6 stepsize + derived constants;
* ``extra_payload`` — expected coords/round beyond the compressed message;
* ``sync_requires_all`` — the sync round is a client-synchronization
  barrier.

The port's coins are host booleans, so a rule (and the engine's sync
round) computes only the branch a coin selects; the reference computes
both and where-selects (``sub.where``), with the same result.  A sweep's
per-lane ``p`` gives a (G,) bool array of coins: a round computes a branch
when any lane's coin selects it, and :func:`select_lanes` picks each lane's
branch, so a lane whose coin is down keeps its sequential run's floats.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import theory, tree
from repro_torch.methods.lanes import host_value


class MvrFusion(NamedTuple):
    """Fusion hint: h_new = grads_new + (1-b)(h - grads_old) (SARAH is
    b = 0)."""

    grads_new: Any
    grads_old: Any
    b: float


def _no_extra_payload(hp, payload: float, dense: float) -> float:
    return 0.0


def _sync_extra_payload(hp, payload: float, dense: float) -> float:
    """A probability-p round uploads dense instead of compressed coords."""
    return hp.p * (dense - payload)


@dataclasses.dataclass(frozen=True)
class VariantRule:
    """One method = one h-update + its analytics (see module docstring)."""

    name: str
    h_update: Callable[..., Tuple[Any, Any]]
    sync_update: Optional[Callable[..., Any]] = None
    force_a: Optional[float] = None
    init_h: Optional[Callable[..., Any]] = None
    theory_gamma: Optional[Callable[..., Tuple[float, Dict[str, Any]]]] = None
    extra_payload: Callable[..., float] = _no_extra_payload
    sync_requires_all: bool = False

    @property
    def has_sync(self) -> bool:
        return self.sync_update is not None

    @property
    def pipeline_coin_flush(self) -> bool:
        """Whether a sync-coin round flushes an asynchronous pipeline
        (DESIGN.md §14): true exactly for ``sync_requires_all`` rules.
        Their coin round overwrites the server estimator with the
        all-client dense mean (``g <- mean(h_sync)``), so every pre-coin
        in-flight message is discarded, and the next broadcast waits until
        all n dense sync uploads have landed.  DASHA / PAGE / MVR never
        flush."""
        return self.sync_requires_all

    @property
    def supports_client_sampling(self) -> bool:
        """Whether the rule can run on a sampled-client substrate
        (DESIGN.md §13): a ``sync_requires_all`` barrier is the one
        disqualifier, since a C-of-n cohort can never deliver an all-client
        dense round."""
        return not self.sync_requires_all


VARIANTS: Dict[str, VariantRule] = {}


def register_variant(rule: VariantRule) -> VariantRule:
    VARIANTS[rule.name] = rule
    return rule


def get_rule(variant) -> VariantRule:
    if isinstance(variant, VariantRule):
        return variant
    if variant not in VARIANTS:
        raise ValueError(f"unknown method variant {variant!r}; "
                         f"registered: {sorted(VARIANTS)}")
    return VARIANTS[variant]


def select_lanes(coin: np.ndarray, up, down):
    """Lane j of ``up`` where ``coin[j]``, else of ``down``: trees (or
    tensors) whose leaves carry a leading (G,) lane axis."""
    def leaf(u, d):
        mask = torch.as_tensor(coin, device=u.device).reshape(
            (-1,) + (1,) * (u.dim() - 1))
        return torch.where(mask, u, d)
    return tree.map_leaves(leaf, up, down)


# ---------------------------------------------------------------------------
# h-updates
# ---------------------------------------------------------------------------

def _h_dasha(sub, rnd, hp, x_new, x_old, h, data):
    """h_i^{t+1} = grad f_i(x^{t+1}) (the GD-like line)."""
    return sub.grad(rnd, x_new, data, hp.batch), None


def _h_page(sub, rnd, hp, x_new, x_old, h, data):
    """PAGE: full reset with prob p, else a SARAH increment on a
    shared-sample minibatch difference (Theorem 6.4).  Per-lane coins
    compute each branch some lane takes."""
    coin = rnd.coin(host_value(hp.p), "page")
    lanes = isinstance(coin, np.ndarray)
    if coin.all() if lanes else coin:
        return sub.grad(rnd, x_new, data, hp.batch), None
    diff = sub.grad_diff(rnd, x_new, x_old, hp.batch, data)
    inc = sub.lin(lambda h_, d_: h_ + d_, h, diff)
    if not lanes or not coin.any():
        return inc, None
    return select_lanes(coin, sub.grad(rnd, x_new, data, hp.batch),
                        inc), None


def _h_mvr(sub, rnd, hp, x_new, x_old, h, data):
    """Momentum variance reduction with the SAME samples at both points
    (Theorem 6.7)."""
    gn, go = sub.grad_pair(rnd, x_new, x_old, hp.batch, data)
    fusion = MvrFusion(gn, go, hp.b)
    if sub.fuses_mvr:
        return None, fusion
    return sub.lin(lambda gn_, h_, go_: gn_ + (1.0 - hp.b) * (h_ - go_),
                   gn, h, go), fusion


def _h_sarah(sub, rnd, hp, x_new, x_old, h, data):
    """SYNC-MVR's compressed branch: MVR with b = 0 (SARAH recursion)."""
    gn, go = sub.grad_pair(rnd, x_new, x_old, hp.batch, data)
    fusion = MvrFusion(gn, go, 0.0)
    if sub.fuses_mvr:
        return None, fusion
    return sub.lin(lambda gn_, h_, go_: gn_ + (h_ - go_), gn, h, go), fusion


def _h_marina(sub, rnd, hp, x_new, x_old, h, data):
    """MARINA: telescoped oracle difference; with force_a = 0 the drift is
    exactly C_i(G_i(x^{t+1}) - G_i(x^t))."""
    diff = sub.grad_diff(rnd, x_new, x_old, hp.batch, data)
    return sub.lin(lambda h_, d_: h_ + d_, h, diff), None


def _sync_megabatch(sub, rnd, hp, x_new, data):
    """The dense sync round: a fresh uncompressed megabatch gradient (the
    exact gradient where the oracle has one)."""
    return sub.megabatch(rnd, x_new, hp.batch_sync, data)


# ---------------------------------------------------------------------------
# theory glue (Section 6)
# ---------------------------------------------------------------------------

def _theory_dasha(c):
    return theory.gamma_dasha(c.L, c.L_hat, c.omega, c.n), {}


def _theory_page(c):
    p = theory.page_p(c.B, c.m)
    return (theory.gamma_dasha_page(c.L, c.L_hat, c.L_max, c.omega, c.n,
                                    c.B, p),
            {"p": p, "batch": c.B})


def _theory_mvr(c):
    b = theory.mvr_b(c.omega, c.n, c.B, c.eps, c.sigma2)
    return (theory.gamma_dasha_mvr(c.L, c.L_hat, c.L_sigma, c.omega, c.n,
                                   c.B, b),
            {"b": b, "batch": c.B})


def _theory_sync_mvr(c):
    p = theory.sync_mvr_p(c.zeta, c.d, c.n, c.B, c.eps, c.sigma2)
    return (theory.gamma_sync_mvr(c.L, c.L_hat, c.L_sigma, c.omega, c.n,
                                  c.B, p),
            {"p": p, "batch": c.B})


def _theory_marina(c):
    p = theory.marina_p(c.zeta, c.d)
    # batch=0: the plain MARINA stepsize assumes exact gradient differences
    return theory.gamma_marina(c.L, c.omega, c.n, p), {"p": p, "batch": 0}


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

register_variant(VariantRule(
    name="dasha", h_update=_h_dasha, theory_gamma=_theory_dasha))

register_variant(VariantRule(
    name="page", h_update=_h_page, theory_gamma=_theory_page))

register_variant(VariantRule(
    name="mvr", h_update=_h_mvr, theory_gamma=_theory_mvr))

register_variant(VariantRule(
    name="sync_mvr", h_update=_h_sarah, sync_update=_sync_megabatch,
    theory_gamma=_theory_sync_mvr, extra_payload=_sync_extra_payload,
    sync_requires_all=True))

register_variant(VariantRule(
    name="marina", h_update=_h_marina, sync_update=_sync_megabatch,
    force_a=0.0, theory_gamma=_theory_marina,
    extra_payload=_sync_extra_payload, sync_requires_all=True))

"""DASHA family (Algorithm 1) and DASHA-SYNC-MVR (Algorithm 2): the seed's
entry points over the methods layer (port of ``repro.core.dasha``).

The variant rules (Alg. 1 line 8) live in :mod:`repro_torch.methods.rules`,
the (n, d) state ops in :class:`repro_torch.methods.FlatSubstrate`, the
shared skeleton in :meth:`repro_torch.methods.Method.build`.  These
functions keep the seed's signatures, with an integer round seed in place
of the key, and are the same rounds as a ``Method.build`` run of the same
hyperparameters, bit for bit:

    m_i     = C_i(h_i^{t+1} - h_i^t - a (g_i^t - h_i^t))
    g_i    <- g_i + m_i
    g      <- g + (1/n) sum_i m_i
"""
from __future__ import annotations

from typing import Optional

from repro_torch.compress import make_round_compressor
from repro_torch.core.device import DEFAULT_DEVICE
from repro_torch.methods import FlatSubstrate, Hyper, Method, MethodState

#: the unified state and hyperparameters under the seed's names
DashaState = MethodState
DashaHyper = Hyper


def _substrate(problem, n: int, d: int) -> FlatSubstrate:
    return FlatSubstrate(problem=problem, n=n, d=d)


def _method(hp: DashaHyper, problem, comp, n: int, d: int) -> Method:
    return Method.build(hp.variant, comp, _substrate(problem, n, d), hp)


def _identity(d: int, n: int, device=DEFAULT_DEVICE):
    return make_round_compressor("identity", d, n, device=device)


def init(x0, n: int, seed: int, *, problem=None,
         hyper: Optional[DashaHyper] = None, init_mode: str = "exact",
         batch_init: int = 1, device=DEFAULT_DEVICE) -> DashaState:
    """Cor. 6.2 / 6.5: g_i^0 = h_i^0 = grad f_i(x^0); Cor. 6.8 / 6.10: a
    minibatch of size B_init; zeros also allowed under PL.  The state's
    tensors lie on ``device`` (default the card; raises without one)."""
    hp = hyper or DashaHyper(gamma=0.0, a=1.0)
    d = x0.shape[0]
    # the compressor plays no role at init; identity keeps build() total
    m = Method.build(hp.variant, _identity(d, n, device),
                     _substrate(problem, n, d), hp)
    return m.init(x0, seed, device=device, init_mode=init_mode,
                  batch_init=batch_init)


def step(state: DashaState, hp: DashaHyper, problem, comp, *,
         draws=None) -> DashaState:
    """One communication round of Algorithm 1 (Algorithm 2 for
    ``sync_mvr``).  ``comp``: a :class:`repro_torch.compress.RoundCompressor`
    or a legacy :class:`repro_torch.compress.legacy.NodeCompressor` view;
    its ``backend`` picks dense / sparse / fused execution of lines 9-10
    without changing the math.  ``draws`` injects the round's randomness
    (:class:`repro_torch.core.rng.Draws`) in place of the round's own
    generators."""
    n, d = state.g_local.shape
    return _method(hp, problem, comp, n, d).step_full(state,
                                                      draws=draws)[0]


def run(state: DashaState, hp: DashaHyper, problem, comp, num_rounds: int,
        *, metric_every: int = 1, metric_fn=None):
    """T rounds through the chunked driver; returns (final state, metric
    trace, cumulative payload trace).  ``metric_fn(state) -> scalar``
    defaults to ||grad f(x)||^2 where the problem has an exact gradient."""
    n, d = state.g_local.shape
    return _method(hp, problem, comp, n, d).run(
        state, num_rounds, metric_every=metric_every, metric_fn=metric_fn)

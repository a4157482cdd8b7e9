"""The port's methods layer against the reference (CPU).

Step parity: both packages start from one state (the reference's init,
carried across by ``repro_torch.convert``); every round the reference's
draws (plan, PAGE coin and samples, MVR/SARAH xi, sync coin and megabatch)
are replayed into the port's ``step_full(draws=...)``.  States must agree
to rtol 1e-5 for 20 rounds, for all 5 variants x dense/sparse/fused;
``t`` and ``bits_sent`` exactly.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from torch_common import (D, N, assert_state_close, glm_arrays,
                          jax_glm_loss, jax_stoch_problem, reference_draws,
                          state_arrays, stoch_arrays, torch_glm_loss,
                          torch_stoch_problem)

import repro.methods as jm
from repro.compress import make_round_compressor as j_make_rc
from repro.core import theory as jtheory
from repro.core.oracles import FiniteSumProblem as JFiniteSum
from repro_torch import convert
from repro_torch import methods as tm
from repro_torch.compress import make_round_compressor as t_make_rc
from repro_torch.core import theory as ttheory

torch.set_num_threads(1)

ROUNDS = 20


def _hyper(cls, variant, omega):
    a = 1.0 / (2 * omega + 1)
    return {
        "dasha": cls(gamma=0.05, a=a),
        "page": cls(gamma=0.05, a=a, variant="page", p=0.3, batch=2),
        "mvr": cls(gamma=0.05, a=a, variant="mvr", b=0.3, batch=4),
        "sync_mvr": cls(gamma=0.05, a=a, variant="sync_mvr", p=0.3,
                        batch=4, batch_sync=8),
        "marina": cls(gamma=0.05, a=0.0, variant="marina", p=0.3, batch=2),
    }[variant]


def _problems(variant):
    if variant in ("mvr", "sync_mvr"):
        A, b = stoch_arrays()
        return jax_stoch_problem(A, b), torch_stoch_problem(A, b), "stoch"
    feats, labels = glm_arrays()
    jp = JFiniteSum(loss=jax_glm_loss, features=jnp.asarray(feats),
                    labels=jnp.asarray(labels))
    tp = convert.problem_from_numpy(torch_glm_loss, feats, labels,
                                    device="cpu")
    return jp, tp, "exact"


@pytest.mark.parametrize("backend", ["dense", "sparse", "fused"])
@pytest.mark.parametrize("variant", ["dasha", "page", "mvr", "sync_mvr",
                                     "marina"])
def test_step_parity_with_replayed_draws(variant, backend):
    jp, tp, init_mode = _problems(variant)
    jrc = j_make_rc("randk", D, N, k=6, backend=backend)
    trc = t_make_rc("randk", D, N, k=6, backend=backend, device="cpu")
    jhp = _hyper(jm.Hyper, variant, jrc.omega)
    thp = _hyper(tm.Hyper, variant, trc.omega)
    jmethod = jm.Method.build(variant, jrc, jm.FlatSubstrate(jp, N, D), jhp)
    tmethod = tm.Method.build(variant, trc, tm.FlatSubstrate(tp, N, D), thp)
    jstate = jmethod.init(jnp.zeros(D), jax.random.PRNGKey(1),
                          init_mode=init_mode)
    tstate = convert.state_from_numpy(state_arrays(jstate), seed=0,
                                      device="cpu")
    jstep = jax.jit(jmethod.step)
    coins = []
    for _ in range(ROUNDS):
        draws = reference_draws(jstate.key, jrc, jp, jhp, variant)
        coins.append(draws.sync_coin or draws.page_coin)
        jstate = jstep(jstate)
        tstate, _ = tmethod.step_full(tstate, draws=draws)
        assert_state_close(tstate, jstate)
    if variant in ("page", "sync_mvr", "marina"):
        assert any(coins) and not all(coins)   # both branches exercised


def test_init_matches_reference_exact_gradients():
    jp, tp, _ = _problems("dasha")
    jrc = j_make_rc("randk", D, N, k=6)
    trc = t_make_rc("randk", D, N, k=6, device="cpu")
    jst = jm.Method.build("dasha", jrc, jm.FlatSubstrate(jp, N, D),
                          _hyper(jm.Hyper, "dasha", 1.0)).init(
        jnp.zeros(D), jax.random.PRNGKey(0))
    tst = tm.Method.build("dasha", trc, tm.FlatSubstrate(tp, N, D),
                          _hyper(tm.Hyper, "dasha", 1.0)).init(
        torch.zeros(D), 0, device="cpu")
    assert_state_close(tst, jst)


def test_step_info_and_participation():
    _, tp, _ = _problems("dasha")
    trc = t_make_rc("randk", D, N, k=6, p_participate=0.5, device="cpu")
    method = tm.Method.build("dasha", trc, tm.FlatSubstrate(tp, N, D),
                             _hyper(tm.Hyper, "dasha", trc.omega))
    st = method.init(torch.zeros(D), 3, device="cpu")
    st, info = method.step_full(st)
    assert info.present.shape == (N,) and info.present.dtype == torch.bool
    assert info.coin is None and info.payload == trc.payload_per_node
    # an absent node sends nothing
    assert not bool(info.messages.dense()[~info.present].any())


@pytest.mark.parametrize("hook", ["deficit", "window", "faults"])
def test_federated_hooks_are_not_ported_yet(hook):
    """window= (the slab store's hook) is ported and needs a
    sampled-client substrate, so the flat one refuses it, as the
    reference does; faults= and deficit= (asynchronous rounds) are
    ported, and a FaultStep that drops no one, or a zero deficit, leaves
    the round bit for bit the plain one (tests/test_torch_faults.py and
    tests/test_torch_async.py hold the rest)."""
    _, tp, _ = _problems("dasha")
    trc = t_make_rc("randk", D, N, k=6, device="cpu")
    method = tm.Method.build("dasha", trc, tm.FlatSubstrate(tp, N, D),
                             _hyper(tm.Hyper, "dasha", 1.0))
    st = method.init(torch.zeros(D), 0, device="cpu")
    if hook != "window":
        neutral = {"faults": tm.FaultStep(drop=torch.zeros(
            N, dtype=torch.bool)), "deficit": torch.zeros(D)}[hook]
        got, _ = method.step_full(st, **{hook: neutral})
        want, _ = method.step_full(st)
        for k in ("x", "g", "g_local", "h_local"):
            assert torch.equal(getattr(got, k), getattr(want, k)), k
        return
    with pytest.raises(ValueError):
        method.step_full(st, window=object())


@pytest.mark.parametrize("variant,kw", [
    ("dasha", {}), ("page", dict(B=4, m=64)),
    ("mvr", dict(B=8, sigma2=0.1, L_sigma=2.0)),
    ("sync_mvr", dict(B=8, sigma2=0.1, zeta=6.0, d=D)),
    ("marina", dict(zeta=6.0, d=D))])
def test_from_theory_matches_reference(variant, kw):
    ref = jm.Hyper.from_theory(variant, 3.0, N, L=2.0, gamma_mult=4, **kw)
    got = tm.Hyper.from_theory(variant, 3.0, N, L=2.0, gamma_mult=4, **kw)
    assert dataclass_dict(got) == dataclass_dict(ref)


def dataclass_dict(h):
    return {f: getattr(h, f) for f in ("gamma", "a", "variant", "b", "p",
                                       "batch", "batch_sync")}


def test_theory_formulas_match_reference():
    names = [n for n in dir(jtheory) if n.startswith(("gamma_", "rounds_"))
             or n in ("page_p", "mvr_b", "sync_mvr_p", "marina_p",
                      "comm_complexity", "oracle_complexity_page")]
    c_ref = jtheory.ProblemConstants(eps=0.01, n=5, omega=3.0, L=2.0,
                                     L_hat=1.5, L_max=3.0, L_sigma=2.5, m=64,
                                     B=4, sigma2=0.2, d=60, zeta=6.0)
    c_port = ttheory.ProblemConstants(**{f: getattr(c_ref, f) for f in
                                         c_ref.__dataclass_fields__})
    args = {"gamma_dasha": (2.0, 1.5, 3.0, 5),
            "gamma_dasha_page": (2.0, 1.5, 3.0, 3.0, 5, 4, 0.1),
            "gamma_dasha_mvr": (2.0, 1.5, 2.5, 3.0, 5, 4, 0.2),
            "gamma_sync_mvr": (2.0, 1.5, 2.5, 3.0, 5, 4, 0.2),
            "gamma_marina": (2.0, 3.0, 5, 0.1), "page_p": (4, 64),
            "mvr_b": (3.0, 5, 4, 0.01, 0.2),
            "sync_mvr_p": (6.0, 60, 5, 4, 0.01, 0.2),
            "marina_p": (6.0, 60), "comm_complexity": (100.0, 6.0, 60),
            "oracle_complexity_page": (100.0, 64, 4)}
    for name in names:
        a = args.get(name)
        if a is None:
            assert getattr(ttheory, name)(c_port) == \
                getattr(jtheory, name)(c_ref), name
        else:
            assert getattr(ttheory, name)(*a) == \
                getattr(jtheory, name)(*a), name


def test_accounting_matches_reference():
    rule_j, rule_t = jm.get_rule("marina"), tm.get_rule("marina")
    hp_j = jm.Hyper(gamma=0.1, a=0.0, variant="marina", p=0.25)
    hp_t = tm.Hyper(gamma=0.1, a=0.0, variant="marina", p=0.25)
    assert tm.expected_payload_frac(rule_t, hp_t, 10.0, 60.0) == \
        jm.expected_payload_frac(rule_j, hp_j, 10.0, 60.0)
    assert tm.expected_wire_coords(rule_t, hp_t, 20.0, 60.0) == \
        jm.expected_wire_coords(rule_j, hp_j, 20.0, 60.0)
    assert tm.sampled_per_node(30.0, 10, 3) == jm.sampled_per_node(30.0, 10,
                                                                   3)
    assert tm.round_payload(10.0, 60.0, True) == 60.0
    assert tm.round_payload(10.0, 60.0, False) == 10.0
    assert tm.round_payload(10.0, 60.0, None) == 10.0
    from repro.methods.accounting import downlink_receivers as j_down
    from repro_torch.methods.accounting import downlink_receivers as t_down
    assert t_down(10) == j_down(10) and t_down(10, 3) == j_down(10, 3)


def test_registry_is_complete_and_unknown_raises():
    assert sorted(tm.VARIANTS) == sorted(jm.VARIANTS)
    for name in tm.VARIANTS:
        assert tm.get_rule(name).has_sync == jm.get_rule(name).has_sync
        assert tm.get_rule(name).force_a == jm.get_rule(name).force_a
    with pytest.raises(ValueError):
        tm.get_rule("nope")

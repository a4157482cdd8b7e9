"""The port's fault injection (``repro_torch.fed.faults``, the engine's
``faults=`` hook, faulted ``FedSim`` and ``VecFedSim``) against the
reference's (CPU), at ``tests/test_fed_faults.py``'s size: D = 40, N = 5,
sparse RandK K = 6, 40 rounds, the bench's theory hyperparameters.

The fault realization is numpy on both sides, so ``draw_campaign``,
``corrupt_bytes``, ``deadline_s`` and ``backoff_cumsum`` must equal the
reference's bit for bit.  Campaign parity starts both packages from one
state (the reference's init, carried across by ``repro_torch.convert``)
and replays the reference's per-round draws into the port
(``torch_common.reference_draws``); the network and fault streams need no
replay.  Tolerances: integer traces (bytes, participants, sync rounds and
every fault trace) exactly; the heap oracle's wall clock exactly too (the
same float64 arithmetic on the same integers and draws), the vectorized
simulator's to rtol 2e-6 (its float32 delays); the metric to rtol 1e-4
and the final iterate to rtol 1e-5 (float32 sums taken in another order,
compounded over the rounds).

The port-only tests (chunk invariance, the server invariant, MARINA's
invariance, deadlines, mass crashes, corruption, kill-and-restore) run on
the port's own draws, as the reference's tests run on its own.  The
kill-and-restore drill keeps the checkpoint in memory: the port has no
``checkpoint/io.py`` yet.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from torch_common import (key_chain, reference_draws, state_arrays,
                          torch_glm_loss)

import repro.fed as jfed
import repro.methods as jm
from benchmarks.common import glm_problem, lipschitz_glm, theory_hyper
from repro.compress import make_round_compressor as j_make_rc
from repro.fed import faults as jfaults
from repro_torch import convert
from repro_torch import fed as tfed
from repro_torch import methods as tm
from repro_torch.compress import make_round_compressor as t_make_rc
from repro_torch.fed import faults as tfaults
from repro_torch.fed import wire as twire
from repro_torch.obs import Obs

torch.set_num_threads(1)

D, K, N, M, ROUNDS = 40, 6, 5, 32, 40

#: traces that are integer functions of the engine and fault randomness
INT_TRACES = ("bytes_up", "value_bytes", "bytes_down", "sync_round",
              "participants") + tfed.FAULT_TRACES

FM_MIXED = dict(p_crash=0.08, crash_rounds=2, p_drop_up=0.1,
                p_drop_down=0.05, p_corrupt=0.05, deadline_mult=3.0,
                rejoin="reset", seed=7)
FM_SYNC = dict(p_crash=0.08, crash_rounds=2, p_drop_up=0.1, p_corrupt=0.05,
               deadline_mult=3.0, seed=7)

#: the reference's FAULT_MATRIX (tests/test_fed_faults.py), row for row
FAULT_MATRIX = [
    ("dasha", 1.0, FM_MIXED),
    ("dasha", 0.6, dict(p_crash=0.1, p_drop_up=0.15, deadline_mult=3.0,
                        seed=11)),
    ("dasha", 1.0, dict(p_crash=0.1, crash_rounds=3, deadline_mult=None,
                        seed=5)),
    ("page", 1.0, FM_MIXED),
    ("mvr", 1.0, dict(p_crash=0.12, crash_rounds=2, p_drop_up=0.2,
                      rejoin="stale", deadline_mult=3.0, seed=13)),
    ("marina", 1.0, FM_SYNC),
    ("sync_mvr", 1.0, dict(p_crash=0.05, p_drop_up=0.1, deadline_mult=4.0,
                           seed=9)),
]
MATRIX_IDS = [f"{v}-p{p}-s{fm['seed']}" for v, p, fm in FAULT_MATRIX]


# ---------------------------------------------------------------------------
# the two packages on one problem
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _problems():
    jp = glm_problem(d=D, m=M)
    tp = convert.problem_from_numpy(torch_glm_loss, np.asarray(jp.features),
                                    np.asarray(jp.labels), device="cpu")
    return jp, tp


#: the campaigns' compressors: sparse RandK, and the fused backend's two
#: kernels (run here through their plain versions)
COMPS = {"randk": ("randk", dict(k=K, backend="sparse")),
         "randk-fused": ("randk", dict(k=K, backend="fused")),
         "qdither-fused": ("qdither", dict(s=7, backend="fused"))}


def _comps(p=1.0, comp="randk"):
    name, kw = COMPS[comp]
    return (j_make_rc(name, D, N, p_participate=p, **kw),
            t_make_rc(name, D, N, p_participate=p, device="cpu", **kw))


def _draws(key, rc, problem, hp, variant):
    """``reference_draws`` plus the finite-sum samples of sync_mvr's
    h-update (the reference's ``minibatch_grad`` pair from ``k_h``)."""
    dr = reference_draws(key, rc, problem, hp, variant)
    if variant == "sync_mvr" and hp.batch > 0:
        k_h = jax.random.split(key, 4)[1]
        dr = dr._replace(samples=np.array(problem._sample_idx(k_h,
                                                              hp.batch)))
    return dr


@functools.lru_cache(maxsize=None)
def _reference(variant, p, fm_items, rounds=ROUNDS, comp="randk"):
    """The reference's faulted FedSim (cached: each matrix row serves both
    of the port's simulators), its init state and its draws."""
    jp, _ = _problems()
    jrc = _comps(p, comp)[0]
    jhp = theory_hyper(variant, jrc.omega, lipschitz_glm(jp), d=D, k=K,
                       n=N, m=M)
    fm = None if fm_items is None else jfaults.FaultModel(**dict(fm_items))
    sim = jfed.FedSim(variant, jrc, jm.FlatSubstrate(jp, N, D), jhp,
                      faults=fm, seed=3)
    st = sim.init(np.zeros(D, np.float32), jax.random.PRNGKey(0))
    draws = [_draws(k, jrc, jp, jhp, variant)
             for k in key_chain(st.key, rounds)]
    return sim.run(st, rounds), st, jhp, draws


def _port_sim(cls, variant, p, fm, hp, *, comp="randk", chunk=128,
              **kw):
    _, tp = _problems()
    trc = _comps(p, comp)[1]
    return cls(variant, trc, tm.FlatSubstrate(tp, N, D), hp,
               faults=None if fm is None else tfaults.FaultModel(**fm),
               seed=3, chunk=chunk, **kw)


def _items(fm):
    return None if fm is None else tuple(sorted(fm.items()))


def _parity(cls, variant, p, fm, comp="randk"):
    """(reference result, port result) of one faulted campaign, the port
    replaying the reference's draws."""
    jres, jst, jhp, draws = _reference(variant, p, _items(fm), comp=comp)
    hp = tm.Hyper(**dataclasses.asdict(jhp))
    sim = _port_sim(cls, variant, p, fm, hp, comp=comp)
    st = convert.state_from_numpy(state_arrays(jst), seed=0, device="cpu")
    return jres, sim.run(st, ROUNDS, draws=lambda t: draws[t])


def _assert_parity(jres, tres, *, exact_clock, x_atol=1e-7):
    for k in INT_TRACES:
        np.testing.assert_array_equal(tres.traces[k], jres.traces[k],
                                      err_msg=k)
    if exact_clock:
        np.testing.assert_array_equal(tres.traces["sim_wall_clock"],
                                      jres.traces["sim_wall_clock"])
    else:
        np.testing.assert_allclose(tres.traces["sim_wall_clock"],
                                   jres.traces["sim_wall_clock"], rtol=2e-6)
    np.testing.assert_allclose(tres.traces["metric"], jres.traces["metric"],
                               rtol=1e-4)
    np.testing.assert_allclose(tres.state.x.numpy(),
                               np.asarray(jres.state.x), rtol=1e-5,
                               atol=x_atol)
    for key in ("dropped_rounds", "retries", "retry_capped",
                "wasted_bytes_up", "bytes_up", "bytes_down",
                "sync_rounds", "mean_participants"):
        assert tres.summary[key] == jres.summary[key], key


def _port_run(cls, variant, fm, *, p=1.0, rounds=ROUNDS, comp="randk",
              **kw):
    """A campaign on the port's own draws, from the port's own init."""
    jp, _ = _problems()
    trc = _comps(p, comp)[1]
    hp = theory_hyper(variant, trc.omega, lipschitz_glm(jp), d=D, k=K, n=N,
                      m=M)
    run_kw = {k: kw.pop(k) for k in ("checkpoint", "start_round", "clock0")
              if k in kw}
    state = kw.pop("state", None)
    sim = _port_sim(cls, variant, p, fm,
                    tm.Hyper(**dataclasses.asdict(hp)), comp=comp, **kw)
    if state is None:
        state = sim.init(torch.zeros(D), 0, device="cpu")
    return sim.run(state, rounds, **run_kw)


# ---------------------------------------------------------------------------
# FaultModel / FaultCampaign: numpy on both sides, bit for bit
# ---------------------------------------------------------------------------

BAD_MODELS = [dict(p_crash=1.0), dict(p_drop_up=-0.1), dict(p_corrupt=1.5),
              dict(crash_rounds=0), dict(rejoin="reboot"),
              dict(deadline_mult=1.0), dict(max_retries=0),
              dict(backoff0_s=0.0), dict(backoff0_s=2.0, backoff_cap_s=1.0)]


@pytest.mark.parametrize("kw", BAD_MODELS,
                         ids=lambda kw: "-".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_fault_model_validation_raises_what_the_reference_raises(kw):
    with pytest.raises(ValueError) as want:
        jfaults.FaultModel(**kw)
    with pytest.raises(ValueError) as got:
        tfaults.FaultModel(**kw)
    assert str(got.value) == str(want.value)


def test_fault_model_accepts_a_disabled_deadline():
    fm = tfaults.FaultModel(deadline_mult=None)
    assert fm.late_cap() is None
    assert fm.deadline_s(tfed.LinkModel(), tfed.LinkModel(), 0.01, D) is None


CAMPAIGNS = [dict(p_crash=0.2, crash_rounds=3, seed=1),
             dict(p_crash=0.1, p_drop_up=0.2, p_drop_down=0.05,
                  p_corrupt=0.1, seed=5),
             dict(p_crash=0.02, crash_rounds=2, p_drop_up=0.2,
                  deadline_mult=3.0, seed=7, max_retries=4)]


@pytest.mark.parametrize("retries", [False, True])
@pytest.mark.parametrize("kw", CAMPAIGNS, ids=lambda kw: f"s{kw['seed']}")
def test_draw_campaign_equals_the_reference(kw, retries):
    want = jfaults.FaultModel(**kw).draw_campaign(60, 8, retries=retries)
    got = tfaults.FaultModel(**kw).draw_campaign(60, 8, retries=retries)
    assert got._fields == want._fields
    for field in want._fields:
        a, b = getattr(got, field), getattr(want, field)
        if b is None:
            assert a is None, field
            continue
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.crashed.any()


def test_draw_campaign_is_monotone_in_the_drop_rate():
    """Common random numbers: raising a probability realizes a superset of
    the same fault events; the retry draws are appended, so graceful and
    sync rules face the same crashes and losses."""
    lo = tfaults.FaultModel(p_drop_up=0.05, p_crash=0.02, seed=3) \
        .draw_campaign(50, 6)
    hi = tfaults.FaultModel(p_drop_up=0.3, p_crash=0.1, seed=3) \
        .draw_campaign(50, 6, retries=True)
    assert (hi.drop_up | lo.drop_up == hi.drop_up).all()
    assert (hi.crash_start | lo.crash_start == hi.crash_start).all()
    assert hi.drop_up.sum() > lo.drop_up.sum()
    assert (hi.first_success >= np.maximum(hi.crash_left, 1)).all()


def test_corrupt_bytes_equals_the_reference_and_verify_catches_it():
    """A flipped byte in a real record trips the crc, in both packages'
    codecs, at the same position; a header-only record flips its node
    field."""
    rc = _comps()[1]
    vals = np.arange(N * K, dtype=np.float32).reshape(N, K)
    idxs = np.tile(np.arange(K, dtype=np.int64), (N, 1))

    class Msgs:
        values, indices = vals, idxs

    bufs = twire.encode_round(rc, None, Msgs, 4, coin=False,
                              sync_values=None, present=None, slots=None)
    header_only = bufs[0][:twire.HEADER_BYTES]
    for i, buf in enumerate(bufs + [header_only]):
        got = tfaults.corrupt_bytes(buf, 4, i)
        assert got == jfaults.corrupt_bytes(buf, 4, i)
        assert sum(a != b for a, b in zip(got, buf)) == 1
        if i < N:
            twire.verify(buf)
            with pytest.raises(twire.WireCorruptionError):
                twire.verify(got)


def test_deadline_and_backoff_equal_the_reference():
    for mult in (1.5, 3.0, 4.0):
        kw = dict(deadline_mult=mult, max_retries=12, backoff0_s=0.03,
                  backoff_cap_s=0.5)
        up = dict(latency_s=1e-3, bandwidth_Bps=1e6)
        down = dict(latency_s=2e-3, bandwidth_Bps=1e8)
        got = tfaults.FaultModel(**kw)
        want = jfaults.FaultModel(**kw)
        dl = got.deadline_s(tfed.LinkModel(**down), tfed.LinkModel(**up),
                            0.002, 20958)
        assert dl.dtype == np.float32
        assert dl == want.deadline_s(jfed.LinkModel(**down),
                                     jfed.LinkModel(**up), 0.002, 20958)
        assert got.late_cap() == want.late_cap() == np.float32(mult)
        np.testing.assert_array_equal(got.backoff_cumsum(),
                                      want.backoff_cumsum())
    assert tfaults.X_BCAST_BYTES == jfaults.X_BCAST_BYTES
    assert tfaults.REJOIN_MODES == jfaults.REJOIN_MODES


# ---------------------------------------------------------------------------
# scope guards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls", [tfed.FedSim, tfed.VecFedSim])
def test_faults_reject_async_and_sampled(cls):
    _, tp = _problems()
    rc = _comps()[1]
    hp = tm.Hyper(gamma=0.1, a=0.5)
    with pytest.raises(ValueError, match="tau"):
        cls("dasha", rc, tm.FlatSubstrate(tp, N, D), hp,
            faults=tfaults.FaultModel(), tau=2)
    with pytest.raises(ValueError, match="sampled"):
        cls("dasha", rc, tm.SampledFlatSubstrate(tp, N, D, c=3), hp,
            faults=tfaults.FaultModel())


def test_engine_takes_faults_only_where_the_reference_does():
    """MARINA / SYNC-MVR recover missing messages by the simulators'
    retries, so the engine refuses a fault mask for them; a sampled
    substrate refuses one too, and takes ``deficit=`` (asynchronous
    rounds), a zero deficit leaving its round bit for bit."""
    _, tp = _problems()
    rc = _comps()[1]
    drop = tm.FaultStep(drop=torch.zeros(N, dtype=torch.bool))
    for variant in ("marina", "sync_mvr"):
        m = tm.Method.build(variant, rc, tm.FlatSubstrate(tp, N, D),
                            tm.Hyper(gamma=0.1, a=0.0, variant=variant,
                                     p=0.5))
        st = m.init(torch.zeros(D), 0, device="cpu")
        with pytest.raises(ValueError, match="sync_requires_all"):
            m.step_full(st, None, faults=drop)
    m = tm.Method.build("dasha", rc, tm.SampledFlatSubstrate(tp, N, D, c=3),
                        tm.Hyper(gamma=0.1, a=0.5))
    st = m.init(torch.zeros(D), 0, device="cpu")
    with pytest.raises(ValueError, match="sampled"):
        m.step_full(st, None, faults=drop)
    got, _ = m.step_full(st, None, deficit=torch.zeros(D))
    want, _ = m.step_full(st, None)
    for k in ("x", "g", "g_local", "h_local"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k


@pytest.mark.parametrize("cls", [tfed.FedSim, tfed.VecFedSim])
def test_faulted_run_still_refuses_obs(cls):
    """A faulted run used to refuse ``obs=``; the handle is ported now
    (``tests/test_torch_obs.py``), so this holds the opposite: a faulted
    run takes a handle, returns what it returns without one, and bills
    every fault trace into its ``fed.faults.*`` counters.  An object that
    is not a handle still raises."""
    sim = _port_sim(cls, "dasha", 1.0, FM_MIXED, tm.Hyper(gamma=0.1, a=0.5))
    st = sim.init(torch.zeros(D), 0, device="cpu")
    plain = sim.run(st, 6)
    obs = Obs.metrics_only()
    res = sim.run(st, 6, obs=obs)
    for k in plain.traces:
        assert np.array_equal(res.traces[k], plain.traces[k]), k
    assert torch.equal(res.state.x, plain.state.x)
    snap = obs.metrics.snapshot()
    for name in ("offline", "dropped", "late", "lost", "rejoins"):
        assert snap[f"fed.faults.{name}"]["value"] == \
            plain.traces[name].sum(), name
    with pytest.raises(AttributeError):
        sim.run(st, 2, obs=object())


# ---------------------------------------------------------------------------
# the engine's hook, one round against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["sparse", "dense", "fused"])
@pytest.mark.parametrize("reset", [False, True])
def test_fault_step_matches_the_reference_round(backend, reset):
    """One engine round with drop and reset masks, both packages from one
    state and one plan: the reset rows blank before the h-update, the
    drop rows reverted, the server's correction applied; the state handed
    in is not written."""
    import jax.numpy as jnp
    from repro.methods.engine import FaultStep as JFaultStep
    jp, tp = _problems()
    jrc = j_make_rc("randk", D, N, k=K, backend=backend)
    trc = t_make_rc("randk", D, N, k=K, backend=backend, device="cpu")
    jhp = theory_hyper("dasha", jrc.omega, lipschitz_glm(jp), d=D, k=K, n=N,
                       m=M)
    jm_ = jm.Method.build("dasha", jrc, jm.FlatSubstrate(jp, N, D), jhp)
    tm_ = tm.Method.build("dasha", trc, tm.FlatSubstrate(tp, N, D),
                          tm.Hyper(**dataclasses.asdict(jhp)))
    jst = jm_.init(jnp.zeros(D), jax.random.PRNGKey(2))
    # a state off its init, so g_i != 0 and the reset correction bites
    for _ in range(3):
        jst = jm_.step(jst)
    tst = convert.state_from_numpy(state_arrays(jst), seed=0, device="cpu")
    before = {k: getattr(tst, k).clone() for k in ("x", "g", "g_local",
                                                   "h_local")}
    drop = np.array([True, False, False, True, False])
    rst = np.array([False, True, False, True, False]) if reset else None
    jnew, _ = jm_.step_full(jst, None, faults=JFaultStep(
        drop=jnp.asarray(drop),
        reset=None if rst is None else jnp.asarray(rst)))
    dr = reference_draws(jst.key, jrc, jp, jhp, "dasha")
    tnew, _ = tm_.step_full(tst, None, draws=dr, faults=tm.FaultStep(
        drop=torch.as_tensor(drop),
        reset=None if rst is None else torch.as_tensor(rst)))
    for k in ("x", "g", "g_local", "h_local"):
        np.testing.assert_allclose(getattr(tnew, k).numpy(),
                                   np.asarray(getattr(jnew, k)), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
        assert torch.equal(getattr(tst, k), before[k]), k
    assert tnew.bits_sent == np.float32(jnew.bits_sent)
    np.testing.assert_allclose(tnew.g.numpy(), tnew.g_local.numpy().mean(0),
                               rtol=2e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the zero-fault anchor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant,p", [("dasha", 1.0), ("dasha", 0.6),
                                       ("marina", 1.0)])
def test_zero_fault_heap_bit_identical(variant, p):
    base = _port_run(tfed.FedSim, variant, None, p=p)
    zf = _port_run(tfed.FedSim, variant, dict(deadline_mult=4.0), p=p)
    for k in base.traces:
        np.testing.assert_array_equal(base.traces[k], zf.traces[k],
                                      err_msg=k)
    assert torch.equal(base.state.x, zf.state.x)


def test_zero_fault_vec_traces_match():
    base = _port_run(tfed.VecFedSim, "dasha", None)
    zf = _port_run(tfed.VecFedSim, "dasha", dict(deadline_mult=4.0))
    for k in ("bytes_up", "value_bytes", "bytes_down", "participants",
              "sync_round", "bits_sent", "metric", "sim_wall_clock"):
        np.testing.assert_array_equal(base.traces[k], zf.traces[k],
                                      err_msg=k)


# ---------------------------------------------------------------------------
# against the reference's faulted FedSim, both of the port's simulators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant,p,fm", FAULT_MATRIX, ids=MATRIX_IDS)
def test_faulted_heap_matches_the_reference(variant, p, fm):
    jres, tres = _parity(tfed.FedSim, variant, p, fm)
    assert jres.traces["dropped"].sum() > 0        # faults actually fired
    _assert_parity(jres, tres, exact_clock=True)


@pytest.mark.parametrize("variant,p,fm", FAULT_MATRIX, ids=MATRIX_IDS)
def test_faulted_vec_matches_the_reference(variant, p, fm):
    jres, tres = _parity(tfed.VecFedSim, variant, p, fm)
    _assert_parity(jres, tres, exact_clock=False)


@pytest.mark.parametrize("cls", [tfed.FedSim, tfed.VecFedSim])
@pytest.mark.parametrize("comp", ["randk-fused", "qdither-fused"])
def test_fused_kernels_match_the_reference_under_faults(cls, comp):
    """Fused RandK (kernel 1) and fused QDither (kernel 2), here through
    their plain versions, under the mixed fault model with reset
    rejoins.  QDither's final iterate is held to 1e-4 of its largest
    magnitude: in round 0 one coordinate of one client's message lands one
    QSGD level apart (a uniform within ~1e-6 of its threshold, where XLA
    and torch sum the row norm in another order; ROADMAP queue 3's
    caveat), a 1.6e-5 step in that client's g_i that its reset rejoin in
    round 7 erases from the state but the iterate keeps (1.2e-5 of 0.37)."""
    jres, tres = _parity(cls, "dasha", 1.0, FM_MIXED, comp=comp)
    assert jres.traces["rejoins"].sum() > 0
    x_atol = 1e-4 * float(np.abs(np.asarray(jres.state.x)).max()) \
        if comp.startswith("qdither") else 1e-7
    _assert_parity(jres, tres, exact_clock=cls is tfed.FedSim,
                   x_atol=x_atol)


# ---------------------------------------------------------------------------
# semantics on the port's own draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls", [tfed.FedSim, tfed.VecFedSim])
def test_faulted_traces_chunk_invariant(cls):
    """Fault streams are keyed by absolute round: rechunking the campaign
    moves no fault, byte, clock or iterate."""
    a = _port_run(cls, "dasha", FM_MIXED, chunk=128)
    b = _port_run(cls, "dasha", FM_MIXED, chunk=7)
    for k in a.traces:
        np.testing.assert_array_equal(a.traces[k], b.traces[k], err_msg=k)
    assert torch.equal(a.state.x, b.state.x)


@pytest.mark.parametrize("cls", [tfed.FedSim, tfed.VecFedSim])
def test_graceful_drop_preserves_server_invariant(cls):
    """g == mean_i(g_local_i) survives drops and reset rejoins."""
    res = _port_run(cls, "dasha", FM_MIXED)
    assert res.traces["dropped"].sum() > 0
    assert res.traces["rejoins"].sum() > 0
    np.testing.assert_allclose(res.state.g.numpy(),
                               res.state.g_local.numpy().mean(0),
                               rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("variant", ["marina", "sync_mvr"])
def test_sync_rules_math_invariant_but_bytes_inflate(variant):
    """MARINA's barrier under faults: identical iterates (retries recover
    every message), more bytes and more wall clock, in both simulators."""
    for cls in (tfed.FedSim, tfed.VecFedSim):
        base = _port_run(cls, variant, None)
        f = _port_run(cls, variant, FM_SYNC)
        for k in ("metric", "bits_sent", "sync_round"):
            np.testing.assert_array_equal(base.traces[k], f.traces[k],
                                          err_msg=k)
        assert torch.equal(base.state.x, f.state.x)
        assert f.traces["retries"].sum() > 0
        assert f.traces["retry_bytes_up"].sum() > 0
        assert f.summary["bytes_up"] > base.summary["bytes_up"]
        assert f.summary["wall_clock_s"] > base.summary["wall_clock_s"]


def test_deadline_cuts_stragglers():
    """A heavy uplink tail and a tight deadline: late clients are cut,
    every short-handed round costs the static deadline, and the vectorized
    simulator cuts the same clients."""
    fm = dict(deadline_mult=1.5, seed=0)
    up = tfed.LinkModel(straggler=tfed.Lognormal(2.0))
    res = _port_run(tfed.FedSim, "dasha", fm, uplink=up)
    assert res.traces["late"].sum() > 0
    dl = float(tfaults.FaultModel(**fm).deadline_s(tfed.LinkModel(), up,
                                                   0.01, D))
    span = res.traces["sim_wall_clock"] - res.traces["bcast_clock"]
    cut = res.traces["dropped"] > 0
    assert cut.any()
    np.testing.assert_allclose(span[cut], dl, rtol=1e-7)
    vres = _port_run(tfed.VecFedSim, "dasha", fm, uplink=up)
    for k in INT_TRACES:
        np.testing.assert_array_equal(res.traces[k], vres.traces[k],
                                      err_msg=k)


@pytest.mark.parametrize("cls", [tfed.FedSim, tfed.VecFedSim])
def test_mass_crash_rounds_stay_finite(cls):
    """Rounds with everyone offline cost a finite constant, never NaN or
    -inf."""
    fm = dict(p_crash=0.9, crash_rounds=4, deadline_mult=2.0, seed=2)
    res = _port_run(cls, "dasha", fm, rounds=30)
    assert np.isfinite(res.traces["sim_wall_clock"]).all()
    assert np.isfinite(res.traces["metric"]).all()
    assert (np.diff(res.traces["sim_wall_clock"]) > 0).all()
    assert (res.traces["participants"] == 0).any()


def test_corruption_is_counted_as_lost():
    """With only corruption active, the lost set is the corrupt set, and
    the heap really flipped and caught each of those records."""
    fm = dict(p_corrupt=0.2, deadline_mult=4.0, seed=4)
    sim = _port_sim(tfed.FedSim, "dasha", 1.0, fm,
                    tm.Hyper(gamma=0.05, a=0.5))
    caught = []
    verify = sim._verify_round_buffers

    def watched(bufs, t, senders, fc):
        verify(bufs, t, senders, fc)
        caught.append(int((senders & fc.corrupt[t]).sum()))

    sim._verify_round_buffers = watched
    res = sim.run(sim.init(torch.zeros(D), 0, device="cpu"), ROUNDS)
    fc = tfaults.FaultModel(**fm).draw_campaign(ROUNDS, N)
    assert res.traces["lost"].sum() == fc.corrupt.sum() == sum(caught) > 0
    np.testing.assert_array_equal(res.traces["lost"], caught)


def test_verify_round_buffers_fails_a_missed_flip():
    """The integrity drill fails loudly when a corrupted record passes the
    checksum (here: a flip that restores the byte) and when a sender has
    no record."""
    fm = tfaults.FaultModel(p_corrupt=0.5, seed=4)
    fc = fm.draw_campaign(4, N)
    t = int(np.flatnonzero(fc.corrupt.any(1))[0])
    sim = _port_sim(tfed.FedSim, "dasha", 1.0, dict(p_corrupt=0.5, seed=4),
                    tm.Hyper(gamma=0.05, a=0.5))
    rc = _comps()[1]
    vals = np.ones((N, K), np.float32)
    idxs = np.tile(np.arange(K, dtype=np.int64), (N, 1))

    class Msgs:
        values, indices = vals, idxs

    bufs = twire.encode_round(rc, None, Msgs, t, coin=False,
                              sync_values=None, present=None, slots=None)
    senders = np.ones(N, bool)
    sim._verify_round_buffers(bufs, t, senders, fc)
    i = int(np.flatnonzero(fc.corrupt[t])[0])
    # a pre-flipped record: corrupt_bytes flips it back to a valid one
    pre = list(bufs)
    pre[i] = tfaults.corrupt_bytes(bufs[i], t, i)
    with pytest.raises(RuntimeError, match="passed wire.verify"):
        sim._verify_round_buffers(pre, t, senders, fc)
    none = list(bufs)
    none[i] = None
    with pytest.raises(RuntimeError, match="no wire record"):
        sim._verify_round_buffers(none, t, senders, fc)


def test_simulate_runs_faulted_campaigns_on_both_engines():
    jp, tp = _problems()
    rc = _comps()[1]
    hp = tm.Hyper(**dataclasses.asdict(theory_hyper(
        "dasha", rc.omega, lipschitz_glm(jp), d=D, k=K, n=N, m=M)))
    out = {}
    for engine in ("heap", "vec"):
        out[engine] = tfed.simulate(
            "dasha", rc, tm.FlatSubstrate(tp, N, D), hp, torch.zeros(D), 0,
            rounds=ROUNDS, seed=3, engine=engine,
            faults=tfaults.FaultModel(**FM_MIXED),
            init_kw=dict(device="cpu"))
    for k in INT_TRACES:
        np.testing.assert_array_equal(out["heap"].traces[k],
                                      out["vec"].traces[k], err_msg=k)
    assert out["heap"].summary["dropped_rounds"] > 0


# ---------------------------------------------------------------------------
# the kill-and-restore drill, the checkpoint kept in memory
# ---------------------------------------------------------------------------

class _Killed(RuntimeError):
    """Simulated process death mid-campaign."""


def _drill(cls, variant, fm, kill_chunk, rounds=ROUNDS, chunk=8):
    """Run a faulted campaign, kill it after ``kill_chunk`` chunks (the
    checkpoint callback keeps a copy of the state, the round and the clock,
    then raises), restore into a fresh simulator, and finish: the tail's
    traces must equal an uninterrupted run's bit for bit."""
    full = _port_run(cls, variant, fm, chunk=chunk, rounds=rounds)
    saved, calls = {}, {"n": 0}

    def cp(state, next_round, now):
        saved.update(state=state._replace(**{
            k: getattr(state, k).clone() for k in ("x", "g", "g_local",
                                                   "h_local")}),
            step=next_round, wall_clock=now)
        calls["n"] += 1
        if calls["n"] == kill_chunk + 1:
            raise _Killed

    with pytest.raises(_Killed):
        _port_run(cls, variant, fm, chunk=chunk, rounds=rounds,
                  checkpoint=cp)
    cut = saved["step"]
    assert 0 < cut < rounds
    res = _port_run(cls, variant, fm, chunk=chunk, rounds=rounds,
                    state=saved["state"], start_round=cut,
                    clock0=saved["wall_clock"])
    for k in full.traces:
        np.testing.assert_array_equal(full.traces[k][cut:], res.traces[k],
                                      err_msg=k)
    assert torch.equal(full.state.x, res.state.x)


@pytest.mark.parametrize("cls", [tfed.FedSim, tfed.VecFedSim])
@pytest.mark.parametrize("kill_chunk", [0, 1, 3])
def test_kill_restore_bit_identical_dasha(cls, kill_chunk):
    _drill(cls, "dasha", FM_MIXED, kill_chunk)


@pytest.mark.parametrize("cls", [tfed.FedSim, tfed.VecFedSim])
@pytest.mark.parametrize("kill_chunk", [0, 3])
def test_kill_restore_bit_identical_sync_mvr(cls, kill_chunk):
    _drill(cls, "sync_mvr", FM_SYNC, kill_chunk)

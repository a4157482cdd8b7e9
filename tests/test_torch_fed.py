"""The port's federated slice against the reference (CPU): the sampled
cross-device round, the slab store's pieces, the network streams, the
analytic wire schema and the vectorized simulator with round barriers.

Parity runs start both packages from one state (the reference's init,
carried across by ``repro_torch.convert``) and replay the reference's
draws into the port: each round's cohort, the cohort's plan before the
n/C scale, PAGE's coin and the cohort rows' samples
(``torch_common.reference_sampled_draws``).  The network multipliers need
no replay: both packages draw them with numpy.

Tolerances: integer traces (bytes, participants, value bytes) exactly;
the simulated wall clock to rtol 1e-6 (float32 delays and a max, as in
the reference); a step's state to rtol 1e-5 / atol 1e-6; a 40-round
campaign's metric to rtol 1e-4 and its final state to rtol 1e-4 plus
1e-4 of each field's largest magnitude (float32 sums taken in another
order, compounded over the rounds and scaled by the cohort's n/C).  The
port's own slab and scatter stores must agree bit for bit, and so must
c == n against the full-participation substrate.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_common import (assert_state_close, glm_arrays, jax_glm_loss,
                          jax_stoch_problem, key_chain,
                          reference_sampled_draws, state_arrays,
                          stoch_arrays, torch_glm_loss, torch_stoch_problem)

import repro.fed as jfed
import repro.methods as jm
from repro.compress import make_round_compressor as j_make_rc
from repro.core.oracles import FiniteSumProblem as JFiniteSum
from repro.methods import substrates as jsubs
from repro_torch import convert
from repro_torch import fed as tfed
from repro_torch import methods as tm
from repro_torch.compress import make_round_compressor as t_make_rc
from repro_torch.core import rng as trng
from repro_torch.methods import substrates as tsubs

torch.set_num_threads(1)

D, K = 40, 6
STEP_ROUNDS = 4
# the campaign: several chunk writebacks (40 rounds in chunks of 16)
CN, CM, CC, CHUNK, CROUNDS = 64, 4, 8, 16, 40

COMPRESSORS = {
    "randk-sparse": ("randk", dict(k=K, backend="sparse")),
    "randk-fused": ("randk", dict(k=K, backend="fused")),
    "bernoulli": ("bernoulli", dict(p=0.3)),
    "permk": ("permk", dict()),
    "identity": ("identity", dict()),
}


def _hyper(cls, variant, omega):
    a = 1.0 / (2 * omega + 1)
    return {"dasha": cls(gamma=0.05, a=a),
            "page": cls(gamma=0.05, a=a, variant="page", p=0.3, batch=2),
            "mvr": cls(gamma=0.05, a=a, variant="mvr", b=0.3, batch=4),
            }[variant]


def _problems(variant, n, m=4, d=D):
    if variant == "mvr":
        A, b = stoch_arrays(d)
        return (jax_stoch_problem(A, b, n), torch_stoch_problem(A, b, n),
                "exact")
    feats, labels = glm_arrays(n, m, d)
    jp = JFiniteSum(loss=jax_glm_loss, features=jnp.asarray(feats),
                    labels=jnp.asarray(labels))
    tp = convert.problem_from_numpy(torch_glm_loss, feats, labels,
                                    device="cpu")
    return jp, tp, "exact"


def _pair(variant, comp, n, c, m=4):
    """(reference, port) problem, compressor, substrate and hyper."""
    name, kw = COMPRESSORS[comp]
    jp, tp, _ = _problems(variant, n, m)
    jrc = j_make_rc(name, D, n, **kw)
    trc = t_make_rc(name, D, n, device="cpu", **kw)
    jsub = jm.SampledFlatSubstrate(jp, n, D, c=c)
    tsub = tm.SampledFlatSubstrate(tp, n, D, c=c)
    omega = jsub.with_compressor(jrc).effective_omega()
    assert omega == tsub.with_compressor(trc).effective_omega()
    return (jp, jrc, jsub, _hyper(jm.Hyper, variant, omega)), \
        (tp, trc, tsub, _hyper(tm.Hyper, variant, omega))


# ---------------------------------------------------------------------------
# the slab store's pieces, the cohort draw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,length,c", [(10, 2, 2), (5, 3, 4), (23, 7, 5),
                                        (100, 16, 8), (8, 1, 8)])
def test_slab_layout_equals_reference(n, length, c):
    rng = np.random.default_rng(n * 31 + length)
    sels = np.stack([rng.choice(n, c, replace=False)
                     for _ in range(length)]).astype(np.int32)
    uniq, loc = tsubs.slab_layout(sels, n)
    juniq, jloc = jsubs.slab_layout(sels, n)
    assert uniq.dtype == juniq.dtype and loc.dtype == jloc.dtype
    assert np.array_equal(uniq, juniq) and np.array_equal(loc, jloc)
    assert np.array_equal(uniq[loc], sels)


def test_gather_slab_rows_equals_reference():
    rng = np.random.default_rng(0)
    full = rng.standard_normal((12, 5)).astype(np.float32)
    idx = np.array([0, 3, 7, 11, 12, 12], np.int32)     # two sentinels
    got = tsubs.gather_slab_rows(torch.as_tensor(full), torch.as_tensor(idx))
    want = np.asarray(jsubs.gather_slab_rows(jnp.asarray(full),
                                             jnp.asarray(idx)))
    assert np.array_equal(got.numpy(), want)


def test_cohort_schedule_is_what_each_round_draws():
    n, c = 1000, 16
    sched = trng.cohort_schedule(5, 7, 12, n, c)
    assert sched.shape == (12, c) and sched.dtype == np.int32
    for j in range(12):
        drawn = trng.RoundRandom(5, 7 + j).cohort(n, c)
        assert np.array_equal(sched[j], drawn)
        assert len(set(drawn.tolist())) == c and 0 <= drawn.min() \
            and drawn.max() < n
    # an injected cohort wins, both in the round and in the schedule
    inj = np.arange(c)
    assert np.array_equal(trng.RoundRandom(
        5, 9, trng.Draws(cohort=inj)).cohort(n, c), inj)
    sched2 = trng.cohort_schedule(
        5, 7, 12, n, c,
        lambda t: trng.Draws(cohort=inj) if t == 9 else None)
    assert np.array_equal(sched2[2], inj)
    assert np.array_equal(np.delete(sched2, 2, 0), np.delete(sched, 2, 0))


def test_cohort_draw_is_uniform():
    """Each client's inclusion frequency over 4,000 rounds is c/n within
    five binomial standard deviations."""
    n, c, rounds = 40, 10, 4000
    hits = np.bincount(trng.cohort_schedule(0, 0, rounds, n, c).ravel(),
                       minlength=n)
    p = c / n
    assert np.all(np.abs(hits - rounds * p)
                  <= 5 * np.sqrt(rounds * p * (1 - p)))


# ---------------------------------------------------------------------------
# wire schema, network streams
# ---------------------------------------------------------------------------

def _schema_cases():
    from repro_torch.compress.spec import REGISTRY
    kws = {"identity": {}, "randk": dict(k=5), "permk": {},
           "bernoulli": dict(p=0.25), "qdither": dict(s=7)}
    for name, defn in sorted(REGISTRY.items()):
        for mode in defn.modes:
            for slot_keyed in (False, True):
                yield name, kws[name], mode, slot_keyed


@pytest.mark.parametrize("name,kw,mode,slot_keyed", list(_schema_cases()))
def test_wire_schema_equals_reference(name, kw, mode, slot_keyed):
    n, d = 6, 37
    got = tfed.wire_schema(t_make_rc(name, d, n, mode=mode, device="cpu",
                                     **kw), slot_keyed=slot_keyed)
    want = jfed.wire_schema(j_make_rc(name, d, n, mode=mode, **kw),
                            slot_keyed=slot_keyed)
    assert tuple(got) == tuple(want)


def test_wire_constants_equal_reference():
    from repro.fed import wire as jwire
    from repro_torch.fed import wire as twire
    for name in ("HEADER_BYTES", "PERMK_EXT_BYTES", "PERMK_SLOT_EXT_BYTES",
                 "FMT_DENSE", "FMT_SPARSE_IDX",
                 "FMT_SPARSE_SEED", "FMT_PERMK", "FMT_PERMK_SLOT"):
        assert getattr(twire, name) == getattr(jwire, name), name
    assert twire.FMT_NAMES == jwire.FMT_NAMES


@pytest.mark.parametrize("strag", ["constant", "lognormal", "pareto"])
def test_network_multipliers_bit_equal_to_reference(strag):
    make = {"constant": lambda m: m.Constant(),
            "lognormal": lambda m: m.Lognormal(1.3),
            "pareto": lambda m: m.Pareto(1.5)}[strag]
    n, rounds = 50, 6
    out = []
    for mod in (jfed, tfed):
        up = mod.LinkModel(latency_s=0.02, bandwidth_Bps=1e5,
                           straggler=make(mod))
        down = mod.LinkModel(straggler=mod.Lognormal(0.5))
        streams = mod.campaign_streams(np.random.default_rng(11), rounds)
        out.append([mod.round_multipliers(s, down, up, n) for s in streams])
    for (jd, ju), (td, tu) in zip(*out):
        assert np.array_equal(jd, td) and np.array_equal(ju, tu)


def test_link_model_rejects_bad_links():
    with pytest.raises(ValueError):
        tfed.LinkModel(bandwidth_Bps=0.0)
    with pytest.raises(ValueError):
        tfed.LinkModel(latency_s=-1.0)


# ---------------------------------------------------------------------------
# the sampled round
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", [3, 8], ids=["c<n", "c==n"])
@pytest.mark.parametrize("comp", list(COMPRESSORS))
@pytest.mark.parametrize("variant", ["dasha", "page", "mvr"])
def test_sampled_step_parity_with_replayed_draws(variant, comp, c):
    n = 8
    (jp, jrc, jsub, jhp), (tp, trc, tsub, thp) = _pair(variant, comp, n, c)
    jmethod = jm.Method.build(variant, jrc, jsub, jhp)
    tmethod = tm.Method.build(variant, trc, tsub, thp)
    jstate = jmethod.init(jnp.zeros(D), jax.random.PRNGKey(1))
    tstate = convert.state_from_numpy(state_arrays(jstate), seed=0,
                                      device="cpu")
    jbound = jsub.with_compressor(jrc)
    jstep = jax.jit(jmethod.step_full)
    flat = tm.Method.build(variant, trc, tm.FlatSubstrate(tp, n, D), thp)
    fstate = tstate
    for _ in range(STEP_ROUNDS):
        draws = reference_sampled_draws(jstate.key, jbound, jp, jhp,
                                        variant)
        jstate, jinfo = jstep(jstate)
        tstate, tinfo = tmethod.step_full(tstate, draws=draws)
        assert_state_close(tstate, jstate)
        assert float(tinfo.payload) == pytest.approx(float(jinfo.payload),
                                                     rel=1e-6)
        if c < n:
            assert np.array_equal(tinfo.present.numpy(),
                                  np.asarray(jinfo.present))
        else:
            # c == n IS the full-participation substrate, bit for bit
            fstate, _ = flat.step_full(fstate, draws=draws)
            for f in ("x", "g", "g_local", "h_local"):
                assert torch.equal(getattr(fstate, f), getattr(tstate, f))
            assert fstate.bits_sent == tstate.bits_sent


def test_sampled_round_freezes_unsampled_rows_and_never_writes_its_input():
    _, (tp, trc, tsub, thp) = _pair("dasha", "randk-sparse", 12, 4)
    method = tm.Method.build("dasha", trc, tsub, thp)
    st = method.init(torch.zeros(D), 3, device="cpu")
    before = {f: getattr(st, f).clone() for f in ("h_local", "g_local")}
    new, info = method.step_full(st)
    for f, t in before.items():
        assert torch.equal(getattr(st, f), t)
    cohort = trng.RoundRandom(3, 0).cohort(12, 4)
    assert np.array_equal(np.flatnonzero(info.present.numpy()),
                          np.sort(cohort))
    frozen = ~info.present
    for f in ("h_local", "g_local"):
        assert torch.equal(getattr(new, f)[frozen], before[f][frozen])
    # g stays the mean of the g_i (the n/C inflation keeps it unbiased)
    assert torch.allclose(new.g, new.g_local.mean(0), rtol=1e-5, atol=1e-6)


def test_window_round_equals_the_drawn_round():
    """window=(clients, sel, loc) on a slab holding the cohort's rows gives the
    round the substrate draws itself, and writes the slab in place."""
    _, (tp, trc, tsub, thp) = _pair("page", "randk-fused", 12, 4)
    method = tm.Method.build("page", trc, tsub, thp)
    st = method.init(torch.zeros(D), 3, device="cpu")
    drawn, _ = method.step_full(st)
    sel = trng.RoundRandom(3, 0).cohort(12, 4)
    uniq, loc = tsubs.slab_layout(sel[None].astype(np.int32), 12)
    idx = torch.as_tensor(uniq)
    slab = st._replace(h_local=tsubs.gather_slab_rows(st.h_local, idx),
                       g_local=tsubs.gather_slab_rows(st.g_local, idx))
    new, _ = method.step_full(slab, window=(
        sel, torch.as_tensor(sel), torch.as_tensor(loc[0]).to(torch.int64)))
    assert new.h_local is slab.h_local          # the slab, in place
    for f in ("h_local", "g_local"):
        assert torch.equal(getattr(new, f), getattr(drawn, f)[idx])
    assert torch.equal(new.x, drawn.x) and torch.equal(new.g, drawn.g)


def test_stochastic_cohort_samples_are_keyed_by_client_id():
    """A client's noise depends on its id and the round, not its slot."""
    A, b = stoch_arrays(D)
    tp = torch_stoch_problem(A, b, 6)
    rnd = trng.RoundRandom(4, 2)
    one = rnd.client_samples(tp, 3, np.array([5, 1]))
    two = rnd.client_samples(tp, 3, np.array([1, 5]))
    assert torch.equal(one[0], two[1]) and torch.equal(one[1], two[0])


def test_sampled_substrate_rejections():
    _, (tp, trc, tsub, thp) = _pair("dasha", "randk-sparse", 12, 4)
    for variant in ("sync_mvr", "marina"):
        with pytest.raises(ValueError, match="sync_requires_all"):
            tm.Method.build(variant, trc, tsub,
                            tm.Hyper(gamma=0.1, a=0.1, variant=variant))
    with pytest.raises(ValueError):
        tm.SampledFlatSubstrate(tp, 12, D, c=0)
    with pytest.raises(ValueError):
        tm.SampledFlatSubstrate(tp, 12, D, c=13)
    pp = t_make_rc("randk", D, 12, k=K, p_participate=0.5, device="cpu")
    with pytest.raises(ValueError, match="sampled twice"):
        tm.SampledFlatSubstrate(tp, 12, D, c=4, rc=pp)
    flat = tm.Method.build("dasha", trc, tm.FlatSubstrate(tp, 12, D), thp)
    st = flat.init(torch.zeros(D), 0, device="cpu")
    with pytest.raises(ValueError, match="window"):
        flat.step_full(st, window=(np.zeros(4, np.int64), torch.zeros(4, dtype=torch.int64),
                                  torch.zeros(4, dtype=torch.int64)))


def test_cohort_rc_redimensions_permk_to_the_cohort():
    _, (tp, trc, tsub, _) = _pair("dasha", "permk", 12, 4)
    crc = tsub.with_compressor(trc).cohort_rc
    assert crc.n == 4 and crc.spec.n == 4 and crc.omega == 3.0
    sch = tfed.wire_schema(crc, slot_keyed=True)
    assert sch.static_count == 10 and sch.header_bytes == 32


# ---------------------------------------------------------------------------
# the campaign
# ---------------------------------------------------------------------------

def _campaign_pair(variant, comp, store, **simkw):
    (jp, jrc, jsub, jhp), (tp, trc, tsub, thp) = _pair(variant, comp, CN,
                                                       CC, m=CM)
    links = dict(uplink=jfed.LinkModel(latency_s=0.02, bandwidth_Bps=1e5,
                                       straggler=jfed.Lognormal(1.0)))
    tlinks = dict(uplink=tfed.LinkModel(latency_s=0.02, bandwidth_Bps=1e5,
                                        straggler=tfed.Lognormal(1.0)))
    jsim = jfed.VecFedSim(variant, jrc, jsub, jhp, seed=3, chunk=CHUNK,
                          store=store, **links, **simkw)
    tsim = tfed.VecFedSim(variant, trc, tsub, thp, seed=3, chunk=CHUNK,
                          store=store, **tlinks, **simkw)
    return jp, jsub.with_compressor(jrc), jhp, jsim, tsim


def _assert_campaign_state_close(port_state, ref_state):
    """Each field within 1e-4 of its largest magnitude: the float32 drift
    of 40 rounds grows with the field's scale (PermK's and the cohort's
    rescales reach C * n/C = n), so elements near zero carry errors of
    the large ones' ulps."""
    for name in ("x", "g", "g_local", "h_local"):
        want = np.asarray(getattr(ref_state, name))
        np.testing.assert_allclose(
            getattr(port_state, name).numpy(), want, rtol=1e-4,
            atol=1e-4 * float(np.abs(want).max()), err_msg=name)
    assert port_state.t == int(ref_state.t)
    assert port_state.bits_sent == np.float32(ref_state.bits_sent)


EXACT_TRACES = ("bytes_up", "value_bytes", "bytes_down", "participants",
                "sync_round")


@pytest.mark.parametrize("store", ["slab", "scatter"])
@pytest.mark.parametrize("variant,comp", [("dasha", "randk-sparse"),
                                          ("dasha", "bernoulli"),
                                          ("page", "randk-fused"),
                                          ("mvr", "permk")])
def test_campaign_parity_with_replayed_draws(variant, comp, store):
    jp, jbound, jhp, jsim, tsim = _campaign_pair(variant, comp, store)
    jstate = jsim.init(jnp.zeros(D), jax.random.PRNGKey(1))
    tstate = convert.state_from_numpy(state_arrays(jstate), seed=0,
                                      device="cpu")
    draws = [reference_sampled_draws(k, jbound, jp, jhp, variant)
             for k in key_chain(jstate.key, CROUNDS)]
    jres = jsim.run(jstate, CROUNDS)
    tres = tsim.run(tstate, CROUNDS, draws=lambda t: draws[t])
    assert set(tres.traces) == set(jres.traces)
    for k in EXACT_TRACES:
        assert np.array_equal(tres.traces[k], jres.traces[k]), k
    assert np.array_equal(tres.traces["bits_sent"], jres.traces["bits_sent"])
    for k in ("sim_wall_clock", "bcast_clock"):
        np.testing.assert_allclose(tres.traces[k], jres.traces[k],
                                   rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(tres.traces["metric"], jres.traces["metric"],
                               rtol=1e-4, atol=1e-7)
    _assert_campaign_state_close(tres.state, jres.state)
    for k in ("rounds", "bytes_up", "bytes_down", "sync_rounds",
              "mean_participants", "mean_bytes_up_per_round"):
        assert tres.summary[k] == jres.summary[k], k
    assert tres.summary["wall_clock_s"] == pytest.approx(
        jres.summary["wall_clock_s"], rel=1e-6)
    assert np.all(tres.traces["participants"] == CC)


def _port_sim(variant="dasha", comp="randk-sparse", store="auto", n=23,
              c=5, chunk=7, **kw):
    _, (tp, trc, tsub, thp) = _pair(variant, comp, n, c)
    return tfed.VecFedSim(variant, trc, tsub, thp, seed=3, chunk=chunk,
                          store=store, uplink=tfed.LinkModel(
                              latency_s=0.01, bandwidth_Bps=1e5,
                              straggler=tfed.Lognormal(1.0)), **kw)


def _assert_bit_identical(a, b, label=""):
    assert set(a.traces) == set(b.traces), label
    for k in a.traces:
        assert np.array_equal(a.traces[k], b.traces[k]), (label, k)
    for f in ("x", "g", "g_local", "h_local"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), \
            (label, f)
    assert a.state.t == b.state.t and a.state.bits_sent == b.state.bits_sent


@pytest.mark.parametrize("variant,comp", [("dasha", "randk-sparse"),
                                          ("dasha", "bernoulli"),
                                          ("page", "randk-fused"),
                                          ("mvr", "permk")])
def test_slab_store_bit_equal_to_scatter(variant, comp):
    """The port's own draws: the slab store equals the scatter store bit
    for bit, for chunk sizes that do and do not divide the rounds."""
    sim = _port_sim(variant, comp, "scatter")
    st = sim.init(torch.zeros(D), 42, device="cpu")
    ref = sim.run(st, 15)
    for chunk in (1, 7, 15):
        got = _port_sim(variant, comp, "slab", chunk=chunk).run(st, 15)
        _assert_bit_identical(ref, got, f"{variant} {comp} chunk={chunk}")


@pytest.mark.parametrize("variant", ["dasha", "page", "mvr"])
def test_c_equals_n_is_the_full_participation_campaign(variant):
    n = 12
    sampled = _port_sim(variant, "randk-fused", n=n, c=n)
    assert not sampled.slab
    _, (tp, trc, _, thp) = _pair(variant, "randk-fused", n, n)
    flat = tfed.VecFedSim(variant, trc, tm.FlatSubstrate(tp, n, D), thp,
                          seed=3, chunk=7, uplink=sampled.uplink)
    st = flat.init(torch.zeros(D), 9, device="cpu")
    _assert_bit_identical(flat.run(st, 15), sampled.run(st, 15), variant)


@pytest.mark.parametrize("store", ["slab", "scatter"])
def test_run_never_writes_its_input_state(store):
    sim = _port_sim("page", "randk-fused", store)
    st = sim.init(torch.zeros(D), 1, device="cpu")
    assert st.h_local is st.g_local       # init shares the one gradient
    before = {f: getattr(st, f).clone() for f in ("x", "g", "h_local")}
    first = sim.run(st, 20)
    for f, t in before.items():
        assert torch.equal(getattr(st, f), t), f
    assert st.t == 0
    _assert_bit_identical(first, sim.run(st, 20), store)


@pytest.mark.parametrize("store", ["slab", "scatter"])
def test_resume_from_a_checkpoint_continues_bit_identically(store):
    sim = _port_sim("dasha", "randk-sparse", store, chunk=6)
    st = sim.init(torch.zeros(D), 1, device="cpu")
    full = sim.run(st, 20)
    saved = {}
    sim.run(st, 20, checkpoint=lambda s, r, w: saved.setdefault(r, (s, w)))
    assert sorted(saved) == [6, 12, 18, 20]
    mid, wall = saved[12]
    assert mid.t == 12 and wall == full.traces["sim_wall_clock"][11]
    rest = sim.run(mid, 20, start_round=12, clock0=wall)
    for k in full.traces:
        assert np.array_equal(rest.traces[k], full.traces[k][12:]), k
    for f in ("x", "g", "g_local", "h_local"):
        assert torch.equal(getattr(rest.state, f), getattr(full.state, f))
    # a later chunk never wrote the snapshot handed to the checkpoint
    assert torch.equal(saved[12][0].h_local, mid.h_local)
    again = sim.run(saved[6][0], 20, start_round=6,
                    clock0=saved[6][1])
    assert torch.equal(again.state.g_local, full.state.g_local)


def test_vecsim_rejections():
    with pytest.raises(NotImplementedError, match="tau"):
        _port_sim(tau=1)
    with pytest.raises(NotImplementedError, match="faults"):
        _port_sim(faults=object())
    sim = _port_sim()
    st = sim.init(torch.zeros(D), 0, device="cpu")
    with pytest.raises(NotImplementedError, match="obs"):
        sim.run(st, 3, obs=object())
    with pytest.raises(ValueError, match="slab"):
        _port_sim(store="slab", n=8, c=8)
    with pytest.raises(ValueError, match="store"):
        _port_sim(store="heap")
    _, (_, trc, tsub, _) = _pair("dasha", "randk-sparse", 12, 4)
    with pytest.raises(ValueError, match="sync_requires_all"):
        tfed.VecFedSim("marina", trc, tsub,
                       tm.Hyper(gamma=0.1, a=0.0, variant="marina"))
    with pytest.raises(ValueError, match="start_round"):
        sim.run(st, 3, start_round=4)
    empty = sim.run(st, 0)
    assert empty.traces == {} and empty.state is st


def test_sampled_campaign_bills_the_cohort_only():
    """Bytes follow the cohort: C uploads of (20 + 8K) bytes (RandK's
    private support) and a C-client broadcast every round."""
    n, c = 23, 5
    sim = _port_sim("dasha", "randk-sparse", n=n, c=c)
    res = sim.run(sim.init(torch.zeros(D), 0, device="cpu"), 10)
    assert np.all(res.traces["bytes_up"] == c * (20 + 8 * K))
    assert np.all(res.traces["value_bytes"] == c * 4 * K)
    assert np.all(res.traces["bytes_down"] == c * 4 * D)
    assert np.all(np.diff(res.traces["sim_wall_clock"]) > 0)
    assert res.summary["mean_participants"] == c
    assert np.all(np.isfinite(res.traces["metric"]))


def test_fed_package_exports():
    for name in ("VecFedSim", "LinkModel", "Constant", "Lognormal",
                 "Pareto", "campaign_streams", "round_multipliers",
                 "wire_schema"):
        assert hasattr(tfed, name), name
    assert dataclasses.is_dataclass(tfed.VecFedSim)

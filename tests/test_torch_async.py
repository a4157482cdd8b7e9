"""The port's asynchronous pipelined rounds (``tau=``, DESIGN.md §14) on
the CPU: the engine's ``deficit=`` hook, ``VecFedSim`` and ``FedSim``
with a staleness bound, against the port's own barrier runs, against each
other, and against the reference, at ``tests/test_fed_async.py``'s size
(D = 40, N = 5, sparse RandK K = 6, 30 rounds, its links).

Port-only contracts (the port's own draws):

* tau = 0 is each simulator's own barrier run, bit for bit (every trace
  and the final state), for all five variants;
* the heap oracle and the vectorized simulator agree at tau in {1, 2, 3}:
  integer traces exactly, clocks to rtol 2e-5, the metric to rtol 1e-4
  and the final iterate to rtol 1e-4 / atol 1e-7 (the heap sums its
  deficit in numpy, the vec on the device, in other orders);
* the slab store equals the scatter store bit for bit at tau in {0, 1,
  2}, in both simulators (n = 23, C = 5);
* landings commute, ``deficit=0`` is ``deficit=None`` bit for bit, a
  deficit v moves x by exactly gamma * v, and the tree substrate's
  ``sub_deficit`` is leaf-wise;
* the schedule: DASHA overlaps rounds, MARINA never lets a broadcast
  cross a coin round's completion, the async wall clock is monotone in
  the straggler severity under common random numbers, and the heap's
  event log interleaves rounds.

Against the reference: both packages start from one state (the
reference's init, carried across by ``repro_torch.convert``) and the port
replays the reference's per-round draws (``torch_common.reference_draws``);
the network streams are numpy on both sides.  Integer traces and the heap's
event kinds, clients, rounds and bytes equal exactly; the heap's clocks
exactly (the same float64 arithmetic on the same integers and draws), the
vectorized simulator's to rtol 2e-6 (float32); the metric to rtol 1e-4
and the final iterate to rtol 1e-5 / atol 1e-7.  The heap's host deficit
is held bit for bit against the deficit the reference's own heap computes
from the same ring.
"""
import collections
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
from repro_torch import convert
from repro_torch import fed as tfed
from repro_torch import methods as tm
from repro_torch.bench import common as tbench
from repro_torch.compress import make_round_compressor as t_make_rc
from repro_torch.core.oracles import FiniteSumProblem
from repro_torch.data.pipeline import synthetic_classification
from repro_torch.fed.sim import host_deficit

torch.set_num_threads(1)

D, K, N, M, ROUNDS = 40, 6, 5, 32, 30
VARIANTS = ["dasha", "page", "mvr", "sync_mvr", "marina"]
INT_TRACES = ("bytes_up", "value_bytes", "bytes_down", "sync_round",
              "participants")
STATE = ("x", "g", "g_local", "h_local")


def _sync_p(variant):
    """The reference tests' coin probability for the sync rules."""
    return 0.3 if variant in ("sync_mvr", "marina") else None


@functools.lru_cache(maxsize=None)
def _problems():
    jp = glm_problem(d=D, m=M)
    tp = convert.problem_from_numpy(torch_glm_loss, np.asarray(jp.features),
                                    np.asarray(jp.labels), device="cpu")
    return jp, tp


@functools.lru_cache(maxsize=None)
def _hypers(variant, p=None):
    """(reference, port) Hyper: the reference bench's theory constants."""
    jp, _ = _problems()
    jrc = j_make_rc("randk", D, N, k=K, backend="sparse")
    jhp = theory_hyper(variant, jrc.omega, lipschitz_glm(jp), d=D, k=K, n=N,
                       m=M)
    if p is not None:
        jhp = dataclasses.replace(jhp, p=p)
    return jhp, tm.Hyper(**dataclasses.asdict(jhp))


def _links(fed, sigma):
    """``tests/test_fed_async.py``'s links, in either package."""
    return dict(uplink=fed.LinkModel(latency_s=0.01, bandwidth_Bps=1e5,
                                     straggler=fed.Lognormal(sigma)),
                downlink=fed.LinkModel(latency_s=0.005, bandwidth_Bps=1e7))


def _port_sim(cls, variant, tau, *, sigma=1.5, p=None, seed=3, **kw):
    _, tp = _problems()
    trc = t_make_rc("randk", D, N, k=K, backend="sparse", device="cpu")
    return cls(variant, trc, tm.FlatSubstrate(tp, N, D),
               _hypers(variant, p)[1], seed=seed, tau=tau,
               **_links(tfed, sigma), **kw)


def _port_run(cls, variant, tau, rounds=ROUNDS, *, run_kw=None, **kw):
    sim = _port_sim(cls, variant, tau, **kw)
    return sim.run(sim.init(torch.zeros(D), 1, device="cpu"), rounds,
                   **(run_kw or {}))


def _assert_bit_identical(a, b, label=""):
    assert set(a.traces) == set(b.traces), label
    for k in a.traces:
        assert np.array_equal(a.traces[k], b.traces[k]), (label, k)
    for f in STATE:
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), \
            (label, f)
    assert a.state.t == b.state.t and a.state.bits_sent == b.state.bits_sent


# ---------------------------------------------------------------------------
# tau = 0 is the barrier, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("cls", [tfed.FedSim, tfed.VecFedSim],
                         ids=["heap", "vec"])
def test_tau0_is_the_barrier_bit_for_bit(cls, variant):
    """tau = 0 repeats the simulator's own barrier run: the same engine
    rounds (no deficit), the same float64 clock chain."""
    p = _sync_p(variant)
    rb = _port_run(cls, variant, None, p=p)
    r0 = _port_run(cls, variant, 0, p=p)
    _assert_bit_identical(rb, r0, variant)
    assert r0.summary["tau"] == 0.0
    assert r0.summary["wall_clock_s"] == rb.summary["wall_clock_s"]


# ---------------------------------------------------------------------------
# the two async simulators agree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tau", [1, 2, 3])
@pytest.mark.parametrize("variant", VARIANTS)
def test_heap_and_vec_agree(variant, tau):
    p = _sync_p(variant)
    rh = _port_run(tfed.FedSim, variant, tau, p=p)
    rv = _port_run(tfed.VecFedSim, variant, tau, p=p)
    for k in INT_TRACES:
        np.testing.assert_array_equal(rh.traces[k], rv.traces[k],
                                      err_msg=k)
    np.testing.assert_array_equal(rh.traces["bits_sent"],
                                  rv.traces["bits_sent"])
    for k in ("sim_wall_clock", "bcast_clock"):
        np.testing.assert_allclose(rv.traces[k], rh.traces[k], rtol=2e-5,
                                   atol=1e-8, err_msg=k)
    np.testing.assert_allclose(rv.traces["metric"], rh.traces["metric"],
                               rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(rv.state.x.numpy(), rh.state.x.numpy(),
                               rtol=1e-4, atol=1e-7)
    assert rv.summary["wall_clock_s"] == pytest.approx(
        rh.summary["wall_clock_s"], rel=2e-5)
    assert rh.summary["tau"] == rv.summary["tau"] == float(tau)


# ---------------------------------------------------------------------------
# slab == scatter
# ---------------------------------------------------------------------------

SN, SC, SM = 23, 5, 4


def _sampled_sim(cls, variant, tau, store, chunk=7):
    feats, labels = synthetic_classification(0, SN, SM, D, device="cpu")
    prob = FiniteSumProblem(loss=tbench.glm_loss, features=feats,
                            labels=labels)
    rc = t_make_rc("randk", D, SN, k=K, backend="sparse", device="cpu")
    hp = tbench.theory_hyper(variant, rc.omega, tbench.lipschitz_glm(prob),
                             d=D, k=K, n=SN, m=SM)
    return cls(variant, rc, tm.SampledFlatSubstrate(prob, SN, D, c=SC), hp,
               seed=3, chunk=chunk, tau=tau, store=store,
               **_links(tfed, 1.5))


def _sampled_run(sim, rounds=15):
    return sim.run(sim.init(torch.zeros(D), 42, device="cpu"), rounds)


@pytest.mark.parametrize("tau", [0, 1, 2])
@pytest.mark.parametrize("variant", ["dasha", "page", "mvr"])
def test_vec_slab_equals_scatter(variant, tau):
    """VecFedSim on a sampled substrate: the slab store's async campaign
    equals the scatter store's bit for bit, at chunk sizes 1, 7 and 15 (15
    rounds: 7 leaves a ragged last chunk)."""
    want = _sampled_run(_sampled_sim(tfed.VecFedSim, variant, tau,
                                     "scatter"))
    for chunk in (1, 7, 15):
        got = _sampled_run(_sampled_sim(tfed.VecFedSim, variant, tau, "slab",
                                        chunk))
        _assert_bit_identical(want, got, f"{variant} tau={tau} R={chunk}")
    assert np.all(want.traces["participants"] == SC)


@pytest.mark.parametrize("tau", [0, 1, 2])
def test_heap_slab_equals_scatter(tau):
    """FedSim: store= changes no bit at any tau, byte traces included (at
    tau >= 1 every round is a one-round slab chunk)."""
    want = _sampled_run(_sampled_sim(tfed.FedSim, "dasha", tau, "scatter"))
    got = _sampled_run(_sampled_sim(tfed.FedSim, "dasha", tau, "slab"))
    _assert_bit_identical(want, got, f"tau={tau}")
    vec = _sampled_run(_sampled_sim(tfed.VecFedSim, "dasha", tau, "slab"))
    for k in INT_TRACES:
        assert np.array_equal(got.traces[k], vec.traces[k]), k


# ---------------------------------------------------------------------------
# the math the pipeline leans on
# ---------------------------------------------------------------------------

def _method(variant="dasha"):
    _, tp = _problems()
    trc = t_make_rc("randk", D, N, k=K, backend="sparse", device="cpu")
    return tm.Method.build(variant, trc, tm.FlatSubstrate(tp, N, D),
                           _hypers(variant)[1])


def test_landings_commute():
    """g^{t+1} = g^t + (1/n) sum_i m_i: applying one round's messages one
    landing at a time, in any order, gives the engine's g."""
    m = _method()
    st = m.init(torch.zeros(D), 7, device="cpu")
    for _ in range(3):
        st = m.step(st)
    new, info = m.step_full(st, None)
    rows = info.messages.dense().double().numpy()
    g0 = st.g.double().numpy()
    rng = np.random.default_rng(0)
    for perm in (np.arange(N), rng.permutation(N), rng.permutation(N)):
        g = g0.copy()
        for i in perm:
            g += rows[i] / N
        np.testing.assert_allclose(g, new.g.numpy(), rtol=1e-5, atol=1e-7)


def test_deficit_hook_shifts_the_server_step():
    """``deficit=0`` is ``deficit=None`` bit for bit, every field; a
    deficit v makes the server step along g - v, so x moves by exactly
    gamma * v."""
    m = _method()
    gamma = _hypers("dasha")[1].gamma
    st = m.step(m.init(torch.zeros(D), 2, device="cpu"))
    base, _ = m.step_full(st, None)
    zero, _ = m.step_full(st, None, deficit=torch.zeros(D))
    for f in STATE:
        assert torch.equal(getattr(base, f), getattr(zero, f)), f
    assert zero.bits_sent == base.bits_sent and zero.t == base.t
    v = torch.linspace(-1, 1, D)
    shifted, _ = m.step_full(st, None, deficit=v)
    np.testing.assert_allclose((shifted.x - base.x).numpy(),
                               (gamma * v).numpy(), rtol=1e-5, atol=1e-7)


def test_lane_substrate_refuses_a_deficit():
    _, tp = _problems()
    lanes = tm.FlatSubstrate(tp, N, D).with_lanes(2)
    with pytest.raises(ValueError, match="lane"):
        lanes.sub_deficit(torch.zeros(2, D), torch.zeros(D))


def test_tree_substrate_subtracts_the_deficit_leaf_by_leaf():
    sub = tm.TreeSubstrate(oracle=None, n=2, server_opt=None)
    g = {"w": torch.arange(6.0).reshape(2, 3),
         "blk": {"b": torch.ones(4), "a": torch.full((2,), 5.0)}}
    v = {"w": torch.full((2, 3), 0.5),
         "blk": {"b": torch.arange(4.0), "a": torch.tensor([1.0, -1.0])}}
    out = sub.sub_deficit(g, v)
    assert sorted(out) == ["blk", "w"] and sorted(out["blk"]) == ["a", "b"]
    assert torch.equal(out["w"], g["w"] - 0.5)
    assert torch.equal(out["blk"]["b"], torch.ones(4) - torch.arange(4.0))
    assert torch.equal(out["blk"]["a"], torch.tensor([4.0, 6.0]))


# ---------------------------------------------------------------------------
# against the reference, on its own draws
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference(cls_name, variant, tau, rounds=ROUNDS):
    """The reference's async campaign (its heap with the event log), its
    init state and its per-round draws."""
    jp, _ = _problems()
    p = _sync_p(variant)
    jrc = j_make_rc("randk", D, N, k=K, backend="sparse")
    jhp = _hypers(variant, p)[0]
    sim = getattr(jfed, cls_name)(variant, jrc, jm.FlatSubstrate(jp, N, D),
                                  jhp, seed=3, tau=tau,
                                  **_links(jfed, 1.5))
    st = sim.init(np.zeros(D, np.float32), jax.random.PRNGKey(0))
    draws = [reference_draws(k, jrc, jp, jhp, variant)
             for k in key_chain(st.key, rounds)]
    kw = {"log_events": True} if cls_name == "FedSim" else {}
    return sim.run(st, rounds, **kw), st, draws


@pytest.mark.parametrize("tau", [1, 2])
@pytest.mark.parametrize("variant", ["dasha", "page", "marina"])
@pytest.mark.parametrize("cls", [tfed.FedSim, tfed.VecFedSim],
                         ids=["heap", "vec"])
def test_async_matches_the_reference(cls, variant, tau):
    jres, jst, draws = _reference(cls.__name__, variant, tau)
    sim = _port_sim(cls, variant, tau, p=_sync_p(variant))
    st = convert.state_from_numpy(state_arrays(jst), seed=0, device="cpu")
    kw = {"log_events": True} if cls is tfed.FedSim else {}
    tres = sim.run(st, ROUNDS, draws=lambda t: draws[t], **kw)
    assert set(tres.traces) == set(jres.traces)
    for k in INT_TRACES:
        np.testing.assert_array_equal(tres.traces[k], jres.traces[k],
                                      err_msg=k)
    np.testing.assert_array_equal(tres.traces["bits_sent"],
                                  jres.traces["bits_sent"])
    for k in ("sim_wall_clock", "bcast_clock"):
        if cls is tfed.FedSim:
            np.testing.assert_array_equal(tres.traces[k], jres.traces[k],
                                          err_msg=k)
        else:
            np.testing.assert_allclose(tres.traces[k], jres.traces[k],
                                       rtol=2e-6, err_msg=k)
    np.testing.assert_allclose(tres.traces["metric"], jres.traces["metric"],
                               rtol=1e-4)
    np.testing.assert_allclose(tres.state.x.numpy(), np.asarray(jres.state.x),
                               rtol=1e-5, atol=1e-7)
    for k in ("rounds", "bytes_up", "bytes_down", "sync_rounds",
              "mean_participants", "tau"):
        assert tres.summary[k] == jres.summary[k], k
    if cls is tfed.FedSim:
        got = [(e.kind, e.client, e.round, e.nbytes) for e in tres.events]
        want = [(e.kind, int(e.client), int(e.round), int(e.nbytes))
                for e in jres.events]
        assert got == want
        assert [e.time for e in tres.events] == \
            [float(e.time) for e in jres.events]
        if variant == "marina":
            assert tres.summary["sync_rounds"] > 0


def test_heap_host_deficit_is_the_references_bit_for_bit():
    """The reference's heap at tau = 2 is watched: the deficit it hands its
    round, its rounds' dense message rows and (from its event log) every
    client's landing and every broadcast.  The port's ``host_deficit``
    over the same ring gives the same float32 vector, bit for bit, every
    round."""
    jp, _ = _problems()
    jrc = j_make_rc("randk", D, N, k=K, backend="sparse")
    tau = 2
    sim = jfed.FedSim("dasha", jrc, jm.FlatSubstrate(jp, N, D),
                      _hypers("dasha")[0], seed=3, tau=tau,
                      **_links(jfed, 2.0))
    seen, rows = [], []
    round_fn, dense_rows = sim._round_fn, sim._dense_rows

    def watched_round_fn(metric_fn):
        fn = round_fn(metric_fn)

        def one(st, deficit):
            seen.append(np.array(deficit))
            return fn(st, deficit)
        return one

    def watched_dense_rows(vals, idxs):
        out = dense_rows(vals, idxs)
        rows.append(out)
        return out

    sim._round_fn, sim._dense_rows = watched_round_fn, watched_dense_rows
    res = sim.run(sim.init(np.zeros(D, np.float32), jax.random.PRNGKey(0)),
                  ROUNDS, log_events=True)
    bcast = {e.round: e.time for e in res.events if e.kind == "bcast"}
    lands = collections.defaultdict(dict)
    for e in res.events:
        if e.kind == "apply":
            lands[e.round][e.client] = e.time
    assert len(seen) == len(rows) == ROUNDS
    ring = collections.deque([{"floor": -np.inf, "arr": None, "msgs": None}
                              for _ in range(tau + 1)], maxlen=tau + 1)
    nonzero = 0
    for t in range(ROUNDS):
        got = host_deficit(ring, bcast[t], N, D)
        assert got.dtype == np.float32
        assert got.tobytes() == seen[t].tobytes(), t
        nonzero += int(np.any(got != 0))
        clients = sorted(lands[t])
        ring.append({"floor": None,
                     "arr": np.array([lands[t][i] for i in clients]),
                     "msgs": rows[t][clients]})
    assert nonzero > 0


# ---------------------------------------------------------------------------
# the schedule: pipelining pays, coin rounds still barrier
# ---------------------------------------------------------------------------

def test_async_beats_the_barrier_under_stragglers():
    rb = _port_run(tfed.FedSim, "dasha", None, 40, sigma=2.0)
    ra = _port_run(tfed.FedSim, "dasha", 2, 40, sigma=2.0)
    assert ra.summary["wall_clock_s"] < rb.summary["wall_clock_s"]


def test_dasha_overlaps_rounds_and_marina_flushes_at_its_coins():
    """DASHA broadcasts round t + 1 before round t has fully landed on some
    round; MARINA never lets a broadcast cross a coin round's
    completion."""
    ra = _port_run(tfed.FedSim, "dasha", 2, 40, sigma=2.0)
    bc, land = ra.traces["bcast_clock"], ra.traces["sim_wall_clock"]
    assert (bc[1:] < land[:-1] - 1e-12).any()
    for cls in (tfed.FedSim, tfed.VecFedSim):
        rm = _port_run(cls, "marina", 2, 40, sigma=2.0, p=0.3)
        bc, land = rm.traces["bcast_clock"], rm.traces["sim_wall_clock"]
        coins = rm.traces["sync_round"].astype(bool)
        assert coins[:-1].any()
        for t in np.flatnonzero(coins[:-1]):
            assert bc[t + 1] >= land[t] - 1e-9
        assert (bc[1:] < land[:-1] - 1e-12).any()   # it pipelines between


def test_async_wall_clock_is_monotone_in_severity():
    """Common random numbers across severities: raising sigma slows the
    async campaign, and async never loses to the barrier at any
    severity."""
    walls = []
    for sigma in (0.5, 1.0, 1.5, 2.0):
        ra = _port_run(tfed.FedSim, "dasha", 2, sigma=sigma)
        rb = _port_run(tfed.FedSim, "dasha", None, sigma=sigma)
        assert ra.summary["wall_clock_s"] \
            <= rb.summary["wall_clock_s"] + 1e-12
        walls.append(ra.summary["wall_clock_s"])
    assert all(a < b for a, b in zip(walls, walls[1:]))


def test_event_log_interleaves_rounds():
    """Some round-t upload lands after round t + 1's broadcast, and every
    round logs one broadcast, its clients' landings in time order and its
    completion."""
    res = _port_run(tfed.FedSim, "dasha", 2, sigma=2.0,
                    run_kw={"log_events": True})
    bcast_at = {e.round: e.time for e in res.events if e.kind == "bcast"}
    assert sorted(bcast_at) == list(range(ROUNDS))
    late = [e for e in res.events if e.kind == "apply"
            and e.round + 1 in bcast_at
            and e.time > bcast_at[e.round + 1] + 1e-12]
    assert late, "no upload ever landed after the next broadcast"
    for t in range(ROUNDS):
        mine = [e for e in res.events if e.round == t]
        assert [e.kind for e in mine] == \
            ["bcast"] + ["apply"] * N + ["round"]
        times = [e.time for e in mine[1:-1]]
        assert times == sorted(times) and mine[-1].time == times[-1]
        assert mine[-1].time == res.traces["sim_wall_clock"][t]


# ---------------------------------------------------------------------------
# what tau composes with
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls", [tfed.FedSim, tfed.VecFedSim],
                         ids=["heap", "vec"])
def test_resume_is_barrier_only(cls):
    """As in the reference: the pipeline's ring is not in a checkpoint, so
    an asynchronous campaign refuses every resume argument."""
    sim = _port_sim(cls, "dasha", 1)
    st = sim.init(torch.zeros(D), 1, device="cpu")
    for kw in (dict(start_round=2), dict(clock0=0.5),
               dict(checkpoint=lambda *a: None)):
        with pytest.raises(ValueError, match="barrier-only"):
            sim.run(st, 4, **kw)
    with pytest.raises(ValueError, match="tau"):
        _port_sim(cls, "dasha", -1)
    with pytest.raises(ValueError, match="tau"):
        _port_sim(cls, "dasha", 1, faults=tfed.FaultModel())
    empty = sim.run(st, 0)
    assert empty.state is st


def test_simulate_runs_async_rounds_on_both_engines():
    _, tp = _problems()
    trc = t_make_rc("randk", D, N, k=K, backend="sparse", device="cpu")
    args = ("dasha", trc, tm.FlatSubstrate(tp, N, D), _hypers("dasha")[1],
            torch.zeros(D), 1)
    kw = dict(rounds=20, seed=3, tau=2, init_kw=dict(device="cpu"),
              **_links(tfed, 1.5))
    rh = tfed.simulate(*args, log_events=True, **kw)
    rv = tfed.simulate(*args, engine="vec", **kw)
    for k in INT_TRACES:
        assert np.array_equal(rh.traces[k], rv.traces[k]), k
    np.testing.assert_allclose(rv.traces["sim_wall_clock"],
                               rh.traces["sim_wall_clock"], rtol=2e-5)
    assert rh.summary["tau"] == rv.summary["tau"] == 2.0
    assert {e.kind for e in rh.events} == {"bcast", "apply", "round"}

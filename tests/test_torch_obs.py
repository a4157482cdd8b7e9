"""The port's campaign telemetry (``repro_torch.obs``, DESIGN.md §17)
against the reference's ``repro.obs`` on the CPU, at ``tests/test_obs.py``'s
size: D = 40, N = 5, sparse RandK K = 6, 12 rounds, its links.

What is held, in dependency order:

* the same events give identical ``validate()`` problems, an identical
  Perfetto dict, identical ``round_byte_sums`` and ``merge`` results in
  both packages, and the same instrument operations identical JSONL lines
  and in-memory records, ``wall_s`` apart;
* on the reference's replayed draws (``torch_common.reference_draws``), the
  port heap's live timeline equals the reference heap's event for event
  for ``dasha`` and ``marina``, barrier, faulted and tau = 2: tracks,
  names, kinds and args exactly, timestamps bit for bit (both heaps run the
  same float64 arithmetic on the same integers and draws, so no tolerance
  is needed);
* byte reconciliation: summing the recorded ``up`` spans and server round
  spans gives the heap's traced ``bytes_up`` / ``bytes_down`` exactly, for
  all five variants, barrier and tau = 2, and for faulted DASHA;
* the port's vec reconstruction equals the port heap's live recording
  event for event with bit-equal float64 timestamps (dense, sampled,
  Bernoulli counts, and on the reference's draws, where it also equals
  the reference heap's), and refuses ``tau`` and ``p_participate < 1``;
* ``attribute`` and ``report`` give the reference's results on the same
  events;
* with ``obs=`` attached, ``Driver``, ``Sweeper``, ``FedSim``, ``VecFedSim``
  and ``simulate`` return state and traces bit-identical to plain runs;
* ``NULL`` is falsy and inert, and ``compile_spans`` records each kernel
  build that ``repro_torch.kernels.build`` reports (nvcc faked by a script:
  this machine has none), and none for an up-to-date library.
"""
import dataclasses
import functools
import json
import sys

import jax
import numpy as np
import pytest
import torch
from torch_common import (key_chain, reference_draws, state_arrays,
                          torch_glm_loss)

import repro.fed as jfed
import repro.methods as jm
import repro.obs as jobs
from benchmarks.common import glm_problem, lipschitz_glm, theory_hyper
from repro.compress import make_round_compressor as j_make_rc
from repro.fed import faults as jfaults
from repro_torch import convert
from repro_torch import fed as tfed
from repro_torch import methods as tm
from repro_torch import obs as tobs
from repro_torch.bench import common as tbench
from repro_torch.compress import make_round_compressor as t_make_rc
from repro_torch.core.oracles import FiniteSumProblem
from repro_torch.data.pipeline import synthetic_classification
from repro_torch.kernels import build
from repro_torch.obs import (COMPILER, HOST, NULL, SERVER, MemorySink, Obs,
                             Timeline, attribute, client_track,
                             reconstruct_vec_timeline, report)

torch.set_num_threads(1)

D, K, N, M, ROUNDS = 40, 6, 5, 32, 12
VARIANTS = ["dasha", "page", "mvr", "sync_mvr", "marina"]
STATE = ("x", "g", "g_local", "h_local")
#: the fault models of ``tests/test_torch_faults.py`` (FM_MIXED, FM_SYNC)
FAULTS = {"dasha": dict(p_crash=0.08, crash_rounds=2, p_drop_up=0.1,
                        p_drop_down=0.05, p_corrupt=0.05,
                        deadline_mult=3.0, rejoin="reset", seed=7),
          "marina": dict(p_crash=0.08, crash_rounds=2, p_drop_up=0.1,
                         p_corrupt=0.05, deadline_mult=3.0, seed=7)}
#: rounds of each mode: enough faulted and pipelined rounds to see marks
#: and overlap
MODE_ROUNDS = {"barrier": ROUNDS, "faulted": 20, "tau2": 20}


# ---------------------------------------------------------------------------
# the two packages on one problem
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _problems():
    jp = glm_problem(d=D, m=M)
    tp = convert.problem_from_numpy(torch_glm_loss, np.asarray(jp.features),
                                    np.asarray(jp.labels), device="cpu")
    return jp, tp


@functools.lru_cache(maxsize=None)
def _hypers(variant, p_participate=1.0):
    """(reference, port) Hyper: the reference tests' theory constants, the
    sync rules' coin probability raised to 0.3 so that 12 rounds hold
    coin rounds."""
    jp, _ = _problems()
    jrc = j_make_rc("randk", D, N, k=K, backend="sparse",
                    p_participate=p_participate)
    jhp = theory_hyper(variant, jrc.omega, lipschitz_glm(jp), d=D, k=K, n=N,
                       m=M)
    if variant in ("sync_mvr", "marina"):
        jhp = dataclasses.replace(jhp, p=0.3)
    return jhp, tm.Hyper(**dataclasses.asdict(jhp))


def _links(fed, sigma=0.8):
    """``tests/test_obs.py``'s links, in either package."""
    strag = fed.Lognormal(sigma) if sigma > 0 else fed.Constant()
    return dict(uplink=fed.LinkModel(latency_s=1e-3, bandwidth_Bps=1e6,
                                     straggler=strag),
                downlink=fed.LinkModel(latency_s=1e-3, bandwidth_Bps=1e8))


def _mode_kw(faultmod, variant, mode):
    if mode == "tau2":
        return {"tau": 2}
    if mode == "faulted":
        return {"faults": faultmod.FaultModel(**FAULTS[variant])}
    return {}


def _port_sim(cls, variant, mode="barrier", *, p_participate=1.0,
              name="randk", **kw):
    _, tp = _problems()
    spec = dict(k=K) if name == "randk" else dict(p=0.3)
    trc = t_make_rc(name, D, N, backend="sparse", device="cpu",
                    p_participate=p_participate, **spec)
    return cls(variant, trc, tm.FlatSubstrate(tp, N, D),
               _hypers(variant, p_participate)[1], seed=7,
               **_mode_kw(tfed, variant, mode), **_links(tfed), **kw)


def _port_init(sim, seed=1):
    return sim.init(torch.zeros(D), seed, device="cpu")


def _run_obs(sim, rounds=ROUNDS, **kw):
    st = _port_init(sim)
    obs = Obs.full(label=sim.variant)
    res = sim.run(st, rounds, obs=obs, **kw)
    return st, res, obs.timeline


@functools.lru_cache(maxsize=None)
def _reference(variant, mode):
    """The reference heap's campaign with a full handle (its live
    timeline), its init state and its per-round draws."""
    jp, _ = _problems()
    jhp = _hypers(variant)[0]
    jrc = j_make_rc("randk", D, N, k=K, backend="sparse")
    sim = jfed.FedSim(variant, jrc, jm.FlatSubstrate(jp, N, D), jhp, seed=7,
                      **_mode_kw(jfaults, variant, mode),
                      **_links(jfed))
    st = sim.init(np.zeros(D, np.float32), jax.random.PRNGKey(1))
    rounds = MODE_ROUNDS[mode]
    draws = [reference_draws(k, jrc, jp, jhp, variant)
             for k in key_chain(st.key, rounds)]
    obs = jobs.Obs.full(label=variant)
    res = sim.run(st, rounds, obs=obs)
    return res, st, draws, obs.timeline


def _sim_events(tl):
    """Simulated-time events only (client and server tracks): the part of
    a live heap timeline that another recording must reproduce."""
    return [e for e in tl.events if e.track not in (HOST, COMPILER)]


def _assert_same_events(want_tl, got_tl):
    want, got = _sim_events(want_tl), _sim_events(got_tl)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert (a.track, a.name, a.kind) == (b.track, b.name, b.kind), (a, b)
        assert a.t0 == b.t0 and a.t1 == b.t1, (a, b)      # bit-equal f64
        assert (a.args or {}) == (b.args or {}), (a, b)


def _assert_bit_identical(a, b):
    assert set(a.traces) == set(b.traces)
    for k in a.traces:
        assert np.array_equal(a.traces[k], b.traces[k]), k
    for f in STATE:
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    assert a.state.t == b.state.t and a.state.bits_sent == b.state.bits_sent


# ---------------------------------------------------------------------------
# timelines and metrics: the same operations, the same results
# ---------------------------------------------------------------------------

def _script_events(mod, valid: bool):
    """One sequence of timeline operations in package ``mod``: every event
    kind on server, host, compiler, client and other tracks; ``valid=False``
    adds the reference test's seeded violations."""
    tl = mod.Timeline("t")
    tl.span(mod.SERVER, "round", 0.0, 1.0, round=0, bytes_down=160,
            coin=False, participants=2, bytes_up=60)
    tl.instant(mod.SERVER, "cohort_draw", 0.0, round=0, c=2)
    tl.span(mod.client_track(0), "up", 0.25, 0.5, round=0, bytes=20)
    tl.span(mod.client_track(3), "up", 0.5, 1.0, round=0, bytes=40)
    tl.counter(mod.HOST, "q", 0.5, 3.0)
    tl.begin(mod.HOST, "chunk", 0.0, start_round=0)
    tl.end(mod.HOST, 0.25)
    tl.span(mod.COMPILER, "backend_compile", 0.1, 0.2, duration_s=0.1)
    tl.span("custom", "note", 1.0, 1.5)
    tl.span(mod.SERVER, "sync_round", 1.0, 2.5, round=1, coin=True,
            bytes_down=160, participants=4, bytes_up=400)
    tl.span(mod.client_track(1), "up", 1.5, 2.5, round=1, bytes=400)
    if not valid:
        tl.span(mod.SERVER, "round", 3.0, 2.5, round=2)   # ends before
        tl.span(mod.SERVER, "round", 3.0, 4.0, round=5)
        tl.span(mod.SERVER, "round", 4.0, 5.0, round=3)   # backwards
        tl.events.append(tl.events[0]._replace(kind="nope"))
        tl.events.append(tl.events[0]._replace(t0=float("nan")))
        tl.events.append(tl.events[4]._replace(t1=1.0))   # counter + t1
        tl.begin(mod.HOST, "chunk", 0.0)                  # never ended
    return tl


@pytest.mark.parametrize("valid", [True, False], ids=["valid", "seeded"])
def test_timeline_validates_as_the_reference(valid):
    want = _script_events(jobs, valid)
    got = _script_events(tobs, valid)
    assert got.validate() == want.validate()
    assert bool(got.validate()) is not valid
    assert got.tracks() == want.tracks()
    for k, v in want.round_byte_sums().items():
        assert np.array_equal(got.round_byte_sums()[k], v), k
    if valid:
        assert got.assert_valid() is got
        return
    with pytest.raises(AssertionError):
        got.assert_valid()
    with pytest.raises(ValueError):
        got.end(SERVER, 1.0)                          # end without begin
    with pytest.raises(ValueError):
        got.begin(HOST, "again", 0.0)                 # one open span


def test_perfetto_dict_and_merge_equal_the_reference(tmp_path):
    want = _script_events(jobs, True)
    got = _script_events(tobs, True)
    path = tmp_path / "trace.json"
    doc = got.to_perfetto(str(path))
    assert doc == want.to_perfetto()
    assert json.loads(path.read_text()) == doc
    names = {e["args"]["name"]: e["tid"] for e in doc["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "thread_name"}
    assert names[SERVER] == 0 and names[HOST] == 2
    assert names[COMPILER] == 1 and names[client_track(3)] == 13
    a, b = tobs.Timeline("a"), tobs.Timeline("b")
    ja, jb = jobs.Timeline("a"), jobs.Timeline("b")
    for tl in (a, ja):
        tl.span(SERVER, "round", 0.0, 1.0)
    for tl in (b, jb):
        tl.span(HOST, "chunk", 0.0, 0.5)
    m, jm_ = tobs.merge([a, b, got], "both"), jobs.merge([ja, jb, want],
                                                         "both")
    assert m.label == jm_.label and m.tracks() == jm_.tracks()
    assert [tuple(e) for e in m.events] == [tuple(e) for e in jm_.events]
    assert m.to_perfetto() == jm_.to_perfetto()


def _instrument(mod, *sinks):
    """One sequence of instrument operations in package ``mod``."""
    reg = mod.MetricsRegistry(*sinks, labels={"engine": "heap", "n": N})
    reg.counter("fed.rounds").inc(ROUNDS)
    reg.gauge("never_set")                      # NaN -> null, not dropped
    reg.gauge("g").set(2.5)
    h = reg.histogram("w")
    for v in (0.0, -1.0, 0.3, 1.5, 1.5, 100.0, 0.5, 2.0 ** -30, 3.0):
        h.observe(v)
    reg.histogram("empty")
    reg.flush()
    reg.counter("fed.rounds").inc(1)
    reg.gauge("g").set(-4.0)
    reg.close()                                 # final flush + close
    return reg


def _strip_wall(records):
    return [{k: v for k, v in r.items() if k != "wall_s"} for r in records]


def test_jsonl_lines_equal_the_reference_but_wall_s(tmp_path):
    paths = {p: str(tmp_path / f"{p}.jsonl") for p in ("ref", "port")}
    _instrument(jobs, jobs.JsonlSink(paths["ref"]))
    _instrument(tobs, tobs.JsonlSink(paths["port"]))
    want = jobs.read_jsonl(paths["ref"])
    got = tobs.read_jsonl(paths["port"])
    assert _strip_wall(got) == _strip_wall(want)
    assert [list(r) for r in got] == [list(r) for r in want]   # key order
    last = {r["name"]: r for r in got}          # cumulative: keep last
    assert last["fed.rounds"]["value"] == ROUNDS + 1
    assert last["never_set"]["value"] is None
    assert last["w"]["buckets"]["0"] == 2 and last["w"]["count"] == 9
    assert last["empty"]["min"] is None
    mem_ref, mem_port = jobs.MemorySink(), MemorySink()
    _instrument(jobs, mem_ref)
    _instrument(tobs, mem_port)
    assert _strip_wall(mem_port.records) == _strip_wall(mem_ref.records)


def test_metrics_are_typed_as_the_reference():
    reg = tobs.MetricsRegistry()
    c = reg.counter("c")
    c.inc(3)
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(TypeError):
        reg.gauge("c")                           # kind clash
    assert reg.counter("c") is c                 # get-or-create
    want = jobs.MetricsRegistry()
    want.counter("c").inc(3)
    want.histogram("h").observe(1.5)
    reg.histogram("h").observe(1.5)
    assert reg.snapshot() == want.snapshot()


# ---------------------------------------------------------------------------
# the port heap's live timeline against the reference heap's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["barrier", "faulted", "tau2"])
@pytest.mark.parametrize("variant", ["dasha", "marina"])
def test_heap_timeline_equals_the_reference(variant, mode):
    """On the reference's draws, from its init state, the port heap records
    the reference heap's events: the same tracks, names, kinds and args,
    bit-equal timestamps (fault marks and retry spans included)."""
    jres, jst, draws, jtl = _reference(variant, mode)
    sim = _port_sim(tfed.FedSim, variant, mode)
    st = convert.state_from_numpy(state_arrays(jst), seed=0, device="cpu")
    obs = Obs.full(label=variant)
    res = sim.run(st, MODE_ROUNDS[mode], draws=lambda t: draws[t], obs=obs)
    np.testing.assert_array_equal(res.traces["bytes_up"],
                                  jres.traces["bytes_up"])
    obs.timeline.assert_valid()
    _assert_same_events(jtl, obs.timeline)
    kinds = {e.name for e in _sim_events(obs.timeline)}
    if mode == "faulted":
        assert kinds & {"crash", "drop_up", "drop_down", "deadline_cut"}
    if variant == "marina":
        assert "sync_round" in kinds
    # the campaign metrics are the reference's too
    snap = obs.metrics.snapshot()
    for name, v in _metric_snapshot(jres, mode).items():
        assert snap[name] == v, name


def _metric_snapshot(jres, mode):
    """The reference's campaign metrics of a finished reference run, from
    its own helpers on its traces and summary."""
    from repro.fed.sim import _obs_fault_metrics, _obs_fed_metrics
    h = jobs.Obs.metrics_only()
    _obs_fed_metrics(h, jres.traces, jres.summary)
    if mode == "faulted":
        _obs_fault_metrics(h, jres.traces)
    return h.metrics.snapshot()


# ---------------------------------------------------------------------------
# byte reconciliation on the port's own draws
# ---------------------------------------------------------------------------

def _assert_reconciles(tl, res, rounds):
    tl.assert_valid()
    sums = tl.round_byte_sums()
    assert sums["round"].tolist() == list(range(rounds))
    np.testing.assert_array_equal(sums["bytes_up"],
                                  res.traces["bytes_up"].astype(np.int64))
    np.testing.assert_array_equal(sums["bytes_down"],
                                  res.traces["bytes_down"].astype(np.int64))
    coins = sorted(int(e.args["round"]) for e in tl.events
                   if e.track == SERVER and e.name == "sync_round")
    assert coins == np.flatnonzero(res.traces["sync_round"]).tolist()


@pytest.mark.parametrize("mode", ["barrier", "tau2"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_heap_timeline_bytes_reconcile(variant, mode):
    rounds = MODE_ROUNDS[mode]
    _, res, tl = _run_obs(_port_sim(tfed.FedSim, variant, mode), rounds)
    _assert_reconciles(tl, res, rounds)


def test_faulted_dasha_timeline_reconciles_and_marks_every_fault():
    """A graceful rule's faulted round bills its senders only, so the
    reconcile holds; the marks count what the fault traces count."""
    rounds = 30
    _, res, tl = _run_obs(_port_sim(tfed.FedSim, "dasha", "faulted"), rounds)
    _assert_reconciles(tl, res, rounds)
    marks = {}
    for e in tl.events:
        if e.kind == "instant" and e.track.startswith("client/"):
            marks[e.name] = marks.get(e.name, 0) + 1
    tr = res.traces
    assert marks.get("deadline_cut", 0) == tr["late"].sum()
    assert marks.get("drop_up", 0) == tr["lost"].sum()
    assert marks.get("rejoin", 0) == tr["rejoins"].sum()
    assert marks.get("drop_down", 0) > 0 and marks.get("crash", 0) > 0


def test_sampled_heap_timeline_marks_cohorts():
    n, c = 48, 8
    sim = _sampled_sim(tfed.FedSim, "dasha", n, c)
    _, res, tl = _run_obs(sim)
    tl.assert_valid()
    draws = [e for e in tl.events
             if e.track == SERVER and e.name == "cohort_draw"]
    assert len(draws) == ROUNDS and all(e.args["c"] == c for e in draws)
    _assert_reconciles(tl, res, ROUNDS)
    slab = [e.name for e in tl.events if e.track == HOST]
    assert slab.count("slab_gather") == slab.count("slab_writeback") == 3


def test_perfetto_export_of_a_campaign(tmp_path):
    sim = _port_sim(tfed.FedSim, "dasha")
    _, res, tl = _run_obs(sim)
    doc = tl.to_perfetto(str(tmp_path / "trace.json"))
    evs = doc["traceEvents"]
    names = {e["args"]["name"]: e["tid"] for e in evs
             if e.get("ph") == "M" and e["name"] == "thread_name"}
    assert names[SERVER] == 0
    assert all(names[client_track(i)] == 10 + i for i in range(N))
    spans = [e for e in evs if e.get("ph") == "X"]
    srv_end = max(e["ts"] + e["dur"] for e in spans if e["tid"] == 0)
    assert srv_end == pytest.approx(
        float(res.traces["sim_wall_clock"][-1]) * 1e6, rel=1e-9)
    ts = [e["ts"] for e in evs if e.get("ph") != "M"]
    assert ts == sorted(ts)


# ---------------------------------------------------------------------------
# vec reconstruction == heap live recording
# ---------------------------------------------------------------------------

def _sampled_sim(cls, variant, n, c, name="randk", **kw):
    feats, labels = synthetic_classification(0, n, 4, D, device="cpu")
    prob = FiniteSumProblem(loss=tbench.glm_loss, features=feats,
                            labels=labels)
    spec = dict(k=K) if name == "randk" else dict(p=0.3)
    rc = t_make_rc(name, D, n, backend="sparse", device="cpu", **spec)
    hp = tbench.theory_hyper(variant, rc.omega, tbench.lipschitz_glm(prob),
                             d=D, k=K, n=n, m=4)
    return cls(variant, rc, tm.SampledFlatSubstrate(prob, n, D, c=c), hp,
               seed=7, chunk=5, **_links(tfed), **kw)


def _vec_case(case):
    """(heap sim, vec sim) of one reconstruction case."""
    if case.startswith("sampled"):
        name = "bernoulli" if case.endswith("bernoulli") else "randk"
        return tuple(_sampled_sim(cls, "dasha", 64, 8, name=name)
                     for cls in (tfed.FedSim, tfed.VecFedSim))
    variant, _, name = case.partition("-")
    return tuple(_port_sim(cls, variant, name=name or "randk")
                 for cls in (tfed.FedSim, tfed.VecFedSim))


@pytest.mark.parametrize("case", ["dasha", "marina", "dasha-bernoulli",
                                  "sampled", "sampled-bernoulli"])
def test_vec_reconstruction_matches_heap(case):
    heap, vec = _vec_case(case)
    _, hres, heap_tl = _run_obs(heap)
    st = _port_init(vec)
    res = vec.run(st, ROUNDS)
    np.testing.assert_array_equal(res.traces["bytes_up"],
                                  hres.traces["bytes_up"])
    vec_tl = reconstruct_vec_timeline(vec, st, res)
    vec_tl.assert_valid()
    assert vec_tl.label == f"vec/{vec.variant}"
    _assert_same_events(heap_tl, vec_tl)
    assert len(vec_tl.events) == len(_sim_events(heap_tl))


@pytest.mark.parametrize("variant", ["dasha", "marina"])
def test_vec_reconstruction_on_reference_draws_equals_the_reference_heap(
        variant):
    """The vec campaign replays the reference's draws, and its
    reconstruction (on the same draws) equals both the port heap's and
    the reference heap's live timelines."""
    _, jst, draws, jtl = _reference(variant, "barrier")
    vec = _port_sim(tfed.VecFedSim, variant)
    st = convert.state_from_numpy(state_arrays(jst), seed=0, device="cpu")
    res = vec.run(st, ROUNDS, draws=lambda t: draws[t])
    vec_tl = reconstruct_vec_timeline(vec, st, res,
                                      draws=lambda t: draws[t])
    _assert_same_events(jtl, vec_tl)


def test_vec_reconstruction_refuses_unreplayable_cases():
    tau_sim = _port_sim(tfed.VecFedSim, "dasha", "tau2")
    st = _port_init(tau_sim)
    res = tau_sim.run(st, 6)
    with pytest.raises(NotImplementedError, match="barrier"):
        reconstruct_vec_timeline(tau_sim, st, res)
    pp = _port_sim(tfed.VecFedSim, "dasha", p_participate=0.5)
    st = _port_init(pp)
    res = pp.run(st, 6)
    with pytest.raises(NotImplementedError, match="p_participate"):
        reconstruct_vec_timeline(pp, st, res)


def test_vec_reconstruction_checks_the_billed_bytes():
    vec = _port_sim(tfed.VecFedSim, "dasha")
    st = _port_init(vec)
    res = vec.run(st, 6)
    res.traces["bytes_up"][3] += 1
    with pytest.raises(AssertionError, match="round 3"):
        reconstruct_vec_timeline(vec, st, res)


# ---------------------------------------------------------------------------
# straggler attribution
# ---------------------------------------------------------------------------

def _as_reference(tl):
    out = jobs.Timeline(tl.label)
    out.events = [jobs.TimelineEvent(*e) for e in tl.events]
    return out


@pytest.mark.parametrize("mode", ["barrier", "faulted", "tau2"])
def test_attribution_equals_the_reference(mode):
    rounds = 30
    _, res, tl = _run_obs(_port_sim(tfed.FedSim, "marina", mode), rounds)
    got, want = attribute(tl), jobs.attribute(_as_reference(tl))
    assert (got.rounds, got.sync_rounds, got.barrier_s,
            got.critical_path) == (want.rounds, want.sync_rounds,
                                   want.barrier_s, want.critical_path)
    assert {i: dataclasses.asdict(c) for i, c in got.clients.items()} == \
        {i: dataclasses.asdict(c) for i, c in want.clients.items()}
    assert [c.client for c in got.top_blamed(3)] == \
        [c.client for c in want.top_blamed(3)]
    # every round is accounted for
    assert got.rounds == rounds == len(got.critical_path)
    assert sum(c.blamed for c in got.clients.values()) == rounds
    assert sum(c.blamed_sync for c in got.clients.values()) == \
        got.sync_rounds
    if mode != "faulted":
        # (a faulted round's SERVER ``retries`` span comes after its round
        # span and carries no coin, so there, as in the reference, the
        # attribution reads that round as no sync barrier)
        assert got.sync_rounds == int(res.traces["sync_round"].sum())
    if mode == "barrier":
        assert got.barrier_s == pytest.approx(
            float(res.traces["sim_wall_clock"][-1]), rel=1e-9)


def test_report_equals_the_reference(tmp_path):
    tls = {v: _run_obs(_port_sim(tfed.FedSim, v))[2]
           for v in ("dasha", "marina")}
    path = tmp_path / "stragglers.md"
    md = report(tls, top=3, path=str(path))
    assert path.read_text() == md
    assert md == jobs.report({k: _as_reference(v) for k, v in tls.items()},
                             top=3)
    assert "## dasha" in md and "## marina" in md
    assert "(0 sync barriers)" in md.split("## marina")[0]


# ---------------------------------------------------------------------------
# the handle changes nothing
# ---------------------------------------------------------------------------

FED_CASES = ["heap-barrier", "heap-faulted", "heap-tau2", "heap-sampled",
             "heap-sampled-tau2", "vec-barrier", "vec-faulted", "vec-tau2",
             "vec-sampled", "vec-sampled-tau2"]


@pytest.mark.parametrize("case", FED_CASES)
def test_fed_runs_are_bit_identical_with_a_handle(case):
    engine, _, mode = case.partition("-")
    cls = tfed.FedSim if engine == "heap" else tfed.VecFedSim
    if mode.startswith("sampled"):
        tau = 2 if mode.endswith("tau2") else None
        sim = _sampled_sim(cls, "dasha", 48, 8, tau=tau)
    else:
        sim = _port_sim(cls, "dasha", mode, chunk=5)
    st = _port_init(sim)
    plain = sim.run(st, ROUNDS)
    obs = Obs.full()
    res = sim.run(st, ROUNDS, obs=obs)
    _assert_bit_identical(plain, res)
    snap = obs.metrics.snapshot()
    assert snap["fed.rounds"]["value"] == ROUNDS
    assert snap["fed.bytes_up"]["value"] == res.summary["bytes_up"]
    assert snap["fed.round_wall_s"]["count"] == ROUNDS
    assert snap["compiles"]["value"] == 0
    host = [e for e in obs.timeline.events if e.track == HOST]
    if engine == "vec":
        assert [e.name for e in host].count("chunk") == 3
        assert snap["vec.chunk_s"]["count"] == 3
    if mode.startswith("sampled"):
        assert {"slab_gather", "slab_writeback"} <= {e.name for e in host}
    if mode == "faulted":
        assert snap["fed.faults.dropped"]["value"] == \
            res.traces["dropped"].sum()
    obs.timeline.assert_valid()


@pytest.mark.parametrize("engine", ["heap", "vec"])
def test_simulate_takes_a_handle(engine):
    sim = _port_sim(tfed.FedSim, "dasha")
    args = ("dasha", sim.comp, sim.substrate, sim.hyper, torch.zeros(D), 1)
    kw = dict(rounds=6, seed=7, engine=engine, init_kw=dict(device="cpu"),
              **_links(tfed))
    plain = tfed.simulate(*args, **kw)
    obs = Obs.full()
    res = tfed.simulate(*args, obs=obs, **kw)
    _assert_bit_identical(plain, res)
    assert obs.metrics.snapshot()["fed.rounds"]["value"] == 6
    n_client = sum(e.track.startswith("client/") for e in obs.timeline.events)
    assert n_client == (3 * N * 6 if engine == "heap" else 0)


def test_campaign_metrics_through_run_to_jsonl(tmp_path):
    sim = _port_sim(tfed.FedSim, "dasha")
    st = _port_init(sim)
    path = str(tmp_path / "campaign.jsonl")
    obs = Obs.to_jsonl(path, labels={"engine": "heap"})
    res = sim.run(st, ROUNDS, obs=obs)
    obs.close()
    last = {r["name"]: r for r in tobs.read_jsonl(path)}
    assert last["fed.rounds"]["value"] == ROUNDS
    assert last["fed.bytes_up"]["value"] == res.summary["bytes_up"]
    assert last["fed.round_wall_s"]["count"] == ROUNDS
    assert last["fed.rounds"]["labels"] == {"engine": "heap"}


def _flat_method(lanes=None):
    _, tp = _problems()
    rc = t_make_rc("randk", D, N, k=K, backend="sparse", device="cpu")
    hp = _hypers("dasha")[1]
    if lanes is not None:
        hp = dataclasses.replace(hp, gamma=lanes)
    return tm.Method.build("dasha", rc, tm.FlatSubstrate(tp, N, D), hp)


@pytest.mark.parametrize("runner", ["driver", "sweeper"])
def test_driver_and_sweeper_are_bit_identical_with_a_handle(runner):
    metrics = {"grad_sq": lambda s, d: torch.sum(s.g ** 2)}
    m = _flat_method()
    st = m.init(torch.zeros(D), 1, device="cpu")
    gammas = np.array([0.5, 1.0, 2.0]) * float(_hypers("dasha")[1].gamma)
    if runner == "driver":
        drv = tm.Driver(m, metrics=metrics, chunk=5)

        def run(**kw):
            return drv.run(st, ROUNDS, **kw)
        billed = ROUNDS
    else:
        sw = tm.Sweeper(_flat_method, metrics=metrics, chunk=5)

        def run(**kw):
            return sw.run(gammas, st, ROUNDS, device="cpu", **kw)
        billed = ROUNDS * len(gammas)
    plain_state, plain_tr = run()
    obs = Obs.full()
    state, tr = run(obs=obs)
    assert set(tr) == set(plain_tr)
    for k in tr:
        assert np.array_equal(tr[k], plain_tr[k]), k
    for f in STATE:
        assert torch.equal(getattr(state, f), getattr(plain_state, f)), f
    snap = obs.metrics.snapshot()
    assert snap["driver.rounds"]["value"] == billed
    assert snap["driver.chunk_s"]["count"] == 3
    chunks = [e for e in obs.timeline.events if e.name == "chunk"]
    assert [(e.track, e.args["start_round"], e.args["rounds"])
            for e in chunks] == [(HOST, 0, 5), (HOST, 5, 5), (HOST, 10, 2)]
    obs.timeline.assert_valid()


def test_zero_rounds_record_no_rounds():
    m = _flat_method()
    st = m.init(torch.zeros(D), 1, device="cpu")
    obs = Obs.full()
    tm.Driver(m).run(st, 0, obs=obs)
    assert obs.metrics.snapshot() == {
        "compiles": {"kind": "counter", "value": 0.0}}
    assert obs.timeline.events == []


# ---------------------------------------------------------------------------
# the null handle and build capture
# ---------------------------------------------------------------------------

def test_null_obs_is_falsy_and_inert():
    assert not NULL and not Obs()
    assert Obs(timeline=Timeline()) and Obs.metrics_only()
    assert NULL.counter("x") is None and NULL.histogram("x") is None
    assert NULL.gauge("x") is None
    NULL.flush(), NULL.close()                  # no-ops
    with tobs.maybe(None) as h:
        assert h is NULL
    with NULL.compile_spans() as h:
        assert h is NULL and not build._LISTENERS


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A kernel source directory with one file and an ``nvcc`` that writes
    an empty library: ``build`` then runs its real start/finish path."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "fake.cu").write_text("// one source\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').close()\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    return out


@pytest.mark.parametrize("handle", ["full", "metrics_only", "timeline"])
def test_compile_spans_record_each_build(fake_nvcc, handle):
    obs = {"full": Obs.full, "metrics_only": Obs.metrics_only,
           "timeline": lambda: Obs(timeline=Timeline())}[handle]()
    with obs.compile_spans():
        assert build.build_all() == {"fake": ""}
        assert build.build_all() == {"fake": ""}   # up to date: no build
    build.build_all()                              # outside: not recorded
    assert not build._LISTENERS
    assert list(fake_nvcc.glob("libfake-*.so"))
    if obs.metrics is not None:
        assert obs.metrics.counter("compiles").value == 1
    if obs.timeline is not None:
        spans = obs.timeline.events
        assert [(e.track, e.name, e.args["kernel"]) for e in spans] == \
            [(COMPILER, "backend_compile", "fake")]
        assert spans[0].t1 >= spans[0].t0 >= 0.0
        assert spans[0].args["duration_s"] >= 0.0

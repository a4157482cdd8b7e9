"""The port's heap-oracle ``FedSim`` against the reference's (CPU), and
against the port's own ``VecFedSim``.

Reference parity: both packages start from one state (the reference's
init, carried across by ``repro_torch.convert``), and the port replays the
reference's draws round by round (plans, PAGE and sync coins, samples,
cohorts: ``torch_common.reference_draws`` / ``reference_sampled_draws``).
The network needs no replay: both draw their float64 straggler
multipliers with numpy from the same seed.  Tolerances: byte,
participant, sync-round and ``bits_sent`` traces and the event log
(times, clients, bytes) exactly; the simulated wall clock exactly too (the
same float64 arithmetic on the same integers and draws); the metric to
rtol 1e-4 (float32 sums taken in another order, compounded over the
rounds, as in ``tests/test_torch_fed.py``).

Heap against vec (the port's own draws): the tolerances of the
reference's ``tests/test_fed_scale.py::_assert_equivalent``: bytes and
participants exactly, wall clock to rtol 2e-6 (the vec engine's float32
delays), metric to rtol 1e-4.  The port's own slab and scatter stores,
a resumed campaign and a lockstep ``Method.run`` must agree with the heap
bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_common import (glm_arrays, jax_glm_loss, jax_stoch_problem,
                          key_chain, reference_draws,
                          reference_sampled_draws, state_arrays,
                          stoch_arrays, torch_glm_loss, torch_stoch_problem)

import repro.fed as jfed
import repro.methods as jm
from repro.compress import make_round_compressor as j_make_rc
from repro.core.oracles import FiniteSumProblem as JFiniteSum
from repro_torch import convert
from repro_torch import fed as tfed
from repro_torch import methods as tm
from repro_torch.compress import make_round_compressor as t_make_rc
from repro_torch.fed import sim as tsim
from repro_torch.fed import wire as twire
from repro_torch.obs import Obs

torch.set_num_threads(1)

D, K, N, M = 40, 6, 5, 8
ROUNDS, CHUNK = 12, 8                   # two chunks, one of them partial
EXACT = ("bytes_up", "value_bytes", "bytes_down", "participants",
         "sync_round", "bits_sent", "sim_wall_clock", "bcast_clock")


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


def _problems(variant, n):
    if variant in ("mvr", "sync_mvr"):
        A, b = stoch_arrays(D)
        return jax_stoch_problem(A, b, n), torch_stoch_problem(A, b, n), \
            "stoch"
    feats, labels = glm_arrays(n, M, D)
    jp = JFiniteSum(loss=jax_glm_loss, features=jnp.asarray(feats),
                    labels=jnp.asarray(labels))
    tp = convert.problem_from_numpy(torch_glm_loss, feats, labels,
                                    device="cpu")
    return jp, tp, "exact"


def _links(mod, sigma=1.0):
    strag = mod.Lognormal(sigma) if sigma else mod.Constant()
    return dict(uplink=mod.LinkModel(latency_s=0.02, bandwidth_Bps=1e5,
                                     straggler=strag),
                downlink=mod.LinkModel(latency_s=0.001, bandwidth_Bps=1e7,
                                       straggler=mod.Lognormal(0.5)))


def _comp(mod_make, name, n, **kw):
    kw = dict(kw)
    mode = kw.pop("mode", "independent")
    backend = kw.pop("backend", "sparse")
    return mod_make(name, D, n, mode=mode, backend=backend, **kw)


def _reference_pair(variant, comp_kw, *, c=None, store="auto", n=N,
                    rounds=ROUNDS):
    """Run the reference's FedSim and the port's on one state, the port
    replaying the reference's draws; returns (reference, port) results."""
    jp, tp, init_mode = _problems(variant, n)
    name = comp_kw["name"]
    kw = {k: v for k, v in comp_kw.items() if k != "name"}
    jrc = _comp(j_make_rc, name, n, **kw)
    trc = _comp(t_make_rc, name, n, device="cpu", **kw)
    if c is None:
        jsub, tsub = jm.FlatSubstrate(jp, n, D), tm.FlatSubstrate(tp, n, D)
        omega = jrc.omega
    else:
        jsub = jm.SampledFlatSubstrate(jp, n, D, c=c)
        tsub = tm.SampledFlatSubstrate(tp, n, D, c=c)
        omega = jsub.with_compressor(jrc).effective_omega()
    jhp, thp = _hyper(jm.Hyper, variant, omega), _hyper(tm.Hyper, variant,
                                                       omega)
    jsim = jfed.FedSim(variant, jrc, jsub, jhp, seed=3, chunk=CHUNK,
                       store=store, **_links(jfed))
    tsim = tfed.FedSim(variant, trc, tsub, thp, seed=3, chunk=CHUNK,
                       store=store, **_links(tfed))
    jstate = jsim.init(jnp.zeros(D), jax.random.PRNGKey(1),
                       init_mode=init_mode)
    tstate = convert.state_from_numpy(state_arrays(jstate), seed=0,
                                      device="cpu")
    keys = key_chain(jstate.key, rounds)
    if c is None:
        draws = [reference_draws(k, jrc, jp, jhp, variant) for k in keys]
    else:
        jbound = jsub.with_compressor(jrc)
        draws = [reference_sampled_draws(k, jbound, jp, jhp, variant)
                 for k in keys]
    jres = jsim.run(jstate, rounds, log_events=True)
    tres = tsim.run(tstate, rounds, log_events=True,
                    draws=lambda t: draws[t])
    return jres, tres


def _assert_matches_reference(jres, tres):
    assert set(tres.traces) == set(jres.traces)
    for k in EXACT:
        np.testing.assert_array_equal(tres.traces[k], jres.traces[k],
                                      err_msg=k)
    np.testing.assert_allclose(tres.traces["metric"], jres.traces["metric"],
                               rtol=1e-4, atol=1e-7)
    assert [tuple(e) for e in tres.events] == \
        [tuple(e) for e in jres.events]
    assert tres.summary == pytest.approx(jres.summary, rel=0, abs=0)


@pytest.mark.parametrize("variant", ["dasha", "page", "mvr", "sync_mvr",
                                     "marina"])
def test_flat_variants_match_reference(variant):
    """The five variants on a flat substrate, independent sparse RandK;
    the sync rules' coin rounds ship every client's dense upload."""
    jres, tres = _reference_pair(variant, dict(name="randk", k=K))
    _assert_matches_reference(jres, tres)
    if variant in ("sync_mvr", "marina"):
        sync = tres.traces["sync_round"].astype(bool)
        assert sync.any() and not sync.all()
        assert np.all(tres.traces["bytes_up"][sync]
                      == N * (twire.HEADER_BYTES + 4 * D))


FORMATS = [
    dict(name="randk", k=K, mode="shared_coords"),
    dict(name="randk", k=K, backend="dense"),
    dict(name="randk", k=K, backend="fused"),
    dict(name="permk", mode="permk"),
    dict(name="permk", mode="permk", backend="fused"),
    dict(name="bernoulli", p=0.25, backend="dense"),
    dict(name="bernoulli", p=0.25, mode="shared_coords", backend="dense"),
    dict(name="qdither", s=7, backend="dense"),
    dict(name="qdither", s=7, backend="fused"),
    dict(name="identity", backend="dense"),
]


@pytest.mark.parametrize("comp_kw", FORMATS,
                         ids=lambda kw: "-".join(str(v)
                                                 for v in kw.values()))
def test_wire_formats_match_reference(comp_kw):
    """Every wire format, its bytes from the codec: shared seeds, dense
    and fused backends (the support read from the round's plan), PermK
    slice headers, Bernoulli's realized counts, raw dense rows."""
    _assert_matches_reference(*_reference_pair("dasha", comp_kw))


@pytest.mark.parametrize("variant", ["dasha", "marina"])
def test_appendix_d_participation_matches_reference(variant):
    """Appendix-D coins (p' = 0.5): absentees ship nothing and nobody
    waits for them; MARINA's barrier refuses partial participation in
    both packages."""
    comp = dict(name="randk", k=K, p_participate=0.5, backend="fused")
    if variant == "marina":
        for mod, rc in ((jfed, _comp(j_make_rc, "randk", N, k=K,
                                     p_participate=0.5)),
                        (tfed, _comp(t_make_rc, "randk", N, k=K,
                                     p_participate=0.5, device="cpu"))):
            with pytest.raises(ValueError, match="sync_requires_all"):
                mod.FedSim("marina", rc, None, None)
        return
    jres, tres = _reference_pair(variant, comp, rounds=16)
    _assert_matches_reference(jres, tres)
    part = tres.traces["participants"]
    assert (part < N).any()
    np.testing.assert_array_equal(tres.traces["bytes_up"],
                                  part * (twire.HEADER_BYTES + 8 * K))


SAMPLED = [dict(name="randk", k=K), dict(name="randk", k=K, backend="dense"),
           dict(name="randk", k=K, mode="shared_coords"),
           dict(name="bernoulli", p=0.25, backend="dense"),
           dict(name="permk", mode="permk")]


@pytest.mark.parametrize("store", ["slab", "scatter"])
@pytest.mark.parametrize("comp_kw", SAMPLED,
                         ids=lambda kw: "-".join(str(v)
                                                 for v in kw.values()))
def test_sampled_cohorts_match_reference(comp_kw, store):
    """C-of-n cohorts on both stores: slot-keyed records (PermK's
    PERMK_SLOT slices included), cohort-only downlink."""
    n, c = 16, 5
    jres, tres = _reference_pair("dasha", comp_kw, c=c, store=store, n=n)
    _assert_matches_reference(jres, tres)
    assert np.all(tres.traces["participants"] == c)
    assert np.all(tres.traces["bytes_down"] == c * 4 * D)
    if comp_kw["name"] == "permk":
        blk = -(-D // c)
        assert np.all(tres.traces["bytes_up"] == c * (
            twire.HEADER_BYTES + twire.PERMK_SLOT_EXT_BYTES + 4 * blk))


# ---------------------------------------------------------------------------
# the port's heap oracle against its own vectorized simulator
# ---------------------------------------------------------------------------

def _port_pair(variant, comp_kw, *, c=None, sigma=1.0, n=N, rounds=15,
               chunk=CHUNK, store="auto"):
    _, tp, _ = _problems(variant, n)
    name = comp_kw["name"]
    trc = _comp(t_make_rc, name, n, device="cpu",
                **{k: v for k, v in comp_kw.items() if k != "name"})
    sub = tm.FlatSubstrate(tp, n, D) if c is None else \
        tm.SampledFlatSubstrate(tp, n, D, c=c)
    omega = sub.with_compressor(trc).effective_omega() if c is not None \
        else trc.omega
    hp = _hyper(tm.Hyper, variant, omega)
    kw = dict(seed=7, chunk=chunk, store=store, compute_s=0.004,
              **_links(tfed, sigma))
    heap = tfed.FedSim(variant, trc, sub, hp, **kw)
    vec = tfed.VecFedSim(variant, trc, sub, hp, **kw)
    st = heap.init(torch.zeros(D), 5, device="cpu")
    return heap, vec, st, rounds


def _assert_equivalent(rh, rv):
    """The reference's heap-vs-vec contract (test_fed_scale.py)."""
    for k in ("bytes_up", "value_bytes", "bytes_down", "sync_round",
              "participants"):
        np.testing.assert_array_equal(rh.traces[k], rv.traces[k],
                                      err_msg=k)
    np.testing.assert_allclose(rv.traces["sim_wall_clock"],
                               rh.traces["sim_wall_clock"], rtol=2e-6)
    np.testing.assert_allclose(rv.traces["bits_sent"],
                               rh.traces["bits_sent"], rtol=1e-6)
    np.testing.assert_allclose(rv.traces["metric"], rh.traces["metric"],
                               rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(rv.state.x.numpy(), rh.state.x.numpy(),
                               rtol=1e-5, atol=1e-7)
    for k in ("bytes_up", "bytes_down", "sync_rounds",
              "mean_participants"):
        assert rh.summary[k] == rv.summary[k], k
    np.testing.assert_allclose(rv.summary["wall_clock_s"],
                               rh.summary["wall_clock_s"], rtol=2e-6)


@pytest.mark.parametrize("sigma", [0.0, 1.0])
@pytest.mark.parametrize("variant", ["dasha", "page", "mvr", "sync_mvr",
                                     "marina"])
def test_heap_equals_vec_all_variants(variant, sigma):
    heap, vec, st, rounds = _port_pair(variant, dict(name="randk", k=K),
                                       sigma=sigma, rounds=30)
    rh = heap.run(st, rounds)
    _assert_equivalent(rh, vec.run(st, rounds))
    if variant in ("sync_mvr", "marina"):
        sync = rh.traces["sync_round"].astype(bool)
        assert sync.any() and not sync.all()


@pytest.mark.parametrize("comp_kw,c", [
    (dict(name="randk", k=K, backend="fused", p_participate=0.5), None),
    (dict(name="bernoulli", p=0.25, backend="dense"), None),
    (dict(name="qdither", s=7, backend="fused"), None),
    (dict(name="permk", mode="permk", backend="fused"), None),
    (dict(name="randk", k=K), 5),
    (dict(name="randk", k=K, backend="fused"), 5),
    (dict(name="bernoulli", p=0.25, backend="dense"), 5),
    (dict(name="permk", mode="permk"), 5),
], ids=lambda v: "-".join(str(x) for x in v.values())
    if isinstance(v, dict) else f"c={v}")
def test_heap_equals_vec_formats_and_cohorts(comp_kw, c):
    """Every format's codec bytes equal the vectorized engine's analytic
    bill: Appendix-D zero-byte absentees, Bernoulli's realized counts,
    raw QDither rows, PermK slices (PERMK_SLOT under sampling)."""
    heap, vec, st, rounds = _port_pair("dasha", comp_kw, c=c, n=16)
    rh = heap.run(st, rounds)
    _assert_equivalent(rh, vec.run(st, rounds))
    if c is not None:
        assert heap.slab and np.all(rh.traces["participants"] == c)


@pytest.mark.parametrize("comp_kw", [dict(name="randk", k=K),
                                     dict(name="permk", mode="permk"),
                                     dict(name="bernoulli", p=0.25,
                                          backend="dense")],
                         ids=["randk", "permk", "bernoulli"])
def test_slab_store_bit_equal_to_scatter(comp_kw):
    """The port's own draws: the slab store equals the scatter store bit
    for bit (traces, events, final state), for chunks that do and do not
    divide the rounds."""
    heap, _, st, _ = _port_pair("dasha", comp_kw, c=5, n=16,
                                store="scatter")
    ref = heap.run(st, 15, log_events=True)
    for chunk in (1, 7, 15):
        slab, _, _, _ = _port_pair("dasha", comp_kw, c=5, n=16,
                                   store="slab", chunk=chunk)
        assert slab.slab
        got = slab.run(st, 15, log_events=True)
        for k in ref.traces:
            np.testing.assert_array_equal(got.traces[k], ref.traces[k],
                                          err_msg=k)
        assert got.events == ref.events
        for f in ("x", "g", "g_local", "h_local"):
            assert torch.equal(getattr(got.state, f), getattr(ref.state, f))


def test_metric_and_state_are_the_lockstep_engines():
    """The simulator's math is the engine's: its metric trace, bits and
    final state equal ``Method.run`` (the chunked driver) bit for bit."""
    heap, _, st, _ = _port_pair("marina", dict(name="randk", k=K,
                                               backend="fused"))
    res = heap.run(st, 20)
    final, metric, bits = heap.method.run(st, 20)
    np.testing.assert_array_equal(res.traces["metric"],
                                  metric.astype(np.float64))
    np.testing.assert_array_equal(res.traces["bits_sent"], bits)
    for f in ("x", "g", "g_local", "h_local"):
        assert torch.equal(getattr(res.state, f), getattr(final, f))


@pytest.mark.parametrize("c", [None, 5], ids=["flat", "slab"])
def test_resume_continues_bit_identically(c):
    heap, _, st, _ = _port_pair("dasha", dict(name="randk", k=K), c=c,
                                n=16, chunk=6)
    full = heap.run(st, 20, log_events=True)
    saved = {}
    heap.run(st, 20, checkpoint=lambda s, r, w: saved.setdefault(r, (s, w)))
    assert sorted(saved) == [6, 12, 18, 20]
    mid, wall = saved[12]
    assert mid.t == 12 and wall == full.traces["sim_wall_clock"][11]
    rest = heap.run(mid, 20, start_round=12, clock0=wall, log_events=True)
    for k in full.traces:
        np.testing.assert_array_equal(rest.traces[k], full.traces[k][12:],
                                      err_msg=k)
    assert rest.events == [e for e in full.events if e.round >= 12]
    for f in ("x", "g", "g_local", "h_local"):
        assert torch.equal(getattr(rest.state, f), getattr(full.state, f))
    # a later chunk never wrote the state handed to the checkpoint
    assert torch.equal(saved[12][0].h_local, mid.h_local)


@pytest.mark.parametrize("c", [None, 5], ids=["flat", "slab"])
def test_run_never_writes_its_input_state(c):
    heap, _, st, _ = _port_pair("page", dict(name="randk", k=K,
                                             backend="fused"), c=c, n=16)
    before = {f: getattr(st, f).clone()
              for f in ("x", "g", "g_local", "h_local")}
    first = heap.run(st, 12)
    for f, t in before.items():
        assert torch.equal(getattr(st, f), t), f
    assert st.t == 0
    again = heap.run(st, 12)
    for k in first.traces:
        np.testing.assert_array_equal(again.traces[k], first.traces[k])


@pytest.mark.parametrize("variant,comp_kw,c", [
    ("marina", dict(name="randk", k=K, backend="fused"), None),
    ("dasha", dict(name="randk", k=K, backend="dense"), None),
    ("dasha", dict(name="randk", k=K, mode="shared_coords",
                   backend="dense"), None),
    ("dasha", dict(name="bernoulli", p=0.25, backend="dense"), None),
    ("dasha", dict(name="permk", mode="permk", backend="fused"), None),
    ("dasha", dict(name="qdither", s=7, backend="fused"), None),
    ("dasha", dict(name="randk", k=K, backend="fused"), 5),
    ("dasha", dict(name="permk", mode="permk"), 5),
], ids=lambda v: v if isinstance(v, str) else
    ("-".join(str(x) for x in v.values()) if isinstance(v, dict)
     else f"c={v}"))
def test_every_upload_decodes_to_its_message_rows(variant, comp_kw, c):
    """The records the heap bills decode to the round's message rows, bit
    for bit (the support that the dense and fused backends' rows need
    comes from the round's own plan; a wrong plan keeps the byte count
    and fails here), and every record passes the crc check."""
    heap, _, st, _ = _port_pair(variant, comp_kw, c=c,
                                n=N if c is None else 16)
    _, ys = heap._run_chunk(st, 20, heap._metric_fn(None), None)
    if variant == "marina":
        assert ys["coin"].any() and not ys["coin"].all()
    for j in range(20):
        coin, active, rb, bufs, (vals, idxs) = heap._round_wire(ys, j, j)
        for b in bufs:
            if b is not None:
                twire.verify(b)
        assert [b is not None for b in bufs] == active.tolist()
        rows = ys["sync"][j] if coin else heap._dense_rows(vals, idxs)
        plan = tsim._HostPlan(*(ys[k][j] if k in ys else None
                                for k in ("plan_indices", "plan_mask")))
        dec = twire.decode_round(bufs, D, plan=plan)
        # bit for bit, but for the sign of zero: a mask multiply leaves
        # -0.0 at a dropped coordinate, which the wire does not carry
        nz = rows != 0
        assert np.array_equal(dec, rows)
        assert dec[nz].tobytes() == rows[nz].tobytes()
        if variant == "marina":
            assert rb.total_bytes == (N * (20 + 4 * D) if coin
                                      else N * (20 + 8 * K))


def test_simulate_runs_both_engines():
    kw = dict(rounds=10, seed=4, init_kw=dict(device="cpu"),
              **_links(tfed))
    heap, _, _, _ = _port_pair("dasha", dict(name="randk", k=K))
    args = ("dasha", heap.comp, heap.substrate, heap.hyper, torch.zeros(D),
            5)
    rh = tfed.simulate(*args, log_events=True, **kw)
    rv = tfed.simulate(*args, engine="vec", **kw)
    _assert_equivalent(rh, rv)
    assert rh.events and rv.events is None
    with pytest.raises(ValueError, match="engine"):
        tfed.simulate(*args, engine="nope", **kw)


def test_rejections():
    heap, _, st, _ = _port_pair("dasha", dict(name="randk", k=K))
    args = ("dasha", heap.comp, heap.substrate, heap.hyper)
    # tau= is ported (tests/test_torch_async.py): it composes with the
    # heap oracle and, as in the reference, refuses a resume
    asim = tfed.FedSim(*args, tau=1)
    assert asim.run(st, 3).summary["tau"] == 1.0
    with pytest.raises(ValueError, match="barrier-only"):
        asim.run(st, 3, clock0=1.0)
    # faults= is ported (tests/test_torch_faults.py) but, as in the
    # reference, refuses asynchronous rounds
    with pytest.raises(ValueError, match="tau"):
        tfed.FedSim(*args, tau=1, faults=tfed.FaultModel())
    # obs= is ported (tests/test_torch_obs.py): a handle is taken, an
    # object that is not one raises
    assert heap.run(st, 3, obs=Obs.metrics_only()).summary["rounds"] == 3
    with pytest.raises(AttributeError):
        heap.run(st, 3, obs=object())
    with pytest.raises(ValueError, match="slab"):
        tfed.FedSim(*args, store="slab")
    with pytest.raises(ValueError, match="store"):
        tfed.FedSim(*args, store="heap")
    with pytest.raises(ValueError, match="start_round"):
        heap.run(st, 3, start_round=4)
    with pytest.raises(ValueError, match="estimator_update_full"):
        tfed.FedSim("dasha", heap.comp, object(), heap.hyper)
    empty = heap.run(st, 0)
    assert all(v.shape == (0,) for v in empty.traces.values())
    assert empty.summary["rounds"] == 0.0 and empty.state is st


def test_fed_package_exports():
    """The port's fed package exports the reference's public names (and
    the codec's error classes)."""
    for name in [n for n in dir(jfed) if not n.startswith("_")
                 and not isinstance(getattr(jfed, n), type(jfed))] + [
            "verify", "WireDecodeError", "WireTruncatedError",
            "WireCorruptionError", "HEADER_BYTES", "FMT_PERMK_SLOT",
            "campaign_multipliers"]:
        assert hasattr(tfed, name), name
    assert dataclasses.is_dataclass(tfed.FedSim)

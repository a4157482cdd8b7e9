"""The port's full-state checkpoint (``repro_torch.checkpoint``) on the
CPU: the reference's format, its restore rules, and kill-and-restore
through files.

* Format and rules, as ``tests/test_driver.py`` and
  ``tests/test_misc_substrate.py`` hold the reference to them: every
  ``MethodState`` field round-trips bit for bit (flat, a parameter tree
  with Adam or SGD, lanes with a (G,) ``bits_sent``), bfloat16 through
  float32, v2 files drop the retired ``prev_params``, v1 files restore
  positionally with its leaf-count heuristic, a missing field raises, a
  ``Driver`` resume through files is bit-identical, the hook keeps its
  cadence.
* Across the packages (the only tests here that import both): a
  reference-written file loads into the port with ``seed=`` to exactly
  the state ``repro_torch.convert`` carries across, and a port-written
  file has the reference's field spans, dtypes and leaves, ``key`` /
  ``seed`` apart; the ``key`` -> ``seed`` rule raises both ways.
* The reference's kill-and-restore drills (``tests/test_fed_faults.py``)
  through files, on the port's own draws: ``FedSim`` and ``VecFedSim``
  killed after chunk 0, 1 or 3 of a 40-round campaign, restored from disk
  alone into a fresh simulator; the tail's traces and the final state
  equal an uninterrupted run's bit for bit.

Every comparison is exact: a checkpoint moves bits, never arithmetic.
"""
import collections
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_common import (glm_arrays, jax_glm_loss, state_arrays,
                          torch_glm_loss)

import repro.methods as jm
from repro.checkpoint import io as jio
from repro.compress import make_round_compressor as j_make_rc
from repro.core.oracles import FiniteSumProblem as JFiniteSum
from repro.optim import distributed as jdist
from repro_torch import convert
from repro_torch import fed as tfed
from repro_torch import methods as tm
from repro_torch.bench.common import lipschitz_glm, theory_hyper
from repro_torch.checkpoint import io as tio
from repro_torch.compress import make_round_compressor as t_make_rc
from repro_torch.fed.faults import FaultModel
from repro_torch.methods import driver as tdriver
from repro_torch.optim import distributed as tdist
from repro_torch.optim.base import AdamState

torch.set_num_threads(1)

N, M, D, K = 5, 32, 40, 6
NODES = 4


# ---------------------------------------------------------------------------
# states to save
# ---------------------------------------------------------------------------

def _flat(variant="dasha", backend="fused"):
    feats, labels = glm_arrays(N, M, D, seed=0)
    problem = convert.problem_from_numpy(torch_glm_loss, feats, labels,
                                         device="cpu")
    rc = t_make_rc("randk", D, N, k=K, backend=backend, device="cpu")
    hp = theory_hyper(variant, rc.omega, lipschitz_glm(problem), d=D, k=K,
                      n=N, m=M)
    method = tm.Method.build(variant, rc, tm.FlatSubstrate(problem, N, D),
                             hp)
    return method, method.init(torch.zeros(D), 11, device="cpu")


def _toy_params(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((6, 4), generator=g) * 0.5,
            "layers": {"a": torch.randn((2, 4, 4), generator=g) * 0.5,
                       "b": torch.zeros((2, 4))},
            "c": torch.randn((5,), generator=g) * 0.1}


def _toy_loss(p, b):
    h = torch.tanh(b["x"] @ p["w"])
    for i in range(2):
        h = torch.tanh(h @ p["layers"]["a"][i] + p["layers"]["b"][i])
    return torch.mean((h - b["y"]) ** 2) + torch.sum(p["c"] ** 2)


def _toy_data(seed, t):
    g = torch.Generator().manual_seed(seed % (1 << 62))
    return {"x": torch.randn((NODES, 8, 6), generator=g),
            "y": torch.randn((NODES, 8, 4), generator=g)}


def _tree(server_opt="adam", state_dtype="float32", variant="mvr"):
    cfg = tdist.DashaTrainConfig(gamma=0.05, compression=0.5,
                                 variant=variant, b=0.3, p=0.5,
                                 n_nodes=NODES, server_opt=server_opt,
                                 state_dtype=state_dtype)
    method = tdist.make_method(cfg, _toy_loss)
    return method, method.init(_toy_params(), 5, init_mode="zeros",
                               device="cpu")


def _run(method, state, rounds, **kw):
    data = dict(data_fn=_toy_data, data_seed=3) \
        if isinstance(state.x, dict) else {}
    return tdriver.run(method, state, rounds, **data, **kw)


def _lanes():
    _, st0 = _flat()
    feats, labels = glm_arrays(N, M, D, seed=0)
    problem = convert.problem_from_numpy(torch_glm_loss, feats, labels,
                                         device="cpu")
    rc = t_make_rc("randk", D, N, k=K, backend="fused", device="cpu")

    def method_fn(gamma):
        return tm.Method.build("dasha", rc, tm.FlatSubstrate(problem, N, D),
                               tm.Hyper(gamma=gamma, a=0.2))

    final, _ = tm.sweep(method_fn, np.array([0.01, 0.05, 0.2], np.float32),
                        st0, 4, device="cpu")
    return final


def _zeros_like(state):
    """A template of the state's structure, every value zeroed."""
    def zero(v):
        if isinstance(v, torch.Tensor):
            return torch.zeros_like(v)
        if isinstance(v, np.ndarray):
            return np.zeros_like(v)
        return type(v)(0)

    def walk(v):
        if v is None:
            return None
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            return type(v)(*(walk(x) for x in v))
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        if isinstance(v, (tuple, list)):
            return type(v)(walk(x) for x in v)
        return zero(v)

    return walk(state)


def _assert_same(a, b, what="state"):
    """Bit-equal values of equal type, structure and dtype."""
    assert type(a) is type(b), (what, type(a), type(b))
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        for f in a._fields:
            _assert_same(getattr(a, f), getattr(b, f), f"{what}.{f}")
    elif isinstance(a, dict):
        assert list(a) == list(b), what
        for k in a:
            _assert_same(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.device == b.device, what
        assert torch.equal(a, b), what
    elif isinstance(a, (np.ndarray, np.generic)):
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


# ---------------------------------------------------------------------------
# format and restore rules
# ---------------------------------------------------------------------------

def _saved_state(kind):
    if kind == "flat-dasha":
        method, st = _flat()
    elif kind == "flat-sync_mvr":
        method, st = _flat("sync_mvr", backend="sparse")
    elif kind == "tree-adam":
        method, st = _tree("adam")
    elif kind == "tree-sgd":
        method, st = _tree("sgd", variant="sync_mvr")
    else:
        return _lanes()
    return _run(method, st, 3)[0]


@pytest.mark.parametrize("kind", ["flat-dasha", "flat-sync_mvr",
                                  "tree-adam", "tree-sgd", "lanes"])
def test_method_state_roundtrip_is_bit_exact(kind, tmp_path):
    st = _saved_state(kind)
    path = str(tmp_path / "ck")
    tio.save_method_state(path, st)
    out = tio.load_method_state(path, _zeros_like(st))
    _assert_same(out, st)
    assert isinstance(out.t, int) and isinstance(out.seed, int)
    meta = tio.checkpoint_meta(path)
    assert meta["version"] == tio.FORMAT_VERSION == 2
    assert meta["step"] == st.t == (4 if kind == "lanes" else 3)
    assert [f["name"] for f in meta["fields"]] == list(st._fields)
    dtypes = dict(zip([f["name"] for f in meta["fields"]
                       for _ in range(f["leaves"])], meta["dtypes"]))
    assert (dtypes["seed"], dtypes["t"], dtypes["bits_sent"]) == \
        ("int64", "int32", "float32")
    if kind == "lanes":
        assert out.bits_sent.shape == (3,) and out.x.shape == (3, D)
    if kind == "tree-adam":
        assert isinstance(out.opt_state, AdamState)
        assert isinstance(out.opt_state.count, int)
        assert out.opt_state.count == 3


def test_bfloat16_leaves_are_stored_as_float32_and_come_back_bit_equal(
        tmp_path):
    method, st = _tree("adam", state_dtype="bfloat16")
    st, _ = _run(method, st, 2)
    assert st.h_local["w"].dtype == torch.bfloat16
    path = str(tmp_path / "ck")
    tio.save_method_state(path, st)
    meta = tio.checkpoint_meta(path)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        stored = {data[f"leaf_{i}"].dtype.name
                  for i, dt in enumerate(meta["dtypes"]) if dt == "bfloat16"}
    assert "bfloat16" in meta["dtypes"] and stored == {"float32"}
    _assert_same(tio.load_method_state(path, _zeros_like(st)), st)
    # the generic format too, and a float32 file into a bfloat16 template
    t = {"a": torch.randn((3, 5)).to(torch.bfloat16),
         "b": {"c": torch.arange(4, dtype=torch.int64)}}
    tio.save_checkpoint(path, t, step=42)
    assert tio.checkpoint_step(path) == 42
    _assert_same(tio.load_checkpoint(path, _zeros_like(t)), t)


def test_generic_checkpoint_shape_mismatch_raises(tmp_path):
    path = str(tmp_path / "ck")
    tio.save_checkpoint(path, {"a": torch.zeros((2, 3))})
    with pytest.raises(ValueError, match="shape mismatch"):
        tio.load_checkpoint(path, {"a": torch.zeros((3, 3))})
    with pytest.raises(ValueError, match="leaf count"):
        tio.load_checkpoint(path, {"a": torch.zeros((2, 3)),
                                   "b": torch.zeros(1)})


def _old_state_type():
    return collections.namedtuple(
        "DashaTrainState", ["params", "prev_params", "g", "h_local",
                            "g_local", "opt_state", "seed", "step"])


def _train_state():
    cfg = tdist.DashaTrainConfig(gamma=0.05, n_nodes=2)
    return tdist.dasha_train_init(_toy_params(), cfg, 5, device="cpu")


def test_v2_checkpoint_drops_the_retired_prev_params_field(tmp_path):
    new = _train_state()
    old = _old_state_type()(prev_params=new.params, **new._asdict())
    path = str(tmp_path / "ck")
    tio.save_state(path, old, step=7)
    assert "prev_params" in tio.RETIRED_FIELDS
    out = tio.load_state(path, _zeros_like(new))
    assert "prev_params" not in out._fields
    _assert_same(out, new)


def test_v1_positional_checkpoint_prev_params_heuristic(tmp_path):
    new = _train_state()
    old = _old_state_type()(prev_params=new.params, **new._asdict())
    path = str(tmp_path / "ck")
    tio.save_checkpoint(path, old, step=3)      # generic: no field spans
    mp = os.path.join(path, "meta.json")
    with open(mp) as f:
        meta = json.load(f)
    meta.pop("version")
    with open(mp, "w") as f:
        json.dump(meta, f)
    _assert_same(tio.load_state(path, _zeros_like(new)), new)


def test_missing_field_fails_loudly(tmp_path):
    _, st = _flat()
    Partial = collections.namedtuple("Partial", ["x", "g"])
    path = str(tmp_path / "ck")
    tio.save_state(path, Partial(x=st.x, g=st.g))
    with pytest.raises(ValueError, match="lacks state fields"):
        tio.load_state(path, st)


def test_host_leaves_keep_their_types_and_range(tmp_path):
    _, st = _flat()
    st = st._replace(seed=(1 << 62) + 5, t=9, bits_sent=np.float32(2.5))
    path = str(tmp_path / "ck")
    tio.save_method_state(path, st, extra={"note": 1})
    assert tio.checkpoint_meta(path)["extra"] == {"note": 1}
    out = tio.load_method_state(path, st._replace(seed=0, t=0,
                                                  bits_sent=np.float32(0)))
    assert (out.seed, out.t) == ((1 << 62) + 5, 9)
    assert type(out.bits_sent) is np.float32 and out.bits_sent == 2.5
    with pytest.raises(ValueError, match="int32"):
        tio.save_method_state(path, st._replace(t=1 << 31))


@pytest.mark.parametrize("variant", ["dasha", "sync_mvr"])
def test_driver_resume_through_files_is_bit_identical(variant, tmp_path):
    method, st0 = _flat(variant, backend="sparse" if variant == "sync_mvr"
                        else "fused")
    n = 6
    mets = {"metric": lambda s, d: torch.sum(torch.square(s.g))}
    full, tr_full = tdriver.run(method, st0, 2 * n, chunk=3, metrics=mets,
                                metric_every=4)
    half, tr_a = tdriver.run(method, st0, n, chunk=3, metrics=mets,
                             metric_every=4)
    path = str(tmp_path / "ck")
    tio.save_method_state(path, half)
    restored = tio.load_method_state(path, _zeros_like(half))
    _assert_same(restored, half)
    resumed, tr_b = tdriver.run(method, restored, n, chunk=3, metrics=mets,
                                metric_every=4)
    _assert_same(resumed, full)
    np.testing.assert_array_equal(
        np.concatenate([tr_a["bits_sent"], tr_b["bits_sent"]]),
        tr_full["bits_sent"])
    for t in range(n, 2 * n):
        if t % 4 == 0:                  # an evaluated point
            assert tr_b["metric"][t - n] == tr_full["metric"][t]


def test_data_fn_resume_through_files_regenerates_the_stream(tmp_path):
    """The data seed is keyed on the global round: a trainer state
    restored from a file sees the same batches, so resume is exact."""
    method, st0 = _tree("adam")
    full, _ = _run(method, st0, 6, chunk=2)
    half, _ = _run(method, st0, 3, chunk=2)
    path = str(tmp_path / "ck")
    tio.save_method_state(path, half)
    resumed, _ = _run(method, tio.load_method_state(path, _zeros_like(half)),
                      3, chunk=2)
    _assert_same(resumed, full)


def test_checkpoint_hook_cadence_through_files(tmp_path):
    method, st0 = _flat()
    path = str(tmp_path / "ck")
    seen = []

    def hook(s, done, tr):
        tio.save_method_state(path, s)
        seen.append((done, tio.checkpoint_step(path), s.t))

    final, _ = tdriver.run(method, st0, 10, chunk=2, checkpoint=hook,
                           checkpoint_every=2)
    # chunks end at 2, 4, 6, 8, 10: the hook at every 2nd and the last
    assert seen == [(4, 4, 4), (8, 8, 8), (10, 10, 10)]
    _assert_same(tio.load_method_state(path, _zeros_like(final)), final)


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

SEED = 123


def _reference_flat():
    feats, labels = glm_arrays(N, M, D, seed=0)
    jp = JFiniteSum(loss=jax_glm_loss, features=jnp.asarray(feats),
                    labels=jnp.asarray(labels))
    rc = j_make_rc("randk", D, N, k=K)
    method = jm.Method.build("dasha", rc, jm.FlatSubstrate(jp, N, D),
                             jm.Hyper(gamma=0.1, a=0.3))
    st = method.init(jnp.zeros(D), jax.random.PRNGKey(1))
    for _ in range(3):
        st = method.step(st)
    arrays = state_arrays(st)
    return st, arrays, lambda: convert.state_from_numpy(arrays, seed=SEED,
                                                        device="cpu")


def _jnp_toy_loss(p, b):
    h = jnp.tanh(b["x"] @ p["w"])
    for i in range(2):
        h = jnp.tanh(h @ p["layers"]["a"][i] + p["layers"]["b"][i])
    return jnp.mean((h - b["y"]) ** 2) + jnp.sum(p["c"] ** 2)


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _reference_tree(server_opt="adam", state_dtype="float32"):
    cfg = jdist.DashaTrainConfig(gamma=0.05, compression=0.5, variant="mvr",
                                 b=0.3, n_nodes=NODES, server_opt=server_opt,
                                 state_dtype=state_dtype)
    method = jdist.make_method(cfg, _jnp_toy_loss)
    params = {k: jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor)
              else {kk: jnp.asarray(vv.numpy()) for kk, vv in v.items()}
              for k, v in _toy_params().items()}
    st = method.init(params, jax.random.PRNGKey(2), init_mode="zeros")
    step = jax.jit(method.step)
    for t in range(2):
        b = _toy_data(t, t)
        st = step(st, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
    opt = st.opt_state
    arrays = {"x": _np(st.x), "g": _np(st.g), "g_local": _np(st.g_local),
              "h_local": _np(st.h_local), "t": np.asarray(st.t),
              "bits_sent": np.asarray(st.bits_sent),
              "opt_state": {"mu": _np(opt.mu), "nu": _np(opt.nu),
                            "count": np.asarray(opt.count)}
              if hasattr(opt, "mu") else ()}
    return st, arrays, lambda: convert.tree_state_from_numpy(
        arrays, seed=SEED, device="cpu")


REFERENCE_STATES = {"flat": _reference_flat,
                    "tree-adam": _reference_tree,
                    "tree-adam-bf16": lambda: _reference_tree(
                        state_dtype="bfloat16"),
                    "tree-sgd": lambda: _reference_tree("sgd")}


@pytest.mark.parametrize("kind", list(REFERENCE_STATES))
def test_reference_file_loads_into_the_port_with_a_seed(kind, tmp_path):
    jst, _, carried = REFERENCE_STATES[kind]()
    path = str(tmp_path / "ref")
    jio.save_method_state(path, jst)
    want = carried()
    got = tio.load_method_state(path, _zeros_like(want), seed=SEED)
    _assert_same(got, want)
    assert tio.checkpoint_step(path) == int(jst.t)


def _without(meta, leaves, field):
    """The meta's dtypes and the leaves with ``field``'s span removed."""
    off = 0
    for f in meta["fields"]:
        if f["name"] == field:
            cut = slice(off, off + f["leaves"])
            break
        off += f["leaves"]
    keep = [i for i in range(meta["num_leaves"])
            if not cut.start <= i < cut.stop]
    return [meta["dtypes"][i] for i in keep], [leaves[i] for i in keep]


def _file(path):
    meta = tio.checkpoint_meta(path)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        leaves = [data[f"leaf_{i}"] for i in range(meta["num_leaves"])]
    return meta, leaves


@pytest.mark.parametrize("kind", list(REFERENCE_STATES))
def test_port_file_has_the_reference_spans_and_leaves(kind, tmp_path):
    jst, _, carried = REFERENCE_STATES[kind]()
    jio.save_method_state(str(tmp_path / "ref"), jst)
    tio.save_method_state(str(tmp_path / "port"), carried())
    jmeta, jleaves = _file(str(tmp_path / "ref"))
    tmeta, tleaves = _file(str(tmp_path / "port"))
    rename = {"key": "seed"}
    assert [(rename.get(f["name"], f["name"]), f["leaves"])
            for f in jmeta["fields"]] == \
        [(f["name"], f["leaves"]) for f in tmeta["fields"]]
    assert (jmeta["version"], jmeta["step"], jmeta["extra"]) == \
        (tmeta["version"], tmeta["step"], tmeta["extra"])
    jd, jl = _without(jmeta, jleaves, "key")
    td, tl = _without(tmeta, tleaves, "seed")
    assert jd == td
    for i, (a, b) in enumerate(zip(jl, tl)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_array_equal(a, b, err_msg=str(i))
    assert tmeta["dtypes"][-3] == "int64"       # the seed


def test_reference_file_without_a_seed_raises(tmp_path):
    jst, _, carried = _reference_flat()
    path = str(tmp_path / "ref")
    jio.save_method_state(path, jst)
    with pytest.raises(ValueError, match="threefry"):
        tio.load_method_state(path, _zeros_like(carried()))


def test_port_file_with_a_seed_raises(tmp_path):
    _, st = _flat()
    path = str(tmp_path / "port")
    tio.save_method_state(path, st)
    with pytest.raises(ValueError, match="own seed"):
        tio.load_method_state(path, _zeros_like(st), seed=SEED)
    tio.save_checkpoint(path, st)               # no field spans
    with pytest.raises(ValueError, match="field spans"):
        tio.load_state(path, _zeros_like(st), seed=SEED)


def test_reference_train_state_file_loads_by_field_name(tmp_path):
    """The rule holds for ``DashaTrainState`` through ``load_state``: the
    reference's trainer state (``key``) restores into the port's
    (``seed``) with ``seed=``, and without it raises."""
    params = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
              "b": np.ones(3, np.float32)}
    cfg = dict(gamma=0.05, n_nodes=2, server_opt="adam")
    jst = jdist.dasha_train_init(
        jax.tree_util.tree_map(jnp.asarray, params),
        jdist.DashaTrainConfig(**cfg), jax.random.PRNGKey(6))
    path = str(tmp_path / "ref")
    jio.save_state(path, jst, step=4)
    want = tdist.dasha_train_init(
        {k: torch.as_tensor(v) for k, v in params.items()},
        tdist.DashaTrainConfig(**cfg), SEED, device="cpu")
    _assert_same(tio.load_state(path, _zeros_like(want), seed=SEED), want)
    with pytest.raises(ValueError, match="seed="):
        tio.load_state(path, _zeros_like(want))


# ---------------------------------------------------------------------------
# kill and restore through files (tests/test_fed_faults.py's drill)
# ---------------------------------------------------------------------------

ROUNDS = 40

FM_MIXED = dict(p_crash=0.08, crash_rounds=2, p_drop_up=0.1,
                p_drop_down=0.05, p_corrupt=0.05, deadline_mult=3.0,
                rejoin="reset", seed=7)
FM_SYNC = dict(p_crash=0.08, crash_rounds=2, p_drop_up=0.1, p_corrupt=0.05,
               deadline_mult=3.0, seed=7)


class _Killed(RuntimeError):
    """Simulated process death mid-campaign."""


def _dense_sim(cls, variant, fm, chunk):
    feats, labels = glm_arrays(N, M, D, seed=0)
    problem = convert.problem_from_numpy(torch_glm_loss, feats, labels,
                                         device="cpu")
    rc = t_make_rc("randk", D, N, k=K, backend="fused", device="cpu")
    hp = theory_hyper(variant, rc.omega, lipschitz_glm(problem), d=D, k=K,
                      n=N, m=M)
    sim = cls(variant, rc, tm.FlatSubstrate(problem, N, D), hp,
              faults=None if fm is None else FaultModel(**fm), seed=3,
              chunk=chunk)
    return sim, sim.init(torch.zeros(D), 0, device="cpu")


def _slab_sim(cls, variant, fm, chunk):
    n, c, d = 64, 8, 24
    feats, labels = glm_arrays(n, 1, d, seed=1)
    problem = convert.problem_from_numpy(torch_glm_loss, feats, labels,
                                         device="cpu")
    rc = t_make_rc("randk", d, n, k=4, backend="fused", device="cpu")
    sub = tm.SampledFlatSubstrate(problem, n, d, c=c)
    hp = tm.Hyper.from_theory("dasha", sub.with_compressor(rc)
                              .effective_omega(), n, L=2.0, gamma_mult=16)
    sim = cls("dasha", rc, sub, hp,
              uplink=tfed.LinkModel(latency_s=0.02, bandwidth_Bps=1e5,
                                    straggler=tfed.Lognormal(1.0)),
              seed=0, chunk=chunk)
    assert sim.slab
    return sim, sim.init(torch.zeros(d), 3, device="cpu")


def _drill(build, cls, variant, fm, kill_chunk, tmp_path, chunk=8):
    """Run a campaign, kill it after ``kill_chunk`` chunks (the hook saves
    the full MethodState with the next round and the wall clock, then
    raises), restore from disk alone into a fresh simulator, and finish:
    the tail's traces and the final state must equal an uninterrupted
    run's bit for bit."""
    path = str(tmp_path / "ck")
    sim, st = build(cls, variant, fm, chunk)
    full = sim.run(st, ROUNDS)
    calls = {"n": 0}

    def cp(state, next_round, now):
        tio.save_method_state(path, state, step=next_round,
                              extra={"wall_clock": now})
        calls["n"] += 1
        if calls["n"] == kill_chunk + 1:
            raise _Killed

    sim, st = build(cls, variant, fm, chunk)
    with pytest.raises(_Killed):
        sim.run(st, ROUNDS, checkpoint=cp)
    del sim, st
    # "a new process": a fresh simulator, the state from disk only
    sim2, like = build(cls, variant, fm, chunk)
    meta = tio.checkpoint_meta(path)
    cut = int(meta["step"])
    assert cut == (kill_chunk + 1) * chunk
    res = sim2.run(tio.load_method_state(path, _zeros_like(like)), ROUNDS,
                   start_round=cut, clock0=float(meta["extra"]["wall_clock"]))
    assert set(res.traces) == set(full.traces)
    for k in full.traces:
        np.testing.assert_array_equal(full.traces[k][cut:], res.traces[k],
                                      err_msg=k)
    _assert_same(res.state, full.state)


@pytest.mark.parametrize("cls", [tfed.FedSim, tfed.VecFedSim])
@pytest.mark.parametrize("kill_chunk", [0, 1, 3])
def test_kill_restore_through_files_dasha(cls, kill_chunk, tmp_path):
    _drill(_dense_sim, cls, "dasha", FM_MIXED, kill_chunk, tmp_path)


@pytest.mark.parametrize("cls", [tfed.FedSim, tfed.VecFedSim])
@pytest.mark.parametrize("kill_chunk", [0, 3])
def test_kill_restore_through_files_sync_mvr(cls, kill_chunk, tmp_path):
    _drill(_dense_sim, cls, "sync_mvr", FM_SYNC, kill_chunk, tmp_path)


@pytest.mark.parametrize("cls", [tfed.FedSim, tfed.VecFedSim])
def test_kill_restore_through_files_unfaulted_barrier(cls, tmp_path):
    _drill(_dense_sim, cls, "dasha", None, 1, tmp_path)


@pytest.mark.parametrize("cls", [tfed.FedSim, tfed.VecFedSim])
def test_kill_restore_through_files_on_the_slab_store(cls, tmp_path):
    _drill(_slab_sim, cls, "dasha", None, 1, tmp_path)


def test_a_planted_fault_fails_the_drill(tmp_path):
    """The drill's comparison is sharp: a restore with one h_local row one
    ulp off, or the start round one off, differs from the uninterrupted
    run."""
    path = str(tmp_path / "ck")
    sim, st = _dense_sim(tfed.VecFedSim, "dasha", FM_MIXED, 8)
    full = sim.run(st, ROUNDS)

    def cp(state, next_round, now):
        if next_round == 16:
            tio.save_method_state(path, state, step=next_round,
                                  extra={"wall_clock": now})

    sim.run(st, ROUNDS, checkpoint=cp)
    meta = tio.checkpoint_meta(path)
    restored = tio.load_method_state(path, _zeros_like(st))
    assert meta["step"] == 16
    clock0 = float(meta["extra"]["wall_clock"])
    h = restored.h_local.clone()
    h[2] = torch.nextafter(h[2], torch.full_like(h[2], np.inf))
    bad = sim.run(restored._replace(h_local=h), ROUNDS, start_round=16,
                  clock0=clock0)
    assert not torch.equal(bad.state.h_local, full.state.h_local)
    late = sim.run(restored, ROUNDS, start_round=17, clock0=clock0)
    assert len(late.traces["bits_sent"]) != len(full.traces["bits_sent"][16:])
    good = sim.run(restored, ROUNDS, start_round=16, clock0=clock0)
    _assert_same(good.state, full.state)

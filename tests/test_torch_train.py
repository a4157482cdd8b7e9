"""The port's DASHA trainer path against the reference (CPU).

* tree-level compression (``compress/treelevel.py``) with the reference's
  masks injected: Bernoulli, shared-coords and PermK messages, the fused
  tree update for dasha and mvr;
* the port's own mask draws by distribution;
* one-to-three ``TreeSubstrate`` rounds per variant x mode x use_kernel on
  a small two-layer tree model, with the reference's masks and sync coins
  replayed (``Draws.masks`` / ``Draws.sync_coin``);
* the whole slice: 5 rounds of ``make_method`` + ``Driver`` on the
  ``mamba2-smoke`` config (float32), DASHA-MVR with the fused kernel path,
  the reference's batches and masks replayed;
* the port's ``launch/train.py`` library function on the CPU, and its
  ``--ckpt`` / ``--resume`` (a resumed run equals an uninterrupted one bit
  for bit);
* the seed-era train-step API (``dasha_train_init`` / ``make_train_step``)
  as ``tests/test_train_distributed.py`` and ``tests/test_fused_paths.py``
  hold the reference's, and one step against the reference's with its
  masks replayed.

Tolerances: messages and masked updates are computed by the same
elementwise ops in both packages and agree to rtol 1e-6 (last-ulp drift
of XLA's fused loops); states after three rounds of the small model agree
to rtol 1e-5; after five Mamba2 rounds to 2e-4 of each leaf's largest
magnitude (gradients through two SSD layers differ in summation order;
see the whole-slice test for why it runs SGD).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import treelevel as jtl
from repro.configs import get_smoke_config as j_smoke
from repro.data.pipeline import SyntheticTextConfig as JText
from repro.data.pipeline import make_node_batches as j_node_batches
from repro.methods.driver import Driver as JDriver
from repro.models import init_params as j_init
from repro.models import lm as jlm
from repro.optim import distributed as jdist
from repro_torch import checkpoint as tcheckpoint
from repro_torch import convert
from repro_torch.compress import treelevel as ttl
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import tree
from repro_torch.core.rng import Draws, RoundRandom
from repro_torch.launch import train as ttrain
from repro_torch.methods import Driver as TDriver
from repro_torch.models import lm as tlm
from repro_torch.optim import distributed as tdist

torch.set_num_threads(1)

N = 4


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _port(t):
    return convert.params_from_numpy(_np(t), device="cpu")


def _assert_trees_close(got, want, rtol, atol, what="", of_max=False):
    """Leaf-wise closeness; ``of_max`` makes ``atol`` a fraction of each
    leaf's largest magnitude."""
    flat_w = {"/".join(p.key for p in path): np.asarray(v) for path, v in
              jax.tree_util.tree_leaves_with_path(want)}
    flat_g = dict(tree.items(got))
    assert sorted(flat_g) == sorted(flat_w), what
    for name, g in flat_g.items():
        w = flat_w[name].astype(np.float32)
        scale = max(float(np.abs(w).max()), 1e-30) if of_max else 1.0
        np.testing.assert_allclose(g.to(torch.float32).numpy(), w,
                                   rtol=rtol, atol=atol * scale,
                                   err_msg=f"{what} {name}")


def _per_node_tree(seed, shapes):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal((N,) + s).astype(np.float32)
                if isinstance(s, tuple) else _per_node_tree(seed + 1, s))
            for k, s in shapes.items()}


SHAPES = {"w": (6, 4), "layers": {"a": (2, 4, 4), "b": (2, 4)}, "c": (5,)}


# ---------------------------------------------------------------------------
# tree-level compression with injected masks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["independent", "shared_coords", "permk"])
def test_tree_masks_replay_and_dense_messages_match_reference(mode):
    delta = _per_node_tree(0, SHAPES)
    jdelta = jax.tree_util.tree_map(jnp.asarray, delta)
    key = jax.random.PRNGKey(3)
    p = 0.3
    jmasks, jscale = jtl.tree_masks(key, jdelta, mode=mode, p=p, n=N)
    rnd = RoundRandom(0, 0, Draws(masks=_port(jmasks)))
    tmasks, tscale = ttl.tree_masks(rnd, _port(jdelta), mode=mode, p=p, n=N)
    assert tscale == jscale
    _assert_trees_close(tmasks, jmasks, 0, 0, "masks")
    if mode == "permk":
        jm, jagg = jtl.permk_compress(key, jdelta, N)
        tm, tagg = ttl.permk_compress(rnd, _port(jdelta), N)
        _assert_trees_close(tagg, jagg, 1e-6, 1e-6, "aggregate")
    else:
        jm = jtl.bernoulli_compress(key, jdelta, p,
                                    shared=mode == "shared_coords")
        tm = ttl.bernoulli_compress(rnd, _port(jdelta), p,
                                    shared=mode == "shared_coords")
    _assert_trees_close(tm, jm, 1e-6, 1e-6, "messages")


@pytest.mark.parametrize("variant,b", [("dasha", 0.0), ("mvr", 0.1),
                                       ("mvr", 0.0)])
@pytest.mark.parametrize("mode", ["independent", "permk"])
def test_fused_tree_update_matches_reference(variant, b, mode):
    gn, go, h, gl = (_per_node_tree(s, SHAPES) for s in (1, 2, 3, 4))
    j = [jax.tree_util.tree_map(jnp.asarray, t) for t in (gn, go, h, gl)]
    key = jax.random.PRNGKey(5)
    kw = dict(mode=mode, a=0.2, p=0.25, n=N, variant=variant, b=b)
    want = jtl.fused_tree_update(key, j[0], j[2], j[3], grads_old=j[1],
                                 **kw)
    jmasks, _ = jtl.tree_masks(key, j[0], mode=mode, p=0.25, n=N)
    rnd = RoundRandom(0, 0, Draws(masks=_port(jmasks)))
    got = ttl.fused_tree_update(rnd, *(_port(t) for t in (j[0], j[2], j[3])),
                                grads_old=_port(j[1]), **kw)
    for g, w, name in zip(got, want, ("m", "h_new", "g_new")):
        _assert_trees_close(g, w, 1e-6, 1e-6, name)


def test_port_mask_draws_by_distribution():
    x = torch.zeros((N, 300, 100))
    per_node = {"big": x, "small": torch.zeros((N, 7))}
    rnd = RoundRandom(11, 4)
    masks, scale = ttl.tree_masks(rnd, per_node, mode="independent", p=0.2,
                                  n=N)
    dens = float(masks["big"].mean())
    assert abs(dens - 0.2) < 4 * np.sqrt(0.2 * 0.8 / x.numel())
    assert scale == 5.0
    # every leaf has its own stream, and a round's draw repeats exactly
    again, _ = ttl.tree_masks(RoundRandom(11, 4), per_node,
                              mode="independent", p=0.2, n=N)
    assert torch.equal(again["big"], masks["big"])
    other, _ = ttl.tree_masks(RoundRandom(11, 5), per_node,
                              mode="independent", p=0.2, n=N)
    assert not torch.equal(other["big"], masks["big"])
    shared, _ = ttl.tree_masks(rnd, per_node, mode="shared_coords", p=0.2,
                               n=N)
    assert all(torch.equal(shared["big"][i], shared["big"][0])
               for i in range(N))
    perm, pscale = ttl.tree_masks(rnd, per_node, mode="permk", p=1.0, n=N)
    assert pscale == float(N)
    for leaf in perm.values():      # a partition: each coordinate once
        assert torch.equal(leaf.sum(0), torch.ones_like(leaf[0]))
    counts = perm["big"].reshape(N, -1).sum(1)
    assert int(counts.max() - counts.min()) <= 1


def test_permk_rejects_a_mismatched_node_axis():
    with pytest.raises(ValueError, match="node axis"):
        ttl.tree_masks(RoundRandom(0, 0), {"w": torch.zeros((3, 5))},
                       mode="permk", p=1.0, n=N)


# ---------------------------------------------------------------------------
# TreeSubstrate rounds on a small tree model
# ---------------------------------------------------------------------------

def _toy_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((6, 4)) * 0.5).astype(np.float32),
            "layers": {"a": (rng.standard_normal((2, 4, 4)) * 0.5)
                       .astype(np.float32),
                       "b": np.zeros((2, 4), np.float32)},
            "c": rng.standard_normal(5).astype(np.float32) * 0.1}


def _toy_batch(t):
    rng = np.random.default_rng(100 + t)
    return {"x": rng.standard_normal((N, 8, 6)).astype(np.float32),
            "y": rng.standard_normal((N, 8, 4)).astype(np.float32)}


def _toy_loss_j(p, b):
    h = jnp.tanh(b["x"] @ p["w"])
    for i in range(2):
        h = jnp.tanh(h @ p["layers"]["a"][i] + p["layers"]["b"][i])
    return jnp.mean((h - b["y"]) ** 2) + jnp.sum(p["c"] ** 2)


def _toy_loss_t(p, b):
    h = torch.tanh(b["x"] @ p["w"])
    for i in range(2):
        h = torch.tanh(h @ p["layers"]["a"][i] + p["layers"]["b"][i])
    return torch.mean((h - b["y"]) ** 2) + torch.sum(p["c"] ** 2)


def _reference_draws(state, cfg):
    """The reference's masks and sync coin for the round it runs from
    ``state`` (``key, k_h, k_c, k_coin = split(key, 4)``)."""
    _, _, k_c, k_coin = jax.random.split(state.key, 4)
    masks, _ = jtl.tree_masks(k_c, state.h_local, mode=cfg.mode,
                              p=cfg.compression, n=cfg.n_nodes)
    coin = bool(jax.random.bernoulli(k_coin, cfg.p)) \
        if cfg.variant == "sync_mvr" else None
    return Draws(masks=_port(masks), sync_coin=coin)


def _state_arrays(s):
    opt = s.opt_state
    opt = {"mu": _np(opt.mu), "nu": _np(opt.nu), "count": np.asarray(
        opt.count)} if hasattr(opt, "mu") else ()
    return {"x": _np(s.x), "g": _np(s.g), "g_local": _np(s.g_local),
            "h_local": _np(s.h_local), "opt_state": opt,
            "t": np.asarray(s.t), "bits_sent": np.asarray(s.bits_sent)}


def _assert_state_close(got, want, rtol, atol, of_max=False):
    for name in ("x", "g", "g_local", "h_local"):
        _assert_trees_close(getattr(got, name), getattr(want, name), rtol,
                            atol, name, of_max)
    if hasattr(want.opt_state, "mu"):
        _assert_trees_close(got.opt_state.mu, want.opt_state.mu, rtol, atol,
                            "mu", of_max)
        assert got.opt_state.count == int(want.opt_state.count)
    assert got.t == int(want.t)
    assert got.bits_sent == np.float32(want.bits_sent)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("mode", ["independent", "permk"])
@pytest.mark.parametrize("variant,server_opt", [("dasha", "sgd"),
                                                ("mvr", "adam"),
                                                ("sync_mvr", "adam")])
def test_tree_substrate_rounds_match_reference(variant, server_opt, mode,
                                               use_kernel):
    kw = dict(gamma=0.05, compression=0.5, mode=mode, variant=variant,
              b=0.3, p=0.5, n_nodes=N, server_opt=server_opt,
              use_kernel=use_kernel)
    jcfg, tcfg = jdist.DashaTrainConfig(**kw), tdist.DashaTrainConfig(**kw)
    jmethod = jdist.make_method(jcfg, _toy_loss_j)
    tmethod = tdist.make_method(tcfg, _toy_loss_t)
    params = _toy_params()
    jstate = jmethod.init(jax.tree_util.tree_map(jnp.asarray, params),
                          jax.random.PRNGKey(2), init_mode="zeros")
    tstate = convert.tree_state_from_numpy(_state_arrays(jstate), seed=0,
                                           device="cpu")
    jstep = jax.jit(jmethod.step)
    for t in range(3):
        batch = _toy_batch(t)
        draws = _reference_draws(jstate, jcfg)
        jstate = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, info = tmethod.step_full(
            tstate, {k: torch.as_tensor(v) for k, v in batch.items()},
            draws=draws)
        _assert_state_close(tstate, jstate, 1e-5, 1e-6)
        assert info.coin == draws.sync_coin and info.messages is None
    assert tdist.payload_frac(tcfg) == jdist.payload_frac(jcfg)


def test_trainer_config_matches_reference_and_refuses_mesh_knobs():
    for mode in ("independent", "shared_coords", "permk"):
        for variant in ("dasha", "mvr", "page", "sync_mvr"):
            kw = dict(gamma=0.1, mode=mode, variant=variant, n_nodes=4)
            j, t = jdist.DashaTrainConfig(**kw), tdist.DashaTrainConfig(**kw)
            assert (t.omega, t.a) == (j.omega, j.a)
            assert tdist.payload_frac(t) == jdist.payload_frac(j)
    # the mesh knobs are accepted as the reference's are (they shape the
    # train specs; the step under them is tests/test_torch_knobs.py's)
    for knob in (dict(seq_shard=True), dict(fsdp=True),
                 dict(spmd_axes=("data",))):
        t = tdist.DashaTrainConfig(gamma=0.1, **knob)
        j = jdist.DashaTrainConfig(gamma=0.1, **knob)
        assert (t.seq_shard, t.fsdp, t.spmd_axes) == \
            (j.seq_shard, j.fsdp, j.spmd_axes)


def test_params_and_state_carry_bit_for_bit():
    jcfg = j_smoke("mamba2-780m")
    jparams = j_init(jcfg, jax.random.PRNGKey(4))
    tparams = convert.params_from_numpy(_np(jparams), device="cpu")
    for (path, w), (gpath, g) in zip(
            jax.tree_util.tree_leaves_with_path(jparams),
            tree.items(tparams)):
        assert gpath == "/".join(p.key for p in path)
        assert g.dtype == (torch.bfloat16 if w.dtype == jnp.bfloat16
                           else torch.float32)
        assert np.array_equal(g.to(torch.float32).numpy(),
                              np.asarray(w, np.float32))


# ---------------------------------------------------------------------------
# the whole slice on mamba2-smoke
# ---------------------------------------------------------------------------

ROUNDS, SEQ = 5, 64


def test_whole_slice_mamba2_matches_reference():
    """make_method + Driver, DASHA-MVR with the fused kernel path, n = 4,
    5 rounds: the reference's batches and masks are replayed into the
    port, and the final states must agree to 2e-4 of each leaf's largest
    magnitude (measured: 7e-5 on g, 1.3e-6 on the iterate).

    The server is SGD here.  Under Adam the same runs part after two
    rounds: its step is about sign(g) * lr wherever |g| is near the
    gradients' rounding noise (~1e-5 of a leaf's largest entry), so such
    coordinates move a whole step apart.  Adam's arithmetic is held to
    the reference on the small model above, where gradients agree to the
    last few ulp."""
    jcfg = dataclasses.replace(j_smoke("mamba2-780m"), dtype="float32")
    tcfg = dataclasses.replace(t_smoke("mamba2-780m"), dtype="float32")
    kw = dict(gamma=0.05, compression=0.25, mode="independent",
              variant="mvr", b=0.1, n_nodes=N, server_opt="sgd",
              use_kernel=True)
    jtc, ttc = jdist.DashaTrainConfig(**kw), tdist.DashaTrainConfig(**kw)
    jmethod = jdist.make_method(jtc, lambda p, b: jlm.loss_fn(jcfg, p, b)[0])
    tmethod = tdist.make_method(ttc, lambda p, b: tlm.loss_fn(tcfg, p, b)[0])
    jparams = j_init(jcfg, jax.random.PRNGKey(0))
    jstate = jmethod.init(jparams, jax.random.PRNGKey(1), init_mode="zeros")
    tstate = convert.tree_state_from_numpy(_state_arrays(jstate), seed=0,
                                           device="cpu")
    text = JText(vocab_size=jcfg.vocab_size, seq_len=SEQ)
    data_key = jax.random.PRNGKey(2)

    def j_data(k, t):
        return j_node_batches(k, text, N, 2)

    batches, draws, s = [], [], jstate
    for t in range(ROUNDS):
        b = j_node_batches(jax.random.fold_in(data_key, t), text, N, 2)
        batches.append({k: torch.as_tensor(np.array(v), dtype=torch.int64)
                        for k, v in b.items()})
        draws.append(_reference_draws(s, jtc))
        s = s._replace(key=jax.random.split(s.key, 4)[0])
    jfinal, _ = JDriver(jmethod, data_fn=j_data, chunk=ROUNDS).run(
        jstate, ROUNDS, data_key=data_key)

    def step(st, data):
        return tmethod.step_full(st, data, draws=draws[st.t])[0]

    tfinal, traces = TDriver(step, data_fn=lambda seed, t: batches[t]).run(
        tstate, ROUNDS, data_seed=0)
    _assert_state_close(tfinal, jfinal, 0.0, 2e-4, of_max=True)
    assert traces["bits_sent"].shape == (ROUNDS,)


# ---------------------------------------------------------------------------
# the trainer entry point
# ---------------------------------------------------------------------------

def test_train_library_function_runs_on_the_cpu():
    args = ttrain.build_parser().parse_args(
        ["--steps", "4", "--log-every", "2", "--seq", "64", "--variant",
         "mvr", "--use-kernel"])
    lines = []
    res = ttrain.train(t_smoke("mamba2-780m"), args, device="cpu",
                       log=lines.append)
    assert [c["rounds"] for c in res.chunks] == [2, 4]
    assert all(np.isfinite(c["loss"]) and c["seconds"] > 0
               for c in res.chunks)
    assert res.state.t == 4 and np.isfinite(res.loss0)
    assert res.chunks[-1]["loss"] < res.loss0
    assert lines[0].startswith("[train] arch=mamba2-smoke")
    # the driver can go on from where train stopped
    more, _ = res.driver.run(res.state, 1, data_seed=res.data_seed)
    assert more.t == 5


def test_ckpt_every_sets_the_hook_cadence_as_the_reference_driver():
    """``--ckpt-every 2`` with ``--log-every 1``: the hook (log line and
    chunk record) fires after every second chunk and after the last, the
    chunk boundaries at which the reference's ``Driver.run`` calls the
    hook that its ``train`` passes ``checkpoint_every=args.ckpt_every``."""
    args = ttrain.build_parser().parse_args(
        ["--steps", "6", "--log-every", "1", "--ckpt-every", "2", "--seq",
         "32"])
    res = ttrain.train(t_smoke("mamba2-780m"), args, device="cpu",
                       log=lambda _: None)
    seen = []
    JDriver(lambda s, d: s + 1, chunk=args.log_every).run(
        jnp.zeros((), jnp.int32), args.steps,
        checkpoint=lambda s, done, tr: seen.append(done),
        checkpoint_every=args.ckpt_every)
    assert [c["rounds"] for c in res.chunks] == seen == [2, 4, 6]
    assert res.state.t == 6


# ---------------------------------------------------------------------------
# --ckpt / --resume
# ---------------------------------------------------------------------------

CKPT_ARGS = ["--seq", "32", "--log-every", "1", "--use-kernel"]


def _train(steps, *extra, log=None):
    args = ttrain.build_parser().parse_args(
        ["--steps", str(steps), *CKPT_ARGS, *extra])
    return ttrain.train(t_smoke("mamba2-780m"), args, device="cpu",
                        log=log or (lambda _: None))


def _assert_port_states_equal(a, b):
    for name in ("x", "g", "g_local", "h_local"):
        for (pa, u), (pb, v) in zip(tree.items(getattr(a, name)),
                                    tree.items(getattr(b, name))):
            assert pa == pb and u.dtype == v.dtype, (name, pa)
            assert torch.equal(u, v), (name, pa)
    for f in ("mu", "nu"):
        for u, v in zip(tree.leaves(getattr(a.opt_state, f)),
                        tree.leaves(getattr(b.opt_state, f))):
            assert torch.equal(u, v), f
    assert a.opt_state.count == b.opt_state.count
    assert (a.seed, a.t) == (b.seed, b.t)
    assert a.bits_sent == b.bits_sent


@pytest.mark.parametrize("variant", ["mvr", "sync_mvr"])
def test_ckpt_then_resume_equals_an_uninterrupted_run(variant, tmp_path):
    """``--steps 2 --ckpt D`` then ``--steps 4 --ckpt D --resume`` ends in
    the state ``--steps 4`` reaches, bit for bit: the full MethodState is
    restored and the data stream is keyed on the global round."""
    ck = str(tmp_path / "ck")
    full = _train(4, "--variant", variant)
    first = _train(2, "--variant", variant, "--ckpt", ck)
    assert tcheckpoint.checkpoint_step(ck) == 2
    lines = []
    resumed = _train(4, "--variant", variant, "--ckpt", ck, "--resume",
                     log=lines.append)
    _assert_port_states_equal(resumed.state, full.state)
    assert resumed.start_step == 2 and resumed.state.t == 4
    assert any("resumed from" in ln and "at step 2" in ln for ln in lines)
    # the eval loss before the first round is that of the restored iterate
    assert resumed.loss0 == first.chunks[-1]["loss"]
    assert [c["loss"] for c in resumed.chunks] == \
        [c["loss"] for c in full.chunks[2:]]
    assert tcheckpoint.checkpoint_step(ck) == 4
    assert all(c["ckpt_s"] > 0 for c in resumed.chunks)


def test_resume_without_ckpt_exits():
    with pytest.raises(SystemExit, match="--resume requires --ckpt"):
        _train(2, "--resume")


@pytest.mark.parametrize("steps", [1, 2])
def test_resume_at_or_past_the_saved_step_runs_no_round(steps, tmp_path):
    ck = str(tmp_path / "ck")
    saved = _train(2, "--ckpt", ck)
    lines = []
    res = _train(steps, "--ckpt", ck, "--resume", log=lines.append)
    assert res.chunks == [] and res.state.t == 2 and res.start_step == 2
    assert "already at step 2" in lines[-1]
    _assert_port_states_equal(res.state, saved.state)


def test_logged_rounds_are_global(tmp_path):
    """After a resume the hook's log lines and chunk records show the
    global round, as the reference logs ``done + t``."""
    ck = str(tmp_path / "ck")
    _train(3, "--ckpt", ck)
    lines = []
    res = _train(7, "--ckpt", ck, "--resume", "--log-every", "2",
                 log=lines.append)
    assert [c["rounds"] for c in res.chunks] == [5, 7]
    steps = [int(ln.split()[2]) for ln in lines
             if ln.startswith("[train] step") and "|g|^2" in ln]
    assert steps == [5, 7]
    assert lines[2].startswith("[train] step     3 loss=")


def test_main_trains_resumes_and_reports_the_rounds_it_ran(tmp_path,
                                                           monkeypatch,
                                                           capsys):
    """``main`` with the real flags: the card is its default, so the test
    points it at the CPU."""
    real = ttrain.train
    monkeypatch.setattr(ttrain, "train", lambda cfg, args: real(
        cfg, args, device="cpu", log=lambda _: None))
    ck = str(tmp_path / "ck")
    assert ttrain.main(["--steps", "2", "--ckpt", ck, *CKPT_ARGS]) == 0
    assert ttrain.main(["--steps", "3", "--ckpt", ck, "--resume",
                        *CKPT_ARGS]) == 0
    out = capsys.readouterr().out
    assert "done: 2 rounds" in out and "done: 1 rounds" in out
    assert f"saved full method state to {ck}" in out


# ---------------------------------------------------------------------------
# the seed-era train-step API (tests/test_train_distributed.py and
# tests/test_fused_paths.py on the port)
# ---------------------------------------------------------------------------

def _mlp_problem():
    rng = np.random.default_rng(0)
    params = {"w1": torch.as_tensor(rng.standard_normal((8, 16)) * 0.3,
                                    dtype=torch.float32),
              "b1": torch.zeros(16),
              "w2": torch.as_tensor(rng.standard_normal((16, 4)) * 0.3,
                                    dtype=torch.float32)}
    target_w = torch.as_tensor(rng.standard_normal((8, 4)),
                               dtype=torch.float32)

    def loss(p, batch):
        h = torch.tanh(batch["x"] @ p["w1"] + p["b1"])
        return torch.mean((h @ p["w2"] - batch["y"]) ** 2)

    def make_batch(seed, n_nodes, b=16):
        g = torch.Generator().manual_seed(seed)
        x = torch.randn((n_nodes, b, 8), generator=g)
        return {"x": x, "y": torch.einsum("nbi,io->nbo", x, target_w)}

    return params, loss, make_batch


def _flat_batch(b):
    return {k: v.reshape((-1,) + v.shape[2:]) for k, v in b.items()}


def _train_loss_ratio(cfg, steps):
    params, loss, make_batch = _mlp_problem()
    state = tdist.dasha_train_init(params, cfg, 3, device="cpu")
    step = tdist.make_train_step(cfg, loss)
    flat = _flat_batch(make_batch(4, cfg.n_nodes))
    l0 = float(loss(params, flat))
    for t in range(steps):
        state, _ = step(state, make_batch(100 + t, cfg.n_nodes))
    assert state.step == steps
    return float(loss(state.params, flat)) / l0, state


@pytest.mark.parametrize("mode,variant,use_kernel", [
    ("independent", "dasha", False), ("independent", "mvr", False),
    ("permk", "dasha", False), ("shared_coords", "dasha", False),
    ("permk", "mvr", True), ("shared_coords", "dasha", True)])
def test_train_step_reduces_loss(mode, variant, use_kernel):
    cfg = tdist.DashaTrainConfig(gamma=0.01, compression=0.25, mode=mode,
                                 variant=variant, b=0.2, n_nodes=4,
                                 server_opt="adam", use_kernel=use_kernel)
    ratio, _ = _train_loss_ratio(cfg, 200 if use_kernel else 300)
    assert ratio < (0.6 if use_kernel else 0.5), ratio


def test_train_step_keeps_g_the_mean_of_g_local():
    cfg = tdist.DashaTrainConfig(gamma=0.05, compression=0.5, n_nodes=4)
    _, state = _train_loss_ratio(cfg, 5)
    for g, gl in zip(tree.leaves(state.g), tree.leaves(state.g_local)):
        np.testing.assert_allclose(g.numpy(), gl.mean(0).numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_bf16_state_still_learns():
    cfg = tdist.DashaTrainConfig(gamma=0.01, compression=0.25, n_nodes=4,
                                 server_opt="adam", state_dtype="bfloat16")
    ratio, state = _train_loss_ratio(cfg, 300)
    assert state.h_local["w1"].dtype == torch.bfloat16
    assert state.g["w1"].dtype == torch.float32
    assert ratio < 0.6, ratio


@pytest.mark.parametrize("mode", ["independent", "shared_coords", "permk"])
@pytest.mark.parametrize("variant", ["dasha", "mvr"])
def test_kernel_path_matches_the_unfused_path(mode, variant):
    """``use_kernel=True`` (the kernels' plain versions on the CPU) against
    the unfused path under the same draws."""
    params, loss, make_batch = _mlp_problem()
    batches = [make_batch(10 + i, 2) for i in range(4)]
    outs = []
    for uk in (False, True):
        cfg = tdist.DashaTrainConfig(gamma=0.05, compression=0.5, n_nodes=2,
                                     mode=mode, variant=variant, b=0.3,
                                     use_kernel=uk)
        state = tdist.dasha_train_init(params, cfg, 5, device="cpu")
        step = tdist.make_train_step(cfg, loss)
        for b in batches:
            state, _ = step(state, b)
        outs.append(state)
    for name in ("params", "g", "h_local", "g_local"):
        for a, b in zip(tree.leaves(getattr(outs[0], name)),
                        tree.leaves(getattr(outs[1], name))):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                       atol=1e-6, err_msg=name)


def test_dasha_train_init_matches_the_reference_and_views_round_trip():
    params = _toy_params()
    grads0 = _per_node_tree(7, {"w": (6, 4), "layers": {"a": (2, 4, 4),
                                                        "b": (2, 4)},
                                "c": (5,)})
    kw = dict(gamma=0.05, n_nodes=N, server_opt="adam")
    jst = jdist.dasha_train_init(
        jax.tree_util.tree_map(jnp.asarray, params), jdist.DashaTrainConfig(
            **kw), jax.random.PRNGKey(0),
        grads0=jax.tree_util.tree_map(jnp.asarray, grads0))
    tst = tdist.dasha_train_init(_port(params), tdist.DashaTrainConfig(**kw),
                                 9, grads0=_port(grads0), device="cpu")
    assert tst._fields == tuple("seed" if f == "key" else f
                                for f in jst._fields)
    for name in ("params", "g", "h_local", "g_local"):
        _assert_trees_close(getattr(tst, name), getattr(jst, name), 0, 0,
                            name)
    assert tst.opt_state.count == int(jst.opt_state.count) == 0
    assert (tst.seed, tst.step) == (9, 0)
    ms = tdist.method_state(tst, np.float32(3))
    assert (ms.x, ms.t, ms.seed, ms.bits_sent) == (tst.params, 0, 9, 3)
    back = tdist.train_state(ms)
    assert all(getattr(back, f) is getattr(tst, f) for f in tst._fields)


@pytest.mark.parametrize("variant,server_opt", [("dasha", "sgd"),
                                                ("mvr", "adam"),
                                                ("sync_mvr", "adam")])
def test_train_step_matches_the_reference_with_injected_draws(variant,
                                                              server_opt):
    """One ``make_train_step`` round per step of the reference's, its masks
    and sync coins replayed: state within fp32 tolerance, the metrics
    (``g_norm_sq`` before the step, the static fraction, the round's
    coords) as the reference's."""
    kw = dict(gamma=0.05, compression=0.5, mode="independent",
              variant=variant, b=0.3, p=0.5, n_nodes=N,
              server_opt=server_opt)
    jcfg, tcfg = jdist.DashaTrainConfig(**kw), tdist.DashaTrainConfig(**kw)
    params = _toy_params()
    jst = jdist.dasha_train_init(
        jax.tree_util.tree_map(jnp.asarray, params), jcfg,
        jax.random.PRNGKey(2))
    tst = tdist.dasha_train_init(_port(params), tcfg, 0, device="cpu")
    jstep = jax.jit(jdist.make_train_step(jcfg, _toy_loss_j))
    tstep = tdist.make_train_step(tcfg, _toy_loss_t)
    for t in range(3):
        batch = _toy_batch(t)
        draws = _reference_draws(jdist.method_state(jst), jcfg)
        jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in batch.items()})
        tst, tm_ = tstep(tst, {k: torch.as_tensor(v)
                               for k, v in batch.items()}, draws=draws)
        for name in ("params", "g", "h_local", "g_local"):
            _assert_trees_close(getattr(tst, name), getattr(jst, name), 1e-5,
                                1e-6, name)
        assert tst.step == int(jst.step) == t + 1
        np.testing.assert_allclose(float(tm_["g_norm_sq"]),
                                   float(jm["g_norm_sq"]), rtol=1e-5)
        assert tm_["payload_frac"] == np.float32(jm["payload_frac"])
        assert tm_["payload_coords"] == np.float32(jm["payload_coords"])

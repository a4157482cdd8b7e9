"""Helpers shared by the port's model-family tests (``test_torch_moe``,
``test_torch_mla``, ``test_torch_gemma3``, ``test_torch_hybrid``): array
conversion, the tolerance check, and the LM / trainer parity runs against
the reference on its parameters, batches and masks."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.compress import treelevel as jtl
from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.data.pipeline import SyntheticTextConfig as JText
from repro.data.pipeline import make_node_batches as j_node_batches
from repro.methods.driver import Driver as JDriver
from repro.models import init_params as j_init
from repro.models import lm as jlm
from repro.optim import distributed as jdist
from repro_torch import convert
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import tree
from repro_torch.core.rng import Draws
from repro_torch.methods import Driver as TDriver
from repro_torch.models import init_params as t_init
from repro_torch.models import lm as tlm
from repro_torch.optim import distributed as tdist

N_NODES = 4

#: the reference's ``init_params`` compiled once per config (its eager
#: form compiles each op on its own); the parity tests carry whatever it
#: draws into the port
j_init_jit = jax.jit(j_init, static_argnums=0)


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def port(t):
    return convert.params_from_numpy(np_tree(t), device="cpu")


def rand(seed, shape, scale=0.1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def tt(a):
    return torch.as_tensor(np.asarray(a))


def tokens(seed, B, S, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, (B, S)) \
        .astype(np.int32)


def close_of_max(got, want, frac, what=""):
    """|got - want| <= frac * max|want|, elementwise."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= frac * scale, f"{what}: {err} > {frac} x {scale}"


def f32_smoke(arch, **kw):
    """The reference's and the port's smoke config of ``arch`` in
    float32 (with ``kw`` replaced in both)."""
    return (dataclasses.replace(j_smoke(arch), dtype="float32", **kw),
            dataclasses.replace(t_smoke(arch), dtype="float32", **kw))


def smoke_model(arch, seed=0, **kw):
    """(jcfg, tcfg, reference params, the same params in the port)."""
    jcfg, tcfg = f32_smoke(arch, **kw)
    jp = j_init_jit(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, port(jp)


def assert_configs_equal(arch):
    """The port's full and smoke configs equal the reference's field for
    field (every field the port has)."""
    for j, t in ((j_config(arch), t_config(arch)),
                 (j_smoke(arch), t_smoke(arch))):
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.padded_vocab == j.padded_vocab
        assert t.head_dim == j.head_dim


def assert_init_tree_matches(arch, n_leaves):
    """init_params: the reference's leaf names, shapes and dtypes (bf16
    weights, a float32 router), and ``params_from_numpy`` of the
    reference's tree comes back leaf for leaf, bit for bit."""
    tcfg, jcfg = t_smoke(arch), j_smoke(arch)
    got = t_init(tcfg, 5, device="cpu")
    jp = j_init_jit(jcfg, jax.random.PRNGKey(0))
    want = jax.tree_util.tree_leaves_with_path(jp)
    assert [p for p, _ in tree.items(got)] == [
        "/".join(k.key for k in path) for path, _ in want]
    assert len(want) == n_leaves
    for (path, g), (_, w) in zip(tree.items(got), want):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[1] == str(w.dtype), path
    carried = port(jp)
    for (path, g), (_, w) in zip(tree.items(carried), want):
        back = g.float().numpy() if g.dtype == torch.bfloat16 \
            else g.numpy()
        np.testing.assert_array_equal(back, np.asarray(w, np.float32),
                                      err_msg=path)
    return got


def assert_param_counts(arch):
    t, j = t_config(arch), j_config(arch)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    return t.param_count()


def assert_forward_and_loss(jcfg, tcfg, jp, tp, B=2, S=40, seed=0,
                            aux_nonzero=False, frac=1e-5):
    """forward (logits within ``frac`` of the largest, aux, last_only) and
    loss_fn (total, loss, aux, out-of-vocab labels masked) against the
    reference."""
    tok = tokens(seed, B, S)
    got, aux = tlm.forward(tcfg, tp, tt(tok).long())
    want, jaux = jlm.forward(jcfg, jp, jnp.asarray(tok), remat=False)
    assert got.shape == want.shape == (B, S, tcfg.padded_vocab)
    close_of_max(got.numpy(), want, frac, "logits")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5,
                               atol=1e-7)
    assert (float(aux) > 0) == aux_nonzero
    last, _ = tlm.forward(tcfg, tp, tt(tok).long(), last_only=True)
    np.testing.assert_allclose(last[:, 0].numpy(), got[:, -1].numpy(),
                               rtol=1e-5, atol=1e-5)
    labels = tokens(seed + 1, B, S)
    labels[0, 1], labels[1, 3] = -1, tcfg.vocab_size + 5
    batch = {"tokens": tok, "labels": labels}
    loss, m = tlm.loss_fn(tcfg, tp, {k: tt(v).long()
                                     for k, v in batch.items()})
    jloss, jm = jlm.loss_fn(jcfg, jp, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    for g, w in ((loss, jloss), (m["loss"], jm["loss"]),
                 (m["aux"], jm["aux"])):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


def assert_streaming_forward(jcfg, tcfg, jp, tp, seed=1):
    """S = 2,048: the streaming attention path, last-position logits."""
    tok = tokens(seed, 1, 2048)
    got, _ = tlm.forward(tcfg, tp, tt(tok).long(), last_only=True)
    want, _ = jlm.forward(jcfg, jp, jnp.asarray(tok), remat=False,
                          last_only=True)
    close_of_max(got.numpy(), want, 1e-5, "streaming logits")


def assert_decode_steps(jcfg, tcfg, jp, tp, S, cache_seq=None, seed=4):
    """S teacher-forced decode steps on a cache of ``cache_seq`` positions
    (default S) against the reference's decode (compiled once), logits and
    every cache leaf; the cache's tree is the reference's.  Returns the
    last logits and the port's cache."""
    B = 2
    tok = tokens(seed, B, S)
    jcache = jlm.init_cache(jcfg, B, cache_seq or S)
    cache = convert.cache_from_numpy(np_tree(jcache), device="cpu")
    jstep = jax.jit(functools.partial(jlm.decode_step, jcfg))
    for t in range(S):
        logits, cache = tlm.decode_step(tcfg, tp, cache,
                                        tt(tok[:, t]).long(), t)
        jlogits, jcache = jstep(jp, jcache, jnp.asarray(tok[:, t]),
                                jnp.int32(t))
        close_of_max(logits.numpy(), jlogits, 1e-5, f"step {t}")
    flat_w = jax.tree_util.tree_leaves_with_path(jcache)
    flat_g = list(tree.items(cache))
    assert [p for p, _ in flat_g] == ["/".join(k.key for k in path)
                                      for path, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        close_of_max(g.numpy(), w, 1e-5, path)
    return logits, cache, tok


def assert_init_cache(arch, seq, want_keys):
    for jcfg, tcfg in ((j_smoke(arch), t_smoke(arch)),
                       f32_smoke(arch)):
        want = jax.tree_util.tree_leaves_with_path(
            jlm.init_cache(jcfg, 3, seq))
        got = list(tree.items(tlm.init_cache(tcfg, 3, seq, device="cpu")))
        assert [p for p, _ in got] == ["/".join(k.key for k in path)
                                       for path, _ in want] == want_keys
        for (path, g), (_, w) in zip(got, want):
            assert tuple(g.shape) == w.shape, path
            assert str(g.dtype).split(".")[1] == str(w.dtype), path
            assert not g.any()


# ---------------------------------------------------------------------------
# trainer rounds with the reference's draws replayed
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tree_masks(mode, p, n):
    """The reference's per-leaf mask draw, compiled once per setting (the
    same bits as its eager form, without one compile per leaf)."""
    return jax.jit(lambda k, t: jtl.tree_masks(k, t, mode=mode, p=p,
                                               n=n)[0])


def _reference_masks(key, h_local, cfg):
    _, _, k_c, _ = jax.random.split(key, 4)
    masks = _tree_masks(cfg.mode, cfg.compression, cfg.n_nodes)(k_c,
                                                                 h_local)
    return Draws(masks=port(masks))


def _state_arrays(s):
    return {"x": np_tree(s.x), "g": np_tree(s.g),
            "g_local": np_tree(s.g_local), "h_local": np_tree(s.h_local),
            "opt_state": (), "t": np.asarray(s.t),
            "bits_sent": np.asarray(s.bits_sent)}


def _assert_trees_close_of_max(got, want, frac, what):
    flat_w = {"/".join(p.key for p in path): np.asarray(v, np.float32)
              for path, v in jax.tree_util.tree_leaves_with_path(want)}
    flat_g = dict(tree.items(got))
    assert sorted(flat_g) == sorted(flat_w), what
    for name, g in flat_g.items():
        close_of_max(g.to(torch.float32).numpy(), flat_w[name], frac,
                     f"{what} {name}")


def reference_trainer_rounds(arch, rounds=2, seq=32, use_kernel=False,
                             **cfg_kw):
    """The reference's side of :func:`assert_trainer_rounds` (its Pallas
    kernel in interpret mode with ``use_kernel``), run once: its final
    state, and what the port replays (its initial state, batches and
    masks)."""
    jcfg, tcfg = f32_smoke(arch, **cfg_kw)
    kw = dict(gamma=0.05, compression=0.25, mode="independent",
              variant="mvr", b=0.1, n_nodes=N_NODES, server_opt="sgd")
    jtc = jdist.DashaTrainConfig(use_kernel=use_kernel, **kw)
    jmethod = jdist.make_method(jtc, lambda p, b: jlm.loss_fn(
        jcfg, p, b, remat=False)[0])
    jstate = jmethod.init(j_init_jit(jcfg, jax.random.PRNGKey(0)),
                          jax.random.PRNGKey(1), init_mode="zeros")
    text = JText(vocab_size=jcfg.vocab_size, seq_len=seq)
    data_key = jax.random.PRNGKey(2)
    batches, draws, key = [], [], jstate.key
    for t in range(rounds):
        b = j_node_batches(jax.random.fold_in(data_key, t), text, N_NODES, 2)
        batches.append({k: torch.as_tensor(np.array(v), dtype=torch.int64)
                        for k, v in b.items()})
        draws.append(_reference_masks(key, jstate.h_local, jtc))
        key = jax.random.split(key, 4)[0]
    jfinal, _ = JDriver(jmethod, data_fn=lambda k, t: j_node_batches(
        k, text, N_NODES, 2), chunk=rounds).run(jstate, rounds,
                                                data_key=data_key)
    return dict(tcfg=tcfg, kw=kw, rounds=rounds, jfinal=jfinal,
                init=_state_arrays(jstate), batches=batches, draws=draws)


def assert_port_trainer_rounds(ref, use_kernel):
    """The port's side: make_method + Driver from the reference's initial
    state on its batches and masks (``ref``, from
    :func:`reference_trainer_rounds`): x, g, g_local, h_local within 2e-4
    of each leaf's largest magnitude (``tests/test_torch_dense.py``'s
    bound); with ``use_kernel`` kernel 3 (its plain version on the CPU)
    runs once per parameter leaf a round."""
    from repro_torch.kernels import ops
    tcfg, rounds, draws, batches = (ref["tcfg"], ref["rounds"],
                                    ref["draws"], ref["batches"])
    ttc = tdist.DashaTrainConfig(use_kernel=use_kernel, **ref["kw"])
    tmethod = tdist.make_method(ttc, lambda p, b: tlm.loss_fn(tcfg, p, b)[0])
    tstate = convert.tree_state_from_numpy(ref["init"], seed=0,
                                           device="cpu")
    calls = []
    real = ops.dasha_mvr_update

    def spy(*a):
        calls.append(tuple(a[0].shape))
        return real(*a)

    def step(st, data):
        return tmethod.step_full(st, data, draws=draws[st.t])[0]

    x0 = {p: g.clone() for p, g in tree.items(tstate.x)}
    ops.dasha_mvr_update = spy
    try:
        tfinal, _ = TDriver(step, data_fn=lambda seed, t: batches[t]).run(
            tstate, rounds, data_seed=0)
    finally:
        ops.dasha_mvr_update = real
    jfinal = ref["jfinal"]
    for name in ("x", "g", "g_local", "h_local"):
        _assert_trees_close_of_max(getattr(tfinal, name),
                                   getattr(jfinal, name), 2e-4, name)
    assert tfinal.t == int(jfinal.t) == rounds
    assert tfinal.bits_sent == np.float32(jfinal.bits_sent)
    leaves = len(tree.leaves(tfinal.x))
    assert len(calls) == (leaves * rounds if use_kernel else 0)
    # the run moved: x is not the initial parameters
    assert any(float((g - x0[p]).abs().max()) > 0
               for p, g in tree.items(tfinal.x))
    return tfinal


def assert_trainer_rounds(arch, use_kernel, rounds=2, seq=32, **cfg_kw):
    """make_method + Driver on ``arch``'s smoke config (float32), n = 4,
    DASHA-MVR with an SGD server, ``rounds`` rounds on the reference's
    batches and masks replayed, both packages on the kernel route or
    both on the plain one (:func:`assert_port_trainer_rounds`)."""
    return assert_port_trainer_rounds(reference_trainer_rounds(
        arch, rounds, seq, use_kernel, **cfg_kw), use_kernel)

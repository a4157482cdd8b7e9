"""The port's mixture-of-experts FFN and the phi3.5-moe family against the
reference (CPU).

* ``moe_ffn`` by both dispatch modes, with and without shared experts;
  capacity drops; the einsum path's zero pad rows (N not a multiple of
  ``moe_chunk``); a zero router, where every token ties; ``dropless``
  decode (the gather path even under ``moe_dispatch="einsum"``); the
  gradients through the router: outputs and aux losses against the
  reference's on the reference's parameters, and the experts' input
  buffers — the slot maps — equal to the reference's exactly (captured
  through its sharding-constraint hooks, which are identities on one
  device; the einsum path's ``lax.scan`` runs eagerly under
  ``jax.disable_jit``);
* the router's top-k against ``lax.top_k`` on the same probabilities,
  ties included (toward the lower index), exactly;
* ``_capacity`` truncates as the reference's does;
* phi3.5-moe smoke: config, parameter tree, ``param_count`` /
  ``active_param_count`` of the full config, ``forward`` / ``loss_fn``
  (with the aux loss) by both dispatch modes, ``init_cache`` and
  ``decode_step`` (dropless), and DASHA-MVR trainer rounds on replayed
  masks, plain and kernel routes.

Tolerances: float32 outputs within 1e-5 of their largest magnitude and
aux losses to rtol 1e-5 (``tests/test_torch_dense.py``'s bound; the two
frameworks sum matmuls in different orders); gradients to rtol 1e-4 / atol
1e-6 of their largest magnitude; slot maps, buffers and top-k indices
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe_mod
from repro.models.common import ArchConfig as JArchConfig
from repro.models.init import _moe_params as j_moe_params
from repro.models.moe import _capacity as j_capacity
from repro.models.moe import moe_ffn as j_moe_ffn
from repro_torch.models import moe as tmoe
from repro_torch.models.common import ArchConfig
from torch_models_common import (assert_configs_equal,
                                 assert_decode_steps,
                                 assert_forward_and_loss,
                                 assert_init_cache,
                                 assert_init_tree_matches,
                                 assert_param_counts, assert_trainer_rounds,
                                 close_of_max, port, rand, smoke_model, tt)

torch.set_num_threads(1)

ARCH = "phi3.5-moe-42b-a6.6b"


def _cfgs(**kw):
    base = dict(name="t", arch_type="moe", num_layers=1, d_model=16,
                num_heads=2, num_kv_heads=2, d_ff=32, vocab_size=64,
                num_experts=4, experts_per_token=2, dtype="float32")
    base.update(kw)
    return JArchConfig(**base), ArchConfig(**base)


def _params(jcfg, seed, zero_router=False):
    p = j_moe_params(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    if zero_router:
        p = dict(p, router=jnp.zeros_like(p["router"]))
    return p, port(p)


def _tokens_x(seed, B, S, d):
    """Inputs whose feature 0 is the token's index + 1, so that a buffer
    row names the token it holds (0: the zero pad row)."""
    x = rand(seed, (B, S, d), 1.0)
    x[..., 0] = np.arange(1, B * S + 1, dtype=np.float32).reshape(B, S)
    return x


def _reference(monkeypatch, p, x, cfg, dropless=False):
    """The reference's (out, aux) and the experts' input buffers, one
    (E, C, d) per chunk (the first expert-major constraint of each six)."""
    seen = []

    def record(a):
        seen.append(np.asarray(a))
        return a

    monkeypatch.setattr(jmoe_mod, "constrain_expert_major", record)
    with jax.disable_jit():
        out, aux = j_moe_ffn(p, jnp.asarray(x), cfg, dropless=dropless)
    return np.asarray(out), float(aux), seen[0::6]


def _port_run(monkeypatch, p, x, cfg, dropless=False):
    bufs = []
    real = tmoe._experts

    def record(pp, buf):
        bufs.append(buf.detach().numpy().copy())
        return real(pp, buf)

    monkeypatch.setattr(tmoe, "_experts", record)
    out, aux = tmoe.moe_ffn(p, tt(x), cfg, dropless=dropless)
    return out.detach().numpy(), float(aux), bufs


def _slot_maps(bufs, N):
    """(E, C) token per slot (N for an empty slot) from the buffers."""
    return [np.where(b[..., 0] > 0, b[..., 0] - 1, N).astype(np.int64)
            for b in bufs]


def _assert_same(monkeypatch, jcfg, tcfg, jp, tp, x, dropless=False):
    want, jaux, jbufs = _reference(monkeypatch, jp, x, jcfg, dropless)
    got, aux, bufs = _port_run(monkeypatch, tp, x, tcfg, dropless)
    close_of_max(got, want, 1e-5, "moe out")
    np.testing.assert_allclose(aux, jaux, rtol=1e-5)
    assert len(bufs) == len(jbufs)
    for b, jb in zip(bufs, jbufs):
        np.testing.assert_array_equal(b, jb)
    N = x.shape[0] * x.shape[1]
    return _slot_maps(bufs, N), got, aux


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
def test_moe_ffn_matches_reference(monkeypatch, dispatch, shared):
    jcfg, tcfg = _cfgs(num_shared_experts=shared, moe_dispatch=dispatch,
                       capacity_factor=100.0)
    jp, tp = _params(jcfg, 0)
    x = _tokens_x(1, 2, 5, 16)
    maps, _, aux = _assert_same(monkeypatch, jcfg, tcfg, jp, tp, x)
    # capacity 100: every (token, k) pair holds a slot
    assert sum(int((m < 10).sum()) for m in maps) == 10 * 2
    assert aux > 0


@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
def test_capacity_drops_match_reference(monkeypatch, dispatch):
    """capacity_factor 0.3: C = int(0.3 * 32 * 2 / 4) = 4 slots an expert
    for 64 (token, k) pairs; the slot maps (which pairs keep a slot) and
    the outputs equal the reference's, and dropped pairs add nothing."""
    jcfg, tcfg = _cfgs(capacity_factor=0.3, moe_dispatch=dispatch)
    jp, tp = _params(jcfg, 4)
    x = _tokens_x(5, 1, 32, 16)
    maps, got, _ = _assert_same(monkeypatch, jcfg, tcfg, jp, tp, x)
    C = tmoe._capacity(tcfg, 32)
    assert C == 4 and maps[0].shape == (4, C)
    assert int((maps[0] < 32).sum()) < 64          # pairs were dropped
    # a token none of whose pairs kept a slot gets no routed output
    kept = set(maps[0][maps[0] < 32].tolist())
    dropped = [t for t in range(32) if t not in kept]
    assert dropped
    assert not np.abs(got.reshape(32, 16)[dropped]).any()


@pytest.mark.parametrize("shared", [0, 1])
def test_einsum_pad_rows_match_reference(monkeypatch, shared):
    """N = 14 tokens in chunks of 8: the last chunk has 2 zero pad rows,
    which route (their logits are all 0, so they tie and pick experts 0
    and 1) and take capacity; chunk by chunk the slot maps equal the
    reference's."""
    jcfg, tcfg = _cfgs(moe_dispatch="einsum", moe_chunk=8,
                       capacity_factor=1.0, num_shared_experts=shared)
    jp, tp = _params(jcfg, 6)
    x = _tokens_x(7, 2, 7, 16)
    maps, _, _ = _assert_same(monkeypatch, jcfg, tcfg, jp, tp, x)
    assert len(maps) == 2
    # the pad rows' zero logits tie: they choose experts 0 and 1, and their
    # probabilities and first choices count in the last chunk's aux loss
    _, _, idx = tmoe._route(torch.zeros((2, 4)), 2)
    assert idx.tolist() == [[0, 1]] * 2


@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
def test_zero_router_ties_match_reference(monkeypatch, dispatch):
    """A zero router: every probability is 1/E, every token picks experts
    0..K-1 (ties to the lower index), and capacity decides who drops;
    outputs, aux (E * 1/E * 1 = 1) and slot maps equal the reference's."""
    jcfg, tcfg = _cfgs(moe_dispatch=dispatch, capacity_factor=1.0)
    jp, tp = _params(jcfg, 8, zero_router=True)
    x = _tokens_x(9, 1, 12, 16)
    maps, _, aux = _assert_same(monkeypatch, jcfg, tcfg, jp, tp, x)
    np.testing.assert_allclose(aux, 1.0, rtol=1e-6)
    C = tmoe._capacity(tcfg, 12)
    # experts 0 and 1 are full with the first C tokens; 2 and 3 are empty
    for e in (0, 1):
        np.testing.assert_array_equal(maps[0][e], np.arange(C))
    assert (maps[0][2:] == 12).all()
    _, _, idx = tmoe._route(torch.zeros((12, 4)), 2)
    assert idx.tolist() == [[0, 1]] * 12


def test_dropless_decode_takes_the_gather_path(monkeypatch):
    """dropless=True: capacity N, no drops, the gather path even with
    ``moe_dispatch="einsum"``; against the reference's dropless call."""
    jcfg, tcfg = _cfgs(capacity_factor=0.01, moe_dispatch="einsum",
                       num_shared_experts=1)
    jp, tp = _params(jcfg, 10)
    x = _tokens_x(11, 8, 1, 16)
    maps, _, _ = _assert_same(monkeypatch, jcfg, tcfg, jp, tp, x,
                              dropless=True)
    assert len(maps) == 1 and maps[0].shape == (4, 8)
    assert int((maps[0] < 8).sum()) == 8 * 2            # nothing dropped


@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
def test_gradients_through_the_router_match_reference(dispatch):
    jcfg, tcfg = _cfgs(moe_dispatch=dispatch, capacity_factor=1.0,
                       num_shared_experts=1)
    jp, tp = _params(jcfg, 12)
    x = _tokens_x(13, 1, 8, 16)
    names = ("router", "w_gate", "w_out", "shared_w_in")

    def jf(*ws):
        out, aux = j_moe_ffn(dict(jp, **dict(zip(names, ws))),
                             jnp.asarray(x), jcfg)
        return jnp.sum(out ** 2) + aux

    want = jax.grad(jf, argnums=tuple(range(len(names))))(
        *(jp[n] for n in names))
    ws = [tp[n].clone().requires_grad_(True) for n in names]
    out, aux = tmoe.moe_ffn(dict(tp, **dict(zip(names, ws))), tt(x), tcfg)
    got = torch.autograd.grad(torch.sum(out ** 2) + aux, ws)
    for n, g, w in zip(names, got, want):
        close_of_max(g.numpy(), w, 1e-4, n)
    assert float(got[0].abs().sum()) > 0


def test_top_k_breaks_ties_toward_the_lower_index():
    """``_route``'s indices equal ``lax.top_k``'s on the same
    probabilities, on rows full of ties."""
    rng = np.random.default_rng(0)
    logits = rng.integers(0, 3, (64, 6)).astype(np.float32)
    logits[:8] = 0.0
    probs, vals, idx = tmoe._route(tt(logits), 3)
    jv, ji = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    jv = jv / jnp.clip(jv.sum(-1, keepdims=True), 1e-9)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=1e-6)
    assert idx[:8].tolist() == [[0, 1, 2]] * 8


@pytest.mark.parametrize("N,K,E", [(500, 6, 64), (64, 2, 4), (1, 1, 1)])
def test_slot_positions_equal_the_reference_cumsum(N, K, E):
    """The stable-sort count equals the reference's cumsum over the
    (N*K, E) one-hot (``src/repro/models/moe.py:56-59``) integer for
    integer."""
    rng = np.random.default_rng(N + E)
    gate_idx = np.stack([rng.permutation(E)[:K] for _ in range(N)])
    onehot = jax.nn.one_hot(jnp.asarray(gate_idx), E, dtype=jnp.int32)
    flat = onehot.reshape(N * K, E)
    want = jnp.sum((jnp.cumsum(flat, 0) - flat).reshape(N, K, E) * onehot,
                   -1)
    got = tmoe._slot_positions(tt(gate_idx).long(), E)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cf", [1.25, 0.3, 0.01])
def test_capacity_truncates_as_the_reference(cf):
    jcfg, tcfg = _cfgs(capacity_factor=cf, num_experts=6,
                       experts_per_token=4)
    for n in (1, 5, 7, 13, 100, 4097):
        assert tmoe._capacity(tcfg, n) == j_capacity(jcfg, n)
    assert tmoe._capacity(_cfgs(num_experts=64, experts_per_token=6)[1],
                          32768) == 3840


# ---------------------------------------------------------------------------
# phi3.5-moe smoke against the reference
# ---------------------------------------------------------------------------

def test_phi35_configs_are_the_reference_configs():
    assert_configs_equal(ARCH)


def test_phi35_init_params_have_the_reference_tree():
    got = assert_init_tree_matches(ARCH, 13)
    assert got["layers"]["ffn"]["router"].dtype == torch.float32
    assert tuple(got["layers"]["ffn"]["w_gate"].shape) == (2, 4, 128, 128)


def test_phi35_param_counts_are_the_reference_counts():
    """The reference counts as experts only leaves under a key named
    "experts", and its tree has none: active == total, and the port
    returns what the reference returns."""
    n = assert_param_counts(ARCH)
    assert n == 41_874_100_224


@pytest.mark.parametrize("kw", [dict(), dict(moe_dispatch="einsum"),
                                dict(moe_dispatch="einsum", moe_chunk=32)])
def test_phi35_forward_and_loss_match_reference(kw):
    jcfg, tcfg, jp, tp = smoke_model(ARCH, **kw)
    assert_forward_and_loss(jcfg, tcfg, jp, tp, aux_nonzero=True)


def test_phi35_init_cache_matches_reference():
    assert_init_cache(ARCH, 24, ["k", "v"])


def test_phi35_decode_steps_match_reference():
    """Dropless decode, 12 steps, and the last step against the
    forward's last position (capacity 100, so the forward drops
    nothing either)."""
    jcfg, tcfg, jp, tp = smoke_model(ARCH, capacity_factor=100.0)
    logits, _, tok = assert_decode_steps(jcfg, tcfg, jp, tp, 12)
    from repro_torch.models import lm as tlm
    full, _ = tlm.forward(tcfg, tp, tt(tok).long(), last_only=True)
    close_of_max(logits.numpy(), full[:, 0].numpy(), 1e-5, "vs forward")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_phi35_trainer_rounds_match_reference(use_kernel):
    assert_trainer_rounds(ARCH, use_kernel)


def test_phi35_einsum_trainer_round_matches_reference():
    assert_trainer_rounds(ARCH, True, moe_dispatch="einsum", moe_chunk=64)


"""The sharded train step against the reference on the CPU.

* ``launch.specs.train_spec``'s step on a one-rank ``gloo`` host mesh
  (DTensors: the node loss under ``remat=True``, ``grad_specs`` pinned,
  the fused path through ``local_map``) against the reference's
  ``make_train_step(dcfg, loss, grad_specs=p_specs)`` with ``spmd_axes``
  on its 1x1 host mesh (axes typed ``Auto``), jitted, for the dense, SSM
  and MoE smoke configs
  and variants ``dasha`` and ``mvr``, 2 rounds each: both start from the
  same parameters (the reference's, through the port's converter) and
  zeros, on the same batches, and the port takes the masks the
  reference's ``tree_masks`` draws from its round key.  Every state leaf
  within 1e-5 of its own largest magnitude, or within twice the largest
  error that a control run gives in its field, whichever is larger;
  ``g_norm_sq`` within 1e-5 of itself, ``payload_coords`` exact.  The
  control is the port's same rounds from parameters one ulp up
  (``nextafter``): how far float32 rounding alone carries them.  XLA's
  and torch's CPU kernels round differently by ~1e-6 of a gradient
  (DASHA: at most 1.23e-5 of a leaf's own magnitude, mamba2's
  ``conv_b``), and MVR's h-update, which cancels most of its terms,
  carries that to 1.28e-5 of a field's largest magnitude (mamba2's
  ``g/embed``) and 3.64e-5 of a small leaf's own (mamba2's ``A_log``),
  as it carries the control's one ulp.  The reference's loss runs with
  ``remat=False``: the same floats (the port's ``remat`` is held to that
  below), compiled in half the time.
* ``lm.loss_fn(remat=True)``'s gradients equal ``remat=False``'s bit for
  bit, in float32 and bf16, for every family's smoke config.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.mesh import enter_mesh as j_enter_mesh
from repro.models import lm as jlm
from repro.models.sharding import param_specs as j_param_specs
from repro.optim import distributed as jdist
from repro_torch.configs import get_smoke_config
from repro_torch.core import tree
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.models import init_params, lm
from repro_torch.models import sharding as sh
from repro_torch.optim import distributed as tdist

from torch_models_common import _reference_masks, f32_smoke, j_init_jit, port

ARCHS = ("starcoder2-3b", "mamba2-780m", "phi3.5-moe-42b-a6.6b")
FAMILIES = ("starcoder2-3b", "mamba2-780m", "phi3.5-moe-42b-a6.6b",
            "deepseek-v2-lite-16b", "zamba2-1.2b", "llama-3.2-vision-11b",
            "whisper-tiny", "gemma3-12b")
ROUNDS, BATCH, SEQ = 2, 2, 32
TOL, CONTROL_K = 1e-5, 2.0
KW = dict(gamma=0.05, compression=0.25, b=0.1)


def _batches(vocab):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(ROUNDS):
        tok = rng.integers(1, vocab, (1, BATCH, SEQ)).astype(np.int32)
        out.append({"tokens": tok, "labels": np.roll(tok, -1, -1)})
    return out


def _j_host_mesh():
    """``repro.launch.mesh.make_host_mesh``'s 1x1 ("data", "model") mesh
    with its axes typed ``Auto``: the reference's sharding constraints
    pin layouts as on the jax it was written for (0.4.x meshes have no
    axis types), where this jax's default ``Explicit`` axes would make
    each one an assertion about the operand's type."""
    auto = (jax.sharding.AxisType.Auto,) * 2
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=auto)


def _reference(jcfg, variant, jparams, batches):
    """The reference's rounds; returns (final state, metrics, masks)."""
    mesh = _j_host_mesh()
    jdc = jdist.DashaTrainConfig(variant=variant, n_nodes=1,
                                 spmd_axes=("data",), **KW)
    with j_enter_mesh(mesh):
        p_specs = j_param_specs(jcfg, jparams, mesh)
        step = jax.jit(jdist.make_train_step(
            jdc, lambda p, b: jlm.loss_fn(jcfg, p, b, remat=False)[0],
            grad_specs=p_specs))
        state = jdist.dasha_train_init(jparams, jdc, jax.random.PRNGKey(1))
        metrics, masks = [], []
        for b in batches:
            masks.append(_reference_masks(state.key, state.h_local, jdc))
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append(m)
    return state, metrics, masks


@pytest.mark.parametrize("variant", ["dasha", "mvr"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_spec_step_on_a_host_mesh_equals_the_reference(arch, variant):
    jcfg, tcfg = f32_smoke(arch)
    jparams = j_init_jit(jcfg, jax.random.PRNGKey(0))
    batches = _batches(tcfg.vocab_size)
    jfinal, jmetrics, masks = _reference(jcfg, variant, jparams, batches)
    got, gns, tmetrics = _port_rounds(tcfg, variant, port(jparams),
                                      batches, masks)
    ctrl, _, _ = _port_rounds(tcfg, variant,
                              tree.map_leaves(_ulp_up, port(jparams)),
                              batches, masks)
    for f in got:
        want = {p: w.to(torch.float32).numpy()
                for p, w in tree.items(port(getattr(jfinal, f)))}
        assert sorted(want) == sorted(got[f])
        reach = max(float(np.abs(ctrl[f][p] - got[f][p]).max())
                    for p in got[f])
        for p, w in want.items():
            err = float(np.abs(got[f][p] - w).max())
            bound = max(TOL * float(np.abs(w).max()), CONTROL_K * reach)
            assert err <= bound, (f, p, err, bound)
    for g, jm, tm in zip(gns, jmetrics, tmetrics):
        want = float(jm["g_norm_sq"])
        assert abs(g - want) <= TOL * abs(want)
        assert float(tm["payload_coords"]) == float(jm["payload_coords"])


def _ulp_up(x):
    return torch.nextafter(x, torch.full_like(x, float("inf"))) \
        if x.is_floating_point() else x


def _port_rounds(tcfg, variant, params, batches, masks):
    """The port's ``train_spec`` rounds on a one-rank ``gloo`` host mesh
    from ``params``; returns (final state fields as numpy, g_norm_sq a
    round, metrics)."""
    tdc = tdist.DashaTrainConfig(variant=variant, use_kernel=True, **KW)
    from torch.distributed.tensor.experimental import implicit_replication
    with tmesh.enter_mesh(tmesh.make_host_mesh("cpu")) as mesh:
        spec = tspecs.train_spec(tcfg, mesh, seq=SEQ, global_batch=BATCH,
                                 dasha=tdc)
        dcfg = tdist.DashaTrainConfig(**spec.static["dasha"])
        assert dcfg.spmd_axes == ("data",) and dcfg.n_nodes == 1
        state = tdist.dasha_train_init(params, dcfg, 0, mesh=mesh,
                                       specs=spec.in_shardings[0])
        tmetrics = []
        for b, draws in zip(batches, masks):
            db = sh.distribute_tree(
                {k: torch.as_tensor(v) for k, v in b.items()},
                spec.in_shardings[1], mesh)
            with implicit_replication():
                state, m = spec.fn(state, db, draws=draws)
            tmetrics.append(m)
        got = {f: {p: x.full_tensor().numpy() for p, x in
                   tree.items(getattr(state, f))}
               for f in ("params", "g", "h_local", "g_local")}
        gns = [float(m["g_norm_sq"].full_tensor()) for m in tmetrics]
    return got, gns, tmetrics


def _grads(cfg, params, batch, remat):
    paths, leaves = zip(*tree.items(params))
    ps = [x.detach().requires_grad_(True) for x in leaves]
    loss = lm.loss_fn(cfg, tree.from_items(zip(paths, ps)), batch,
                      remat=remat)[0]
    return [loss] + list(torch.autograd.grad(loss, ps))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_gradients_equal_the_kept_activations_bit_for_bit(arch, dtype):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    params = init_params(cfg, 0, device="cpu")
    g = torch.Generator().manual_seed(3)
    tok = torch.randint(1, cfg.vocab_size, (1, 16), generator=g,
                        dtype=torch.int32)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, -1)}
    if cfg.arch_type == "vlm":
        batch["image_embeds"] = torch.randn(
            (1, cfg.num_image_tokens, cfg.d_model), generator=g).to(
                cfg.torch_dtype)
    if cfg.arch_type == "audio":
        batch["frames"] = torch.randn(
            (1, cfg.num_audio_frames, cfg.d_model), generator=g).to(
                cfg.torch_dtype)
    kept, remat = _grads(cfg, params, batch, False), \
        _grads(cfg, params, batch, True)
    assert all(torch.equal(a, b) for a, b in zip(kept, remat))


@pytest.mark.parametrize("arch", ["starcoder2-3b", "deepseek-v2-lite-16b"])
def test_remat_streaming_rows_equal_the_kept_activations_bit_for_bit(arch):
    """At a streaming length (``attention.QBLOCK_THRESHOLD``), where
    ``remat=True`` also checkpoints each query block's row of key blocks
    (GQA and MLA): the same loss and gradients, bit for bit.  On one CPU
    thread: the embedding's backward sums 2,048 rows in an order that
    varies run to run on several threads, remat or not."""
    from repro_torch.models import attention
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    g = torch.Generator().manual_seed(4)
    tok = torch.randint(1, cfg.vocab_size,
                        (1, attention.QBLOCK_THRESHOLD), generator=g,
                        dtype=torch.int32)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, -1)}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        kept, remat = _grads(cfg, params, batch, False), \
            _grads(cfg, params, batch, True)
    finally:
        torch.set_num_threads(threads)
    assert all(torch.equal(a, b) for a, b in zip(kept, remat))


def test_streaming_rows_remat_only_under_lm_remat():
    """One switch: the attention checkpoints its streaming rows only
    inside :func:`attention.remat_rows`, which ``lm``'s ``remat=True``
    sets in each checkpointed body, and only where autograd records."""
    from repro_torch.models import attention
    q = torch.zeros(1, requires_grad=True)
    assert not attention._records(q)
    with attention.remat_rows():
        assert attention._records(q)
        assert not attention._records(q.detach())
        with torch.no_grad():
            assert not attention._records(q)
    assert not attention._records(q)

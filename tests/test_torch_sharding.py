"""The port's sharding policy against the reference's (CPU).

Spec parity is exact, leaf by leaf by path: ``param_specs`` for every arch
on the 16x16, 2x16x16, 2x2 and 1x1 meshes with ``fsdp`` and
``hd_fallback`` both ways, ``cache_specs`` at decode_32k (B = 128) and,
where supported, long_500k (B = 1), ``batch_specs`` and
``sharding_report``'s string.  The reference runs on its
``abstract_mesh`` and ``jax.eval_shape`` trees, the port on its
``abstract_mesh`` and ``meta`` trees.  The reference's own checks
(``tests/test_sharding_specs.py``) are mirrored on the port's specs, and
on the fake production meshes every leaf's local shard (``to_local()`` of
``distribute_tree``) is the division the reference's spec implies, summed
into the argument bytes a device holds.  A planted fault, an expert axis
pinned on a dim that is not the experts', fails the parity check.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import all_arch_ids
from repro.configs import get_config as j_config
from repro.launch.mesh import abstract_mesh as j_mesh
from repro.launch.specs import shape_supported as j_supported
from repro.models import init_params as j_init
from repro.models import lm as jlm
from repro.models import sharding as js
from repro_torch.configs import get_config as t_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.specs import decode_cache
from repro_torch.models import init_params as t_init
from repro_torch.models import sharding as ts

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
ARCHS = all_arch_ids()


def _key(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def ref_specs(tree) -> dict:
    """{path: spec tuple} of a reference spec tree."""
    return {"/".join(_key(k) for k in path): tuple(s) for path, s in
            jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))}


def port_specs(tree) -> dict:
    return {"/".join(str(k) for k in path): tuple(s) for path, s in
            ts.leaves_with_path(tree, is_leaf=ts.is_spec)}


_REF_PARAMS, _PORT_PARAMS = {}, {}


def ref_params(arch):
    if arch not in _REF_PARAMS:
        _REF_PARAMS[arch] = jax.eval_shape(
            lambda: j_init(j_config(arch), jax.random.PRNGKey(0)))
    return _REF_PARAMS[arch]


def port_params(arch):
    if arch not in _PORT_PARAMS:
        _PORT_PARAMS[arch] = t_init(t_config(arch), 0, device="meta")
    return _PORT_PARAMS[arch]


def ref_cache(arch, batch, seq):
    cfg = j_config(arch)

    def mk():
        import jax.numpy as jnp
        image_kv = enc_kv = None
        G, hd = cfg.num_kv_heads, cfg.head_dim
        if cfg.arch_type == "vlm":
            z = jnp.zeros((cfg.num_layers // cfg.cross_attn_every, batch,
                           cfg.num_image_tokens, G, hd), cfg.jax_dtype)
            image_kv = {"k": z, "v": z}
        if cfg.arch_type == "audio":
            z = jnp.zeros((cfg.num_layers, batch, cfg.num_audio_frames, G,
                           hd), cfg.jax_dtype)
            enc_kv = {"k": z, "v": z}
        return jlm.init_cache(cfg, batch, seq, image_kv=image_kv,
                              enc_kv=enc_kv)
    return jax.eval_shape(mk)


def param_parity(arch, mesh_name, rule_patch=None):
    shape, axes = MESHES[mesh_name]
    jm, tm = j_mesh(shape, axes), tmesh.abstract_mesh(shape, axes)
    bad = []
    for fsdp in (False, True):
        for hd in (True, False):
            want = ref_specs(js.param_specs(j_config(arch), ref_params(arch),
                                            jm, fsdp=fsdp, hd_fallback=hd))
            got = port_specs(ts.param_specs(t_config(arch),
                                            port_params(arch), tm,
                                            fsdp=fsdp, hd_fallback=hd))
            if got != want:
                bad.append((fsdp, hd, {
                    k: (want[k], got.get(k)) for k in want
                    if want[k] != got.get(k)}))
    return bad


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh_name):
    assert param_parity(arch, mesh_name) == []


def test_planted_expert_axis_on_the_wrong_dim_fails_parity(monkeypatch):
    """Pin the experts' weights on their second dim (d) instead of the
    expert dim: the parity check must see it."""
    real = ts.param_specs

    def planted(cfg, params, mesh, fsdp=False, hd_fallback=True):
        specs = real(cfg, params, mesh, fsdp, hd_fallback)

        def move(path, spec):
            if "ffn" in path and path[-1] in ("w_gate", "w_in", "w_out") \
                    and spec and spec[-3] == "model":
                return ts.P(*(spec[:-3] + (None, "model", None)))
            return spec
        return ts.map_with_path(move, specs, is_leaf=ts.is_spec)

    monkeypatch.setattr(ts, "param_specs", planted)
    for arch in ("phi3.5-moe-42b-a6.6b", "deepseek-v2-lite-16b"):
        assert param_parity(arch, "16x16") != []


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_reference(arch):
    for shape, (batch, seq) in (("decode_32k", (128, 32768)),
                                ("long_500k", (1, 524288))):
        if not j_supported(j_config(arch), shape)[0]:
            continue
        for mesh_name in ("16x16", "2x16x16"):
            sh, axes = MESHES[mesh_name]
            want = ref_specs(js.cache_specs(
                j_config(arch), ref_cache(arch, batch, seq),
                j_mesh(sh, axes), batch))
            got = port_specs(ts.cache_specs(
                t_config(arch), decode_cache(t_config(arch), batch, seq),
                tmesh.abstract_mesh(sh, axes), batch))
            assert got == want, (shape, mesh_name)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_specs_and_report_equal_the_reference(mesh_name):
    sh, axes = MESHES[mesh_name]
    jm, tm = j_mesh(sh, axes), tmesh.abstract_mesh(sh, axes)
    for arch in ARCHS:
        for batch in (1, 32, 128, 256):
            assert port_specs(ts.batch_specs(t_config(arch), tm, batch)) == \
                ref_specs(js.batch_specs(j_config(arch), jm, batch))
        assert ts.sharding_report(t_config(arch), port_params(arch), tm) == \
            js.sharding_report(j_config(arch), ref_params(arch), jm)


# ---------------------------------------------------------------------------
# the reference's own checks, on the port's specs
# ---------------------------------------------------------------------------

def _axis_size(sizes, axes):
    if axes is None:
        return 1
    if isinstance(axes, str):
        return sizes[axes]
    return int(np.prod([sizes[a] for a in axes]))


def _check_divisible(tree, specs, mesh):
    sizes = tmesh.mesh_axes(mesh)
    leaves = ts.leaves_with_path(tree)
    spec_leaves = ts.leaves_with_path(specs, is_leaf=ts.is_spec)
    assert len(leaves) == len(spec_leaves)
    for (path, leaf), (_, spec) in zip(leaves, spec_leaves):
        assert len(spec) <= leaf.ndim, (path, spec, leaf.shape)
        for dim, axes in zip(leaf.shape, tuple(spec)):
            assert dim % _axis_size(sizes, axes) == 0, (path, leaf.shape,
                                                        spec)


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
def test_port_specs_divide_their_dims(mesh_name):
    mesh = tmesh.abstract_mesh(*MESHES[mesh_name])
    for arch in ARCHS:
        cfg = t_config(arch)
        for fsdp in (False, True):
            _check_divisible(port_params(arch),
                             ts.param_specs(cfg, port_params(arch), mesh,
                                            fsdp=fsdp), mesh)
        for batch, seq in ((128, 32768), (1, 524288)):
            cache = decode_cache(cfg, batch, seq)
            _check_divisible(cache, ts.cache_specs(cfg, cache, mesh, batch),
                             mesh)


def test_big_matrices_not_replicated():
    """On the 16x16 mesh every >= 32 MB (bf16) parameter carries at least
    one sharded dim."""
    mesh = tmesh.abstract_mesh(*MESHES["16x16"])
    for arch in ARCHS:
        params = port_params(arch)
        specs = ts.param_specs(t_config(arch), params, mesh)
        for (path, leaf), (_, spec) in zip(
                ts.leaves_with_path(params),
                ts.leaves_with_path(specs, is_leaf=ts.is_spec)):
            if leaf.numel() * 2 >= 32e6:
                assert any(a is not None for a in spec), (arch, path)


def test_dp_axes_and_sizes():
    single = tmesh.abstract_mesh(*MESHES["16x16"])
    multi = tmesh.abstract_mesh(*MESHES["2x16x16"])
    assert ts.dp_axes(single) == ("data",)
    assert ts.dp_axes(multi) == ("pod", "data")
    assert (ts.dp_size(single), ts.dp_size(multi)) == (16, 32)
    assert (ts.tp_size(single), ts.tp_size(multi)) == (16, 16)


def test_spec_entries_normalise_as_the_reference_does():
    assert tuple(ts.P(("data",), None)) == tuple(JP(("data",), None))
    assert tuple(ts.P((), None)) == tuple(JP((), None))
    assert tuple(ts.P(("pod", "data"), "model")) == \
        tuple(JP(("pod", "data"), "model"))


# ---------------------------------------------------------------------------
# placements and local shards on the fake production meshes
# ---------------------------------------------------------------------------

@pytest.fixture(params=["16x16", "2x16x16"])
def production_mesh(request):
    mesh = tmesh.make_production_mesh(
        multi_pod=request.param == "2x16x16", device="cpu")
    with tmesh.enter_mesh(mesh):
        yield request.param, mesh
    assert not torch.distributed.is_initialized()


def test_to_placements_maps_each_axis_to_its_dim(production_mesh):
    from torch.distributed.tensor import Replicate, Shard
    name, mesh = production_mesh
    if name == "16x16":
        assert ts.to_placements(("data", None, "model"), mesh) == \
            [Shard(0), Shard(2)]
        assert ts.to_placements((None, None), mesh) == [Replicate()] * 2
    else:
        assert ts.to_placements((("pod", "data"), "model"), mesh) == \
            [Shard(0), Shard(0), Shard(1)]
        with pytest.raises(ValueError):
            ts.to_placements((("data", "pod"), None), mesh)
    with pytest.raises(ValueError):
        ts.to_placements(("model", "model"), mesh)


def test_local_shards_are_the_reference_specs_division(production_mesh):
    """Every leaf's local shard is its shape divided by the reference's
    spec, and the summed argument bytes a device holds are that
    division's sum."""
    name, mesh = production_mesh
    sh, axes = MESHES[name]
    sizes = dict(zip(axes, sh))
    for arch in ARCHS:
        want_specs = ref_specs(js.param_specs(j_config(arch),
                                              ref_params(arch),
                                              j_mesh(sh, axes)))
        params = port_params(arch)
        dist_tree = ts.distribute_tree(
            params, ts.param_specs(t_config(arch), params, mesh), mesh)
        got_bytes = want_bytes = 0
        for (path, leaf), (_, d) in zip(ts.leaves_with_path(params),
                                        ts.leaves_with_path(dist_tree)):
            spec = want_specs["/".join(path)]
            want = tuple(n // _axis_size(sizes, a)
                         for n, a in zip(leaf.shape, spec))
            local = d.to_local()
            assert tuple(local.shape) == want, (arch, path)
            got_bytes += local.numel() * local.element_size()
            want_bytes += int(np.prod(want)) * leaf.element_size()
        assert got_bytes == want_bytes


def test_expert_constraints_pin_the_expert_dim(production_mesh):
    from torch.distributed.tensor import Replicate, Shard
    _, mesh = production_mesh
    t = ts.constrain(torch.empty((64, 8, 4), device="meta"), (None,) * 3,
                     mesh)
    assert ts.constrain_expert_major(t) is t        # no axis set
    with ts.expert_sharding("model"):
        pinned = ts.constrain_expert_major(t)
        assert pinned.placements[-1] == Shard(0)
        assert all(p == Replicate() for p in pinned.placements[:-1])
        assert all(p == Replicate() for p in
                   ts.constrain_token_major(pinned).placements)
    plain = torch.zeros(3)
    with ts.expert_sharding("model"):
        assert ts.constrain_expert_major(plain) is plain

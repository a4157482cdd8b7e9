"""The port's launch layer against the reference's (CPU): the abstract
specs, the analytic model, the roofline and the collective counter.

* ``shape_supported`` gives the reference's skip set for every arch x
  shape;
* the abstract arguments (``meta`` tensors) equal the reference's
  ``ShapeDtypeStruct`` leaves in shape and dtype, path by path (the
  trainer's ``key`` is the port's integer ``seed``, the decode position a
  Python int), and the in / out spec trees are equal, the train state's
  included, with sgd and adam, ``fsdp`` both ways and ``seq_shard``;
* ``analytic.*`` gives the reference's floats on the bytes the port's
  trees hold, which equal the reference's;
* ``Roofline`` with the reference's three constants gives its row;
* on a fake 2x2 mesh a column-parallel then a row-parallel matmul counts
  one all-reduce of the (local) B x S x d output's bytes.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import all_arch_ids
from repro.configs import get_config as j_config
from repro.launch import analytic as j_analytic
from repro.launch import roofline as j_roofline
from repro.launch import specs as j_specs
from repro.launch.mesh import abstract_mesh as j_mesh
from repro.optim.distributed import DashaTrainConfig as JDasha
from repro_torch.configs import get_config as t_config
from repro_torch.launch import analytic as t_analytic
from repro_torch.launch import collectives as coll
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import roofline as t_roofline
from repro_torch.launch import specs as t_specs
from repro_torch.models import sharding as ts
from repro_torch.optim.distributed import DashaTrainConfig as TDasha

from test_torch_sharding import port_specs
from test_torch_sharding import ref_specs as _ref_specs

ARCHS = all_arch_ids()
SHAPES = list(t_specs.SHAPES)
MESH = ((16, 16), ("data", "model"))


def _key(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def ref_specs(tree) -> dict:
    """The reference's spec leaves by path, its ``key`` named ``seed``."""
    return {k.replace("/key", "/seed"): v
            for k, v in _ref_specs(tree).items()}


def _ref_args(tree) -> dict:
    return {"/".join(_key(k) for k in path).replace("/key", "/seed"):
            (tuple(x.shape), np.dtype(x.dtype).name)
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


def _port_args(tree) -> dict:
    out = {}
    for path, x in ts.leaves_with_path(tree):
        key = "/".join(str(k) for k in path)
        if isinstance(x, torch.Tensor):
            assert x.device.type == "meta", key
            out[key] = (tuple(x.shape), str(x.dtype).replace("torch.", ""))
        else:
            out[key] = x
    return out


def _specs_pair(arch, shape, **dasha):
    jm, tm = j_mesh(*MESH), tmesh.abstract_mesh(*MESH)
    kw = {}
    if t_specs.SHAPES[shape]["kind"] == "train":
        kw = dict(j=dict(dasha=JDasha(gamma=0.01, **dasha)),
                  t=dict(dasha=TDasha(gamma=0.01, **dasha)))
    return (j_specs.input_specs(j_config(arch), shape, jm,
                                **kw.get("j", {})),
            t_specs.input_specs(t_config(arch), shape, tm,
                                **kw.get("t", {})))


def test_skip_set_equals_the_reference():
    for arch in ARCHS:
        for shape in SHAPES:
            assert t_specs.shape_supported(t_config(arch), shape) == \
                j_specs.shape_supported(j_config(arch), shape)
    with pytest.raises(ValueError):
        t_specs.input_specs(t_config("qwen1.5-110b"), "long_500k",
                            tmesh.abstract_mesh(*MESH))


SUPPORTED = [(a, s) for a in ARCHS for s in SHAPES
             if j_specs.shape_supported(j_config(a), s)[0]]


@pytest.mark.parametrize("arch,shape", SUPPORTED)
def test_args_and_spec_trees_equal_the_reference(arch, shape):
    jspec, tspec = _specs_pair(arch, shape)
    want, got = _ref_args(jspec.args), _port_args(tspec.args)
    kind = t_specs.SHAPES[shape]["kind"]
    if kind == "train":
        assert want.pop("0/seed") == ((2,), "uint32")     # a JAX key
        assert got.pop("0/seed") == 0
        assert want.pop("0/step") == ((), "int32")        # host ints here
        assert got.pop("0/step") == 0
    if kind == "decode":
        assert want.pop("3") == ((), "int32")
        assert got.pop("3") == t_specs.SHAPES[shape]["seq"] - 1
    assert got == want
    assert port_specs(tspec.in_shardings) == ref_specs(jspec.in_shardings)
    assert port_specs(tspec.out_shardings) == ref_specs(jspec.out_shardings)
    assert {k: v for k, v in tspec.static.items() if k != "dasha"} == \
        {k: v for k, v in jspec.static.items() if k != "dasha"}


@pytest.mark.parametrize("server_opt", ["sgd", "adam"])
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", ["starcoder2-3b", "deepseek-v2-lite-16b",
                                  "zamba2-1.2b"])
def test_train_state_specs_equal_the_reference(arch, fsdp, server_opt):
    jspec, tspec = _specs_pair(arch, "train_4k", fsdp=fsdp, seq_shard=True,
                               server_opt=server_opt)
    assert port_specs(tspec.in_shardings) == ref_specs(jspec.in_shardings)
    assert port_specs(tspec.out_shardings) == ref_specs(jspec.out_shardings)
    assert _port_args(tspec.args).keys() == _ref_args(jspec.args).keys()
    assert tspec.static["dasha"]["spmd_axes"] == ("data",)


def _tree_bytes_ref(tree):
    return float(sum(np.prod(x.shape) * np.dtype(x.dtype).itemsize
                     for x in jax.tree_util.tree_leaves(tree)))


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_equals_the_reference(arch):
    from repro_torch.launch.dryrun import tree_bytes
    jcfg, tcfg = j_config(arch), t_config(arch)
    assert tcfg.active_param_count() == jcfg.active_param_count()
    n_active = tcfg.active_param_count()
    for shape in SHAPES:
        if not t_specs.shape_supported(tcfg, shape)[0]:
            continue
        info = t_specs.SHAPES[shape]
        kw = dict(seq=info["seq"], global_batch=info["global_batch"],
                  n_active=n_active)
        jspec, tspec = _specs_pair(arch, shape)
        pb = tree_bytes(tspec.args[0] if info["kind"] != "train"
                        else tspec.args[0].params)
        assert pb == _tree_bytes_ref(jspec.args[0] if info["kind"] != "train"
                                     else jspec.args[0].params)
        if info["kind"] == "train":
            st = tspec.args[0]
            sb = tree_bytes(st.h_local) + tree_bytes(st.g_local) + \
                tree_bytes(st.g)
            js = jspec.args[0]
            assert sb == _tree_bytes_ref(js.h_local) + \
                _tree_bytes_ref(js.g_local) + _tree_bytes_ref(js.g)
            args = dict(kw, params_bytes=pb, state_bytes=sb,
                        state_itemsize=4)
            assert t_analytic.train_analytics(tcfg, **args) == \
                j_analytic.train_analytics(jcfg, **args)
        elif info["kind"] == "prefill":
            args = dict(kw, params_bytes=pb)
            assert t_analytic.prefill_analytics(tcfg, **args) == \
                j_analytic.prefill_analytics(jcfg, **args)
        else:
            cb = tree_bytes(tspec.args[1])
            assert cb == _tree_bytes_ref(jspec.args[1])
            args = dict(kw, params_bytes=pb, cache_bytes=cb)
            assert t_analytic.decode_analytics(tcfg, **args) == \
                j_analytic.decode_analytics(jcfg, **args)
        for S in (1, 4096, 32768):
            for T in (4096, 524288):
                assert t_analytic.attn_flops_fwd(tcfg, 8, S, T) == \
                    j_analytic.attn_flops_fwd(jcfg, 8, S, T)
            assert t_analytic.ssd_flops_fwd(tcfg, 8, S) == \
                j_analytic.ssd_flops_fwd(jcfg, 8, S)


def test_roofline_with_the_reference_constants_gives_its_row():
    chip = t_roofline.Chip(peak_flops=j_roofline.PEAK_FLOPS,
                           hbm_bw=j_roofline.HBM_BW,
                           link_bw=j_roofline.LINK_BW)
    det = {"all-gather": 3e9, "all-gather_count": 7}
    for flops, hbm, cb, chips, mf in ((1e15, 2e12, 3e9, 256, 6e14),
                                      (2e9, 8e12, 0.0, 512, None),
                                      (5e12, 1e9, 9e12, 256, 5e12)):
        want = j_roofline.Roofline(flops, hbm, cb, chips, det, mf).row()
        got = t_roofline.Roofline(flops, hbm, cb, chips, det, mf,
                                  chip=chip).row()
        assert got == want
    h = t_roofline.H100_SXM5
    assert (h.peak_flops, h.hbm_bw, h.link_bw) == (989e12, 3.35e12, 450e9)
    assert "700 W" in h.name
    assert t_roofline.Roofline(1.0, 1.0, 0.0, 1, {}).chip is h


def test_collective_kinds_are_the_reference_five():
    assert coll.KINDS == j_roofline._COLLECTIVES
    ops = torch.ops._c10d_functional
    assert coll.collective_kind(ops.all_reduce.default) == "all-reduce"
    assert coll.collective_kind(
        ops.all_gather_into_tensor.default) == "all-gather"
    assert coll.collective_kind(
        ops.reduce_scatter_tensor.default) == "reduce-scatter"
    assert coll.collective_kind(ops.all_to_all_single.default) == \
        "all-to-all"
    assert coll.collective_kind(ops.wait_tensor.default) is None
    assert coll.collective_kind(torch.ops.aten.mm.default) is None


@pytest.fixture
def fake_2x2():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    torch.distributed.init_process_group("fake", store=FakeStore(), rank=0,
                                         world_size=4)
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    with tmesh.enter_mesh(mesh):
        yield mesh
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_column_then_row_parallel_counts_one_all_reduce(fake_2x2, dtype):
    mesh = fake_2x2
    B, S, d, f = 4, 8, 16, 32
    x = ts.distribute_tree(torch.empty((B, S, d), dtype=dtype,
                                       device="meta"),
                           ts.P("data", None, None), mesh)
    w1 = ts.distribute_tree(torch.empty((d, f), dtype=dtype, device="meta"),
                            ts.P(None, "model"), mesh)
    w2 = ts.distribute_tree(torch.empty((f, d), dtype=dtype, device="meta"),
                            ts.P("model", None), mesh)
    with coll.CallTrace() as tr:
        tr.track_args([x, w1, w2])
        y = ((x @ w1) @ w2).redistribute(mesh, ts.to_placements(
            ("data", None, None), mesh))
    det = tr.collectives()
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert det["all-reduce_count"] == 1
    assert det["all-reduce"] == (B // 2) * S * d * itemsize
    assert all(det[k] == 0 for k in coll.KINDS if k != "all-reduce")
    assert tr.arg_bytes == ((B // 2) * S * d + d * f) * itemsize
    mem = t_roofline.memory_per_device(tr, y)
    assert mem["argument_gb"] * 1e9 == tr.arg_bytes
    assert mem["output_gb"] * 1e9 == (B // 2) * S * d * itemsize
    assert mem["alias_gb"] == 0
    assert mem["peak_gb"] == pytest.approx(
        mem["argument_gb"] + mem["temp_gb"] + mem["output_gb"])
    assert y.to_local().shape == (B // 2, S, d)

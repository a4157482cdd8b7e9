"""The sharded DASHA trainer on a real 2x2 ``gloo`` mesh (4 CPU processes),
run by ``tests/test_torch_mesh_train.py`` (the families) and
``tests/test_torch_mesh_train_knobs.py`` (the mesh knobs):

    python tests/torch_mesh_train_worker.py OUT.json families|knobs

Mesh (data 2, model 2), so n = 2 nodes, one a data rank.  Each case builds
``launch.specs.train_spec``'s step for a smoke config in float32 and runs
it for 2 rounds twice: on plain tensors (rank 0) and on the mesh's
DTensors, every rank its own node's gradient on its shard of the batch,
its shards' masks and the fused path (whose plain versions run on the
CPU) on its local shards.  Both runs take the same injected masks (full
tensors, cut to the shards on the mesh; PermK draws its ownership map,
the same on both).  Rank 0 writes, per case, each state field's and
metric's largest error beside the plain run's largest magnitude, the
payloads, and every collective issued on the data axis (kind, shape,
dtype) beside the shapes the parameters and ``g`` hold there.

Planted faults: a rank that computes the other node's gradient; masks
replicated over the data axis while ``h`` is sharded (``local_map``
refuses them).  The un-injected draws: each rank's mask density, and
whether the data ranks drew the same mask.  Everything is made from
seeds, so the ranks hold the same full tensors.
"""
import dataclasses
import json
import math
import os
import socket
import sys
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

FAMILIES = {"dense": "starcoder2-3b", "ssm": "mamba2-780m",
            "moe": "phi3.5-moe-42b-a6.6b", "mla": "deepseek-v2-lite-16b",
            "hybrid": "zamba2-1.2b", "vlm": "llama-3.2-vision-11b",
            "audio": "whisper-tiny"}
SEQ, PER_NODE, ROUNDS, P_KEEP = 32, 1, 2, 0.5
FIELDS = ("params", "g", "h_local", "g_local")
#: two groups, each one subprocess of its own test file: the families
#: (and DASHA and PermK), then the mesh knobs with the planted faults and
#: the un-injected draws
CASES = {
    "families": [(f"{fam}-mvr", arch, {}) for fam, arch in FAMILIES.items()]
    + [("dense-dasha", "starcoder2-3b", {"variant": "dasha"}),
       ("dense-permk", "starcoder2-3b", {"mode": "permk"}),
       # 3 heads over a model axis of 2: the attention's batch rows split
       # over "model" (two rows a node)
       ("dense-oddheads", "starcoder2-3b", {"heads": (3, 1),
                                            "per_node": 2})],
    "knobs": [(f"{fam}-{tag}", FAMILIES[fam], kw)
              for fam in ("dense", "ssm")
              for tag, kw in (("fsdp", {"fsdp": True}),
                              ("seq", {"seq_shard": True}),
                              ("fsdp-seq", {"fsdp": True,
                                            "seq_shard": True}))]
    + [("dense-fsdp-adam", "starcoder2-3b", {"fsdp": True,
                                             "server_opt": "adam"})]}
#: a state leaf's error: within TOL of its own largest magnitude, or
#: within CONTROL_K times the largest error the one-ulp control run gives
#: in its field (tests/test_torch_mesh_train.py's docstring says why)
TOL, CONTROL_K = 1e-5, 2.0


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _setup(arch, mesh, **kw):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import specs as S
    from repro_torch.models import init_params
    from repro_torch.optim.distributed import DashaTrainConfig
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    if "heads" in kw:
        cfg = dataclasses.replace(cfg, num_heads=kw["heads"][0],
                                  num_kv_heads=kw["heads"][1])
    per_node = kw.get("per_node", PER_NODE)
    dc = DashaTrainConfig(gamma=0.01, compression=P_KEEP,
                          variant=kw.get("variant", "mvr"),
                          mode=kw.get("mode", "independent"),
                          use_kernel=True, fsdp=kw.get("fsdp", False),
                          seq_shard=kw.get("seq_shard", False),
                          server_opt=kw.get("server_opt", "sgd"))
    n = 2
    spec = S.train_spec(cfg, mesh, seq=SEQ, global_batch=n * per_node,
                        dasha=dc)
    params = init_params(cfg, 0, device="cpu")
    lead = (n, per_node)
    tokens = torch.randint(1, cfg.vocab_size, lead + (SEQ,),
                           generator=_gen(1), dtype=torch.int64)
    batch = {"tokens": tokens.to(torch.int32),
             "labels": torch.roll(tokens, -1, -1).to(torch.int32)}
    if cfg.arch_type == "vlm":
        batch["image_embeds"] = 0.5 * torch.randn(
            lead + (cfg.num_image_tokens, cfg.d_model), generator=_gen(2))
    if cfg.arch_type == "audio":
        batch["frames"] = 0.5 * torch.randn(
            lead + (cfg.num_audio_frames, cfg.d_model), generator=_gen(3))
    if "cross_layers" in params:             # fresh gates add nothing
        for k, v in (("attn_gate", 0.5), ("mlp_gate", -0.3)):
            params["cross_layers"][k] = torch.full_like(
                params["cross_layers"][k], v)
    return cfg, spec, params, batch


def _draws(state, mode, rnd_seed):
    from repro_torch.core import tree
    from repro_torch.core.rng import Draws
    if mode == "permk":
        return [None] * ROUNDS
    g = _gen(rnd_seed)
    return [Draws(masks=tree.map_leaves(
        lambda h: (torch.rand(h.shape, generator=g) < P_KEEP).to(
            torch.float32), state.h_local)) for _ in range(ROUNDS)]


def _ulp_up(x):
    """A float leaf one ulp up, away from zero's side (``nextafter``)."""
    if not x.is_floating_point():
        return x
    return torch.nextafter(x, torch.full_like(x, float("inf")))


def _full(t):
    from repro_torch.models.sharding import is_dtensor
    return t.full_tensor() if is_dtensor(t) else t


def _err(got, want):
    """[largest |got - want|, largest |want|] of one leaf."""
    got, want = _full(got).to(torch.float32), want.to(torch.float32)
    return [float((got - want).abs().max()), float(want.abs().max())]


def _sharded_run(cfg, spec, params, batch, draws, mesh):
    """The step's rounds on the mesh; returns (state, metrics, data-axis
    collectives, model-local shapes the data axis may carry)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.core import tree
    from repro_torch.launch.collectives import CallTrace
    from repro_torch.models import sharding as sh
    from repro_torch.optim.distributed import (DashaTrainConfig,
                                               dasha_train_init)
    dc = DashaTrainConfig(**spec.static["dasha"])
    st = dasha_train_init(params, dc, 0, mesh=mesh,
                          specs=spec.in_shardings[0])
    db = sh.distribute_tree(batch, spec.in_shardings[1], mesh)
    data_group = mesh.get_group("data").group_name
    metrics, calls = [], []
    for r in range(ROUNDS):
        with implicit_replication(), CallTrace() as tr:
            st, m = spec.fn(st, db, draws=draws[r])
        metrics.append(m)
        calls += [c for c in tr.calls if c[1] == data_group]
    # what may cross the data axis: g's leaves (the aggregate, float32)
    # and, under FSDP, the parameters gathered whole over it: a
    # parameter's shape on one data rank, which is h's row's
    allowed = {tuple(h.to_local().shape[1:])
               for h in tree.leaves(st.h_local)}
    return st, metrics, calls, allowed


def _case(arch, mesh, rank, **kw):
    from repro_torch.core import tree
    from repro_torch.optim.distributed import (DashaTrainConfig,
                                               dasha_train_init)
    cfg, spec, params, batch = _setup(arch, mesh, **kw)
    dc = DashaTrainConfig(**spec.static["dasha"])
    plain0 = dasha_train_init(params, dc, 0, device="cpu")
    draws = _draws(plain0, kw.get("mode", "independent"), 7)
    st, metrics, calls, allowed = _sharded_run(cfg, spec, params, batch,
                                               draws, mesh)
    fulls = {f: [(p, _full(x)) for p, x in tree.items(getattr(st, f))]
             for f in FIELDS}
    adam = hasattr(st.opt_state, "mu")
    if adam:                     # the server's moments, laid out as g
        fulls.update({f: [(p, _full(x)) for p, x in
                          tree.items(getattr(st.opt_state, f))]
                      for f in ("mu", "nu")})
    gns = [float(_full(m["g_norm_sq"])) for m in metrics]
    if rank != 0:
        return None
    want, wm = plain0, []
    for r in range(ROUNDS):
        want, m = spec.fn(want, batch, draws=draws[r])
        wm.append(m)
    # the control: the same plain rounds from parameters one ulp up, the
    # float32 rounding's own reach through the two rounds
    ctrl = dasha_train_init(tree.map_leaves(_ulp_up, params), dc, 0,
                            device="cpu")
    for r in range(ROUNDS):
        ctrl, _ = spec.fn(ctrl, batch, draws=draws[r])
    errs, control = {}, {}
    for f in fulls:
        owner = (lambda s: s.opt_state) if f in ("mu", "nu") else \
            (lambda s: s)
        src, csrc = getattr(owner(want), f), getattr(owner(ctrl), f)
        for (p, got), (_, w), (_, c) in zip(fulls[f], tree.items(src),
                                            tree.items(csrc)):
            errs[f"{f}/{p}"] = _err(got, w)
            control[f"{f}/{p}"] = _err(c, w)
    errs["g_norm_sq"] = max(
        [abs(a - float(b["g_norm_sq"])), abs(float(b["g_norm_sq"]))]
        for a, b in zip(gns, wm))
    return {"errors": errs, "control": control,
            "payload": [[float(a["payload_coords"]),
                         float(b["payload_coords"])]
                        for a, b in zip(metrics, wm)],
            "data_calls": [[k, list(s), str(d)] for k, _, s, d in calls],
            "allowed_shapes": [list(s) for s in sorted(allowed)],
            "leaves": len(fulls["params"])}


def _planted_node(mesh, rank):
    """Each rank computes the OTHER node's gradient."""
    from repro_torch.methods import substrates
    real = substrates._node_rows

    def other(data, node_dims):
        from repro_torch.core import tree
        mesh_ = tree.leaves(data)[0].device_mesh
        n_ranks = mesh_.size(node_dims[0])
        j = (mesh_.get_coordinate()[node_dims[0]] + 1) % n_ranks

        def one(x):
            full = x.full_tensor()
            k = full.shape[0] // n_ranks
            return full[j * k:(j + 1) * k]
        return tree.map_leaves(one, data)
    substrates._node_rows = other
    try:
        res = _case("starcoder2-3b", mesh, rank)
        return {"raised": None, "result": res}
    except Exception as e:
        return {"raised": f"{type(e).__name__}: {str(e)[-300:]}"}
    finally:
        substrates._node_rows = real


def _planted_mask(mesh, rank):
    """The masks' specs say the node axis is replicated over "data"."""
    from repro_torch.models import sharding as sh
    real = sh.node_spec
    sh.node_spec = lambda axes, spec: sh.P(None, *tuple(spec))
    try:
        res = _case("starcoder2-3b", mesh, rank)
        return {"raised": None, "result": res}
    except Exception as e:
        return {"raised": f"{type(e).__name__}: {str(e)[-300:]}"}
    finally:
        sh.node_spec = real


def _undrawn(mesh, rank):
    """One round's masks drawn on the mesh (no injection): this rank's
    density of its shard of the largest leaf and the data ranks' masks
    compared."""
    from repro_torch.compress import treelevel
    from repro_torch.core import tree
    from repro_torch.core.rng import RoundRandom
    from repro_torch.models import sharding as sh
    from repro_torch.optim.distributed import (DashaTrainConfig,
                                               dasha_train_init)
    cfg, spec, params, _ = _setup("starcoder2-3b", mesh)
    dc = DashaTrainConfig(**spec.static["dasha"])
    st = dasha_train_init(params, dc, 0, mesh=mesh,
                          specs=spec.in_shardings[0])
    specs = spec.in_shardings[0].h_local
    path, h = max(tree.items(st.h_local), key=lambda kv: kv[1].numel())
    rnd = RoundRandom(0, 3)
    mask = treelevel.leaf_support(rnd, path, h, mode="independent",
                                  p=P_KEEP, n=2, spec=tree.get(specs, path))
    local = mask.to_local()
    row = {"rank": rank, "coord": list(mesh.get_coordinate()),
           "density": float(local.to(torch.float32).mean()),
           "numel": local.numel(),
           "same_layout": tuple(mask.placements) == tuple(h.placements)}
    rows = [None] * dist.get_world_size()
    dist.all_gather_object(rows, (row, local.to(torch.uint8).tolist()))
    if rank != 0:
        return None
    masks = {tuple(r["coord"]): m for r, m in rows}
    return {"rows": [r for r, _ in rows],
            "data_ranks_equal": masks[(0, 0)] == masks[(1, 0)],
            "leaf": path}


def within(errors, control):
    """The leaves of a case's ``errors`` over their bound (module
    constants), each as (leaf, error / bound): a leaf's bound is TOL of
    its own largest magnitude or CONTROL_K times the largest error of its
    field in ``control``, whichever is larger."""
    reach = {}
    for k, (e, _) in control.items():
        f = k.split("/")[0]
        reach[f] = max(reach.get(f, 0.0), e)
    over = []
    for k, (e, m) in errors.items():
        if "/" not in k:
            continue
        bound = max(TOL * m, CONTROL_K * reach[k.split("/")[0]])
        if e > bound:
            over.append((k, e / bound if bound else math.inf))
    return over


def run(out_path, group: str, timeout: int = 300) -> dict:
    """This script on ``group`` in a subprocess; returns its rows."""
    import subprocess
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(out_path), group], capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out_path) as f:
        return json.load(f)


def _rank(rank, world, port, out_path, group):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    results = {}
    try:
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        for name, arch, kw in CASES[group]:
            t0 = time.perf_counter()
            try:
                results[name] = _case(arch, mesh, rank, **kw)
            except Exception:
                results[name] = traceback.format_exc()[-2000:]
            results[f"{name}-s"] = time.perf_counter() - t0
        if group == "knobs":
            results["planted_node"] = _planted_node(mesh, rank)
            results["planted_mask"] = _planted_mask(mesh, rank)
            results["undrawn"] = _undrawn(mesh, rank)
    finally:
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(results, f, indent=1)
        dist.destroy_process_group()


def main(argv=None) -> int:
    out_path, group = (argv or sys.argv[1:])[:2]
    with socket.socket() as s:                 # a free port on this host
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(_rank, args=(4, port, out_path, group), nprocs=4, join=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

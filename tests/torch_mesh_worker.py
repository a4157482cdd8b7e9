"""Sharded numerics of the port on a real 2x2 ``gloo`` mesh (4 CPU
processes), run by ``tests/test_torch_mesh_numerics.py``:

    python tests/torch_mesh_worker.py OUT.json

Each rank builds every family's smoke config (float32 and bf16; the SSM
and hybrid families through kernel 5's ``local_map`` path, whose plain
version runs on the CPU), lays its parameters, prompt and decode cache out
by the port's policy (``param_specs`` / ``batch_specs`` / ``cache_specs``)
on the ("data", "model") mesh, and runs the last-position prefill logits
and 4 decode steps under ``implicit_replication()``; every rank runs the
same calls on plain tensors.  Rank 0 writes, per case, each output's
largest error relative to the plain run's largest magnitude and the mean
error relative to its mean magnitude.  A planted case declares kernel 5's
heads replicated while the policy shards them; it must raise or disagree.
Everything is made from seeds, so the ranks hold the same full tensors.
"""
import dataclasses
import json
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
B, S, STEPS, SLOTS = 4, 64, 4, 16
GATES = {"attn_gate": 0.5, "mlp_gate": -0.3}


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _inputs(cfg):
    tokens = torch.randint(1, cfg.vocab_size, (B, S), generator=_gen(1),
                           dtype=torch.int64).to(torch.int32)
    extra = {}
    if cfg.arch_type == "vlm":
        extra["image_embeds"] = (0.5 * torch.randn(
            (B, cfg.num_image_tokens, cfg.d_model),
            generator=_gen(2))).to(cfg.torch_dtype)
    if cfg.arch_type == "audio":
        extra["frames"] = (0.5 * torch.randn(
            (B, cfg.num_audio_frames, cfg.d_model),
            generator=_gen(3))).to(cfg.torch_dtype)
    steps = torch.randint(1, cfg.vocab_size, (STEPS, B), generator=_gen(4),
                          dtype=torch.int64).to(torch.int32)
    return tokens, extra, steps


def _params(cfg):
    from repro_torch.models import init_params
    p = init_params(cfg, 0, device="cpu")
    if "cross_layers" in p:                # fresh gates add nothing
        for k, v in GATES.items():
            p["cross_layers"][k] = torch.full_like(p["cross_layers"][k], v)
    return p


def _cache(cfg, params, extra):
    from repro_torch.models import lm
    kw = {}
    if cfg.arch_type == "vlm":
        kw["image_kv"] = lm.make_image_kv(cfg, params, extra["image_embeds"],
                                          device="cpu")
    if cfg.arch_type == "audio":
        kw["enc_kv"] = lm.make_enc_kv(cfg, params, extra["frames"],
                                      device="cpu")
    return lm.init_cache(cfg, B, SLOTS, device="cpu", **kw)


def _program(cfg, params, tokens, extra, cache, steps, exp_axis):
    from repro_torch.launch.serve import kernel_config
    from repro_torch.models import lm
    from repro_torch.models.sharding import expert_sharding
    outs = []
    with torch.no_grad(), expert_sharding(exp_axis):
        logits, _ = lm.forward(kernel_config(cfg), params, tokens,
                               last_only=True, **extra)
        outs.append(logits)
        for t in range(STEPS):
            logits, cache = lm.decode_step(cfg, params, cache, steps[t], t)
            outs.append(logits)
    return outs


def _full(t):
    from repro_torch.models.sharding import is_dtensor
    return (t.full_tensor() if is_dtensor(t) else t).to(torch.float32)


def _errors(got, want):
    rows = []
    for g, w in zip(got, want):
        g, w = _full(g), _full(w)
        err = (g - w).abs()
        rows.append({"max_rel": float(err.max() / w.abs().max()),
                     "mean_rel": float(err.mean() / w.abs().mean())})
    return rows


def _case(arch, dtype, mesh):
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.specs import _expert_axis
    from repro_torch.models import sharding as sh
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    params = _params(cfg)
    tokens, extra, steps = _inputs(cfg)
    want = _program(cfg, params, tokens, extra, _cache(cfg, params, extra),
                    steps, None)
    dp = sh.dp_axes(mesh)
    dparams = sh.distribute_tree(params, sh.param_specs(cfg, params, mesh),
                                 mesh)
    bspec = sh.batch_specs(cfg, mesh, B)
    dtok = sh.distribute_tree(tokens, bspec["tokens"], mesh)
    dextra = {k: sh.distribute_tree(v, bspec[k], mesh)
              for k, v in extra.items()}
    cache = _cache(cfg, params, extra)
    dcache = sh.distribute_tree(cache, sh.cache_specs(cfg, cache, mesh, B),
                                mesh)
    dsteps = sh.distribute_tree(steps, sh.P(None, dp), mesh)
    with implicit_replication():
        got = _program(cfg, dparams, dtok, dextra, dcache,
                       [dsteps[t] for t in range(STEPS)],
                       _expert_axis(cfg, mesh))
    return _errors(got, want)


def _planted(mesh):
    """Kernel 5 declared with its heads replicated where the policy shards
    them: local_map must refuse it, or its numbers must be off."""
    from repro_torch.kernels import ops
    from torch.distributed.tensor import Replicate, Shard
    real = ops.ssd_placements

    def planted(x):
        heads = [j for j, p in enumerate(x.placements) if p == Shard(2)]

        def clear(pl):
            return tuple(Replicate() if j in heads else p
                         for j, p in enumerate(pl))
        in_pl, out_pl = real(x)
        return (tuple(clear(p) if p is not None else None for p in in_pl),
                tuple(clear(p) for p in out_pl))
    ops.ssd_placements = planted
    try:
        rows = _case("mamba2-780m", "float32", mesh)
        return {"raised": None, "errors": rows}
    except Exception as e:
        return {"raised": f"{type(e).__name__}: {str(e)[-300:]}",
                "errors": None}
    finally:
        ops.ssd_placements = real


def _rank(rank, world, port, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    results = {}
    try:
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        for fam, arch in FAMILIES.items():
            for dtype in ("float32", "bfloat16"):
                try:
                    t0 = time.perf_counter()
                    results[f"{fam}-{dtype}"] = _case(arch, dtype, mesh)
                    results[f"{fam}-{dtype}-s"] = time.perf_counter() - t0
                except Exception:
                    results[f"{fam}-{dtype}"] = traceback.format_exc()[-1500:]
        results["planted"] = _planted(mesh)
    finally:
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(results, f, indent=1)
        dist.destroy_process_group()


def main(argv=None) -> int:
    out_path = (argv or sys.argv[1:])[0]
    with socket.socket() as s:                 # a free port on this host
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(_rank, args=(4, port, out_path), nprocs=4, join=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

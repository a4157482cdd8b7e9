"""Multi-pod dry run (port of ``repro.launch.dryrun``): trace every
(architecture x input shape) on the production mesh, with memory per device
and the roofline terms of each pair.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-3b \\
        --shape decode_32k [--multi-pod | --both-meshes] [--json out.json] \\
        [--device cpu]

Each pair builds its :class:`~repro_torch.launch.specs.LoweredSpec` on
``meta`` tensors, lays the arguments out by their specs on rank 0 of the
fake 16x16 (or 2x16x16) ``DeviceMesh`` (:func:`launch.mesh.
make_production_mesh`) and runs the function once under
``implicit_replication()`` (the tensors the model makes itself, RoPE
tables and masks, join as replicated) and a
:class:`~repro_torch.launch.collectives.CallTrace`.  Nothing is allocated
and nothing is computed: ``meta`` tensors carry shapes, and the fake
group's collectives write nothing.  The row gets the analytic
:class:`~repro_torch.launch.roofline.Roofline` terms on the H100, the
trace's memory per device and its collectives by kind.  ``trace_s`` takes
the place of the reference's ``compile_s``; ``hlo_raw_gflops`` is None (no
compiler cost analysis exists here).

The train_4k pairs trace the sharded DASHA train step
(:func:`repro_torch.launch.specs.train_spec`: each rank its own node's
forward and backward under ``remat``, tensor-parallel over "model", the
estimator update on its local shards, the aggregate reduced over the data
axes); their rows carry the reference's train analytics (``model_flops``
6 x active params x tokens) and a ``peak_gb`` that covers the whole step,
the backward's saved tensors and recompute included.

Success criterion: every pair traces on both meshes (``ok``), or is
skipped under the reference's rule (``long_500k`` only for the
sub-quadratic families).  The exit code is 1 if any row is ``FAIL``.

A process group is global to its process, so the CLI runs in its own
process; each pair makes the mesh and destroys its group after.
``--device`` names the mesh's device type (the card unless ``cpu`` is
asked for); the arguments are ``meta`` either way.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from typing import Callable, Dict, Optional

from repro_torch.configs import all_arch_ids, get_config
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.launch.specs import SHAPES, input_specs, shape_supported
from repro_torch.optim.distributed import DashaTrainConfig

def tree_bytes(tree) -> float:
    from repro_torch.models.sharding import leaves_with_path
    import torch
    return float(sum(x.numel() * x.element_size()
                     for _, x in leaves_with_path(tree)
                     if isinstance(x, torch.Tensor)))


def trace_call(spec, mesh):
    """Run ``spec.fn`` once on ``spec.args`` laid out on ``mesh``; returns
    (outputs, CallTrace, seconds)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch.collectives import CallTrace
    from repro_torch.models.sharding import distribute_tree
    args = distribute_tree(spec.args, spec.in_shardings, mesh)
    t0 = time.perf_counter()
    with implicit_replication(), CallTrace() as trace:
        trace.track_args(args)
        out = spec.fn(*args)
    return out, trace, time.perf_counter() - t0


def dryrun_one(arch: str, shape: str, *, multi_pod: bool = False,
               dasha: Optional[DashaTrainConfig] = None,
               moe_dispatch: Optional[str] = None,
               serve_attn_hd_shard: bool = True,
               verbose: bool = True, device=DEFAULT_DEVICE,
               config=None, mesh_fn: Optional[Callable] = None) -> Dict:
    """Trace one (arch, shape) pair on the production mesh; returns the
    roofline row.  ``config`` replaces ``get_config(arch)`` (a smoke
    config, say) and ``mesh_fn()`` the production mesh (a fake mesh of
    another shape)."""
    resolve_device(device)          # no card: raise, not a FAIL row
    cfg = config or get_config(arch)
    if moe_dispatch and cfg.num_experts:
        cfg = dataclasses.replace(cfg, moe_dispatch=moe_dispatch)
    ok, why = shape_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "status": "skip", "why": why}

    from repro_torch.launch import analytic
    from repro_torch.launch.mesh import enter_mesh, make_production_mesh
    from repro_torch.launch.roofline import (H100_SXM5, Roofline,
                                             memory_per_device)
    try:
        mesh = mesh_fn() if mesh_fn else \
            make_production_mesh(multi_pod=multi_pod, device=device)
        with enter_mesh(mesh):
            chips = mesh.size()
            mesh_name = "x".join(str(s) for s in mesh.shape)
            spec = input_specs(cfg, shape, mesh, dasha=dasha,
                               serve_attn_hd_shard=serve_attn_hd_shard)
            out, trace, dt = trace_call(spec, mesh)
            mem = memory_per_device(trace, out)
            det = trace.collectives()
            del out
    except Exception as e:  # a failure here is a bug in the port's sharding
        return {"arch": arch, "shape": shape, "status": "FAIL",
                "error": f"{type(e).__name__}: {e}"[:500],
                "traceback": traceback.format_exc()[-3000:]}

    n_active = cfg.active_param_count()
    kind = spec.static.get("kind")
    tokens = spec.static.get("tokens", 0)
    info = SHAPES[shape]
    if kind == "train":
        state = spec.args[0]
        ana = analytic.train_analytics(
            cfg, seq=info["seq"], global_batch=info["global_batch"],
            n_active=n_active, params_bytes=tree_bytes(state.params),
            state_bytes=(tree_bytes(state.h_local)
                         + tree_bytes(state.g_local) + tree_bytes(state.g)),
            state_itemsize=4)
    elif kind == "prefill":
        ana = analytic.prefill_analytics(
            cfg, seq=info["seq"], global_batch=info["global_batch"],
            n_active=n_active, params_bytes=tree_bytes(spec.args[0]))
    else:
        ana = analytic.decode_analytics(
            cfg, seq=info["seq"], global_batch=info["global_batch"],
            n_active=n_active, params_bytes=tree_bytes(spec.args[0]),
            cache_bytes=tree_bytes(spec.args[1]))

    model_flops = (6.0 if kind == "train" else 2.0) * n_active * tokens
    coll = float(sum(v for k, v in det.items() if not k.endswith("_count")))
    rl = Roofline(flops=ana["flops"], hbm_bytes=ana["hbm_bytes"],
                  coll_bytes=coll, chips=chips, coll_detail=det,
                  model_flops=model_flops, chip=H100_SXM5)
    row = {"arch": arch, "shape": shape, "status": "ok",
           "mesh": mesh_name, "chips": chips, "trace_s": round(dt, 1),
           "kind": kind, "tokens": tokens,
           "model_gflops": model_flops / 1e9, "hlo_raw_gflops": None,
           **mem, **rl.row(),
           "coll_detail": {k: round(v) for k, v in rl.coll_detail.items()
                           if v}}
    if verbose:
        print(f"[dryrun] {arch} x {shape} mesh={row['mesh']} "
              f"trace={dt:.1f}s peak={mem['peak_gb']:.2f}GB/dev "
              f"bottleneck={row['bottleneck']} "
              f"t=(C {row['t_compute_s']:.3e}, M {row['t_memory_s']:.3e}, "
              f"X {row['t_collective_s']:.3e})s", flush=True)
        print(f"  memory: {mem}", flush=True)
    return row


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + [None], help="input shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true",
                    help="run single-pod AND multi-pod")
    ap.add_argument("--json", default=None, help="write rows to this file")
    ap.add_argument("--compression", type=float, default=1 / 32)
    ap.add_argument("--mode", default="independent",
                    choices=["independent", "permk"])
    ap.add_argument("--variant", default="dasha", choices=["dasha", "mvr"])
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--state-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--server-opt", default="sgd", choices=["sgd", "adam"])
    ap.add_argument("--moe-dispatch", default=None,
                    choices=[None, "gather", "einsum"])
    ap.add_argument("--serve-attn-replicate", action="store_true",
                    help="replicate attention weights on serve paths for "
                         "non-divisible head counts (no per-layer "
                         "hd-partial all-reduces)")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="the mesh's device type (cuda | cpu)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    archs = [args.arch] if args.arch else all_arch_ids()
    shapes = [args.shape] if args.shape else list(SHAPES)
    pods = [args.multi_pod] if not args.both_meshes else [False, True]

    rows, failures = [], 0
    t0 = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                dasha = DashaTrainConfig(
                    gamma=0.01, compression=args.compression, mode=args.mode,
                    variant=args.variant, seq_shard=args.seq_shard,
                    fsdp=args.fsdp, state_dtype=args.state_dtype,
                    server_opt=args.server_opt)
                row = dryrun_one(
                    arch, shape, multi_pod=mp, dasha=dasha,
                    moe_dispatch=args.moe_dispatch,
                    serve_attn_hd_shard=not args.serve_attn_replicate,
                    device=args.device)
                row.setdefault("mesh", "2x16x16" if mp else "16x16")
                rows.append(row)
                if row["status"] == "FAIL":
                    failures += 1
                    print(f"[dryrun] FAIL {arch} x {shape}: {row['error']}",
                          file=sys.stderr)
                elif row["status"] == "skip":
                    print(f"[dryrun] skip {arch} x {shape}: {row['why']}")

    wall = time.perf_counter() - t0
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1, default=str)
        print(f"[dryrun] wrote {len(rows)} rows to {args.json}")
    count = {s: sum(r["status"] == s for r in rows) for s in ("ok", "skip")}
    print(f"[dryrun] {count['ok']} ok / {count['skip']} skip / "
          f"{failures} FAIL in {wall:.1f} s")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())

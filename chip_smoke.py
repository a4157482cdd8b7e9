#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build — compile every kernel under ``src/repro_torch/kernels/csrc`` with
   nvcc for sm_90a (one nvcc per source, all started together);
2. kernels vs plain — each kernel against its plain torch version on the
   card at the main path's shape (5, 20958), at the ResNet-18 width
   (5, 11173962) and at a ragged shape with misaligned inputs, timed with
   CUDA events beside its device-memory bound;
3. main path — DASHA's flat Algorithm-1 round at the LIBSVM real-sim shape
   (n = 5 nodes x m = 14,461 samples, d = 20,958; synthetic data made on
   the card from a seed) through Method.build / init / Driver.run: dasha
   with fused RandK, dasha with fused QDither, page with fused RandK, 200
   rounds each; the kernels' launch counters must show the path ran
   through them;
4. agreement — all 5 variants x dense/sparse/fused on the quickstart
   problem, on the card and on the CPU with the same injected draws, must
   give the same ||grad f||^2 and bits_sent traces.

Prints one JSON ``kernels`` line, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

N_NODES, M_REALSIM, D_REALSIM = 5, 14461, 20958
D_RESNET18 = 11173962
ROUNDS, METRIC_EVERY, K_RANDK, S_QDITHER = 200, 10, 100, 15
SHAPES = [(N_NODES, D_REALSIM), (N_NODES, D_RESNET18), (3, 4099)]


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after a warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_kernels(torch, prof):
    """Device time (us) and count of every CUDA kernel in a profile."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            out[e.key] = (e.count, float(us))
    return out


def profiled(torch, fn):
    """Run ``fn`` under torch.profiler: (kernel table, wall seconds)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return device_kernels(torch, prof), wall


def kernel_device_ms(torch, fn, names, reps: int = 20):
    """Device time of one call of ``fn`` from the profiler: the summed
    time of the CUDA kernels whose names contain one of ``names``
    (None when the profiler records no device activity)."""
    fn()
    torch.cuda.synchronize()
    table, _ = profiled(torch, lambda: [fn() for _ in range(reps)])
    us = sum(t for k, (_, t) in table.items()
             if any(nm in k for nm in names))
    return us / reps / 1e3 if us > 0 else None


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"[build] {sorted(logs)} built in {time.perf_counter() - t0:.1f} s "
        f"into {build.BUILD_DIR}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def _inputs(torch, shape, seed: int, misalign: bool):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    numel = math.prod(shape)

    def make(fill):
        off = 1 if misalign else 0
        buf = torch.empty(numel + off, device="cuda")
        fill(buf)
        return buf[off:].view(shape)

    grad = make(lambda b: b.normal_(generator=g))
    h = make(lambda b: b.normal_(generator=g))
    gl = make(lambda b: b.normal_(generator=g))
    mask = make(lambda b: b.copy_((torch.rand(b.shape, device="cuda",
                                               generator=g) < 0.3).float()))
    u = make(lambda b: b.uniform_(generator=g))
    return grad, h, gl, mask, u


def phase_kernels(torch):
    from repro_torch.kernels import dasha_update as kern
    from repro_torch.kernels import ref
    a, scale, levels = 1.0 / (2.0 * 208.58 + 1.0), 209.58, S_QDITHER
    rows = {"dasha_update": [], "quantize": []}
    log("[kernels] library_ms is null for both: no single PyTorch call "
        "computes the fused estimator update or row-wise QSGD with external "
        "uniforms")
    for i, shape in enumerate(SHAPES):
        misalign = shape == SHAPES[-1]
        grad, h, gl, mask, u = _inputs(torch, shape, 100 + i, misalign)
        x = grad.clone()
        if misalign:
            x[0].zero_()                   # a zero row quantizes to zeros
        numel = math.prod(shape)

        out = kern.dasha_update(grad, h, gl, mask, a, scale)
        again = kern.dasha_update(grad, h, gl, mask, a, scale)
        plain = ref.dasha_update_ref(grad, h, gl, mask, a, scale)
        torch.cuda.synchronize()
        err = max(float((o - p).abs().max()) for o, p in zip(out, plain))
        if err != 0.0 or not all(torch.equal(o, p)
                                 for o, p in zip(out, again)):
            raise AssertionError(f"dasha_update {shape}: max_abs_err {err} "
                                 "(must be bit-equal and repeatable)")
        b, by = bound(7 * 4 * numel, 6 * numel)
        rows["dasha_update"].append({
            "shape": list(shape), "misaligned": misalign,
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: kern.dasha_update(
                grad, h, gl, mask, a, scale)),
            "plain_ms": time_ms(torch, lambda: ref.dasha_update_ref(
                grad, h, gl, mask, a, scale)),
            "device_ms": kernel_device_ms(torch, lambda: kern.dasha_update(
                grad, h, gl, mask, a, scale), ["dasha_update_"]),
            "bound_ms": b, "bound_by": by})

        q = kern.quantize(x, u, levels)
        q_again = kern.quantize(x, u, levels)
        q_plain = ref.quantize_ref(x, u, levels)
        torch.cuda.synchronize()
        agree = kern.quantize_agreement(q, q_plain, x, u, levels)
        if not agree["ok"] or not torch.equal(q, q_again):
            raise AssertionError(f"quantize {shape}: {agree} (one-level "
                                 "rule and repeatability)")
        if misalign and bool(q[0].abs().max() != 0):
            raise AssertionError("quantize: a zero row must give zeros")
        b, by = bound(3 * 4 * numel, 10 * numel)
        rows["quantize"].append({
            "shape": list(shape), "misaligned": misalign,
            "max_abs_err": agree["max_abs_err"],
            "one_level_flips": agree["flips"],
            "ms": time_ms(torch, lambda: kern.quantize(x, u, levels)),
            "plain_ms": time_ms(torch, lambda: ref.quantize_ref(x, u,
                                                                 levels)),
            "device_ms": kernel_device_ms(torch, lambda: kern.quantize(
                x, u, levels), ["quantize_partials", "quantize_apply"]),
            "bound_ms": b, "bound_by": by})
        for name in rows:
            r = rows[name][-1]
            log(f"[kernels] {name} {shape}{' misaligned' if misalign else ''}"
                f": err {r['max_abs_err']:.3g}  call {r['ms']:.4f} ms  "
                f"device {r['device_ms']} ms  plain {r['plain_ms']:.4f} ms  "
                f"bound {r['bound_ms']:.4f} ms")
        del grad, h, gl, mask, u, x, out, again, plain, q, q_again, q_plain
    return rows


def _glm_loss(torch):
    def loss(x, a, y):
        return (1 - 1 / (1 + torch.exp(y * torch.dot(a, x)))) ** 2
    return loss


def phase_main_path(torch):
    from repro_torch.compress import make_round_compressor
    from repro_torch.core.oracles import FiniteSumProblem
    from repro_torch.data.pipeline import synthetic_classification
    from repro_torch.kernels import dasha_update as kern
    from repro_torch.methods import Driver, FlatSubstrate, Hyper, Method

    n, m, d = N_NODES, M_REALSIM, D_REALSIM
    t0 = time.perf_counter()
    feats, labels = synthetic_classification(0, n, m, d, device="cuda")
    torch.cuda.synchronize()
    log(f"[main] real-sim-shaped data ({n}, {m}, {d}) = "
        f"{feats.numel() * 4 / 1e9:.2f} GB made on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    problem = FiniteSumProblem(_glm_loss(torch), feats, labels)
    L = float(torch.mean(torch.sum(feats ** 2, -1)) * 2)
    x0 = torch.zeros(d, device="cuda")
    g0 = float(torch.sum(problem.grad_f(x0) ** 2))
    runs = [("dasha", "randk", dict(k=K_RANDK), {}, "dasha_update"),
            ("dasha", "qdither", dict(s=S_QDITHER), {}, "quantize"),
            ("page", "randk", dict(k=K_RANDK), dict(B=1, m=m),
             "dasha_update")]
    results, launches = [], {name: 0 for name in kern.COUNTS}
    for variant, comp_name, ckw, tkw, kernel in runs:
        comp = make_round_compressor(comp_name, d, n, backend="fused",
                                     device="cuda", **ckw)
        hyper = Hyper.from_theory(variant, comp.omega, n, L=L,
                                  gamma_mult=16, **tkw)
        method = Method.build(variant, comp, FlatSubstrate(problem, n, d),
                              hyper)
        state = method.init(x0, 1, device="cuda")
        driver = Driver(method, metrics={
            "grad_sq": lambda s, _d: torch.sum(problem.grad_f(s.x) ** 2)},
            metric_every=METRIC_EVERY)
        driver.run(state, 3)            # warm-up: cuBLAS, torch.func
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kern.reset_counts()
        t0 = time.perf_counter()
        state, traces = driver.run(state, ROUNDS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kern.COUNTS)
        peak = torch.cuda.max_memory_allocated()
        gs = traces["grad_sq"]
        expected_bits = float(d) + ROUNDS * comp.payload_per_node
        tag = f"{variant}/{comp_name}"
        if gs.shape != (ROUNDS,) or not all(math.isfinite(v) for v in gs):
            raise AssertionError(f"{tag}: non-finite or misshapen trace")
        if not gs[-1] < g0:
            raise AssertionError(f"{tag}: ||grad f||^2 {gs[-1]} did not end "
                                 f"below its x0 value {g0}")
        if counts[kernel] != ROUNDS or sum(counts.values()) != ROUNDS:
            raise AssertionError(f"{tag}: launches {counts}, expected "
                                 f"{ROUNDS} of {kernel} only")
        if float(traces["bits_sent"][-1]) != expected_bits:
            raise AssertionError(f"{tag}: bits_sent "
                                 f"{traces['bits_sent'][-1]} != "
                                 f"{expected_bits}")
        for name in launches:
            launches[name] += counts[name]
        # where the time goes: 20 more rounds under the profiler (its CPU
        # tracing slows the host, so the busy share is a lower bound)
        table, pwall = profiled(torch, lambda: driver.run(state, 20))
        busy_s = sum(t for _, t in table.values()) / 1e6
        top = sorted(table.items(), key=lambda kv: -kv[1][1])[:8]
        profile = {"rounds": 20, "wall_s": pwall, "device_busy_s": busy_s,
                   "busy_share": busy_s / pwall,
                   "top_kernels": [[k[:90], c, us / 1e3]
                                   for k, (c, us) in top]}
        results.append({"run": tag, "rounds": ROUNDS,
                        "rounds_per_s": ROUNDS / wall, "wall_s": wall,
                        "peak_mem_gb": peak / 1e9, "grad_sq_x0": g0,
                        "grad_sq_final": float(gs[-1]),
                        "bits_sent": float(traces["bits_sent"][-1]),
                        "launches": counts, "gamma": hyper.gamma,
                        "profile": profile})
        log(f"[main] {tag}: {ROUNDS / wall:.1f} rounds/s, peak "
            f"{peak / 1e9:.2f} GB, ||grad f||^2 {g0:.6e} -> {gs[-1]:.6e} "
            f"(rel. drop {(g0 - gs[-1]) / g0:.3e}), bits_sent "
            f"{traces['bits_sent'][-1]}, launches {counts}, device busy "
            f"{profile['busy_share']:.2f} of a profiled 20-round window")
        for k, c, ms in profile["top_kernels"]:
            log(f"[main]   {ms:9.3f} ms  x{c:<5d} {k}")
    del feats, labels, problem
    return results, launches


def _draws_to(draws, dev):
    """Injected draws with their tensors moved to ``dev``."""
    plan = draws.plan._replace(**{
        f: getattr(draws.plan, f).to(dev)
        for f in ("scale", "indices", "mask", "dither_u")
        if hasattr(getattr(draws.plan, f), "to")})
    samples = None if draws.samples is None else draws.samples.to(dev)
    return draws._replace(plan=plan, samples=samples)


def phase_agreement(torch):
    """Every variant x backend on the quickstart problem, on the card and
    on the CPU, with the same CPU-drawn randomness (plan, coins, samples)
    injected into both: the ||grad f||^2 traces must agree, bits_sent must
    be equal, and g == mean_i g_i must hold on the card."""
    from repro_torch.compress import make_round_compressor
    from repro_torch.core.oracles import FiniteSumProblem
    from repro_torch.core.rng import Draws, RoundRandom
    from repro_torch.data.pipeline import synthetic_classification
    from repro_torch.methods import Driver, FlatSubstrate, Hyper, Method

    n, m, d, k, rounds = 5, 64, 60, 10, 30
    theory_kw = {"dasha": {}, "page": dict(B=2, m=m),
                 "mvr": dict(B=4, sigma2=0.1),
                 "sync_mvr": dict(B=4, sigma2=0.1, zeta=float(k), d=d),
                 "marina": dict(zeta=float(k), d=d)}
    feats, labels = synthetic_classification(0, n, m, d, device="cpu")
    L = float(torch.mean(torch.sum(feats ** 2, -1)) * 2)
    problems = {dev: FiniteSumProblem(_glm_loss(torch), feats.to(dev),
                                      labels.to(dev))
                for dev in ("cpu", "cuda")}
    worst = 0.0
    for variant, tkw in theory_kw.items():
        for backend in ("dense", "sparse", "fused"):
            comps = {dev: make_round_compressor("randk", d, n, k=k,
                                                backend=backend, device=dev)
                     for dev in problems}
            hyper = Hyper.from_theory(variant, comps["cpu"].omega, n, L=L,
                                      gamma_mult=4, **tkw)
            draws = []
            for t in range(rounds):
                rnd = RoundRandom(7, t)
                draws.append(Draws(
                    plan=rnd.plan(comps["cpu"]),
                    page_coin=rnd.coin(hyper.p, "page"),
                    samples=rnd.samples(problems["cpu"], hyper.batch)
                    if hyper.batch > 0 else None,
                    sync_coin=rnd.coin(hyper.p, "sync")))
            traces, finals = {}, {}
            for dev, problem in problems.items():
                method = Method.build(variant, comps[dev],
                                      FlatSubstrate(problem, n, d), hyper)
                state = method.init(torch.zeros(d), 1, device=dev)
                dev_draws = [_draws_to(dr, dev) for dr in draws]

                def step(s, data, method=method, dev_draws=dev_draws):
                    return method.step_full(s, data,
                                            draws=dev_draws[s.t])[0]

                finals[dev], traces[dev] = Driver(step, metrics={
                    "grad_sq": lambda s, _d, p=problem: torch.sum(
                        p.grad_f(s.x) ** 2)}).run(state, rounds)
            card = finals["cuda"]
            rel = float(max(abs(a - b) / abs(b) for a, b in zip(
                traces["cuda"]["grad_sq"], traces["cpu"]["grad_sq"])))
            worst = max(worst, rel)
            tag = f"{variant}/{backend}"
            if rel > 1e-4 or not (traces["cuda"]["bits_sent"]
                                  == traces["cpu"]["bits_sent"]).all():
                raise AssertionError(f"{tag}: card and CPU disagree "
                                     f"(max rel err {rel})")
            if not torch.allclose(card.g, card.g_local.mean(0), rtol=1e-5,
                                  atol=1e-6):
                raise AssertionError(f"{tag}: g != mean_i g_i on the card")
    log(f"[agree] 5 variants x dense/sparse/fused, quickstart problem, "
        f"{rounds} rounds with injected CPU draws: card vs CPU max rel err "
        f"{worst:.3g} (limit 1e-4), bits_sent equal, g == mean_i g_i")
    return worst


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
              "repository", file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: chip_smoke needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    phase_build()
    per_shape = phase_kernels(torch)
    runs, launches = phase_main_path(torch)
    rel = phase_agreement(torch)

    sources = {"dasha_update": "src/repro/kernels/dasha_update.py:70",
               "quantize": "src/repro/kernels/dasha_update.py:129"}
    kernels = []
    for name, rows in per_shape.items():
        main_shape = rows[0]            # the main path's (5, 20958)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dasha_update.cu",
            "replaces": sources[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"], "library_ms": None,
            "shapes": rows})
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched on the main "
                                 "path")
    report = {"kernels": kernels, "main_path": runs,
              "agreement_max_rel_err": rel, "nvidia_smi": smi}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

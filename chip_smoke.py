#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build — compile every kernel under ``src/repro_torch/kernels/csrc`` with
   nvcc for sm_90a (one nvcc per source, all started together);
2. kernels vs plain — each kernel against its plain torch version on the
   card, timed with CUDA events and the profiler beside its device-memory
   bound: ``dasha_update`` and ``quantize`` at the flat path's (5, 20958),
   the ResNet-18 width (5, 11173962) and a ragged misaligned (3, 4099);
   ``dasha_mvr_update`` at (4, 20958), the Mamba2-780M tied embedding
   leaf (4, 77463552) and the ragged misaligned shape;
3. flat main path — DASHA's flat Algorithm-1 round at the LIBSVM real-sim
   shape (n = 5 nodes x m = 14,461 samples, d = 20,958; synthetic data made
   on the card from a seed) through Method.build / init / Driver.run: dasha
   with fused RandK, dasha with fused QDither, page with fused RandK;
4. flat agreement — all 5 variants x dense/sparse/fused on the quickstart
   problem, on the card and on the CPU with the same injected draws;
5. trainer main path — ``repro_torch.launch.train.train`` on Mamba2-780M
   at full width (d_model 1536, vocab 50,432) with the depth cut to
   ``TRAIN_LAYERS`` of 48 layers (n = 4 nodes of fp32 state, the round's
   new trees and one node's activations: 32 layers ran out of the card's
   80 GB), n = 4, batch 2 per node,
   seq 512, DASHA-MVR with the fused kernel and an Adam server; rounds/s,
   tokens/s, peak memory, eval loss before and after, kernel launches
   (= leaves x rounds) and a profiled window;
6. trainer agreement — a smoke-size float32 Mamba2 trained on the card and
   on the CPU with the same injected masks, coins and batches, for dasha /
   mvr / sync_mvr x independent / permk x use_kernel off / on;
7. ssd_chunk vs plain — the SSD intra-chunk kernel against its plain torch
   version in bf16 and fp32 at one layer of the serving prefill (x (4,
   32768, 48, 64) as a view of the conv output, b/c (4, 32768, 128), Q =
   256), at the smoke model's (2, 64, 8, 32, 16), Q = 32, and at ragged
   (1, 128, 4, 16, 8), Q = 32 and (2, 32, 3, 4, 5), Q = 8; each output
   within 1e-4 of the plain version's largest magnitude, timed beside its
   bound;
8. serve main path — ``repro_torch.launch.serve`` on Mamba2-780M at full
   width and full depth (48 layers, bf16, random weights from a seed):
   (a) ``prefill_logits`` at batch 4 x 32,768 tokens, 1 warm-up + 2 timed
   calls and a profiled one (``ssd_chunk`` launches = 48 a call: the
   kernel's launches on the main path); (b) ``serve`` at batch 128, a
   256-token prompt stepped through ``decode_step`` and 64 new tokens
   (the recurrence, no kernel); (c) ``prefill_logits`` against the 512th
   decode step of ``serve`` on a 512-token prompt at batch 2 in float32;
9. serve agreement — the smoke Mamba2 in float32 prefilled (kernel on
   the card, plain version on the CPU) and served on the card and on the
   CPU with the same params and prompt: logits within 1e-4 of the largest
   magnitude, equal tokens;
10. slab_writeback vs plain — the slab-writeback kernel against its plain
    version, set and accumulate bit for bit, at the cross-device cell's
    chunk slab (U 8,192 rows with its realized sentinel tail into n =
    100,000 x d = 20,958), at (U 64, n 110,000, d 20,958) with ids at the
    end (n*d > 2^31), ragged (U 37 with 5 sentinels, n 1,000, d 4,099) on
    an offset view, all-sentinel and U = n, timed beside its bound and one
    ``index_copy_`` / ``index_add_`` call;
11. federated main path — ``repro_torch.fed.VecFedSim`` on
    ``SampledFlatSubstrate``: cross-device DASHA with n = 100,000 clients
    x m = 1 x d = 20,958 (synthetic data made on the card), C = 64, fused
    RandK K = 100, a lognormal-straggler uplink, 1,000 rounds in chunks of
    128 on the slab store after a warm-up chunk.  A timed run with no
    check inside it gives rounds/s and peak memory (the caller's state is
    kept on the host) and gates on the launches (16 slab writebacks, 1,000
    fused updates), participants and bytes; a second, gated run from the
    same state watches every writeback (untouched and written store rows)
    and must repeat the first bit for bit; the caller's state must be
    unchanged; then a profiled chunk, and ``dasha_update`` against its
    plain version at the cohort's (64, 20958) with a real round's RandK
    mask and the plan scale d/K * n/C;
12. federated agreement — the example's shape (n = 256, m = 8, d = 40,
    K = 8, C in 256/64/16) for dasha/page x randk sparse/fused and mvr on
    a stochastic problem, card vs CPU with the same injected draws (exact
    byte traces, metrics within 1e-4); slab vs scatter bit for bit on the
    card at n = 10,000, C = 64, d = 20,958, 128 rounds.

Every phase that drives a main path zeroes the launch counters just before
it and reads them just after; a kernel of that path that never launched
fails the run.  Prints one JSON ``kernels`` line, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the repository beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import dataclasses
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
# the trainer: Mamba2-780M's widths, its tied embedding leaf, n = 4 nodes
TRAIN_NODES, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = 4, 16, 2, 512
TRAIN_WARMUP, TRAIN_ROUNDS, TRAIN_PROFILED = 2, 10, 2
D_EMBED = 50432 * 1536
MVR_SHAPES = [(TRAIN_NODES, D_REALSIM), (TRAIN_NODES, D_EMBED), (3, 4099)]
# serving: Mamba2-780M's SSD (H = 48 heads x P = 64, state N = 128, chunk
# 256) at the prefill_32k sequence length, batch cut from 32 to 4; then
# the smoke model's, and ragged shapes (B, S, H, P, N, chunk)
SSD_SHAPES = [(4, 32768, 48, 64, 128, 256), (2, 64, 8, 32, 16, 32),
              (1, 128, 4, 16, 8, 32), (2, 32, 3, 4, 5, 8)]
SSD_LIMIT = 1e-4
PREFILL_BATCH, PREFILL_SEQ, PREFILL_TIMED = 4, 32768, 2
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW, DECODE_PROFILED = 128, 256, 64, 4
PARITY_BATCH, PARITY_PROMPT, PARITY_LIMIT = 2, 512, 5e-3
PROFILE_WARMUP_LAUNCHES, PROFILE_WARMUP_S = 32, 0.2
# the cross-device campaign: fed_scale_bench's largest (n = 10^5 clients,
# C = 64, 1,000 rounds) at real-sim's width, chunks of 128 rounds; and a
# store past 2^31 elements for the kernel's 64-bit offsets
FED_N, FED_C, FED_ROUNDS, FED_CHUNK, FED_BIG_N = 100000, 64, 1000, 128, \
    110000


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
    """Device time (us) and count of every CUDA kernel in a profile, but
    the warm-up's spin kernels."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            out[e.key] = (e.count, float(us))
    return out


def profiled(torch, fn):
    """Run ``fn`` under torch.profiler: (kernel table, wall seconds).  The
    profiler records no launch of its first moments (without a warm-up, a
    window of one call recorded none, and one of 20 short calls 13), so
    a few spin kernels and a pause come first, outside the wall and the
    table."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_WARMUP_LAUNCHES):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(PROFILE_WARMUP_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return device_kernels(torch, prof), wall


def kernel_device_ms(torch, fn, names, reps: int = 20):
    """Device time of one call of ``fn`` from the profiler: the summed
    time of the CUDA kernels whose names contain one of ``names``.  None
    when the windows' launches do not add up: a profiled single call gives
    the launches a call makes, and the ``reps``-call window must hold
    exactly ``reps`` times as many (a window that missed launches measures
    nothing)."""
    fn()
    torch.cuda.synchronize()

    def matching(table):
        hits = [(c, t) for k, (c, t) in table.items()
                if any(nm in k for nm in names)]
        return sum(c for c, _ in hits), sum(t for _, t in hits)

    def run():                       # keeps no outputs alive between calls
        for _ in range(reps):
            fn()

    per_call, _ = matching(profiled(torch, fn)[0])
    table, _ = profiled(torch, run)
    n, us = matching(table)
    if per_call == 0 or n != per_call * reps:
        top = sorted(table.items(), key=lambda kv: -kv[1][1])[:4]
        log(f"[profile] {names}: {per_call} launches in one profiled call, "
            f"{n} in {reps} calls: no device time; {len(table)} kernels "
            f"recorded, the longest {[(k[:60], c, t) for k, (c, t) in top]}")
        return None
    return us / reps / 1e3


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


def _check_dasha(torch, kern, ref, shape, misalign, seed,
                 a=1.0 / (2.0 * 208.58 + 1.0), scale=209.58, mask=None):
    """Kernel 1 against its plain version; by default the flat round's
    RandK scale d/K on a Bernoulli mask, else the given ``a``, ``scale``
    and (shape-sized) ``mask``."""
    grad, h, gl, bern, _ = _inputs(torch, shape, seed, misalign)
    mask = bern if mask is None else mask
    out = kern.dasha_update(grad, h, gl, mask, a, scale)
    again = kern.dasha_update(grad, h, gl, mask, a, scale)
    plain = ref.dasha_update_ref(grad, h, gl, mask, a, scale)
    torch.cuda.synchronize()
    err = max(float((o - p).abs().max()) for o, p in zip(out, plain))
    if err != 0.0 or not all(torch.equal(o, p) for o, p in zip(out, again)):
        raise AssertionError(f"dasha_update {shape}: max_abs_err {err} "
                             "(must be bit-equal and repeatable)")
    numel = math.prod(shape)
    b, by = bound(7 * 4 * numel, 6 * numel)
    return {"max_abs_err": err,
            "ms": time_ms(torch, lambda: kern.dasha_update(
                grad, h, gl, mask, a, scale)),
            "plain_ms": time_ms(torch, lambda: ref.dasha_update_ref(
                grad, h, gl, mask, a, scale)),
            "device_ms": kernel_device_ms(torch, lambda: kern.dasha_update(
                grad, h, gl, mask, a, scale), ["dasha_update_"]),
            "bound_ms": b, "bound_by": by}


def _check_mvr(torch, kern, ref, shape, misalign, seed):
    a, scale = 1.0 / (2.0 * 31.0 + 1.0), 32.0
    gn, h, gl, mask, _ = _inputs(torch, shape, seed, misalign)
    go, *_ = _inputs(torch, shape, seed + 50, misalign)
    err = 0.0
    for b in (0.1, 0.0):                      # MVR and SARAH (SYNC-MVR)
        out = kern.dasha_mvr_update(gn, go, h, gl, mask, a, b, scale)
        again = kern.dasha_mvr_update(gn, go, h, gl, mask, a, b, scale)
        plain = ref.dasha_mvr_update_ref(gn, go, h, gl, mask, a, b, scale)
        torch.cuda.synchronize()
        err = max([err] + [float((o - p).abs().max())
                           for o, p in zip(out, plain)])
        if err != 0.0 or not all(torch.equal(o, p)
                                 for o, p in zip(out, again)):
            raise AssertionError(f"dasha_mvr_update {shape} b={b}: "
                                 f"max_abs_err {err} (must be bit-equal "
                                 "and repeatable)")
        del out, again, plain
    numel = math.prod(shape)
    b_ms, by = bound(8 * 4 * numel, 9 * numel)
    return {"max_abs_err": err,
            "ms": time_ms(torch, lambda: kern.dasha_mvr_update(
                gn, go, h, gl, mask, a, 0.1, scale)),
            "plain_ms": time_ms(torch, lambda: ref.dasha_mvr_update_ref(
                gn, go, h, gl, mask, a, 0.1, scale)),
            "device_ms": kernel_device_ms(torch, lambda: kern.dasha_mvr_update(
                gn, go, h, gl, mask, a, 0.1, scale), ["dasha_mvr_update_"]),
            "bound_ms": b_ms, "bound_by": by}


def _check_quantize(torch, kern, ref, shape, misalign, seed):
    levels = S_QDITHER
    grad, _, _, _, u = _inputs(torch, shape, seed, misalign)
    x = grad.clone()
    if misalign:
        x[0].zero_()                       # a zero row quantizes to zeros
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
    numel = math.prod(shape)
    b, by = bound(3 * 4 * numel, 10 * numel)
    return {"max_abs_err": agree["max_abs_err"],
            "one_level_flips": agree["flips"],
            "ms": time_ms(torch, lambda: kern.quantize(x, u, levels)),
            "plain_ms": time_ms(torch, lambda: ref.quantize_ref(x, u,
                                                                 levels)),
            "device_ms": kernel_device_ms(torch, lambda: kern.quantize(
                x, u, levels), ["quantize_partials", "quantize_apply"]),
            "bound_ms": b, "bound_by": by}


def phase_kernels(torch):
    from repro_torch.kernels import dasha_update as kern
    from repro_torch.kernels import ref
    checks = {"dasha_update": (_check_dasha, SHAPES),
              "quantize": (_check_quantize, SHAPES),
              "dasha_mvr_update": (_check_mvr, MVR_SHAPES)}
    rows = {name: [] for name in checks}
    log("[kernels] library_ms is null for all: no single PyTorch call "
        "computes a fused estimator update, row-wise QSGD with external "
        "uniforms or the SSD intra-chunk block")
    for name, (check, shapes) in checks.items():
        for i, shape in enumerate(shapes):
            misalign = i == len(shapes) - 1
            r = check(torch, kern, ref, shape, misalign, 100 + i)
            r = {"shape": list(shape), "misaligned": misalign, **r}
            rows[name].append(r)
            torch.cuda.empty_cache()
            log(f"[kernels] {name} {shape}"
                f"{' misaligned' if misalign else ''}: err "
                f"{r['max_abs_err']:.3g}  call {r['ms']:.4f} ms  device "
                f"{r['device_ms']} ms  plain {r['plain_ms']:.4f} ms  bound "
                f"{r['bound_ms']:.4f} ms")
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


def _train_args(extra):
    from repro_torch.launch.train import build_parser
    return build_parser().parse_args([
        "--nodes", str(TRAIN_NODES), "--batch", str(TRAIN_BATCH),
        "--seq", str(TRAIN_SEQ), "--server-opt", "adam", *extra])


def phase_trainer(torch):
    """The trainer at full width (depth cut), as ``launch.train.main``
    runs it, with the counters zeroed before and read after."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.kernels import dasha_update as kern
    from repro_torch.launch.train import train
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config("mamba2-780m"),
                              num_layers=TRAIN_LAYERS)
    rounds = TRAIN_WARMUP + TRAIN_ROUNDS
    args = _train_args(["--steps", str(rounds), "--log-every",
                        str(TRAIN_WARMUP), "--variant", "mvr",
                        "--use-kernel"])
    torch.cuda.empty_cache()
    kern.reset_counts()
    res = train(cfg, args, device="cuda", log=log)
    torch.cuda.synchronize()
    counts = dict(kern.COUNTS)
    peak = max(c["peak_mem_gb"] for c in res.chunks) * 1e9
    leaves = len(tree.leaves(res.state.x))
    # memory: the state between rounds, and one node's forward + backward
    # on top of it (the rest of the peak is the round's per-node trees)
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    batch = {k: v[0] for k, v in res.driver.data_fn(res.data_seed, 0).items()}
    ps = [p.detach().requires_grad_(True) for p in tree.leaves(res.state.x)]
    paths = [path for path, _ in tree.items(res.state.x)]
    loss = lm.loss_fn(cfg, tree.from_items(zip(paths, ps)), batch)[0]
    torch.autograd.grad(loss, ps)
    torch.cuda.synchronize()
    node_pass = torch.cuda.max_memory_allocated() - resident
    del batch, ps, loss
    if counts["dasha_mvr_update"] != leaves * rounds or \
            counts["dasha_update"] or counts["quantize"]:
        raise AssertionError(f"trainer launches {counts}, expected "
                             f"{leaves} leaves x {rounds} rounds of "
                             "dasha_mvr_update only")
    losses = [c["loss"] for c in res.chunks]
    if not all(math.isfinite(v) for v in [res.loss0] + losses) or \
            not losses[-1] < res.loss0:
        raise AssertionError(f"trainer eval loss {res.loss0} -> {losses}: "
                             "must be finite and end lower")
    timed = res.chunks[1:]                      # the first chunk warms up
    wall = sum(c["seconds"] for c in timed)
    timed_rounds = rounds - TRAIN_WARMUP
    tokens = TRAIN_NODES * TRAIN_BATCH * TRAIN_SEQ
    numel = res.n_params * TRAIN_NODES
    k3_bound = numel * 32 / HBM_BYTES_PER_S * 1e3
    # where the time goes: a few more rounds under the profiler (its CPU
    # tracing slows the host, so the busy share is a lower bound)
    table, pwall = profiled(torch, lambda: res.driver.run(
        res.state, TRAIN_PROFILED, data_seed=res.data_seed))
    busy_s = sum(t for _, t in table.values()) / 1e6
    k3_us = sum(t for k, (_, t) in table.items() if "dasha_mvr_update" in k)
    k3_ms = k3_us / 1e3 / TRAIN_PROFILED
    top = sorted(table.items(), key=lambda kv: -kv[1][1])[:12]
    out = {"layers": TRAIN_LAYERS, "d_model": cfg.d_model,
           "vocab_padded": cfg.padded_vocab, "params": res.n_params,
           "leaves": leaves, "nodes": TRAIN_NODES, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "rounds_timed": timed_rounds,
           "rounds_per_s": timed_rounds / wall,
           "tokens_per_s": timed_rounds * tokens / wall,
           "round_ms": wall / timed_rounds * 1e3,
           "peak_mem_gb": peak / 1e9, "resident_mem_gb": resident / 1e9,
           "node_pass_mem_gb": node_pass / 1e9,
           "eval_loss_start": res.loss0,
           "eval_loss_end": losses[-1], "launches": counts,
           "kernel_device_ms_per_round": k3_ms,
           "kernel_bound_ms_per_round": k3_bound,
           "kernel_share_of_profiled_round": k3_ms / (pwall * 1e3
                                                      / TRAIN_PROFILED),
           "profile": {"rounds": TRAIN_PROFILED, "wall_s": pwall,
                       "device_busy_s": busy_s, "busy_share": busy_s / pwall,
                       "top_kernels": [[k[:90], c, us / 1e3]
                                       for k, (c, us) in top]},
           "chunks": res.chunks}
    log(f"[train] mamba2-780m {TRAIN_LAYERS}/48 layers, "
        f"{res.n_params / 1e6:.1f}M params, {leaves} leaves: "
        f"{out['rounds_per_s']:.3f} rounds/s, {out['tokens_per_s']:.0f} "
        f"tokens/s, peak {peak / 1e9:.2f} GB (state between rounds "
        f"{resident / 1e9:.2f} GB, one node's forward + backward "
        f"{node_pass / 1e9:.2f} GB), eval loss {res.loss0:.4f} -> "
        f"{losses[-1]:.4f}, launches {counts}")
    log(f"[train] dasha_mvr_update {k3_ms:.3f} ms device per round vs a "
        f"{k3_bound:.3f} ms bound, {out['kernel_share_of_profiled_round']:.3f}"
        f" of a profiled round; device busy {out['profile']['busy_share']:.3f}")
    for k, c, ms in out["profile"]["top_kernels"]:
        log(f"[train]   {ms:9.3f} ms  x{c:<5d} {k}")
    del res
    torch.cuda.empty_cache()
    return out, counts


def _states_agree(torch, got, want, limit):
    """Worst leaf error over (x, g, g_local, h_local), as a fraction of
    each leaf's largest magnitude."""
    from repro_torch.core import tree
    worst = 0.0
    for name in ("x", "g", "g_local", "h_local"):
        for path, w in tree.items(getattr(want, name)):
            g = tree.get(getattr(got, name), path).float().cpu()
            w = w.float()
            scale = max(float(w.abs().max()), 1e-30)
            worst = max(worst, float((g - w).abs().max()) / scale)
    if not worst <= limit:
        raise AssertionError(f"card and CPU states differ by {worst} of a "
                             f"leaf's largest magnitude (limit {limit})")
    return worst


def phase_trainer_agreement(torch):
    """Smoke-size float32 Mamba2 trained on the card and on the CPU with
    the same CPU-drawn masks, sync coins and batches.  SGD server: Adam's
    sign-like first steps would turn gradient rounding noise into
    whole-step differences (see tests/test_torch_train.py)."""
    from repro_torch.compress import treelevel
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import tree
    from repro_torch.core.rng import Draws, RoundRandom
    from repro_torch.data.pipeline import (SyntheticTextConfig,
                                           make_node_batches)
    from repro_torch.methods import Driver
    from repro_torch.models import init_params, lm
    from repro_torch.optim.distributed import DashaTrainConfig, make_method

    cfg = dataclasses.replace(get_smoke_config("mamba2-780m"),
                              dtype="float32")
    n, rounds, limit = TRAIN_NODES, 3, 5e-4
    text = SyntheticTextConfig(vocab_size=cfg.vocab_size, seq_len=64)
    batches = [make_node_batches(t, text, n, 2, device="cpu")
               for t in range(rounds)]
    params = init_params(cfg, 0, device="cpu")
    worst = 0.0
    for variant in ("dasha", "mvr", "sync_mvr"):
        for mode in ("independent", "permk"):
            for use_kernel in (False, True):
                dcfg = DashaTrainConfig(
                    gamma=0.05, compression=0.25, mode=mode,
                    variant=variant, b=0.1, p=0.5, n_nodes=n,
                    server_opt="sgd", use_kernel=use_kernel)
                zeros = tree.map_leaves(
                    lambda p: torch.zeros((n,) + tuple(p.shape)), params)
                draws = []
                for t in range(rounds):
                    rnd = RoundRandom(9, t)
                    masks, _ = treelevel.tree_masks(
                        rnd, zeros, mode=mode, p=dcfg.compression, n=n)
                    draws.append(Draws(masks=masks,
                                       sync_coin=rnd.coin(dcfg.p, "sync")))
                finals = {}
                for dev in ("cpu", "cuda"):
                    method = make_method(
                        dcfg, lambda p, b: lm.loss_fn(cfg, p, b)[0])
                    state = method.init(
                        tree.map_leaves(lambda p: p.to(dev), params), 1,
                        init_mode="zeros", device=dev)
                    dev_draws = [d._replace(masks=tree.map_leaves(
                        lambda m: m.to(dev), d.masks)) for d in draws]

                    def step(s, data, method=method, dev_draws=dev_draws):
                        return method.step_full(s, data,
                                                draws=dev_draws[s.t])[0]

                    def data_fn(seed, t, dev=dev):
                        return {k: v.to(dev) for k, v in batches[t].items()}

                    finals[dev], _ = Driver(step, data_fn=data_fn).run(
                        state, rounds, data_seed=0)
                tag = f"{variant}/{mode}/kernel={use_kernel}"
                try:
                    err = _states_agree(torch, finals["cuda"],
                                        finals["cpu"], limit)
                except AssertionError as e:
                    raise AssertionError(f"{tag}: {e}") from None
                worst = max(worst, err)
    log(f"[train-agree] smoke Mamba2 f32, dasha/mvr/sync_mvr x "
        f"independent/permk x kernel off/on, {rounds} rounds with injected "
        f"CPU masks, coins and batches: card vs CPU worst {worst:.3g} of a "
        f"leaf's largest magnitude (limit {limit})")
    return worst


def _ssd_inputs(torch, shape, dtype, seed):
    """x, dt, A, b, c of the mixer's layout on the card: x, b and c are
    views of one (B, S, H*P + 2N) conv output, as the model hands them."""
    B, S, H, P, N, _ = shape
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    xbc = torch.randn((B, S, H * P + 2 * N), device="cuda", generator=g)
    dt = torch.nn.functional.softplus(torch.randn(
        (B, S, H), device="cuda", generator=g))
    A = -torch.exp(0.3 * torch.randn((H,), device="cuda", generator=g))
    xbc, dt = xbc.to(dtype), dt.to(dtype)
    x = xbc[..., :H * P].view(B, S, H, P)
    return x, dt, A, xbc[..., H * P:H * P + N], xbc[..., H * P + N:]


def ssd_bound(shape, itemsize: int):
    """The least time of one intra-chunk pass: its float32 work counting
    only what the inputs need (the lower triangle; c b^T once per (batch,
    chunk), since it does not depend on the head), against its bytes
    (inputs read once, float32 outputs written once)."""
    B, S, H, P, N, Q = shape
    G, nc = B * H, S // Q
    tri = Q * (Q + 1) // 2
    flops = (2 * B * nc * tri * N            # scores c b^T
             + 2 * G * nc * tri * P          # y_diag
             + 2 * G * nc * Q * N * P        # states
             + 2 * G * nc * tri              # exp and the L * scores product
             + 2 * G * S * P)                # x dt and its decay weight
    nbytes = (itemsize * (B * S * H * P + B * S * H + 2 * B * S * N) + 4 * H
              + 4 * G * nc * (Q * P + N * P + 1 + Q))
    return bound(nbytes, flops), flops, nbytes


def phase_ssd_kernel(torch, smi: str):
    """ssd_chunk against its plain version on the card (phase 7)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_chunk as kern
    rows = []
    for i, shape in enumerate(SSD_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            torch.cuda.empty_cache()
            x, dt, A, b, c = _ssd_inputs(torch, shape, dtype, 200 + i)
            Q = shape[-1]
            got = kern.ssd_chunk(x, dt, A, b, c, Q)
            again = kern.ssd_chunk(x, dt, A, b, c, Q)

            def plain():
                return ref.ssd_chunk_ref(*ops.chunk_layout(x, dt, A, b, c, Q))

            want = plain()
            torch.cuda.synchronize()
            errs = {}
            for name, gg, ww in zip(("y_diag", "states", "decays", "acs"),
                                    got, want):
                scale = float(ww.abs().max())
                err = float((gg - ww).abs().max())
                errs[name] = {"max_abs_err": err, "max_abs_plain": scale}
                if not err <= SSD_LIMIT * scale:
                    raise AssertionError(
                        f"ssd_chunk {shape} {dtype}: {name} max_abs_err "
                        f"{err} > {SSD_LIMIT} x {scale}")
            if not all(torch.equal(a, w) for a, w in zip(got, again)):
                raise AssertionError(f"ssd_chunk {shape} {dtype}: two "
                                     "launches differ")
            del got, again, want
            (b_ms, by), flops, nbytes = ssd_bound(shape, x.element_size())
            reps = 5 if shape[1] > 4096 else 20
            r = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                 "errors": errs,
                 "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
                 "ms": time_ms(torch, lambda: kern.ssd_chunk(
                     x, dt, A, b, c, Q), reps=reps),
                 "plain_ms": time_ms(torch, plain, reps=reps),
                 "device_ms": kernel_device_ms(torch, lambda: kern.ssd_chunk(
                     x, dt, A, b, c, Q), ["ssd_chunk_kernel"], reps=reps),
                 "bound_ms": b_ms, "bound_by": by, "flops": flops,
                 "bytes": nbytes}
            rows.append(r)
            log(f"[ssd] {shape} {r['dtype']}: err {r['max_abs_err']:.3g} "
                f"(y_diag {errs['y_diag']['max_abs_err']:.3g} of "
                f"{errs['y_diag']['max_abs_plain']:.3g})  call "
                f"{r['ms']:.4f} ms  device {r['device_ms']} ms  plain "
                f"{r['plain_ms']:.4f} ms  bound {b_ms:.4f} ms ({by})  "
                f"[{smi}]")
            del x, dt, A, b, c
    torch.cuda.empty_cache()
    return rows


def phase_serve(torch, smi: str):
    """Mamba2-780M at full width and depth through the port's serving entry
    points (phase 8), each part with the launch count zeroed before it and
    read after it."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.data.pipeline import SyntheticTextConfig, make_lm_batch
    from repro_torch.kernels import ssd_chunk as kern
    from repro_torch.launch import serve as S
    from repro_torch.models import init_params

    cfg = get_config("mamba2-780m")
    L = cfg.num_layers
    torch.cuda.empty_cache()
    params = init_params(cfg, 0, device="cuda")
    n_params = sum(int(x.numel()) for x in tree.leaves(params))
    out = {"layers": L, "params": n_params, "card": smi}

    # (a) prefill: the last position's logits of 4 x 32,768 tokens
    text = SyntheticTextConfig(vocab_size=cfg.vocab_size,
                               seq_len=PREFILL_SEQ)
    tokens = make_lm_batch(1, text, PREFILL_BATCH, device="cuda")["tokens"]
    kern.reset_counts()
    logits = S.prefill_logits(cfg, params, tokens)            # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(PREFILL_TIMED):
        t0 = time.perf_counter()
        logits = S.prefill_logits(cfg, params, tokens)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    calls = 1 + PREFILL_TIMED
    launches = kern.COUNTS["ssd_chunk"]
    peak = torch.cuda.max_memory_allocated()
    if launches != L * calls:
        raise AssertionError(f"prefill: ssd_chunk launches {launches}, "
                             f"expected {L} layers x {calls} calls")
    if tuple(logits.shape) != (PREFILL_BATCH, 1, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} are "
                             "misshapen or not finite")
    table, pwall = profiled(torch, lambda: S.prefill_logits(cfg, params,
                                                            tokens))
    busy_s = sum(t for _, t in table.values()) / 1e6
    k_count = sum(c for k, (c, _) in table.items() if "ssd_chunk_kernel" in k)
    k_ms = sum(t for k, (_, t) in table.items()
               if "ssd_chunk_kernel" in k) / 1e3
    if k_count != L:
        # a window that missed launches measures nothing
        log(f"[serve] the profiled prefill call recorded {k_count} "
            f"ssd_chunk launches, not {L}: no device time for it")
        k_ms = None
    (b_ms, by), _, _ = ssd_bound((PREFILL_BATCH, PREFILL_SEQ,
                                  cfg.ssm_nheads, cfg.ssm_headdim,
                                  cfg.ssm_state, cfg.ssd_chunk), 2)
    top = sorted(table.items(), key=lambda kv: -kv[1][1])[:12]
    wall = sum(walls) / len(walls)
    ntok = PREFILL_BATCH * PREFILL_SEQ
    out["prefill"] = {
        "batch": PREFILL_BATCH, "seq": PREFILL_SEQ, "walls_s": walls,
        "tokens_per_s": ntok / wall, "peak_mem_gb": peak / 1e9,
        "ssd_chunk_launches": launches,
        "ssd_chunk_profiled_launches": k_count,
        "ssd_chunk_device_ms_per_layer": None if k_ms is None else k_ms / L,
        "ssd_chunk_bound_ms_per_layer": b_ms, "bound_by": by,
        "ssd_chunk_share_of_call": None if k_ms is None
        else k_ms / (pwall * 1e3),
        "profile": {"wall_s": pwall, "device_busy_s": busy_s,
                    "busy_share": busy_s / pwall,
                    "top_kernels": [[k[:90], c, us / 1e3]
                                    for k, (c, us) in top]}}
    log(f"[serve] mamba2-780m {L}/48 layers, {n_params / 1e6:.1f}M params, "
        f"bf16 ({smi}): prefill {PREFILL_BATCH}x{PREFILL_SEQ} in "
        f"{walls} s, {ntok / wall:.0f} tokens/s, peak {peak / 1e9:.2f} GB, "
        f"ssd_chunk launches {launches}; profiled call {pwall:.3f} s, device "
        f"busy {busy_s / pwall:.3f}, ssd_chunk "
        f"{out['prefill']['ssd_chunk_device_ms_per_layer']} ms a layer vs "
        f"a {b_ms:.3f} ms bound ({by}), "
        f"{out['prefill']['ssd_chunk_share_of_call']} of the call")
    for k, c, ms in out["prefill"]["profile"]["top_kernels"]:
        log(f"[serve]   {ms:9.3f} ms  x{c:<5d} {k}")
    del logits, tokens
    torch.cuda.empty_cache()

    # (b) serve: a 256-token prompt stepped through decode_step, 64 new
    # (the recurrence: no ssd_chunk launch)
    args = S.build_parser().parse_args([
        "--batch", str(DECODE_BATCH), "--prompt-len", str(DECODE_PROMPT),
        "--new-tokens", str(DECODE_NEW)])
    torch.cuda.reset_peak_memory_stats()
    kern.reset_counts()
    res = S.serve(cfg, args, device="cuda", params=params, log=log)
    torch.cuda.synchronize()
    launches_b = kern.COUNTS["ssd_chunk"]
    peak = torch.cuda.max_memory_allocated()
    if res.tokens.shape != (DECODE_BATCH, DECODE_NEW) or \
            not ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all():
        raise AssertionError(f"serve tokens {res.tokens.shape} misshapen "
                             "or out of the vocabulary")
    cache_gb = sum(t.numel() * t.element_size()
                   for t in res.state.cache.values()) / 1e9
    # not a gate: the bf16 kernel prefill of the same prompt against the
    # last prompt step (tests/test_torch_serve.py holds this gap to the
    # reference's own)
    gap, agree = _logit_gap(S, cfg, S.prefill_logits(
        cfg, params, res.prompt)[:, 0], res.last_logits)
    out["decode"] = {
        "batch": DECODE_BATCH, "prompt": DECODE_PROMPT, "new": DECODE_NEW,
        "decode_s": res.decode_s,
        "decode_tokens_per_s": DECODE_BATCH * DECODE_NEW / res.decode_s,
        "ms_per_step": res.decode_s / DECODE_NEW * 1e3,
        "prompt_steps_s": res.prefill_s,
        "prompt_ms_per_step": res.prefill_s / DECODE_PROMPT * 1e3,
        "cache_gb": cache_gb,
        "peak_mem_gb": peak / 1e9, "ssd_chunk_launches": launches_b,
        "bf16_prefill_vs_step_err": gap, "bf16_first_token_agree": agree,
        "first_row": res.tokens[0].tolist()}
    log(f"[serve] bf16 kernel prefill of the {DECODE_BATCH} x "
        f"{DECODE_PROMPT} prompt vs its last decode step (not a gate): "
        f"{gap:.3e} of max |logit|, greedy tokens agree on {agree:.3f} of "
        "rows")
    # where a decode step's time goes: a few more steps under the profiler
    # (its CPU tracing slows the host, so the busy share is a lower bound)
    from repro_torch.models import lm
    state = res.state

    def steps():
        with torch.inference_mode():
            tok = state.tok
            for i in range(DECODE_PROFILED):
                logits, _ = lm.decode_step(S.kernel_config(cfg), params,
                                           state.cache, tok, state.t + i)
                tok = S.greedy(cfg, logits)

    table, pwall = profiled(torch, steps)
    busy_s = sum(t for _, t in table.values()) / 1e6
    n_kernels = sum(c for c, _ in table.values())
    top = sorted(table.items(), key=lambda kv: -kv[1][1])[:8]
    out["decode_profile"] = {
        "steps": DECODE_PROFILED, "wall_s": pwall, "device_busy_s": busy_s,
        "busy_share": busy_s / pwall,
        "device_ms_per_step": busy_s / DECODE_PROFILED * 1e3,
        "kernels_per_step": n_kernels / DECODE_PROFILED,
        "top_kernels": [[k[:90], c, us / 1e3] for k, (c, us) in top]}
    log(f"[serve] decode profile ({smi}), {DECODE_PROFILED} steps: "
        f"{pwall / DECODE_PROFILED * 1e3:.2f} ms a step under the profiler, "
        f"device busy {busy_s / pwall:.3f} "
        f"({busy_s / DECODE_PROFILED * 1e3:.2f} ms of device work a step), "
        f"{n_kernels / DECODE_PROFILED:.0f} kernels a step")
    for k, c, ms in out["decode_profile"]["top_kernels"]:
        log(f"[serve]   {ms:9.3f} ms  x{c:<5d} {k}")
    log(f"[serve] decode batch {DECODE_BATCH} ({smi}): {DECODE_NEW} steps in "
        f"{res.decode_s:.3f} s, {out['decode']['ms_per_step']:.2f} ms a step, "
        f"{out['decode']['decode_tokens_per_s']:.0f} tokens/s; prompt "
        f"{out['decode']['prompt_ms_per_step']:.2f} ms a step; cache "
        f"{cache_gb:.2f} GB, peak {peak / 1e9:.2f} GB; first row "
        f"{res.tokens[0][:16].tolist()}")
    del res, params, state
    torch.cuda.empty_cache()

    # (c) kernel prefill vs decode recurrence at full width, float32
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(cfg32, 0, device="cuda")
    args = S.build_parser().parse_args([
        "--batch", str(PARITY_BATCH), "--prompt-len", str(PARITY_PROMPT),
        "--new-tokens", "4"])
    res = S.serve(cfg32, args, device="cuda", params=params, log=log)
    kern.reset_counts()
    first = S.prefill_logits(cfg32, params, res.prompt)[:, 0]
    torch.cuda.synchronize()
    if kern.COUNTS["ssd_chunk"] != L:
        raise AssertionError(f"parity: ssd_chunk launches "
                             f"{kern.COUNTS['ssd_chunk']}, expected {L}")
    err, agree = _logit_gap(S, cfg32, first, res.last_logits)
    if not err <= PARITY_LIMIT:
        raise AssertionError(f"kernel prefill vs decode recurrence: "
                             f"{err} of max |logit| > {PARITY_LIMIT}")
    out["parity_f32"] = {"batch": PARITY_BATCH, "prompt": PARITY_PROMPT,
                         "err_of_max_logit": err, "limit": PARITY_LIMIT,
                         "greedy_agree": agree,
                         "max_logit": float(res.last_logits.abs().max())}
    log(f"[serve] float32 full width ({smi}), {PARITY_BATCH} x "
        f"{PARITY_PROMPT}: kernel prefill vs the {PARITY_PROMPT}th decode "
        f"step {err:.3e} of max |logit| (limit {PARITY_LIMIT}), greedy "
        f"tokens agree on {agree:.3f} of rows")
    del res, params, first
    torch.cuda.empty_cache()
    return out, launches


def _logit_gap(S, cfg, got, want):
    """The largest |got - want| as a fraction of max |want|, and the share
    of rows whose greedy tokens agree."""
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got.float() - want.float()).abs().max()) / scale
    agree = float((S.greedy(cfg, got) == S.greedy(cfg, want)).float().mean())
    return err, agree


def phase_serve_agreement(torch):
    """The smoke Mamba2 in float32 prefilled and served on the card and on
    the CPU with the same params and prompt (phase 9)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import tree
    from repro_torch.kernels import ssd_chunk as kern
    from repro_torch.launch import serve as S
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_smoke_config("mamba2-780m"),
                              dtype="float32")
    args = S.build_parser().parse_args(["--batch", "4", "--prompt-len", "64",
                                        "--new-tokens", "16"])
    params = init_params(cfg, 0, device="cpu")
    prompt = torch.randint(1, cfg.vocab_size, (4, 64),
                           generator=torch.Generator().manual_seed(5))
    res, first = {}, {}
    for dev in ("cuda", "cpu"):
        dev_params = tree.map_leaves(lambda p, d=dev: p.to(d), params)
        res[dev] = S.serve(cfg, args, device=dev, params=dev_params,
                           prompt=prompt, log=lambda _: None)
        kern.reset_counts()
        first[dev] = S.prefill_logits(cfg, dev_params,
                                      prompt.to(dev))[:, 0].cpu()
        if kern.COUNTS["ssd_chunk"] != (cfg.num_layers if dev == "cuda"
                                        else 0):
            raise AssertionError(f"smoke prefill on {dev}: ssd_chunk "
                                 f"launches {kern.COUNTS['ssd_chunk']}")
    worst = 0.0
    for card, cpu in ((first["cuda"], first["cpu"]),
                      (res["cuda"].last_logits.cpu(),
                       res["cpu"].last_logits)):
        worst = max(worst, float((card - cpu).abs().max())
                    / float(cpu.abs().max()))
    if not worst <= 1e-4:
        raise AssertionError(f"smoke serve: card and CPU logits differ by "
                             f"{worst} of the largest magnitude")
    if not (res["cuda"].tokens == res["cpu"].tokens).all():
        raise AssertionError("smoke serve: card and CPU tokens differ")
    log(f"[serve-agree] smoke Mamba2 f32, 4 x 64 prompt + 16 tokens: card "
        f"vs CPU prefill (kernel vs plain) and last-step logits {worst:.3g} "
        "of the largest magnitude (limit 1e-4), greedy tokens equal")
    return worst


# ---------------------------------------------------------------------------
# the federated slice: kernel 4, the cross-device campaign, agreement
# ---------------------------------------------------------------------------

def _slab_inputs(torch, n, d, idx, seed, offset=0):
    """A random (n, d) store (a view ``offset`` columns into a wider
    buffer when offset > 0) and a random (len(idx), d) slab on the card."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    buf = torch.randn((n, d + 2 * offset), device="cuda", generator=g)
    rows = torch.randn((len(idx), d), device="cuda", generator=g)
    idx_t = torch.as_tensor(idx, dtype=torch.int32, device="cuda")
    return buf, buf[:, offset:offset + d], idx_t, rows


def _slab_shapes():
    """Phase 10's (label, n, d, idx, offset) cases; the cell's ids are a
    real chunk's: the union of 128 rounds of 64-of-100,000 cohorts, with
    its realized sentinel tail."""
    import numpy as np
    from repro_torch.core.rng import cohort_schedule
    from repro_torch.methods.substrates import slab_layout
    n, d = FED_N, D_REALSIM
    cell, _ = slab_layout(cohort_schedule(0, 0, FED_CHUNK, n, FED_C), n)
    big = FED_BIG_N
    ragged = np.concatenate([np.sort(np.random.default_rng(3).choice(
        1000, 32, replace=False)), np.full(5, 1000)])
    return [("cell", n, d, cell, 0),
            ("past_2^31", big, d, np.arange(big - 64, big), 0),
            ("ragged_view", 1000, 4099, ragged, 1),
            ("all_sentinel", 1000, d, np.full(64, 1000), 0),
            ("u_equals_n", 1000, d, np.arange(1000), 0)]


def phase_slab_kernel(torch, smi: str):
    """slab_writeback against its plain version on the card (phase 10):
    set and accumulate bit-equal at each shape, timed beside its bound and
    beside one ``index_copy_`` / ``index_add_`` call over the valid
    rows."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import slab_writeback as kern
    torch.cuda.empty_cache()
    rows_out = []
    for i, (label, n, d, idx, offset) in enumerate(_slab_shapes()):
        u = int((idx < n).sum())
        for accumulate in (False, True):
            buf, full, idx_t, rows = _slab_inputs(torch, n, d, idx, 40 + i,
                                                  offset)
            plain_buf = buf.clone()
            plain = plain_buf[:, offset:offset + d]
            kern.slab_writeback(full, idx_t, rows, accumulate=accumulate)
            ref.slab_writeback_ref(plain, idx_t, rows, accumulate=accumulate)
            torch.cuda.synchronize()
            if not torch.equal(buf, plain_buf):
                raise AssertionError(
                    f"slab_writeback {label} accumulate={accumulate}: "
                    "not bit-equal to the plain version")
            del plain_buf, plain
            width = kern.vec_width(full, rows)
            idx_l = idx_t[:u].to(torch.int64)
            valid = rows[:u]
            if accumulate:
                def lib(full=full, idx_l=idx_l, valid=valid):
                    full.index_add_(0, idx_l, valid)
            else:
                def lib(full=full, idx_l=idx_l, valid=valid):
                    full.index_copy_(0, idx_l, valid)

            def call(full=full, idx_t=idx_t, rows=rows, acc=accumulate):
                kern.slab_writeback(full, idx_t, rows, accumulate=acc)

            def plain_call(full=full, idx_t=idx_t, rows=rows,
                           acc=accumulate):
                ref.slab_writeback_ref(full, idx_t, rows, accumulate=acc)

            b, by = bound((3 if accumulate else 2) * 4 * u * d + 4 * len(idx),
                          u * d if accumulate else 0)
            r = {"shape": label, "n": n, "d": d, "U": len(idx),
                 "valid_rows": u, "accumulate": accumulate,
                 "vec_width": width, "max_abs_err": 0.0,
                 "ms": time_ms(torch, call),
                 "device_ms": kernel_device_ms(
                     torch, call, ["slab_writeback_kernel"]) if u else None,
                 "plain_ms": time_ms(torch, plain_call),
                 "library_ms": time_ms(torch, lib),
                 "bound_ms": b, "bound_by": by}
            rows_out.append(r)
            del buf, full, rows, idx_t, idx_l, valid, lib, call, plain_call
            torch.cuda.empty_cache()
            log(f"[slab] {label} (U {len(idx)}, {u} valid, n {n}, d {d}"
                f"{', offset view' if offset else ''}) "
                f"{'accumulate' if accumulate else 'set'}: bit-equal, "
                f"float{width} access; call {r['ms']:.4f} ms  device "
                f"{r['device_ms']} ms  plain {r['plain_ms']:.4f} ms  "
                f"index_{'add' if accumulate else 'copy'}_ "
                f"{r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms"
                f"  | {smi}")
    return rows_out


def _fed_sim(problem, n, d, c, *, variant="dasha", backend="fused",
             device="cuda", store="auto", k=K_RANDK, hyper_kw=None,
             chunk=None, gamma_mult=16):
    from repro_torch.compress import make_round_compressor
    from repro_torch.fed import LinkModel, Lognormal, VecFedSim
    from repro_torch.fed.sim import DEFAULT_CHUNK
    from repro_torch.methods import Hyper, SampledFlatSubstrate
    comp = make_round_compressor("randk", d, n, k=k, backend=backend,
                                 device=device)
    sub = SampledFlatSubstrate(problem, n, d, c=c)
    omega = sub.with_compressor(comp).effective_omega()
    hyper = Hyper.from_theory(variant, omega, n, gamma_mult=gamma_mult,
                              **(hyper_kw or {}))
    uplink = LinkModel(latency_s=0.02, bandwidth_Bps=1e5,
                       straggler=Lognormal(1.0))
    return VecFedSim(variant, comp, sub, hyper, uplink=uplink, seed=0,
                     store=store, chunk=chunk or DEFAULT_CHUNK)


def phase_fed_main(torch, smi: str):
    """Cross-device DASHA at fed_scale_bench's largest campaign and
    real-sim's width (phase 11): VecFedSim on SampledFlatSubstrate over
    n = 100,000 clients x m = 1 x d = 20,958, C = 64, RandK K = 100 on the
    fused backend, 1,000 rounds in chunks of 128 on the slab store, after
    a warm-up chunk.  Gates: launches, participants, bytes, untouched and
    written store rows, the caller's state, finite traces."""
    import numpy as np
    from repro_torch.core.oracles import FiniteSumProblem
    from repro_torch.data.pipeline import synthetic_classification
    from repro_torch.fed.net import campaign_streams
    from repro_torch.kernels import dasha_update as kern
    from repro_torch.kernels import slab_writeback as slab_kern
    from repro_torch.kernels import ssd_chunk as ssd_kern

    n, m, d, c, rounds = FED_N, 1, D_REALSIM, FED_C, FED_ROUNDS
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    feats, labels = synthetic_classification(0, n, m, d, device="cuda")
    torch.cuda.synchronize()
    log(f"[fed] ({n}, {m}, {d}) client data = {feats.numel() * 4 / 1e9:.2f}"
        f" GB made on the card in {time.perf_counter() - t0:.2f} s")
    problem = FiniteSumProblem(_glm_loss(torch), feats, labels)
    L = float((feats.norm(dim=-1) ** 2).mean() * 2)
    sim = _fed_sim(problem, n, d, c, hyper_kw=dict(L=L),
                   chunk=FED_CHUNK)
    if not sim.slab:
        raise AssertionError("store='auto' did not take the slab store")
    state = sim.init(torch.zeros(d, device="cuda"), 1, device="cuda")
    g0 = float(torch.sum(state.g ** 2))            # g^0 = grad f(x^0)

    def metric(s):
        return torch.sum(s.g ** 2)

    sim.run(state, FED_CHUNK, metric_fn=metric)       # warm-up chunk
    torch.cuda.synchronize()
    # the caller's state, kept on the host so that the card's peak memory
    # is the campaign's own
    shared = state.g_local is state.h_local
    before = {f: getattr(state, f).cpu() for f in ("x", "g", "h_local")
              + (() if shared else ("g_local",))}

    # the timed run: nothing but the campaign
    torch.cuda.reset_peak_memory_stats()
    kern.reset_counts()
    slab_kern.reset_counts()
    ssd_kern.reset_counts()
    t0 = time.perf_counter()
    res = sim.run(state, rounds, metric_fn=metric)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**kern.COUNTS, **slab_kern.COUNTS, **ssd_kern.COUNTS}
    peak = torch.cuda.max_memory_allocated()

    tr = res.traces
    chunks = -(-rounds // FED_CHUNK)
    want = {"dasha_update": rounds, "slab_writeback": 2 * chunks}
    if any(counts[k] != v for k, v in want.items()) or \
            sum(counts.values()) != sum(want.values()):
        raise AssertionError(f"[fed] launches {counts}, expected {want}")
    if not np.all(tr["participants"] == c):
        raise AssertionError("[fed] a round without 64 participants")
    up = c * (20 + 8 * K_RANDK)
    if not np.all(tr["bytes_up"] == up) or \
            not np.all(tr["bytes_down"] == c * 4 * d):
        raise AssertionError(f"[fed] bytes: up {set(tr['bytes_up'])} != "
                             f"{up} or down {set(tr['bytes_down'])}")
    for k in ("metric", "sim_wall_clock", "bits_sent"):
        if not np.all(np.isfinite(tr[k])) or tr[k].shape != (rounds,):
            raise AssertionError(f"[fed] trace {k} non-finite/misshapen")

    # the gated run, from the same state: it watches every writeback (the
    # union rows it touched, and that each written store row equals its
    # slab row) and must repeat the timed run bit for bit
    touched = torch.zeros(n, dtype=torch.bool, device="cuda")
    written_ok = []
    exit_orig = sim._slab_exit

    def watched_exit(st, idx, full_h, full_g):
        out = exit_orig(st, idx, full_h, full_g)
        u = int((idx < n).sum())
        rows = idx[:u].to(torch.int64)
        touched[rows] = True
        written_ok.append(
            torch.equal(out.h_local.index_select(0, rows), st.h_local[:u])
            and torch.equal(out.g_local.index_select(0, rows),
                            st.g_local[:u]))
        return out

    sim._slab_exit = watched_exit
    gated = sim.run(state, rounds, metric_fn=metric)
    sim._slab_exit = exit_orig
    if not written_ok or not all(written_ok):
        raise AssertionError("[fed] a written store row differs from its "
                             "slab row")
    for key in tr:
        if not np.array_equal(tr[key], gated.traces[key]):
            raise AssertionError(f"[fed] the gated run's {key} differs")
    for f in ("x", "g", "h_local", "g_local"):
        if not torch.equal(getattr(res.state, f), getattr(gated.state, f)):
            raise AssertionError(f"[fed] the gated run's {f} differs")
    del gated
    for f, t in before.items():
        if not torch.equal(getattr(state, f).cpu(), t):
            raise AssertionError(f"[fed] run wrote the caller's {f}")
    del before
    untouched_rows = 0
    for f in ("h_local", "g_local"):
        final, start = getattr(res.state, f), getattr(state, f)
        for lo in range(0, n, 8192):
            diff = (final[lo:lo + 8192] != start[lo:lo + 8192]).any(1)
            if bool((diff & ~touched[lo:lo + 8192]).any()):
                raise AssertionError(f"[fed] an untouched {f} row changed")
        untouched_rows = int((~touched).sum())
    del state
    torch.cuda.empty_cache()

    # where a chunk's time goes: one more chunk from the final state (the
    # simulator's own copy, so the in-place writeback is allowed)
    t0 = time.perf_counter()
    md, mu = sim._chunk_multipliers(
        campaign_streams(np.random.default_rng(5), FED_CHUNK), 0, FED_CHUNK)
    draw_s = time.perf_counter() - t0              # the host's numpy draws
    table, pwall = profiled(torch, lambda: sim._chunk_slab(
        res.state, FED_CHUNK, md, mu, metric, None))
    busy_s = sum(t for _, t in table.values()) / 1e6
    slab_hits = [(cnt, us) for key, (cnt, us) in table.items()
                 if "slab_writeback_kernel" in key]
    slab_launches = sum(cnt for cnt, _ in slab_hits)
    slab_ms = sum(us for _, us in slab_hits) / 1e3 \
        if slab_launches == 2 else None
    sels = sim.substrate.cohort_schedule(res.state.seed, res.state.t,
                                         FED_CHUNK)
    u = int(np.unique(sels).size)
    slab_bound, _ = bound(2 * 2 * 4 * u * d, 0)
    top = sorted(table.items(), key=lambda kv: -kv[1][1])[:8]
    gf = float(torch.sum(problem.grad_f(res.state.x) ** 2))
    out = {"n": n, "m": m, "d": d, "C": c, "K": K_RANDK,
           "rounds": rounds, "chunk": FED_CHUNK, "store": "slab",
           "rounds_per_s": rounds / wall, "wall_s": wall,
           "peak_mem_gb": peak / 1e9, "grad_sq_x0": g0,
           "grad_sq_final": gf, "gamma": sim.hyper.gamma,
           "effective_omega": sim._bound.effective_omega(),
           "sim_wall_clock_s": res.summary["wall_clock_s"],
           "bytes_up_per_round": up, "launches": counts,
           "untouched_rows": untouched_rows,
           "multipliers_s_per_chunk": draw_s,
           "profiled_chunk": {
               "rounds": FED_CHUNK, "wall_s": pwall,
               "device_busy_s": busy_s, "busy_share": busy_s / pwall,
               "slab_writeback_launches": slab_launches,
               "slab_writeback_device_ms": slab_ms,
               "slab_writeback_bound_ms": slab_bound,
               "union_rows": u,
               "top_kernels": [[k[:90], cnt, us / 1e3]
                               for k, (cnt, us) in top]},
           "nvidia_smi": smi}
    log(f"[fed] dasha, randk K={K_RANDK} fused, n={n} C={c} d={d}: "
        f"{rounds} rounds in {wall:.2f} s = {rounds / wall:.1f} rounds/s, "
        f"peak {peak / 1e9:.2f} GB, ||grad f||^2 {g0:.6e} -> {gf:.6e}, "
        f"simulated wall clock {res.summary['wall_clock_s']:.2f} s, "
        f"launches {counts}, {untouched_rows} rows never touched | {smi}")
    log(f"[fed] a chunk's straggler multipliers (numpy, 2 x {FED_CHUNK} x "
        f"{n} draws): {draw_s * 1e3:.1f} ms on the host")
    log(f"[fed] profiled chunk: {pwall * 1e3:.1f} ms wall, device busy "
        f"{busy_s / pwall:.3f}; slab_writeback {slab_launches} launches, "
        f"{slab_ms} ms device a chunk against {slab_bound:.4f} ms bound "
        f"({u} union rows) | {smi}")
    for k, cnt, ms in out["profiled_chunk"]["top_kernels"]:
        log(f"[fed]   {ms:9.3f} ms  x{cnt:<5d} {k}")
    del res, problem, feats, labels
    torch.cuda.empty_cache()
    return out, counts, _check_dasha_fed(torch, sim, smi)


def _check_dasha_fed(torch, sim, smi: str):
    """Kernel 1 against its plain version at the federated path's shape
    and scale: the (C, d) cohort, a real round's RandK mask, the plan
    scale d/K * n/C (the n/C inflation folded in, as the cohort round
    does) and the campaign's own momentum a."""
    from repro_torch.compress.plan import indices_to_masks
    from repro_torch.core.rng import RoundRandom
    from repro_torch.kernels import dasha_update as kern
    from repro_torch.kernels import ref
    sub = sim._bound
    c, d = int(sub.c), int(sim.comp.spec.d)
    plan = RoundRandom(0, 0).plan(sub.cohort_rc)
    scale = float(plan.scale) * (sub.n / float(c))
    mask = plan.mask.to(torch.float32).contiguous() if plan.mask is not None \
        else indices_to_masks(plan.indices, d)
    if int(mask.sum()) != c * K_RANDK:
        raise AssertionError("[fed] the cohort plan's mask is not RandK")
    r = _check_dasha(torch, kern, ref, (c, d), False, 160, a=sim.hyper.a,
                     scale=scale, mask=mask)
    r = {"shape": [c, d], "misaligned": False, "path": "fed", "a": sim.hyper.a,
         "scale": scale, **r}
    log(f"[kernels] dasha_update ({c}, {d}) at the federated scale "
        f"{scale:.6g}, a {sim.hyper.a:.6g}: err {r['max_abs_err']:.3g}  call "
        f"{r['ms']:.4f} ms  device {r['device_ms']} ms  plain "
        f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms | {smi}")
    return r


def _fed_draws(sim, problem_cpu, variant, hp, rounds, seed):
    """Every round's randomness drawn on the CPU (cohort, the cohort's
    plan, PAGE's coin, samples), for injection into both devices."""
    from repro_torch.core.rng import Draws, RoundRandom
    sub = sim._bound
    out = []
    for t in range(rounds):
        rnd = RoundRandom(seed, t)
        cohort = rnd.cohort(sub.n, sub.c) if sub.samples_clients else None
        rc = sub.cohort_rc if cohort is not None else sub.rc
        clients = cohort if cohort is not None else list(range(sub.n))
        samples = page_coin = None
        if variant == "page":
            page_coin = rnd.coin(hp.p, "page")
            rows = problem_cpu if cohort is None else dataclasses.replace(
                problem_cpu, features=problem_cpu.features[cohort],
                labels=problem_cpu.labels[cohort])
            samples = rnd.samples(rows, hp.batch)
        elif hasattr(problem_cpu, "stoch_grad"):
            samples = rnd.client_samples(problem_cpu, hp.batch, clients)
        out.append(Draws(plan=rnd.plan(rc), page_coin=page_coin,
                         samples=samples, cohort=cohort))
    return out


def phase_fed_agreement(torch):
    """The example's shape on the card and on the CPU with the same
    injected CPU draws (phase 12a): exact byte and participant traces,
    metrics within 1e-4; then slab vs scatter on the card, bit for bit, at
    n = 10,000, C = 64, d = 20,958 over 128 rounds (phase 12b)."""
    import numpy as np
    from repro_torch.core.oracles import FiniteSumProblem, StochasticProblem
    from repro_torch.data.pipeline import (synthetic_classification,
                                           synthetic_quadratic)

    n, m, d, k, rounds, seed = 256, 8, 40, 8, 60, 7
    feats, labels = synthetic_classification(0, n, m, d, device="cpu")
    L = float(torch.mean(torch.sum(feats ** 2, -1)) * 2)
    glm = {dev: FiniteSumProblem(_glm_loss(torch), feats.to(dev),
                                 labels.to(dev)) for dev in ("cpu", "cuda")}
    A, b = synthetic_quadratic(0, d, device="cpu")

    def stoch(dev):
        Ad, bd = A.to(dev), b.to(dev)

        def loss(x, xi, i):
            return 0.5 * x @ Ad @ x - bd @ x + xi @ x

        def sample(gen, i, batch):
            return 0.3 * torch.randn((batch, d), generator=gen,
                                     device=gen.device)

        return StochasticProblem(loss=loss, sample=sample, n=n, device=dev,
                                 true_grad=lambda x: Ad @ x - bd)

    quad = {dev: stoch(dev) for dev in ("cpu", "cuda")}
    cases = [(v, be, c) for v in ("dasha", "page")
             for be in ("sparse", "fused") for c in (256, 64, 16)] + \
        [("mvr", "sparse", c) for c in (256, 64, 16)]
    hkw = {"dasha": dict(L=L), "page": dict(L=L, B=2, m=m),
           "mvr": dict(L=2.0, B=4, sigma2=0.09 * d)}
    worst = 0.0
    for variant, backend, c in cases:
        probs = quad if variant == "mvr" else glm
        res, draws = {}, None
        for dev in ("cpu", "cuda"):
            # the quadratic's L = 2 leaves no room for the 16x fine-tune
            sim = _fed_sim(probs[dev], n, d, c, variant=variant,
                           backend=backend, device=dev, k=k,
                           hyper_kw=hkw[variant], chunk=16,
                           gamma_mult=1 if variant == "mvr" else 16)
            if draws is None:
                draws = _fed_draws(sim, probs["cpu"], variant,
                                   sim.hyper, rounds, seed)
                # one initial state: a stochastic init draws its samples
                # from the device's own generator
                state0 = sim.init(torch.zeros(d), 1, device="cpu")
            dev_draws = [_draws_to(dr, dev) for dr in draws]
            state = state0._replace(**{
                f: getattr(state0, f).to(dev)
                for f in ("x", "g", "g_local", "h_local")})
            res[dev] = sim.run(state, rounds, draws=lambda t: dev_draws[t])
        tag = f"{variant}/{backend}/C={c}"
        for key in ("bytes_up", "value_bytes", "bytes_down",
                    "participants", "bits_sent"):
            if not np.array_equal(res["cuda"].traces[key],
                                  res["cpu"].traces[key]):
                raise AssertionError(f"[fed-agree] {tag}: {key} differs")
        wall_rel = float(np.max(np.abs(
            res["cuda"].traces["sim_wall_clock"]
            / res["cpu"].traces["sim_wall_clock"] - 1)))
        a, b_ = res["cuda"].traces["metric"], res["cpu"].traces["metric"]
        if not (np.all(np.isfinite(a)) and np.all(np.isfinite(b_))):
            raise AssertionError(f"[fed-agree] {tag}: non-finite metric")
        rel = float(np.max(np.abs(a - b_) / np.abs(b_)))
        worst = max(worst, rel)
        if not (rel <= 1e-4 and wall_rel <= 1e-6):
            raise AssertionError(f"[fed-agree] {tag}: metric rel err {rel}"
                                 f", wall clock rel err {wall_rel}")
    log(f"[fed-agree] dasha/page x randk sparse/fused and mvr (stochastic)"
        f" x C in (256, 64, 16), n={n} d={d}, {rounds} rounds with "
        f"injected CPU draws: bytes/participants/bits equal, metric max "
        f"rel err {worst:.3g} (limit 1e-4)")

    # slab vs scatter on the card, the port's own draws
    n2, c2, rounds2 = 10000, 64, 128
    feats2, labels2 = synthetic_classification(1, n2, 1, D_REALSIM,
                                               device="cuda")
    prob2 = FiniteSumProblem(_glm_loss(torch), feats2, labels2)
    L2 = float((feats2.norm(dim=-1) ** 2).mean() * 2)
    runs = {}
    for store in ("slab", "scatter"):
        sim = _fed_sim(prob2, n2, D_REALSIM, c2, store=store,
                       hyper_kw=dict(L=L2), chunk=FED_CHUNK)
        state = sim.init(torch.zeros(D_REALSIM, device="cuda"), 3,
                         device="cuda")
        runs[store] = sim.run(state, rounds2,
                              metric_fn=lambda s: torch.sum(s.g ** 2))
        del state
    a, b_ = runs["slab"], runs["scatter"]
    for key in a.traces:
        if not np.array_equal(a.traces[key], b_.traces[key]):
            raise AssertionError(f"[fed-agree] slab vs scatter: {key}")
    for f in ("x", "g", "g_local", "h_local"):
        if not torch.equal(getattr(a.state, f), getattr(b_.state, f)):
            raise AssertionError(f"[fed-agree] slab vs scatter: {f}")
    log(f"[fed-agree] slab == scatter bit for bit on the card: n={n2} "
        f"C={c2} d={D_REALSIM}, {rounds2} rounds (traces and final state)")
    del runs, a, b_, feats2, labels2, prob2
    torch.cuda.empty_cache()
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
    trainer, train_launches = phase_trainer(torch)
    launches["dasha_mvr_update"] = train_launches["dasha_mvr_update"]
    train_rel = phase_trainer_agreement(torch)
    ssd_rows = phase_ssd_kernel(torch, smi)
    serving, launches["ssd_chunk"] = phase_serve(torch, smi)
    serve_rel = phase_serve_agreement(torch)
    slab_rows = phase_slab_kernel(torch, smi)
    fed, fed_launches, fed_dasha = phase_fed_main(torch, smi)
    per_shape["dasha_update"].append(fed_dasha)
    fed_rel = phase_fed_agreement(torch)
    launches["slab_writeback"] = fed_launches["slab_writeback"]
    # kernel 1 runs on two main paths: the flat round and the federated
    # cohort round (each counted from zero around its own run)
    flat_dasha = launches["dasha_update"]
    launches["dasha_update"] += fed_launches["dasha_update"]

    sources = {"dasha_update": "src/repro/kernels/dasha_update.py:70",
               "dasha_mvr_update": "src/repro/kernels/dasha_update.py:90",
               "quantize": "src/repro/kernels/dasha_update.py:129"}
    # the row each kernel reports: the flat path's (5, 20958); for the MVR
    # kernel the trainer's largest leaf, the tied embedding (4, 77463552)
    headline = {"dasha_update": 0, "quantize": 0, "dasha_mvr_update": 1}
    kernels = []
    for name, rows in per_shape.items():
        main_shape = rows[headline[name]]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dasha_update.cu",
            "replaces": sources[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"], "library_ms": None,
            "shapes": rows})
        if name == "dasha_mvr_update":
            kernels[-1]["per_round"] = {
                k: trainer[k] for k in ("kernel_device_ms_per_round",
                                        "kernel_bound_ms_per_round",
                                        "kernel_share_of_profiled_round")}
    # the SSD kernel's row: one layer of the serving prefill in bf16
    main_shape = ssd_rows[0]
    kernels.append({
        "name": "ssd_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_chunk.py:62",
        "launches": launches["ssd_chunk"],
        "max_abs_err": max(r["max_abs_err"] for r in ssd_rows),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": None,
        "shapes": ssd_rows,
        # its device time in the profiled 48-layer prefill call (phase 8a)
        "per_layer": {k: serving["prefill"][k] for k in (
            "ssd_chunk_profiled_launches", "ssd_chunk_device_ms_per_layer",
            "ssd_chunk_bound_ms_per_layer", "ssd_chunk_share_of_call")}})
    next(r for r in kernels if r["name"] == "dasha_update")[
        "launches_by_path"] = {"flat": flat_dasha,
                               "fed": fed_launches["dasha_update"]}
    # the slab kernel's row: the cell's chunk slab, set
    main_shape = slab_rows[0]
    kernels.append({
        "name": "slab_writeback", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/slab_writeback.cu",
        "replaces": "src/repro/kernels/slab_writeback.py:38",
        "launches": launches["slab_writeback"],
        "max_abs_err": max(r["max_abs_err"] for r in slab_rows),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"], "shapes": slab_rows,
        # its device time in phase 11's profiled chunk (two launches)
        "per_chunk": {k: fed["profiled_chunk"][k] for k in (
            "slab_writeback_launches", "slab_writeback_device_ms",
            "slab_writeback_bound_ms", "union_rows")}})
    for row in kernels:
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']} was never launched on the "
                                 "main path")
    report = {"kernels": kernels, "main_path": runs,
              "agreement_max_rel_err": rel, "trainer": trainer,
              "trainer_agreement_worst": train_rel, "serve": serving,
              "serve_agreement_worst": serve_rel, "fed": fed,
              "fed_agreement_worst": fed_rel, "nvidia_smi": smi}
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

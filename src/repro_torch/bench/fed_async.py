"""Asynchronous pipelining bench: what retiring the round barrier is worth
in wall clock (port of ``benchmarks/fed_async_bench.py``, DESIGN.md §14).

1. **Wall clock to target against straggler severity**
   (:func:`severity_sweep`).  DASHA and MARINA run with round barriers
   (``tau=None``) and pipelined (``tau=2``) through
   :class:`repro_torch.fed.VecFedSim` on one GLM problem, one compressor
   and the same network draws (common random numbers: the per-round
   streams stay valid while rounds overlap in flight).  The clock stops at
   the landing of the first round whose metric crosses a fixed target, so
   a method banks the pipelining only if the staleness does not cost it
   rounds.  Gates: async DASHA strictly beats its barrier run at every
   high severity, the advantage widens as the tail grows, and MARINA's
   async/barrier ratio stays above DASHA's (its sync coins flush the
   pipeline, ``pipeline_coin_flush``).

2. **Payload reconciliation.**  Pipelining reschedules rounds and never
   reprices them: the async runs' per-round ``bytes_up`` equal the barrier
   runs' exactly, and the mean bytes per node sit on the accounting
   expectation.

3. **Depth** (:func:`tau_sweep`): DASHA's wall clock against tau at the
   highest severity, non-increasing.

4. **Implementation equivalence** (:func:`equivalence_check`).  At small
   n the heap oracle and the vectorized simulator agree (integer traces
   exactly, clocks to float32 tolerance), and ``tau=0`` reproduces both
   barrier simulators bit for bit.

The shape, compressor backend, rounds, severities and device are
parameters with the reference's full-size values as defaults (its quick
size: d = 512, 120 rounds, sigma in {0, 1, 2}).  The data are the port's
own synthetic draw from the reference's seed, and the port draws its own
RandK supports and coins, so only numbers that depend on the link draws
and static byte counts alone can equal the reference's: DASHA's clocks.

    PYTHONPATH=src python -m repro_torch.bench.run --only fed_async \\
        [--device cpu]
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.bench.common import (emit, glm_problem, lipschitz_glm,
                                      theory_hyper)
from repro_torch.bench.fed_faults import (compare_heap_vec, make_problem,
                                          same_run)
from repro_torch.compress import make_round_compressor
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.oracles import FiniteSumProblem
from repro_torch.fed import Constant, FedSim, LinkModel, Lognormal, VecFedSim
from repro_torch.fed import wire
from repro_torch.methods import FlatSubstrate
from repro_torch.methods.accounting import expected_wire_coords
from repro_torch.methods.rules import get_rule

D = 2048                 # the reference's full size (its quick size: 512)
N = 20
M = 8                    # samples per node (compute is not the point)
ROUNDS = 300             # (quick: 120)
TAU = 2
SIGMAS = (0.0, 0.5, 1.0, 1.5, 2.0)       # (quick: 0, 1, 2)
HIGH_SIGMA = 1.0         # "high severity": sigmas >= this
MARINA_P = 0.15          # frequent enough coins to see the flush
SEED = 7                 # the simulators' network seed
TAUS = (0, 1, 2, 4)
TAU_SWEEP_ROUNDS = 150

#: WAN-like links; the uplink carries the straggler tail
UP_BW, DOWN_BW, LATENCY = 1e6, 1e8, 1e-3

#: the traces that are integer functions of the engine's randomness
INT_TRACES = ("bytes_up", "value_bytes", "bytes_down", "sync_round",
              "participants")


def links(sigma: float) -> Dict[str, LinkModel]:
    strag = Lognormal(sigma) if sigma > 0 else Constant()
    return dict(uplink=LinkModel(latency_s=LATENCY, bandwidth_Bps=UP_BW,
                                 straggler=strag),
                downlink=LinkModel(latency_s=LATENCY,
                                   bandwidth_Bps=DOWN_BW))


def bench_hyper(variant: str, omega: float, L: float, *, d: int, k: int,
                n: int, m: int):
    """The theory hyperparameters, MARINA's coin probability raised to
    :data:`MARINA_P`."""
    hp = theory_hyper(variant, omega, L, d=d, k=k, n=n, m=m)
    if variant == "marina":
        hp = dataclasses.replace(hp, p=max(hp.p, MARINA_P))
    return hp


def run_campaign(variant, rc, sub, hp, sigma: float, tau: Optional[int],
                 rounds: int, *, cls=VecFedSim, metric_fn=None,
                 compute_s: float = 0.0, seed: int = SEED, **kw):
    """One campaign from x0 = 0 (init seed 1) on the bench's links at
    severity ``sigma``; returns (result, host seconds of ``run``)."""
    sim = cls(variant, rc, sub, hp, compute_s=compute_s, seed=seed,
              tau=tau, **links(sigma), **kw)
    dev = rc.device
    st = sim.init(torch.zeros(sub.d, device=dev), 1, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = sim.run(st, rounds, metric_fn=metric_fn)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return res, time.perf_counter() - t0


def wall_to_target(res, target: float) -> float:
    """Seconds until the metric first crosses ``target``: that round's
    landing (the server cannot report progress it has not seen)."""
    hit = np.nonzero(res.traces["metric"] <= target)[0]
    if hit.size == 0:
        return float("inf")
    return float(res.traces["sim_wall_clock"][hit[0]])


def campaign_setup(problem, backend: str, k: Optional[int]):
    """(n, m, d, k, the flat substrate, the RandK compressor, L) of the
    bench's campaigns on ``problem``; ``k`` defaults to the reference's
    ``max(d // 64, 8)``."""
    n, m, d = (int(s) for s in problem.features.shape)
    k = max(d // 64, 8) if k is None else int(k)
    sub = FlatSubstrate(problem, n, d)
    rc = make_round_compressor("randk", d, n, k=k, backend=backend,
                               device=problem.features.device)
    return n, m, d, k, sub, rc, lipschitz_glm(problem)


def severity_sweep(problem: Optional[FiniteSumProblem] = None, *,
                   d: int = D, n: int = N, m: int = M,
                   k: Optional[int] = None, backend: str = "sparse",
                   rounds: int = ROUNDS, sigmas: Sequence[float] = SIGMAS,
                   tau: int = TAU, device=DEFAULT_DEVICE, metric_fn=None,
                   keep_runs: bool = False) -> Dict:
    """Experiments 1 and 2: wall clock to target and byte identity.
    ``problem`` (an (n, m, d) GLM) replaces the bench's own; ``k``
    defaults to the reference's ``max(d // 64, 8)``.  ``keep_runs`` adds
    the campaigns' results under ``"runs"``."""
    if problem is None:
        problem = make_problem(d, n, m, device=resolve_device(device))
    n, m, d, k, sub, rc, L = campaign_setup(problem, backend, k)
    variants = {v: bench_hyper(v, rc.omega, L, d=d, k=k, n=n, m=m)
                for v in ("dasha", "marina")}
    sigmas = [float(s) for s in sigmas]

    runs = {v: {"barrier": [], "async": []} for v in variants}
    host = {v: {"barrier": [], "async": []} for v in variants}
    bytes_identical = True
    for sigma in sigmas:
        for v, hp in variants.items():
            for mode, t in (("barrier", None), ("async", tau)):
                r, s = run_campaign(v, rc, sub, hp, sigma, t, rounds,
                                    metric_fn=metric_fn)
                runs[v][mode].append(r)
                host[v][mode].append(s)
            # pipelining reschedules rounds; it must not reprice them
            if not np.array_equal(runs[v]["barrier"][-1].traces["bytes_up"],
                                  runs[v]["async"][-1].traces["bytes_up"]):
                bytes_identical = False

    # one fixed target every run reaches: the worst final metric seen
    target = max(float(r.traces["metric"][-1])
                 for v in runs for mode in runs[v] for r in runs[v][mode])
    wall = {v: {mode: [wall_to_target(r, target) for r in runs[v][mode]]
                for mode in runs[v]} for v in runs}
    ratio = {v: [a / b for a, b in zip(wall[v]["async"],
                                       wall[v]["barrier"])] for v in wall}
    gap = {v: [b - a for a, b in zip(wall[v]["async"],
                                     wall[v]["barrier"])] for v in wall}

    hi = [i for i, s in enumerate(sigmas) if s >= HIGH_SIGMA]
    dasha_strict = all(wall["dasha"]["async"][i]
                       < wall["dasha"]["barrier"][i] for i in hi)
    # the advantage widens with the tail (common random numbers)
    widening = all(gap["dasha"][i + 1] >= gap["dasha"][i] * 0.95
                   for i in range(len(sigmas) - 1)) \
        and gap["dasha"][-1] > gap["dasha"][0]
    # MARINA's coin flushes cap its gain relative to DASHA's
    marina_capped = all(ratio["marina"][i] > ratio["dasha"][i] for i in hi)

    # accounting: the mean measured bytes per node against the expectation
    wire_coords = rc.spec.wire_coords("independent")
    recon = {}
    for v, hp in variants.items():
        ra = runs[v]["async"][-1]
        measured = float(ra.traces["bytes_up"].mean() / n) \
            - wire.HEADER_BYTES
        rule = get_rule(v)
        p = hp.p if rule.has_sync else 0.0
        expected = 4 * expected_wire_coords(rule, hp, wire_coords, float(d))
        tol = 4 * 4.0 * np.sqrt(max(p * (1 - p), 1e-12) / rounds) \
            * (d - wire_coords)
        recon[v] = {"measured_wire_bytes_per_node": measured,
                    "expected_wire_bytes_per_node": expected,
                    "ok": bool(abs(measured - expected) <= tol + 1e-9)}

    out = {
        "d": d, "n": n, "m": m, "k": k, "backend": backend,
        "sigmas": sigmas, "tau": tau, "rounds": rounds,
        "target_metric": target,
        "wall_to_target_s": wall,
        "async_over_barrier_ratio": ratio,
        "advantage_gap_s": gap,
        "wall_clock_s": {v: {mode: [float(r.summary["wall_clock_s"])
                                    for r in runs[v][mode]]
                             for mode in runs[v]} for v in runs},
        "host_s": host,
        "sync_rounds_async": {v: float(runs[v]["async"][-1]
                                       .traces["sync_round"].sum())
                              for v in runs},
        "dasha_async_strictly_faster": bool(dasha_strict),
        "advantage_widens_with_severity": bool(widening),
        "marina_capped_by_coin_flush": bool(marina_capped),
        "bytes_up_bit_identical_async_vs_barrier": bool(bytes_identical),
        "payload_reconciliation": recon,
        "payload_reconciles": bool(
            bytes_identical and all(r["ok"] for r in recon.values())),
    }
    if keep_runs:
        out["runs"] = runs
    return out


def tau_sweep(problem: Optional[FiniteSumProblem] = None, *,
              d: int = D, n: int = N, m: int = M, k: Optional[int] = None,
              backend: str = "sparse", rounds: int = ROUNDS,
              taus: Sequence[int] = TAUS, sigma: float = 2.0,
              device=DEFAULT_DEVICE, metric_fn=None) -> Dict:
    """Experiment 3: DASHA's campaign wall clock against the pipeline
    depth at the highest severity, over ``min(rounds, 150)`` rounds (the
    depth saturates once the gate stops binding)."""
    if problem is None:
        problem = make_problem(d, n, m, device=resolve_device(device))
    n, m, d, k, sub, rc, L = campaign_setup(problem, backend, k)
    hp = bench_hyper("dasha", rc.omega, L, d=d, k=k, n=n, m=m)
    walls, host = [], []
    for t in taus:
        r, s = run_campaign("dasha", rc, sub, hp, sigma, t,
                            min(rounds, TAU_SWEEP_ROUNDS),
                            metric_fn=metric_fn)
        walls.append(float(r.summary["wall_clock_s"]))
        host.append(s)
    return {"taus": [int(t) for t in taus], "sigma": sigma,
            "rounds": min(rounds, TAU_SWEEP_ROUNDS), "wall_clock_s": walls,
            "host_s": host,
            "monotone_nonincreasing": bool(
                all(b <= a * (1 + 1e-9) for a, b in zip(walls, walls[1:])))}


def equivalence_check(*, n: int = 5, d: int = 64, k: int = 8, m: int = 8,
                      rounds: int = 40, tau: int = TAU,
                      device=DEFAULT_DEVICE) -> Dict:
    """Experiment 4: heap == vec at small n and tau = 2; tau = 0 == the
    barrier, bit for bit, in both simulators."""
    dev = resolve_device(device)
    problem = glm_problem(d=d, m=m, device=dev)
    sub = FlatSubstrate(problem, n, d)
    rc = make_round_compressor("randk", d, n, k=k, backend="sparse",
                               device=dev)
    hp = theory_hyper("dasha", rc.omega, lipschitz_glm(problem), d=d, k=k,
                      n=n, m=m)

    def run(cls, t):
        return run_campaign("dasha", rc, sub, hp, 1.5, t, rounds, cls=cls,
                            compute_s=0.002, seed=3)[0]

    cmp = compare_heap_vec(run(FedSim, tau), run(VecFedSim, tau),
                           INT_TRACES)
    wall_ok = cmp["wall_clock_rel_err"] <= 2e-5
    tau0_ok = all(same_run(run(cls, None), run(cls, 0))
                  for cls in (FedSim, VecFedSim))
    return {"n": n, "d": d, "rounds": rounds, "tau": tau,
            "heap_vec_integer_traces_bit_exact":
                cmp["integer_traces_bit_exact"],
            "heap_vec_wall_clock_close": bool(wall_ok),
            "tau0_reproduces_barrier_bit_exact": bool(tau0_ok),
            "ok": bool(cmp["integer_traces_bit_exact"] and wall_ok
                       and tau0_ok)}


def run(*, device=DEFAULT_DEVICE, rounds_scale: float = 1.0):
    """The experiments at the reference's full size (``rounds_scale``
    multiplies the sweeps' rounds); CSV rows as the reference's."""
    rounds = max(int(ROUNDS * rounds_scale), 1)
    sev = severity_sweep(rounds=rounds, device=device)
    depth = tau_sweep(rounds=rounds, device=device)
    equiv = equivalence_check(device=device)
    ok = bool(sev["dasha_async_strictly_faster"]
              and sev["advantage_widens_with_severity"]
              and sev["marina_capped_by_coin_flush"] and equiv["ok"])
    cols = ["bench", "sigma", "tau", "wall_dasha_barrier_s",
            "wall_dasha_async_s", "wall_marina_barrier_s",
            "wall_marina_async_s", "wall_s", "ok"]
    blank = {c: "" for c in cols}
    rows: List[Dict] = []
    w = sev["wall_to_target_s"]
    for i, sigma in enumerate(sev["sigmas"]):
        rows.append(dict(
            blank, bench="fed_async_severity", sigma=sigma,
            wall_dasha_barrier_s=round(w["dasha"]["barrier"][i], 4),
            wall_dasha_async_s=round(w["dasha"]["async"][i], 4),
            wall_marina_barrier_s=round(w["marina"]["barrier"][i], 4),
            wall_marina_async_s=round(w["marina"]["async"][i], 4)))
    for t, wall in zip(depth["taus"], depth["wall_clock_s"]):
        rows.append(dict(blank, bench="fed_async_tau", tau=t,
                         wall_s=round(wall, 4)))
    rows.append(dict(blank, bench="fed_async_gates",
                     ok=ok and sev["payload_reconciles"]
                     and depth["monotone_nonincreasing"]))
    rows.append(dict(blank, bench="fed_async_equiv", ok=equiv["ok"]))
    return rows


if __name__ == "__main__":
    emit(run())

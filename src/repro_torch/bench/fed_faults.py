"""Fault-tolerance bench: graceful degradation against sync-barrier retry
amplification (port of ``benchmarks/fed_faults_bench.py``, DESIGN.md §18).

1. **Degradation sweep** (:func:`degradation_sweep`).  DASHA (graceful:
   the server closes each round with whoever delivered) and MARINA (sync
   barrier: missing clients are re-requested with exponential backoff)
   run the same seeded fault campaign, an uplink drop-rate grid 0 -> 20%
   plus a fixed crash process, through :class:`repro_torch.fed.VecFedSim`.
   Gates (``graceful_degradation_ok``):

   * DASHA's math stays finite and its final metric within
     ``METRIC_FACTOR`` of the fault-free run at every drop rate;
   * DASHA's wall-clock inflation is bounded by the deadline policy (a cut
     round costs ``deadline_mult`` x nominal, never more);
   * MARINA's iterates are bit-identical at every drop rate (retries
     recover every message) but its wall clock and uplink bytes blow past
     DASHA's at the top of the grid.

2. **Implementation equivalence** (:func:`equivalence_check`).  At small
   n the heap oracle and the vectorized simulator realize the same faulted
   campaign: every integer byte and fault trace bit-exact, clocks to carry
   tolerance.

3. **Observability is build-free** (:func:`obs_compile_check`).  A warmed
   faulted campaign run again with ``Obs.metrics_only(MemorySink())``
   attached builds no kernel (the handle's ``compiles`` counter, fed by
   :func:`repro_torch.kernels.build.subscribe`, stays 0), and its final
   state and traces equal the plain run's bit for bit: the port's form of
   the reference's zero-recompile gate (``faulted_obs_compile_free``).

The shape, compressor backend, rounds and device are parameters with the reference's values as defaults; the data are the
port's own synthetic draw from the reference's seed, so only quantities
that depend on the fault and link draws alone can equal the reference's
numbers (DASHA's bytes, clocks and fault counts; MARINA's fault counts).

    PYTHONPATH=src python -m repro_torch.bench.run --only fed_faults \\
        [--device cpu]
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.bench.common import (emit, glm_loss, lipschitz_glm,
                                      theory_hyper)
from repro_torch.compress import make_round_compressor
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.oracles import FiniteSumProblem
from repro_torch.data.pipeline import synthetic_classification
from repro_torch.fed import FAULT_TRACES, FaultModel, FedSim, LinkModel, \
    VecFedSim
from repro_torch.methods import FlatSubstrate
from repro_torch.obs import MemorySink, Obs

D = 1024                 # the reference's full size (its quick size: 256)
N = 20
M = 8
ROUNDS = 240             # (quick: 96)
DROP_GRID = (0.0, 0.05, 0.1, 0.2)
P_CRASH, CRASH_ROUNDS = 0.02, 2
DEADLINE_MULT = 3.0
SEED = 7
#: DASHA's accuracy under 20% loss must stay within this factor of the
#: fault-free final metric: "degrades smoothly", not "diverges"
METRIC_FACTOR = 10.0

UP_BW, DOWN_BW, LATENCY = 1e6, 1e8, 1e-3
NET_SEED = 3             # the simulators' network seed

#: the traces that are integer functions of the engine and fault draws
INT_TRACES = ("bytes_up", "value_bytes", "bytes_down", "sync_round",
              "participants") + FAULT_TRACES


def make_problem(d: int = D, n: int = N, m: int = M, *,
                 device=DEFAULT_DEVICE) -> FiniteSumProblem:
    """The bench's GLM: ``synthetic_classification`` from seed 0."""
    feats, labels = synthetic_classification(0, n, m, d, device=device)
    return FiniteSumProblem(loss=glm_loss, features=feats, labels=labels)


def fault_model(p_drop: float) -> FaultModel:
    return FaultModel(p_crash=P_CRASH, crash_rounds=CRASH_ROUNDS,
                      p_drop_up=p_drop, deadline_mult=DEADLINE_MULT,
                      seed=SEED)


def links() -> Dict[str, LinkModel]:
    return dict(uplink=LinkModel(latency_s=LATENCY, bandwidth_Bps=UP_BW),
                downlink=LinkModel(latency_s=LATENCY,
                                   bandwidth_Bps=DOWN_BW))


def run_campaign(variant, rc, sub, hp, fm, rounds, *, cls=VecFedSim,
                 metric_fn=None, compute_s: float = 0.0, obs=None, **kw):
    """One campaign from x0 = 0 (init seed 1) on the bench's links, with
    the observability handle ``obs`` attached; returns (result, host
    seconds of ``run``)."""
    sim = cls(variant, rc, sub, hp, compute_s=compute_s, seed=NET_SEED,
              faults=fm, **links(), **kw)
    dev = rc.device
    st = sim.init(torch.zeros(sub.d, device=dev), 1, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = sim.run(st, rounds, metric_fn=metric_fn, obs=obs)
    return res, time.perf_counter() - t0


def degradation_sweep(problem: Optional[FiniteSumProblem] = None, *,
                      d: int = D, n: int = N, m: int = M,
                      k: Optional[int] = None, backend: str = "sparse",
                      rounds: int = ROUNDS, device=DEFAULT_DEVICE,
                      metric_fn=None) -> Dict:
    """Experiment 1: the drop-rate grid and the degradation gates.
    ``problem`` (an (n, m, d) GLM) replaces the bench's own; ``k``
    defaults to the reference's ``max(d // 64, 8)``."""
    dev = resolve_device(device)
    if problem is None:
        problem = make_problem(d, n, m, device=dev)
    n, m, d = (int(s) for s in problem.features.shape)
    k = max(d // 64, 8) if k is None else int(k)
    sub = FlatSubstrate(problem, n, d)
    rc = make_round_compressor("randk", d, n, k=k, backend=backend,
                               device=dev)
    L = lipschitz_glm(problem)
    hp = {v: theory_hyper(v, rc.omega, L, d=d, k=k, n=n, m=m)
          for v in ("dasha", "marina")}

    grid: List[Dict] = []
    runs = {"dasha": [], "marina": []}
    for p in DROP_GRID:
        fm = fault_model(p)
        row = {"p_drop_up": p, "p_crash": P_CRASH}
        for v in ("dasha", "marina"):
            r, wall = run_campaign(v, rc, sub, hp[v], fm, rounds,
                                   metric_fn=metric_fn)
            runs[v].append(r)
            row[v] = {
                "final_metric": float(r.traces["metric"][-1]),
                "wall_clock_s": float(r.summary["wall_clock_s"]),
                "bytes_up": int(r.summary["bytes_up"]),
                "wasted_bytes_up": int(r.summary["wasted_bytes_up"]),
                "dropped_rounds": int(r.summary["dropped_rounds"]),
                "retries": int(r.summary["retries"]),
                "retry_capped": int(r.summary["retry_capped"]),
                "mean_participants": float(
                    r.traces["participants"].mean()),
                "host_s": wall,
            }
        grid.append(row)

    base = {v: runs[v][0] for v in runs}
    top = DROP_GRID.index(max(DROP_GRID))

    # MARINA's barrier: faults reschedule its rounds, never reprice its
    # math: iterates and metric bit-identical across the grid
    marina_invariant = all(
        np.array_equal(base["marina"].traces["metric"], r.traces["metric"])
        and torch.equal(base["marina"].state.x, r.state.x)
        for r in runs["marina"][1:])

    # DASHA: finite everywhere, final metric within METRIC_FACTOR of the
    # fault-free run, wall-clock inflation bounded by the deadline policy
    d0 = float(base["dasha"].traces["metric"][-1])
    dasha_finite = all(np.isfinite(r.traces["metric"]).all()
                       for r in runs["dasha"])
    dasha_metric_ok = all(
        float(r.traces["metric"][-1]) <= METRIC_FACTOR * d0
        for r in runs["dasha"])
    wall = {v: [float(r.summary["wall_clock_s"]) for r in runs[v]]
            for v in runs}
    dasha_ratio = [w / wall["dasha"][0] for w in wall["dasha"]]
    marina_ratio = [w / wall["marina"][0] for w in wall["marina"]]
    # a cut round costs deadline_mult x nominal; uncut rounds cost nominal:
    # the campaign can never inflate past the multiplier
    dasha_wall_bounded = all(r <= DEADLINE_MULT + 1e-6 for r in dasha_ratio)
    # the barrier pays in time and bytes at the top of the grid
    marina_pays = (marina_ratio[top] > dasha_ratio[top]
                   and grid[top]["marina"]["bytes_up"]
                   > grid[0]["marina"]["bytes_up"]
                   and grid[top]["marina"]["retries"] > 0)
    ok = bool(marina_invariant and dasha_finite and dasha_metric_ok
              and dasha_wall_bounded and marina_pays)
    return {
        "d": d, "n": n, "m": m, "k": k, "backend": backend,
        "drop_grid": list(DROP_GRID), "rounds": rounds,
        "deadline_mult": DEADLINE_MULT, "metric_factor": METRIC_FACTOR,
        "grid": grid,
        "wall_inflation": {"dasha": dasha_ratio, "marina": marina_ratio},
        "marina_math_invariant": bool(marina_invariant),
        "dasha_metric_within_factor": bool(dasha_metric_ok
                                           and dasha_finite),
        "dasha_wall_bounded_by_deadline": bool(dasha_wall_bounded),
        "marina_pays_in_time_and_bytes": bool(marina_pays),
        "graceful_degradation_ok": ok,
    }


def compare_heap_vec(rh, rv, int_traces=INT_TRACES) -> Dict:
    """The heap and the vectorized result of one campaign: ``int_traces``
    equal, and the clocks' (landings and broadcasts) and the metric's
    largest relative gaps."""
    ints = {t: bool(np.array_equal(rh.traces[t], rv.traces[t]))
            for t in int_traces}

    def rel(key):
        a, b = rv.traces[key], rh.traces[key]
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))

    return {"integer_traces_bit_exact": all(ints.values()),
            "integer_traces": ints,
            "wall_clock_rel_err": max(rel("sim_wall_clock"),
                                      rel("bcast_clock")),
            "metric_rel_err": rel("metric")}


#: the equivalence campaigns' fault models (``tests/test_fed_faults.py``'s
#: FM_MIXED and FM_SYNC)
EQUIV_FAULTS = {
    "dasha": dict(p_crash=0.08, crash_rounds=2, p_drop_up=0.1,
                  p_drop_down=0.05, p_corrupt=0.05, deadline_mult=3.0,
                  rejoin="reset", seed=7),
    "marina": dict(p_crash=0.08, crash_rounds=2, p_drop_up=0.1,
                   p_corrupt=0.05, deadline_mult=3.0, seed=7),
}


def equivalence_check(*, n: int = 5, d: int = 64, k: int = 8, m: int = 8,
                      rounds: int = 40, device=DEFAULT_DEVICE) -> Dict:
    """Experiment 2: heap == vec on one faulted campaign per rule family
    at small n."""
    dev = resolve_device(device)
    problem = make_problem(d, n, m, device=dev)
    sub = FlatSubstrate(problem, n, d)
    rc = make_round_compressor("randk", d, n, k=k, backend="sparse",
                               device=dev)
    L = lipschitz_glm(problem)
    out = {}
    for variant, fkw in EQUIV_FAULTS.items():
        hp = theory_hyper(variant, rc.omega, L, d=d, k=k, n=n, m=m)
        fm = FaultModel(**fkw)
        rh, rv = (run_campaign(variant, rc, sub, hp, fm, rounds, cls=cls,
                               compute_s=0.002)[0]
                  for cls in (FedSim, VecFedSim))
        cmp = compare_heap_vec(rh, rv)
        wall_ok = cmp["wall_clock_rel_err"] <= 2e-5
        out[variant] = {"integer_traces_bit_exact":
                        cmp["integer_traces_bit_exact"],
                        "wall_clock_close": bool(wall_ok),
                        "dropped_rounds": int(rh.summary["dropped_rounds"]),
                        "ok": bool(cmp["integer_traces_bit_exact"]
                                   and wall_ok)}
    out["ok"] = bool(all(out[v]["ok"] for v in EQUIV_FAULTS))
    return out


def same_run(a, b) -> bool:
    """Two results equal bit for bit: every trace and the final state."""
    return set(a.traces) == set(b.traces) \
        and all(np.array_equal(a.traces[k], b.traces[k]) for k in a.traces) \
        and all(torch.equal(getattr(a.state, f), getattr(b.state, f))
                for f in ("x", "g", "g_local", "h_local"))


def obs_compile_check(problem: Optional[FiniteSumProblem] = None, *,
                      d: int = D, n: int = N, m: int = M,
                      k: Optional[int] = None, backend: str = "sparse",
                      rounds: int = ROUNDS, device=DEFAULT_DEVICE) -> Dict:
    """Experiment 3: a faulted DASHA campaign (the grid's 10% drop model)
    run plain, which warms every kernel it needs, then again with a
    metrics handle attached: the second run builds nothing (the handle's
    ``compiles`` counter) and equals the plain one bit for bit."""
    dev = resolve_device(device)
    if problem is None:
        problem = make_problem(d, n, m, device=dev)
    n, m, d = (int(s) for s in problem.features.shape)
    k = max(d // 64, 8) if k is None else int(k)
    sub = FlatSubstrate(problem, n, d)
    rc = make_round_compressor("randk", d, n, k=k, backend=backend,
                               device=dev)
    hp = theory_hyper("dasha", rc.omega, lipschitz_glm(problem), d=d, k=k,
                      n=n, m=m)
    fm = fault_model(0.1)
    plain, _ = run_campaign("dasha", rc, sub, hp, fm, rounds)
    obs = Obs.metrics_only(MemorySink())
    res, _ = run_campaign("dasha", rc, sub, hp, fm, rounds, obs=obs)
    builds = int(obs.metrics.counter("compiles").value)
    identical = same_run(plain, res)
    return {"steady_state_compiles": builds,
            "bit_identical": bool(identical),
            "fed_rounds_counted": int(obs.metrics.counter(
                "fed.rounds").value),
            "compile_free": bool(builds == 0 and identical)}


def report(*, device=DEFAULT_DEVICE, rounds_scale: float = 1.0) -> Dict:
    """The three experiments at the reference's full size (``rounds_scale``
    multiplies the sweep's rounds), in the layout of the reference's
    ``BENCH_faults.json``."""
    rounds = max(int(ROUNDS * rounds_scale), 1)
    sweep = degradation_sweep(rounds=rounds, device=device)
    equiv = equivalence_check(device=device)
    obs = obs_compile_check(rounds=rounds, device=device)
    return {
        "config": {"d": D, "k": sweep["k"], "n": N, "rounds": rounds,
                   "p_crash": P_CRASH, "crash_rounds": CRASH_ROUNDS,
                   "deadline_mult": DEADLINE_MULT, "uplink_Bps": UP_BW,
                   "downlink_Bps": DOWN_BW},
        "degradation": sweep, "equivalence": equiv, "obs": obs,
        "graceful_degradation_ok": sweep["graceful_degradation_ok"],
        "faulted_heap_vec_bit_exact": equiv["ok"],
        "faulted_obs_compile_free": obs["compile_free"],
    }


def run(*, device=DEFAULT_DEVICE, rounds_scale: float = 1.0):
    """:func:`report` as CSV rows, the reference's."""
    rep = report(device=device, rounds_scale=rounds_scale)
    sweep = rep["degradation"]
    cols = ["bench", "p_drop", "wall_dasha_s", "wall_marina_s",
            "metric_dasha", "retries_marina", "ok"]
    blank = {c: "" for c in cols}
    rows = []
    for i, p in enumerate(DROP_GRID):
        g = sweep["grid"][i]
        rows.append(dict(
            blank, bench="fed_faults_grid", p_drop=p,
            wall_dasha_s=round(g["dasha"]["wall_clock_s"], 4),
            wall_marina_s=round(g["marina"]["wall_clock_s"], 4),
            metric_dasha=float(f"{g['dasha']['final_metric']:.3e}"),
            retries_marina=g["marina"]["retries"]))
    rows.append(dict(blank, bench="fed_faults_gates",
                     ok=rep["graceful_degradation_ok"]))
    rows.append(dict(blank, bench="fed_faults_equiv",
                     ok=rep["faulted_heap_vec_bit_exact"]))
    rows.append(dict(blank, bench="fed_faults_obs",
                     ok=rep["faulted_obs_compile_free"]))
    return rows


if __name__ == "__main__":
    emit(run())

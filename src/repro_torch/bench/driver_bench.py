"""Driver throughput: per-step Python experiment loops against the chunked
driver (port of ``benchmarks/driver_bench.py``, DESIGN.md §10).

    PYTHONPATH=src python -m repro_torch.bench.driver_bench [--device cpu]
        [--rounds-scale 0.1] [--out driver.json]

Cases (rows keep the reference's fields; ``steady_state_compiles`` is
``steady_state_builds``, the kernel builds a warmed region made,
:func:`repro_torch.analysis.recompile.watch`, since the port's only
compiler is ``nvcc``):

* ``smoke_lm_tune`` — the paper's powers-of-two stepsize tune (8 gammas)
  at the smoke LM config (starcoder2-3b's).  Old harness: one Python loop
  per gamma, a fresh ``make_train_step`` for each stepsize (the reference
  rebuilds and recompiles its jitted step; here the rebuild costs only
  Python), eager per-step batches, a host ``float()`` of the eval loss per
  run.  New: ONE :class:`~repro_torch.methods.Sweeper` over 8 lanes on the
  tree substrate, data drawn per round by the driver.  steps/s counts
  method-steps of all lanes.
* ``smoke_lm_single`` — one training run: ``launch/train.py``'s old loop
  shape (eager batch, train step, ``float()`` of the eval loss and of
  ``g_norm_sq`` on log steps) against the :class:`~repro_torch.methods.
  Driver` (metrics kept on the device, one transfer a chunk).
* ``flat_1e6`` — a flat d = 1e6 stochastic problem, research-loop shape
  (per-step ``method.step`` and a host metric read each round) against the
  Driver's chunk.  The reference's default (dense) backend becomes the
  port's ``fused`` one, the main path's kernel 1.

Both loop shapes of a case draw the same randomness: the method's rounds
are keyed by ``(seed, t)`` and round t's batch by ``derive_seed(data_seed,
t, "data")``, so each row also says how far apart their final states are
(``final_state_max_abs_diff``; the tune compares lane j of the sweep with
the per-gamma loop at gamma j).  Each pair runs the same ops on the same
values in the same order (a sweep lane's forward and backward run on its
own iterate, and its Adam step scales by its own gamma), so they end bit
for bit equal, on the CPU and on the card.

``REPRO_BENCH_QUICK=1`` shrinks gammas / steps / d for smoke runs and then
asserts that the warmed loops built nothing; ``--rounds-scale`` multiplies
every case's steps (at least 2).  A JSON is written only where ``--out``
points (the reference's ``BENCH_driver.json`` stays the reference's).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.analysis import recompile
from repro_torch.bench.common import emit
from repro_torch.compress import make_round_compressor
from repro_torch.configs import get_smoke_config
from repro_torch.core import tree
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.oracles import StochasticProblem
from repro_torch.core.rng import derive_seed, generator
from repro_torch.data.pipeline import SyntheticTextConfig, make_node_batches
from repro_torch.methods import Driver, FlatSubstrate, Hyper, Method, Sweeper
from repro_torch.models import init_params, lm
from repro_torch.optim.distributed import (DashaTrainConfig, dasha_train_init,
                                           make_method, make_train_step)

QUICK = bool(os.environ.get("REPRO_BENCH_QUICK"))
REPS = 1 if QUICK else 3     # best-of-N timing (hosts are noisy)
N_NODES = 4
BATCH, SEQ = 1, 32            # the tune case (keeps 8 lanes x 30 steps fast)
BATCH_1, SEQ_1 = 2, 64        # the single-run case (train.py-like shape)
GAMMA_1 = 0.003               # the single run's stepsize
LOG_EVERY = 10
N_GAMMAS = 4 if QUICK else 8
STEPS_TUNE = 10 if QUICK else 30
STEPS_LM = 20 if QUICK else 40
D_FLAT = int(1e5) if QUICK else int(1e6)
STEPS_FLAT = 20 if QUICK else 50
#: the reference's keys as the port's integer seeds
PARAMS_SEED, STATE_SEED, DATA_SEED, EVAL_SEED, PROBLEM_SEED = 0, 1, 2, 9, 3


def _steps(steps: int, rounds_scale: float) -> int:
    return max(int(steps * rounds_scale), 2)


def _best_sps(fn, steps: int, reps: int, dev) -> float:
    best = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        best = max(best, steps / (time.perf_counter() - t0))
    return best


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _max_abs_diff(a, b) -> float:
    return max((float(torch.max(torch.abs(x.float() - y.float())))
                for x, y in zip(tree.leaves(a), tree.leaves(b))),
               default=0.0)


def _lm_setup(seq: int, dev):
    cfg = get_smoke_config("starcoder2-3b")
    params = init_params(cfg, PARAMS_SEED, device=dev)
    tcfg = SyntheticTextConfig(vocab_size=cfg.vocab_size, seq_len=seq)

    def node_loss(p, b):
        return lm.loss_fn(cfg, p, b)[0]

    def eval_loss(p, b) -> torch.Tensor:
        flat = {k: v.reshape((-1,) + tuple(v.shape[2:]))
                for k, v in b.items()}
        with torch.no_grad():
            return lm.loss_fn(cfg, p, flat)[1]["loss"]

    return cfg, params, tcfg, node_loss, eval_loss


def _dcfg(gamma):
    return DashaTrainConfig(gamma=gamma, compression=1 / 32,
                            n_nodes=N_NODES, server_opt="adam",
                            use_kernel=True)


def _batches(tcfg, batch: int, dev):
    """Round t's node batches, as the Driver's ``data_fn`` receives them."""
    def data_fn(seed, t):
        return make_node_batches(seed, tcfg, N_NODES, batch, device=dev)

    def at(t):
        return data_fn(derive_seed(DATA_SEED, t, "data"), t)
    return data_fn, at


def bench_smoke_lm_tune(dev, n_gammas: int = N_GAMMAS,
                        steps: int = STEPS_TUNE) -> Dict:
    """The powers-of-two stepsize tune: sequential per-gamma loops (a
    fresh train step each) vs ONE chunked sweep of lanes."""
    cfg, params, tcfg, node_loss, eval_loss = _lm_setup(SEQ, dev)
    gammas = tuple(0.0005 * 2 ** i for i in range(n_gammas))
    total = len(gammas) * steps
    data_fn, batch_at = _batches(tcfg, BATCH, dev)
    eval_batch = make_node_batches(EVAL_SEED, tcfg, N_NODES, BATCH,
                                   device=dev)

    def old_tune():
        finals, best = [], None
        for g in gammas:
            dcfg = _dcfg(g)
            st = dasha_train_init(params, dcfg, STATE_SEED, device=dev)
            step = make_train_step(dcfg, node_loss)
            for t in range(steps):
                st, _ = step(st, batch_at(t))
            fl = float(eval_loss(st.params, eval_batch))
            best = fl if best is None else min(best, fl)
            finals.append(st.params)
        return finals

    t0 = time.perf_counter()
    old_finals = old_tune()
    _sync(dev)
    py_sps = total / (time.perf_counter() - t0)   # incl. the per-gamma
    # rebuilds -- inherent to the old harness (a fresh step per stepsize)

    def method_fn(gamma):
        return make_method(_dcfg(gamma), node_loss)

    ms0 = method_fn(gammas[0]).init(params, STATE_SEED, init_mode="zeros",
                                    device=dev)
    sweeper = Sweeper(method_fn, data_fn=data_fn, chunk=LOG_EVERY)

    def new_tune():
        fin, _ = sweeper.run(np.array(gammas), ms0, steps,
                             data_seed=DATA_SEED, device=dev)
        _sync(dev)
        return fin

    t0 = time.perf_counter()
    new_tune()                                    # incl. its first run
    drv_first = total / (time.perf_counter() - t0)
    with recompile.watch("lm_tune_steady") as region:
        t0 = time.perf_counter()
        fin = new_tune()
        drv_sps = total / (time.perf_counter() - t0)
    diff = max(_max_abs_diff(tree.map_leaves(lambda x, j=j: x[j], fin.x),
                             old_finals[j]) for j in range(len(gammas)))
    return {"case": "smoke_lm_tune", "gammas": len(gammas), "steps": steps,
            "python_loop_steps_per_s": round(py_sps, 3),
            "driver_steps_per_s": round(drv_sps, 3),
            "driver_steps_per_s_incl_compile": round(drv_first, 3),
            "speedup": round(drv_sps / py_sps, 2),
            "steady_state_builds": region.count,
            "final_state_max_abs_diff": diff}


def lm_single_driver(dev, setup=None):
    """``smoke_lm_single``'s chunked Driver (metrics on the device) and its
    initial state: ``(driver, state)``; ``setup`` is ``_lm_setup``'s."""
    _, params, tcfg, node_loss, eval_loss = setup or _lm_setup(SEQ_1, dev)
    method = make_method(_dcfg(GAMMA_1), node_loss)
    ms0 = method.init(params, STATE_SEED, init_mode="zeros", device=dev)
    data_fn, _ = _batches(tcfg, BATCH_1, dev)
    drv = Driver(method, data_fn=data_fn,
                 metrics={"loss": lambda s, d: eval_loss(s.x, d),
                          "g_norm_sq": lambda s, d: sum(
                              torch.sum(torch.square(x))
                              for x in tree.leaves(s.g))},
                 metric_every=LOG_EVERY, chunk=LOG_EVERY)
    return drv, ms0


def bench_smoke_lm_single(dev, steps: int = STEPS_LM,
                          reps: int = REPS) -> Dict:
    """One run: ``launch/train.py``'s old per-step loop vs the Driver."""
    cfg, params, tcfg, node_loss, eval_loss = _lm_setup(SEQ_1, dev)
    dcfg = _dcfg(GAMMA_1)
    _, batch_at = _batches(tcfg, BATCH_1, dev)

    # OLD: the pre-driver launch/train.py Python loop
    state = dasha_train_init(params, dcfg, STATE_SEED, device=dev)
    step = make_train_step(dcfg, node_loss)

    def py_loop(state, steps):
        for t in range(steps):
            batch = batch_at(t)
            state, metrics = step(state, batch)
            if t % LOG_EVERY == 0 or t == steps - 1:
                float(eval_loss(state.params, batch))
                float(metrics["g_norm_sq"])
        return state

    py_loop(state, 2)                              # warm up
    py_sps = _best_sps(lambda: py_loop(state, steps), steps, reps, dev)
    py_final = py_loop(state, steps).params

    # NEW: the chunked driver, metrics on the device
    drv, ms0 = lm_single_driver(dev, (cfg, params, tcfg, node_loss,
                                      eval_loss))
    drv.run(ms0, steps, data_seed=DATA_SEED)       # warm up
    _sync(dev)
    with recompile.watch("lm_single_steady") as region:
        drv_sps = _best_sps(
            lambda: drv.run(ms0, steps, data_seed=DATA_SEED), steps, reps,
            dev)
    fin, _ = drv.run(ms0, steps, data_seed=DATA_SEED)
    return {"case": "smoke_lm_single", "steps": steps,
            "d": sum(int(x.numel()) for x in tree.leaves(params)),
            "python_loop_steps_per_s": round(py_sps, 3),
            "driver_steps_per_s": round(drv_sps, 3),
            "speedup": round(drv_sps / py_sps, 2),
            "steady_state_builds": region.count,
            "final_state_max_abs_diff": _max_abs_diff(fin.x, py_final)}


def flat_problem(d: int, dev) -> StochasticProblem:
    """The flat stochastic quadratic: f(x) = x^T diag x / 2 - b^T x with
    additive gradient noise xi of std 0.1 / sqrt(d)."""
    diag = torch.linspace(1.0, 2.0, d, device=dev)
    b = torch.randn((d,), generator=generator(dev, PROBLEM_SEED, "b"),
                    device=dev) / math.sqrt(d)

    def loss(x, xi, i):
        return 0.5 * torch.sum(diag * x * x) - b @ x + xi @ x

    def sample(gen, i, batch):
        return 0.1 * torch.randn((batch, d), generator=gen,
                                 device=dev) / math.sqrt(d)

    return StochasticProblem(loss=loss, sample=sample, n=N_NODES, device=dev,
                             true_grad=lambda x: diag * x - b)


def flat_method(d: int, dev) -> Method:
    """MVR with fused RandK (K = d / 100) on the flat substrate."""
    problem = flat_problem(d, dev)
    comp = make_round_compressor("randk", d, N_NODES, k=max(d // 100, 1),
                                 backend="fused", device=dev)
    hp = Hyper(gamma=0.1, a=0.5, variant="mvr", b=0.2)
    return Method.build("mvr", comp, FlatSubstrate(problem, N_NODES, d), hp)


def flat_metric(s) -> torch.Tensor:
    return torch.sum(torch.square(s.g))


def bench_flat(d: int, dev, steps: int = STEPS_FLAT,
               reps: int = REPS) -> Dict:
    m = flat_method(d, dev)
    st0 = m.init(torch.zeros(d, device=dev), STATE_SEED, init_mode="stoch",
                 device=dev)

    # OLD: per-step method.step + a host metric read per round
    def py_loop(st, steps):
        trace = []
        for _ in range(steps):
            st = m.step(st)
            trace.append(float(flat_metric(st)))
        return st, trace

    py_loop(st0, 2)                                # warm up
    py_sps = _best_sps(lambda: py_loop(st0, steps), steps, reps, dev)
    py_final = py_loop(st0, steps)[0]

    # NEW: the Driver's chunk (metric on the device, one transfer a chunk)
    drv = Driver(m, metrics={"metric": lambda s, d_: flat_metric(s)},
                 chunk=10)
    drv.run(st0, steps)                            # warm up
    _sync(dev)
    with recompile.watch("flat_steady") as region:
        drv_sps = _best_sps(lambda: drv.run(st0, steps), steps, reps, dev)
    fin, _ = drv.run(st0, steps)
    return {"case": f"flat_d{d:.0e}", "steps": steps, "d": d,
            "python_loop_steps_per_s": round(py_sps, 3),
            "driver_steps_per_s": round(drv_sps, 3),
            "speedup": round(drv_sps / py_sps, 2),
            "steady_state_builds": region.count,
            "final_state_max_abs_diff": max(
                _max_abs_diff(getattr(fin, f), getattr(py_final, f))
                for f in ("x", "g", "g_local", "h_local"))}


def payload(cases: List[Dict], dev) -> Dict:
    """The bench's JSON: the reference's keys, with builds for compiles."""
    return {"bench": "driver", "quick": QUICK,
            "steady_state_build_free": all(
                c["steady_state_builds"] == 0 for c in cases),
            "backend": dev.type,
            "note": ("smoke_lm_tune: the paper's stepsize tune -- "
                     "sequential per-gamma Python loops (a fresh train step "
                     "per gamma; eager batches) vs ONE chunked sweep of "
                     "lanes. smoke_lm_single / flat: per-step calls with "
                     "host metric reads vs the Driver's chunk, metrics on "
                     "the device (DESIGN.md §10)."),
            "cases": cases}


def run(*, device=DEFAULT_DEVICE, rounds_scale: float = 1.0,
        out: Optional[str] = None) -> List[Dict]:
    dev = resolve_device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.build_all()       # no case pays a first build
    cases = [bench_smoke_lm_tune(dev, steps=_steps(STEPS_TUNE,
                                                   rounds_scale)),
             bench_smoke_lm_single(dev, steps=_steps(STEPS_LM,
                                                     rounds_scale)),
             bench_flat(D_FLAT, dev, steps=_steps(STEPS_FLAT, rounds_scale))]
    doc = payload(cases, dev)
    if out:
        with open(out, "w") as f:
            json.dump(doc, f, indent=2)
    if QUICK:
        # smoke gate: a warmed driver loop must never build a kernel
        assert doc["steady_state_build_free"], \
            f"warmed driver runs built kernels: {cases}"
    return [dict(bench="driver_bench", **c) for c in cases]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--rounds-scale", type=float, default=1.0)
    ap.add_argument("--out", default=None,
                    help="write the bench's JSON here (default: none)")
    args = ap.parse_args(argv)
    emit(run(device=args.device, rounds_scale=args.rounds_scale,
             out=args.out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

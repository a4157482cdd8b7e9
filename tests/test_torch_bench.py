"""The port's paper benchmarks (``repro_torch.bench``) on the CPU.

* ``table1`` equals the reference's ``benchmarks.table1_complexity.run()``
  row for row, string for string;
* fig1 at its full 800 rounds: DASHA reaches eps in fewer coords than
  MARINA (``speedup_dasha_over_marina`` > 1);
* fig5 at its full 3,000 rounds: the larger momentum's floor lies above
  the theory momentum's (``floor_ordering == "ok"``);
* fig2, fig3 and ``run.py --only`` smoke-run at reduced rounds, with
  finite rows of the reference's columns;
* the quickstart at 50 rounds ends below its x0 ||grad f||^2;
* ``sweep_tune`` keeps the best finite lane;
* the fault bench's degradation sweep at the reference's quick size
  reproduces ``BENCH_faults.json`` wherever the number depends only on
  the numpy fault and link draws, with every gate true;
* the async bench at the reference's quick size reproduces
  ``BENCH_async.json``'s DASHA clocks, with every gate true;
* the fault bench's third experiment: a warmed faulted campaign with a
  metrics handle builds no kernel and equals the plain run bit for bit
  (``faulted_obs_compile_free``, the reference's field, true in both);
* the obs tour (``bench/obs_trace.py``) at 6 rounds writes its four files,
  and its timelines validate and reconcile with the campaigns' bytes.
"""
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks import table1_complexity as ref_table1
from repro_torch.bench import (common, fed_async, fed_faults, fig1_gradient,
                               fig2_finite_sum, fig3_stochastic,
                               fig5_quadratic_pl, obs_trace, quickstart,
                               table1_complexity)
from repro_torch.bench import run as bench_run
from repro_torch.methods import Hyper
from repro_torch.obs import read_jsonl

torch.set_num_threads(1)


def _finite(rows, column):
    return all(math.isfinite(float(r[column])) for r in rows)


def test_table1_equals_the_reference_row_for_row():
    got = table1_complexity.run()
    want = ref_table1.run()
    assert [{k: str(v) for k, v in r.items()} for r in got] == \
        [{k: str(v) for k, v in r.items()} for r in want]


def test_fig1_dasha_reaches_eps_in_fewer_coords_than_marina():
    rows = fig1_gradient.run(device="cpu")
    assert list(rows[0]) == ["bench", "method", "gamma", "grad_sq_final",
                             "coords_to_eps", "rounds", "k", "d", "n"]
    assert [r["method"] for r in rows] == ["dasha", "marina",
                                          "speedup_dasha_over_marina"]
    assert _finite(rows[:2], "coords_to_eps")
    assert rows[2]["coords_to_eps"] > 1.0


def test_fig5_floors_order_as_the_analysis_says():
    rows = fig5_quadratic_pl.run(device="cpu")
    assert list(rows[0]) == ["bench", "momentum", "b", "gamma",
                             "grad_sq_floor"]
    assert _finite(rows[:2], "grad_sq_floor")
    assert rows[2]["momentum"] == "floor_ordering"
    assert rows[2]["grad_sq_floor"] == "ok"


def test_fig2_smoke_run():
    rows = fig2_finite_sum.run(device="cpu", rounds_scale=0.05)
    assert list(rows[0]) == ["bench", "k", "method", "gamma",
                             "grad_sq_tail", "coords_sent"]
    assert [(r["k"], r["method"]) for r in rows] == [
        (k, m) for k in (2, 10, 30) for m in ("dasha_page", "vr_marina")]
    assert _finite(rows, "grad_sq_tail") and _finite(rows, "coords_sent")


def test_fig3_smoke_run():
    rows = fig3_stochastic.run(device="cpu", rounds_scale=0.02)
    assert list(rows[0]) == ["bench", "ratio", "k", "method", "gamma",
                             "grad_sq_tail", "coords_sent"]
    assert len(rows) == 12
    assert {r["method"] for r in rows} == {"dasha_mvr", "dasha_sync_mvr",
                                           "vr_marina_online"}
    assert _finite(rows, "grad_sq_tail") and _finite(rows, "coords_sent")


def test_run_only_selects_by_prefix_and_prints_csv(capsys):
    assert bench_run.main(["--only", "table1,fig5", "--device", "cpu",
                           "--rounds-scale", "0.01"]) == 0
    out = capsys.readouterr().out
    assert "=== fig5_quadratic_pl ===" in out
    assert "=== table1_complexity ===" in out
    assert "=== fig1_gradient ===" not in out
    assert "bench,momentum,b,gamma,grad_sq_floor" in out
    assert "bench,eps,omega,method,rounds,comm_coords" in out
    with pytest.raises(SystemExit, match="no bench matches"):
        bench_run.main(["--only", "fig9", "--device", "cpu"])


def test_quickstart_ends_below_its_start(monkeypatch, capsys):
    monkeypatch.setenv("REPRO_EXAMPLE_ROUNDS", "50")
    out = quickstart.main(["--device", "cpu"])
    assert out["rounds"] == 50
    assert out["grad_sq_final"] < out["grad_sq_x0"]
    assert out["bits_sent"] == 60 + 50 * 10
    assert "final ||grad f||^2" in capsys.readouterr().out


def test_sweep_tune_keeps_the_best_finite_lane():
    """A grid whose largest stepsizes diverge: the tune keeps the lane with
    the smallest finite final metric, and reports its gamma."""
    problem = common.glm_problem(20, 16, device="cpu")
    comp = common.randk_compressor(20, 4, device="cpu")
    metric = common.problem_metric(problem)

    def method_fn(gamma):
        return common.build_method("dasha", problem, comp,
                                   Hyper(gamma=gamma, a=0.2))

    gammas = np.array([0.5, 2.0, 1e4, 1e8])
    st = method_fn(0.0).init(torch.zeros(20), 1, device="cpu")
    best = common.sweep_tune(method_fn, gammas, st, 30, metric_fn=metric)
    finals = []
    for g in gammas:
        _, tr = common.Sweeper(method_fn, metrics={
            "m": common.metric_of_state(metric)}).run(
            np.array([g]), st, 30, device="cpu")
        finals.append(float(tr["m"][0, -1]))
    finite = [f if math.isfinite(f) else math.inf for f in finals]
    assert best["index"] == int(np.argmin(finite))
    assert best["gamma"] == gammas[best["index"]]
    assert best["final"] == pytest.approx(min(finite), rel=1e-6)
    assert best["bits"].shape == (30,)


def test_fed_faults_reproduces_the_reference_bench():
    """``degradation_sweep`` at the reference's quick configuration (d =
    256, n = 20, 96 rounds, sparse RandK) against ``BENCH_faults.json``.
    DASHA's bytes, waste, fault counts and participants depend only on the
    numpy fault and link draws: equal exactly, its simulated wall clock to
    1e-6 relative (float32 round times).  MARINA's fault counts likewise;
    its bytes and clock also follow its sync coins, which the port draws
    itself, so they are compared only where draws are injected
    (``tests/test_torch_faults.py``).  Every gate holds."""
    want = json.loads((Path(__file__).resolve().parents[1]
                       / "BENCH_faults.json").read_text())["degradation"]
    got = fed_faults.degradation_sweep(d=256, n=20, m=8, rounds=96,
                                       backend="sparse", device="cpu")
    assert (got["k"], got["rounds"]) == (8, want["rounds"])
    assert got["drop_grid"] == want["drop_grid"]
    exact = {"dasha": ("bytes_up", "wasted_bytes_up", "dropped_rounds",
                       "retries", "retry_capped", "mean_participants"),
             "marina": ("dropped_rounds", "retries", "retry_capped",
                        "mean_participants")}
    for g, w in zip(got["grid"], want["grid"]):
        assert g["p_drop_up"] == w["p_drop_up"]
        for variant, keys in exact.items():
            for key in keys:
                assert g[variant][key] == w[variant][key], (variant, key)
        assert g["dasha"]["wall_clock_s"] == pytest.approx(
            w["dasha"]["wall_clock_s"], rel=1e-6)
    for gate in ("marina_math_invariant", "dasha_metric_within_factor",
                 "dasha_wall_bounded_by_deadline",
                 "marina_pays_in_time_and_bytes",
                 "graceful_degradation_ok"):
        assert got[gate] is True, gate
        assert want[gate] is True, gate


def test_fed_faults_equivalence_check_holds():
    """The bench's second experiment: the heap oracle and the vectorized
    simulator realize the same faulted campaign (mixed faults with reset
    rejoins for DASHA, the sync model for MARINA), integer traces bit for
    bit, and the faults fired."""
    out = fed_faults.equivalence_check(device="cpu")
    assert out["ok"] is True
    for variant in ("dasha", "marina"):
        assert out[variant]["integer_traces_bit_exact"] is True
        assert out[variant]["dropped_rounds"] > 0


def test_fed_faults_report_has_the_reference_fields_and_is_obs_free(
        capsys):
    """``fed_faults.run`` at a twentieth of its rounds: its report carries
    the reference's top-level fields, ``faulted_obs_compile_free`` true as
    in ``BENCH_faults.json`` (no kernel build, bit-identical results with
    the handle attached), and its CSV the reference's ``fed_faults_obs``
    row."""
    want = json.loads((Path(__file__).resolve().parents[1]
                       / "BENCH_faults.json").read_text())
    rep = fed_faults.report(device="cpu", rounds_scale=0.05)
    assert set(rep) == set(want)
    assert set(want["config"]) - set(rep["config"]) == {"quick"}
    assert rep["faulted_obs_compile_free"] is True
    assert want["faulted_obs_compile_free"] is True
    assert rep["obs"]["steady_state_compiles"] == \
        want["obs"]["steady_state_compiles"] == 0
    assert rep["obs"]["bit_identical"] is True
    assert rep["obs"]["fed_rounds_counted"] == rep["config"]["rounds"] == 12
    rows = fed_faults.run(device="cpu", rounds_scale=0.05)
    assert [r["ok"] for r in rows if r["bench"] == "fed_faults_obs"] == \
        [True]


def test_obs_trace_writes_its_files_and_its_timelines_validate(
        monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("REPRO_EXAMPLE_ROUNDS", "6")
    monkeypatch.chdir(tmp_path)
    out = obs_trace.main(["--device", "cpu"])
    assert out["rounds"] == 6
    for name in obs_trace.FILES:
        assert (tmp_path / name).stat().st_size > 0, name
    for variant in ("dasha", "marina"):
        tl, res = out["timelines"][variant], out["results"][variant]
        assert tl.validate() == []
        sums = tl.round_byte_sums()
        assert np.array_equal(sums["bytes_up"],
                              res.traces["bytes_up"].astype(np.int64))
        doc = json.loads((tmp_path / f"obs_trace_{variant}.json")
                         .read_text())
        assert len(doc["traceEvents"]) > 3 * 6
    assert out["sync_rounds"]["dasha"] == 0
    recs = read_jsonl(str(tmp_path / "obs_trace_metrics.jsonl"))
    last = {(r["labels"]["variant"], r["name"]): r for r in recs}
    assert last[("dasha", "fed.rounds")]["value"] == 6
    assert last[("marina", "fed.rounds")]["value"] == 6
    md = (tmp_path / "obs_trace_stragglers.md").read_text()
    assert "## dasha" in md and "## marina" in md
    assert "no-client-synchronization" in capsys.readouterr().out


def test_fed_async_reproduces_the_reference_bench():
    """``severity_sweep`` and ``tau_sweep`` at the reference's quick
    configuration (d = 512, n = 20, 120 rounds, sigma in {0, 1, 2}, sparse
    RandK) against ``BENCH_async.json``.  DASHA's clocks depend only on the
    numpy link draws and its static byte counts: its wall clock to target
    at every severity, barrier and async, and the tau sweep's four
    campaign wall clocks equal the file's to 1e-6 relative (float32
    landings), and it never flushes.  MARINA's numbers follow its own coin
    draws, which the port makes itself, so they are compared only where
    draws are injected (``tests/test_torch_async.py``).  Every gate
    holds."""
    want = json.loads((Path(__file__).resolve().parents[1]
                       / "BENCH_async.json").read_text())
    ws = want["severity"]
    assert want["config"]["quick"] is True
    sev = fed_async.severity_sweep(d=512, n=20, m=8, rounds=120,
                                   sigmas=ws["sigmas"], backend="sparse",
                                   device="cpu")
    assert (sev["k"], sev["rounds"], sev["tau"], sev["sigmas"]) == \
        (want["config"]["k"], ws["rounds"], ws["tau"], ws["sigmas"])
    for mode in ("barrier", "async"):
        assert sev["wall_to_target_s"]["dasha"][mode] == pytest.approx(
            ws["wall_to_target_s"]["dasha"][mode], rel=1e-6), mode
    assert sev["sync_rounds_async"]["dasha"] == 0.0 \
        == ws["sync_rounds_async"]["dasha"]
    assert sev["sync_rounds_async"]["marina"] > 0
    assert sev["payload_reconciliation"]["dasha"] == \
        ws["payload_reconciliation"]["dasha"]
    for gate in ("dasha_async_strictly_faster",
                 "advantage_widens_with_severity",
                 "marina_capped_by_coin_flush",
                 "bytes_up_bit_identical_async_vs_barrier",
                 "payload_reconciles"):
        assert sev[gate] is True, gate
        assert ws[gate] is True, gate
    depth = fed_async.tau_sweep(d=512, n=20, m=8, rounds=120,
                                backend="sparse", device="cpu")
    assert depth["taus"] == want["tau_sweep"]["taus"]
    assert depth["wall_clock_s"] == pytest.approx(
        want["tau_sweep"]["wall_clock_s"], rel=1e-6)
    assert depth["monotone_nonincreasing"] is True


def test_fed_async_equivalence_check_holds():
    """The bench's last experiment: heap == vec at n = 5, tau = 2 (integer
    traces bit for bit, clocks within 2e-5), and tau = 0 == the barrier in
    both simulators, bit for bit."""
    out = fed_async.equivalence_check(device="cpu")
    assert out == dict(out, ok=True, heap_vec_integer_traces_bit_exact=True,
                       heap_vec_wall_clock_close=True,
                       tau0_reproduces_barrier_bit_exact=True)

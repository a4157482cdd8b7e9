"""The port's driver bench (``repro_torch.bench.driver_bench``, the port of
``benchmarks/driver_bench.py``) at quick CPU sizes: its rows carry the
reference's fields (``steady_state_compiles`` as ``steady_state_builds``),
each case's two loop shapes end in the same state, and the harness runs
it.

Both loop shapes of a case draw the same randomness: the method's rounds
are keyed by ``(seed, t)`` and round t's batch by ``derive_seed(data_seed,
t, "data")``.  The flat and single cases run the same ops in the same
order, so their final states are bit-equal; so are the tune's lanes and
the per-gamma loops (each lane's forward and backward runs on its own
iterate, and its Adam step multiplies by the lane's gamma as the loop's
multiplies by its float)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.bench import driver_bench as DB

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _reference_fields():
    cases = json.loads((ROOT / "BENCH_driver.json").read_text())["cases"]
    return {c["case"].split("_d")[0] if c["case"].startswith("flat")
            else c["case"]:
            {k.replace("steady_state_compiles", "steady_state_builds")
             for k in c} for c in cases}


@pytest.fixture(scope="module")
def rows():
    return {"smoke_lm_tune": DB.bench_smoke_lm_tune(CPU, n_gammas=2,
                                                    steps=2),
            "smoke_lm_single": DB.bench_smoke_lm_single(CPU, steps=3,
                                                        reps=1),
            "flat": DB.bench_flat(2000, CPU, steps=4, reps=1)}


def test_rows_carry_the_reference_fields(rows):
    want = _reference_fields()
    assert set(want) == set(rows)
    for case, row in rows.items():
        assert want[case] <= set(row), (case, want[case] - set(row))
        assert row["steady_state_builds"] == 0
        assert row["python_loop_steps_per_s"] > 0
        assert row["driver_steps_per_s"] > 0
    assert rows["flat"]["case"] == "flat_d2e+03"


def test_each_case_ends_in_the_same_state(rows):
    for case, row in rows.items():
        assert row["final_state_max_abs_diff"] == 0.0, case


def test_payload_keeps_the_reference_keys(rows, tmp_path):
    doc = DB.payload(list(rows.values()), CPU)
    ref = json.loads((ROOT / "BENCH_driver.json").read_text())
    assert {k.replace("recompile", "build") for k in ref} == set(doc)
    assert doc["steady_state_build_free"] is True


def test_bench_run_selects_and_runs_the_driver_bench(tmp_path):
    """``bench.run --only driver`` runs the bench (quick sizes, a tenth of
    its steps); the bench writes a JSON only where ``--out`` points."""
    # one thread: the tiny quick shapes gain nothing from more, and the
    # test workers already hold the cores
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_BENCH_QUICK="1", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.run", "--only", "driver",
         "--device", "cpu", "--rounds-scale", "0.1"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "=== driver_bench ===" in run.stdout
    assert "smoke_lm_tune" in run.stdout and "flat_d1e+05" in run.stdout
    assert list(tmp_path.iterdir()) == []
    from repro_torch.bench import run as bench_run
    assert bench_run.select("driver") == ["driver_bench"]

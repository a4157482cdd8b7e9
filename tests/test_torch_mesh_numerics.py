"""The port's sharded numerics on a real 2x2 ``gloo`` mesh (CPU).

One subprocess runs ``tests/torch_mesh_worker.py``: four ranks (one spawn
for the file, on a free port found by binding port 0) lay the smoke
configs of the dense, SSM, MoE, MLA, hybrid, VLM and audio families out by
the port's policy and run the last-position prefill logits and 4 decode
steps, against the same calls on plain tensors.  DTensor computes
correctly whatever the placements, so this tests the op coverage (the
spec parity of ``test_torch_sharding.py`` tests the policy).

Tolerances, each output against the plain run's largest magnitude
(``max``) and mean magnitude (``mean``):

* float32: 1e-5 of the largest magnitude, every family and output
  (measured at most 6.8e-6, zamba2's prefill);
* bf16: ``tests/test_torch_lm.py``'s max bound, 0.03, with the mean
  at 0.02 (its 0.015 is for the reference's parity on two layers) — a
  row-parallel product sums its ranks' bf16 partials, each rounded to
  bf16, where one device rounds once after a float32 sum, so the two
  runs part by bf16 roundings that the float32 run rules out as faults
  (measured at most 0.0184 max, 0.0153 mean: the VLM's decode).  Two
  families drift further: zamba2, whose 4-layer smoke stack amplifies a
  rounding ~8x more than mamba2's (measured 0.0999 / 0.0671 on its
  prefill, held to 0.12 / 0.08), and the MoE, where a near-tie routing
  flips under another rounding (its capacity-dropping prefill then
  re-slots every later token: measured up to 0.24 / 0.089 between
  builds of this tree, held to 0.3 / 0.1; its dropless decode steps
  measured up to 0.111 / 0.035, held to 0.15 / 0.05).

A planted fault, kernel 5's ``local_map`` declaring its heads replicated
while the policy shards them, must fail: ``local_map`` refuses the
mismatch, or the numbers disagree.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ("dense", "ssm", "moe", "mla", "hybrid", "vlm", "audio")
F32 = 1e-5
BF16 = (0.03, 0.02)
BF16_PREFILL = {"hybrid": (0.12, 0.08), "moe": (0.3, 0.1)}
BF16_DECODE = {"hybrid": (0.12, 0.08), "moe": (0.15, 0.05)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh") / "mesh.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable,
                          str(ROOT / "tests" / "torch_mesh_worker.py"),
                          str(out)], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("family", FAMILIES)
def test_float32_sharded_prefill_and_decode_equal_one_device(results,
                                                             family):
    rows = results[f"{family}-float32"]
    assert not isinstance(rows, str), rows
    assert len(rows) == 5                  # prefill + 4 decode steps
    assert all(r["max_rel"] <= F32 for r in rows), rows


@pytest.mark.parametrize("family", FAMILIES)
def test_bf16_sharded_prefill_and_decode_within_bounds(results, family):
    rows = results[f"{family}-bfloat16"]
    assert not isinstance(rows, str), rows
    bounds = [BF16_PREFILL.get(family, BF16)] + \
        [BF16_DECODE.get(family, BF16)] * 4
    for i, (r, (mx, mean)) in enumerate(zip(rows, bounds)):
        assert r["max_rel"] <= mx and r["mean_rel"] <= mean, (i, r)


def test_planted_replicated_heads_fail(results):
    plant = results["planted"]
    if plant["raised"] is None:
        assert any(r["max_rel"] > F32 for r in plant["errors"]), plant
    else:
        assert "placements" in plant["raised"], plant["raised"]

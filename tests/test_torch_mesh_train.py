"""The sharded DASHA trainer on a real 2x2 ``gloo`` mesh (CPU).

One subprocess runs ``tests/torch_mesh_train_worker.py`` on its
"families" group: four ranks on a (data 2, model 2) mesh, n = 2 nodes,
run ``launch.specs.train_spec``'s step for 2 rounds on DTensors against
the same step on plain tensors, both on the same injected masks (PermK
draws its own ownership map, the same on both):

* every family's smoke config in float32, DASHA-MVR on the fused path
  (its plain versions on the CPU, through ``local_map``); DASHA, PermK
  and 3 query heads (1 KV head) on the dense family, the last with two
  batch rows a node, which the attention core splits over "model" as
  the heads do not divide it (``fsdp``, ``seq_shard`` and both on the
  dense and SSM families, the planted faults and the un-injected draws
  are ``tests/test_torch_mesh_train_knobs.py``'s);
* the data axis carries only the aggregate (a float32 all-reduce of one
  row a leaf, each round), scalars, and under FSDP the parameters'
  all-gathers: every collective on it is an all-reduce or an all-gather
  whose size is a parameter's (h's row's) or a scalar's, so no per-node
  state leaf crosses it.

The bound (float32): each state leaf within 1e-5 of its own largest
magnitude, or within twice the largest error that a control run gives
in the leaf's field, whichever is larger; ``g_norm_sq`` within 1e-5 of
itself; ``payload_coords`` exact.  The control is the same plain rounds
from parameters one ulp up (``nextafter``): how far float32 rounding
alone carries the two rounds.  Tensor parallelism sums row-parallel
partials, and the vocabulary-parallel loss its max and exponentials, in
another order than one device, which moves a gradient by ~1e-6 of its
size (the DASHA case, within 1e-5 of every leaf); MVR's h-update ``gn +
(1 - b)(h - go)`` cancels most of its terms and carries that error ~10x
up, most on a small leaf (a bias, a norm, ``D``, ``A_log``, a gate).
The control shows the same reach: a one-ulp start moves the fields by
6e-6 to 1.2e-4 of their largest magnitude (zamba2's 4-layer stack
most), and the sharded rounds stay within 0.75 of the bound (measured
on this CPU).
"""
import math
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import torch_mesh_train_worker as W  # noqa: E402

NAMES = [name for name, _, _ in W.CASES["families"]]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_train") / "families.json"
    return W.run(out, "families")


def check_rounds(res):
    """The sharded rounds against the plain ones (module docstring)."""
    assert not isinstance(res, str), res
    over = W.within(res["errors"], res["control"])
    assert not over, over
    err, scale = res["errors"]["g_norm_sq"]
    assert err <= W.TOL * scale
    assert len(res["payload"]) == W.ROUNDS
    assert all(got == want for got, want in res["payload"])


def check_data_axis(res, fsdp: bool):
    """Only the aggregate, scalars and FSDP's parameter gathers on the
    data axis (module docstring)."""
    assert not isinstance(res, str), res
    sizes = {math.prod(s) for s in res["allowed_shapes"]} | {1}
    calls = res["data_calls"]
    kinds = {k for k, _, _ in calls}
    assert kinds <= ({"all-reduce", "all-gather"} if fsdp
                     else {"all-reduce"}), kinds
    assert all(math.prod(s) in sizes for _, s, _ in calls), calls
    # the aggregate: one float32 all-reduce of a row a leaf, each round
    rows = [c for c in calls if c[0] == "all-reduce" and math.prod(c[1]) > 1]
    assert len(rows) == res["leaves"] * W.ROUNDS
    assert all(d == "torch.float32" for _, _, d in rows)


@pytest.mark.parametrize("case", NAMES)
def test_sharded_rounds_equal_one_device(results, case):
    check_rounds(results[case])


@pytest.mark.parametrize("case", NAMES)
def test_only_the_aggregate_crosses_the_data_axis(results, case):
    check_data_axis(results[case], fsdp=False)

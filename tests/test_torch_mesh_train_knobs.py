"""The sharded DASHA trainer's mesh knobs on a real 2x2 ``gloo`` mesh
(CPU): ``tests/torch_mesh_train_worker.py``'s "knobs" group, held by
``tests/test_torch_mesh_train.py``'s rules.

* ``fsdp``, ``seq_shard`` and both, on the dense and SSM smoke configs,
  and ``fsdp`` with an Adam server on the dense one (its moments laid
  out as FSDP's g): 2 rounds of DASHA-MVR on DTensors equal the plain
  step's by the same bound (Adam's moments too: mu and nu, before its
  step's division by sqrt(nu) + 1e-8, within 1.2e-6 of their field; its
  parameters move most, as a coordinate whose estimator sits near 1e-8
  moves by ~1e8 times its rounding: the one-ulp control reaches 3.4e-4
  of the field there, the sharded rounds 9.2e-5), and the data axis
  carries the aggregate, scalars and, under FSDP, each parameter's
  all-gather (outside autograd: no gradient is reduced over the nodes);
* planted faults: a rank computing the other node's gradient must
  disagree; masks replicated over "data" while ``h`` is sharded must be
  refused by ``local_map``;
* un-injected draws: each rank's shard keeps density p, and the two data
  ranks draw different masks.
"""
import math
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import torch_mesh_train_worker as W  # noqa: E402
from test_torch_mesh_train import check_data_axis, check_rounds  # noqa: E402

NAMES = [name for name, _, _ in W.CASES["knobs"]]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_train") / "knobs.json"
    return W.run(out, "knobs")


@pytest.mark.parametrize("case", NAMES)
def test_sharded_rounds_with_knobs_equal_one_device(results, case):
    check_rounds(results[case])


@pytest.mark.parametrize("case", NAMES)
def test_data_axis_carries_the_aggregate_and_fsdp_gathers(results, case):
    check_data_axis(results[case], fsdp="fsdp" in case)


def test_adam_moments_within_1e_5_before_its_division(results):
    """Adam's mu and nu, the server state before its step divides by
    sqrt(nu) + 1e-8, held by 1e-5 of their field's largest magnitude with
    no control: what its parameters' wider reach comes from is that
    division, not the sharded moments."""
    errors = results["dense-fsdp-adam"]["errors"]
    for field in ("mu", "nu"):
        rows = [v for k, v in errors.items() if k.startswith(field + "/")]
        assert rows
        scale = max(m for _, m in rows)
        assert max(e for e, _ in rows) <= W.TOL * scale, field


def test_a_rank_computing_the_other_nodes_gradient_disagrees(results):
    plant = results["planted_node"]
    assert plant["raised"] is None, plant["raised"]
    res = plant["result"]
    assert W.within(res["errors"], res["control"]), \
        "the planted node swap went unnoticed"


def test_masks_replicated_over_data_are_refused(results):
    plant = results["planted_mask"]
    assert plant["raised"] is not None
    assert "local_map" in plant["raised"]


def test_undrawn_masks_keep_density_per_shard_and_differ_by_data_rank(
        results):
    res = results["undrawn"]
    assert len(res["rows"]) == 4
    for row in res["rows"]:
        sigma = math.sqrt(W.P_KEEP * (1 - W.P_KEEP) / row["numel"])
        assert abs(row["density"] - W.P_KEEP) < 5 * sigma, row
        assert row["same_layout"]
    assert not res["data_ranks_equal"]

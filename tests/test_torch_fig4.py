"""The port's Figure 4 (``repro_torch.bench.fig4_dnn``) against the
reference's ``benchmarks/fig4_dnn.py`` (CPU).

The reference runs its whole benchmark with ``STEPS`` cut to a few rounds
(monkeypatched on the imported module; nothing on disk changes).  The port
runs the same rows on the reference's draws: its parameters (carried by
``convert.params_from_numpy``), the per-round node batches
(``fold_in(data_key, t)``), the per-leaf masks of the key chain from the
state's key (one draw a round, shared by the three lanes, as the
reference's vmapped sweep shares it) and the fixed eval batch.

* ``coords_per_node`` equals the reference's exactly, row for row, from
  the replay and from the port's own ``run``;
* each row's ``final_loss`` (the best lane's, rounded to 4 places by both)
  within 5e-3 of the reference's, and the best gamma equal.  The model is
  the bf16 smoke config, whose matmuls round in other places in the two
  frameworks; measured after 3 rounds: 2e-4 (DASHA, DASHA-MVR), 5e-4
  (PermK) and 1.1e-3 (the Adam baseline) apart.
"""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.compress import treelevel as jtl
from repro.data.pipeline import SyntheticTextConfig as JText
from repro.data.pipeline import make_node_batches as j_node_batches
from repro.models import init_params as j_init
from repro_torch import convert
from repro_torch.bench import fig4_dnn as F
from repro_torch.core.rng import Draws
from repro_torch.optim.distributed import DashaTrainConfig

torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
STEPS = 3
LOSS_TOL = 5e-3


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def reference_rows():
    import benchmarks.fig4_dnn as ref
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref, "STEPS", STEPS)
        rows = ref.run()
    return {r["method"]: r for r in rows}


@pytest.fixture(scope="module")
def replay():
    """The reference's parameters, batches, fixed batch and per-round
    masks of each compressed method, as port tensors."""
    import benchmarks.fig4_dnn as ref
    cfg = ref.get_smoke_config("starcoder2-3b")
    jparams = j_init(cfg, jax.random.PRNGKey(0))
    text = JText(vocab_size=cfg.vocab_size, seq_len=ref.SEQ)

    def batch(key):
        b = j_node_batches(key, text, ref.N_NODES, ref.BATCH)
        return {k: torch.as_tensor(np.array(v), dtype=torch.int64)
                for k, v in b.items()}

    data_key = jax.random.PRNGKey(2)
    batches = [batch(jax.random.fold_in(data_key, t)) for t in range(STEPS)]
    h_local = jax.tree_util.tree_map(
        lambda p: np.zeros((ref.N_NODES,) + p.shape, np.float32), jparams)
    masks = {}
    for name, kw in F.METHODS:
        dcfg = DashaTrainConfig(gamma=0.0, n_nodes=F.N_NODES, **kw)
        key, per_round = jax.random.PRNGKey(1), []
        for _ in range(STEPS):
            _, _, k_c, _ = jax.random.split(key, 4)
            m, _ = jtl.tree_masks(k_c, h_local, mode=dcfg.mode,
                                  p=dcfg.compression, n=dcfg.n_nodes)
            per_round.append(convert.params_from_numpy(_np(m), device="cpu"))
            key = jax.random.split(key, 4)[0]
        masks[name] = per_round
    return {"params": convert.params_from_numpy(_np(jparams), device="cpu"),
            "batches": batches, "fixed": batch(jax.random.PRNGKey(99)),
            "masks": masks}


def _data_fn(replay):
    return lambda seed, t: replay["batches"][t]


@pytest.mark.parametrize("name,kw", F.METHODS, ids=[m for m, _ in F.METHODS])
def test_sweep_rows_match_the_reference_on_its_draws(name, kw, replay,
                                                     reference_rows):
    masks = replay["masks"][name]
    row, finals, losses = F.sweep_row(
        F.config(), name, kw, replay["params"], _data_fn(replay),
        replay["fixed"], STEPS, device="cpu",
        draws=lambda t: Draws(masks=masks[t]))
    want = reference_rows[name]
    assert row["coords_per_node"] == want["coords_per_node"]
    assert row["steps"] == want["steps"] == STEPS
    assert row["gamma"] == want["gamma"]
    assert abs(row["final_loss"] - want["final_loss"]) <= LOSS_TOL
    assert finals.t == STEPS and len(losses) == len(F.GAMMAS)
    assert np.all(np.isfinite(losses))


def test_sgd_row_matches_the_reference_on_its_draws(replay, reference_rows):
    row, final = F.sgd_row(F.config(), replay["params"], _data_fn(replay),
                           replay["fixed"], STEPS)
    want = reference_rows["sgd_uncompressed"]
    assert row["coords_per_node"] == want["coords_per_node"]
    assert row["gamma"] == want["gamma"]
    assert abs(row["final_loss"] - want["final_loss"]) <= LOSS_TOL
    assert final.t == STEPS


def test_run_gives_the_reference_rows_and_coords(reference_rows):
    rows = F.run(device="cpu", rounds_scale=STEPS / F.STEPS)
    assert [r["method"] for r in rows] == list(reference_rows)
    for r in rows:
        want = reference_rows[r["method"]]
        assert set(want) <= set(r)
        assert r["coords_per_node"] == want["coords_per_node"]
        assert r["steps"] == STEPS and r["gamma"] in F.GAMMAS + (F.SGD_LR,)
        assert np.isfinite(r["final_loss"]) and r["wall_s"] > 0

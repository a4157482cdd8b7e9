"""Figure 4 (CIFAR10/ResNet-18 in the paper): deep-model training with
compressed communication (port of ``benchmarks/fig4_dnn.py``).

As in the reference, a reduced starcoder2-family LM (the ``starcoder2-3b``
smoke config, bf16 parameters) on the synthetic token stream: DASHA,
DASHA-MVR and DASHA with PermK, each stepsize tune one sweep of three
lanes on the tree substrate (:class:`repro_torch.methods.Sweeper`), beside
uncompressed distributed Adam through the :class:`Driver`, at equal
*communication* budget.  Metric: the eval loss on a fixed batch reached
per coordinates sent per node.

The reference's seeds become the port's integer seeds (parameters 0, the
method state 1, the data 2, the fixed batch 99).  Torch's generators
cannot replay JAX's, so the numbers are another sample of the reference's
figure; ``coords_per_node`` depends on no draw and equals the reference's.
:func:`sweep_row` and :func:`sgd_row` take the parameters, the data, the
eval batch and (a sweep) the per-round ``draws=`` as arguments, so the
parity tests hand them the reference's.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.bench.common import emit, scaled
from repro_torch.configs import get_smoke_config
from repro_torch.core import tree
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.data.pipeline import SyntheticTextConfig, make_node_batches
from repro_torch.methods import Driver, Sweeper
from repro_torch.models import init_params, lm
from repro_torch.optim.base import Adam, apply_updates
from repro_torch.optim.distributed import (DashaTrainConfig, make_method,
                                           payload_frac)

N_NODES, BATCH, SEQ, STEPS = 4, 2, 64, 120
GAMMAS = (0.0005, 0.001, 0.003)   # paper: tune the stepsize
CHUNK = 40
#: the three compressed methods: (row name, DashaTrainConfig fields)
METHODS = [("dasha_1/32", dict(compression=1 / 32)),
           ("dasha_mvr_1/32", dict(compression=1 / 32, variant="mvr",
                                   b=0.2)),
           ("dasha_permk", dict(mode="permk"))]
SGD_LR = 0.003
PARAMS_SEED, STATE_SEED, DATA_SEED, FIXED_SEED = 0, 1, 2, 99


def config():
    return get_smoke_config("starcoder2-3b")


def node_loss_fn(cfg):
    def node_loss(p, b):
        return lm.loss_fn(cfg, p, b)[0]
    return node_loss


def eval_loss(cfg, params, batch) -> float:
    """The loss of ``params`` on a node batch flattened to one batch."""
    flat = {k: v.reshape((-1,) + tuple(v.shape[2:]))
            for k, v in batch.items()}
    with torch.no_grad():
        return float(lm.loss_fn(cfg, params, flat)[1]["loss"])


def d_total(params) -> int:
    return sum(int(x.numel()) for x in tree.leaves(params))


def method_fn_of(cfg, kw: Dict, draws: Optional[Callable] = None):
    """``gamma -> Method`` (a float or a sweep's Lanes) of one compressed
    method, Adam at lr = gamma on the server; with ``draws`` (round ->
    ``Draws``) a bare step that replays them."""
    node_loss = node_loss_fn(cfg)

    def method_fn(gamma):
        method = make_method(DashaTrainConfig(gamma=gamma, n_nodes=N_NODES,
                                              server_opt="adam", **kw),
                             node_loss)
        if draws is None:
            return method
        return lambda s, d: method.step_full(s, d, draws=draws(s.t))[0]
    return method_fn


def init_state(cfg, kw: Dict, params, *, device):
    """The state every lane of a method's sweep starts from (zeros for
    h_i and g_i, as the reference's ``init_mode="zeros"``)."""
    return make_method(DashaTrainConfig(gamma=GAMMAS[0], n_nodes=N_NODES,
                                        server_opt="adam", **kw),
                       node_loss_fn(cfg)).init(
        params, STATE_SEED, init_mode="zeros", device=device)


def setup(device):
    """(config, parameters, data_fn, fixed eval batch) on ``device``, from
    the port's seeds."""
    cfg = config()
    params = init_params(cfg, PARAMS_SEED, device=device)
    tcfg = SyntheticTextConfig(vocab_size=cfg.vocab_size, seq_len=SEQ)

    def data_fn(seed, t):
        return make_node_batches(seed, tcfg, N_NODES, BATCH, device=device)

    fixed_batch = make_node_batches(FIXED_SEED, tcfg, N_NODES, BATCH,
                                    device=device)
    return cfg, params, data_fn, fixed_batch


def sweep_row(cfg, name: str, kw: Dict, params, data_fn, fixed_batch,
              steps: int, *, device, draws: Optional[Callable] = None):
    """One compressed method's 3-gamma tune as one sweep: its row (the
    best lane's eval loss and gamma, the sweep's wall seconds with the
    evals), the final lane states and every lane's eval loss."""
    method_fn = method_fn_of(cfg, kw, draws)
    state = init_state(cfg, kw, params, device=device)
    t0 = time.perf_counter()
    finals, _ = Sweeper(method_fn, data_fn=data_fn, chunk=CHUNK).run(
        np.array(GAMMAS), state, steps, data_seed=DATA_SEED, device=device)
    losses = [eval_loss(cfg, tree.map_leaves(lambda leaf: leaf[i],
                                             finals.x), fixed_batch)
              for i in range(len(GAMMAS))]
    wall = time.perf_counter() - t0
    best = int(np.argmin(losses))
    frac = payload_frac(DashaTrainConfig(gamma=0.0, n_nodes=N_NODES, **kw))
    row = {"bench": "fig4_dnn", "method": name,
           "final_loss": round(losses[best], 4), "gamma": GAMMAS[best],
           "coords_per_node": int(steps * frac * d_total(params)),
           "steps": steps, "wall_s": wall}
    return row, finals, losses


class SgdState(NamedTuple):
    p: Any
    ost: Any
    t: int


def sgd_row(cfg, params, data_fn, fixed_batch, steps: int):
    """The uncompressed distributed Adam baseline through the Driver: the
    mean of the nodes' losses, its gradient, one Adam step."""
    node_loss = node_loss_fn(cfg)
    opt = Adam(lr=SGD_LR)
    paths = [path for path, _ in tree.items(params)]

    def sgd_step(st: SgdState, batch) -> SgdState:
        ps = [p.detach().requires_grad_(True) for p in tree.leaves(st.p)]
        with torch.enable_grad():
            pp = tree.from_items(zip(paths, ps))
            n = tree.leaves(batch)[0].shape[0]
            losses = torch.stack([node_loss(pp, tree.map_leaves(
                lambda x, i=i: x[i], batch)) for i in range(n)])
            grads = torch.autograd.grad(torch.mean(losses), ps)
        g = tree.from_items(zip(paths, grads))
        upd, ost = opt.update(g, st.ost, st.p)
        return SgdState(apply_updates(st.p, upd), ost, st.t + 1)

    t0 = time.perf_counter()
    final, _ = Driver(sgd_step, data_fn=data_fn, chunk=CHUNK).run(
        SgdState(params, opt.init(params), 0), steps, data_seed=DATA_SEED)
    loss = eval_loss(cfg, final.p, fixed_batch)
    return {"bench": "fig4_dnn", "method": "sgd_uncompressed",
            "final_loss": round(loss, 4), "gamma": SGD_LR,
            "coords_per_node": steps * d_total(params), "steps": steps,
            "wall_s": time.perf_counter() - t0}, final


def figure(device, steps: int):
    """The figure's rows, each compressed method's (final lane states,
    lane eval losses) by name, and :func:`setup`'s tuple."""
    inputs = setup(device)
    cfg, params, data_fn, fixed_batch = inputs
    rows, sweeps = [], {}
    for name, kw in METHODS:
        row, finals, losses = sweep_row(cfg, name, kw, params, data_fn,
                                        fixed_batch, steps, device=device)
        rows.append(row)
        sweeps[name] = (finals, losses)
    rows.append(sgd_row(cfg, params, data_fn, fixed_batch, steps)[0])
    return rows, sweeps, inputs


def run(*, device=DEFAULT_DEVICE, rounds_scale: float = 1.0):
    return figure(resolve_device(device), scaled(STEPS, rounds_scale))[0]


if __name__ == "__main__":
    emit(run())

"""End-to-end DASHA training driver (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
        --steps 200 --nodes 4 --batch 2 --seq 128 [--full] \
        --compression 0.03125 --variant mvr --use-kernel \
        [--ckpt out/ckpt --ckpt-every 1 --resume]

The reference's command line, with its default ``--arch starcoder2-3b``
(the dense GQA family; ``mamba2-780m``, ``minitron-8b``,
``qwen1.5-110b``, ``gemma3-12b``, ``phi3.5-moe-42b-a6.6b``,
``deepseek-v2-lite-16b``, ``zamba2-1.2b``, ``llama-3.2-vision-11b`` and
``whisper-tiny`` are the other ported ids; the MoE families add their
routers' load-balance loss, times 0.01, to the training loss; the
trainer's forward takes the plain SSD path, as the reference's does; the
VLM's batches carry image embeddings and whisper's frames, drawn with
the tokens, as the reference's ``data_kw`` adds them).  Without
``--full`` it trains the architecture's reduced (smoke) config.
:func:`train` is the library form: it takes the config itself, so a
caller can cut the depth of a full config, and a device (the card
unless ``device="cpu"``).

Rounds run through the chunked :class:`~repro_torch.methods.driver.Driver`
with a fresh node batch each round (``data_fn``, seeded by the global
round index), in chunks of ``--log-every`` rounds.  After every
``--ckpt-every``-th chunk and after the last, as the reference's hook
fires, the host waits for the device, logs the held-out eval loss,
``||g||^2`` and the payload at the global round, records the wall time
since the previous log, and with ``--ckpt`` saves the full
``MethodState`` (iterate, g, g_i, h_i, optimizer state, seed, round,
payload count) there.  ``--resume`` restores that state and runs the
rounds from its step up to ``--steps``: the same data and draws as an
uninterrupted run, so the same final state bit for bit.  The eval loss is
also taken before the first round, on the (restored) iterate.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Callable, Dict, List

import torch

from repro_torch.checkpoint import (checkpoint_step, load_method_state,
                                   save_method_state)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import tree
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.rng import derive_seed
from repro_torch.data.pipeline import (SyntheticTextConfig, make_node_batches,
                                       modality_kw)
from repro_torch.methods.driver import Driver
from repro_torch.methods.engine import MethodState
from repro_torch.models import init_params, lm
from repro_torch.models.common import ArchConfig
from repro_torch.optim.distributed import (DashaTrainConfig, make_method,
                                           payload_frac)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--full", action="store_true",
                    help="use the full assigned config")
    ap.add_argument("--steps", type=int,
                    default=int(os.environ.get("REPRO_EXAMPLE_ROUNDS", 100)))
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2, help="per-node batch")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--gamma", type=float, default=0.003)
    ap.add_argument("--compression", type=float, default=1 / 32)
    ap.add_argument("--mode", default="independent",
                    choices=["independent", "permk"])
    ap.add_argument("--variant", default="dasha",
                    choices=["dasha", "mvr", "page", "sync_mvr"])
    ap.add_argument("--mvr-b", type=float, default=0.1)
    ap.add_argument("--coin-p", type=float, default=0.25,
                    help="PAGE / SYNC-MVR sync-round probability")
    ap.add_argument("--server-opt", default="adam", choices=["sgd", "adam"])
    ap.add_argument("--use-kernel", action="store_true",
                    help="fused CUDA estimator-update path")
    ap.add_argument("--ckpt", default=None,
                    help="full-MethodState checkpoint directory")
    ap.add_argument("--ckpt-every", type=int, default=1,
                    help="checkpoint cadence in chunks")
    ap.add_argument("--resume", action="store_true",
                    help="continue from --ckpt (bit-identical to an "
                         "uninterrupted run)")
    ap.add_argument("--chunk", type=int, default=None,
                    help="driver chunk length (default: --log-every)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    return ap


@dataclasses.dataclass
class TrainResult:
    """What :func:`train` leaves behind: the final state, the driver and
    its data seed (to run further rounds), the eval loss before the first
    round, one record per logged chunk (``rounds``: the global round
    reached, ``seconds`` of wall time for the chunk's rounds, eval
    ``loss``, ``g_norm_sq``, with ``--ckpt`` the ``ckpt_s`` its save took,
    and on the card the chunk's ``peak_mem_gb``), and the round the run
    started from (the checkpoint's step after ``--resume``)."""

    state: MethodState
    driver: Driver
    data_seed: int
    loss0: float
    chunks: List[Dict[str, float]]
    n_params: int
    start_step: int = 0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _chunk_peak(dev: torch.device) -> Dict[str, float]:
    """The device's peak allocation since the last call, in GB."""
    if dev.type != "cuda":
        return {}
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    return {"peak_mem_gb": peak}


def train(cfg: ArchConfig, args: argparse.Namespace,
          device=DEFAULT_DEVICE, *, log: Callable[[str], None] = print
          ) -> TrainResult:
    """Train ``cfg`` up to global round ``args.steps`` on ``device``: from
    round 0, or with ``--resume`` from the step of the state in
    ``--ckpt``."""
    if args.resume and not args.ckpt:
        raise SystemExit("--resume requires --ckpt")
    dev = resolve_device(device)
    params = init_params(cfg, derive_seed(args.seed, "init"), device=dev)
    n_params = sum(int(x.numel()) for x in tree.leaves(params))
    log(f"[train] arch={cfg.name} layers={cfg.num_layers} "
        f"params={n_params / 1e6:.2f}M nodes={args.nodes} "
        f"tokens/step={args.nodes * args.batch * args.seq} device={dev}")

    dasha = DashaTrainConfig(
        gamma=args.gamma, compression=args.compression, mode=args.mode,
        variant=args.variant, b=args.mvr_b, p=args.coin_p,
        n_nodes=args.nodes, server_opt=args.server_opt,
        use_kernel=args.use_kernel)

    def node_loss(p, b):
        return lm.loss_fn(cfg, p, b)[0]

    method = make_method(dasha, node_loss)
    state = method.init(params, derive_seed(args.seed, "state"),
                        init_mode="zeros", device=dev)
    del params
    done = 0
    if args.resume:
        t0 = time.perf_counter()
        state = load_method_state(args.ckpt, state)
        done = checkpoint_step(args.ckpt)
        log(f"[train] resumed from {args.ckpt} at step {done} in "
            f"{time.perf_counter() - t0:.2f}s")

    tcfg = SyntheticTextConfig(vocab_size=cfg.vocab_size, seq_len=args.seq)
    data_kw = modality_kw(cfg)

    def data_fn(seed, t):
        return make_node_batches(seed, tcfg, args.nodes, args.batch,
                                 device=dev, **data_kw)

    def g_norm_sq(s, b):
        return sum(torch.sum(torch.square(x)) for x in tree.leaves(s.g))

    # held-out eval batch: all nodes' sequences in one batch
    eval_batch = {k: v.reshape((-1,) + v.shape[2:]) for k, v in
                  data_fn(derive_seed(args.seed, "eval"), 0).items()}

    def eval_loss(p) -> float:
        with torch.no_grad():
            return float(lm.loss_fn(cfg, p, eval_batch)[1]["loss"])

    frac = payload_frac(dasha)
    chunk = args.chunk or args.log_every
    drv = Driver(method, data_fn=data_fn, metrics={"g_norm_sq": g_norm_sq},
                 chunk=chunk)
    data_seed = derive_seed(args.seed, "data")
    loss0 = eval_loss(state.x)
    log(f"[train] step {done:5d} loss={loss0:.4f}")
    chunks: List[Dict[str, float]] = []
    remaining = args.steps - done
    if remaining <= 0:
        log(f"[train] checkpoint already at step {done} >= {args.steps}")
        return TrainResult(state=state, driver=drv, data_seed=data_seed,
                           loss0=loss0, chunks=chunks, n_params=n_params,
                           start_step=done)
    _sync(dev)
    _chunk_peak(dev)
    clock = [time.perf_counter()]

    def hook(ms, _, tr):
        _sync(dev)
        seconds = time.perf_counter() - clock[0]
        peak = _chunk_peak(dev)
        loss = eval_loss(ms.x)
        gsq = float(tr["g_norm_sq"][-1])
        rec = {"rounds": int(ms.t), "seconds": seconds, "loss": loss,
               "g_norm_sq": gsq, **peak}
        saved = ""
        if args.ckpt:
            t0 = time.perf_counter()
            save_method_state(args.ckpt, ms, step=int(ms.t))
            rec["ckpt_s"] = time.perf_counter() - t0
            saved = f" saved in {rec['ckpt_s']:.2f}s"
        chunks.append(rec)
        mem = f" peak={peak['peak_mem_gb']:.2f}GB" if peak else ""
        log(f"[train] step {int(ms.t):5d} loss={loss:.4f} |g|^2={gsq:.3e} "
            f"payload={frac:.4f} coords/node={float(ms.bits_sent):.3e} "
            f"({seconds:.2f}s){mem}{saved}")
        _sync(dev)
        clock[0] = time.perf_counter()

    # the initial state goes in as a temporary (popped from its box), so
    # the driver can free it after the first round (n = 4 nodes of fp32
    # state are ~30 bytes per parameter)
    box = [state]
    del state
    state, _ = drv.run(box.pop(), remaining, data_seed=data_seed,
                       checkpoint=hook, checkpoint_every=args.ckpt_every)
    return TrainResult(state=state, driver=drv, data_seed=data_seed,
                       loss0=loss0, chunks=chunks, n_params=n_params,
                       start_step=done)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch) if args.full \
        else get_smoke_config(args.arch)
    res = train(cfg, args)
    if not res.chunks:
        return 0
    if args.ckpt:
        print(f"[train] saved full method state to {args.ckpt}")
    wall = sum(c["seconds"] for c in res.chunks)
    rounds = res.state.t - res.start_step
    print(f"[train] done: {rounds} rounds at "
          f"{rounds / max(wall, 1e-9):.2f} steps/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""What two trees of the port cost on the card, on the serving paths that
the bf16 activations run through, measured in turns.

    python3 scripts/torch_activation_cost.py --before OLD/src --after src \
        [--turns 2] [--json out/activation_cost.json]

``--before`` and ``--after`` are the ``src`` directories of two checkouts
(for instance the parent commit unpacked with ``git archive`` into an
ignored directory, and this one).  Each measurement runs in a process of
its own, in turns (before, after, after, before for ``--turns 2``), so
that both trees meet the same card and host.  In bf16 with random weights
from a seed, each process measures:

* Mamba2-780M at full width and depth (48 layers): ``prefill_logits`` of
  4 x 32,768 tokens (kernel 5 on every layer; one warm-up, two timed
  calls), and 32 decode steps at batch 128 after two warm-up steps (the
  recurrence: conv, dt and gate activations on every layer);
* gemma3-12b at full width and depth (48 layers, GeGLU): a 4 x 8,192
  prefill (one warm-up, one timed call) and 32 decode steps at batch 32
  from t = 4,080 on a 4,128-slot cache holding random history.

It prints one JSON line a process, the card's name and power limit
(``nvidia-smi``), and the after/before ratio of each number's mean.  It
needs a CUDA card and imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def _prefill_s(torch, S, cfg, params, batch, seq, timed):
    from repro_torch.data.pipeline import SyntheticTextConfig, make_lm_batch
    tokens = make_lm_batch(1, SyntheticTextConfig(vocab_size=cfg.vocab_size,
                                                  seq_len=seq), batch,
                           device="cuda")["tokens"]
    S.prefill_logits(cfg, params, tokens)                      # warm-up
    torch.cuda.synchronize()
    walls = []
    for _ in range(timed):
        t0 = time.perf_counter()
        logits = S.prefill_logits(cfg, params, tokens)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    assert bool(torch.isfinite(logits).all())
    return statistics.mean(walls)


def _decode_ms(torch, S, lm, tree, cfg, params, batch, slots, t0, steps):
    cache = lm.init_cache(cfg, batch, slots, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    for c in tree.leaves(cache):
        c.normal_(generator=gen)
    tok = torch.randint(1, cfg.vocab_size, (batch,), device="cuda",
                        generator=gen)
    with torch.inference_mode():
        for i in range(steps + 2):
            if i == 2:                                     # after warm-up
                torch.cuda.synchronize()
                start = time.perf_counter()
            logits, _ = lm.decode_step(cfg, params, cache, tok, t0 + i)
            tok = S.greedy(cfg, logits)
        torch.cuda.synchronize()
    wall = time.perf_counter() - start
    assert bool(torch.isfinite(logits).all())
    return wall / steps * 1e3


def worker(src: str) -> dict:
    """One tree's measurements, in this process."""
    sys.path.insert(0, os.path.abspath(src))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.launch import serve as S
    from repro_torch.models import init_params, lm
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: this script "
                         "measures the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"src": src, "device": torch.cuda.get_device_name(0)}
    cfg = get_config("mamba2-780m")
    params = init_params(cfg, 0, device="cuda")
    out["mamba2_prefill_s"] = _prefill_s(torch, S, cfg, params, 4, 32768, 2)
    out["mamba2_decode_ms"] = _decode_ms(torch, S, lm, tree, cfg, params,
                                         128, 64, 0, 32)
    del params
    torch.cuda.empty_cache()
    cfg = get_config("gemma3-12b")
    params = init_params(cfg, 0, device="cuda")
    out["gemma3_prefill_s"] = _prefill_s(torch, S, cfg, params, 4, 8192, 1)
    out["gemma3_decode_ms"] = _decode_ms(torch, S, lm, tree, cfg, params,
                                         32, 4128, 4080, 32)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--before")
    ap.add_argument("--after")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--json")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker)), flush=True)
        return 0
    if not (args.before and args.after):
        ap.error("--before and --after are required")
    smi = _smi()
    order = []
    for _ in range(args.turns):
        order += ["before", "after"] if len(order) % 4 == 0 \
            else ["after", "before"]
    runs = {"before": [], "after": []}
    for arm in order:
        src = getattr(args, arm)
        proc = subprocess.run([sys.executable, __file__, "--worker", src],
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        row["arm"] = arm
        runs[arm].append(row)
        print(json.dumps(row), flush=True)
    keys = [k for k in runs["after"][0] if k.endswith(("_s", "_ms"))]
    summary = {k: {"before": statistics.mean(r[k] for r in runs["before"]),
                   "after": statistics.mean(r[k] for r in runs["after"])}
               for k in keys}
    for v in summary.values():
        v["after_over_before"] = v["after"] / v["before"]
    report = {"card": smi, "order": order, "runs": runs, "summary": summary}
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    print(smi)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())

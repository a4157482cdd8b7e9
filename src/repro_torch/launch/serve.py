"""Serving driver (port of ``examples/serve_lm.py`` and of the prefill
function of ``repro.launch.specs``): the ``ssm`` family (mamba2-780m), the
dense GQA family (starcoder2-3b, minitron-8b, qwen1.5-110b), gemma3's
grouped local/global stack (gemma3-12b), the mixture-of-experts family
(phi3.5-moe-42b-a6.6b, deepseek-v2-lite-16b with MLA), the hybrid
family (zamba2-1.2b: Mamba2 layers and one shared transformer block) and
the cross-attention families (llama-3.2-vision-11b: gated cross blocks to
image embeddings; whisper-tiny: an encoder over audio frames and a cross
block in every decoder layer).

    PYTHONPATH=src python -m repro_torch.launch.serve [--arch starcoder2-3b] \
        [--full] --batch 4 --prompt-len 24 --new-tokens 16

Without ``--full`` it serves the architecture's reduced (smoke) config.
:func:`serve` is the library form: it takes the config itself and a device
(the card unless ``device="cpu"``).  As in the reference example, the
prompt is prefilled by stepping :func:`lm.decode_step` over its positions
through the chunked :class:`~repro_torch.methods.driver.Driver` (static
driver data, indexed by the state's position ``t``), and then the state's
own greedy token feeds back for ``--new-tokens`` steps, the generated
tokens leaving the device as the ``"token"`` metric trace.
:func:`prefill_logits` is the serving prefill of ``repro.launch.specs``: the
prompt through the forward to the last position's logits; every Mamba2
layer (mamba2-780m's, and zamba2's between its shared-block uses) through
the chunked SSD with the hand-written kernel (``use_ssd_kernel``, the
reference's TPU deploy switch, which its Mamba2 mixer reads in any
family), for the transformer families and zamba2's shared block through
the attention of :mod:`repro_torch.models.attention` (GQA or MLA; dense
below 2,048 tokens, streaming from there; cross attention in query blocks)
and the routed experts of :mod:`repro_torch.models.moe` (dropless on the
decode steps), none of which has a kernel of its own.

Weights are random from ``--seed`` and prompts are the synthetic
copy-structured tokens of :func:`data.pipeline.make_lm_batch`, drawn on the
CPU so that every device serves the same prompt; so are the VLM's image
embeddings and whisper's frames (the stubbed vision encoder's and audio
frontend's outputs), whose cross K/V (:func:`lm.make_image_kv`,
:func:`lm.make_enc_kv`, the latter through the encoder) are made once
and held in the decode cache, as ``examples/serve_lm.py`` does.
Everything runs under ``torch.inference_mode()``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.rng import derive_seed
from repro_torch.data.pipeline import (SyntheticTextConfig, make_lm_batch,
                                       modality_kw)
from repro_torch.methods.driver import Driver
from repro_torch.models import init_params, lm
from repro_torch.models.common import ArchConfig


class DecodeState(NamedTuple):
    """Driver-steppable serving state; ``t`` is the cache position (the
    driver also keys its round index off it)."""

    cache: Any
    tok: torch.Tensor                 # next token to feed (batch,)
    emitted: torch.Tensor             # token fed THIS step (the output)
    t: int


def greedy(cfg: ArchConfig, logits: torch.Tensor) -> torch.Tensor:
    """The greedy token of each row, folded into the real vocabulary."""
    return torch.argmax(logits, -1) % cfg.vocab_size


def kernel_config(cfg: ArchConfig) -> ArchConfig:
    """``cfg`` with the SSD kernel path on for the families with Mamba2
    layers (``ssm``, ``hybrid``); a family without one is served as it
    is."""
    if cfg.arch_type not in ("ssm", "hybrid"):
        return cfg
    return dataclasses.replace(cfg, use_ssd_kernel=True)


def prefill_logits(cfg: ArchConfig, params: Dict, tokens: torch.Tensor, *,
                   image_embeds: Optional[torch.Tensor] = None,
                   frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Serving prefill: (B, 1, V_padded) logits of the last position,
    through the forward (with the SSD kernel on every Mamba2 layer; the
    VLM attends to ``image_embeds``, whisper's encoder reads
    ``frames``)."""
    with torch.inference_mode():
        logits, _ = lm.forward(kernel_config(cfg), params, tokens,
                               image_embeds=image_embeds, frames=frames,
                               last_only=True)
    return logits


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--full", action="store_true",
                    help="use the full assigned config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int,
                    default=int(os.environ.get("REPRO_EXAMPLE_ROUNDS", 16)))
    ap.add_argument("--seed", type=int, default=0)
    return ap


@dataclasses.dataclass
class ServeResult:
    """What :func:`serve` leaves behind: the final state, the prompt, the
    generated tokens (batch, new), the last prompt step's logits (batch,
    V_padded; None for an empty prompt) and the timings of the prompt
    steps and of the decode."""

    state: DecodeState
    prompt: torch.Tensor
    tokens: np.ndarray
    last_logits: Optional[torch.Tensor]
    prefill_s: float
    decode_s: float


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg: ArchConfig, args: argparse.Namespace, device=DEFAULT_DEVICE,
          *, params: Optional[Dict] = None,
          prompt: Optional[torch.Tensor] = None,
          inputs: Optional[Dict[str, torch.Tensor]] = None,
          log: Callable[[str], None] = print) -> ServeResult:
    """Prefill ``args.batch`` prompts of ``args.prompt_len`` tokens and
    greedily decode ``args.new_tokens`` more on ``device``.  ``params``,
    ``prompt`` (batch, prompt_len) and ``inputs`` (the VLM's
    ``image_embeds`` or whisper's ``frames``) replace the seeded ones."""
    dev = resolve_device(device)
    cfg = kernel_config(cfg)
    B, S = args.batch, args.prompt_len
    with torch.inference_mode():
        if params is None:
            params = init_params(cfg, derive_seed(args.seed, "init"),
                                 device=dev)
        kw = modality_kw(cfg)
        if prompt is None or (kw and inputs is None):
            text = SyntheticTextConfig(vocab_size=cfg.vocab_size, seq_len=S)
            drawn = make_lm_batch(derive_seed(args.seed, "prompt"), text, B,
                                  device="cpu", **kw)
            prompt = drawn.pop("tokens") if prompt is None else prompt
            inputs = drawn if inputs is None else inputs
        prompt = prompt.to(dev)
        if tuple(prompt.shape) != (B, S):
            raise ValueError(f"prompt {tuple(prompt.shape)} != ({B}, {S})")

        cross = {}
        if cfg.arch_type == "vlm":
            cross["image_kv"] = lm.make_image_kv(
                cfg, params, inputs["image_embeds"], device=dev)
        elif cfg.arch_type == "audio":
            cross["enc_kv"] = lm.make_enc_kv(cfg, params, inputs["frames"],
                                             device=dev)
        cache = lm.init_cache(cfg, B, S + args.new_tokens, device=dev,
                              **cross)
        last: Dict[str, torch.Tensor] = {}

        # prefill: step the decode path over the prompt positions; the
        # prompt is static driver data, indexed by the state's position
        def prefill_step(s: DecodeState, data) -> DecodeState:
            tok = data["tokens"][:, s.t]
            logits, c = lm.decode_step(cfg, params, s.cache, tok, s.t)
            last["logits"] = logits
            return DecodeState(cache=c, tok=greedy(cfg, logits), emitted=tok,
                               t=s.t + 1)

        zeros = torch.zeros((B,), dtype=torch.int64, device=dev)
        state = DecodeState(cache=cache, tok=zeros, emitted=zeros, t=0)
        del cache
        _sync(dev)
        t0 = time.perf_counter()
        state, _ = Driver(prefill_step, data={"tokens": prompt}).run(state, S)
        _sync(dev)
        steps_s = time.perf_counter() - t0
        last_logits = last.pop("logits", None)
        log(f"[serve] {cfg.name}: prefilled {B}x{S} tokens in {steps_s:.2f}s")

        # decode: the state's own greedy token feeds back; the generated
        # sequence streams out as the named metric trace
        def decode_step(s: DecodeState, data) -> DecodeState:
            logits, c = lm.decode_step(cfg, params, s.cache, s.tok, s.t)
            return DecodeState(cache=c, tok=greedy(cfg, logits),
                               emitted=s.tok, t=s.t + 1)

        t0 = time.perf_counter()
        state, traces = Driver(decode_step, metrics={
            "token": lambda s, d: s.emitted}).run(state, args.new_tokens)
        _sync(dev)
        decode_s = time.perf_counter() - t0
    gen = np.transpose(traces["token"])                   # (batch, new)
    log(f"[serve] generated {args.new_tokens} tokens/seq in {decode_s:.2f}s "
        f"({B * args.new_tokens / max(decode_s, 1e-9):.1f} tok/s)")
    if gen.size:
        log(f"[serve] sample row: {gen[0][:12].tolist()}")
    return ServeResult(state=state, prompt=prompt, tokens=gen,
                       last_logits=last_logits, prefill_s=steps_s,
                       decode_s=decode_s)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch) if args.full \
        else get_smoke_config(args.arch)
    serve(cfg, args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

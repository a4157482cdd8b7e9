"""Abstract arguments and their specs for every (arch x input shape) (port
of ``repro.launch.specs``).

``input_specs(cfg, shape, mesh, ...)`` returns a :class:`LoweredSpec`: the
function to run, its abstract arguments and their in / out specs, and no
device allocation.  The arguments are ``meta`` tensors (the counterpart of
``jax.ShapeDtypeStruct``): shapes and dtypes, no storage.  The spec trees are
the reference's, entry for entry; the decode position ``t`` is a Python int
(the port's ``lm.decode_step`` takes it so), one before the context's end.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.launch.mesh import mesh_axes
from repro_torch.models import init_params, lm
from repro_torch.models.common import ArchConfig
from repro_torch.models.sharding import (P, cache_specs, dp_axes, dp_size,
                                         expert_sharding, is_spec,
                                         map_with_path, param_specs)
from repro_torch.optim.base import AdamState
from repro_torch.optim.distributed import (DashaTrainConfig, DashaTrainState,
                                           dasha_train_init, make_train_step)

SHAPES: Dict[str, Dict] = {
    "train_4k":    dict(kind="train",  seq=4_096,   global_batch=256),
    "prefill_32k": dict(kind="prefill", seq=32_768, global_batch=32),
    "decode_32k":  dict(kind="decode", seq=32_768,  global_batch=128),
    "long_500k":   dict(kind="decode", seq=524_288, global_batch=1),
}

META = torch.device("meta")


def long_context_supported(cfg: ArchConfig) -> bool:
    """long_500k eligibility: SSM / hybrid / sliding-window, not audio."""
    subquadratic = (cfg.arch_type in ("ssm", "hybrid")
                    or cfg.sliding_window > 0)
    return subquadratic and cfg.arch_type != "audio"


def shape_supported(cfg: ArchConfig, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and not long_context_supported(cfg):
        return False, ("full-attention arch (no sub-quadratic variant); "
                       "skip per DESIGN.md §4")
    return True, ""


@dataclasses.dataclass
class LoweredSpec:
    fn: Callable
    args: Tuple
    in_shardings: Any
    out_shardings: Any
    static: Dict


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _batch_struct(cfg: ArchConfig, batch: int, seq: int,
                  node_axis: Optional[int] = None) -> Dict:
    """Abstract LM batch; optional leading node axis (DASHA training)."""
    lead = (node_axis, batch // node_axis) if node_axis else (batch,)
    out = {"tokens": _meta(lead + (seq,), torch.int32),
           "labels": _meta(lead + (seq,), torch.int32)}
    if cfg.arch_type == "vlm":
        out["image_embeds"] = _meta(lead + (cfg.num_image_tokens,
                                            cfg.d_model), cfg.torch_dtype)
    if cfg.arch_type == "audio":
        out["frames"] = _meta(lead + (cfg.num_audio_frames, cfg.d_model),
                              cfg.torch_dtype)
    return out


def _batch_sharding(cfg: ArchConfig, mesh, batch: int,
                    node_axis: bool) -> Dict:
    dp = dp_axes(mesh)
    b = dp if (batch % dp_size(mesh) == 0 or node_axis) else None
    lead = (b, None) if node_axis else (b,)
    out = {"tokens": P(*lead, None), "labels": P(*lead, None)}
    if cfg.arch_type == "vlm":
        out["image_embeds"] = P(*lead, None, None)
    if cfg.arch_type == "audio":
        out["frames"] = P(*lead, None, None)
    return out


def _expert_axis(cfg: ArchConfig, mesh) -> Optional[str]:
    tp = mesh_axes(mesh).get("model", 1)
    return "model" if (cfg.num_experts and tp > 1
                       and cfg.num_experts % tp == 0) else None


# ---------------------------------------------------------------------------
# train (DASHA data-parallel nodes x tensor parallel)
# ---------------------------------------------------------------------------

def train_spec(cfg: ArchConfig, mesh, *, seq: int, global_batch: int,
               dasha: Optional[DashaTrainConfig] = None) -> LoweredSpec:
    """The sharded DASHA train step, as the reference's: n = the data
    ranks' count nodes (the node axis over the data axes), each node's
    loss under ``remat`` and ``seq_shard``, each node's gradient pinned to
    the parameters' specs (``grad_specs``), params, g and the server
    optimizer's moments laid out by the FSDP specs when ``dasha.fsdp``.
    On DTensors each rank computes its own node's rounds only
    (:mod:`repro_torch.optim.distributed`)."""
    n = dp_size(mesh)
    dasha = dasha or DashaTrainConfig(gamma=0.01, compression=1 / 32,
                                      n_nodes=n)
    if dasha.n_nodes != n:
        dasha = dataclasses.replace(dasha, n_nodes=n)
    dp = dp_axes(mesh)
    tp = mesh_axes(mesh).get("model", 1)
    if dasha.spmd_axes is None and dp:
        dasha = dataclasses.replace(dasha, spmd_axes=dp)
    params_s = init_params(cfg, 0, device=META)
    state_s = dasha_train_init(params_s, dasha, 0, device=META)
    batch_s = _batch_struct(cfg, global_batch, seq, node_axis=n)

    seq_axis = "model" if (dasha.seq_shard and tp > 1 and seq % tp == 0) \
        else None
    exp_axis = _expert_axis(cfg, mesh)

    def node_loss(p, b):
        with expert_sharding(exp_axis):
            return lm.loss_fn(cfg, p, b, seq_shard=seq_axis, remat=True)[0]

    # FSDP specs for params / g / opt; plain specs for the per-node state
    # (the node axis already occupies the data axes there)
    p_specs = param_specs(cfg, params_s, mesh)
    p_specs_f = param_specs(cfg, params_s, mesh, fsdp=dasha.fsdp)

    step = make_train_step(dasha, node_loss, grad_specs=p_specs)

    def node_specs(specs):
        return map_with_path(lambda _, s: P(dp, *tuple(s)), specs,
                             is_leaf=is_spec)

    if dasha.server_opt == "adam":
        opt_specs: Any = AdamState(mu=p_specs_f, nu=p_specs_f, count=P())
    else:
        opt_specs = map_with_path(lambda *_: P(), state_s.opt_state)

    state_specs = DashaTrainState(
        params=p_specs_f, g=p_specs_f,
        h_local=node_specs(p_specs), g_local=node_specs(p_specs),
        opt_state=opt_specs, seed=P(), step=P())
    batch_specs_ = _batch_sharding(cfg, mesh, global_batch, node_axis=True)
    out_specs = (state_specs, {"g_norm_sq": P(), "payload_frac": P(),
                               "payload_coords": P()})
    return LoweredSpec(fn=step, args=(state_s, batch_s),
                       in_shardings=(state_specs, batch_specs_),
                       out_shardings=out_specs,
                       static=dict(kind="train", n_nodes=n,
                                   tokens=global_batch * seq,
                                   dasha=dataclasses.asdict(dasha)))


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def prefill_spec(cfg: ArchConfig, mesh, *, seq: int, global_batch: int,
                 serve_attn_hd_shard: bool = True) -> LoweredSpec:
    """The serving prefill: the last position's logits through the forward,
    every Mamba2 layer through kernel 5 (``serve.kernel_config``)."""
    from repro_torch.launch.serve import kernel_config
    params_s = init_params(cfg, 0, device=META)
    batch_s = _batch_struct(cfg, global_batch, seq)
    exp_axis = _expert_axis(cfg, mesh)
    kcfg = kernel_config(cfg)

    def prefill(params, batch):
        with torch.no_grad(), expert_sharding(exp_axis):
            logits, _ = lm.forward(kcfg, params, batch["tokens"],
                                   image_embeds=batch.get("image_embeds"),
                                   frames=batch.get("frames"),
                                   last_only=True)
        return logits  # (B, 1, V)

    p_specs = param_specs(cfg, params_s, mesh,
                          hd_fallback=serve_attn_hd_shard)
    b_specs = _batch_sharding(cfg, mesh, global_batch, node_axis=False)
    b_axis = b_specs["tokens"][0]
    return LoweredSpec(fn=prefill, args=(params_s, batch_s),
                       in_shardings=(p_specs, b_specs),
                       out_shardings=P(b_axis, None, None),
                       static=dict(kind="prefill",
                                   tokens=global_batch * seq))


# ---------------------------------------------------------------------------
# decode (serve_step: ONE token against a seq-long cache)
# ---------------------------------------------------------------------------

def decode_cache(cfg: ArchConfig, global_batch: int, seq: int) -> Dict:
    """The abstract (``meta``) decode cache of ``global_batch`` rows for
    ``seq`` positions, with the cross K/V the VLM and audio families
    hold."""
    device = META
    image_kv = enc_kv = None
    G, hd = cfg.num_kv_heads, cfg.head_dim
    if cfg.arch_type == "vlm":
        n_cross = cfg.num_layers // cfg.cross_attn_every
        shape = (n_cross, global_batch, cfg.num_image_tokens, G, hd)
        image_kv = {k: torch.zeros(shape, dtype=cfg.torch_dtype,
                                   device=device) for k in ("k", "v")}
    if cfg.arch_type == "audio":
        shape = (cfg.num_layers, global_batch, cfg.num_audio_frames, G, hd)
        enc_kv = {k: torch.zeros(shape, dtype=cfg.torch_dtype,
                                 device=device) for k in ("k", "v")}
    return lm.init_cache(cfg, global_batch, seq, image_kv=image_kv,
                         enc_kv=enc_kv, device=device)


def decode_spec(cfg: ArchConfig, mesh, *, seq: int,
                global_batch: int) -> LoweredSpec:
    params_s = init_params(cfg, 0, device=META)
    cache_s = decode_cache(cfg, global_batch, seq)
    token_s = _meta((global_batch,), torch.int32)
    exp_axis = _expert_axis(cfg, mesh)

    def serve_step(params, cache, token, t):
        with torch.no_grad(), expert_sharding(exp_axis):
            return lm.decode_step(cfg, params, cache, token, t)

    p_specs = param_specs(cfg, params_s, mesh)
    c_specs = cache_specs(cfg, cache_s, mesh, global_batch)
    b_ok = global_batch % dp_size(mesh) == 0
    tok_spec = P(dp_axes(mesh)) if b_ok else P(None)
    logits_spec = P(tok_spec[0] if b_ok else None, None)
    return LoweredSpec(
        fn=serve_step, args=(params_s, cache_s, token_s, seq - 1),
        in_shardings=(p_specs, c_specs, tok_spec, P()),
        out_shardings=(logits_spec, c_specs),
        static=dict(kind="decode", tokens=global_batch))


def input_specs(cfg: ArchConfig, shape: str, mesh,
                dasha: Optional[DashaTrainConfig] = None,
                serve_attn_hd_shard: bool = True) -> LoweredSpec:
    info = SHAPES[shape]
    ok, why = shape_supported(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} x {shape}: {why}")
    if info["kind"] == "train":
        return train_spec(cfg, mesh, seq=info["seq"],
                          global_batch=info["global_batch"], dasha=dasha)
    if info["kind"] == "prefill":
        return prefill_spec(cfg, mesh, seq=info["seq"],
                            global_batch=info["global_batch"],
                            serve_attn_hd_shard=serve_attn_hd_shard)
    return decode_spec(cfg, mesh, seq=info["seq"],
                       global_batch=info["global_batch"])

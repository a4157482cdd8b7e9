"""Shared model configuration and small building blocks (port of
``repro.models.common``).

:class:`ArchConfig` keeps the reference's field names and defaults for
everything the ported families read: the SSM fields (Mamba2), the
attention fields of the dense GQA stack (starcoder2, minitron, qwen1.5,
gemma3's grouped local/global stack), the MoE and MLA fields (phi3.5-moe,
deepseek-v2-lite), the hybrid family's shared-block period (zamba2), the
VLM's cross-attention period and image-token count (llama-3.2-vision)
and the encoder-decoder's encoder depth and frame count (whisper).

The bf16 activations (:func:`silu`, :func:`gelu_tanh`, :func:`softplus`)
and :func:`softcap` round each op to bf16 in the order the reference's
JAX lowers them to, with its weak-typed constants rounded to bf16 first;
in float32 each activation is one ``torch.nn.functional`` call.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str               # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    source: str = ""             # citation bracket from the assignment
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    mlp_type: str = "swiglu"     # swiglu | gelu | geglu
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "gather"   # gather | einsum (see moe.moe_ffn)
    moe_chunk: int = 4096          # tokens per einsum-dispatch group

    # --- MLA (DeepSeek-V2) ---------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # --- SSM (Mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    conv_width: int = 4
    ssd_chunk: int = 256
    use_ssd_kernel: bool = False   # the hand-written ssd_chunk kernel path

    # --- attention pattern -----------------------------------------------
    sliding_window: int = 0        # 0 = full attention everywhere
    global_every: int = 0          # gemma3: 1 global layer per `global_every`
    hybrid_attn_every: int = 0     # zamba2: shared attn block every k layers
    attn_logit_softcap: float = 0.0

    # --- VLM ----------------------------------------------------------------
    cross_attn_every: int = 0      # llama-3.2-vision: cross-attn each k layers
    num_image_tokens: int = 0

    # --- encoder-decoder (whisper) -----------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    num_audio_frames: int = 0

    def __post_init__(self):
        if self.head_dim is None and self.num_heads:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:          # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def param_count(self) -> int:
        """Parameters of the model, counted from the shapes of
        :func:`repro_torch.models.init.init_params` on the ``meta``
        device (nothing is allocated)."""
        from repro_torch.core import tree
        from repro_torch.models.init import init_params
        return int(sum(p.numel() for p in tree.leaves(
            init_params(self, 0, device="meta"))))

    def active_param_count(self) -> int:
        """Active parameters per token, as the reference counts them: the
        leaves under a key named ``"experts"`` count at
        ``experts_per_token / num_experts``.  No parameter tree has such a
        key (the routed experts are ``ffn/w_gate`` etc.), so this equals
        :meth:`param_count` for the MoE configs too, as the reference's
        does."""
        total = self.param_count()
        if self.num_experts == 0:
            return total
        from repro_torch.core import tree
        from repro_torch.models.init import init_params
        expert_total = sum(
            p.numel() for path, p in tree.items(
                init_params(self, 0, device="meta"))
            if "experts" in path.split("/"))
        active_frac = self.experts_per_token / max(self.num_experts, 1)
        return int(total - expert_total + expert_total * active_frac)


# ---------------------------------------------------------------------------
# tiny building blocks
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def dtype_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``.  JAX rounds a Python scalar (a weak
    type) to the dtype of the array it multiplies (a bf16 array times 0.5
    ** -0.5 multiplies by 0.70703125); torch multiplies by the unrounded
    value.  Multiplying by this one gives the reference's product."""
    return float(torch.tensor(value, dtype=dtype))


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + w.to(torch.float32))).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding in float32, cast back to ``x``'s dtype.
    x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freq  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.split(x.to(torch.float32), half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``.  In bf16 the op order jax 0.9 lowers it to, each
    op rounded to bf16: ``x * (1 / (1 + exp(-x)))``; else one
    ``F.silu``."""
    if x.dtype != torch.bfloat16:
        return F.silu(x)
    return x * torch.reciprocal(torch.exp(-x) + 1.0)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)``.  In bf16 its formula op by op,
    each op rounded to bf16, the constants 0.044715 and sqrt(2 / pi)
    rounded to bf16 first: ``x * (0.5 * (1 + tanh(c1 * (x + c0 * x**3))))``
    with ``x**3`` as ``(x * x) * x``; else one ``F.gelu``."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    c0 = dtype_scalar(0.044715, x.dtype)
    c1 = dtype_scalar(math.sqrt(2 / math.pi), x.dtype)
    cube = (x * x) * x
    inner = (x + cube * c0) * c1
    return x * ((torch.tanh(inner) + 1.0) * 0.5)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``).  In bf16 the op order jax
    0.9 lowers it to, each op rounded to bf16: ``max(x, 0) +
    log1p(exp(-|x|))``; else one ``F.softplus``."""
    if x.dtype != torch.bfloat16:
        return F.softplus(x)
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def mlp_apply(p: dict, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    """The block's MLP.  ``jax.nn.gelu`` is the tanh approximation by
    default, so the reference's ``"gelu"`` and ``"geglu"`` both take
    ``approximate="tanh"``."""
    if mlp_type == "gelu":
        h = x @ p["w_in"]
        if "b_in" in p:
            h = h + p["b_in"]
        h = gelu_tanh(h) @ p["w_out"]
        return h + p["b_out"] if "b_out" in p else h
    gate = x @ p["w_gate"]
    act = gelu_tanh(gate) if mlp_type == "geglu" else silu(gate)
    return (act * (x @ p["w_in"])) @ p["w_out"]


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    """``cap * tanh(logits / cap)`` with the cap rounded to the logits'
    dtype first, as JAX rounds the weak-typed scalar."""
    if cap <= 0:
        return logits
    cap = dtype_scalar(cap, logits.dtype)
    return cap * torch.tanh(logits / cap)

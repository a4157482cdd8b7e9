"""llama-3.2-vision-11b [vlm] — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision].

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.  The ViT vision
encoder and projector are stubbed: the caller provides projected patch
embeddings (B, num_image_tokens, d_model); gated cross-attention blocks
after every 5th layer consume them.  A copy of
``repro/configs/llama32_vision_11b.py``.
"""
import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    arch_type="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    source="Llama 3.2 Vision [hf:meta-llama/Llama-3.2-11B-Vision]",
    cross_attn_every=5,
    num_image_tokens=1601,
)

SMOKE = dataclasses.replace(
    CONFIG, name="llama-vision-smoke", num_layers=4, d_model=128,
    vocab_size=512, num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
    cross_attn_every=2, num_image_tokens=16)

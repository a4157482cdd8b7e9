"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct].

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064.  A copy of
``repro/configs/phi35_moe_42b.py``.
"""
import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    source="Phi-3.5-MoE [hf:microsoft/Phi-3.5-MoE-instruct]",
    num_experts=16,
    experts_per_token=2,
)

SMOKE = dataclasses.replace(
    CONFIG, name="phi35-moe-smoke", num_layers=2, d_model=128, vocab_size=512,
    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=128, num_experts=4,
    experts_per_token=2)

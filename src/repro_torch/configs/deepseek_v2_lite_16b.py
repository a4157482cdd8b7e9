"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, shared+routed experts top-6
[arXiv:2405.04434].

27L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400, MoE 64e top-6,
2 shared experts (the reference follows the primary spec line: 64 routed
experts, top-6, 2 shared).  A copy of
``repro/configs/deepseek_v2_lite_16b.py``.
"""
import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    source="DeepSeek-V2 [arXiv:2405.04434]",
    use_mla=True,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    head_dim=128,
    num_experts=64,
    experts_per_token=6,
    num_shared_experts=2,
)

SMOKE = dataclasses.replace(
    CONFIG, name="deepseek-smoke", num_layers=2, d_model=128, vocab_size=512,
    num_heads=4, num_kv_heads=4, head_dim=32, d_ff=64, num_experts=4,
    experts_per_token=2, num_shared_experts=1, kv_lora_rank=32,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)

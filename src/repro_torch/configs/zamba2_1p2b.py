"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64.
One SHARED transformer block (weights reused) applied every 6 layers.  A
copy of ``repro/configs/zamba2_1p2b.py``.
"""
import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    source="Zamba2 [arXiv:2411.15242]",
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    hybrid_attn_every=6,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="zamba2-smoke", num_layers=4, d_model=128, vocab_size=512,
    num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256, ssm_state=16,
    ssm_headdim=32, hybrid_attn_every=2, ssd_chunk=32)

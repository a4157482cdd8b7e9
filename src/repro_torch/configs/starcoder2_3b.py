"""starcoder2-3b [dense] — GQA, RoPE, 4k sliding window [arXiv:2402.19173].

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.  Plain-GELU MLP.
A copy of ``repro/configs/starcoder2_3b.py``.
"""
import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    arch_type="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    source="StarCoder2 [arXiv:2402.19173]",
    mlp_type="gelu",
    qkv_bias=True,
    sliding_window=4096,
)

SMOKE = dataclasses.replace(
    CONFIG, name="starcoder2-smoke", num_layers=2, d_model=128,
    vocab_size=512, num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
    sliding_window=16)

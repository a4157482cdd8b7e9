"""gemma3-12b [dense] — 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt family].

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144.  Local layers use a
1024-token sliding window; every 6th layer is global.  GeGLU MLP, embedding
scaled by sqrt(d), tied head.  A copy of ``repro/configs/gemma3_12b.py``.
"""
import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b",
    arch_type="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    d_ff=15360,
    vocab_size=262144,
    source="Gemma 3 [hf:google/gemma-3-1b-pt]",
    mlp_type="geglu",
    sliding_window=1024,
    global_every=6,
    attn_logit_softcap=0.0,
    tie_embeddings=True,
    head_dim=256,
)

SMOKE = dataclasses.replace(
    CONFIG, name="gemma3-smoke", num_layers=4, d_model=128, vocab_size=512,
    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, sliding_window=16,
    global_every=2)

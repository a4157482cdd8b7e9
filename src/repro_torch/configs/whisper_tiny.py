"""whisper-tiny [audio] — encoder-decoder, conv frontend stubbed
[arXiv:2212.04356].

4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865.  The mel-spectrogram and
conv feature extractor are stubbed: the caller provides precomputed frame
embeddings (B, 1500, d_model).  Decoder: self-attention and
cross-attention in every layer; the encoder reuses the causal
transformer block with RoPE positions, as the reference's does.  A copy
of ``repro/configs/whisper_tiny.py``.
"""
import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    arch_type="audio",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    source="Whisper [arXiv:2212.04356]",
    mlp_type="gelu",
    is_encoder_decoder=True,
    num_encoder_layers=4,
    num_audio_frames=1500,
)

SMOKE = dataclasses.replace(
    CONFIG, name="whisper-smoke", num_layers=2, num_encoder_layers=2,
    d_model=128, vocab_size=512, num_heads=4, num_kv_heads=4, head_dim=32,
    d_ff=256, num_audio_frames=32)

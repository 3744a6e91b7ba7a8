"""Whisper-medium — encoder-decoder ASR backbone [arXiv:2212.04356].

The conv frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed frame embeddings of shape (B, num_audio_frames, d_model). The
transformer backbone is 24 encoder + 24 decoder layers; positions use RoPE in
place of sinusoidal/learned absolute embeddings (shape/FLOP-equivalent;
noted in DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,
    num_decoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,  # padded to 51968 for sharding (vocab_padded)
    num_audio_frames=1500,
    mlp_kind="gelu",
    tie_embeddings=True,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, num_decoder_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512, num_audio_frames=16,
)

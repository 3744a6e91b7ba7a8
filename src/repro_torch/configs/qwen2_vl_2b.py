"""Qwen2-VL-2B — M-RoPE, dynamic-resolution VLM [arXiv:2409.12191; hf].

The vision frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings of shape (B, num_patch_tokens, d_model) which the
backbone prepends to the text-token embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    mlp_kind="swiglu",
    rope_theta=1e6,
    num_patch_tokens=256,
    mrope_sections=(16, 24, 24),  # sums to head_dim/2 = 64
    tie_embeddings=True,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, num_patch_tokens=8, mrope_sections=(4, 2, 2),
)

"""Zamba2-2.7B — Mamba2 backbone + shared attention block [arXiv:2411.15242].

54 Mamba2 layers; one *weight-shared* full attention+MLP block is applied
every ``attn_every`` SSM layers (9 applications). This is the JAX
reference's simplification of the family, which the differential tests
hold the port to: it keeps the weight sharing and leaves out the released
model's second block, its per-application LoRA and its attention over
``[hidden ; embedding]`` (``PERF.md`` §4).  The released layout is
``configs/zamba2_7b.py`` (``models/transformer.py:Zamba2LM``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    attn_every=6,
    mlp_kind="swiglu",
    tie_embeddings=True,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, ssm_state=16, ssm_headdim=16, attn_every=2,
    ssm_chunk=16,
)

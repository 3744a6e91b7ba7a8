"""Phi-3.5-MoE 42B (6.6B active) — 16 experts, top-2 routing
[hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    num_experts=16,
    experts_per_token=2,
    mlp_kind="swiglu",
    tie_embeddings=False,
    train_microbatches=8,  # HBM fit at train_4k (see EXPERIMENTS §Perf)
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=64, vocab_size=512, num_experts=4, experts_per_token=2,
)

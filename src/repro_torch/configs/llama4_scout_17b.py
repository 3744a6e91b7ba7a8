"""Llama-4-Scout-17B-16E — MoE 16 experts top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

Assignment-faithful simplification: all 48 layers are MoE with 16 experts and
top-1 routing (the released model interleaves dense layers and adds a shared
expert; the assignment config specifies "MoE 16e top-1" uniformly).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    num_experts=16,
    experts_per_token=1,
    mlp_kind="swiglu",
    tie_embeddings=False,
    train_microbatches=16,  # HBM fit at train_4k (see EXPERIMENTS §Perf)
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=64, vocab_size=512, num_experts=4, experts_per_token=1,
)

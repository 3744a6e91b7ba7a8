"""SmolLM-360M — llama-arch small model [hf:HuggingFaceTB/SmolLM-360M]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    mlp_kind="swiglu",
    tie_embeddings=True,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=60, num_heads=3, num_kv_heads=1, head_dim=20,
    d_ff=128, vocab_size=512,
)

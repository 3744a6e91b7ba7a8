"""Mamba2-2.7B — attention-free SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,  # padded to 50432 for sharding (vocab_padded)
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    tie_embeddings=True,
    train_microbatches=8,  # HBM fit at train_4k (see EXPERIMENTS §Perf)
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=64, vocab_size=512, ssm_state=16, ssm_headdim=16,
    ssm_chunk=16,
)

"""Zamba2-7B, the released Zamba2 layout [arXiv:2405.16712, 2411.15242].

81 Mamba2 layers (ngroups 2, state 64, head dim 64, 112 heads, conv bias,
grouped gated norm); two shared attention+MLP blocks applied in turn
before the 13 layers of ``hybrid_layer_ids``, each application with its
own LoRA on the MLP's gate/up product (rank 128) and its own output
linear; attention over ``[hidden ; embedding]`` (2 × 3,584 wide), 32 heads
of 224, RoPE (theta 10,000), scale 112^-0.5; an erf-GELU gated MLP of
14,336.  Every number is the published ``config.json``'s
(https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json);
the layer equations are transformers' ``models/zamba2/modeling_zamba2.py``.
Built by ``models/transformer.py:Zamba2LM``; ``zamba2_2_7b`` is the JAX
reference's simplification of the family, which the differential tests
hold.
"""
from repro_torch.configs.base import Zamba2Config

CONFIG = Zamba2Config(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=224,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    ssm_groups=2,
    ssm_chunk=256,
    # bench/counts.py counts num_layers // attn_every applications: 13 of
    # 81 layers, as hybrid_layer_ids has them
    attn_every=6,
    mlp_kind="gelu",
    rope_theta=1e4,
    tie_embeddings=True,
    norm_eps=1e-5,
    hybrid_layer_ids=[6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77],
    mem_blocks=2,
    adapter_rank=128,
    attn_scale_dim=112,
)

# four applications, so that each block runs twice; two groups
SMOKE_CONFIG = CONFIG.replace(
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=4, head_dim=32,
    d_ff=128, vocab_size=512, ssm_state=16, ssm_headdim=16, ssm_chunk=16,
    attn_every=2, hybrid_layer_ids=[2, 4, 5, 7], adapter_rank=8,
    attn_scale_dim=16,
)

"""Analytic model counters: useful FLOPs, decode-state bytes and the HBM
traffic floor of a (config × shape) cell.

The port of the pure-Python counters of the reference package's
``repro.analysis.roofline``: ``attn_flops_forward``, ``model_flops``,
``decode_state_bytes`` and ``model_bytes``, unchanged.  The reference's
three-term roofline (``roofline``, ``load_records``, ``full_table``,
``markdown_table``) reads XLA dry-run records against TPU peaks and waits
for the dry-run slice of the port.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeSpec


def attn_flops_forward(cfg: ModelConfig, batch: int, seq: int) -> float:
    """Full-attention score+value FLOPs, forward, causal-halved."""
    if cfg.num_heads == 0:
        return 0.0
    per_layer = 2 * 2 * batch * seq * seq * cfg.num_heads * cfg.head_dim / 2
    if cfg.family in ("dense", "vlm", "moe"):
        layers = cfg.num_layers
    elif cfg.family == "hybrid":
        layers = cfg.num_layers // cfg.attn_every
    elif cfg.family == "encdec":
        enc = 2 * 2 * batch * cfg.num_audio_frames ** 2 * cfg.num_heads * cfg.head_dim
        cross = 2 * 2 * batch * seq * cfg.num_audio_frames * cfg.num_heads * cfg.head_dim
        return cfg.num_layers * enc + cfg.num_decoder_layers * (per_layer + cross)
    else:
        layers = 0
    return layers * per_layer


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Analytic useful FLOPs per step (global): 6ND (train) / 2ND (prefill)
    / 2N per token (decode), plus the attention term."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6 * n * toks + 3 * attn_flops_forward(cfg, shape.global_batch,
                                                     shape.seq_len)
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2 * n * toks + attn_flops_forward(cfg, shape.global_batch,
                                                 shape.seq_len)
    # decode: one token per sequence; attention reads the whole cache
    flops = 2 * n * shape.global_batch
    if cfg.num_heads:
        stack = (cfg.num_layers if cfg.family in ("dense", "vlm", "moe")
                 else cfg.num_layers // cfg.attn_every
                 if cfg.family == "hybrid" else cfg.num_decoder_layers)
        flops += (2 * 2 * shape.global_batch * shape.seq_len *
                  cfg.num_kv_heads * cfg.head_dim * stack)
    return flops


def decode_state_bytes(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """KV-cache + SSM-state bytes (global) — the decode memory floor."""
    B, S = shape.global_batch, shape.seq_len
    total = 0.0
    if cfg.num_heads:
        stack = (cfg.num_layers if cfg.family in ("dense", "vlm", "moe")
                 else cfg.num_layers // cfg.attn_every
                 if cfg.family == "hybrid" else cfg.num_decoder_layers)
        total += 2 * stack * B * S * cfg.num_kv_heads * cfg.head_dim * 2
    if cfg.ssm_state:
        conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        total += cfg.num_layers * B * (
            cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state
            + (cfg.ssm_conv - 1) * conv_ch) * 2
    return total


def model_bytes(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Analytic HBM-traffic floor per step (global), for the fair roofline
    fraction of memory-bound cells:

      train:   6 × param bytes (fwd read + bwd read + grad/opt update)
               + 4 × activation-residual traffic (write + re-read, fwd+bwd)
      prefill: param read + KV write + 2 × activations
      decode:  active-param read + full decode-state read (the floor that
               dominates at long context)
    """
    p_bytes = cfg.param_count() * 4.0  # fp32 master weights
    d = cfg.d_model
    toks = shape.global_batch * shape.seq_len
    layers = cfg.num_layers + (cfg.num_decoder_layers or 0)
    act = toks * d * 2.0 * layers  # bf16 residual stream per layer
    if shape.kind == "train":
        return 6 * p_bytes + 4 * act
    if shape.kind == "prefill":
        kv = decode_state_bytes(cfg, shape)
        return cfg.active_param_count() * 2.0 + kv + 2 * act
    return (cfg.active_param_count() * 2.0 +
            decode_state_bytes(cfg, shape))

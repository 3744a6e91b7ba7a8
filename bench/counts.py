"""Analytic operation and byte counts: the yardstick of the benchmark's
utilisation metrics.

A count is of the work the model needs, whatever implements it:

* every weight product, the shared block of a hybrid at each of its
  ``num_layers / attn_every`` applications;
* causal attention, its two products over the pairs (i, j <= i) only;
* the chunked SSD's four products a chunk of ``ssm_chunk`` (C·Bᵀ on the
  ``ssm_groups`` groups, (L∘CBᵀ)·X, the chunk states, state to output);
* nothing for recomputation under remat.

Training counts the forward three times (forward, and the backward's two
products a product) with the head over every position; prefill counts the
head at the last position only.  The published peaks are NVIDIA's data
sheet figures for one H100 SXM at its full 700 W.
"""
from __future__ import annotations

PEAKS = {
    # dense bf16 tensor-core rate, the card's highest short of fp8
    "bf16_flops": 989e12,
    "hbm_bytes_per_s": 3.35e12,
}


def _ssd_dims(cfg: dict, S: int):
    d = cfg["d_model"]
    di = cfg["ssm_expand"] * d
    q = min(cfg["ssm_chunk"], S)
    c = -(-S // q)
    return (di, di // cfg["ssm_headdim"], cfg["ssm_headdim"],
            cfg["ssm_groups"], cfg["ssm_state"], q, c)


def mamba_proj_flops(cfg: dict, B: int, S: int) -> int:
    """One Mamba2 block's weight products (in_proj's five, out_proj)."""
    d = cfg["d_model"]
    di, h, _, g, n, _, _ = _ssd_dims(cfg, S)
    return 2 * B * S * d * (2 * di + 2 * g * n + h) + 2 * B * S * di * d


def ssd_flops(cfg: dict, B: int, S: int, cb_per_head: bool = False) -> int:
    """One block's chunked SSD products.  ``cb_per_head`` counts C·Bᵀ on
    every head, as a scan that repeats the groups' B and C to the heads
    computes it."""
    _, h, p, g, n, q, c = _ssd_dims(cfg, S)
    cb = 2 * B * c * q * q * (h if cb_per_head else g) * n
    lx = 2 * B * c * q * q * h * p
    states = 2 * B * c * q * h * p * n
    return cb + lx + 2 * states


def ssd_bytes(cfg: dict, B: int, S: int, elem: int = 4) -> int:
    """One block's SSD inputs read once (x, dt, B, C) and outputs written
    once (y, the final state)."""
    _, h, p, g, n, _, _ = _ssd_dims(cfg, S)
    return elem * (B * S * (2 * h * p + h + 2 * g * n) + B * h * p * n)


def attn_proj_flops(cfg: dict, B: int, S: int) -> int:
    d, H, Hkv, Dh = (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"],
                     cfg["head_dim"])
    return 2 * B * S * d * (H + 2 * Hkv) * Dh + 2 * B * S * H * Dh * d


def attention_flops(cfg: dict, B: int, S: int, causal: bool = True) -> int:
    """QKᵀ and PV over the causal pairs (``causal=False``: the full
    square, as a masked dense computation does it)."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return 2 * 2 * B * cfg["num_heads"] * cfg["head_dim"] * pairs


def attention_bytes(cfg: dict, B: int, S: int, elem: int = 2) -> int:
    H, Hkv, Dh = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    return elem * B * S * Dh * (2 * H + 2 * Hkv)


def mlp_flops(cfg: dict, B: int, S: int) -> int:
    return 2 * B * S * cfg["d_model"] * cfg["d_ff"] * 3


def head_flops(cfg: dict, rows: int) -> int:
    vp = (cfg["vocab_size"] + 255) // 256 * 256
    return 2 * rows * cfg["d_model"] * vp


def forward_terms(cfg: dict, B: int, S: int, head_rows: int,
                  causal: bool = True, cb_per_head: bool = False) -> dict:
    """The forward pass's products by term, summed over the model."""
    L = cfg["num_layers"]
    terms = {"mamba_proj": L * mamba_proj_flops(cfg, B, S),
             "ssd": L * ssd_flops(cfg, B, S, cb_per_head),
             "head": head_flops(cfg, head_rows)}
    if cfg["family"] == "hybrid":
        apps = L // cfg["attn_every"]
        terms["shared_proj"] = apps * (attn_proj_flops(cfg, B, S)
                                       + mlp_flops(cfg, B, S))
        terms["attention"] = apps * attention_flops(cfg, B, S, causal)
    elif cfg["family"] != "ssm":
        raise ValueError(f"no count for family {cfg['family']!r}")
    return terms


def prefill_flops(cfg: dict, B: int, S: int) -> int:
    """Model operations of one (B, S) prefill: the head at the last
    position."""
    return sum(forward_terms(cfg, B, S, head_rows=B).values())


def train_flops(cfg: dict, B: int, S: int) -> int:
    """Model operations of one training step on (B, S) tokens."""
    return 3 * sum(forward_terms(cfg, B, S, head_rows=B * S).values())

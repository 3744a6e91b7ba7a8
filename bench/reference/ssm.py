"""Mamba2 language model (family ``ssm``) in plain float32: embedding, a
stack of Mamba2 blocks, final RMSNorm and the tied head."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from bench.reference import common as C


def leaf_specs(cfg: dict) -> dict:
    """Flat ``{name: (shape, init)}`` of the parameter tree, the program's
    names: ``embed``, ``ln_f`` and ``layers.*`` stacked over the layers."""
    specs = C.head_leaf_specs(cfg)
    for k, v in C.mamba_leaf_specs(cfg, (cfg["num_layers"],)).items():
        specs[f"layers.{k}"] = v
    return specs


def _layer(params: dict, i: int) -> dict:
    return {k: v[i] for k, v in params["layers"].items()}


def prefill(params: dict, tokens, cfg: dict, pr=C.EXACT, pad_to=None):
    """Last-position logits (B, V) and the decode state {"ssm": (L, B, h,
    p, n), "conv": (L, B, w-1, ch)} of a (B, S) prompt batch."""
    x = C.embed(params, tokens, pr)
    ssm, conv = [], []
    for i in range(cfg["num_layers"]):
        x, (s, c) = C.mamba_layer(x, _layer(params, i), cfg, pr,
                                  with_state=True)
        ssm.append(s)
        conv.append(c)
    return (C.logits(x[:, -1], params, cfg, pr),
            {"ssm": torch.stack(ssm), "conv": torch.stack(conv)})


def loss_sum(params: dict, tokens, labels, cfg: dict, pr=C.EXACT):
    """Sum of the token losses of a (B, S) batch; each block is
    recomputed in the backward (``checkpoint``), so the reference fits
    beside the program's sizes."""
    x = C.embed(params, tokens, pr)
    for i in range(cfg["num_layers"]):
        x = checkpoint(C.mamba_layer, x, _layer(params, i), cfg, pr,
                       use_reentrant=False)
    return checkpoint(C.cross_entropy, x, params, labels, cfg, pr,
                      use_reentrant=False)

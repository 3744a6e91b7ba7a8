"""Facade: build models and the input specs of a (config × shape) cell.

The port of the reference package's ``repro.models.model``, without its
sharding rules: ``param_pspecs``, ``state_pspecs``, ``input_pspecs``,
``axes_for``, ``to_shardings`` and ``abstract_params`` map trees to
``PartitionSpec``s of a mesh and wait for the mesh slice of the port.  A
model's abstract parameters are ``build_model(cfg, device="meta")``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.transformer import build_model  # re-export  # noqa: F401


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """``meta`` tensors (the reference's ShapeDtypeStruct stand-ins) for
    every model input of this cell.

    train/prefill: token batch (+ stubbed modality embeddings).
    decode: current tokens (B,) — the cache/state specs come from
    ``model.decode_state_specs``.
    """
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    cd = cfg.compute_dtype

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    d = {}
    if shape.kind == "decode":
        d["tokens"] = spec((B,), i32)
        return d
    if cfg.family == "vlm":
        pt = cfg.num_patch_tokens
        d["patch_embeds"] = spec((B, pt, cfg.d_model), cd)
        d["tokens"] = spec((B, S - pt), i32)
        if shape.kind == "train":
            d["labels"] = spec((B, S - pt), i32)
        return d
    if cfg.family == "encdec":
        d["audio_frames"] = spec((B, cfg.num_audio_frames, cfg.d_model), cd)
    d["tokens"] = spec((B, S), i32)
    if shape.kind == "train":
        d["labels"] = spec((B, S), i32)
    return d

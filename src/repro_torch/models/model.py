"""Facade: build models, input specs and sharding rules.

The port of the reference package's ``repro.models.model``.  This is the
single place that knows how parameter/state/input trees map to
:class:`~repro_torch.models.sharding.P` specs (DESIGN.md §6).  Rules are
name-based on the *trailing* dims of each leaf so the same table covers
stacked (L, ...), double-stacked (n_super, k, ...) and unstacked
(shared-block) parameters.  A tree is a nested dict (or the model, whose
``named_parameters()`` follow the reference's tree paths); its leaves are
tensors (``meta`` tensors stand for the reference's ``ShapeDtypeStruct``s).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.layers import ParamTree
from repro_torch.models.sharding import MeshAxes, P, make_axes, placements
from repro_torch.models.transformer import build_model  # re-export  # noqa: F401

# trailing-dim partition entries per parameter name ("data" = ZeRO-3 shard,
# "model" = tensor/expert parallel). Leading stack dims are padded with None.
_PARAM_RULES = {
    "embed": ("model", "data"),
    "unembed": ("model", "data"),
    "wq": ("data", "model"),
    "wk": ("data", "model"),
    "wv": ("data", "model"),
    "wo": ("model", "data"),
    "w_gate": ("data", "model"),
    "w_up": ("data", "model"),
    "w_down": ("model", "data"),
    # mamba2
    "wz": ("data", "model"),
    "wx": ("data", "model"),
    "wB": ("data", None),
    "wC": ("data", None),
    "wdt": ("data", "model"),
    "conv": (None, "model"),
    "A_log": ("model",),
    "D": ("model",),
    "dt_bias": ("model",),
    "norm": ("model",),  # gated-norm weight over d_inner
    "out": ("model", "data"),
}
_MOE_RULES = {  # under a "moe" subtree (trailing dims (E, D, F) / (E, F, D))
    "router": ("data", None),
    "w_gate": ("model", "data", None),
    "w_up": ("model", "data", None),
    "w_down": ("model", None, "data"),
}


def _map_with_path(fn, tree, path=()):
    """``jax.tree_util.tree_map_with_path``: ``fn(path, leaf)`` over a tree
    of dicts (or the model), ``path`` the tuple of a leaf's keys; rebuilt
    as nested dicts."""
    if isinstance(tree, (dict, ParamTree)):
        return {k: _map_with_path(fn, tree[k], (*path, k))
                for k in tree.keys()}
    return fn(path, tree)


def param_pspecs(param_tree, cfg: ModelConfig | None = None):
    """P tree for a params (or matching ``meta``) tree.

    ``cfg.embed_sharding == "model_only"`` drops the data-axis ZeRO shard of
    the embedding tables (required by vocab-parallel CE)."""
    embed_core = (("model", None)
                  if cfg is not None and cfg.embed_sharding == "model_only"
                  else ("model", "data"))

    def spec(path, leaf):
        name = path[-1]
        if name in ("embed", "unembed"):
            core = embed_core
        else:
            rules = (_MOE_RULES if "moe" in path and name in _MOE_RULES
                     else _PARAM_RULES)
            core = rules.get(name)
        if core is None or leaf.dim() < len(core):
            return P()  # norms, scalars, biases: replicate
        pad = (None,) * (leaf.dim() - len(core))
        return P(*pad, *core)

    return _map_with_path(spec, param_tree)


def choose_kv_partition(cfg: ModelConfig, tp: int) -> str:
    """Shard decode KV caches by head when divisible, else by sequence
    (flash-decoding with softmax-stat reduction over the model axis)."""
    if cfg.num_kv_heads and cfg.num_kv_heads % tp == 0:
        return "heads"
    return "seq"


def state_pspecs(state_tree, axes: MeshAxes):
    """P specs for a decode-state tree from decode_state_specs()."""
    kv_core = ((axes.bspec, axes.model, None, None)
               if axes.kv_partition == "seq"
               else (axes.bspec, None, axes.model, None))
    rules = {
        "k": kv_core,
        "v": kv_core,
        "ssm": (axes.bspec, axes.model, None, None),
        "conv": (axes.bspec, None, axes.model),
    }

    def spec(path, leaf):
        name = path[-1]
        if name == "pos":
            return P()
        if "enc_kv" in path:  # whisper cross-kv: heads always divisible
            core = (axes.bspec, None, axes.model, None)
        else:
            core = rules.get(name)
        if core is None:
            return P()
        pad = (None,) * (leaf.dim() - len(core))
        return P(*pad, *core)

    return _map_with_path(spec, state_tree)


# ---------------------------------------------------------------------------
# input specs per (config × shape)
# ---------------------------------------------------------------------------


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


def input_pspecs(cfg: ModelConfig, shape: ShapeSpec, axes: MeshAxes) -> dict:
    b = axes.bspec
    d = {}
    if shape.kind == "decode":
        return {"tokens": P(b)}
    if cfg.family == "vlm":
        d["patch_embeds"] = P(b, None, None)
    if cfg.family == "encdec":
        d["audio_frames"] = P(b, None, None)
    d["tokens"] = P(b, None)
    if shape.kind == "train":
        d["labels"] = P(b, None)
    return d


def _mesh_shape(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_shardable(shape: ShapeSpec, mesh) -> bool:
    sizes = _mesh_shape(mesh)
    n = sizes.get("pod", 1) * sizes.get("data", 1)
    return shape.global_batch % n == 0 and shape.global_batch >= n


def axes_for(cfg: ModelConfig, shape: ShapeSpec, mesh) -> MeshAxes:
    tp = _mesh_shape(mesh).get("model", 1)
    return make_axes(mesh, batch_shardable=batch_shardable(shape, mesh),
                     kv_partition=choose_kv_partition(cfg, tp))


def to_shardings(mesh, pspec_tree):
    """``NamedSharding(mesh, spec)`` for every spec of a tree: a
    ``(mesh, placements)`` pair (:func:`sharding.placements`)."""
    if isinstance(pspec_tree, dict):
        return {k: to_shardings(mesh, v) for k, v in pspec_tree.items()}
    return (mesh, placements(mesh, pspec_tree))


def abstract_params(model):
    """The parameter tree as ``meta`` tensors, allocating nothing (the
    model built on ``meta``: ``eval_shape`` of ``init``)."""
    meta = build_model(model.cfg, device="meta")
    return _map_with_path(lambda path, leaf: leaf, meta)

"""Mixture-of-Experts FFN with capacity-based routing (GShard-style).

The port of the reference package's ``repro.models.moe``, local path only:
all experts on one device (the reference's fallback without a mesh, which
is also its oracle for the expert-parallel path).  Expert parallelism over
the ``model`` axis (``shard_map`` with a psum combine) waits for the mesh
slice, and asking for it raises.

Capacity semantics: each expert accepts at most C = ceil(cf·k·T/E) tokens;
overflow tokens are dropped for that expert (standard GShard). Slot C is a
scratch row that absorbs dropped tokens and is discarded.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.sharding import _MESH_SLICE, MeshAxes, sc


def moe_params(gen, cfg: ModelConfig, layers: int | None = None):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    pre = () if layers is None else (layers,)
    dt = cfg.param_dtype
    return {
        "router": L.dense_init(gen, (*pre, d, e), dtype=dt),
        "w_gate": L.dense_init(gen, (*pre, e, d, f), in_axis=-2, dtype=dt),
        "w_up": L.dense_init(gen, (*pre, e, d, f), in_axis=-2, dtype=dt),
        "w_down": L.dense_init(gen, (*pre, e, f, d), in_axis=-2, dtype=dt),
    }


def capacity(cfg: ModelConfig, tokens: int) -> int:
    return max(1, math.ceil(cfg.capacity_factor * cfg.experts_per_token *
                            tokens / cfg.num_experts))


def _moe_local(xf, router, w_gate, w_up, w_down, *, cfg: ModelConfig):
    """MoE over the tokens ``xf`` (T, D) with all E experts local (the
    reference's ``_moe_local`` with ``model_axis=None``).

    Returns ``(y (T, D), aux (2,) [load_balance, router_z])``.  Each
    expert gathers its routed tokens into a (C+1, D) buffer by their
    running count (``index_add_``, the reference's ``.at[slot].add``), so a
    token past capacity lands in the scratch row C and contributes
    nothing."""
    T, D = xf.shape
    E = cfg.num_experts
    k = cfg.experts_per_token
    cd = cfg.compute_dtype
    f32 = torch.float32

    logits = xf.to(f32) @ router.to(f32)  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)  # (T, k), sorted
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    C = capacity(cfg, T)
    x_cd = xf.to(cd)

    def per_expert(wg_e, wu_e, wd_e, e_id):
        w_te = torch.sum(torch.where(gate_idx == e_id, gate_vals, 0.0),
                         dim=-1)  # (T,)
        m = w_te > 0
        posn = torch.cumsum(m.to(torch.int32), dim=0) - 1
        keep = m & (posn < C)
        slot = torch.where(keep, posn, C)
        buf = torch.zeros((C + 1, D), dtype=cd, device=xf.device).index_add_(
            0, slot, torch.where(m[:, None], x_cd, 0))
        h = F.silu(buf @ wg_e.to(cd)) * (buf @ wu_e.to(cd))
        out = h @ wd_e.to(cd)  # (C+1, D)
        return out[slot] * torch.where(keep, w_te, 0.0)[:, None].to(cd)

    # one unbind a weight: a backward through the experts' slices is one
    # stack, not a full-size gradient a slice summed over the experts
    ys = torch.stack([per_expert(wg, wu, wd, e) for e, (wg, wu, wd) in
                      enumerate(zip(w_gate.unbind(0), w_up.unbind(0),
                                    w_down.unbind(0)))])
    y = torch.sum(ys, dim=0)  # (T, D)

    # auxiliary losses (Switch/GShard load balancing + router z-loss)
    f_e = torch.mean(torch.sum(F.one_hot(gate_idx, E).to(f32), dim=1), dim=0)
    p_e = torch.mean(probs, dim=0)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    load = E * torch.sum(f_e * p_e)
    return y, torch.stack([load, z])


def moe_ffn(x, p, cfg: ModelConfig, axes: MeshAxes, mesh=None):
    """MoE FFN. x: (B, S, D) -> (y: (B, S, D), aux: (2,) [load_balance, z]).

    The local path; an enabled mesh (expert parallelism) raises.
    """
    B, S, D = x.shape
    if axes.enabled:
        raise NotImplementedError(_MESH_SLICE)
    xf = x.reshape(B * S, D)
    y, aux = _moe_local(xf, p["router"], p["w_gate"], p["w_up"],
                        p["w_down"], cfg=cfg)
    y = sc(y.reshape(B, S, D), axes, "batch", None, None)
    return y, aux


def moe_block(x, p, cfg: ModelConfig, axes: MeshAxes, angles, mesh=None, *,
              causal: bool = True):
    """Pre-norm attention + MoE-FFN block."""
    cd = cfg.compute_dtype
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = L.project_qkv(h, p["attn"], cfg, axes, angles)
    o = L.full_attention(q, k, v, cfg, axes, causal=causal)
    x = x + (o @ p["attn"]["wo"].to(cd))
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    y, aux = moe_ffn(h, p["moe"], cfg, axes, mesh)
    return x + y, aux

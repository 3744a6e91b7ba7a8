"""Mixture-of-Experts FFN with capacity-based routing (GShard-style) and
expert parallelism over the ``model`` mesh axis.

The port of the reference package's ``repro.models.moe``.  Design
(DESIGN.md §6 EP): at the MoE boundary the hidden states are already
replicated over the model axis, so dispatch is *local masking + scatter
into a capacity buffer* on the rank that owns the expert, and combine is a
single sum over the model axis — no all-to-all.  The reference's
``shard_map`` region runs on local shards (:func:`_moe_sharded`): each
model rank runs :func:`_moe_local` over its ``E / tp`` experts.  Without a
mesh all E experts are local (the reference's fallback, also its oracle
for the expert-parallel path).

Capacity semantics: each expert accepts at most C = ceil(cf·k·T/E) tokens
per shard (T the shard's tokens); overflow tokens are dropped for that
expert (standard GShard). Slot C is a scratch row that absorbs dropped
tokens and is discarded.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import sharding as SH
from repro_torch.models.sharding import MeshAxes, P, sc


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


def _moe_local(xf, router, w_gate, w_up, w_down, *, cfg: ModelConfig,
               region=None):
    """MoE over the tokens ``xf`` (T, D) and the experts ``w_*`` hold.

    Without ``region`` all E experts are local (the reference's
    ``_moe_local`` with ``model_axis=None``).  Inside the expert-parallel
    region, ``region`` is ``(shard, model groups, batch groups, batch
    ranks)``: the ``w_*`` hold ``E_loc`` experts, expert ``e_local`` is
    ``shard * E_loc + e_local``, ``xf`` is replicated over the model axis
    and enters the experts through ``copy_to`` with the gate values, the
    experts' outputs are summed over it (``reduce_from``), and the
    load-balance statistics are averaged over the batch axes.

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
    E_loc = w_gate.shape[0]
    shard, model, batch, n_batch = region or (0, (), (), 1)

    logits = xf.to(f32) @ router.to(f32)  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)  # (T, k), sorted
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    C = capacity(cfg, T)
    x_cd = SH.copy_to(xf.to(cd), model)
    g_vals = SH.copy_to(gate_vals, model)

    def per_expert(wg_e, wu_e, wd_e, e_local):
        e_id = shard * E_loc + e_local
        w_te = torch.sum(torch.where(gate_idx == e_id, g_vals, 0.0),
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
    y = SH.reduce_from(torch.sum(ys, dim=0), model)  # (T, D)

    # auxiliary losses (Switch/GShard load balancing + router z-loss)
    f_e = torch.mean(torch.sum(F.one_hot(gate_idx, E).to(f32), dim=1), dim=0)
    p_e = torch.mean(probs, dim=0)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    if batch and model:
        f_e = SH.mean_over(f_e, batch, n_batch)
        p_e = SH.mean_over(p_e, batch, n_batch)
        z = SH.mean_over(z, batch, n_batch)
    load = E * torch.sum(f_e * p_e)
    return y, torch.stack([load, z])


def _moe_sharded(xf, p, cfg: ModelConfig, axes: MeshAxes, mesh):
    """The reference's expert-parallel ``shard_map`` region on local
    shards: tokens ``P(batch, None)``, the router replicated, the experts
    ``P(model, None, None)``, cast to ``compute_dtype`` before the region
    as the reference casts them (the ZeRO gather of each expert then moves
    half the bytes).  The router and the experts are used on each batch
    rank's own tokens, so their gradients are partial over the batch
    axes.  Returns ``(y P(batch, None), aux P())``."""
    b = axes.bspec
    cd = cfg.compute_dtype
    xl = SH.to_region(xf, P(b, None))
    router = SH.to_region(p["router"], P(None, None), partial=axes.batch)
    ws = [SH.to_region(p[name].to(cd), P(axes.model, None, None),
                       partial=axes.batch)
          for name in ("w_gate", "w_up", "w_down")]
    region = (mesh.get_local_rank(axes.model),
              SH.axis_groups(mesh, axes.model),
              SH.axis_groups(mesh, axes.batch), SH.axis_size(mesh, axes.batch))
    y, aux = _moe_local(xl, router, *ws, cfg=cfg, region=region)
    return (SH.from_region(y, mesh, P(b, None)),
            SH.from_region(aux, mesh, P()))


def moe_ffn(x, p, cfg: ModelConfig, axes: MeshAxes, mesh=None):
    """MoE FFN. x: (B, S, D) -> (y: (B, S, D), aux: (2,) [load_balance, z]).

    With a mesh and sharding enabled, experts are sharded over
    ``axes.model`` (EP); otherwise runs the dense local fallback (also the
    reference oracle for equivalence tests).
    """
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    if axes.enabled and mesh is not None and axes.model is not None:
        tp = SH.axis_size(mesh, axes.model)
        if cfg.num_experts % tp:
            raise AssertionError(f"num_experts={cfg.num_experts} must divide "
                                 f"model axis {tp}")
        y, aux = _moe_sharded(xf, p, cfg, axes, mesh)
    else:
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

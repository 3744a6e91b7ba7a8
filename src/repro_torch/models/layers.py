"""Core neural-net layers in plain PyTorch: norms, RoPE/M-RoPE, GQA
attention (prefill with chunked queries + single-step decode), MLPs.

The port of the reference package's ``repro.models.layers``, op for op and
in the reference's order, so that bf16 rounding follows the same steps:

  * params are nested dicts of tensors (a :class:`ParamTree` module, or a
    plain dict of one layer's slices), weights in the reference's
    ``(in, out)`` layout, applied as ``x @ w``;
  * every function takes ``axes: MeshAxes`` and applies activation
    constraints through :func:`repro_torch.models.sharding.sc` at the
    reference's call sites (the identity without a mesh; on a mesh a
    ``redistribute`` of the DTensor activations);
  * compute happens in ``cfg.compute_dtype`` (bf16), softmax/norm
    statistics in fp32;
  * ``jax.lax.scan`` over stacked layer params is :func:`xscan`, a Python
    loop over the leading dimension;
  * the init helpers draw from an explicit ``torch.Generator`` (different
    numbers from ``jax.random``: compare the two packages on carried
    weights, ``models/carry.py``, never on two inits).

The attention here is the reference's plain-``jnp`` function, which its
models call (``cfg.attn_impl`` is read nowhere), not the flash-attention
kernel of ``kernels/ops.py``.  Training differentiates these functions
with autograd (the reference: ``jax.value_and_grad``); :func:`_tp_out`
tags the two outputs that ``cfg.remat = "tp_out"`` saves.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharding as SH
from repro_torch.models.sharding import MeshAxes, P, sc
from repro_torch.obs import tracer as obs


# ---------------------------------------------------------------------------
# parameter trees and the layer loop
# ---------------------------------------------------------------------------


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: each leaf an ``nn.Parameter``
    named after its key, each inner dict a child ``ParamTree``, so
    ``named_parameters()`` gives the reference tree's paths
    (``layers.attn.wq``) and ``p["attn"]["wq"]`` reads like the
    reference's dict.  Serving never differentiates, so the parameters
    are made without gradients; training turns them on
    (``train_loop.make_train_step`` calls ``requires_grad_(True)``)."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        if key in self._modules:
            return self._modules[key]
        raise KeyError(key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def keys(self) -> list:
        return [*self._parameters, *self._modules]

    def get(self, key: str, default=None):
        return self[key] if key in self else default


def _leading(xs) -> int:
    if isinstance(xs, (dict, ParamTree)):
        return _leading(xs[next(iter(xs.keys()))])
    if isinstance(xs, (tuple, list)):
        return _leading(next(x for x in xs if x is not None))
    return xs.shape[0]


def _stack(ys: list):
    """The per-step outputs stacked leaf by leaf (``lax.scan``'s ys)."""
    first = ys[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack([y[k] for y in ys]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([y[j] for y in ys])
                           for j in range(len(first)))
    return torch.stack(ys)


def tree_unbind(xs, n: int) -> list:
    """The ``n`` slices along the leading dimension of every leaf of a
    tree, as ``n`` trees: one ``unbind`` a leaf, so a backward through the
    slices is one ``stack`` a leaf (indexing each slice alone would give
    each its own full-size gradient, summed over the stack)."""
    if xs is None:
        return [None] * n
    if isinstance(xs, (dict, ParamTree)):
        cols = {k: tree_unbind(xs[k], n) for k in xs.keys()}
        return [{k: c[i] for k, c in cols.items()} for i in range(n)]
    if isinstance(xs, (tuple, list)):
        cols = [tree_unbind(x, n) for x in xs]
        return [type(xs)(c[i] for c in cols) for i in range(n)]
    return list(torch.unbind(xs, 0))


def xscan(cfg: ModelConfig, body, carry, xs, index: bool = False):
    """``lax.scan(body, carry, xs)`` as a Python loop over the leading
    dimension of ``xs``; returns ``(carry, stacked ys)``.  Always unrolled,
    so ``cfg.unroll_scans`` has nothing to change.  With ``index`` the
    body is called ``body(carry, x_i, i)``."""
    ys = []
    for i, x_i in enumerate(tree_unbind(xs, _leading(xs))):
        carry, y = body(carry, x_i, i) if index else body(carry, x_i)
        ys.append(y)
    return carry, (_stack(ys) if ys else None)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _device(gen):
    """The generator's device; None (the ambient device, e.g. ``meta``
    while a model is only being shaped) without a generator."""
    return gen.device if gen is not None else None


def normal(gen, shape):
    return torch.randn(shape, generator=gen, device=_device(gen))


def full(gen, shape, value: float, dtype):
    return torch.full(shape, value, dtype=dtype, device=_device(gen))


def dense_init(gen, shape, in_axis: int = -2, dtype=torch.float32):
    fan_in = shape[in_axis]
    return (normal(gen, shape) * (fan_in**-0.5)).to(dtype)


def embed_init(gen, shape, dtype=torch.float32):
    return (normal(gen, shape) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x, w, eps: float = 1e-5):
    """RMSNorm with fp32 *statistics* but a bf16 data path: only the
    (B, S, 1) statistic is computed in fp32, and ``x * inv * w`` runs in
    ``x``'s dtype, left to right, as in the reference."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(dt)  # (B, S, 1) statistic only
    return x * inv * w.to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings (RoPE + M-RoPE)
# ---------------------------------------------------------------------------


def rope_angles(positions, head_dim: int, theta: float, sections=()):
    """Rotation angles, shape (..., S, head_dim//2).

    ``positions``: (B, S) int32 for plain RoPE, or (3, B, S) for M-RoPE where
    the three streams are (temporal, height, width) position ids. ``sections``
    partitions head_dim//2 among the three streams (Qwen2-VL).
    """
    half = head_dim // 2
    dev = positions.device
    inv_freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                             device=dev) / half))
    if sections:
        if sum(sections) != half or positions.dim() != 3:
            raise ValueError(f"M-RoPE sections {tuple(sections)} must sum "
                             f"to {half} over (3, B, S) positions, got "
                             f"{tuple(positions.shape)}")
        # (half,) -> the stream each frequency reads (filled on the
        # device: no host-to-device copy in a decode step)
        sec_id = torch.cat([torch.full((n,), i, device=dev)
                            for i, n in enumerate(sections)])
        pos = positions.to(torch.float32)[sec_id]  # (half, B, S)
        return torch.movedim(pos, 0, -1) * inv_freq  # (B, S, half)
    return positions.to(torch.float32)[..., None] * inv_freq


def apply_rope(x, angles):
    """x: (B, S, H, Dh); angles: (B, S, Dh//2). Rotate-half convention."""
    half = x.shape[-1] // 2
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attn_params(gen, cfg: ModelConfig, layers: int | None = None, dtype=None):
    """Stacked attention params; ``layers=None`` -> unstacked (shared block)."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    pre = () if layers is None else (layers,)
    dtype = dtype or cfg.param_dtype
    p = {
        "wq": dense_init(gen, (*pre, d, qd), dtype=dtype),
        "wk": dense_init(gen, (*pre, d, kvd), dtype=dtype),
        "wv": dense_init(gen, (*pre, d, kvd), dtype=dtype),
        "wo": dense_init(gen, (*pre, qd, d), dtype=dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = full(gen, (*pre, cfg.head_dim), 1.0, dtype)
        p["k_norm"] = full(gen, (*pre, cfg.head_dim), 1.0, dtype)
    return p


def project_qkv(x, p, cfg: ModelConfig, axes: MeshAxes, angles, kv_x=None):
    """Project to q/k/v heads, apply qk-norm and RoPE.

    ``kv_x``: source for k/v (cross-attention; no RoPE applied then);
    defaults to ``x``. Returns q (B,Sq,Hq,Dh), k,v (B,Skv,Hkv,Dh).
    """
    cd = cfg.compute_dtype
    cross = kv_x is not None
    kv_x = x if kv_x is None else kv_x
    B, Sq, _ = x.shape
    Skv = kv_x.shape[1]
    q = _heads(x @ p["wq"].to(cd), cfg.num_heads, cfg.head_dim)
    k = _heads(kv_x @ p["wk"].to(cd), cfg.num_kv_heads, cfg.head_dim)
    v = _heads(kv_x @ p["wv"].to(cd), cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if angles is not None and not cross:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    q = sc(q, axes, "batch", None, "model", None)
    k = sc(k, axes, "batch", None, None, None)
    v = sc(v, axes, "batch", None, None, None)
    return q, k, v


def _heads(x, H: int, Dh: int):
    """(B, S, H*Dh) -> (B, S, H, Dh).  On a mesh, DTensor's ``view``
    cannot split a dimension sharded over n ranks into H heads unless n
    divides H: such a dimension is gathered over those ranks first."""
    if isinstance(x, DTensor):
        mesh, pl = x.device_mesh, list(x.placements)
        keep = [p if not (isinstance(p, Shard) and p.dim == x.dim() - 1
                          and H % mesh.size(i)) else Replicate()
                for i, p in enumerate(pl)]
        if keep != pl:
            x = x.redistribute(mesh, keep)
    return x.reshape(*x.shape[:-1], H, Dh)


def _repeat_kv(k, num_heads: int):
    """(B,S,Hkv,Dh) -> (B,S,Hq,Dh) by repeating each kv head for its group."""
    return torch.repeat_interleave(k, num_heads // k.shape[2], dim=2)


def full_attention(q, k, v, cfg: ModelConfig, axes: MeshAxes, *, causal: bool,
                   q_chunk: int | None = None, scale: float | None = None):
    """Chunked-query full attention (flash-style blocking in plain ops).

    Looping over query chunks bounds peak score memory at
    (B, H, q_chunk, Skv) instead of (B, H, Sq, Skv).  The softmax is taken
    in fp32 over a ``-inf`` causal mask and cast back, as in the reference
    (no ``F.scaled_dot_product_attention``: its numerics differ).  The
    scores are scaled by ``scale``, ``Dh ** -0.5`` by default.  The scores,
    softmax and weighted sum run in the ``attn.core`` span (``tokens=``);
    the ``attn.scores`` counter gives the score elements a call
    materialises, B·H·Sq·Skv.

    On a mesh the reference constrains q, k, v, the scores and the output
    to batch on the batch axes and heads on the model axis; attention is
    independent across both, so it runs on each rank's local shards
    (:func:`sharding.to_region`, no communication), as GSPMD runs it: the
    einsums' flattening of sharded batch and head dimensions has no
    sharding rule in every DTensor release.
    """
    B, Sq, Hq, Dh = q.shape
    k = _repeat_kv(k, Hq)
    v = _repeat_kv(v, Hq)
    k = sc(k, axes, "batch", None, "model", None)
    v = sc(v, axes, "batch", None, "model", None)
    scale = Dh**-0.5 if scale is None else scale
    obs.counter("attn.scores", B * Hq * Sq * k.shape[1])
    if not axes.enabled:
        with obs.span("attn.core", tokens=B * Sq):
            out = _attend(q, k, v, cfg, causal, q_chunk, scale)
        return out.reshape(B, Sq, Hq * Dh)
    spec = P(axes.bspec, None, axes.model, None)
    q = sc(q, axes, *spec)
    ql, kl, vl = (SH.to_region(t, spec) for t in (q, k, v))
    with obs.span("attn.core", tokens=B * Sq):
        out = SH.from_region(_attend(ql, kl, vl, cfg, causal, q_chunk, scale),
                             q.device_mesh, spec, shape=q.shape)
    if Hq % SH.axis_size(q.device_mesh, axes.model):
        # heads split unevenly: whole heads on every rank before the
        # flatten, which DTensor cannot split by heads; the flatten's
        # backward unflattens the gradient, so that too arrives whole
        out = sc(out, axes, "batch", None, None, None)
        return SH.grad_placed_as_value(out.reshape(B, Sq, Hq * Dh))
    return out.reshape(B, Sq, Hq * Dh)


def _attend(q, k, v, cfg: ModelConfig, causal: bool, q_chunk, scale: float):
    """The attention of (B, Sq, H, Dh) ``q`` over ``k``/``v`` (B, Skv, H,
    Dh), whole or one rank's shards, its scores scaled by ``scale``;
    (B, Sq, H, Dh)."""
    B, Sq, Hq, Dh = q.shape
    Skv = k.shape[1]
    qc = min(q_chunk or cfg.attn_q_chunk, Sq)
    n_chunks = Sq // qc
    k_idx = torch.arange(Skv, device=q.device)

    def one_chunk(qb, q0: int):
        s = torch.einsum("bqhd,bkhd->bhqk", qb, k) * scale
        if causal:
            q_idx = q0 + torch.arange(qc, device=q.device)
            mask = q_idx[:, None] >= k_idx[None, :]
            s = s.masked_fill(~mask[None, None], float("-inf"))
        a = torch.softmax(s.to(torch.float32), dim=-1).to(qb.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", a, v)

    if n_chunks <= 1:
        return one_chunk(q, 0)
    qr = q.reshape(B, n_chunks, qc, Hq, Dh)
    return torch.cat([one_chunk(qr[:, c], c * qc) for c in range(n_chunks)],
                     dim=1)


def decode_attention(q, k_cache, v_cache, pos, cfg: ModelConfig,
                     axes: MeshAxes, scale: float | None = None):
    """Single-token attention against a (possibly seq-sharded) KV cache.

    q: (B, 1, Hq, Dh); caches: (B, Smax, Hkv, Dh); ``pos``: 0-d int tensor
    (or int) — number of valid cache entries (positions >= pos are masked
    out).  The grouped ``(B, Hkv, group, Dh)`` form avoids materializing a
    repeated cache.

    When ``axes.kv_partition == "seq"`` on a mesh the cache's sequence dim
    is sharded over the model axis (flash-decoding,
    :func:`_decode_attention_seq`): the softmax statistics and the
    weighted sum reduce over the model axis.  Otherwise kv-heads are
    sharded and attention is local: on a mesh it runs on each rank's
    heads (as :func:`full_attention` does).  The scores are scaled by
    ``scale``, ``Dh ** -0.5`` by default.
    """
    B, _, Hq, Dh = q.shape
    scale = Dh**-0.5 if scale is None else scale
    if axes.kv_partition == "seq":
        cache_spec = ("batch", "model", None, None)
    else:
        cache_spec = ("batch", None, "model", None)
    k_cache = sc(k_cache, axes, *cache_spec)
    v_cache = sc(v_cache, axes, *cache_spec)
    if not axes.enabled:
        return _decode_attend(q, k_cache, v_cache, pos, scale).reshape(
            B, 1, Hq * Dh)
    if axes.kv_partition == "seq" and axes.model:
        return _decode_attention_seq(q, k_cache, v_cache, pos, axes, scale)
    spec = P(axes.bspec, None, axes.model, None)
    q = sc(q, axes, *spec)
    ql, kl, vl = (SH.to_region(t, spec) for t in (q, k_cache, v_cache))
    out = SH.from_region(_decode_attend(ql, kl, vl, pos, scale),
                         q.device_mesh, spec, shape=q.shape)
    return out.reshape(B, 1, Hq * Dh)


def _decode_attend(q, k_cache, v_cache, pos, scale: float):
    """Grouped single-token attention, whole or one rank's heads; (B, 1,
    Hq, Dh)."""
    B, _, Hq, Dh = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    group = Hq // Hkv
    qg = q.reshape(B, Hkv, group, Dh)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache) * scale
    valid = (torch.arange(Smax, device=q.device) < _local(pos))
    s = s.to(torch.float32).masked_fill(~valid[None, None, None, :],
                                        float("-inf"))
    a = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhgk,bkhd->bhgd", a, v_cache)
    return o.reshape(B, 1, Hq, Dh)


def _local(x):
    """A replicated DTensor's value on this rank; any other value as is."""
    return x.to_local() if isinstance(x, DTensor) else x


def _decode_attention_seq(q, k_cache, v_cache, pos, axes: MeshAxes,
                          scale: float):
    """Flash-decoding over a cache whose sequence is sharded on the model
    axis (what GSPMD makes of the reference's constraints), on local
    shards: each model rank scores its positions, the maximum and the
    exponentials' sum are reduced over the model axis, and each rank's
    share of the weighted sum of ``v`` is summed over it.  Inference
    only: no gradient crosses these sums."""
    mesh = k_cache.device_mesh
    b = axes.bspec
    groups = SH.axis_groups(mesh, axes.model)
    B, _, Hq, Dh = q.shape
    Hkv = k_cache.shape[2]
    ql = SH.to_region(q, P(b, None, None, None))
    kl = SH.to_region(k_cache, P(b, axes.model, None, None))
    vl = SH.to_region(v_cache, P(b, axes.model, None, None))
    s_loc = kl.shape[1]
    first = mesh.get_local_rank(axes.model) * s_loc
    qg = ql.reshape(ql.shape[0], Hkv, Hq // Hkv, Dh)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, kl) * scale
    valid = (first + torch.arange(s_loc, device=s.device)) < _local(pos)
    s = s.to(torch.float32).masked_fill(~valid[None, None, None, :],
                                        float("-inf"))
    gmax = SH.max_over(torch.amax(s, dim=-1, keepdim=True), groups)
    e = torch.exp(s - gmax)
    a = (e / SH.reduce_from(torch.sum(e, dim=-1, keepdim=True), groups)
         ).to(ql.dtype)
    o = SH.reduce_from(torch.einsum("bhgk,bkhd->bhgd", a, vl), groups)
    return SH.from_region(o.reshape(o.shape[0], 1, Hq * Dh), mesh,
                          P(b, None, None))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_params(gen, cfg: ModelConfig, layers: int | None = None, dtype=None):
    d, f = cfg.d_model, cfg.d_ff
    pre = () if layers is None else (layers,)
    dtype = dtype or cfg.param_dtype
    if cfg.mlp_kind == "swiglu":
        return {
            "w_gate": dense_init(gen, (*pre, d, f), dtype=dtype),
            "w_up": dense_init(gen, (*pre, d, f), dtype=dtype),
            "w_down": dense_init(gen, (*pre, f, d), dtype=dtype),
        }
    return {
        "w_up": dense_init(gen, (*pre, d, f), dtype=dtype),
        "w_down": dense_init(gen, (*pre, f, d), dtype=dtype),
    }


def _ar_boundary(x, cfg: ModelConfig):
    """The reference's optimization barrier after TP matmuls (keeps XLA's
    model-axis all-reduce in bf16): a value identity.  DTensor reduces
    the product's partial sums in its own dtype, so there is nothing to
    pin."""
    return x


@torch.library.custom_op("repro_torch::checkpoint_name", mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``jax.ad_checkpoint.checkpoint_name``: the value of ``x`` under an
    operator of its own, which a selective-checkpoint policy can name
    (``transformer._remat``'s ``"tp_out"``).  A custom operator may not
    return its input, so it returns a copy."""
    return x.clone()


@checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x)


checkpoint_name.register_autograd(
    lambda ctx, grad: (grad, None))


def _tp_out(x, name: str, cfg: ModelConfig):
    """The reference's remat tag on the TP-psum outputs (``attn_out``,
    ``mlp_out``): a value identity.  Under ``cfg.remat = "tp_out"``, where
    the value takes part in a gradient, it passes through
    :func:`checkpoint_name` (a copy), so that policy can save exactly
    these outputs; every other setting, and serving, gets ``x`` itself."""
    if cfg.remat == "tp_out" and torch.is_grad_enabled() and x.requires_grad:
        return checkpoint_name(x, name)
    return x


def gated_gelu_mlp(x, p, cfg: ModelConfig, adapter=None):
    """The released Zamba2's MLP: ``gate_up = x @ w_gate_up``, plus the
    low-rank ``(x @ lora_a) @ lora_b`` of ``adapter`` (one application's),
    then ``(GELU(gate) * up) @ w_down`` with the exact (erf) GELU.  Runs
    unsharded (``models/transformer.py:Zamba2LM``)."""
    cd = cfg.compute_dtype
    gu = x @ p["w_gate_up"].to(cd)
    if adapter is not None:
        gu = gu + (x @ adapter["lora_a"].to(cd)) @ adapter["lora_b"].to(cd)
    gate, up = gu.chunk(2, dim=-1)
    return (F.gelu(gate) * up) @ p["w_down"].to(cd)


def mlp_block(x, p, cfg: ModelConfig, axes: MeshAxes):
    cd = cfg.compute_dtype
    if cfg.mlp_kind == "swiglu":
        g = x @ p["w_gate"].to(cd)
        u = x @ p["w_up"].to(cd)
        h = F.silu(g) * u
    else:  # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["w_up"].to(cd), approximate="tanh")
    h = sc(h, axes, "batch", None, "model")
    out = _tp_out(_ar_boundary(h @ p["w_down"].to(cd), cfg), "mlp_out",
                  cfg)
    return sc(out, axes, "batch", None, None)


# ---------------------------------------------------------------------------
# transformer block (attention + MLP, pre-norm)
# ---------------------------------------------------------------------------


def block_params(gen, cfg: ModelConfig, layers: int | None = None):
    pre = () if layers is None else (layers,)
    return {
        "attn": attn_params(gen, cfg, layers),
        "mlp": mlp_params(gen, cfg, layers),
        "ln1": full(gen, (*pre, cfg.d_model), 1.0, cfg.param_dtype),
        "ln2": full(gen, (*pre, cfg.d_model), 1.0, cfg.param_dtype),
    }


def transformer_block(x, p, cfg: ModelConfig, axes: MeshAxes, angles, *,
                      causal: bool = True):
    """Pre-norm self-attention + MLP residual block (prefill)."""
    cd = cfg.compute_dtype
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = project_qkv(h, p["attn"], cfg, axes, angles)
    o = full_attention(q, k, v, cfg, axes, causal=causal)
    x = x + _tp_out(_ar_boundary(o @ p["attn"]["wo"].to(cd), cfg),
                    "attn_out", cfg)
    x = sc(x, axes, "batch", None, None)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + mlp_block(h, p["mlp"], cfg, axes)
    return sc(x, axes, "batch", None, None)


def cross_attn_sublock(x, p, ln, cfg: ModelConfig, axes: MeshAxes, enc_out):
    """Pre-norm cross-attention residual sub-block (enc-dec training and
    prefill path).

    ``p``: attention params; ``ln``: the norm weight; no RoPE on cross-attn.
    """
    cd = cfg.compute_dtype
    h = rms_norm(x, ln, cfg.norm_eps)
    q, k, v = project_qkv(h, p, cfg, axes, None, kv_x=enc_out)
    o = full_attention(q, k, v, cfg, axes, causal=False)
    return x + (o @ p["wo"].to(cd))


def cache_write(cache, new, pos):
    """``dynamic_update_slice(cache, new, (0, pos, 0, 0))`` in place: writes
    ``new`` (B, 1, Hkv, Dh) at sequence position ``pos`` (a 0-d tensor or
    int, within the cache) of the (B, Smax, Hkv, Dh) ``cache`` and returns
    it.  The caller owns ``cache``: a decode step passes its layer's view
    of the one copy of the stacked cache that the step makes.  A DTensor
    cache is written shard by shard (:func:`_cache_write_sharded`)."""
    if isinstance(cache, DTensor):
        return _cache_write_sharded(cache, new, pos)
    idx = torch.as_tensor(pos, device=cache.device).reshape(1).long()
    return cache.index_copy_(1, idx, new.to(cache.dtype))


def _cache_write_sharded(cache, new, pos):
    """:func:`cache_write` on a DTensor cache, on its local shard (DTensor
    has no sharding rule for ``index_copy_``): ``new`` is placed as the
    cache is, with its one position replicated, and written by the rank
    whose sequence shard holds ``pos`` (every rank writes, each its own
    row or, off its shard, its row back unchanged: no host sync)."""
    mesh = cache.device_mesh
    pl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
          for p in cache.placements]
    new = new.to(cache.dtype)
    if isinstance(new, DTensor):
        new = new.redistribute(mesh, pl)
    else:
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False).redistribute(mesh, pl)
    local = cache.to_local()
    s_loc = local.shape[1]
    first = 0
    for i, p in enumerate(cache.placements):
        if isinstance(p, Shard) and p.dim == 1:
            first = first * mesh.size(i) + mesh.get_local_rank(i)
    first *= s_loc
    at = torch.as_tensor(_local(pos), device=local.device).reshape(1).long()
    at = at - first
    mine = (at >= 0) & (at < s_loc)
    at = torch.clamp(at, 0, s_loc - 1)
    row = torch.where(mine, new.to_local(), local.index_select(1, at))
    local.index_copy_(1, at, row)
    return cache


def transformer_block_decode(x, p, cfg: ModelConfig, axes: MeshAxes, angles,
                             cache, pos):
    """Single-token decode block. ``cache``: {"k","v"} (B,Smax,Hkv,Dh).

    Writes this step's k/v at position ``pos`` into ``cache`` in place
    (:func:`cache_write`), then attends to positions ``< pos+1``. Returns
    (x, cache).
    """
    cd = cfg.compute_dtype
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = project_qkv(h, p["attn"], cfg, axes, angles)
    ck = cache_write(cache["k"], k, pos)
    cv = cache_write(cache["v"], v, pos)
    o = decode_attention(q, ck, cv, pos + 1, cfg, axes)
    x = x + (o @ p["attn"]["wo"].to(cd))
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + mlp_block(h, p["mlp"], cfg, axes)
    return x, {"k": ck, "v": cv}


def cross_block_decode(x, p, cfg: ModelConfig, axes: MeshAxes, enc_kv):
    """Cross-attention sub-block for enc-dec decode (k/v precomputed).
    ``p``: {"ln1": norm weight, "attn": attention params}."""
    cd = cfg.compute_dtype
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q = _heads(h @ p["attn"]["wq"].to(cd), cfg.num_heads, cfg.head_dim)
    S_enc = enc_kv["k"].shape[1]
    o = decode_attention(q, enc_kv["k"].to(cd), enc_kv["v"].to(cd), S_enc,
                         cfg, axes)
    return x + (o @ p["attn"]["wo"].to(cd))

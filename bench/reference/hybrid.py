"""The released Zamba2 language model (family ``hybrid``) in plain float32.

Written from transformers' ``models/zamba2/modeling_zamba2.py`` and
arXiv:2405.16712 (eq. 6).  With ``e`` the embedding output, application
``j`` of the shared blocks before layer ``i`` of ``hybrid_layer_ids``:

    u = RMSNorm_2d([h ; e])                  # block b = j mod mem_blocks
    a = Attn_b(u)                            # q, k, v from 2d, RoPE, causal
    m = MLP_b(RMSNorm_d(a)) with gate_up + (x A_j) B_j, GELU (erf)
    t = m Lin_j
    h = h + Mamba_i(RMSNorm(h + t))          # t enters the mixer only

and ``h = h + Mamba_i(RMSNorm(h))`` at every other layer; then the final
RMSNorm and the tied head.  The Mamba2 layer is the released one: a bias
after the causal conv, the gated norm taken over ``ssm_groups`` groups of
``d_inner``.  Attention scores are scaled by ``attn_scale_dim ** -0.5``
(``(head_dim / 2) ** -0.5`` in transformers), RoPE rotates halves
(theta ``rope_theta``).  Nothing here imports the program; every product
and every activation the configuration holds in its compute dtype goes
through the :class:`~bench.reference.common.Precision` it is given.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference import common as C


def leaf_specs(cfg: dict) -> dict:
    """Flat ``{name: (shape, init)}`` of the parameter tree, the program's
    names: ``embed``, ``ln_f``, ``layers.*`` stacked over the Mamba2
    layers, ``shared.*`` over the blocks and ``apps.*`` over the
    applications.  The adapters and linears are drawn like any weight
    (not zero, as fine-tuning starts them), so that each counts."""
    z = C.sizes(cfg)
    d, f, r = cfg["d_model"], cfg["d_ff"], cfg["adapter_rank"]
    qd = cfg["num_heads"] * cfg["head_dim"]
    kvd = cfg["num_kv_heads"] * cfg["head_dim"]
    nl, nb = cfg["num_layers"], cfg["mem_blocks"]
    na = len(cfg["hybrid_layer_ids"])
    specs = C.head_leaf_specs(cfg)
    for k, v in C.mamba_leaf_specs(cfg, (nl,)).items():
        specs[f"layers.{k}"] = v
    specs["layers.conv_bias"] = ((nl, z["conv_ch"]),
                                 ("normal", z["w"] ** -0.5))
    specs.update({
        "shared.ln1": ((nb, 2 * d), ("around_one",)),
        "shared.attn.wq": ((nb, 2 * d, qd), ("normal", (2 * d) ** -0.5)),
        "shared.attn.wk": ((nb, 2 * d, kvd), ("normal", (2 * d) ** -0.5)),
        "shared.attn.wv": ((nb, 2 * d, kvd), ("normal", (2 * d) ** -0.5)),
        "shared.attn.wo": ((nb, qd, d), ("normal", qd ** -0.5)),
        "shared.ln2": ((nb, d), ("around_one",)),
        "shared.mlp.w_gate_up": ((nb, d, 2 * f), ("normal", d ** -0.5)),
        "shared.mlp.w_down": ((nb, f, d), ("normal", f ** -0.5)),
        "apps.lora_a": ((na, d, r), ("normal", d ** -0.5)),
        "apps.lora_b": ((na, r, 2 * f), ("normal", r ** -0.5)),
        "apps.linear": ((na, d, d), ("normal", d ** -0.5)),
    })
    return specs


def _slice(tree: dict, i: int) -> dict:
    return {k: (_slice(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------


def mamba_layer(x, p, cfg: dict, pr: C.Precision, inject=None,
                with_state: bool = False):
    """The released Zamba2 Mamba2 layer: (B, S, D) -> (B, S, D), and its
    (ssm, conv) decode state when ``with_state``.  ``inject`` joins the
    layer's input before its norm, not its residual."""
    z = C.sizes(cfg)
    Bsz, S, _ = x.shape
    eps = cfg["norm_eps"]
    u = C.rms_norm(x if inject is None else x + inject, p["ln"], eps)
    zg = C.mm(u, p["wz"], pr)
    xbc = torch.cat([C.mm(u, p["wx"], pr), C.mm(u, p["wB"], pr),
                     C.mm(u, p["wC"], pr)], dim=-1)
    dt = F.softplus(C.mm(u, p["wdt"], pr) + p["dt_bias"])
    conv_state = xbc[:, S - (z["w"] - 1):] if with_state else None
    xbc = F.silu(C.causal_conv(xbc, p["conv"]) + p["conv_bias"])
    di, gn = z["di"], z["g"] * z["n"]
    xs = xbc[..., :di].reshape(Bsz, S, z["h"], z["p"])
    Bm = xbc[..., di:di + gn].reshape(Bsz, S, z["g"], z["n"])
    Cm = xbc[..., di + gn:].reshape(Bsz, S, z["g"], z["n"])
    y, ssm_state = C.ssd(xs, dt, -torch.exp(p["A_log"]), Bm, Cm,
                         cfg["ssm_chunk"], pr)
    y = (y + p["D"][:, None] * xs).reshape(Bsz, S, di)
    y = gated_norm(y, zg, p["norm"], z["g"], eps)
    out = pr.act(x + C.mm(y, p["out"], pr))
    return (out, (ssm_state, conv_state)) if with_state else out


def gated_norm(y, zg, weight, groups: int, eps: float):
    """RMSNorm of ``y * SiLU(zg)`` (B, S, d_inner), one of ``groups``
    equal groups of its last axis at a time."""
    Bsz, S, di = y.shape
    y = (y * F.silu(zg)).reshape(Bsz, S, groups, di // groups)
    return C.rms_norm(y, weight.reshape(groups, -1), eps).reshape(Bsz, S, di)


def rope(x, positions, theta: float):
    """Rotate-half RoPE of (B, S, H, Dh) ``x`` at integer ``positions``
    (S,)."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = positions.to(torch.float32)[:, None] * inv      # (S, half)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, scale: float, pr: C.Precision):
    """Causal softmax attention of (B, S, H, Dh) heads, the softmax in
    float32; (B, S, H * Dh)."""
    B, S, H, Dh = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", pr.gemm(q), pr.gemm(k)) * scale
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", pr.gemm(a), pr.gemm(v))
    return pr.act(o.reshape(B, S, H * Dh))


def shared_block(h, e, bp: dict, ap: dict, cfg: dict, pr: C.Precision):
    """One application of a shared block over (B, S, D): its output ``t``
    (B, S, D) and its roped k and v (B, S, H, Dh)."""
    B, S, _ = h.shape
    eps = cfg["norm_eps"]
    H, Dh = cfg["num_heads"], cfg["head_dim"]
    u = C.rms_norm(torch.cat([h, e], dim=-1), bp["ln1"], eps)
    pos = torch.arange(S, device=h.device)
    q, k, v = (C.mm(u, bp["attn"][w], pr).reshape(B, S, H, Dh)
               for w in ("wq", "wk", "wv"))
    q = rope(q, pos, cfg["rope_theta"])
    k = rope(k, pos, cfg["rope_theta"])
    scale = cfg["attn_scale_dim"] ** -0.5
    a = C.mm(attention(q, k, v, scale, pr), bp["attn"]["wo"], pr)
    x = C.rms_norm(a, bp["ln2"], eps)
    gu = C.mm(x, bp["mlp"]["w_gate_up"], pr) + C.mm(
        C.mm(x, ap["lora_a"], pr), ap["lora_b"], pr)
    gate, up = gu.chunk(2, dim=-1)
    m = C.mm(F.gelu(gate) * up, bp["mlp"]["w_down"], pr)
    return pr.act(C.mm(m, ap["linear"], pr)), k, v


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _run(params: dict, tokens, cfg: dict, pr, collect: bool, remat: bool):
    """The trunk over a (B, S) batch: the last hidden states (B, S, D) and,
    with ``collect``, the state {"ssm", "conv", "kv": {"k", "v"}}.  With
    ``remat`` each layer and each application is recomputed in the
    backward."""
    def call(fn, *args):
        return (checkpoint(fn, *args, use_reentrant=False) if remat
                else fn(*args))

    x = e = C.embed(params, tokens, pr)
    at = {i: j for j, i in enumerate(cfg["hybrid_layer_ids"])}
    ssm, conv, ks, vs = [], [], [], []
    for i in range(cfg["num_layers"]):
        t = None
        if i in at:
            j = at[i]
            t, k, v = call(shared_block, x, e,
                           _slice(params["shared"], j % cfg["mem_blocks"]),
                           _slice(params["apps"], j), cfg, pr)
            ks.append(k)
            vs.append(v)
        lp = _slice(params["layers"], i)
        if collect:
            x, (s, c) = mamba_layer(x, lp, cfg, pr, t, with_state=True)
            ssm.append(s)
            conv.append(c)
        else:
            x = call(mamba_layer, x, lp, cfg, pr, t)
    if not collect:
        return x, None
    return x, {"ssm": torch.stack(ssm), "conv": torch.stack(conv),
               "kv": {"k": torch.stack(ks), "v": torch.stack(vs)}}


def hidden(params: dict, tokens, cfg: dict, pr=C.EXACT):
    """The final hidden states (B, S, D) of a (B, S) batch, before the
    final norm: ``common.logits`` of them are every position's logits."""
    return _run(params, tokens, cfg, pr, collect=False, remat=False)[0]


def prefill(params: dict, tokens, cfg: dict, pr=C.EXACT, pad_to=None):
    """Last-position logits (B, V) and the decode state {"ssm": (L, B, h,
    p, n), "conv": (L, B, w-1, ch), "kv": {"k", "v": (J, B, pad_to, H,
    Dh)}} of a (B, S) prompt batch; the KV entries past S are zero."""
    x, state = _run(params, tokens, cfg, pr, collect=True, remat=False)
    S = tokens.shape[1]
    if pad_to is not None and pad_to > S:
        state["kv"] = {n: F.pad(t, (0, 0, 0, 0, 0, pad_to - S))
                       for n, t in state["kv"].items()}
    return C.logits(x[:, -1], params, cfg, pr), state


def loss_sum(params: dict, tokens, labels, cfg: dict, pr=C.EXACT):
    """Sum of the token losses of a (B, S) batch; each layer and each
    application is recomputed in the backward (``checkpoint``), so the
    reference fits beside the program's sizes."""
    x, _ = _run(params, tokens, cfg, pr, collect=False, remat=True)
    return checkpoint(C.cross_entropy, x, params, labels, cfg, pr,
                      use_reentrant=False)

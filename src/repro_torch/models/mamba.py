"""Mamba2 (SSD — state-space duality) blocks in plain PyTorch
[arXiv:2405.21060].

The port of the reference's ``repro/models/mamba.py``, op for op: the
chunked SSD algorithm (``segsum``, ``ssd_chunked``: matrix-transformer form
within chunks, linear recurrence across chunks, the inter-chunk
``jax.lax.scan`` as a Python loop over chunks), the O(1)-per-token
recurrent step (``ssd_step``), and the Mamba2 block built on them: params,
the depthwise causal conv, the split projections, the prefill block that
hands its final SSM and conv state to decode, the decode step and the
decode state's shapes.  ``kernels/ref.py`` builds its SSD oracle on
``ssd_chunked``, as the reference's does.

The prefill block's scan takes one of two routes (:func:`ssd_route`, the
``route=`` of its ``mamba.ssd`` span).  ``"kernel"``: the hand-written
chunk-parallel scan of ``kernels/ssd_scan.py`` (``csrc/ssd_scan.cu``; f32
operands through 3xTF32), when the operands are real CUDA tensors, no mesh
axis is enabled and nothing needs a gradient; prefill and serving on the
card.  A shape or dtype the kernel does not take then raises (the
wrapper's check), as every kernel of the port does on the card.
``"plain"``: :func:`ssd_chunked_sharded` in every other case: the CPU (so
the CPU path is the reference's, op for op), training (the kernel has no
backward), a mesh and the dry run's fake tensors.  Decode's
:func:`ssd_step` is plain PyTorch always.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.models import sharding as SH
from repro_torch.models.layers import dense_init, full, normal, rms_norm
from repro_torch.models.sharding import MeshAxes, replicated, sc
from repro_torch.obs import tracer as obs


def segsum(x):
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} x[..., k] (i>=j),
    -inf elsewhere. x: (..., T) -> (..., T, T)."""
    T = x.shape[-1]
    xc = torch.cumsum(x, dim=-1)
    seg = xc[..., :, None] - xc[..., None, :]
    i = torch.arange(T, device=x.device)
    mask = replicated(i[:, None] >= i[None, :], seg)
    return torch.where(mask, seg, float("-inf"))


def _pad_tail(q: int, *arrays):
    """Each (b, s, ...) array zero-padded along s to a multiple of ``q``
    (for dt, 0: decay 1 and no contribution to the state)."""
    pad = (-arrays[0].shape[1]) % q
    if not pad:
        return arrays
    return tuple(F.pad(a, [0, 0] * (a.dim() - 2) + [0, pad]) for a in arrays)


def ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None):
    """Chunked SSD scan.

    x: (b, s, h, p)   head inputs
    dt: (b, s, h)     discretization steps (post-softplus)
    A: (h,)           negative decay rates
    B, C: (b, s, g, n) input/output projections (g groups broadcast to heads)
    Returns y: (b, s, h, p), final_state: (b, h, p, n).
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q = min(chunk, s)
    x, dt, B, C = _pad_tail(q, x, dt, B, C)
    s_orig, s = s, x.shape[1]
    c = s // q

    xd = (x * dt[..., None]).reshape(b, c, q, h, p)
    dA = (dt * A).reshape(b, c, q, h)
    rep = h // g
    Bh = torch.repeat_interleave(B.reshape(b, c, q, g, n), rep, dim=3)
    Ch = torch.repeat_interleave(C.reshape(b, c, q, g, n), rep, dim=3)

    dA_t = torch.movedim(dA, -1, 1)  # (b, h, c, q)
    dA_cs = torch.cumsum(dA_t, dim=-1)  # (b, h, c, q)

    # 1. intra-chunk (diagonal blocks)
    L = torch.exp(segsum(dA_t))  # (b, h, c, q, q)
    y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", Ch, Bh, L, xd)

    # 2. per-chunk final states
    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)  # (b, h, c, q)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bh, decay_states, xd)

    # 3. inter-chunk linear recurrence (sequential; c is small)
    chunk_decay = torch.exp(dA_cs[..., -1])  # (b, h, c)
    if initial_state is None:
        initial_state = replicated(torch.zeros(
            (b, h, p, n), dtype=states.dtype, device=states.device), states)
    carry, states_in = initial_state, []
    for ci in range(c):
        states_in.append(carry)  # the state *entering* this chunk
        carry = carry * chunk_decay[:, :, ci, None, None] + states[:, ci]
    final_state = carry
    states_in = torch.stack(states_in, dim=1)  # (b, c, h, p, n)

    # 4. state -> output
    state_decay = torch.exp(dA_cs)  # (b, h, c, q)
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Ch, states_in,
                         state_decay)

    y = (y_diag + y_off).reshape(b, s, h, p)[:, :s_orig]
    return y, final_state


def ssd_step(state, x_t, dt_t, A, B_t, C_t):
    """Single-token SSD recurrence.

    state: (b, h, p, n); x_t: (b, h, p); dt_t: (b, h); B_t, C_t: (b, g, n).
    Returns (y_t: (b, h, p), new_state).
    """
    h, g = x_t.shape[1], B_t.shape[1]
    rep = h // g
    Bh = torch.repeat_interleave(B_t, rep, dim=1)  # (b, h, n)
    Ch = torch.repeat_interleave(C_t, rep, dim=1)
    dA = torch.exp(dt_t * A)  # (b, h)
    upd = torch.einsum("bhp,bhn->bhpn", x_t * dt_t[..., None], Bh)
    new_state = state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y, new_state


def _group_heads(Bg, h: int):
    """(..., g, n) -> (..., h, n): each group's row repeated for its
    ``h // g`` heads (``repeat_interleave`` over the group dimension, as
    a broadcast and a reshape)."""
    *lead, g, n = Bg.shape
    return Bg.unsqueeze(-2).expand(*lead, g, h // g, n).reshape(*lead, h, n)


def _per_head(fn, axes: MeshAxes, args, dims, out_dims, out_shapes):
    """``fn`` on each rank's local shards of ``args`` (DTensors, entered
    at ``dims``, the ``sc`` entries), its outputs leaving as DTensors at
    ``out_dims`` of the whole ``out_shapes``.  An argument without a batch
    dimension (``A``) is used on each batch rank's own rows, so its
    gradient is partial over the batch axes.  The scan is independent
    across the batch and the heads, so on a mesh it runs on local shards
    with no communication, as GSPMD runs it: DTensor's rules for the
    einsums' products over sharded batch and head dimensions read values
    back to the host (a sync on the card, and no trace on fake
    tensors)."""
    mesh = args[0].device_mesh
    # grad_placed_as_value: the gradient that a placement change's
    # backward hands on is a strided shard, which a product's backward
    # upstream cannot view
    loc = [SH.to_region(sc(SH.grad_placed_as_value(a) if a.requires_grad
                           else a, axes, *d), SH.resolve(d, axes),
                        partial=() if "batch" in d else axes.batch)
           for a, d in zip(args, dims)]
    return tuple(SH.from_region(o, mesh, SH.resolve(d, axes), shape=shp)
                 for o, d, shp in zip(fn(*loc), out_dims, out_shapes))


def ssd_chunked_sharded(x, dt, A, B, C, chunk: int, axes: MeshAxes):
    """:func:`ssd_chunked` on a mesh (batch over ``axes.batch``, heads over
    ``axes.model``), on local shards (:func:`_per_head`); the groups of
    ``B``/``C`` are expanded to the heads first.  The identity of
    :func:`ssd_chunked` without an enabled ``axes``."""
    if not axes.enabled:
        return ssd_chunked(x, dt, A, B, C, chunk)
    b, s, h, p = x.shape
    n = B.shape[3]
    heads = ("batch", None, "model", None)
    return _per_head(
        lambda *a: ssd_chunked(*a, chunk), axes,
        (x, dt, A, _group_heads(B, h), _group_heads(C, h)),
        (heads, ("batch", None, "model"), ("model",), heads, heads),
        (heads, ("batch", "model", None, None)),
        ((b, s, h, p), (b, h, p, n)))


def _card_tensor(t) -> bool:
    """A CUDA tensor with storage: not a fake one (the dry run's)."""
    return t.is_cuda and not is_fake(t)


def ssd_route(x, dt, A, B, C, axes: MeshAxes) -> str:
    """``"kernel"`` where :func:`ssd_kernel` computes the scan, else
    ``"plain"`` (:func:`ssd_chunked_sharded`).  The kernel needs real CUDA
    operands, no enabled mesh axis and no operand that needs a gradient
    (it has no backward); the shapes and dtypes it takes are its wrapper's
    to check."""
    ops = (x, dt, A, B, C)
    if axes.enabled or not all(_card_tensor(t) for t in ops):
        return "plain"
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        return "plain"
    return "kernel"


def ssd_kernel(x, dt, A, B, C, chunk: int):
    """:func:`ssd_chunked`'s function through ``kernels/ssd_scan.py:
    ssd_scan``, the tail padded as :func:`ssd_chunked` pads it and y cut
    back.  Returns y: (b, s, h, p) in x's dtype and the final state
    (b, h, p, n) f32."""
    s = x.shape[1]
    q = min(chunk, s)
    x, dt, B, C = _pad_tail(q, x, dt, B, C)
    y, state = SSD.ssd_scan(x, dt, A, B, C, q)
    return y[:, :s], state


def ssd_step_sharded(state, x_t, dt_t, A, B_t, C_t, axes: MeshAxes):
    """:func:`ssd_step` on a mesh, on local shards (see
    :func:`ssd_chunked_sharded`); the identity of :func:`ssd_step` without
    an enabled ``axes``."""
    if not axes.enabled:
        return ssd_step(state, x_t, dt_t, A, B_t, C_t)
    h = x_t.shape[1]
    heads = ("batch", "model", None)
    return _per_head(
        ssd_step, axes,
        (state, x_t, dt_t, A, _group_heads(B_t, h), _group_heads(C_t, h)),
        (("batch", "model", None, None), heads, ("batch", "model"),
         ("model",), heads, heads),
        (heads, ("batch", "model", None, None)),
        (tuple(x_t.shape), tuple(state.shape)))


# ---------------------------------------------------------------------------
# full Mamba2 block
# ---------------------------------------------------------------------------


def mamba_params(gen, cfg: ModelConfig, layers: int | None = None):
    d, di = cfg.d_model, cfg.d_inner
    g, n, h, w = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    pre = () if layers is None else (layers,)
    dt = cfg.param_dtype
    return {
        "wz": dense_init(gen, (*pre, d, di), dtype=dt),
        "wx": dense_init(gen, (*pre, d, di), dtype=dt),
        "wB": dense_init(gen, (*pre, d, g * n), dtype=dt),
        "wC": dense_init(gen, (*pre, d, g * n), dtype=dt),
        "wdt": dense_init(gen, (*pre, d, h), dtype=dt),
        "conv": (normal(gen, (*pre, w, di + 2 * g * n)) * 0.1).to(dt),
        "A_log": full(gen, (*pre, h), 0.0, dt),  # A = -exp(A_log) = -1
        "D": full(gen, (*pre, h), 1.0, dt),
        "dt_bias": full(gen, (*pre, h), -2.0, dt),  # softplus(-2) ~ 0.12
        "norm": full(gen, (*pre, di), 1.0, dt),
        "out": dense_init(gen, (*pre, di, d), dtype=dt),
        "ln": full(gen, (*pre, d), 1.0, dt),
    }


def causal_conv1d(x, kernel):
    """Depthwise causal conv. x: (B, S, ch); kernel: (w, ch).  The taps
    accumulate in the reference's order, from the oldest."""
    w = kernel.shape[0]
    pad = F.pad(x, (0, 0, w - 1, 0))
    S = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(w):
        out = out + pad[:, i:i + S, :] * kernel[i]
    return out


def _project(x, p, cfg: ModelConfig, axes: MeshAxes):
    cd = cfg.compute_dtype
    z = x @ p["wz"].to(cd)
    xin = x @ p["wx"].to(cd)
    Bp = x @ p["wB"].to(cd)
    Cp = x @ p["wC"].to(cd)
    dt_raw = x @ p["wdt"].to(cd)
    return z, xin, Bp, Cp, dt_raw


def _gated_norm(y, z, w, eps: float, groups: int):
    """``rms_norm(y * SiLU(z))`` over the whole of the last dimension, or
    over each of its ``groups`` equal parts (``RMSNormGated(group_size=
    d_inner // groups)``) where ``groups`` > 1."""
    y = y * F.silu(z)
    if groups == 1:
        return rms_norm(y, w, eps)
    shape = y.shape
    return rms_norm(y.reshape(*shape[:-1], groups, -1),
                    w.reshape(groups, -1), eps).reshape(shape)


def _conv_bias(xbc, p, cd):
    """The causal conv's output plus its bias, where the block has one
    (``conv_bias``: the released Zamba2's layers)."""
    return xbc + p["conv_bias"].to(cd) if "conv_bias" in p else xbc


def mamba_block(x, p, cfg: ModelConfig, axes: MeshAxes,
                layer: int | None = None, *, inject=None,
                norm_groups: int = 1):
    """Prefill Mamba2 block: (B, S, D) -> ((B, S, D), final_state).

    final_state: (ssm_state (B,h,p,n), conv_state (B, w-1, conv_ch), None
    when S < w) so that prefill can hand off to the recurrent decode path.
    ``layer`` (the block's index in its trunk) only labels the block's
    spans: ``mamba.proj``, ``mamba.ssd`` (with the scan's ``route=``, see
    :func:`ssd_route`), ``mamba.out``.

    The released Zamba2's layers (``Zamba2LM``) use three options, each
    off by default: ``inject`` (B, S, D) is added to the block's input
    before its norm but not to its residual; the gated norm runs over
    ``norm_groups`` groups of ``d_inner``; a ``conv_bias`` leaf in ``p``
    is added after the causal conv.
    """
    B_, S, _ = x.shape
    cd = cfg.compute_dtype
    f32 = torch.float32
    g, n, hh, pp, w = (cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads,
                       cfg.ssm_headdim, cfg.ssm_conv)
    res = x
    if inject is not None:
        x = x + inject
    x = rms_norm(x, p["ln"], cfg.norm_eps)
    with obs.span("mamba.proj", layer=layer):
        z, xin, Bp, Cp, dt_raw = _project(x, p, cfg, axes)
    xbc = torch.cat([xin, Bp, Cp], dim=-1)
    xbc = sc(xbc, axes, "batch", None, "model")
    conv_state = xbc[:, S - (w - 1):, :] if S >= w else None
    xbc = F.silu(_conv_bias(causal_conv1d(xbc, p["conv"].to(cd)), p, cd))
    di = cfg.d_inner
    xin = xbc[..., :di].reshape(B_, S, hh, pp)
    Bm = xbc[..., di:di + g * n].reshape(B_, S, g, n)
    Cm = xbc[..., di + g * n:].reshape(B_, S, g, n)
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"].to(f32))
    A = -torch.exp(p["A_log"].to(f32))
    xin = sc(xin, axes, "batch", None, "model", None)
    # ssd_dtype="bf16": x/B/C operands in bf16 through the intra-chunk
    # matrix work; decay/statistics stay fp32 inside ssd_chunked
    sdt = f32 if cfg.ssd_dtype == "fp32" else cfg.compute_dtype
    with obs.span("mamba.ssd", layer=layer, tokens=B_ * S) as sp:
        ops = (xin.to(sdt), dt, A, Bm.to(sdt), Cm.to(sdt))
        route = ssd_route(*ops, axes)
        sp.set(route=route)
        y, ssm_state = (ssd_kernel(*ops, cfg.ssm_chunk) if route == "kernel"
                        else ssd_chunked_sharded(*ops, cfg.ssm_chunk, axes))
        y = y.to(f32) + (p["D"].to(f32)[:, None] * xin.to(f32))
    with obs.span("mamba.out", layer=layer):
        y = y.to(cd).reshape(B_, S, di)
        y = _gated_norm(y, z, p["norm"], cfg.norm_eps, norm_groups)
        out = y @ p["out"].to(cd)
    return (res + sc(out, axes, "batch", None, None),
            (ssm_state.to(cd), conv_state))


def mamba_block_decode(x, p, cfg: ModelConfig, axes: MeshAxes, state, *,
                       inject=None, norm_groups: int = 1):
    """Single-token Mamba2 step. x: (B, 1, D); state: (ssm, conv).
    ``inject``, ``norm_groups`` and a ``conv_bias`` leaf as in
    :func:`mamba_block`."""
    ssm_state, conv_state = state  # (B,h,p,n), (B, w-1, conv_ch)
    B_ = x.shape[0]
    cd = cfg.compute_dtype
    f32 = torch.float32
    g, n, hh, pp = (cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads,
                    cfg.ssm_headdim)
    res = x
    if inject is not None:
        x = x + inject
    x = rms_norm(x, p["ln"], cfg.norm_eps)
    z, xin, Bp, Cp, dt_raw = _project(x[:, 0], p, cfg, axes)
    xbc_t = torch.cat([xin, Bp, Cp], dim=-1)  # (B, conv_ch)
    window = torch.cat([conv_state, xbc_t[:, None, :]], dim=1)  # (B,w,ch)
    conv_out = torch.einsum("bwc,wc->bc", window, p["conv"].to(cd))
    conv_out = F.silu(_conv_bias(conv_out, p, cd))
    new_conv_state = window[:, 1:, :]
    di = cfg.d_inner
    x_t = conv_out[:, :di].reshape(B_, hh, pp)
    B_t = conv_out[:, di:di + g * n].reshape(B_, g, n)
    C_t = conv_out[:, di + g * n:].reshape(B_, g, n)
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"].to(f32))
    A = -torch.exp(p["A_log"].to(f32))
    y, new_ssm = ssd_step_sharded(ssm_state.to(f32), x_t.to(f32), dt, A,
                                  B_t.to(f32), C_t.to(f32), axes)
    y = y + p["D"].to(f32)[:, None] * x_t.to(f32)
    y = y.to(cd).reshape(B_, di)
    y = _gated_norm(y, z, p["norm"], cfg.norm_eps, norm_groups)
    out = (y @ p["out"].to(cd))[:, None, :]
    return res + out, (new_ssm.to(cd), new_conv_state)


def mamba_state_specs(cfg: ModelConfig, batch: int,
                      stacked: int | None = None):
    """Decode state of one (or ``stacked``) blocks as ``meta`` tensors (the
    reference's ShapeDtypeStructs): (ssm, conv)."""
    pre = () if stacked is None else (stacked,)
    cd = cfg.compute_dtype
    conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return (
        torch.empty((*pre, batch, cfg.ssm_heads, cfg.ssm_headdim,
                     cfg.ssm_state), dtype=cd, device="meta"),
        torch.empty((*pre, batch, cfg.ssm_conv - 1, conv_ch), dtype=cd,
                    device="meta"),
    )

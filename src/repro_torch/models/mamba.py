"""Mamba2 SSD (state-space duality) in plain PyTorch [arXiv:2405.21060].

The port of the chunked SSD algorithm of the reference's
``repro/models/mamba.py`` (matrix-transformer form within chunks, linear
recurrence across chunks) and of its O(1)-per-token recurrent step:
``segsum``, ``ssd_chunked`` and ``ssd_step``, op for op, with the
inter-chunk ``jax.lax.scan`` as a Python loop over chunks.
``kernels/ref.py`` builds its SSD oracle on ``ssd_chunked``, as the
reference's does.

The Mamba2 block itself (projections, causal conv, gating, params and
decode cache) waits for the model slice of the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def segsum(x):
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} x[..., k] (i>=j),
    -inf elsewhere. x: (..., T) -> (..., T, T)."""
    T = x.shape[-1]
    xc = torch.cumsum(x, dim=-1)
    seg = xc[..., :, None] - xc[..., None, :]
    i = torch.arange(T, device=x.device)
    mask = i[:, None] >= i[None, :]
    return torch.where(mask, seg, torch.tensor(-torch.inf, dtype=seg.dtype,
                                               device=seg.device))


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
    pad = (-s) % q
    if pad:  # zero-pad tail: dt=0 => decay 1 and no state contribution
        def zp(a):
            return F.pad(a, [0, 0] * (a.dim() - 2) + [0, pad])
        x, dt, B, C = zp(x), zp(dt), zp(B), zp(C)
        s_orig, s = s, s + pad
    else:
        s_orig = s
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
        initial_state = torch.zeros((b, h, p, n), dtype=states.dtype,
                                    device=states.device)
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

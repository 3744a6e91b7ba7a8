"""Plain-PyTorch oracles for the op layer's kernels (the allclose ground
truth), the port of the reference's ``repro/kernels/ref.py``."""
from __future__ import annotations

import torch


def reference_attention(q, k, v, *, causal: bool = True):
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D). fp32 softmax."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    k = torch.repeat_interleave(k, rep, dim=1)
    v = torch.repeat_interleave(v, rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (D**-0.5)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = s.masked_fill(~mask, -torch.inf)
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", a, v.float())
    return o.to(q.dtype)


def reference_ssd(x, dt, A, B, C, chunk: int):
    """Delegates to the model-level chunked SSD: x (b,s,h,p), dt (b,s,h),
    A (h,), B/C (b,s,g,n)."""
    from repro_torch.models.mamba import ssd_chunked

    y, state = ssd_chunked(x.float(), dt.float(), A.float(), B.float(),
                           C.float(), chunk)
    return y.to(x.dtype), state


def reference_ssd_sequential(x, dt, A, B, C):
    """Independent O(s·n·p) recurrent oracle (no chunking at all)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    Bh = torch.repeat_interleave(B, rep, dim=2).float()
    Ch = torch.repeat_interleave(C, rep, dim=2).float()
    dtf = dt.float()
    xf = x.float()
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        dA = torch.exp(dtf[:, t] * A)  # (b, h)
        upd = torch.einsum("bhp,bhn->bhpn", xf[:, t] * dtf[:, t][..., None],
                           Bh[:, t])
        state = state * dA[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), state


def reference_rmsnorm(x, w, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)

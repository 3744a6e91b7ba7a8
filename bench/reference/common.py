"""Plain float32 building blocks of the benchmark's references.

Written from the published descriptions (Mamba2: arXiv:2405.21060, its
minimal SSD listing), in plain PyTorch and
float32.  Nothing here imports the program under test.  Every product of
a weight or an activation goes through a :class:`Precision`, so that the
same code computes the reference (exact float32, TF32 off) and the
lower-precision control that ``correct`` is shown to reject
(:class:`Lowered`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def vocab_padded(cfg: dict) -> int:
    v = cfg["vocab_size"]
    return (v + 255) // 256 * 256


def sizes(cfg: dict) -> dict:
    """Derived sizes of a configuration file's ``config`` block."""
    di = cfg["ssm_expand"] * cfg["d_model"]
    g, n = cfg["ssm_groups"], cfg["ssm_state"]
    return {"d": cfg["d_model"], "di": di, "g": g, "n": n,
            "h": di // cfg["ssm_headdim"], "p": cfg["ssm_headdim"],
            "w": cfg["ssm_conv"], "conv_ch": di + 2 * g * n,
            "vp": vocab_padded(cfg)}


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------


class Precision:
    """Exact float32: products as they are."""

    def act(self, x):
        """An activation the configuration holds in its compute dtype: the
        embedding's rows and the residual stream between blocks."""
        return x

    def gemm(self, x):
        """An operand of a product the configuration computes in its
        compute dtype."""
        return x

    def scan(self, x):
        """An operand of the SSD's products, which the configuration
        computes in its ``ssd_dtype``."""
        return x


class _RoundSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _fp8(x):
    """``x`` rounded to float8 e4m3 under a per-tensor scale (amax to
    448), as an fp8 GEMM's operand is."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


class Lowered(Precision):
    """The control: computed one precision below what the configuration
    states, fp8 (e4m3, per-tensor scale) where it states bfloat16 (the
    GEMMs' operands, the embedding's rows, the residual stream between
    blocks) and bfloat16 where it states float32 (the SSD's products).
    Rounding is in the forward pass; gradients pass through it
    unchanged."""

    def act(self, x):
        return _RoundSTE.apply(x, _fp8)

    def gemm(self, x):
        return _RoundSTE.apply(x, _fp8)

    def scan(self, x):
        return _RoundSTE.apply(x, _bf16)


EXACT = Precision()


def no_tf32():
    """Float32 products in full float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def mm(x, w, pr: Precision):
    return pr.gemm(x) @ pr.gemm(w)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def causal_conv(x, k):
    """Depthwise causal convolution: x (B, S, ch), k (w, ch), the last tap
    on the current position."""
    w = k.shape[0]
    xt = F.pad(x.transpose(1, 2), (w - 1, 0))
    return F.conv1d(xt, k.t().unsqueeze(1), groups=x.shape[-1]).transpose(1, 2)


def segsum(a):
    """out[..., i, j] = a[..., j+1] + ... + a[..., i] for i >= j, -inf
    above the diagonal (the stable form: a masked cumulative sum, no
    difference of prefix sums)."""
    T = a.shape[-1]
    a = a[..., None].expand(*a.shape, T)               # [..., i, j] = a_i
    strict = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device),
                        -1)
    ss = torch.cumsum(a.masked_fill(~strict, 0.0), dim=-2)
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device))
    return ss.masked_fill(~keep, float("-inf"))


def ssd(x, dt, A, B, C, chunk: int, pr: Precision):
    """The SSD scan from a zero state: x (b, s, h, p), dt (b, s, h), A (h,),
    B and C (b, s, g, n).  Returns y (b, s, h, p) and the final state
    (b, h, p, n).  Quadratic inside a chunk, a (c+1)-square decay matrix
    across chunks."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x, dt, B, C = (F.pad(t, [0, 0] * (t.dim() - 2) + [0, pad])
                       for t in (x, dt, B, C))
    c = (s + pad) // q
    X = (x * dt[..., None]).reshape(b, c, q, h, p)
    Bh = B.repeat_interleave(h // g, dim=2).reshape(b, c, q, h, n)
    Ch = C.repeat_interleave(h // g, dim=2).reshape(b, c, q, h, n)
    a = (dt * A).reshape(b, c, q, h).permute(0, 3, 1, 2)      # (b, h, c, q)
    acs = torch.cumsum(a, dim=-1)
    L = torch.exp(segsum(a))                                    # (b,h,c,q,q)
    X, Bh, Ch, L = (pr.scan(t) for t in (X, Bh, Ch, L))
    y = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", Ch, Bh, L, X)
    decay = pr.scan(torch.exp(acs[..., -1:] - acs))
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bh, decay, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(segsum(F.pad(acs[..., -1], (1, 0))))  # (b,h,c+1,c+1)
    states = torch.einsum("bhzc,bchpn->bzhpn", pr.scan(chunk_decay),
                          pr.scan(states))
    entering, final = states[:, :-1], states[:, -1]
    y = y + torch.einsum("bclhn,bchpn,bhcl->bclhp", Ch, pr.scan(entering),
                         pr.scan(torch.exp(acs)))
    return y.reshape(b, c * q, h, p)[:, :s], final


def mamba_layer(x, p, cfg: dict, pr: Precision, with_state: bool = False):
    """One Mamba2 block (pre-norm, residual): (B, S, D) -> (B, S, D), and
    its (ssm, conv) decode state when ``with_state``."""
    z_ = sizes(cfg)
    Bsz, S, _ = x.shape
    eps = cfg["norm_eps"]
    u = rms_norm(x, p["ln"], eps)
    z = mm(u, p["wz"], pr)
    xbc = torch.cat([mm(u, p["wx"], pr), mm(u, p["wB"], pr),
                     mm(u, p["wC"], pr)], dim=-1)
    dt = F.softplus(mm(u, p["wdt"], pr) + p["dt_bias"])
    conv_state = xbc[:, S - (z_["w"] - 1):] if with_state else None
    xbc = F.silu(causal_conv(xbc, p["conv"]))
    di, gn = z_["di"], z_["g"] * z_["n"]
    xs = xbc[..., :di].reshape(Bsz, S, z_["h"], z_["p"])
    Bm = xbc[..., di:di + gn].reshape(Bsz, S, z_["g"], z_["n"])
    Cm = xbc[..., di + gn:].reshape(Bsz, S, z_["g"], z_["n"])
    A = -torch.exp(p["A_log"])
    y, ssm_state = ssd(xs, dt, A, Bm, Cm, cfg["ssm_chunk"], pr)
    y = (y + p["D"][:, None] * xs).reshape(Bsz, S, di)
    y = rms_norm(y * F.silu(z), p["norm"], eps)
    out = pr.act(x + mm(y, p["out"], pr))
    return (out, (ssm_state, conv_state)) if with_state else out


def embed(params, tokens, pr: Precision):
    return pr.act(params["embed"][tokens.long()])


def logits(h, params, cfg: dict, pr: Precision):
    """Tied-head logits of (..., D) hidden states over the padded vocab."""
    u = rms_norm(h, params["ln_f"], cfg["norm_eps"])
    return mm(u, params["embed"].t(), pr)


def cross_entropy(h, params, labels, cfg: dict, pr: Precision,
                  block: int = 1024):
    """Sum of token losses of (B, S, D) hidden states against ``labels``,
    in blocks of positions."""
    total = h.new_zeros(())
    for s0 in range(0, h.shape[1], block):
        lg = logits(h[:, s0:s0 + block], params, cfg, pr)
        lbl = labels[:, s0:s0 + block].long()
        total = total + torch.sum(torch.logsumexp(lg, dim=-1)
                                  - lg.gather(-1, lbl[..., None])[..., 0])
    return total


# ---------------------------------------------------------------------------
# parameters and AdamW
# ---------------------------------------------------------------------------


def mamba_leaf_specs(cfg: dict, lead: tuple) -> dict:
    """name -> (shape, init) of one Mamba2 block's leaves, stacked under
    ``lead``."""
    z = sizes(cfg)
    d, di, h, gn = z["d"], z["di"], z["h"], z["g"] * z["n"]
    return {
        "wz": ((*lead, d, di), ("normal", d ** -0.5)),
        "wx": ((*lead, d, di), ("normal", d ** -0.5)),
        "wB": ((*lead, d, gn), ("normal", d ** -0.5)),
        "wC": ((*lead, d, gn), ("normal", d ** -0.5)),
        "wdt": ((*lead, d, h), ("normal", d ** -0.5)),
        "conv": ((*lead, z["w"], z["conv_ch"]), ("normal", z["w"] ** -0.5)),
        "A_log": ((*lead, h), ("A_log",)),
        "D": ((*lead, h), ("around_one",)),
        "dt_bias": ((*lead, h), ("dt_bias",)),
        "norm": ((*lead, di), ("around_one",)),
        "out": ((*lead, di, d), ("normal", di ** -0.5)),
        "ln": ((*lead, d), ("around_one",)),
    }


def head_leaf_specs(cfg: dict) -> dict:
    z = sizes(cfg)
    return {"embed": ((z["vp"], z["d"]), ("normal", 0.02)),
            "ln_f": ((z["d"],), ("around_one",))}


def _draw(shape, init, gen, device):
    kind = init[0]
    if kind == "normal":
        return torch.randn(shape, generator=gen, device=device).mul_(init[1])
    if kind == "around_one":
        return torch.randn(shape, generator=gen, device=device).mul_(0.1).add_(1)
    u = torch.rand(shape, generator=gen, device=device)
    if kind == "A_log":                      # A uniform in [1, 16]
        return torch.log(1 + 15 * u)
    if kind == "dt_bias":                    # softplus^-1 of log-uniform dt
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(f"unknown init {kind!r}")


def leaf_seed(seed: int, index: int) -> int:
    return (seed * 1_000_003 + index * 7_919 + 12_345) % (1 << 63)


def make_leaf(specs: dict, name: str, seed: int, device):
    """One leaf of the flat spec dict, drawn from its own generator on
    ``device``: any leaf can be drawn again alone."""
    index = list(specs).index(name)
    shape, init = specs[name]
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, index))
    return _draw(shape, init, gen, device)


def make_weights(specs: dict, seed: int, device) -> dict:
    """Every leaf of a flat ``{"layers.wz": (shape, init)}`` dict, in
    float32 on ``device``."""
    return {name: make_leaf(specs, name, seed, device) for name in specs}


def nest(flat: dict) -> dict:
    out: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def adamw_lr(opt: dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * (opt["min_lr_ratio"]
                               + (1 - opt["min_lr_ratio"]) * cos)


@torch.no_grad()
def adamw_step(params: dict, grads: dict, mu: dict, nu: dict, step: int,
               opt: dict) -> dict:
    """AdamW with global-norm clipping, decay on leaves of two or more
    dimensions; updates ``params``, ``mu``, ``nu`` in place and returns
    each leaf's norm of its clipped gradient."""
    gn = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                       for g in grads.values()))
    scale = min(1.0, opt["grad_clip"] / (gn + 1e-9))
    lr = adamw_lr(opt, step)
    b1, b2 = opt["b1"], opt["b2"]
    norms = {}
    for name, p in params.items():
        g = grads[name] * scale
        norms[name] = float(torch.linalg.vector_norm(g.double()))
        mu[name].mul_(b1).add_(g, alpha=1 - b1)
        nu[name].mul_(b2).add_(g * g, alpha=1 - b2)
        upd = (mu[name] / (1 - b1 ** step)) / (
            torch.sqrt(nu[name] / (1 - b2 ** step)) + opt["eps"])
        if p.dim() >= 2:
            upd = upd + opt["weight_decay"] * p
        p.sub_(lr * upd)
    return norms

"""Flash attention forward (causal or bidirectional, GQA): the CUDA kernel of
``csrc/flash_attention.cu``, its wrapper and its plain PyTorch version.

The port of the reference package's ``repro/kernels/flash_attention.py``.
:func:`flash_attention_fwd` keeps the reference's signature (with
``interpret=`` gone) and checks: ``Hq % Hkv == 0`` and each sequence a
multiple of its block.  It launches the kernel for CUDA tensors (on the
current stream, without synchronizing) and runs
:func:`flash_attention_ref` for CPU tensors.  ``block_q``/``block_k``
choose the plain version's blocking, as they choose the Pallas kernel's;
the CUDA kernel tiles by its own (64 queries, and 64 keys in bf16 or 32 in
f32) and gives the same function.  On the card ``D`` is at most
:data:`MAX_D` and q, k, v share one dtype (f32 or bf16); the plain version
takes any.  The kernel is built for a few head dims (16, 32, 64, 80, 96,
128); any other ``D`` is zero-padded to the next of them, which the scores
and the output do not see.  CUDA inputs that are views (transposed,
strided, or off 16-byte alignment) are copied first; other inputs are
used in place.  ``launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels._build import DTYPE_CODES as DTYPES
from repro_torch.kernels._build import CudaLibrary, card_inputs

NEG_INF = -1e30
MAX_D = 128            # FA_MAX_D in the CUDA source

launches = 0


def _bind(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [vp, vp, vp, vp] + [i32] * 6 + [
        ctypes.c_float, i32, i32, vp]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_max_d.restype = ctypes.c_int
    lib.flash_attention_head_dim.argtypes = [i32]
    lib.flash_attention_head_dim.restype = ctypes.c_int
    if lib.flash_attention_max_d() != MAX_D:
        raise RuntimeError("kernel library disagrees on MAX_D")


LIBRARY = CudaLibrary("flash_attention.cu", _bind)


def _shapes(q, k, v, block_q, block_k):
    """The reference's checks; returns ``(B, Hq, Hkv, Sq, Sk, D)``."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash attention takes q (B, Hq, Sq, D) and k, v "
                         f"(B, Hkv, Sk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError("q and k/v disagree on batch or head dimension")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq % Hkv must be 0, got Hq={Hq}, Hkv={Hkv}")
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    if bq <= 0 or bk <= 0 or Sq % bq or Sk % bk:
        raise ValueError(f"Sq={Sq} and Sk={Sk} must be multiples of their "
                         f"blocks ({bq}, {bk})")
    return B, Hq, Hkv, Sq, Sk, D


def flash_attention_fwd(q, k, v, *, causal: bool = True, block_q: int = 128,
                        block_k: int = 128):
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D) with Hq % Hkv == 0.
    Returns (B, Hq, Sq, D) in q's dtype."""
    global launches
    B, Hq, Hkv, Sq, Sk, D = _shapes(q, k, v, block_q, block_k)
    card, (q, k, v) = card_inputs("flash_attention_fwd", q, k, v)
    if not card:
        return flash_attention_ref(q, k, v, causal=causal, block_q=block_q,
                                   block_k=block_k)
    if D > MAX_D:
        raise ValueError(f"the flash attention kernel takes D <= {MAX_D}, "
                         f"got {D}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the flash attention kernel takes q, k, v all "
                        f"float32 or all bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.numel() == 0:
        return torch.empty_like(q)
    lib, _ = LIBRARY.load()
    Dk = lib.flash_attention_head_dim(D)     # the instance D runs at
    if Dk != D:                              # zero columns add nothing
        q, k, v = (F.pad(t, (0, Dk - D)) for t in (q, k, v))
    out = torch.empty_like(q)
    LIBRARY.launch("flash_attention_launch", q.device, q.data_ptr(),
                   k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq, Hkv,
                   Sq, Sk, Dk, float(D ** -0.5), int(bool(causal)),
                   DTYPES[q.dtype])
    launches += 1
    return out if Dk == D else out[..., :D].contiguous()


def flash_attention_ref(q, k, v, *, causal: bool = True, block_q: int = 128,
                        block_k: int = 128):
    """Plain version of :func:`flash_attention_fwd`: the Pallas kernel's
    block loop step by step, over every flat head at once (any device, any
    D): the same ``bq``/``bk``, skip predicate, ``NEG_INF`` and ``l == 0``
    guard."""
    B, Hq, Hkv, Sq, Sk, D = _shapes(q, k, v, block_q, block_k)
    group = Hq // Hkv
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    nq, nk = Sq // bq, Sk // bk
    scale = D ** -0.5
    qr = q.reshape(B * Hq, Sq, D)
    kv_head = torch.arange(B * Hq, device=q.device) // group
    kr = k.reshape(B * Hkv, Sk, D)[kv_head]
    vr = v.reshape(B * Hkv, Sk, D)[kv_head]
    out = torch.empty((B * Hq, Sq, D), dtype=q.dtype, device=q.device)
    rows = torch.arange(bq, device=q.device)[:, None]
    cols = torch.arange(bk, device=q.device)[None, :]
    for qi in range(nq):
        qb = qr[:, qi * bq:(qi + 1) * bq].float()
        m = torch.full((B * Hq, bq), NEG_INF, device=q.device)
        l = torch.zeros((B * Hq, bq), device=q.device)
        acc = torch.zeros((B * Hq, bq, D), device=q.device)
        for kj in range(nk):
            if causal and not (qi + 1) * bq > kj * bk:
                continue   # the block lies above the diagonal
            kb = kr[:, kj * bk:(kj + 1) * bk].float()
            vb = vr[:, kj * bk:(kj + 1) * bk].float()
            s = torch.bmm(qb, kb.transpose(1, 2)) * scale
            if causal:
                s = torch.where(qi * bq + rows >= kj * bk + cols, s,
                                NEG_INF)
            m_cur = torch.maximum(m, s.amax(dim=2))
            alpha = torch.exp(m - m_cur)
            p = torch.exp(s - m_cur[..., None])
            l = l * alpha + p.sum(dim=2)
            m = m_cur
            acc = acc * alpha[..., None] + torch.bmm(p, vb)
        den = torch.where(l == 0, torch.ones_like(l), l)
        out[:, qi * bq:(qi + 1) * bq] = (acc / den[..., None]).to(q.dtype)
    return out.reshape(B, Hq, Sq, D)

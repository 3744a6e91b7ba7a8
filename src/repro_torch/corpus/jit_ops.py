"""The op corpus that the hardware characterization path measures.

The port of the reference package's ``repro/corpus/jit_ops.py``: the same
ops (matmul tiles, elementwise, reductions, layout ops, fused layers) under
the same names, on the same example values and dtypes, with the same
analytic FLOP counts.  Every op is shape-preserving, so
``core/hardware.py`` can chain it.  The reference's ops are jitted;
PyTorch runs each of these eagerly, op by op.

One difference: each ``matmul_{n}x{n}`` op here divides by its own ``n``.
The reference's ``mm`` closes over the loop variable, so every matmul op of
a corpus built with several sizes divides by the last size (ROADMAP §3).
"""
from __future__ import annotations

import torch

from repro_torch.core.device_mesh import resolve_device


def _matmul(n):
    def mm(v):
        return (v @ v) * (1.0 / n)  # normalized to stay finite

    return mm


def build_jit_corpus(sizes=(128, 256, 512), device=None) -> dict:
    """name -> (shape-preserving fn, example arg, flops per application),
    with the examples on ``device`` (default ``cuda:0``)."""
    dev = resolve_device(device)
    corpus = {}
    for n in sizes:
        x = torch.ones((n, n), dtype=torch.float32, device=dev) * 0.5
        mm = _matmul(n)
        corpus[f"matmul_{n}x{n}_f32"] = (mm, x, 2.0 * n * n * n)
        xb = x.to(torch.bfloat16)
        corpus[f"matmul_{n}x{n}_bf16"] = (mm, xb, 2.0 * n * n * n)
    v = torch.linspace(0.1, 1.0, 1 << 16, dtype=torch.float32, device=dev)
    corpus["add_vec_64k"] = (lambda t: t + 1.5, v, 1 << 16)
    corpus["mul_vec_64k"] = (lambda t: t * 1.0001, v, 1 << 16)
    corpus["fma_vec_64k"] = (lambda t: t * 0.999 + 0.01, v, 2 << 16)
    corpus["exp_vec_64k"] = (lambda t: torch.exp(t) * 0.3, v, 1 << 16)
    corpus["rsqrt_vec_64k"] = (lambda t: torch.rsqrt(t + 1.0), v, 1 << 16)
    m = torch.ones((256, 256), dtype=torch.float32, device=dev)
    # .contiguous() moves the data: an elementwise op on a transposed view
    # keeps the view's strides, so ``t.T + 0.0`` alone would not transpose
    corpus["transpose_256"] = (lambda t: t.T.contiguous() + 0.0, m, 0.0)
    corpus["reduce_sum_256"] = (
        lambda t: t + torch.sum(t, dim=1, keepdim=True) * 1e-6, m,
        256 * 256)
    corpus["softmax_256"] = (lambda t: torch.softmax(t, dim=-1) + t * 0.5,
                             m, 5 * 256 * 256)
    idx = torch.arange(256, device=dev) % 128

    def gather_op(t):
        return t[idx] * 0.5 + t * 0.5

    corpus["gather_256"] = (gather_op, m, 0.0)
    w = torch.ones((256,), dtype=torch.float32, device=dev)

    def rmsnorm_op(t):
        var = torch.mean(t * t, dim=-1, keepdim=True)
        return t * torch.rsqrt(var + 1e-5) * w

    corpus["rmsnorm_256"] = (rmsnorm_op, m, 4 * 256 * 256)
    return corpus


#: legacy name of the reference package (its ``repro.ops.corpus``
#: re-export)
build_corpus = build_jit_corpus

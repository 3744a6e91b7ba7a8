"""Public entry points of the op layer's kernels.

The port of the reference package's ``repro/kernels/ops.py``.  The
reference's ``default_interpret`` has no counterpart: the tensors' device
decides.  A CUDA tensor launches the hand-written kernel (or raises), a CPU
tensor runs the kernel's plain PyTorch version.

:func:`flash_attention` is differentiable as the reference's is: its
forward is the kernel, and its backward recomputes the gradient through
:func:`~repro_torch.kernels.ref.reference_attention` with
``torch.autograd.grad``, as the reference's ``_fa_bwd`` does through
``jax.vjp`` in XLA.  That recompute is the reference's own backward (it
has no backward kernel), not a plain version standing in for a kernel.
:func:`ssd_scan` and :func:`rmsnorm` are forward-only, as in the
reference: a gradient through them raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm_kernel
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd_kernel


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return flash_attention_fwd(q, k, v, causal=causal, block_q=block_q,
                                   block_k=block_k)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        # the recomputed backward through the reference (flash-equivalent
        # math), as the JAX package's custom VJP does
        with torch.enable_grad():
            o = ref.reference_attention(q, k, v, causal=ctx.causal)
            dq, dk, dv = torch.autograd.grad(o, (q, k, v), g)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, block_q: int = 128,
                    block_k: int = 128):
    return _FlashAttention.apply(q, k, v, causal, block_q, block_k)


class _ForwardOnly(torch.autograd.Function):
    """Runs ``fn`` without a gradient: a backward through it raises."""

    @staticmethod
    def forward(ctx, fn, name, *args):
        ctx.name = name
        return fn(*args)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(f"{ctx.name} is forward-only (the reference "
                           "defines no gradient for it)")


def ssd_scan(x, dt, A, B, C, chunk: int = 256):
    return _ForwardOnly.apply(_ssd_kernel, "ssd_scan", x, dt, A, B, C, chunk)


def rmsnorm(x, w, eps: float = 1e-5):
    return _ForwardOnly.apply(_rmsnorm_kernel, "rmsnorm", x, w, eps)

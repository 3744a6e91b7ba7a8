"""Fused RMSNorm: the CUDA kernel of ``csrc/rmsnorm.cu``, its wrapper and
its plain PyTorch version.

The port of the reference package's ``repro/kernels/rmsnorm.py``: per row,
in f32, ``x * rsqrt(mean(x**2) + eps) * w``, rounded into x's dtype.
:func:`rmsnorm` keeps the reference's signature with ``block_rows`` gone:
it launches the kernel for CUDA tensors (on the current stream, without
synchronizing) and runs :func:`rmsnorm_ref` for CPU tensors.  The kernel
takes any row count without padding (one warp a row) and any ``d``.  CUDA
inputs that are views (transposed, strided, or off 16-byte alignment, such
as ``x[1:]`` of an f32 ``(rows, 21)`` tensor) are copied first; other
inputs are used in place.  ``launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import DTYPE_CODES as DTYPES
from repro_torch.kernels._build import CudaLibrary, card_inputs


launches = 0


def _bind(lib):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rmsnorm_launch.argtypes = [vp, vp, vp, i64, i32, ctypes.c_float,
                                   i32, i32, vp]
    lib.rmsnorm_launch.restype = ctypes.c_int


LIBRARY = CudaLibrary("rmsnorm.cu", _bind)


def _check(x, w):
    for name, t in (("x", x), ("w", w)):
        if t.dtype not in DTYPES:
            raise TypeError(f"rmsnorm: {name} must be float32 or bfloat16, "
                            f"got {t.dtype}")
    if x.dim() < 1 or w.shape != (x.shape[-1],):
        raise ValueError(f"rmsnorm: x (..., d) and w (d,), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")


def rmsnorm(x, w, eps: float = 1e-5):
    """x: (..., d); w: (d,).  Returns x's shape and dtype."""
    global launches
    _check(x, w)
    card, (x, w) = card_inputs("rmsnorm", x, w)
    if not card:
        return rmsnorm_ref(x, w, eps)
    d = x.shape[-1]
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    LIBRARY.launch("rmsnorm_launch", x.device, x.data_ptr(), w.data_ptr(),
                   out.data_ptr(), rows, d, float(eps), DTYPES[x.dtype],
                   DTYPES[w.dtype])
    launches += 1
    return out


def rmsnorm_ref(x, w, eps: float = 1e-5):
    """Plain version of :func:`rmsnorm`: the Pallas body's steps (any
    device)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.float()).to(x.dtype)

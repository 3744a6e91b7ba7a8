"""The min-cut port bound of a wave of blocks: the CUDA kernel of
``csrc/port_bound.cu``, its wrapper and its plain PyTorch version.

The port of ``port_bound_kernel`` in the reference package's
``repro/service/batch_predictor.py`` (``BatchPredictor._compile_kernel``),
the one device kernel every served prediction goes through.  Per row of
``u`` (``B x C`` int32: a block's summed uop count per port combination),
``demand = u @ mask`` over the model's min-cut candidate sets (``mask``
``C x S`` int32, 0/1; ``size`` ``S`` int32, each candidate's port count,
at least 1), and the pair ``(num, den) = (demand[s], size[s])`` of the
largest ratio, by the exact compare ``an * bd < bn * ad`` from ``(0, 1)``.
The result is one int32 ``(2, B)`` tensor, ``num`` in row 0 and ``den``
in row 1 (``num, den = port_bound(...)`` unpacks the two rows as views),
so a caller copies it back once.  The caller divides ``num / den`` in
float64.

Equal ratios may come back as different pairs (the kernel, the plain
version and the reference's jax reduce each break ties their own way);
their float64 quotients are equal, so only quotients are compared.  The
caller keeps ``row total * max(size) < 2**31`` (the reference's guard), so
every product fits int32.

:func:`port_bound` launches the kernel for CUDA tensors (on the current
stream, without synchronizing) and runs :func:`port_bound_ref` for CPU
tensors.  The kernel takes exactly ``B`` rows, no padding.  ``launches``
counts the kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaLibrary, card_inputs

launches = 0


def _bind(lib):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.port_bound_launch.argtypes = [vp, vp, vp, vp, i64, i32, i32, vp]
    lib.port_bound_launch.restype = ctypes.c_int


LIBRARY = CudaLibrary("port_bound.cu", _bind)


def _check(u, mask, size):
    for name, t in (("u", u), ("mask", mask), ("size", size)):
        if t.dtype != torch.int32:
            raise TypeError(f"port_bound: {name} must be int32, got "
                            f"{t.dtype}")
    if (u.dim() != 2 or mask.dim() != 2 or size.dim() != 1
            or u.shape[1] != mask.shape[0] or mask.shape[1] != size.shape[0]):
        raise ValueError(f"port_bound: u (B, C), mask (C, S) and size (S,), "
                         f"got {tuple(u.shape)}, {tuple(mask.shape)} and "
                         f"{tuple(size.shape)}")


def port_bound(u, mask, size):
    """The int32 ``(2, B)`` tensor ``[num, den]`` on ``u``'s device."""
    global launches
    _check(u, mask, size)
    card, (u, mask, size) = card_inputs("port_bound", u, mask, size)
    if not card:
        return port_bound_ref(u, mask, size)
    B, C = u.shape
    out = torch.empty((2, B), dtype=torch.int32, device=u.device)
    if B == 0:
        return out
    LIBRARY.launch("port_bound_launch", u.device, u.data_ptr(),
                   mask.data_ptr(), size.data_ptr(), out.data_ptr(), B, C,
                   mask.shape[1])
    launches += 1
    return out


def port_bound_ref(u, mask, size):
    """Plain version of :func:`port_bound` (any device): int32 demand, one
    combination at a time (CUDA has no int32 matmul), then the exact
    compare one candidate at a time, as the reference's reduce."""
    _check(u, mask, size)
    B, C = u.shape
    demand = torch.zeros((B, mask.shape[1]), dtype=torch.int32,
                         device=u.device)
    for c in range(C):
        demand += u[:, c, None] * mask[c]
    an = torch.zeros(B, dtype=torch.int32, device=u.device)
    ad = torch.ones(B, dtype=torch.int32, device=u.device)
    for s in range(mask.shape[1]):
        bn, bd = demand[:, s], size[s]
        take = an * bd < bn * ad
        an = torch.where(take, bn, an)
        ad = torch.where(take, bd, ad)
    return torch.stack((an, ad))

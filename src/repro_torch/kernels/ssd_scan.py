"""Mamba2 SSD chunk scan: the CUDA kernel of ``csrc/ssd_scan.cu``, its
wrapper and its plain PyTorch version.

The port of the reference package's ``repro/kernels/ssd_scan.py``: a serial
loop over chunks that carries the (P, N) f32 state, with the intra-chunk
work as matrix products.  :func:`ssd_scan` keeps the reference's signature
(with ``interpret=`` gone) and its check that the chunk divides the
sequence.  It launches the kernel for CUDA tensors (on the current stream,
without synchronizing) and runs :func:`ssd_scan_ref` for CPU tensors.  On
the card ``p`` is at most :data:`MAX_P` and ``n`` at most :data:`MAX_N`, x
is f32 or bf16, B and C share one dtype (f32 or bf16), and dt and A are
read as f32 (the wrapper casts them if they are not); the plain version
takes any.  CUDA inputs that are views (transposed, strided, or off
16-byte alignment, such as B and C split out of one projection) are copied
first; other inputs are used in place.  ``launches`` counts the kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import DTYPE_CODES as DTYPES
from repro_torch.kernels._build import CudaLibrary, card_inputs

MAX_P = 64             # SSD_MAX_P in the CUDA source
MAX_N = 128            # SSD_MAX_N

launches = 0


def _bind(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_launch.argtypes = [vp] * 7 + [i32] * 9 + [vp]
    lib.ssd_scan_launch.restype = ctypes.c_int
    lib.ssd_scan_fits.argtypes = [i32, i32, i32]
    lib.ssd_scan_fits.restype = ctypes.c_int
    for name, want in (("ssd_scan_max_p", MAX_P), ("ssd_scan_max_n", MAX_N)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        if fn() != want:
            raise RuntimeError(f"kernel library disagrees on {name}")


LIBRARY = CudaLibrary("ssd_scan.cu", _bind)


def _shapes(x, dt, A, B, C, chunk):
    """The reference's shapes and its assert; returns
    ``(b, s, h, p, g, n, q)``."""
    if x.dim() != 4 or B.dim() != 4 or C.shape != B.shape:
        raise ValueError(f"ssd_scan takes x (b, s, h, p) and B, C "
                         f"(b, s, g, n), got {tuple(x.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if (dt.shape != (b, s, h) or A.shape != (h,) or B.shape[:2] != (b, s)
            or g == 0 or h % g):
        raise ValueError(f"ssd_scan: dt (b, s, h), A (h,), B/C (b, s, g, n) "
                         f"with h % g == 0, got dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(B.shape)}")
    q = min(chunk, s)
    if q <= 0 or s % q:
        raise ValueError(f"the chunk ({q}) must divide the sequence ({s})")
    return b, s, h, p, g, n, q


def ssd_scan(x, dt, A, B, C, chunk: int):
    """x: (b, s, h, p); dt: (b, s, h) (post-softplus); A: (h,) negative;
    B, C: (b, s, g, n).  Returns (y: (b, s, h, p) in x's dtype,
    state: (b, h, p, n) f32)."""
    global launches
    b, s, h, p, g, n, q = _shapes(x, dt, A, B, C, chunk)
    card, (x, dt, A, B, C) = card_inputs("ssd_scan", x, dt, A, B, C)
    if not card:
        return ssd_scan_ref(x, dt, A, B, C, chunk)
    if p > MAX_P or n > MAX_N:
        raise ValueError(f"the SSD kernel takes p <= {MAX_P} and n <= "
                         f"{MAX_N}, got p={p}, n={n}")
    if x.dtype not in DTYPES or B.dtype not in DTYPES or C.dtype != B.dtype:
        raise TypeError(f"the SSD kernel takes x float32 or bfloat16 and B, "
                        f"C both float32 or both bfloat16, got {x.dtype}, "
                        f"{B.dtype}, {C.dtype}")
    lib, _ = LIBRARY.load()
    if not lib.ssd_scan_fits(p, n, q):
        raise ValueError(f"a chunk of {q} steps needs more shared memory "
                         f"than a CTA has")
    dt, A = dt.to(torch.float32), A.to(torch.float32)
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return y, state.zero_()
    LIBRARY.launch("ssd_scan_launch", x.device, x.data_ptr(), dt.data_ptr(),
                   A.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
                   state.data_ptr(), b, s, h, p, g, n, q, DTYPES[x.dtype],
                   DTYPES[B.dtype])
    launches += 1
    return y, state


def ssd_scan_ref(x, dt, A, B, C, chunk: int):
    """Plain version of :func:`ssd_scan`: the Pallas body's steps, chunk by
    chunk, over every (batch, head) at once (any device, any width)."""
    b, s, h, p, g, n, q = _shapes(x, dt, A, B, C, chunk)
    rep = h // g
    group = torch.arange(h, device=x.device) // rep
    xt = x.movedim(2, 1)                       # (b, h, s, p)
    dtt = dt.movedim(2, 1)                     # (b, h, s)
    Bt = B.movedim(2, 1)[:, group]             # (b, h, s, n)
    Ct = C.movedim(2, 1)[:, group]
    a = A.float()[None, :, None]
    lower = (torch.arange(q, device=x.device)[:, None]
             >= torch.arange(q, device=x.device)[None, :])
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    y = torch.empty((b, h, s, p), dtype=x.dtype, device=x.device)
    for c0 in range(0, s, q):
        xc = xt[:, :, c0:c0 + q].float()       # (b, h, Q, P)
        dtc = dtt[:, :, c0:c0 + q].float()     # (b, h, Q)
        bm = Bt[:, :, c0:c0 + q].float()       # (b, h, Q, N)
        cm = Ct[:, :, c0:c0 + q].float()
        xbar = xc * dtc[..., None]
        cum = torch.cumsum(dtc * a, dim=-1)
        seg = cum[..., :, None] - cum[..., None, :]
        L = torch.where(lower, torch.exp(seg), 0.0)
        scores = cm @ bm.transpose(-1, -2)
        y_diag = (scores * L) @ xbar
        decay_out = torch.exp(cum)
        y_off = (cm * decay_out[..., None]) @ state.transpose(-1, -2)
        y[:, :, c0:c0 + q] = (y_diag + y_off).to(x.dtype)
        decay_in = torch.exp(cum[..., -1:] - cum)
        upd = xbar.transpose(-1, -2) @ (bm * decay_in[..., None])
        state = state * torch.exp(cum[..., -1])[..., None, None] + upd
    return y.movedim(1, 2), state

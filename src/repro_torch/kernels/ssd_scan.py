"""Mamba2 SSD chunk scan: the CUDA passes of ``csrc/ssd_scan.cu``, their
wrappers and their plain PyTorch versions.

The port of the reference package's ``repro/kernels/ssd_scan.py``.
:func:`ssd_scan` keeps the reference's signature (with ``interpret=``
gone) and its check that the chunk divides the sequence.  For CPU tensors
it runs :func:`ssd_scan_ref`, the reference's chunk loop.  For CUDA tensors
it launches :data:`KERNELS_PER_CALL` kernels back to back on the current
stream, without synchronizing, with their scratch from ``torch.empty``:

1. :func:`ssd_chunk_state`: each chunk's cumsum of ``dt * A`` and its own
   state from zero, ``xbar^T (B * exp(cum[-1] - cum))``;
2. :func:`ssd_state_pass`: the serial part, the state entering each chunk
   and the final state, walked chunk by chunk;
3. :func:`ssd_chunk_cb`: the scores ``C B^T`` of each chunk, once a group;
4. :func:`ssd_chunk_scan`: ``y = ((C B^T) * L) xbar + (C * exp(cum))
   state^T`` with the state entering the chunk.

Each pass has a wrapper of its own, which launches it alone for CUDA
tensors and runs its plain version (``*_ref``) for CPU tensors; composed,
the plain versions compute :func:`ssd_scan_ref`'s function.  On the card
``p`` is at most :data:`MAX_P` and ``n`` at most :data:`MAX_N`, x is f32 or
bf16, B and C share one dtype (f32 or bf16), and dt and A are read as f32
(the wrapper casts them if they are not); the plain versions take any, in
f32 (f64 for f64 inputs).  CUDA inputs that are views (transposed,
strided, or off 16-byte alignment, such as B and C split out of one
projection) are copied first; other inputs are used in place.
``launches`` counts the :func:`ssd_scan` calls that launched the kernels;
the pass wrappers alone are not counted.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import DTYPE_CODES as DTYPES
from repro_torch.kernels._build import CudaLibrary, card_inputs

MAX_P = 64             # SSD_MAX_P in the CUDA source
MAX_N = 128            # SSD_MAX_N
KERNELS_PER_CALL = 4   # the passes one ssd_scan call launches
PASSES = ("chunk_state", "state_pass", "chunk_cb", "chunk_scan")

launches = 0


def _bind(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for name, argtypes in (
            ("ssd_scan_launch", [vp] * 10 + [i32] * 9 + [vp]),
            ("ssd_chunk_state_launch", [vp] * 6 + [i32] * 9 + [vp]),
            ("ssd_state_pass_launch", [vp] * 3 + [i32] * 4 + [vp]),
            ("ssd_chunk_cb_launch", [vp] * 3 + [i32] * 6 + [vp]),
            ("ssd_chunk_scan_launch", [vp] * 7 + [i32] * 9 + [vp]),
            ("ssd_scan_fits", [i32] * 3)):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
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


def _wide(t):
    """The plain versions' working type: f64 for f64 inputs, else f32."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _check_card(x, B, C, p, n, q):
    """Raise on what the kernels do not take (before any launch)."""
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


def _empty(like, *shape):
    """An f32 tensor of ``shape`` on ``like``'s device (the passes'
    scratch and the final state)."""
    return torch.empty(shape, dtype=torch.float32, device=like.device)


def ssd_scan(x, dt, A, B, C, chunk: int):
    """x: (b, s, h, p); dt: (b, s, h) (post-softplus); A: (h,) negative;
    B, C: (b, s, g, n).  Returns (y: (b, s, h, p) in x's dtype,
    state: (b, h, p, n) f32)."""
    global launches
    b, s, h, p, g, n, q = _shapes(x, dt, A, B, C, chunk)
    card, (x, dt, A, B, C) = card_inputs("ssd_scan", x, dt, A, B, C)
    if not card:
        return ssd_scan_ref(x, dt, A, B, C, chunk)
    _check_card(x, B, C, p, n, q)
    dt, A = dt.to(torch.float32), A.to(torch.float32)
    y = torch.empty_like(x)
    state = _empty(x, b, h, p, n)
    if x.numel() == 0:
        return y, state.zero_()
    cum, states = _empty(x, b, h, s), _empty(x, b, h, s // q, p, n)
    cb = _empty(x, b, g, s // q, q, q)
    LIBRARY.launch("ssd_scan_launch", x.device, x.data_ptr(), dt.data_ptr(),
                   A.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
                   state.data_ptr(), cum.data_ptr(), states.data_ptr(),
                   cb.data_ptr(), b, s, h, p, g, n, q, DTYPES[x.dtype],
                   DTYPES[B.dtype])
    launches += 1
    return y, state


# ------------------------------------------------------- the passes alone
def ssd_chunk_state(x, dt, A, B, chunk: int):
    """Pass 1: ``(cum (b, h, s), local (b, h, s // q, p, n))``, both f32:
    each chunk's inclusive cumsum of ``dt * A`` and its own state from
    zero."""
    b, s, h, p, g, n, q = _shapes(x, dt, A, B, B, chunk)
    card, (x, dt, A, B) = card_inputs("ssd_chunk_state", x, dt, A, B)
    if not card:
        return ssd_chunk_state_ref(x, dt, A, B, chunk)
    _check_card(x, B, B, p, n, q)
    dt, A = dt.to(torch.float32), A.to(torch.float32)
    cum, local = _empty(x, b, h, s), _empty(x, b, h, s // q, p, n)
    LIBRARY.launch("ssd_chunk_state_launch", x.device, x.data_ptr(),
                   dt.data_ptr(), A.data_ptr(), B.data_ptr(), cum.data_ptr(),
                   local.data_ptr(), b, s, h, p, g, n, q, DTYPES[x.dtype],
                   DTYPES[B.dtype])
    return cum, local


def ssd_state_pass(local, cum, chunk: int):
    """Pass 2: ``(states, final)``: the state entering each chunk
    (b, h, s // q, p, n) and the state after the last (b, h, p, n), f32.
    On either device ``states`` is ``local`` itself, overwritten (on the
    card its copy, if ``local`` was a view)."""
    b, h, nc, p, n = local.shape
    s = cum.shape[-1]
    q = min(chunk, s)
    if cum.shape != (b, h, s) or q <= 0 or s != nc * q:
        raise ValueError(f"ssd_state_pass: local (b, h, s // q, p, n) and "
                         f"cum (b, h, s), got {tuple(local.shape)}, "
                         f"{tuple(cum.shape)}, chunk {chunk}")
    card, (local, cum) = card_inputs("ssd_state_pass", local, cum)
    if not card:
        states, final = ssd_state_pass_ref(local, cum, chunk)
        return local.copy_(states), final
    if local.dtype != torch.float32 or cum.dtype != torch.float32:
        raise TypeError("ssd_state_pass takes f32 local and cum")
    final = _empty(local, b, h, p, n)
    LIBRARY.launch("ssd_state_pass_launch", local.device, local.data_ptr(),
                   cum.data_ptr(), final.data_ptr(), b * h, s, q, p * n)
    return local, final


def ssd_chunk_cb(B, C, chunk: int):
    """Pass 3: the scores ``C_i . B_j`` of each chunk, (b, g, s // q, q, q)
    f32.  Only the entries with j <= i are defined, on either device: the
    kernel leaves those above the diagonal outside its diagonal tiles
    unwritten, and the plain version gives 0 there.  Read the whole of it
    as ``torch.tril(cb)``."""
    b, s, g, n = B.shape
    q = min(chunk, s)
    if C.shape != B.shape or q <= 0 or s % q:
        raise ValueError(f"ssd_chunk_cb: B, C (b, s, g, n) and a chunk "
                         f"that divides s, got {tuple(B.shape)}, "
                         f"{tuple(C.shape)}, chunk {chunk}")
    card, (B, C) = card_inputs("ssd_chunk_cb", B, C)
    if not card:
        return ssd_chunk_cb_ref(B, C, chunk)
    _check_card(B, B, C, 1, n, q)
    cb = _empty(B, b, g, s // q, q, q)
    LIBRARY.launch("ssd_chunk_cb_launch", B.device, B.data_ptr(),
                   C.data_ptr(), cb.data_ptr(), b, s, g, n, q,
                   DTYPES[B.dtype])
    return cb


def ssd_chunk_scan(x, dt, C, cum, cb, states, chunk: int):
    """Pass 4: y (b, s, h, p) in x's dtype from the chunks' cumsums
    (b, h, s), scores (b, g, s // q, q, q) and entering states
    (b, h, s // q, p, n)."""
    b, s, h, p = x.shape
    g, n = C.shape[2], C.shape[3]
    q = min(chunk, s)
    if q <= 0 or s % q or g == 0 or h % g or dt.shape != (b, s, h):
        raise ValueError(f"ssd_chunk_scan: x (b, s, h, p), dt (b, s, h), C "
                         f"(b, s, g, n) with h % g == 0 and a chunk that "
                         f"divides s, got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(C.shape)}, chunk {chunk}")
    if (cum.shape != (b, h, s) or cb.shape != (b, g, s // q, q, q)
            or states.shape != (b, h, s // q, p, n)):
        raise ValueError(f"ssd_chunk_scan: cum (b, h, s), cb (b, g, s // q, "
                         f"q, q), states (b, h, s // q, p, n), got "
                         f"{tuple(cum.shape)}, {tuple(cb.shape)}, "
                         f"{tuple(states.shape)}")
    card, (x, dt, C, cum, cb, states) = card_inputs(
        "ssd_chunk_scan", x, dt, C, cum, cb, states)
    if not card:
        return ssd_chunk_scan_ref(x, dt, C, cum, cb, states, chunk)
    _check_card(x, C, C, p, n, q)
    if any(t.dtype != torch.float32 for t in (cum, cb, states)):
        raise TypeError("ssd_chunk_scan takes f32 cum, cb and states")
    dt = dt.to(torch.float32)
    y = torch.empty_like(x)
    LIBRARY.launch("ssd_chunk_scan_launch", x.device, x.data_ptr(),
                   dt.data_ptr(), C.data_ptr(), cum.data_ptr(), cb.data_ptr(),
                   states.data_ptr(), y.data_ptr(), b, s, h, p, g, n, q,
                   DTYPES[x.dtype], DTYPES[C.dtype])
    return y


# -------------------------------------------------------- plain versions
def _chunks(t, b, nc, q):
    """(b, s, k, w) -> (b, k, nc, q, w)."""
    return t.reshape(b, nc, q, t.shape[2], t.shape[3]).permute(0, 3, 1, 2, 4)


def ssd_chunk_state_ref(x, dt, A, B, chunk: int):
    """Plain version of :func:`ssd_chunk_state`: the reference's ``cum``
    and ``upd`` for every chunk at once."""
    b, s, h, p, g, n, q = _shapes(x, dt, A, B, B, chunk)
    wide, nc = _wide(x), s // q
    group = torch.arange(h, device=x.device) // (h // g)
    xc = _chunks(x.to(wide), b, nc, q)              # (b, h, nc, q, p)
    dtc = dt.to(wide).reshape(b, nc, q, h).permute(0, 3, 1, 2)
    bm = _chunks(B.to(wide), b, nc, q)[:, group]    # (b, h, nc, q, n)
    cum = torch.cumsum(dtc * A.to(wide)[None, :, None, None], dim=-1)
    xbar = xc * dtc[..., None]
    decay_in = torch.exp(cum[..., -1:] - cum)
    local = xbar.transpose(-1, -2) @ (bm * decay_in[..., None])
    return cum.reshape(b, h, s), local


def ssd_state_pass_ref(local, cum, chunk: int):
    """Plain version of :func:`ssd_state_pass`: the reference's
    ``state * exp(cum[-1]) + upd``, chunk by chunk."""
    b, h, nc, p, n = local.shape
    q = cum.shape[-1] // nc
    cl = cum.reshape(b, h, nc, q)[..., -1]
    state = torch.zeros((b, h, p, n), dtype=local.dtype, device=local.device)
    states = torch.empty_like(local)
    for c in range(nc):
        states[:, :, c] = state
        decay = torch.exp(cl[:, :, c])[..., None, None]
        state = state * decay + local[:, :, c]
    return states, state


def ssd_chunk_cb_ref(B, C, chunk: int):
    """Plain version of :func:`ssd_chunk_cb`: ``C B^T`` of each chunk and
    group, 0 above the diagonal."""
    b, s, g, n = B.shape
    q = min(chunk, s)
    wide = _wide(B)
    bm = _chunks(B.to(wide), b, s // q, q)
    cm = _chunks(C.to(wide), b, s // q, q)
    return torch.tril(cm @ bm.transpose(-1, -2))


def ssd_chunk_scan_ref(x, dt, C, cum, cb, states, chunk: int):
    """Plain version of :func:`ssd_chunk_scan`: the reference's
    ``y_diag + y_off`` for every chunk at once."""
    b, s, h, p = x.shape
    g = C.shape[2]
    q = min(chunk, s)
    wide, nc = _wide(x), s // q
    group = torch.arange(h, device=x.device) // (h // g)
    xc = _chunks(x.to(wide), b, nc, q)
    dtc = dt.to(wide).reshape(b, nc, q, h).permute(0, 3, 1, 2)
    cm = _chunks(C.to(wide), b, nc, q)[:, group]
    cumc = cum.to(wide).reshape(b, h, nc, q)
    lower = (torch.arange(q, device=x.device)[:, None]
             >= torch.arange(q, device=x.device)[None, :])
    xbar = xc * dtc[..., None]
    L = torch.where(lower, torch.exp(cumc[..., :, None] - cumc[..., None, :]),
                    0.0)
    y_diag = (cb.to(wide)[:, group] * L) @ xbar
    y_off = ((cm * torch.exp(cumc)[..., None])
             @ states.to(wide).transpose(-1, -2))
    y = (y_diag + y_off).to(x.dtype)                # (b, h, nc, q, p)
    return y.permute(0, 2, 3, 1, 4).reshape(b, s, h, p)


def ssd_scan_ref(x, dt, A, B, C, chunk: int):
    """Plain version of :func:`ssd_scan`: the Pallas body's steps, chunk by
    chunk, over every (batch, head) at once (any device, any width), in f32
    (in f64 for f64 x)."""
    b, s, h, p, g, n, q = _shapes(x, dt, A, B, C, chunk)
    wide = _wide(x)
    rep = h // g
    group = torch.arange(h, device=x.device) // rep
    xt = x.movedim(2, 1)                       # (b, h, s, p)
    dtt = dt.movedim(2, 1)                     # (b, h, s)
    Bt = B.movedim(2, 1)[:, group]             # (b, h, s, n)
    Ct = C.movedim(2, 1)[:, group]
    a = A.to(wide)[None, :, None]
    lower = (torch.arange(q, device=x.device)[:, None]
             >= torch.arange(q, device=x.device)[None, :])
    state = torch.zeros((b, h, p, n), dtype=wide, device=x.device)
    y = torch.empty((b, h, s, p), dtype=x.dtype, device=x.device)
    for c0 in range(0, s, q):
        xc = xt[:, :, c0:c0 + q].to(wide)       # (b, h, Q, P)
        dtc = dtt[:, :, c0:c0 + q].to(wide)     # (b, h, Q)
        bm = Bt[:, :, c0:c0 + q].to(wide)       # (b, h, Q, N)
        cm = Ct[:, :, c0:c0 + q].to(wide)
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

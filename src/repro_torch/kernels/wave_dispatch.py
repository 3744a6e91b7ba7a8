"""The wave dispatch/dependency recurrence: CUDA kernel, wrapper, plain version.

:func:`wave_dispatch` runs the hand-written CUDA kernel in
``csrc/wave_dispatch.cu`` (it replaces the TPU kernel built by
``_build_pallas_fn`` in the reference package's ``repro/core/batch_sim.py``).
:func:`wave_dispatch_ref` is its plain PyTorch version: one Python step per
μop row, vectorized across lanes, on any device.

Both take the wave row-major, one column per lane:

* ``issue``, ``mask_id``, ``lat``, ``blk``: int32 ``(S, E)``;
* ``valid``: bool ``(S, E)`` — rows that are not valid (padding, stale rows
  of a reused buffer) produce ``done = 0`` and change no port state;
* ``prod``, ``delta``: int32 ``(S, E, R)`` — producer row (``-1``: none) and
  the delta added to its ``done`` time (added even when ``prod < 0``);
* ``lut``: bool ``(M, P)`` — the ports each mask id allows, on the sorted
  port axis (which is also the dispatch tie-break order);

and return ``done`` int32 ``(S, E)`` and ``counts`` int32 ``(E, P)``.

A producer row at or after its reader (``j <= prod < S``) reads 0, as the
TPU kernel's zero-initialised ``done`` gives.

The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use, and loaded with ``ctypes`` (see
``kernels/_build.py``).  :func:`port_width` and :func:`rows_per_tile` report
the instance and the tile a launch takes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import CudaLibrary

MAX_PORTS = 32          # MAXP in the CUDA source
MAX_ROWS = 2**27 - 1    # rows: a count * 32 + port index fits 32 bits
_INT32_MAX = 2**31 - 1

# kernel launches made by wave_dispatch (the CUDA path only)
launches = 0


def _bind(lib):
    fn = lib.wave_dispatch_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.wave_dispatch_max_ports.restype = ctypes.c_int
    lib.wave_dispatch_port_width.argtypes = [ctypes.c_int]
    lib.wave_dispatch_port_width.restype = ctypes.c_int
    lib.wave_dispatch_rows_per_tile.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.wave_dispatch_rows_per_tile.restype = ctypes.c_int
    lib.wave_dispatch_max_rows.restype = ctypes.c_int
    if lib.wave_dispatch_max_rows() != MAX_ROWS:
        raise RuntimeError("kernel library disagrees on MAX_ROWS")
    if lib.wave_dispatch_max_ports() != MAX_PORTS:
        raise RuntimeError("kernel library disagrees on MAXP")


LIBRARY = CudaLibrary("wave_dispatch.cu", _bind)


@functools.lru_cache(maxsize=None)
def port_width(P: int) -> int:
    """The port width of the kernel instance a launch with ``P`` ports runs
    (8 up to 8 ports, else 32; 0 outside 1..32).  Builds the library."""
    return LIBRARY.load()[0].wave_dispatch_port_width(P)


@functools.lru_cache(maxsize=None)
def rows_per_tile(R: int, M: int) -> int:
    """Rows of per-row inputs a stage of the kernel holds at ``R`` reads and
    ``M`` port masks (0: they do not fit in shared memory, which bounds
    both).  Builds the library."""
    return LIBRARY.load()[0].wave_dispatch_rows_per_tile(R, M)


def _check(issue, mask_id, lat, blk, valid, prod, delta, lut):
    if issue.dim() != 2:
        raise ValueError(f"issue must be (S, E), got {tuple(issue.shape)}")
    S, E = issue.shape
    if prod.dim() != 3 or prod.shape[:2] != (S, E):
        raise ValueError(f"prod must be (S, E, R), got {tuple(prod.shape)}")
    R = prod.shape[2]
    if lut.dim() != 2:
        raise ValueError(f"lut must be (M, P), got {tuple(lut.shape)}")
    for name, t, shape, dtype in (
            ("issue", issue, (S, E), torch.int32),
            ("mask_id", mask_id, (S, E), torch.int32),
            ("lat", lat, (S, E), torch.int32),
            ("blk", blk, (S, E), torch.int32),
            ("valid", valid, (S, E), torch.bool),
            ("prod", prod, (S, E, R), torch.int32),
            ("delta", delta, (S, E, R), torch.int32),
            ("lut", lut, tuple(lut.shape), torch.bool)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != issue.device:
            raise ValueError(f"{name} is on {t.device}, issue on "
                             f"{issue.device}")
    return S, E, R


def wave_dispatch(issue, mask_id, lat, blk, valid, prod, delta, lut):
    """Run the recurrence on the tensors' device: the CUDA kernel for CUDA
    tensors (on the current stream), the plain version for CPU tensors.
    Returns ``(done (S, E), counts (E, P))``, both int32."""
    global launches
    S, E, R = _check(issue, mask_id, lat, blk, valid, prod, delta, lut)
    dev = issue.device
    if dev.type == "cpu":
        return wave_dispatch_ref(issue, mask_id, lat, blk, valid, prod,
                                 delta, lut)
    if dev.type != "cuda":
        raise ValueError(f"wave_dispatch runs on cuda or cpu, not {dev}")
    M, P = lut.shape
    if not 1 <= P <= MAX_PORTS:
        raise ValueError(f"the kernel takes 1..{MAX_PORTS} ports, got {P}")
    if R < 1:
        raise ValueError("prod must have at least one read column")
    if S > MAX_ROWS:
        raise ValueError(f"the kernel takes at most {MAX_ROWS} rows, got {S}")
    if rows_per_tile(R, M) == 0:
        raise ValueError(f"{R} read columns and {M} port masks do not fit "
                         "in the kernel's shared memory")
    args = (issue, mask_id, lat, blk, valid, prod, delta, lut)
    for name, t in zip(("issue", "mask_id", "lat", "blk", "valid", "prod",
                        "delta", "lut"), args):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    done = torch.empty((S, E), dtype=torch.int32, device=dev)
    counts = torch.empty((E, P), dtype=torch.int32, device=dev)
    if S == 0 or E == 0:
        counts.zero_()
        return done, counts
    LIBRARY.launch("wave_dispatch_launch", dev,
                   *(t.data_ptr() for t in args), done.data_ptr(),
                   counts.data_ptr(), S, E, R, M, P)
    launches += 1
    return done, counts


def wave_dispatch_ref(issue, mask_id, lat, blk, valid, prod, delta, lut):
    """The plain PyTorch version of the kernel (any device): one step per
    μop row up to the last valid one, all lanes at once, with the TPU
    kernel's two-pass tie-break (earliest time, then least count, then
    lowest port index)."""
    S, E, R = _check(issue, mask_id, lat, blk, valid, prod, delta, lut)
    dev = issue.device
    P = lut.shape[1]
    pf = torch.zeros((E, P), dtype=torch.int32, device=dev)
    pc = torch.zeros((E, P), dtype=torch.int32, device=dev)
    rows = valid.any(dim=1).nonzero()
    if S == 0 or E == 0 or rows.numel() == 0:
        return torch.zeros((S, E), dtype=torch.int32, device=dev), pc
    # the walk ends at the last valid row, as the kernel's does: every
    # later row gives done = 0 and changes no port state
    walk = int(rows[-1]) + 1
    issue, mask_id, lat, blk, valid = (t[:walk] for t in
                                       (issue, mask_id, lat, blk, valid))
    prod, delta = prod[:walk], delta[:walk]
    big = torch.tensor(_INT32_MAX, dtype=torch.int32, device=dev)
    ports = torch.arange(P, device=dev)[None, :]
    lanes = torch.arange(E, device=dev)[None, :, None]
    # done history, flat, with one extra all-zero row that producers < 0
    # read from
    done = torch.zeros((S + 1) * E, dtype=torch.int32, device=dev)
    src = torch.where(prod < 0, S, prod).long() * E + lanes     # (S, E, R)
    allowed = lut[mask_id.long()]                               # (S, E, P)
    vint = valid.to(torch.int32)
    # an invalid row's winner is pushed off the port axis: no state change
    off = (~valid).long() * P
    steps = zip(issue.unbind(0), src.unbind(0), delta.unbind(0),
                allowed.unbind(0), lat.unbind(0), blk.unbind(0),
                vint.unbind(0), off.unbind(0), done[:walk * E].split(E))
    for isu, sr, de, alw, la, bl, va, of, out in steps:
        ready = torch.maximum(isu, (done.take(sr) + de).amax(dim=1))
        t = torch.maximum(ready[:, None], pf)
        ta = torch.where(alw, t, big)
        tmin = ta.amin(dim=1)
        best = torch.where(ta == tmin[:, None], pc, big).argmin(dim=1)
        torch.mul(tmin + la, va, out=out)
        hit = ports == (best + of)[:, None]
        pf = torch.where(hit, (tmin + bl)[:, None], pf)
        pc += hit
    return done[:S * E].view(S, E), pc

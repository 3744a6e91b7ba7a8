"""Unit blockers: the CUDA kernels of ``csrc/microbench.cu``, their wrappers
and their plain PyTorch versions.

The port of the reference package's ``repro/kernels/microbench.py``, the
form of the paper's *blocking instructions* (§5.1.1) for an accelerator:
where an x86 blocking instruction saturates one port combination, each
blocker here saturates one functional unit of the card:

    mxu_blocker   chained f32 products acc = acc @ b (3xTF32)  -> tensor cores
    vpu_blocker   long fmaf chains                             -> FP32 pipe
    sfu_blocker   rsqrt chains                                 -> MUFU
    lsu_blocker   streaming x + 1 with 16-byte accesses        -> HBM

``core/kernel_bench.py`` runs a target kernel beside each blocker and
reads unit occupancy from the contention signature (the counter-free form
of Algorithm 1).

The public blockers keep the reference's signatures and defaults, with
``device=`` (default ``cuda:0``) in place of ``interpret=``; they make the
reference's inputs (:func:`blocker_inputs`, which callers that time or
check a blocker use too) and call the inner entry points :func:`mxu_chain`,
:func:`vpu_chain`, :func:`sfu_chain` and :func:`lsu_stream`, which take
their input tensors.  Each inner entry point launches its CUDA kernel for a
CUDA tensor (on the current stream, without synchronizing) and runs its
plain version (``*_ref``) for a CPU tensor.  ``launches`` counts the kernel
launches per unit.

Where the kernels differ from the TPU kernels:

* ``mxu_chain`` takes ``tile`` a multiple of 16, at most :data:`MXU_MAX_TILE`
  (one CTA holds ``acc`` and ``b`` in shared memory); the plain version
  takes any square tile.
* ``vpu_chain``'s kernel contracts ``acc * 1.000001 + 0.5`` into one fused
  multiply-add, so it rounds once where the plain version rounds twice
  (1.2e-7 relative apart after 256 steps from 1.0).
* ``lsu_stream`` writes every row; the reference's ``lsu_blocker`` leaves
  the rows past the last multiple of 512 unwritten when ``rows > 512``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.device_mesh import resolve_device
from repro_torch.kernels._build import CudaLibrary

TILE = 128
MXU_MAX_TILE = 128      # MXU_MAX_TILE in the CUDA source

# kernel launches per unit (the CUDA path only)
launches = {"MXU": 0, "VPU": 0, "SFU": 0, "LSU": 0}


def _bind(lib):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, args in (("mxu_chain_launch", [vp, vp, vp, i32, i32, vp]),
                       ("vpu_chain_launch", [vp, vp, i64, i32, vp]),
                       ("sfu_chain_launch", [vp, vp, i64, i32, vp]),
                       ("lsu_stream_launch", [vp, vp, i64, vp])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.microbench_mxu_max_tile.restype = ctypes.c_int
    if lib.microbench_mxu_max_tile() != MXU_MAX_TILE:
        raise RuntimeError("kernel library disagrees on MXU_MAX_TILE")


LIBRARY = CudaLibrary("microbench.cu", _bind)


def _check(name, t, device=None):
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _on_card(name, *tensors) -> bool:
    """True for CUDA tensors (after checking what the kernels need), False
    for CPU tensors; any other device raises."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
    return True


def _launch(unit, fn_name, dev, *args):
    lib, _ = LIBRARY.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err}")
    launches[unit] += 1


# --------------------------------------------------------------------- MXU
def mxu_chain(a, b, iters: int):
    """``iters`` chained products ``acc = acc @ b`` from ``acc = a``; ``a``
    and ``b`` square f32 of one size."""
    _check("a", a)
    _check("b", b, a.device)
    if a.dim() != 2 or a.shape[0] != a.shape[1] or b.shape != a.shape:
        raise ValueError(f"a and b must be one square (tile, tile) shape, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if not _on_card("mxu_chain", a, b):
        return mxu_chain_ref(a, b, iters)
    tile = a.shape[0]
    if tile % 16 or not 16 <= tile <= MXU_MAX_TILE:
        raise ValueError(f"the MXU kernel takes a tile that is a multiple "
                         f"of 16 from 16 to {MXU_MAX_TILE}, got {tile}")
    out = torch.empty_like(a)
    _launch("MXU", "mxu_chain_launch", a.device, a.data_ptr(), b.data_ptr(),
            out.data_ptr(), tile, int(iters))
    return out


def mxu_chain_ref(a, b, iters: int):
    """Plain version of :func:`mxu_chain` (any device, any square tile)."""
    acc = a.clone()
    for _ in range(iters):
        acc = acc @ b
    return acc


def mxu_blocker(iters: int = 64, tile: int = TILE, *, device=None):
    return mxu_chain(*blocker_inputs("MXU", device, iters=iters, tile=tile))


# --------------------------------------------------------------------- VPU
def _elementwise(name, x):
    _check("x", x)
    if x.dim() != 2 or x.shape[1] != TILE:
        raise ValueError(f"{name}: x must be (rows, {TILE}), got "
                         f"{tuple(x.shape)}")
    return _on_card(name, x)


def vpu_chain(x, iters: int):
    """``iters`` steps of ``acc = acc * 1.000001 + 0.5`` from ``acc = x``,
    ``x`` f32 ``(rows, 128)``."""
    if not _elementwise("vpu_chain", x):
        return vpu_chain_ref(x, iters)
    out = torch.empty_like(x)
    _launch("VPU", "vpu_chain_launch", x.device, x.data_ptr(),
            out.data_ptr(), x.numel(), int(iters))
    return out


def vpu_chain_ref(x, iters: int):
    """Plain version of :func:`vpu_chain`: the product and the sum rounded
    separately."""
    acc = x.clone()
    for _ in range(iters):
        acc = acc * 1.000001 + 0.5
    return acc


def vpu_blocker(iters: int = 256, rows: int = 8, *, device=None):
    return vpu_chain(*blocker_inputs("VPU", device, iters=iters, rows=rows))


# --------------------------------------------------------------------- SFU
def sfu_chain(x, iters: int):
    """``iters`` steps of ``acc = rsqrt(acc + 1.5)`` from ``acc = x``,
    ``x`` f32 ``(rows, 128)``."""
    if not _elementwise("sfu_chain", x):
        return sfu_chain_ref(x, iters)
    out = torch.empty_like(x)
    _launch("SFU", "sfu_chain_launch", x.device, x.data_ptr(),
            out.data_ptr(), x.numel(), int(iters))
    return out


def sfu_chain_ref(x, iters: int):
    """Plain version of :func:`sfu_chain`."""
    acc = x.clone()
    for _ in range(iters):
        acc = torch.rsqrt(acc + 1.5)
    return acc


def sfu_blocker(iters: int = 128, rows: int = 8, *, device=None):
    return sfu_chain(*blocker_inputs("SFU", device, iters=iters, rows=rows))


# --------------------------------------------------------------------- LSU
def lsu_stream(x):
    """``x + 1`` streamed through memory, ``x`` f32 ``(rows, 128)``."""
    if not _elementwise("lsu_stream", x):
        return lsu_stream_ref(x)
    out = torch.empty_like(x)
    _launch("LSU", "lsu_stream_launch", x.device, x.data_ptr(),
            out.data_ptr(), x.numel())
    return out


def lsu_stream_ref(x):
    """Plain version of :func:`lsu_stream`."""
    return x + 1.0


def lsu_blocker(rows: int = 4096, *, device=None):
    """Streaming copy: bandwidth-bound, near-zero arithmetic intensity."""
    return lsu_stream(*blocker_inputs("LSU", device, rows=rows))


def blocker_inputs(unit: str, device=None, **size):
    """The inputs the public blocker of ``unit`` makes, as the argument tuple
    of the unit's inner entry point (``INNER[unit][0]``).  ``size`` holds
    the blocker's own keywords, all of them: ``iters`` and ``tile`` (MXU),
    ``iters`` and ``rows`` (VPU, SFU), ``rows`` (LSU)."""
    dev = resolve_device(device)
    if unit == "MXU":
        a = torch.eye(size["tile"], dtype=torch.float32, device=dev) * 1.0001
        return (a, a, size["iters"])
    fill = torch.zeros if unit == "LSU" else torch.ones
    x = fill((size["rows"], TILE), dtype=torch.float32, device=dev)
    return (x,) if unit == "LSU" else (x, size["iters"])


BLOCKERS = {
    "MXU": mxu_blocker,
    "VPU": vpu_blocker,
    "SFU": sfu_blocker,
    "LSU": lsu_blocker,
}

# each unit's inner entry point (kernel on the card) and its plain version
INNER = {
    "MXU": (mxu_chain, mxu_chain_ref),
    "VPU": (vpu_chain, vpu_chain_ref),
    "SFU": (sfu_chain, sfu_chain_ref),
    "LSU": (lsu_stream, lsu_stream_ref),
}

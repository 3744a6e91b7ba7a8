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

The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, into a build directory keyed by the
source's hash (``build/repro_torch/`` at the checkout root, or
``$REPRO_TORCH_BUILD_DIR``), and loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "wave_dispatch.cu"
MAX_PORTS = 32          # MAXP in the CUDA source
MAX_MASKS = 12 * 1024   # port masks held in 48 KB of shared memory
_INT32_MAX = 2**31 - 1

# kernel launches made by wave_dispatch (the CUDA path only)
launches = 0

_LIB = None
_LIB_LOCK = threading.Lock()
build_log = ""          # nvcc's -Xptxas -v report of the last build
build_seconds = None    # wall time of the last build in this process


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return _SRC.parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the wave-dispatch kernel is built "
                       "from source with the CUDA toolkit")


def load_library():
    """Build (if needed) and load the kernel library; returns
    ``(lib, loaded_now)``.  The library is keyed by the source's hash, so
    an edited source is rebuilt and a built one is reused."""
    global _LIB, build_log, build_seconds
    if _LIB is not None:
        return _LIB, False
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB, False
        import time  # noqa: PLC0415
        src = _SRC.read_bytes()
        tag = hashlib.sha256(src).hexdigest()[:16]
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        so = out_dir / f"wave_dispatch_{tag}.so"
        if not so.exists():
            tmp = out_dir / f".wave_dispatch_{tag}.{os.getpid()}.so"
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-o", str(tmp), str(_SRC)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_seconds = time.perf_counter() - t0
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{build_log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        fn = lib.wave_dispatch_launch
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.wave_dispatch_max_ports.restype = ctypes.c_int
        if lib.wave_dispatch_max_ports() != MAX_PORTS:
            raise RuntimeError("kernel library disagrees on MAXP")
        _LIB = lib
        return lib, True


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
    if M > MAX_MASKS:
        raise ValueError(f"the kernel takes at most {MAX_MASKS} port masks, "
                         f"got {M}")
    if R < 1:
        raise ValueError("prod must have at least one read column")
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
    lib, _ = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.wave_dispatch_launch(
            *(t.data_ptr() for t in args), done.data_ptr(),
            counts.data_ptr(), S, E, R, M, P, stream)
    if err != 0:
        raise RuntimeError(f"wave_dispatch launch failed: CUDA error {err}")
    launches += 1
    return done, counts


def wave_dispatch_ref(issue, mask_id, lat, blk, valid, prod, delta, lut):
    """The plain PyTorch version of the kernel (any device): one step per
    μop row, all lanes at once, with the TPU kernel's two-pass tie-break
    (earliest time, then least count, then lowest port index)."""
    S, E, R = _check(issue, mask_id, lat, blk, valid, prod, delta, lut)
    dev = issue.device
    P = lut.shape[1]
    pf = torch.zeros((E, P), dtype=torch.int32, device=dev)
    pc = torch.zeros((E, P), dtype=torch.int32, device=dev)
    if S == 0 or E == 0:
        return torch.zeros((S, E), dtype=torch.int32, device=dev), pc
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
    rows = zip(issue.unbind(0), src.unbind(0), delta.unbind(0),
               allowed.unbind(0), lat.unbind(0), blk.unbind(0),
               vint.unbind(0), off.unbind(0), done[:S * E].split(E))
    for isu, sr, de, alw, la, bl, va, of, out in rows:
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

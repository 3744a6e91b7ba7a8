"""Build a CUDA source of the port into a shared library and load it.

Every kernel source under ``csrc/`` has a plain C interface.  At first use
it is compiled with ``nvcc`` for ``sm_90a`` into a shared library, keyed by
the source's hash, in a build directory (``build/repro_torch/`` at the
checkout root, or ``$REPRO_TORCH_BUILD_DIR``), and loaded with ``ctypes``.
An edited source is rebuilt; a built one is reused.  Several libraries can
be built at once from several threads: each holds its own lock, and
``nvcc`` runs outside the interpreter lock.

Every wrapper follows one rule: a CUDA tensor launches the kernel (or
raises), a CPU tensor takes the plain version.  The kernels read rows with
16-byte loads, so a wrapper takes its inputs through :func:`card_inputs`,
which copies (:func:`aligned`) only a CUDA view that is not contiguous and
16-byte aligned.  (``wave_dispatch``, whose inputs ``core/batch_sim.py``
packs itself, keeps its own checks and raises on a view.)
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# the dtype codes of the op layer's C entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parents[2] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "source with the CUDA toolkit")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when it is contiguous and 16-byte aligned, else a
    contiguous, 16-byte-aligned copy (a transposed or strided view, or a
    contiguous slice that starts off a 16-byte boundary)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    # one copy into a new allocation, which starts aligned
    return t.clone(memory_format=torch.contiguous_format)


def card_inputs(name, *tensors):
    """``(on the card, tensors)``.  CUDA tensors on one device, with a card
    present, launch the kernel, each passed through :func:`aligned`; CPU
    tensors take the plain version and come back as they are; any other
    device raises."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False, tensors
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"{name}: {dev} tensor but no CUDA device is "
                           "available")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on {t.device} and {dev}")
    return True, tuple(aligned(t) for t in tensors)


class CudaLibrary:
    """One CUDA source, built and loaded once per process.

    ``bind(lib)`` declares the C functions' ``argtypes``/``restype`` on the
    loaded library and checks it agrees with the Python side."""

    def __init__(self, source: str, bind):
        self.source = CSRC / source
        self._bind = bind
        self._lib = None
        self._lock = threading.Lock()
        self.path = None          # the shared library, once loaded
        self.build_log = ""       # nvcc's -Xptxas -v report of the build
        self.build_seconds = None  # nvcc wall time, if built in this process

    def load(self):
        """Build (if needed) and load the library; returns
        ``(lib, loaded_now)``."""
        if self._lib is not None:
            return self._lib, False
        with self._lock:
            if self._lib is not None:
                return self._lib, False
            stem = self.source.stem
            tag = hashlib.sha256(self.source.read_bytes()).hexdigest()[:16]
            out_dir = build_dir()
            out_dir.mkdir(parents=True, exist_ok=True)
            so = out_dir / f"{stem}_{tag}.so"
            if not so.exists():
                tmp = out_dir / f".{stem}_{tag}.{os.getpid()}.so"
                cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                       "-std=c++17", "-O3", "-shared", "-Xcompiler",
                       "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
                       str(self.source)]
                t0 = time.perf_counter()
                proc = subprocess.run(cmd, capture_output=True, text=True)
                self.build_seconds = time.perf_counter() - t0
                self.build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {self.source.name} "
                                       f"({proc.returncode}):\n"
                                       f"{self.build_log}")
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            self._bind(lib)
            self.path = so
            self._lib = lib
            return lib, True

    def launch(self, fn_name: str, device, *args) -> None:
        """Call the C entry point ``fn_name`` with ``args`` and the current
        stream of ``device``; raise if it returns a CUDA error."""
        lib, _ = self.load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(lib, fn_name)(*args, stream)
        if err != 0:
            raise RuntimeError(f"{fn_name} failed: CUDA error {err}")

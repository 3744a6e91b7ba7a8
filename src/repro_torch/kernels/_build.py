"""Build a CUDA source of the port into a shared library and load it.

Every kernel source under ``csrc/`` has a plain C interface.  At first use
it is compiled with ``nvcc`` for ``sm_90a`` into a shared library, keyed by
the source's hash, in a build directory (``build/repro_torch/`` at the
checkout root, or ``$REPRO_TORCH_BUILD_DIR``), and loaded with ``ctypes``.
An edited source is rebuilt; a built one is reused.  Several libraries can
be built at once from several threads: each holds its own lock, and
``nvcc`` runs outside the interpreter lock.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"


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

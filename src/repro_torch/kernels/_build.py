"""Build the port's CUDA sources with ``nvcc`` and bind them with ``ctypes``.

Each source under ``csrc/`` is compiled on its own with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library in
``build/repro_torch/`` (or ``$REPRO_TORCH_BUILD_DIR``) at first use, keyed
by a hash of the source, the shared ``csrc/*.cuh`` headers and the flags,
and exposes a plain ``extern "C"`` interface: launchers that return
``cudaGetLastError()`` and an ``<name>_error_string(int)`` that names such
a code.  Nothing here runs when the module is imported; :func:`build_all` compiles several sources
side by side (one ``nvcc`` each).
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable

__all__ = ["CudaLibrary", "build_all", "NVCC_FLAGS", "CSRC"]

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(__file__))))
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _build_dir() -> str:
    return os.environ.get(
        "REPRO_TORCH_BUILD_DIR", os.path.join(_REPO_ROOT, "build", "repro_torch")
    )


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built on the GPU host")


def _digest(source: str) -> str:
    """Build key: the source, the shared headers of ``csrc/`` and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [source] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


class CudaLibrary:
    """One CUDA source, ``csrc/<name>.cu``, built and loaded on demand.

    ``bind(lib)`` declares ``argtypes``/``restype`` of the launchers.
    :attr:`info` holds, after :meth:`load`, the library path, the build
    seconds (0.0 when it was already built) and ``nvcc -Xptxas -v``'s
    report (registers, spills, shared memory per kernel).
    """

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = os.path.join(CSRC, f"{name}.cu")
        self.info: dict = {}
        self._bind = bind
        self._lib = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        """Compile (once per source hash) and load; thread-safe."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            digest = _digest(self.source)
            out_dir = _build_dir()
            lib_path = os.path.join(out_dir, f"{self.name}_{digest}.so")
            log_path = lib_path + ".log"
            seconds = 0.0
            if not os.path.exists(lib_path):
                os.makedirs(out_dir, exist_ok=True)
                tmp = f"{lib_path}.{os.getpid()}.{threading.get_ident()}.tmp"
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source],
                    capture_output=True, text=True,
                )
                seconds = time.perf_counter() - t0
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {self.source}:\n{proc.stderr}")
                with open(log_path, "w") as f:
                    f.write(proc.stdout + proc.stderr)
                os.replace(tmp, lib_path)
            lib = ctypes.CDLL(lib_path)
            err_fn = getattr(lib, f"{self.name}_error_string")
            err_fn.argtypes = [ctypes.c_int]
            err_fn.restype = ctypes.c_char_p
            self._bind(lib)
            log = ""
            if os.path.exists(log_path):
                with open(log_path) as f:
                    log = f.read()
            self.info.update(path=lib_path, seconds=seconds, ptxas=log)
            self._lib = lib
            return lib

    def check(self, err: int, what: str) -> None:
        """Raise ``RuntimeError`` when a launcher returned a CUDA error."""
        if err != 0:
            msg = getattr(self._lib, f"{self.name}_error_string")(err).decode()
            raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def build_all(libraries: Iterable[CudaLibrary]) -> None:
    """Build and load ``libraries`` concurrently, one ``nvcc`` each."""
    libs = list(libraries)
    with ThreadPoolExecutor(max_workers=max(1, len(libs))) as pool:
        for fut in [pool.submit(lib.load) for lib in libs]:
            fut.result()

"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` (Hopper) into its own shared library, which
:mod:`ctypes` loads. Libraries go to ``build/kernels/`` at the repository
root, named by a hash of the source, the headers beside it (``*.cuh``)
and the flags, so an edited source or header never loads a stale
library. Nothing is built at import: the first launch builds its
library, and :func:`build_all` builds every source at once (one ``nvcc``
process per source, all started together) — what ``chip_smoke.py``
calls before anything else.

A wrapper launches through a :class:`Kernel`, which binds the C function,
counts launches in the plain integer ``launches`` (only where the kernel
really launched) and raises on any CUDA error code the C side returns.
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
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = (
    "fused_norm", "flash_attention", "flash_bwd", "paged_attention", "int4_matmul",
    "fused_attention",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are "
            "built from source on the machine with the card"
        )
    return str(path)


def _target(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source,
    every header under ``csrc/`` (a source may include any of them) and
    the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one nvcc for ``name`` unless its library is already built;
    returns ``(target, process or None)``."""
    target = _target(name)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return target, proc


def _finish(name: str, target: Path, proc) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(out)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, target)


def build_all(names: Sequence[str] = SOURCES) -> float:
    """Build every named source in parallel; returns the wall seconds.
    Raises ``RuntimeError`` with nvcc's output if any build fails."""
    t0 = time.perf_counter()
    with _lock:
        started = [(n, *_start(n)) for n in names]
        errors: List[str] = []
        for name, target, proc in started:
            try:
                _finish(name, target, proc)
            except RuntimeError as exc:
                errors.append(str(exc))
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)
    for the last build of ``name`` in this build directory."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def _library(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target, proc = _start(name)
            _finish(name, target, proc)
            lib = _libs[name] = ctypes.CDLL(str(target))
        return lib


class Kernel:
    """One C entry point of one kernel library, with its launch count.

    ``argtypes`` must name ``ctypes.c_void_p`` for every pointer and the
    stream (a bare int would be passed as a 32-bit value and cut the
    pointer). The C function returns a ``cudaError_t``; non-zero raises.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def _bind(self):
        if self._fn is None:
            fn = getattr(_library(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, *args) -> None:
        code = self._bind()(*args)
        if code != 0:
            raise RuntimeError(
                f"CUDA kernel {self.symbol} failed to launch "
                f"(cudaError_t {code})"
            )
        self.launches += 1

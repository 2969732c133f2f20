"""Deterministic shuffled batches over row-aligned numpy arrays.

The port of :mod:`unionml_tpu.data.native`: the C++ threaded host loader
(``_native/hostloader.cpp``, this package's own copy) assembles shuffled
batches on worker threads into staging buffers. This module builds it at
first use with ``g++`` into ``build/host/`` at the repository root (named
by a hash of the source and the flags, compiled to a unique temporary
path and then renamed, so concurrent builds never load a half-written
library), binds its plain C interface through :mod:`ctypes`, and wraps
the staging pointers as numpy arrays without copying. Without a C++
toolchain it falls back to a numpy path with the identical stream.

Determinism contract: the epoch permutation is ``argsort(splitmix64(seed
^ (epoch + 1) * PHI ^ row))`` with ties broken by row index, in C++ and
in numpy, so with the same seed the port's trainer sees the reference
trainer's batch order and a run resumes from ``(epoch, step)`` on either.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from unionml_tpu_torch._logging import logger

_PHI = np.uint64(0x9E3779B97F4A7C15)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 over uint64 (bit-identical to the C++ one)."""
    with np.errstate(over="ignore"):
        x = (x + _PHI).astype(np.uint64)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def epoch_permutation(n_rows: int, seed: int, epoch: int, shuffle: bool = True) -> np.ndarray:
    """The loader's deterministic row order for ``epoch``."""
    if not shuffle:
        return np.arange(n_rows, dtype=np.uint64)
    with np.errstate(over="ignore"):
        base = np.uint64(seed) ^ (np.uint64(epoch + 1) * _PHI)
    keys = splitmix64(base ^ np.arange(n_rows, dtype=np.uint64))
    return np.argsort(keys, kind="stable").astype(np.uint64)


# --------------------------------------------------------------------- #
# build
# --------------------------------------------------------------------- #

SOURCE = Path(__file__).resolve().parent / "_native" / "hostloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_FAILED = False


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    """The library built from :data:`SOURCE`, named by a hash of the
    source and the flags (an edited source never loads a stale build)."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return Path(build_dir) / f"hostloader-{digest.hexdigest()[:16]}.so"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
    lib.hl_new.restype = ctypes.c_void_p
    lib.hl_new.argtypes = [u8pp, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
                           ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.hl_num_batches.restype = ctypes.c_uint64
    lib.hl_num_batches.argtypes = [ctypes.c_void_p]
    lib.hl_start_epoch.restype = None
    lib.hl_start_epoch.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64]
    lib.hl_next.restype = ctypes.c_uint64
    lib.hl_next.argtypes = [ctypes.c_void_p, u8pp, ctypes.POINTER(ctypes.c_void_p)]
    lib.hl_release.restype = None
    lib.hl_release.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.hl_free.restype = None
    lib.hl_free.argtypes = [ctypes.c_void_p]
    return lib


def build_library(build_dir: Path = BUILD_DIR) -> Optional[ctypes.CDLL]:
    """Build (unless already built) and load the host loader from
    ``build_dir``; ``None`` when there is no working ``g++``."""
    so = library_path(build_dir)
    try:
        if not so.exists():
            so.parent.mkdir(parents=True, exist_ok=True)
            # a unique temporary name, then an atomic rename: concurrent
            # builds (test workers, a trainer beside them) never load a
            # half-written library
            tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            try:
                subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            finally:
                tmp.unlink(missing_ok=True)
        return _bind(ctypes.CDLL(str(so)))
    except (OSError, subprocess.SubprocessError) as exc:
        logger.info(f"native host loader unavailable ({exc!r}); using the numpy path")
        return None


def get_library() -> Optional[ctypes.CDLL]:
    """The process's host loader library, built at the first call;
    ``None`` (the numpy path) when it cannot be built."""
    global _LIB, _LIB_FAILED
    with _LIB_LOCK:
        if _LIB is None and not _LIB_FAILED:
            _LIB = build_library()
            _LIB_FAILED = _LIB is None
        return _LIB


# --------------------------------------------------------------------- #
# the loader
# --------------------------------------------------------------------- #


class BatchLoader:
    """Shuffled batches over arrays sharing their leading (row) dimension;
    each batch is a tuple of arrays in the given order. ``epoch(e,
    start_batch)`` resumes mid-epoch.

    The native loader is used when it builds (``use_native=None``), the
    numpy path otherwise; both give the identical stream.
    ``use_native=True`` raises without the native loader, ``False`` takes
    the numpy path. ``num_threads`` / ``queue_depth`` size the native
    side's workers and its ready queue. ``copy=False`` yields zero-copy
    views of the native staging buffers: a batch is valid only until the
    generator is advanced (the feed pins, and so copies, each batch
    before it pulls the next).
    """

    def __init__(
        self,
        arrays: Sequence[np.ndarray],
        *,
        batch_size: int,
        seed: int = 0,
        shuffle: bool = True,
        drop_remainder: bool = False,
        num_threads: int = 2,
        queue_depth: int = 4,
        use_native: Optional[bool] = None,
        copy: bool = True,
    ):
        if not arrays:
            raise ValueError("BatchLoader needs at least one array")
        self.arrays = [np.ascontiguousarray(a) for a in arrays]
        n = self.arrays[0].shape[0]
        if any(a.shape[0] != n for a in self.arrays):
            raise ValueError("all arrays must share the leading dimension")
        self.n_rows = n
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.copy = copy
        self.num_batches = n // batch_size if drop_remainder else -(-n // batch_size)
        self._active_iter: Optional[object] = None
        lib = get_library() if use_native is None or use_native else None
        if use_native and lib is None:
            raise RuntimeError("the native host loader was requested but cannot be built")
        self._lib = lib
        self._handle = None
        if lib is not None:
            k = len(self.arrays)
            ptrs = (ctypes.POINTER(ctypes.c_uint8) * k)()
            row_bytes = (ctypes.c_uint64 * k)()
            for i, a in enumerate(self.arrays):
                ptrs[i] = a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
                row_bytes[i] = a.dtype.itemsize * int(np.prod(a.shape[1:], dtype=np.int64))
            self._handle = lib.hl_new(ptrs, row_bytes, k, n, batch_size, seed, int(shuffle),
                                      int(drop_remainder), num_threads, queue_depth)

    @property
    def native(self) -> bool:
        """Whether this loader runs on the native library."""
        return self._handle is not None

    def epoch(self, epoch: int = 0, start_batch: int = 0) -> Iterator[Tuple[np.ndarray, ...]]:
        """The batches of one epoch, from ``start_batch`` on.

        One epoch iterator may be live per loader: the native side holds
        one (permutation, queue) state per handle, so a second iterator
        would corrupt the first. The numpy path keeps the same rule, so
        both give the same streams; use one loader per stream."""
        gen = (self._native_epoch(epoch, start_batch) if self._handle is not None
               else self._numpy_epoch(epoch, start_batch))
        token = object()
        self._active_iter = token
        try:
            while True:
                if self._active_iter is not token:
                    raise RuntimeError(
                        "concurrent epoch() iterators on one BatchLoader are not "
                        "supported — create a separate loader per stream"
                    )
                try:
                    item = next(gen)
                except StopIteration:
                    return
                yield item
        finally:
            if self._active_iter is token:
                self._active_iter = None
            gen.close()

    def epochs(
        self, num_epochs: int, *, start_epoch: int = 0, start_batch: int = 0
    ) -> Iterator[Tuple[int, int, Tuple[np.ndarray, ...]]]:
        """``(epoch, batch_index, batch)`` across epochs, with resume."""
        for e in range(start_epoch, num_epochs):
            sb = start_batch if e == start_epoch else 0
            for i, batch in enumerate(self.epoch(e, sb)):
                yield e, sb + i, batch

    def _native_epoch(self, epoch: int, start_batch: int):
        lib, handle = self._lib, self._handle
        lib.hl_start_epoch(handle, epoch, start_batch)
        out_ptrs = (ctypes.POINTER(ctypes.c_uint8) * len(self.arrays))()
        token = ctypes.c_void_p()
        pending = None  # the staging buffer lent out with copy=False
        try:
            while True:
                rows = lib.hl_next(handle, out_ptrs, ctypes.byref(token))
                if pending is not None:
                    # the consumer advanced the generator: the lent batch is
                    # done with, so its staging buffer goes back to the pool
                    lib.hl_release(handle, pending)
                    pending = None
                if rows == 0:
                    return
                out = []
                for i, a in enumerate(self.arrays):
                    nbytes = int(rows) * a.dtype.itemsize * int(np.prod(a.shape[1:],
                                                                        dtype=np.int64))
                    buf = ctypes.cast(out_ptrs[i], ctypes.POINTER(ctypes.c_uint8 * nbytes))
                    view = np.frombuffer(buf.contents, dtype=a.dtype).reshape(
                        (int(rows),) + a.shape[1:])
                    out.append(view.copy() if self.copy else view)
                if self.copy:
                    lib.hl_release(handle, token)
                else:
                    pending = ctypes.c_void_p(token.value)
                yield tuple(out)
        finally:
            # close() may have freed the handle while this generator was
            # suspended (abandoned mid-epoch)
            if pending is not None and self._handle is not None:
                lib.hl_release(self._handle, pending)

    def _numpy_epoch(self, epoch: int, start_batch: int):
        perm = epoch_permutation(self.n_rows, self.seed, epoch, self.shuffle)
        for b in range(start_batch, self.num_batches):
            idx = perm[b * self.batch_size:(b + 1) * self.batch_size]
            yield tuple(a[idx] for a in self.arrays)

    def close(self) -> None:
        """Stop the native workers and free the staging buffers."""
        if self._handle is not None:
            self._lib.hl_free(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass

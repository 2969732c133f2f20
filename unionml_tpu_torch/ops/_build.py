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

Each kernel row also has a cost function beside its wrapper: the
``(flops, bytes)`` of one call from its arguments' shapes. The op that
picks the kernel or its plain version reports that cost through
:func:`charged` to the cost counter of the calling thread
(:class:`unionml_tpu_torch.introspection.CostCounter`), whichever path
runs, and the aten ops inside it are not counted: a program costs the
same on the card and on the CPU. With no dispatch mode on the thread,
:func:`charged` is one C call and a shared null context.

The same choke point serves the NaN guard
(:func:`unionml_tpu_torch.diagnostics.nan_guard`): each row passes its
result through :func:`checked`, which, while :data:`NAN_GUARD` is set,
raises ``FloatingPointError`` naming the row and its C entry when a NaN
comes out. The aten ops outside the rows are checked by :class:`NanMode`
on each thread that runs device work (:func:`nan_scope`); the ops inside
a row, its plain version's included, are the row's and are not checked
one by one, so the CPU and the card name the same row. With the guard
off a row pays one read of :data:`NAN_GUARD`.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack

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
        record = getattr(_CAPTURE_TLS, "record", None)
        if record is None:
            self.launches += 1
        else:
            record[self] = record.get(self, 0) + 1


#: per thread: ``record``, the launches a CUDA graph capture open on this
#: thread has recorded (:func:`launches_recorded`)
_CAPTURE_TLS = threading.local()


@contextlib.contextmanager
def launches_recorded():
    """Launches this thread makes inside the block go into the yielded
    ``{kernel: n}`` instead of the kernels' counts: a CUDA graph's capture
    records its launches and runs none, and each replay credits them.
    Other threads' launches meanwhile count as ever."""
    outer = getattr(_CAPTURE_TLS, "record", None)
    record: Dict["Kernel", int] = {}
    _CAPTURE_TLS.record = record
    try:
        yield record
    finally:
        _CAPTURE_TLS.record = outer


# --------------------------------------------------------------------- #
# kernel costs
# --------------------------------------------------------------------- #

#: per thread: ``quiet``, the depth of :func:`charged` scopes open here
#: (a cost counter does not count aten ops inside one)
COST_TLS = threading.local()
_NULL = contextlib.nullcontext()


def cost_sink():
    """The innermost cost counter on this thread's dispatch-mode stack
    (autograd's worker threads inherit the stack of the thread that
    started the backward), or None."""
    if not torch._C._len_torch_dispatch_stack():
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if getattr(mode, "counts_costs", False):
            return mode
    return None


@contextlib.contextmanager
def _kernel_scope(sink, cost: Optional[Tuple[float, float]]):
    depth = getattr(COST_TLS, "quiet", 0)
    if depth == 0 and sink is not None:
        sink.charge(*cost)
    COST_TLS.quiet = depth + 1
    try:
        yield
    finally:
        COST_TLS.quiet = depth


def charged(cost_fn: Callable[..., Tuple[float, float]], *args, **kwargs):
    """A context for one call of a kernel row (the kernel or its plain
    version): when a cost counter is active, ``cost_fn(*args, **kwargs)``
    is charged to it once (a row called inside another row's scope is part
    of that row's cost) and the aten ops inside are not counted. The scope
    also keeps :class:`NanMode` off the row's own ops."""
    if not torch._C._len_torch_dispatch_stack():
        return _NULL
    sink = cost_sink()
    return _kernel_scope(sink, None if sink is None else cost_fn(*args, **kwargs))


# --------------------------------------------------------------------- #
# the NaN guard
# --------------------------------------------------------------------- #

#: process-wide, as ``jax_debug_nans`` is: set while a
#: :func:`~unionml_tpu_torch.diagnostics.nan_guard` scope is open on any
#: thread
NAN_GUARD = False


def row_label(row: int, kernel: Kernel) -> str:
    """How the guard names a kernel row: ``"row 2, fused_norm.norm_fwd"``."""
    return f"row {row}, {kernel.source}.{kernel.symbol}"


def nan_error(where: str) -> FloatingPointError:
    return FloatingPointError(f"invalid value (nan) encountered in {where}")


def _floating(out: Any) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        if type(out).__name__ == "DTensor":
            out = out.to_local()   # a rank checks its own shard
        return [out] if out.is_floating_point() else []
    if isinstance(out, (list, tuple)):
        return [t for x in out for t in _floating(x)]
    if isinstance(out, dict):
        return [t for x in out.values() for t in _floating(x)]
    return []


def holds_nan(out: Any) -> bool:
    """Whether a floating tensor in ``out`` (a tensor or a tree of them)
    holds a NaN: one readback a tensor, its ops neither counted nor
    checked. False while the CUDA stream is capturing a graph, where a
    readback is illegal (the captured predictor checks each replay)."""
    tensors = _floating(out)
    if not tensors:
        return False
    if any(t.is_cuda for t in tensors) and torch.cuda.is_current_stream_capturing():
        return False
    depth = getattr(COST_TLS, "quiet", 0)
    COST_TLS.quiet = depth + 1
    try:
        return any(bool(torch.isnan(t).any()) for t in tensors)
    finally:
        COST_TLS.quiet = depth


def checked(out: Any, row: str) -> Any:
    """A kernel row's result, passed through. Under the NaN guard a NaN in
    it raises ``FloatingPointError`` naming ``row`` (see
    :func:`row_label`); the kernel or its plain version ran either way."""
    if NAN_GUARD and holds_nan(out):
        raise nan_error(row)
    return out


_NAN_RULES: Dict[Any, Optional[int]] = {}


def _nan_rule(func) -> Optional[int]:
    """What :class:`NanMode` checks of ``func``, decided once per op: None
    for nothing (a view or an allocation makes no values), the position
    of the values argument of a scatter (it writes only those; the rest
    of its result is what the buffer held, which may be stale or never
    written), else -1: the result."""
    from unionml_tpu_torch.introspection import _ALLOCS, _SCATTERS, _VIEWS

    packet = func._overloadpacket
    if func.is_view or packet in _VIEWS or packet in _ALLOCS:
        return None
    return _SCATTERS.get(packet, -1)


class NanMode(TorchDispatchMode):
    """The guard's check of each aten op on the thread that entered it:
    a NaN in the values an op makes raises ``FloatingPointError`` naming
    the op (``aten.mul.Tensor``); see :func:`_nan_rule`. Ops inside a
    kernel row are the row's (checked by :func:`checked`); a DTensor op
    is checked by the local ops it runs."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in types:
            if t not in (torch.Tensor, torch.nn.Parameter):
                if t.__name__ == "DTensor":
                    return NotImplemented
                return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if NAN_GUARD and not getattr(COST_TLS, "quiet", 0):
            rule = _NAN_RULES[func] if func in _NAN_RULES else \
                _NAN_RULES.setdefault(func, _nan_rule(func))
            if rule is not None and holds_nan(out if rule < 0 else
                                              args[rule] if len(args) > rule else None):
                raise nan_error(str(func))
        return out


def nan_scope():
    """The context a thread runs one unit of device work in (the engine's
    dispatcher pass and harvest, the batcher's batch, the feed's item):
    while the guard is on, :class:`NanMode` unless this thread has one
    entered already; else the shared null context. Autograd's workers
    inherit the mode of the thread that started the backward."""
    if not NAN_GUARD:
        return _NULL
    if torch._C._len_torch_dispatch_stack() and any(
            isinstance(m, NanMode) for m in _get_current_dispatch_mode_stack()):
        return _NULL
    return NanMode()


def nbytes(*tensors: Optional[torch.Tensor]) -> int:
    """Bytes of the given tensors (None counts 0)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_ms(cost: Tuple[float, float], peak_ops: float, peak_bytes: float) -> Tuple[float, str]:
    """The least time (ms) a device with these peaks could take for a call
    of ``cost = (flops, bytes)``, and what bounds it: the larger of the
    bytes over the memory rate and the operations over the peak rate for
    their type."""
    flops, moved = cost
    t_bytes, t_ops = moved / peak_bytes * 1e3, flops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

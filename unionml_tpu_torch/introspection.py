"""Program costs, device peaks and tracking for the port's device programs.

The port of :mod:`unionml_tpu.introspection`. The reference reads each
compiled program's ``cost_analysis()`` at its compile event; eager
PyTorch compiles nothing, so the port counts instead:

- :class:`CostCounter` — a ``TorchDispatchMode`` that adds up one
  call's work: the FLOPs of every aten op outside a kernel row (matrix
  products and convolutions by the formulas ``torch.utils.flop_counter``
  registers, one operation per output element of elementwise
  arithmetic, one per input element of a reduction) and the bytes of
  its tensor operands and results (a view moves nothing; a gather reads
  and writes its result's bytes, a scatter its values'). Each kernel row
  charges its own cost function's ``(flops, bytes)`` instead, on the
  card and on the CPU alike (:func:`unionml_tpu_torch.ops._build
  .charged`), so a program costs the same wherever it runs. The mode is
  thread-local: it counts only the calls of the thread that entered it
  (and of autograd's workers for a backward that thread started). Under
  a placed tree a rank counts its local shards' work (a DTensor op is
  counted by the local ops it runs): the reference's ``lower().cost_analysis()``
  reads the program before partitioning and so counts the whole mesh's
  work, where ``compile().cost_analysis()`` of the partitioned program
  is per device; the port's ratios divide by one card's peak, so they
  take the per-device count.
- :class:`ProgramTracker` — wraps the hot paths' programs (engine
  prefill / decode / splice, batcher predict, trainer steps, the
  captured predictor). The port's compile event is the first dispatch
  of a new ``sig_fn`` signature: that call runs under a
  :class:`CostCounter`, its cost is kept for the signature, the compile
  is counted with its wall time and ``on_compile(key, ms)`` is told
  (goodput's ``compile`` bucket). Every later call at that signature
  pays one dict lookup and the counter increments.
- **MFU / roofline gauges**: each program keeps a window of ``(t,
  cumulative flops, cumulative bytes)`` samples at dispatch;
  ``unionml_program_mfu_ratio`` / ``unionml_program_hbm_ratio`` divide
  the windowed rates by the peaks of :func:`resolve_device_peaks`
  (:data:`DEVICE_PEAKS`, overridable by :data:`PEAK_FLOPS_ENV` /
  :data:`PEAK_HBM_ENV`); an unknown device reads 0.

Also here, as in the reference: :func:`capture_profile` (``POST
/debug/profile``, on :mod:`torch.profiler`) and
:func:`device_memory_breakdown` (``GET /debug/memory``, on
``torch.cuda.memory_stats`` and a census of live tensors).
"""

from __future__ import annotations

import gc
import math
import os
import tempfile
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from unionml_tpu_torch import telemetry
from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.ops._build import COST_TLS
from unionml_tpu_torch.ops._build import nbytes as _size

__all__ = [
    "CostCounter",
    "DEVICE_PEAKS",
    "MAX_CAPTURE_SECONDS",
    "PEAK_FLOPS_ENV",
    "PEAK_HBM_ENV",
    "ProfileInProgress",
    "ProgramTracker",
    "capture_profile",
    "device_memory_breakdown",
    "resolve_device_peaks",
]

# env overrides for devices the table doesn't know (or partial overrides
# to correct a table entry): absolute FLOP/s and HBM GB/s
PEAK_FLOPS_ENV = "UNIONML_TPU_PEAK_FLOPS"
PEAK_HBM_ENV = "UNIONML_TPU_PEAK_HBM_GBPS"

# per-device peaks: (dense bf16 FLOP/s, HBM bytes/s), keyed on a
# lowercase substring of the device name (longest key wins). Sources:
# NVIDIA's H100 data sheet (SXM5:
# 1979 TFLOP/s bf16 with sparsity, so 989e12 dense, and 3.35 TB/s; PCIe:
# 1513 with sparsity, so 756e12 dense, and 2.0 TB/s); the SXM5 card
# names itself "NVIDIA H100 80GB HBM3". The CPU row is a NOMINAL
# placeholder so CPU test runs produce finite ratios — it is not a
# meaningful roofline.
DEVICE_PEAKS: Dict[str, Tuple[float, float]] = {
    "h100 80gb hbm3": (989e12, 3.35e12),
    "h100 pcie": (756e12, 2.0e12),
    "cpu": (5e10, 2e10),
}


def _device_name(device: Any) -> Tuple[str, str]:
    """(platform, kind) of ``device`` (a ``torch.device``, a string or an
    index; default: the first card, else the CPU)."""
    if device is None:
        device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    elif isinstance(device, int):
        device = torch.device("cuda", device)
    else:
        device = torch.device(device)
    if device.type == "cuda":
        return "gpu", torch.cuda.get_device_name(device)
    return device.type, device.type


def resolve_device_peaks(device: Any = None) -> dict:
    """``{"platform", "kind", "peak_flops", "peak_bytes_per_s",
    "source"}`` for ``device`` (default: the first card, else the CPU).

    Env overrides (:data:`PEAK_FLOPS_ENV` FLOP/s, :data:`PEAK_HBM_ENV`
    GB/s) win over the table — the escape hatch for devices the table
    doesn't know; either can be set alone. ``source`` is ``env``,
    ``table``, or ``unknown`` (no match: peaks are ``None`` and the
    MFU gauges report 0 rather than a made-up ratio)."""
    platform, kind = "unknown", "unknown"
    try:
        platform, kind = _device_name(device)
    except Exception as exc:  # no such device: peaks resolve from env only
        logger.info(f"device peak resolution: no device ({exc!r})")
    flops: Optional[float] = None
    bandwidth: Optional[float] = None
    source = "unknown"
    lowered = kind.lower()
    for key in sorted(DEVICE_PEAKS, key=len, reverse=True):
        if key in lowered or key in platform.lower():
            flops, bandwidth = DEVICE_PEAKS[key]
            source = "table"
            break
    env_flops = os.environ.get(PEAK_FLOPS_ENV)
    env_hbm = os.environ.get(PEAK_HBM_ENV)
    if env_flops or env_hbm:
        try:
            if env_flops:
                flops = float(env_flops)
            if env_hbm:
                bandwidth = float(env_hbm) * 1e9
            source = "env"
        except ValueError:
            logger.info(
                f"ignoring malformed peak override "
                f"{PEAK_FLOPS_ENV}={env_flops!r} {PEAK_HBM_ENV}={env_hbm!r}"
            )
    return {
        "platform": platform,
        "kind": kind,
        "peak_flops": flops,
        "peak_bytes_per_s": bandwidth,
        "source": source,
    }


# --------------------------------------------------------------------- #
# the counting mode
# --------------------------------------------------------------------- #

_aten = torch.ops.aten
# aliases of their input that the schema does not mark as views
_VIEWS = {_aten.detach, _aten.alias, _aten.lift_fresh, _aten._unsafe_view,
          _aten._reshape_alias}
# results whose bytes are not moved (allocation only)
_ALLOCS = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
           _aten.new_empty_strided, _aten.resize_}
# elementwise by tag but moving or converting values, no arithmetic
_MOVES = {_aten.clone, _aten._to_copy, _aten.copy, _aten.copy_, _aten.fill, _aten.fill_,
          _aten.zero_, _aten.lift_fresh_copy}
# reads and writes only the selected rows (result bytes) plus the indices
_GATHERS = {_aten.index, _aten.index_select, _aten.embedding, _aten.gather,
            _aten._unsafe_index}
# writes only its values (and reads them and the indices): the position
# of the values argument
_SCATTERS = {_aten.index_put: 2, _aten.index_put_: 2, _aten._index_put_impl_: 2,
             _aten.index_copy: 3, _aten.index_copy_: 3, _aten.scatter: 3, _aten.scatter_: 3,
             _aten.scatter_add: 3, _aten.scatter_add_: 3, _aten.index_add: 3,
             _aten.index_add_: 3, _aten.masked_scatter: 2, _aten.masked_scatter_: 2}
# operations an element of the fused row ops (their kernels' arithmetic)
_ROW_OPS = {_aten._softmax: 4, _aten._log_softmax: 5, _aten._softmax_backward_data: 4,
            _aten._log_softmax_backward_data: 4, _aten.native_layer_norm: 8,
            _aten.native_layer_norm_backward: 15}


_PLAIN = (torch.Tensor, torch.nn.Parameter)
# composite ops counted whole (their formula, not their decomposition)
_KEEP_WHOLE = {_aten.native_layer_norm, _aten._softmax, _aten._log_softmax}
# matrix products: the positions of their two factors
_PRODUCTS = {_aten.mm: (0, 1), _aten.bmm: (0, 1), _aten.addmm: (1, 2), _aten.baddbmm: (1, 2)}


def _tensors(tree: Any) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _classify(func) -> tuple:
    """How :func:`_op_cost` counts ``func``: ``(kind, detail)``, decided
    once per op overload."""
    from torch.utils.flop_counter import flop_registry

    packet = func._overloadpacket
    if packet not in _KEEP_WHOLE and torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), "CompositeImplicitAutograd"):
        return ("composite", None)
    if func.is_view or packet in _VIEWS or packet in _ALLOCS:
        return ("free", None)
    if packet in _GATHERS:
        return ("gather", None)
    if packet in _SCATTERS:
        return ("scatter", _SCATTERS[packet])
    if packet in (_aten.copy_, _aten.fill_, _aten.zero_):
        return ("write", None)
    if packet in _PRODUCTS:
        return ("product", _PRODUCTS[packet])
    if packet in flop_registry:
        return ("formula", flop_registry[packet])
    if packet in _ROW_OPS:
        return ("row", _ROW_OPS[packet])
    if torch.Tag.reduction in func.tags:
        return ("reduction", None)
    if torch.Tag.pointwise in func.tags and packet not in _MOVES:
        return ("pointwise", None)
    return ("move", None)


_RULES: Dict[Any, tuple] = {}


def _op_cost(func, args: tuple, kwargs: dict, out: Any) -> Tuple[float, float]:
    """``(flops, bytes)`` of one aten op (see :class:`CostCounter`)."""
    kind, detail = _RULES.get(func) or _RULES.setdefault(func, _classify(func))
    if kind == "free":
        return 0.0, 0.0
    ins = _tensors(args)
    if kwargs:
        ins += _tensors(kwargs)
    outs = _tensors(out)
    if kind == "gather":
        index = sum(_size(t) for t in ins[1:] if not t.is_floating_point())
        return 0.0, float(2 * sum(_size(t) for t in outs) + index)
    if kind == "scatter":
        values = _tensors(args[detail]) if len(args) > detail else []
        index = _tensors(args[1:detail])
        if values:
            moved = 2 * sum(_size(t) for t in values)
        else:   # a scalar scattered: written at every index
            moved = sum(t.numel() for t in index) * ins[0].element_size()
        flops = sum(t.numel() for t in values) if "add" in func._overloadpacket.__name__ else 0
        return float(flops), float(moved + sum(_size(t) for t in index))
    if kind == "write":
        return 0.0, float(sum(_size(t) for t in ins[1:]) + sum(_size(t) for t in outs))
    seen, moved = set(), 0
    for t in ins:
        if id(t) not in seen:
            seen.add(id(t))
            moved += _size(t)
    for t in outs:   # a result written in place of an operand: read and written
        moved += _size(t)
    if kind == "product":
        a, b = args[detail[0]].shape, args[detail[1]].shape
        return float(2 * math.prod(a) * b[-1]), float(moved)
    if kind == "formula":
        return float(detail(*args, **kwargs, out_val=out)), float(moved)
    if kind == "row":
        return float(detail * ins[0].numel()), float(moved)
    if kind == "reduction":
        return float(ins[0].numel() if ins else 0), float(moved)
    if kind == "pointwise":
        return float(max((t.numel() for t in outs), default=0)), float(moved)
    return 0.0, float(moved)


class CostCounter(TorchDispatchMode):
    """Counts the ``(flops, bytes)`` of the calls made while it is entered
    (see the module docstring): every aten op outside a kernel row by
    :func:`_op_cost`, every kernel row by its own cost function
    (:meth:`charge`). Thread-local, as every dispatch mode is."""

    counts_costs = True

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        # the part the kernel rows charged (their cost functions)
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0

    def charge(self, flops: float, nbytes: float) -> None:
        """A kernel row's (or a replayed graph's) cost."""
        self.flops += flops
        self.bytes += nbytes
        self.kernel_flops += flops
        self.kernel_bytes += nbytes

    @property
    def cost(self) -> Tuple[float, float]:
        return self.flops, self.bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in types:
            if t not in _PLAIN:
                if t.__name__ == "DTensor":
                    # it runs its local ops back through this mode
                    return NotImplemented
                # another subclass (the fake tensors of a DTensor's sharding
                # propagation) does no work on the device
                return func(*args, **kwargs)
        rule = _RULES.get(func) or _RULES.setdefault(func, _classify(func))
        if rule[0] == "composite":
            # a composite op reaches the mode whole under inference mode
            # (tensordot, linear, matmul): count what it decomposes into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
            _RULES[func] = ("move", None)
        out = func(*args, **kwargs)
        if not getattr(COST_TLS, "quiet", 0):
            flops, moved = _op_cost(func, args, kwargs, out)
            self.flops += flops
            self.bytes += moved
        return out


class _Program:
    """Per-key tracking state (guarded by the tracker lock)."""

    __slots__ = (
        "key", "calls", "compiles", "cum_flops", "cum_bytes",
        "cost_by_sig", "last_cost", "window", "last_t", "pending",
        "m_calls", "m_compiles", "m_flops", "m_bytes", "h_compile",
        "h_call",
    )

    def __init__(self, key: str):
        self.key = key
        self.calls = 0
        self.compiles = 0
        self.cum_flops = 0.0
        self.cum_bytes = 0.0
        # signature -> (flops, bytes) counted at its first dispatch; the
        # sig is whatever the program's sig_fn returns (a bucket shape,
        # a static length) — None for single-shape programs
        self.cost_by_sig: Dict[Any, Tuple[float, float]] = {}
        self.last_cost: Tuple[float, float] = (0.0, 0.0)
        self.window: "deque[Tuple[float, float, float]]" = deque(maxlen=256)
        self.last_t = 0.0
        # signatures whose counted first dispatch is running on some thread
        self.pending: set = set()


class ProgramTracker:
    """Cost registry over a component's device programs.

    ``wrap(key, fn, sig_fn=...)`` returns a drop-in callable. The first
    dispatch at a new signature (``sig_fn``'s cheap per-call value: a
    bucket shape — NOT a full tree, which would put a traversal on the
    hot path) is the port's compile event: it runs under a
    :class:`CostCounter` and its ``(flops, bytes)`` are kept for the
    signature; steady-state calls attribute that signature's cost to the
    cumulative counters and the MFU window, and record their host wall
    time. A callable that runs no aten op and no kernel costs ``(0,
    0)``.

    All series land in the shared telemetry registry labeled
    ``{component, program}``; :meth:`stats` is the ``stats()
    ["programs"]`` view.
    """

    WINDOW_S = 60.0

    def __init__(
        self,
        registry: Optional[telemetry.MetricsRegistry] = None,
        component: str = "program",
        window_s: float = WINDOW_S,
        on_compile: Optional[Callable[[str, float], None]] = None,
    ):
        self._registry = (
            registry if registry is not None else telemetry.get_registry()
        )
        self.component = component
        self.window_s = float(window_s)
        # compile-event push seam: called as on_compile(key, call_ms)
        # AFTER the counted call returns — the goodput tracker
        # (unionml_tpu_torch.goodput) subscribes to debit that call's time
        # out of the compute bucket. Exceptions are swallowed: an observer
        # bug must never fail the hot path.
        self.on_compile = on_compile
        self._lock = threading.Lock()
        self._programs: Dict[str, _Program] = {}
        self._peaks: Optional[dict] = None
        R = self._registry
        labels = ("component", "program")
        self._f_calls = R.counter(
            "unionml_program_calls_total",
            "Dispatches of a tracked compiled program.", labels,
        )
        self._f_compiles = R.counter(
            "unionml_program_compiles_total",
            "Compile events per tracked program: first dispatches of a new "
            "call signature (a count above the expected shape set = "
            "recompiles).", labels,
        )
        self._f_flops = R.counter(
            "unionml_program_flops_total",
            "FLOPs dispatched, per the cost counted at each signature's "
            "first dispatch.", labels,
        )
        self._f_bytes = R.counter(
            "unionml_program_bytes_total",
            "Device-memory bytes accessed, per the cost counted at each "
            "signature's first dispatch.", labels,
        )
        self._f_compile_ms = R.histogram(
            "unionml_program_compile_ms",
            "Wall time of compile events (the counted first dispatch of a "
            "signature).", labels,
        )
        self._f_call_ms = R.histogram(
            "unionml_program_call_ms",
            "Host wall time of one dispatch (on the card: the enqueue, "
            "the call does not wait for the device).", labels,
        )
        self._f_mfu = R.gauge(
            "unionml_program_mfu_ratio",
            "Windowed achieved FLOP/s over the device peak "
            "(model-flops utilization; 0 when idle or peak unknown).",
            labels,
        )
        self._f_hbm = R.gauge(
            "unionml_program_hbm_ratio",
            "Windowed achieved bytes/s over peak HBM bandwidth "
            "(roofline memory utilization; 0 when idle or peak "
            "unknown).", labels,
        )

    # ------------------------------------------------------------------ #

    def _get(self, key: str) -> _Program:
        with self._lock:
            prog = self._programs.get(key)
            if prog is None:
                prog = _Program(key)
                lbl = (self.component, key)
                prog.m_calls = self._f_calls.labels(*lbl)
                prog.m_compiles = self._f_compiles.labels(*lbl)
                prog.m_flops = self._f_flops.labels(*lbl)
                prog.m_bytes = self._f_bytes.labels(*lbl)
                prog.h_compile = self._f_compile_ms.labels(*lbl)
                prog.h_call = self._f_call_ms.labels(*lbl)
                self._f_mfu.labels(*lbl).set_function(
                    lambda p=prog: self._utilization(p)[0]
                )
                self._f_hbm.labels(*lbl).set_function(
                    lambda p=prog: self._utilization(p)[1]
                )
                self._programs[key] = prog
            return prog

    def wrap(
        self,
        key: str,
        fn: Callable,
        sig_fn: Optional[Callable[..., Any]] = None,
    ) -> Callable:
        """Instrument ``fn`` under ``key``. ``sig_fn(*args, **kwargs)``
        must be CHEAP (one shape attribute, a static kwarg) and only
        distinct enough to separate the shapes this one callable runs at
        (e.g. the token-bucket shape for prefill); ``None`` declares a
        single-signature program."""
        prog = self._get(key)

        def wrapper(*args, **kwargs):
            sig = None
            if sig_fn is not None:
                try:
                    sig = sig_fn(*args, **kwargs)
                except Exception:
                    sig = None
            with self._lock:
                cost = prog.cost_by_sig.get(sig)
                first = cost is None and sig not in prog.pending
                if first:
                    prog.pending.add(sig)
            if first:
                return self._first_call(prog, sig, fn, args, kwargs)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            prog.h_call.observe((time.perf_counter() - t0) * 1e3)
            self._account(prog, cost if cost is not None else prog.last_cost)
            return out

        wrapper.__wrapped__ = fn
        wrapper.program_key = key
        return wrapper

    def _first_call(self, prog: _Program, sig, fn, args, kwargs):
        """The compile event: the call runs under a :class:`CostCounter`."""
        counter = CostCounter()
        t0 = time.perf_counter()
        try:
            with counter:
                out = fn(*args, **kwargs)
        except BaseException:
            with self._lock:
                prog.pending.discard(sig)
            raise
        self.record_compile(prog.key, sig, counter.cost, (time.perf_counter() - t0) * 1e3)
        return out

    def record_compile(self, key: str, sig: Any, cost: Tuple[float, float],
                       ms: float) -> None:
        """Record a compile event of program ``key`` at signature ``sig``
        whose counted call cost ``cost`` and took ``ms``: the signature's
        cost, a compile, its time, ``on_compile`` and the call itself (the
        path of :meth:`wrap`, and of a captured graph's counted warm-up)."""
        prog = self._get(key)
        cost = (float(cost[0]), float(cost[1]))
        with self._lock:
            prog.pending.discard(sig)
            prog.compiles += 1
            prog.cost_by_sig[sig] = cost
            prog.last_cost = cost
        prog.m_compiles.inc()
        prog.h_compile.observe(ms)
        if self.on_compile is not None:
            try:
                self.on_compile(prog.key, ms)
            except Exception:
                pass
        self._account(prog, cost)

    def record_call(self, key: str, sig: Any, ms: float) -> None:
        """Record one steady-state call of program ``key`` at ``sig`` that
        took ``ms`` on the host (a graph replay)."""
        prog = self._get(key)
        prog.h_call.observe(ms)
        self._on_call(prog, sig)

    def cost(self, key: str, sig: Any = None) -> Tuple[float, float]:
        """Last-known ``(flops, bytes)`` of one dispatch of program
        ``key`` at signature ``sig`` (falling back to the program's last
        counted cost; ``(0, 0)`` for untracked programs) — the
        per-dispatch numerator the usage ledger splits across tenants."""
        with self._lock:
            prog = self._programs.get(key)
            if prog is None:
                return (0.0, 0.0)
            return prog.cost_by_sig.get(sig, prog.last_cost)

    def _on_call(self, prog: _Program, sig) -> None:
        with self._lock:
            cost = prog.cost_by_sig.get(sig, prog.last_cost)
        self._account(prog, cost)

    def _account(self, prog: _Program, cost: Tuple[float, float]) -> None:
        now = time.monotonic()
        flops, nbytes = cost
        with self._lock:
            prog.calls += 1
            prog.cum_flops += flops
            prog.cum_bytes += nbytes
            prog.window.append((now, prog.cum_flops, prog.cum_bytes))
            while (
                len(prog.window) > 2
                and now - prog.window[0][0] > self.window_s
            ):
                prog.window.popleft()
            prog.last_t = now
        prog.m_calls.inc()
        if flops:
            prog.m_flops.inc(flops)
        if nbytes:
            prog.m_bytes.inc(nbytes)

    # ------------------------------------------------------------------ #

    def peaks(self) -> dict:
        """Device peaks, resolved once per tracker
        (:func:`resolve_device_peaks`)."""
        with self._lock:
            if self._peaks is None:
                self._peaks = resolve_device_peaks()
            return self._peaks

    def _rates(self, prog: _Program) -> Tuple[float, float]:
        """Windowed achieved (FLOP/s, bytes/s); 0 when idle (no
        dispatch within the window) or under 2 samples."""
        now = time.monotonic()
        with self._lock:
            if len(prog.window) < 2 or now - prog.last_t > self.window_s:
                return 0.0, 0.0
            t0, f0, b0 = prog.window[0]
            t1, f1, b1 = prog.window[-1]
        dt = t1 - t0
        if dt <= 0:
            return 0.0, 0.0
        return (f1 - f0) / dt, (b1 - b0) / dt

    def _utilization(self, prog: _Program) -> Tuple[float, float]:
        """(MFU, HBM-roofline) ratios for the gauges; 0 when the peak
        is unknown rather than a fabricated ratio."""
        flops_s, bytes_s = self._rates(prog)
        peaks = self.peaks()
        mfu = (
            flops_s / peaks["peak_flops"] if peaks["peak_flops"] else 0.0
        )
        hbm = (
            bytes_s / peaks["peak_bytes_per_s"]
            if peaks["peak_bytes_per_s"] else 0.0
        )
        return mfu, hbm

    def stats(self) -> dict:
        """The ``stats()["programs"]`` view: per program — calls,
        compiles, compile- and call-time summaries, flops/bytes per call
        and total, windowed achieved rates, and the MFU/roofline ratios —
        plus a ``device`` entry naming the peaks they are measured
        against."""
        peaks = self.peaks()
        out: dict = {"device": dict(peaks)}
        with self._lock:
            programs = list(self._programs.values())
        for prog in programs:
            mfu, hbm = self._utilization(prog)
            flops_s, bytes_s = self._rates(prog)
            with self._lock:
                entry = {
                    "calls": prog.calls,
                    "compiles": prog.compiles,
                    "flops_per_call": prog.last_cost[0],
                    "bytes_per_call": prog.last_cost[1],
                    "flops_total": prog.cum_flops,
                    "bytes_total": prog.cum_bytes,
                }
            for name, hist in (("compile_ms", prog.h_compile), ("call_ms", prog.h_call)):
                summary = hist.summary()
                if summary:
                    entry[name] = summary
            entry["achieved_flops_per_s"] = round(flops_s, 1)
            entry["achieved_bytes_per_s"] = round(bytes_s, 1)
            entry["mfu"] = round(mfu, 6)
            entry["hbm_utilization"] = round(hbm, 6)
            out[prog.key] = entry
        return out

    def reset(self) -> None:
        """Zero cumulative counters and windows (benchmarks call this
        between phases); the counted signatures' costs are kept — they
        describe programs that still run."""
        with self._lock:
            programs = list(self._programs.values())
        for prog in programs:
            with self._lock:
                prog.calls = 0
                prog.compiles = 0
                prog.cum_flops = 0.0
                prog.cum_bytes = 0.0
                prog.window.clear()
                prog.last_t = 0.0
            for m in (prog.m_calls, prog.m_compiles, prog.m_flops,
                      prog.m_bytes, prog.h_compile, prog.h_call):
                m.reset()


# --------------------------------------------------------------------- #
# on-demand profiler capture (POST /debug/profile)
# --------------------------------------------------------------------- #


class ProfileInProgress(RuntimeError):
    """A capture is already running (the transport answers 409): the
    profiler is process-global and nested captures corrupt the trace."""


_capture_lock = threading.Lock()

MAX_CAPTURE_SECONDS = 120.0


def capture_profile(seconds: float = 2.0, log_dir: Optional[str] = None) -> dict:
    """Capture a :mod:`torch.profiler` trace (CPU, and CUDA activity with a
    card) for ``seconds`` (clamped to :data:`MAX_CAPTURE_SECONDS`) and
    return its artifact directory. Blocks the calling thread for the
    window; the traffic in flight meanwhile is what the trace shows.
    Raises :class:`ProfileInProgress` while another capture runs, and
    ``ValueError`` for a non-positive duration."""
    seconds = float(seconds)
    if not seconds > 0:
        raise ValueError(f"seconds must be positive, got {seconds}")
    seconds = min(seconds, MAX_CAPTURE_SECONDS)
    if not _capture_lock.acquire(blocking=False):
        raise ProfileInProgress("a profiler capture is already in progress; retry when it finishes")
    try:
        from unionml_tpu_torch.diagnostics import trace

        if log_dir is None:
            log_dir = tempfile.mkdtemp(prefix="unionml-tpu-torch-profile-")
        t0 = time.perf_counter()
        with trace(log_dir):
            time.sleep(seconds)
        captured_s = time.perf_counter() - t0
        files = []
        for root, _, names in os.walk(log_dir):
            files.extend(os.path.relpath(os.path.join(root, n), log_dir) for n in names)
        return {
            "trace_dir": log_dir,
            "seconds": round(captured_s, 3),
            "file_count": len(files),
            "files": sorted(files)[:50],
        }
    finally:
        _capture_lock.release()


# --------------------------------------------------------------------- #
# device-memory breakdown (GET /debug/memory)
# --------------------------------------------------------------------- #


def device_memory_breakdown(top: int = 10) -> dict:
    """Per-device memory truth: ``torch.cuda.memory_stats()`` of every
    card (none on a CPU-only host) plus a census of the live tensors —
    count, bytes (each storage counted once), per-dtype totals and the
    ``top`` largest (dtype, shape) groups, where a leaked KV cache or a
    forgotten weight tree shows up by name."""
    devices = []
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            devices.append({
                "id": i,
                "platform": "gpu",
                "kind": torch.cuda.get_device_name(i),
                "memory_stats": {str(k): int(v) for k, v in stats.items()
                                 if isinstance(v, (int, float))},
            })
    groups: Dict[Tuple[str, str, Tuple[int, ...]], Dict[str, int]] = {}
    by_dtype: Dict[str, int] = {}
    seen = set()
    total_bytes = count = 0
    for obj in gc.get_objects():
        if not issubclass(type(obj), torch.Tensor):   # type(): no lazy-module __class__ hooks
            continue
        try:
            storage = obj.untyped_storage()
            key = (str(obj.device), storage.data_ptr())
            nbytes = 0 if key in seen else int(storage.nbytes())
        except (RuntimeError, NotImplementedError):
            continue  # meta / exotic tensors: skip, never fail the census
        seen.add(key)
        count += 1
        total_bytes += nbytes
        dtype = str(obj.dtype).removeprefix("torch.")
        by_dtype[dtype] = by_dtype.get(dtype, 0) + nbytes
        group = groups.setdefault((dtype, str(obj.device), tuple(obj.shape)),
                                  {"count": 0, "bytes": 0})
        group["count"] += 1
        group["bytes"] += nbytes
    top_groups = [
        {"dtype": dtype, "device": device, "shape": list(shape), **info}
        for (dtype, device, shape), info in sorted(
            groups.items(), key=lambda kv: kv[1]["bytes"], reverse=True
        )[: max(0, int(top))]
    ]
    return {
        "devices": devices,
        "live_tensors": {"count": count, "bytes": total_bytes, "by_dtype": by_dtype,
                         "top": top_groups},
    }

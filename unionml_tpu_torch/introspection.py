"""Program tracking for the decode engine's device programs.

The port of :class:`unionml_tpu.introspection.ProgramTracker` on the
reference's own branch for a callable that is not an XLA executable
("tracked opaquely (calls only)"): PyTorch runs eagerly, so there is no
compile event to catch and no cost analysis to read. Every wrapped call
records its count into the same ``unionml_program_*`` series the
reference publishes, and its host wall time into
``unionml_program_call_ms``; flops and bytes per call are ``(0, 0)``
and :meth:`ProgramTracker.peaks` reports the peaks as unknown, so the
MFU / roofline gauges read 0 rather than a made-up ratio (giving the
programs analytic costs is not ported yet, ROADMAP.md).

Also here, as in the reference: :func:`capture_profile` (``POST
/debug/profile``, on :mod:`torch.profiler`) and
:func:`device_memory_breakdown` (``GET /debug/memory``, on
``torch.cuda.memory_stats`` and a census of live tensors).
"""

from __future__ import annotations

import gc
import os
import tempfile
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from unionml_tpu_torch import telemetry

__all__ = [
    "MAX_CAPTURE_SECONDS",
    "ProfileInProgress",
    "ProgramTracker",
    "capture_profile",
    "device_memory_breakdown",
]


class _Program:
    """Per-key tracking state (guarded by the tracker lock)."""

    __slots__ = (
        "key", "calls", "compiles", "cum_flops", "cum_bytes",
        "cost_by_sig", "last_cost", "window", "last_t",
        "m_calls", "m_compiles", "m_flops", "m_bytes", "h_compile",
        "h_call",
    )

    def __init__(self, key: str):
        self.key = key
        self.calls = 0
        self.compiles = 0
        self.cum_flops = 0.0
        self.cum_bytes = 0.0
        # signature -> (flops, bytes); stays empty until programs carry
        # analytic costs (every lookup then falls back to (0, 0))
        self.cost_by_sig: Dict[Any, Tuple[float, float]] = {}
        self.last_cost: Tuple[float, float] = (0.0, 0.0)
        self.window: "deque[Tuple[float, float, float]]" = deque(maxlen=256)
        self.last_t = 0.0


class ProgramTracker:
    """Call registry over a component's device programs.

    ``wrap(key, fn, sig_fn=...)`` returns a drop-in callable that counts
    each dispatch under ``key`` and records its host wall time
    (``sig_fn`` names the per-call signature, kept for the cost lookup
    of :meth:`cost`). All series land in the
    shared telemetry registry labeled ``{component, program}``;
    :meth:`stats` is the ``stats()["programs"]`` view.
    """

    WINDOW_S = 60.0

    def __init__(
        self,
        registry: Optional[telemetry.MetricsRegistry] = None,
        component: str = "program",
        window_s: float = WINDOW_S,
    ):
        self._registry = (
            registry if registry is not None else telemetry.get_registry()
        )
        self.component = component
        self.window_s = float(window_s)
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
            "XLA compile events per tracked program (a count above the "
            "expected shape set = recompiles).", labels,
        )
        self._f_flops = R.counter(
            "unionml_program_flops_total",
            "FLOPs dispatched per XLA cost analysis.", labels,
        )
        self._f_bytes = R.counter(
            "unionml_program_bytes_total",
            "HBM bytes accessed per XLA cost analysis.", labels,
        )
        self._f_compile_ms = R.histogram(
            "unionml_program_compile_ms",
            "Wall time of calls that compiled (trace + XLA compile + "
            "first run).", labels,
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
        must be CHEAP (one shape attribute, a static kwarg); ``None``
        declares a single-signature program."""
        prog = self._get(key)

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            prog.h_call.observe((time.perf_counter() - t0) * 1e3)
            sig = None
            if sig_fn is not None:
                try:
                    sig = sig_fn(*args, **kwargs)
                except Exception:
                    sig = None
            self._on_call(prog, sig)
            return out

        wrapper.__wrapped__ = fn
        wrapper.program_key = key
        return wrapper

    def cost(self, key: str, sig: Any = None) -> Tuple[float, float]:
        """Last-known ``(flops, bytes)`` of one dispatch of program
        ``key`` at signature ``sig`` (``(0, 0)`` until programs carry
        analytic costs) — the per-dispatch numerator the usage ledger
        splits across tenants."""
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
        """The peaks the utilization gauges divide by: unknown (the
        programs carry no costs yet), with the device named."""
        with self._lock:
            if self._peaks is None:
                import torch

                on_card = torch.cuda.is_available()
                self._peaks = {
                    "platform": "gpu" if on_card else "cpu",
                    "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                    "peak_flops": None,
                    "peak_bytes_per_s": None,
                    "source": "unknown",
                }
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
        """The ``stats()["programs"]`` view: per program — calls, host
        call-time summary, flops/bytes per call and total, windowed achieved rates, and the
        MFU/roofline ratios — plus a ``device`` entry naming the peaks
        they are measured against."""
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
            summary = prog.h_call.summary()
            if summary:
                entry["call_ms"] = summary
            entry["achieved_flops_per_s"] = round(flops_s, 1)
            entry["achieved_bytes_per_s"] = round(bytes_s, 1)
            entry["mfu"] = round(mfu, 6)
            entry["hbm_utilization"] = round(hbm, 6)
            out[prog.key] = entry
        return out

    def reset(self) -> None:
        """Zero cumulative counters and windows (benchmarks call this
        between phases)."""
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

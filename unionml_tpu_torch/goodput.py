"""Training goodput accounting: step-phase attribution and badput causes.

The port of :mod:`unionml_tpu.goodput`, logic unchanged: every second of
trainer wall time is classified into **compute** (the step doing useful
work) or a named **badput** cause, so the bottleneck is measured, not
guessed.

- :class:`GoodputTracker` — the accountant the trainer loops
  (:func:`unionml_tpu_torch.execution.run_step_trainer`,
  :func:`unionml_tpu_torch.elastic.run_elastic_trainer`) thread their
  phases through. Each :meth:`~GoodputTracker.phase` scope lands its wall
  time in one bucket (:data:`BADPUT_CAUSES`): ``data_wait`` (host input
  starvation in the feed), ``host_to_device`` (the pin and copy enqueue
  of the inline feed), ``compile``, ``checkpoint`` (save/restore stall on
  the loop) and ``preemption`` (elastic restore + replay after a
  preemption). Eager PyTorch compiles nothing, so the port's trainers
  never call :meth:`~GoodputTracker.note_compile_ms` and ``compile``
  stays 0; the hook is kept for a caller that compiles its step.
  Published series: ``unionml_train_goodput_ratio``,
  ``unionml_train_goodput_seconds_total``,
  ``unionml_train_badput_seconds_total{cause}`` and the per-phase
  ``unionml_train_phase_ms{phase}`` histogram. Each phase is also a span
  on a ``kind="trainer"`` timeline of the port's
  :class:`~unionml_tpu_torch.telemetry.TraceRecorder`, rotated onto a
  fresh request every ``timeline_rotate_steps`` steps.
- :class:`StepTimeRegressionDetector` — a rolling-baseline anomaly
  detector over per-step wall times with hysteresis (also run by the
  serving goodput plane, :mod:`unionml_tpu_torch.serving.perf`).
- :class:`StepSkewMonitor` — per-process step skew and straggler math
  over injected timings. :func:`allgather_step_times` gathers every
  rank's step time over ``torch.distributed`` (``None`` in one
  process).

Everything here but the gather (which imports torch when called) is
stdlib-only, thread-safe (the feed and the step loop
may run phases from different threads) and takes an injectable monotonic
``clock`` so the bucket math is testable on a synthetic clock.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from unionml_tpu_torch import telemetry
from unionml_tpu_torch._logging import logger

__all__ = [
    "BADPUT_CAUSES",
    "COMPUTE_PHASE",
    "GoodputTracker",
    "StepSkewMonitor",
    "StepTimeRegressionDetector",
    "allgather_step_times",
    "phase_scope",
]


def phase_scope(tracker: Optional["GoodputTracker"], name: str):
    """Phase scope on ``tracker``, or a no-op when accounting is off —
    the one phase-or-noop helper the trainer loops share, so optional
    instrumentation never re-invents the ``if tracker`` branch at every
    call site."""
    if tracker is None:
        return contextlib.nullcontext()
    return tracker.phase(name)

#: The one good phase: wall time inside the step (minus any compile
#: debit) counts toward goodput.
COMPUTE_PHASE = "compute"

#: The badput taxonomy.
#: Any phase name outside COMPUTE_PHASE + BADPUT_CAUSES is rejected —
#: an unknown bucket would silently leak out of the attribution sum.
BADPUT_CAUSES = (
    "data_wait",        # host input starvation (the stream/loader feed)
    "host_to_device",   # the inline feed's pin and copy enqueue
    "compile",          # compile/recompile (note_compile_ms); 0 in eager PyTorch
    "checkpoint",       # checkpoint save/restore stall on the loop
    "preemption",       # elastic restore + replay after preemption
)


class StepTimeRegressionDetector:
    """Rolling-baseline step-time anomaly detection with hysteresis.

    The baseline is the median of the newest ``window`` *normal* step
    durations (anomalous steps never feed it, so a sustained
    regression cannot absorb itself into the baseline). A step is
    *anomalous* when its duration exceeds ``threshold`` × baseline;
    the detector enters the **regressed** state after ``consecutive``
    anomalous steps in a row and leaves it only after ``consecutive``
    steps below ``clear_threshold`` × baseline — the two thresholds
    are the hysteresis band that keeps a step time oscillating around
    the trip point from flapping the state. The first ``min_steps``
    steps only warm the baseline (never anomalous).

    Pure math — no clocks, no registries — so the hysteresis is
    unit-testable from a list of synthetic durations.
    """

    def __init__(
        self,
        *,
        window: int = 50,
        threshold: float = 1.5,
        clear_threshold: float = 1.2,
        consecutive: int = 3,
        min_steps: int = 10,
    ):
        if threshold <= clear_threshold:
            raise ValueError(
                f"threshold ({threshold}) must exceed clear_threshold "
                f"({clear_threshold}) — equal bands have no hysteresis"
            )
        if window < 2 or consecutive < 1 or min_steps < 1:
            raise ValueError("window >= 2, consecutive >= 1, min_steps >= 1")
        self.window = int(window)
        self.threshold = float(threshold)
        self.clear_threshold = float(clear_threshold)
        self.consecutive = int(consecutive)
        self.min_steps = int(min_steps)
        self._normal: List[float] = []
        self._steps = 0
        self._over = 0
        self._under = 0
        self.regressed = False
        self.anomalies = 0

    def baseline(self) -> Optional[float]:
        """Median of the retained normal durations (None while the
        warmup window is still filling)."""
        if self._steps < self.min_steps or not self._normal:
            return None
        vals = sorted(self._normal)
        return vals[len(vals) // 2]

    def update(self, step_s: float) -> dict:
        """Feed one step duration; returns ``{"ratio", "anomaly",
        "regressed", "entered", "cleared"}`` — ``entered``/``cleared``
        flag the regressed-state *transitions* this update caused."""
        step_s = float(step_s)
        self._steps += 1
        base = self.baseline()
        ratio = (step_s / base) if base else 1.0
        anomaly = base is not None and ratio > self.threshold
        entered = cleared = False
        if anomaly:
            self.anomalies += 1
            self._over += 1
            self._under = 0
            if not self.regressed and self._over >= self.consecutive:
                self.regressed = True
                entered = True
        else:
            self._over = 0
            self._normal.append(step_s)
            if len(self._normal) > self.window:
                del self._normal[: -self.window]
            if self.regressed:
                if base is None or ratio < self.clear_threshold:
                    self._under += 1
                    if self._under >= self.consecutive:
                        self.regressed = False
                        cleared = True
                        self._under = 0
                else:
                    self._under = 0
        return {
            "ratio": ratio,
            "anomaly": anomaly,
            "regressed": self.regressed,
            "entered": entered,
            "cleared": cleared,
        }


class StepSkewMonitor:
    """Per-host step-completion skew + straggler detection (pure math).

    ``observe(step, host_step_s)`` takes every host's step duration
    for one synchronization point (what :func:`allgather_step_times`
    returns on a slice, or a synthetic list in tests) and reports the
    skew — slowest minus median, the time every other host spent
    waiting at the collective — and which hosts ran past
    ``straggler_factor`` × the median AND ``min_skew_ms`` absolute
    margin (the absolute floor keeps µs-scale jitter on a fast step
    from flagging phantom stragglers).
    """

    def __init__(
        self, *, straggler_factor: float = 1.5, min_skew_ms: float = 50.0
    ):
        if straggler_factor <= 1.0:
            raise ValueError("straggler_factor must be > 1.0")
        self.straggler_factor = float(straggler_factor)
        self.min_skew_ms = float(min_skew_ms)

    def observe(self, step: int, host_step_s: Sequence[float]) -> dict:
        times = [float(t) for t in host_step_s]
        if not times:
            raise ValueError("host_step_s must be non-empty")
        ordered = sorted(times)
        # LOWER middle element for even host counts: the upper middle
        # would make a 2-host slice blind (median == slowest ⇒ skew 0
        # and the straggler ratio can never trip); the lower middle
        # keeps "how long did the rest of the slice wait" meaningful
        # down to 2 processes
        median = ordered[(len(ordered) - 1) // 2]
        slowest = max(times)
        skew_ms = (slowest - median) * 1e3
        stragglers = [
            host for host, t in enumerate(times)
            if t > median * self.straggler_factor
            and (t - median) * 1e3 >= self.min_skew_ms
        ]
        return {
            "step": int(step),
            "median_ms": median * 1e3,
            "slowest_ms": slowest * 1e3,
            "skew_ms": skew_ms,
            "stragglers": stragglers,
        }


def allgather_step_times(step_s: float) -> Optional[List[float]]:
    """Every rank's ``step_s`` over the default process group,
    index-aligned with the rank: the multi-process sync point feeding
    :class:`StepSkewMonitor`. Returns ``None`` in one process (no
    collective, no cost) or when the gather fails (a skew sample must never
    take training down)."""
    try:
        import torch
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() <= 1:
            return None
        device = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend() == "nccl" else torch.device("cpu")
        mine = torch.tensor([float(step_s)], dtype=torch.float64, device=device)
        out = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(out, mine)
        return [float(t.item()) for t in out]
    except Exception as exc:
        logger.info(f"step-skew allgather unavailable: {exc!r}")
        return None


class _PhaseScope:
    def __init__(self, tracker: "GoodputTracker", name: str):
        self._tracker = tracker
        self._name = name
        self._t0 = 0.0

    def __enter__(self) -> "_PhaseScope":
        self._t0 = self._tracker._clock()
        return self

    def __exit__(self, *exc) -> None:
        self._tracker._end_phase(self._name, self._t0, self._tracker._clock())


class GoodputTracker:
    """Decomposes trainer wall time into compute vs. badput buckets.

    The trainer loops open :meth:`phase` scopes around every
    classifiable stretch of wall time; :meth:`report` divides the
    accumulated buckets by the :meth:`start` → now wall span. Compile
    time reported *inside* a compute phase (:meth:`note_compile_ms`) is
    debited out of that compute phase into the ``compile`` bucket, so
    goodput never counts a recompile as useful work and the buckets
    still sum to measured wall time. Eager PyTorch compiles nothing:
    the port's trainers never report a compile, and ``compile`` stays
    0.

    ``registry`` / ``tracer`` / ``flight`` default to the
    process-global telemetry instances (one scrape covers serving and
    training); ``clock`` (monotonic seconds) is injectable for
    deterministic tests. All methods are thread-safe — the prefetch
    feed and the step loop may run phases from different threads.
    """

    def __init__(
        self,
        *,
        registry: Optional[telemetry.MetricsRegistry] = None,
        tracer: Optional[telemetry.TraceRecorder] = None,
        flight: Optional[telemetry.FlightRecorder] = None,
        clock: Callable[[], float] = time.perf_counter,
        detector: Optional[StepTimeRegressionDetector] = None,
        skew_monitor: Optional[StepSkewMonitor] = None,
        timeline_rotate_steps: int = 512,
    ):
        self._registry = (
            registry if registry is not None else telemetry.get_registry()
        )
        self._tracer = tracer if tracer is not None else telemetry.get_tracer()
        self._flight = (
            flight if flight is not None else telemetry.get_flight_recorder()
        )
        self._clock = clock
        self.detector = (
            detector if detector is not None else StepTimeRegressionDetector()
        )
        self.skew_monitor = (
            skew_monitor if skew_monitor is not None else StepSkewMonitor()
        )
        # long runs record 3-4 phase spans per step against the trace
        # recorder's per-request span cap: rotate the trainer timeline
        # onto a fresh request every N steps (512 * 4 spans stays well
        # under MAX_SPANS_PER_REQUEST=4096) so a 100k-step run exports
        # its whole history as a chain of requests instead of silently
        # truncating after the first ~1k steps. 0 disables rotation.
        self._timeline_rotate_steps = int(timeline_rotate_steps)
        self._lock = threading.Lock()
        self._buckets: Dict[str, float] = {COMPUTE_PHASE: 0.0}
        for cause in BADPUT_CAUSES:
            self._buckets[cause] = 0.0
        self._pending_compile_s = 0.0
        self._t_start: Optional[float] = None
        self._t_stop: Optional[float] = None
        self._steps = 0
        self._rid: Optional[str] = None
        R = self._registry
        self._g_ratio = R.gauge(
            "unionml_train_goodput_ratio",
            "Compute seconds over trainer wall seconds since start() "
            "(1.0 = every second was step compute).",
        )
        self._c_good = R.counter(
            "unionml_train_goodput_seconds_total",
            "Trainer wall seconds classified as step compute.",
        )
        self._c_bad = R.counter(
            "unionml_train_badput_seconds_total",
            "Trainer wall seconds lost to a named badput cause.",
            ("cause",),
        )
        self._h_phase = R.histogram(
            "unionml_train_phase_ms",
            "Per-occurrence wall time of one trainer phase.",
            ("phase",),
        )
        # hot-path children resolved once: _end_phase runs up to four
        # times per training step and must not pay the family-lock
        # labels() lookup each time
        self._bad_children = {
            cause: self._c_bad.labels(cause) for cause in BADPUT_CAUSES
        }
        self._phase_children = {
            name: self._h_phase.labels(name)
            for name in (COMPUTE_PHASE,) + BADPUT_CAUSES
        }
        self._g_ratio_step = R.gauge(
            "unionml_train_step_time_ratio",
            "Current step time over the rolling-baseline median "
            "(regression detector; 1.0 = at baseline).",
        )
        self._c_anomalies = R.counter(
            "unionml_train_step_anomalies_total",
            "Steps whose wall time exceeded the regression detector's "
            "anomaly threshold.",
        )
        self._g_skew = R.gauge(
            "unionml_train_step_skew_ms",
            "Slowest-host minus median-host step time at the last "
            "multihost skew sample.",
        )
        self._g_host_step = R.gauge(
            "unionml_train_host_step_ms",
            "Per-host step wall time at the last multihost skew sample.",
            ("process",),
        )
        self._c_stragglers = R.counter(
            "unionml_train_stragglers_total",
            "Hosts observed past straggler_factor x the median step "
            "time at a skew sample.",
        )

    @property
    def registry(self) -> telemetry.MetricsRegistry:
        """The registry this tracker publishes into — the trainer loops
        use it so companion instrumentation (the program tracker's
        compile series) lands in the same scrape."""
        return self._registry

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Anchor the wall clock and open the per-run trace timeline.
        Idempotent while running — the trainer calls it
        unconditionally, a caller that pre-started the tracker loses
        nothing. Calling it again after :meth:`finish` RESUMES the
        accounting: the paused gap is excluded from wall time (the
        buckets keep accumulating), so one tracker can span several
        trainer invocations and still report an honest attribution."""
        reopen = False
        with self._lock:
            now = self._clock()
            if self._t_start is None:
                self._t_start = now
                reopen = True
            elif self._t_stop is not None:
                self._t_start += now - self._t_stop
                self._t_stop = None
                reopen = True
        if reopen:
            self._rid = self._tracer.new_request(kind="trainer")

    def finish(self) -> None:
        """Freeze the wall span and finish the trace timeline (the
        spans export through ``/debug/trace`` and OTLP like any
        serving request). :meth:`report` stays readable after."""
        with self._lock:
            if self._t_start is None or self._t_stop is not None:
                return
            self._t_stop = self._clock()
            rid = self._rid
        if rid is not None:
            self._tracer.finish_request(rid)
        self._publish_ratio()

    # -- phases ------------------------------------------------------------

    def phase(self, name: str) -> _PhaseScope:
        """Context manager attributing its wall time to bucket
        ``name`` (``compute`` or one of :data:`BADPUT_CAUSES`)."""
        if name != COMPUTE_PHASE and name not in BADPUT_CAUSES:
            raise ValueError(
                f"unknown phase {name!r}: expected {COMPUTE_PHASE!r} or "
                f"one of {BADPUT_CAUSES}"
            )
        return _PhaseScope(self, name)

    def note_compile_ms(self, key: str, dt_ms: float) -> None:
        """Compile hook (a ``ProgramTracker`` ``on_compile`` callback in
        the reference; the port's eager trainers never call it): ``dt_ms``
        of the call that just compiled becomes a pending debit, moved from the
        enclosing compute phase into the ``compile`` bucket when that
        phase closes."""
        with self._lock:
            self._pending_compile_s += max(0.0, float(dt_ms)) / 1e3
        self._flight.record(
            "train_compile", program=key, compile_ms=round(float(dt_ms), 3)
        )

    def _end_phase(self, name: str, t0: float, t1: float) -> None:
        dt = max(0.0, t1 - t0)
        compile_debit = 0.0
        with self._lock:
            if name == COMPUTE_PHASE and self._pending_compile_s > 0.0:
                compile_debit = min(self._pending_compile_s, dt)
                self._pending_compile_s -= compile_debit
            self._buckets[name] += dt - compile_debit
            if compile_debit:
                self._buckets["compile"] += compile_debit
            steps = self._steps
            rid = self._rid
        self._phase_children[name].observe(dt * 1e3)
        if name == COMPUTE_PHASE:
            if dt - compile_debit:
                self._c_good.inc(dt - compile_debit)
        else:
            self._bad_children[name].inc(dt)
        if compile_debit:
            self._bad_children["compile"].inc(compile_debit)
        if rid is not None:
            self._tracer.record_span(rid, name, t0, t1, step=steps)

    # -- per-step hooks ----------------------------------------------------

    def step_complete(self, step_s: float, *, detect: bool = True) -> dict:
        """Called once per trainer step with its wall duration; feeds
        the regression detector, publishes the ratio gauge, counts
        anomalies, and records regression transitions in the flight
        recorder. Returns the detector verdict.

        ``detect=False`` counts the step (and rotates the timeline)
        but keeps the sample OUT of the regression detector — for
        steps whose timing is known to be non-comparable to the rest,
        e.g. the trainer's window-boundary steps whose wait for the
        card drains a whole window of enqueued device work into one
        sample (every boundary would read as a >1.5x anomaly against an
        enqueue-scale baseline)."""
        rotate_rid = None
        with self._lock:
            self._steps += 1
            step = self._steps
            if (
                self._timeline_rotate_steps > 0
                and self._rid is not None
                and self._t_stop is None
                and step % self._timeline_rotate_steps == 0
            ):
                rotate_rid = self._rid
            if detect:
                # the detector mutates its baseline window unsynchronized
                # — updating it under the tracker lock keeps the
                # documented thread-safety claim true for concurrent
                # step_complete calls
                verdict = self.detector.update(step_s)
            else:
                verdict = {
                    "ratio": 1.0, "anomaly": False,
                    "regressed": self.detector.regressed,
                    "entered": False, "cleared": False,
                }
        if rotate_rid is not None:
            self._tracer.finish_request(rotate_rid)
            new_rid = self._tracer.new_request(kind="trainer")
            with self._lock:
                self._rid = new_rid
        # the ratio gauge refreshes once per step, not on every phase
        # close — the gauge readers (scrapes, the SLO watchdog) sample
        # far slower than the loop's 3-4 phases per step
        self._publish_ratio()
        if detect:
            self._g_ratio_step.set(verdict["ratio"])
        if verdict["anomaly"]:
            self._c_anomalies.inc()
            self._flight.record(
                "step_time_anomaly",
                step=step,
                step_ms=round(step_s * 1e3, 3),
                ratio=round(verdict["ratio"], 3),
            )
        if verdict["entered"] or verdict["cleared"]:
            self._flight.record(
                "step_time_regression",
                step=step,
                state="entered" if verdict["entered"] else "cleared",
                ratio=round(verdict["ratio"], 3),
            )
        return verdict

    def record_step_skew(
        self, step: int, host_step_s: Sequence[float]
    ) -> dict:
        """Publish one multihost skew sample (see
        :class:`StepSkewMonitor`); straggler hosts land in the flight
        recorder so a post-hoc reader can name the slow host."""
        sample = self.skew_monitor.observe(step, host_step_s)
        self._g_skew.set(sample["skew_ms"])
        for host, t in enumerate(host_step_s):
            self._g_host_step.labels(str(host)).set(float(t) * 1e3)
        for host in sample["stragglers"]:
            self._c_stragglers.inc()
            self._flight.record(
                "straggler",
                step=sample["step"],
                process=host,
                host_step_ms=round(float(host_step_s[host]) * 1e3, 3),
                median_ms=round(sample["median_ms"], 3),
            )
        return sample

    # -- reporting ---------------------------------------------------------

    def _wall_s(self) -> float:
        if self._t_start is None:
            return 0.0
        end = self._t_stop if self._t_stop is not None else self._clock()
        return max(0.0, end - self._t_start)

    def _publish_ratio(self) -> None:
        with self._lock:
            wall = self._wall_s()
            compute = self._buckets[COMPUTE_PHASE]
        if wall > 0.0:
            self._g_ratio.set(min(1.0, compute / wall))

    def report(self) -> dict:
        """The attribution summary the bench preset and tests assert
        on: per-bucket seconds, wall seconds since :meth:`start`,
        ``goodput_ratio`` (compute/wall), ``attributed_fraction``
        (all buckets / wall — the ≥95% acceptance bar), and
        ``unattributed_s`` (loop bookkeeping between phases)."""
        with self._lock:
            wall = self._wall_s()
            buckets = dict(self._buckets)
            steps = self._steps
        attributed = sum(buckets.values())
        return {
            "wall_s": wall,
            "steps": steps,
            "buckets_s": {k: round(v, 6) for k, v in buckets.items()},
            "goodput_s": round(buckets[COMPUTE_PHASE], 6),
            "badput_s": {
                cause: round(buckets[cause], 6) for cause in BADPUT_CAUSES
            },
            "goodput_ratio": (
                round(buckets[COMPUTE_PHASE] / wall, 6) if wall else 0.0
            ),
            "attributed_fraction": (
                round(min(1.0, attributed / wall), 6) if wall else 0.0
            ),
            "unattributed_s": round(max(0.0, wall - attributed), 6),
            "anomalies": self.detector.anomalies,
            "regressed": self.detector.regressed,
        }

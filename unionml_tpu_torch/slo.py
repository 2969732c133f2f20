"""SLO watchdog: objectives evaluated as multi-window burn rates.

The PyTorch port of :mod:`unionml_tpu.slo`, unchanged: pure Python over
the port's :mod:`~unionml_tpu_torch.telemetry` registry.

The telemetry layer records what happened; nothing in the system
*judges* it — a TTFT regression or an error burst is visible on a
dashboard but never changes ``GET /health``, so load balancers keep
routing to a replica that is missing its objectives. This module closes
that loop, Google-SRE style (multi-window, multi-burn-rate alerting):

- apps declare **objectives** against the live
  :class:`~unionml_tpu_torch.telemetry.MetricsRegistry` series —
  :class:`LatencyObjective` (a latency percentile bound, e.g. engine
  TTFT p95 ≤ 250 ms, read from a histogram's bucket counts),
  :class:`AvailabilityObjective` (good-fraction ≥ target, e.g. HTTP
  availability ≥ 99.9% from the error/request counters), and
  :class:`GaugeObjective` (a level bound, e.g. decode MFU ≥ 0.2);
- the :class:`SloWatchdog` samples the registry on every
  :meth:`~SloWatchdog.evaluate` (the transports call it from
  ``GET /health`` and ``GET /debug/slo``, so the health-probe cadence
  IS the sampling cadence) and computes each objective's **burn rate**
  — error-budget consumption speed, ``bad_fraction / (1 - target)`` —
  over a **fast** window (default 5 min; catches a cliff) and a
  **slow** window (default 1 h; ignores blips). An objective breaches
  when BOTH windows burn past their thresholds, and clears as soon as
  the fast window runs clean — fast to fire, fast to recover, immune
  to a single slow request;
- breaches publish ``unionml_slo_burn_rate{objective,window}`` /
  ``unionml_slo_breached{objective}`` /
  ``unionml_slo_breaches_total{objective}`` into the registry, surface
  in ``GET /debug/slo``, and flip
  :meth:`~unionml_tpu_torch.serving.http.ServingApp.health` to ``degraded``
  (→ HTTP 503) — so the PR-3 admission/breaker machinery and the load
  balancer react to *objective burn*, not just crash loops
  (docs/observability.md).

Everything here is stdlib-only, thread-safe, and deterministic:
``evaluate(now=...)`` takes an explicit clock so the burn-rate window
math is unit-testable without sleeping.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from unionml_tpu_torch import telemetry

__all__ = [
    "AvailabilityObjective",
    "DEFAULT_FAST_WINDOW_S",
    "DEFAULT_SLOW_WINDOW_S",
    "GaugeObjective",
    "LatencyObjective",
    "SloWatchdog",
]

DEFAULT_FAST_WINDOW_S = 300.0     # 5 min: the page-now window
DEFAULT_SLOW_WINDOW_S = 3600.0    # 1 h: the is-it-sustained window

# Google SRE workbook pairing for a 5m/1h multiwindow alert: the fast
# window must burn hard (14.4x eats a 30-day budget in ~2 days) AND the
# slow window must confirm it is not a blip (6x sustained over an hour)
DEFAULT_FAST_BURN = 14.4
DEFAULT_SLOW_BURN = 6.0


def _match(
    labelnames: Sequence[str],
    values: Sequence[str],
    label_filter: Optional[Dict[str, str]],
) -> bool:
    if not label_filter:
        return True
    pairs = dict(zip(labelnames, values))
    return all(pairs.get(k) == str(v) for k, v in label_filter.items())


class _Objective:
    """Shared declaration shape: a name, burn thresholds, and the
    registry families the watchdog must snapshot for it."""

    kind = "objective"

    def __init__(self, name: str, fast_burn: float, slow_burn: float):
        self.name = str(name)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)

    def metric_names(self) -> Tuple[str, ...]:
        raise NotImplementedError

    def evaluate_window(
        self,
        baseline: Optional[dict],
        samples: List[Tuple[float, dict]],
    ) -> dict:
        """Burn over one window: ``baseline`` is the newest snapshot at
        or before the window start (None when history is younger than
        the window), ``samples`` the in-window snapshots oldest→newest
        (current last). Returns ``{"burn_rate": float, ...detail}``."""
        raise NotImplementedError

    def describe(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "fast_burn_threshold": self.fast_burn,
            "slow_burn_threshold": self.slow_burn,
        }


class LatencyObjective(_Objective):
    """``p(target)`` of ``histogram`` ≤ ``threshold_ms``: at most
    ``1 - target`` of the window's observations may exceed the
    threshold; burn rate is the over-threshold fraction divided by
    that budget.

    The threshold is evaluated against the histogram's bucket bounds
    (observations above the smallest bound ≥ ``threshold_ms`` count as
    bad — pick a threshold on a bucket edge, e.g. from
    :data:`telemetry.DEFAULT_MS_BUCKETS`, for exact accounting).
    ``label_filter`` narrows to matching children (e.g.
    ``{"engine": "engine-0"}``); default sums every child. Windows
    with fewer than ``min_events`` observations burn 0 — no traffic is
    not a breach."""

    kind = "latency"

    def __init__(
        self,
        name: str,
        histogram: str,
        threshold_ms: float,
        *,
        target: float = 0.95,
        label_filter: Optional[Dict[str, str]] = None,
        min_events: int = 1,
        fast_burn: float = DEFAULT_FAST_BURN,
        slow_burn: float = DEFAULT_SLOW_BURN,
    ):
        if not 0.0 < target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {target}")
        super().__init__(name, fast_burn, slow_burn)
        self.histogram = str(histogram)
        self.threshold_ms = float(threshold_ms)
        self.target = float(target)
        self.label_filter = dict(label_filter or {})
        self.min_events = int(min_events)

    def metric_names(self) -> Tuple[str, ...]:
        return (self.histogram,)

    def _totals(self, snap: Optional[dict]) -> Tuple[float, float]:
        """(observations, over-threshold observations) summed over the
        matching children of one snapshot."""
        if snap is None:
            return 0.0, 0.0
        fam = snap.get(self.histogram)
        if fam is None or fam["kind"] != "histogram":
            return 0.0, 0.0
        total = bad = 0.0
        for values, payload in fam["children"].items():
            if not _match(fam["labelnames"], values, self.label_filter):
                continue
            bounds, cum = payload["bounds"], payload["cum_counts"]
            count = cum[-1]
            idx = bisect.bisect_left(bounds, self.threshold_ms)
            good = cum[idx] if idx < len(cum) else count
            total += count
            bad += count - good
        return total, bad

    def evaluate_window(self, baseline, samples):
        cur = samples[-1][1] if samples else baseline
        total0, bad0 = self._totals(baseline if baseline is not None
                                    else (samples[0][1] if samples else None))
        total1, bad1 = self._totals(cur)
        events = max(0.0, total1 - total0)
        bad = max(0.0, bad1 - bad0)
        budget = 1.0 - self.target
        fraction = (bad / events) if events >= self.min_events else 0.0
        return {
            "burn_rate": fraction / budget,
            "events": events,
            "bad_events": bad,
            "bad_fraction": round(fraction, 6),
        }

    def describe(self) -> dict:
        return {
            **super().describe(),
            "histogram": self.histogram,
            "threshold_ms": self.threshold_ms,
            "target": self.target,
            "label_filter": self.label_filter,
        }


class AvailabilityObjective(_Objective):
    """Good-fraction ≥ ``target`` (e.g. 0.999): the window's error rate
    — delta of ``errors`` over delta of ``total`` — divided by the
    ``1 - target`` budget is the burn rate. Counters may live in
    different families with different label schemas
    (``unionml_http_errors_total`` vs ``unionml_http_requests_total``);
    each gets its own optional label filter."""

    kind = "availability"

    def __init__(
        self,
        name: str,
        *,
        total: str,
        errors: str,
        target: float = 0.999,
        total_filter: Optional[Dict[str, str]] = None,
        error_filter: Optional[Dict[str, str]] = None,
        min_events: int = 1,
        fast_burn: float = DEFAULT_FAST_BURN,
        slow_burn: float = DEFAULT_SLOW_BURN,
    ):
        if not 0.0 < target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {target}")
        super().__init__(name, fast_burn, slow_burn)
        self.total = str(total)
        self.errors = str(errors)
        self.target = float(target)
        self.total_filter = dict(total_filter or {})
        self.error_filter = dict(error_filter or {})
        self.min_events = int(min_events)

    def metric_names(self) -> Tuple[str, ...]:
        return (self.total, self.errors)

    @staticmethod
    def _sum(snap: Optional[dict], family: str, label_filter) -> float:
        if snap is None:
            return 0.0
        fam = snap.get(family)
        if fam is None or fam["kind"] == "histogram":
            return 0.0
        return sum(
            payload for values, payload in fam["children"].items()
            if _match(fam["labelnames"], values, label_filter)
        )

    def evaluate_window(self, baseline, samples):
        cur = samples[-1][1] if samples else baseline
        base = baseline if baseline is not None else (
            samples[0][1] if samples else None
        )
        total = max(
            0.0,
            self._sum(cur, self.total, self.total_filter)
            - self._sum(base, self.total, self.total_filter),
        )
        errors = max(
            0.0,
            self._sum(cur, self.errors, self.error_filter)
            - self._sum(base, self.errors, self.error_filter),
        )
        budget = 1.0 - self.target
        fraction = (errors / total) if total >= self.min_events else 0.0
        return {
            "burn_rate": fraction / budget,
            "events": total,
            "bad_events": errors,
            "bad_fraction": round(fraction, 6),
        }

    def describe(self) -> dict:
        return {
            **super().describe(),
            "total": self.total,
            "errors": self.errors,
            "target": self.target,
        }


class GaugeObjective(_Objective):
    """A level bound on a gauge (e.g. ``unionml_program_mfu_ratio``
    with ``{"program": "engine.decode"}`` ≥ 0.2): the window value is
    the MEAN of the sampled gauge across the window, and the burn rate
    is 1.0 while the bound is violated, else 0.0 — so with the default
    thresholds (1.0/1.0) a breach requires the violation to hold
    across BOTH windows. Windows with no samples (or, when
    ``skip_zero`` is set, only zero samples — gauges report 0 before
    their source first resolves) burn 0."""

    kind = "gauge"

    def __init__(
        self,
        name: str,
        gauge: str,
        *,
        min_value: Optional[float] = None,
        max_value: Optional[float] = None,
        label_filter: Optional[Dict[str, str]] = None,
        skip_zero: bool = True,
        fast_burn: float = 1.0,
        slow_burn: float = 1.0,
    ):
        if (min_value is None) == (max_value is None):
            raise ValueError("set exactly one of min_value / max_value")
        super().__init__(name, fast_burn, slow_burn)
        self.gauge = str(gauge)
        self.min_value = min_value
        self.max_value = max_value
        self.label_filter = dict(label_filter or {})
        self.skip_zero = bool(skip_zero)

    def metric_names(self) -> Tuple[str, ...]:
        return (self.gauge,)

    def evaluate_window(self, baseline, samples):
        points: List[float] = []
        for _, snap in samples:
            fam = snap.get(self.gauge)
            if fam is None or fam["kind"] == "histogram":
                continue
            vals = [
                payload for values, payload in fam["children"].items()
                if _match(fam["labelnames"], values, self.label_filter)
            ]
            if vals:
                points.append(sum(vals) / len(vals))
        if self.skip_zero:
            points = [p for p in points if p != 0.0]
        if not points:
            return {"burn_rate": 0.0, "value": None}
        value = sum(points) / len(points)
        violated = (
            (self.min_value is not None and value < self.min_value)
            or (self.max_value is not None and value > self.max_value)
        )
        return {"burn_rate": 1.0 if violated else 0.0,
                "value": round(value, 6)}

    def describe(self) -> dict:
        return {
            **super().describe(),
            "gauge": self.gauge,
            "min_value": self.min_value,
            "max_value": self.max_value,
            "label_filter": self.label_filter,
        }


class SloWatchdog:
    """Evaluates declared objectives over fast/slow burn windows against
    a live registry, publishes the ``unionml_slo_*`` series, and
    answers the ``degraded``-or-not question ``health()`` asks.

    Each :meth:`evaluate` snapshots exactly the metric families the
    objectives reference, appends the sample to a bounded history, and
    computes per-objective burn rates over the **fast** and **slow**
    windows (a window's baseline is the newest sample at or before its
    start, so counter deltas cover the whole window once history is
    deep enough). Evaluation is cheap (one registry read + arithmetic)
    and thread-safe — the transports call it from ``GET /health``, so
    the probe cadence is the sampling cadence; call
    :meth:`start`/:meth:`stop` for a background ticker where probes
    are sparse."""

    def __init__(
        self,
        objectives: Sequence[_Objective] = (),
        *,
        registry: Optional["telemetry.MetricsRegistry"] = None,
        fast_window_s: float = DEFAULT_FAST_WINDOW_S,
        slow_window_s: float = DEFAULT_SLOW_WINDOW_S,
        min_sample_gap_s: float = 0.0,
        max_samples: int = 7200,
    ):
        if fast_window_s <= 0 or slow_window_s <= 0:
            raise ValueError("windows must be positive")
        if slow_window_s < fast_window_s:
            raise ValueError(
                f"slow window {slow_window_s}s shorter than fast "
                f"{fast_window_s}s"
            )
        self.objectives: List[_Objective] = []
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.min_sample_gap_s = float(min_sample_gap_s)
        self.max_samples = int(max_samples)
        self._registry = (
            registry if registry is not None else telemetry.get_registry()
        )
        self._lock = threading.Lock()
        self._history: "deque[Tuple[float, dict]]" = deque()
        self._breached: Dict[str, bool] = {}
        self._last_report: Optional[dict] = None
        self._ticker: Optional[threading.Thread] = None
        self._ticker_stop = threading.Event()
        R = self._registry
        self._g_burn = R.gauge(
            "unionml_slo_burn_rate",
            "Error-budget burn rate per objective and window (1.0 = "
            "burning exactly at budget).",
            ("objective", "window"),
        )
        self._g_breached = R.gauge(
            "unionml_slo_breached",
            "1 while the objective is breached (both windows past "
            "their burn thresholds).",
            ("objective",),
        )
        self._m_breaches = R.counter(
            "unionml_slo_breaches_total",
            "ok -> breached transitions per objective.",
            ("objective",),
        )
        for obj in objectives:
            self.add_objective(obj)

    def add_objective(self, objective: _Objective) -> None:
        if any(o.name == objective.name for o in self.objectives):
            raise ValueError(f"duplicate objective name {objective.name!r}")
        self.objectives.append(objective)
        # the series exist from declaration time, not first breach — a
        # dashboard can alert on absence vs. a healthy 0
        self._g_breached.labels(objective.name).set(0.0)
        for window in ("fast", "slow"):
            self._g_burn.labels(objective.name, window).set(0.0)

    # -- sampling ----------------------------------------------------------

    def _snapshot(self) -> dict:
        """Point-in-time values of every family the objectives read:
        ``{name: {"kind", "labelnames", "children": {values: payload}}}``
        where payload is a float (counter/gauge) or bucket detail
        (histogram)."""
        wanted = set()
        for obj in self.objectives:
            wanted.update(obj.metric_names())
        snap: dict = {}
        for family in self._registry.collect():
            if family.name not in wanted:
                continue
            children: dict = {}
            for values, child in family.children():
                if family.kind == "histogram":
                    buckets = child.buckets()
                    children[values] = {
                        "bounds": [b for b, _ in buckets[:-1]],
                        "cum_counts": [c for _, c in buckets],
                    }
                else:
                    children[values] = float(child.value)
            snap[family.name] = {
                "kind": family.kind,
                "labelnames": family.labelnames,
                "children": children,
            }
        return snap

    def _window(
        self, now: float, window_s: float
    ) -> Tuple[Optional[dict], List[Tuple[float, dict]]]:
        """(baseline snapshot, in-window samples oldest→newest) — call
        with the lock held, after the current sample was appended."""
        start = now - window_s
        baseline = None
        samples: List[Tuple[float, dict]] = []
        for t, snap in self._history:
            if t <= start:
                baseline = snap
            else:
                samples.append((t, snap))
        return baseline, samples

    # -- evaluation --------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> dict:
        """Sample the registry, recompute every objective's fast/slow
        burn rates, publish the ``unionml_slo_*`` series, and return
        the ``GET /debug/slo`` report. ``now`` (monotonic seconds)
        exists for deterministic tests; production passes nothing."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            if (
                self._history
                and self.min_sample_gap_s > 0.0
                and now - self._history[-1][0] < self.min_sample_gap_s
                and self._last_report is not None
            ):
                return self._last_report
            self._history.append((now, self._snapshot()))
            horizon = now - self.slow_window_s
            while len(self._history) > 1 and (
                self._history[1][0] <= horizon
                or len(self._history) > self.max_samples
            ):
                # keep one sample at/before the horizon as the slow
                # window's baseline
                self._history.popleft()
            report_objs = []
            breached_names = []
            for obj in self.objectives:
                windows = {}
                for window, window_s in (
                    ("fast", self.fast_window_s),
                    ("slow", self.slow_window_s),
                ):
                    baseline, samples = self._window(now, window_s)
                    detail = obj.evaluate_window(baseline, samples)
                    detail["window_s"] = window_s
                    detail["burn_rate"] = round(detail["burn_rate"], 4)
                    windows[window] = detail
                    self._g_burn.labels(obj.name, window).set(
                        detail["burn_rate"]
                    )
                breached = (
                    windows["fast"]["burn_rate"] >= obj.fast_burn
                    and windows["slow"]["burn_rate"] >= obj.slow_burn
                )
                was = self._breached.get(obj.name, False)
                if breached and not was:
                    self._m_breaches.labels(obj.name).inc()
                self._breached[obj.name] = breached
                self._g_breached.labels(obj.name).set(1.0 if breached else 0.0)
                if breached:
                    breached_names.append(obj.name)
                report_objs.append({
                    **obj.describe(),
                    "windows": windows,
                    "breached": breached,
                })
            self._last_report = {
                "objectives": report_objs,
                "breached": breached_names,
                "fast_window_s": self.fast_window_s,
                "slow_window_s": self.slow_window_s,
                "samples": len(self._history),
            }
            return self._last_report

    def breached(self) -> List[str]:
        """Objectives breached as of the LAST evaluation (no sampling;
        ``health()`` calls :meth:`evaluate` which refreshes this)."""
        with self._lock:
            return [n for n, b in self._breached.items() if b]

    def health_status(self) -> str:
        """``"degraded"`` while any objective is breached, else
        ``"ok"`` — the contribution ``ServingApp.health`` merges."""
        return "degraded" if self.breached() else "ok"

    def burn_score(self, window: str = "fast") -> float:
        """Max burn rate across objectives over ``window`` (``"fast"``
        or ``"slow"``) as of the LAST evaluation (0.0 before any) — a
        scalar load-shifting signal: the fleet router deprioritizes
        replicas whose objectives are burning budget even before they
        formally breach, so traffic shifts ahead of the page, not
        after it. The autoscaler reads BOTH windows (scale-out needs
        the fast window to burn hard AND the slow window to confirm
        it is sustained — the same multiwindow discipline as paging).
        No sampling happens here; the health-probe cadence (which
        calls :meth:`evaluate`) is the refresh cadence."""
        if window not in ("fast", "slow"):
            raise ValueError(
                f"window must be 'fast' or 'slow', got {window!r}"
            )
        with self._lock:
            if self._last_report is None:
                return 0.0
            return max(
                (
                    obj["windows"][window]["burn_rate"]
                    for obj in self._last_report["objectives"]
                ),
                default=0.0,
            )

    def burn_scores(self) -> Dict[str, float]:
        """``{"fast": ..., "slow": ...}`` — both windows' max burn
        rates in one read (the autoscaler's sustained-burn signal)."""
        return {
            "fast": self.burn_score("fast"),
            "slow": self.burn_score("slow"),
        }

    # -- optional background ticker ---------------------------------------

    def start(self, interval_s: float = 15.0) -> None:
        """Evaluate every ``interval_s`` on a daemon thread — for
        deployments whose health probes are too sparse to double as
        the sampling cadence. Idempotent."""
        if self._ticker is not None and self._ticker.is_alive():
            return
        self._ticker_stop.clear()

        def tick():
            while not self._ticker_stop.wait(interval_s):
                try:
                    self.evaluate()
                except Exception:
                    pass  # a watchdog bug must never take serving down

        self._ticker = threading.Thread(
            target=tick, daemon=True, name="unionml-tpu-slo-watchdog"
        )
        self._ticker.start()

    def stop(self) -> None:
        self._ticker_stop.set()
        if self._ticker is not None:
            self._ticker.join(timeout=2.0)
            self._ticker = None

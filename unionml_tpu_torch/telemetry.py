"""Unified telemetry: metrics registry, Prometheus exposition, trace spans.

The reference has **no observability subsystem** (SURVEY.md §5.1 "Tracing
/ profiling — ABSENT", §5.5 "No Prometheus/OTel"), and this rebuild had
four mutually-incompatible private accounting schemes: the decode
engine's ``_completed`` tuples, the micro-batcher's ``_done`` list,
:class:`~unionml_tpu_torch.diagnostics.StepTimer`, and free-form
``logger.info`` strings. This module is the single spine that replaces
them:

- :class:`MetricsRegistry` — a dependency-free, thread-safe registry of
  **Counter / Gauge / Histogram** families with label sets. Histograms
  use fixed log-spaced ms buckets (:data:`DEFAULT_MS_BUCKETS`) so
  percentile math is mergeable across threads and scrapers, plus a
  bounded raw-sample window so the existing ``stats()`` percentile
  summaries stay exact rather than bucket-approximated.
- ``registry.exposition()`` — Prometheus text exposition format 0.0.4,
  served at ``GET /metrics`` by both HTTP transports
  (:mod:`unionml_tpu_torch.serving.http` and :mod:`unionml_tpu_torch.serving.fastapi`).
- :class:`TraceRecorder` — per-request trace spans on the monotonic
  clock (``queue → prefill → decode-chunk[i] → harvest`` in the decode
  engine), keyed by a generated request id, exportable as Chrome
  trace-event JSON (loads in Perfetto / ``chrome://tracing``) and as
  structured JSON lines. Every request timeline carries a real **W3C
  trace context** (128-bit trace id, 64-bit span ids, parent links):
  the transports parse an inbound ``traceparent`` header
  (:func:`parse_traceparent`), open a :func:`trace_scope` around the
  predictor call, and the recorder picks the ambient context up in
  :meth:`~TraceRecorder.new_request` — so engine/batcher spans join
  the caller's distributed trace, and the OTLP exporter
  (:mod:`unionml_tpu_torch.exporters`) can ship a connected span tree.

- :class:`FlightRecorder` — a bounded ring buffer of per-request
  lifecycle events (submit, prefill, decode chunks, sheds, recoveries)
  the engine and batcher record into; dumped at ``GET /debug/flight``
  and snapshotted into recovery trace spans for postmortems
  (docs/observability.md).
- :func:`percentile_summary` — the shared nearest-rank percentile
  formula every stats surface uses (moved here from
  ``serving._stats``, which re-exports it).
- :func:`publish_process_metrics` — the standard
  ``process_start_time_seconds`` and ``unionml_tpu_torch_build_info`` gauges,
  published into every scraped registry.

Process-global defaults (:func:`get_registry`, :func:`get_tracer`,
:func:`get_flight_recorder`) make independently-constructed components
(an engine built outside the ``ServingApp``, a trainer loop in the same
process) land in the one scrape surface; pass explicit instances for
isolation. Everything here is stdlib-only and safe to import before
torch.
"""

from __future__ import annotations

import bisect
import itertools
import json
import math
import os
import random
import re
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

__all__ = [
    "DEFAULT_MS_BUCKETS",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "TraceContext",
    "TraceRecorder",
    "current_trace_context",
    "format_traceparent",
    "get_flight_recorder",
    "get_registry",
    "get_tracer",
    "instance_label",
    "merge_expositions",
    "new_request_id",
    "new_span_id",
    "new_trace_id",
    "parse_traceparent",
    "SlidingSamples",
    "percentile_summary",
    "publish_process_metrics",
    "server_trace_context",
    "stitched_trace",
    "trace_scope",
    "wall_clock_offset_ms",
]


def percentile_summary(values: Sequence[float]) -> dict:
    """p50/p95/p99/mean/n of a non-empty sample.

    Percentiles use nearest-rank ``ceil(q * n) - 1`` (the formula the
    benchmarks, histogram summaries, StepTimer, and the program
    registry all share through this helper): for small windows
    ``int(q * n)`` indexes the sample MAXIMUM — one cold-compile outlier
    would be reported as the p95 and misdirect tail-latency attribution.
    ``n`` is the sample count, so a consumer can tell a p99 computed
    over 3 requests from one computed over 10k.

    (Moved here from ``unionml_tpu_torch.serving._stats``, which re-exports
    it: non-serving modules — diagnostics, introspection — need it too,
    and telemetry is the layer they all already import.)
    """
    vals = sorted(values)
    n = len(vals)
    return {
        "p50": round(vals[n // 2], 1),
        "p95": round(vals[max(0, math.ceil(0.95 * n) - 1)], 1),
        "p99": round(vals[max(0, math.ceil(0.99 * n) - 1)], 1),
        "mean": round(sum(vals) / n, 1),
        "n": n,
    }


class SlidingSamples:
    """A bounded sliding window of float samples with nearest-rank
    percentile reads — the live-quantile primitive behind adaptive
    decisions (the fleet router's hedge delay tracks the request p95
    through one of these; a Histogram can't serve that read because
    its buckets quantize to the grid and never age out old regimes).

    Thread-safe; O(1) add, O(n log n) percentile (n <= maxlen, read on
    decision paths that already cost a dispatch)."""

    def __init__(self, maxlen: int = 512):
        if maxlen < 1:
            raise ValueError(f"maxlen must be >= 1, got {maxlen}")
        self._samples: "deque[float]" = deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def add(self, value: float) -> None:
        with self._lock:
            self._samples.append(float(value))

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    def percentile(self, q: float, default: float = 0.0) -> float:
        """Nearest-rank q-quantile (``ceil(q*n) - 1``, the repo-wide
        formula — see :func:`percentile_summary`); ``default`` when no
        samples have landed yet."""
        if not 0.0 < q <= 1.0:
            raise ValueError(f"q must be in (0, 1], got {q}")
        with self._lock:
            if not self._samples:
                return default
            vals = sorted(self._samples)
        return vals[max(0, math.ceil(q * len(vals)) - 1)]

    def mean(self, default: float = 0.0) -> float:
        """Window mean (the rolling-average read behind the router's
        weighted least-request latency term); ``default`` when empty."""
        with self._lock:
            if not self._samples:
                return default
            return sum(self._samples) / len(self._samples)


# log-spaced ms buckets (1 / 2.5 / 5 per decade, 100 µs .. 1 min): wide
# enough for a fused decode step (~2 ms) and a cold XLA compile (~20 s)
# in the same family, few enough that per-observation cost is one bisect
DEFAULT_MS_BUCKETS: Tuple[float, ...] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0,
)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

_instance_counters: Dict[str, "itertools.count"] = {}
_instance_lock = threading.Lock()


#: The source of request, trace and span ids: seeded from the OS once (and
#: again in a forked child), then drawn without a system call, so the
#: trainer's per-phase spans cost no syscall between its goodput phases.
_ID_RNG = random.Random()
os.register_at_fork(after_in_child=_ID_RNG.seed)


def _random_hex(bits: int) -> str:
    """``bits`` random bits as lowercase hex, never all zero."""
    return f"{_ID_RNG.getrandbits(bits) or 1:0{bits // 4}x}"


def new_request_id() -> str:
    """A 16-hex-char request id (the ``X-Request-ID`` / trace key)."""
    return _random_hex(64)


def instance_label(prefix: str) -> str:
    """Process-unique label value for one component instance
    (``engine-0``, ``batcher-3``, ...): keeps every instance's series
    separate in the shared registry without unbounded cardinality."""
    with _instance_lock:
        counter = _instance_counters.setdefault(prefix, itertools.count())
        return f"{prefix}-{next(counter)}"


def _escape_label_value(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(value: float) -> str:
    if value != value:  # NaN
        return "NaN"
    if value in (float("inf"), float("-inf")):
        return "+Inf" if value > 0 else "-Inf"
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def _label_pairs(labelnames: Sequence[str], values: Sequence[str]) -> str:
    if not labelnames:
        return ""
    inner = ",".join(
        f'{n}="{_escape_label_value(v)}"' for n, v in zip(labelnames, values)
    )
    return "{" + inner + "}"


class _Child:
    """One labeled series of a family; shares the family lock."""

    def __init__(self, family: "_Family", values: Tuple[str, ...]):
        self._family = family
        self._lock = family._lock
        self._values = values


class Counter(_Child):
    """Monotonic counter. ``reset()`` exists for windowed ``stats()``
    views (benchmarks zero the window between scenarios); Prometheus
    scrapers tolerate resets as counter restarts."""

    def __init__(self, family: "_Family", values: Tuple[str, ...]):
        super().__init__(family, values)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up (inc({amount}))")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Gauge(_Child):
    """Settable value; ``set_function`` registers a callable sampled at
    read time (for values owned elsewhere, e.g. queue depth)."""

    def __init__(self, family: "_Family", values: Tuple[str, ...]):
        super().__init__(family, values)
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._fn = None
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    def set_function(self, fn: Callable[[], float]) -> None:
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:  # sampled outside the lock: user callables may be slow
            return float(fn())
        except Exception:
            return 0.0

    def reset(self) -> None:
        with self._lock:
            self._fn = None
            self._value = 0.0


class Histogram(_Child):
    """Bucketed distribution + a bounded raw-sample window.

    The buckets feed the mergeable Prometheus exposition; the window
    (capped like the accounting lists it replaces: 10k samples, trimmed
    to the newest 5k) feeds :meth:`summary`'s exact percentiles so
    ``stats()`` output keeps its historical meaning.

    Exemplars (Dapper lineage): an ``observe`` call may attach a
    request id, kept in a bounded ring of ``(value, exemplar)`` pairs.
    :meth:`exemplars` returns the largest recent values with their
    ids, which is how ``GET /debug/tail`` links a p99 spike back to
    the exact request (``/debug/trace?rid=``) that caused it. The
    ring is recency-bounded, not value-sorted, so old outliers age
    out and the view stays "slowest *recent* requests".
    """

    WINDOW_CAP = 10_000
    EXEMPLAR_CAP = 64

    def __init__(self, family: "_Family", values: Tuple[str, ...]):
        super().__init__(family, values)
        self._bounds = family._buckets
        self._counts = [0] * (len(self._bounds) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._window: List[float] = []
        self._exemplars: List[Tuple[float, str]] = []

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        value = float(value)
        idx = bisect.bisect_left(self._bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1
            self._window.append(value)
            if len(self._window) > self.WINDOW_CAP:
                del self._window[: self.WINDOW_CAP // 2]
            if exemplar is not None:
                self._exemplars.append((value, str(exemplar)))
                if len(self._exemplars) > self.EXEMPLAR_CAP:
                    del self._exemplars[: self.EXEMPLAR_CAP // 2]

    def exemplars(self, n: int = 5) -> List[Tuple[float, str]]:
        """The ``n`` largest recent ``(value, exemplar)`` pairs,
        slowest first — the per-series tail view behind
        ``GET /debug/tail``."""
        with self._lock:
            pairs = list(self._exemplars)
        pairs.sort(key=lambda p: p[0], reverse=True)
        return pairs[: max(0, int(n))]

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def buckets(self) -> List[Tuple[float, int]]:
        """Cumulative ``(upper_bound, count)`` pairs, ``+Inf`` last."""
        with self._lock:
            counts = list(self._counts)
        out, running = [], 0
        for bound, n in zip(self._bounds + (float("inf"),), counts):
            running += n
            out.append((bound, running))
        return out

    def summary(self) -> dict:
        """Exact ``percentile_summary`` of the retained window (the
        ``stats()`` view); ``{}`` when nothing was observed."""
        with self._lock:
            window = list(self._window)
        if not window:
            return {}
        return percentile_summary(window)

    def samples(self) -> List[float]:
        """The retained raw-sample window (oldest first) — cross-series
        percentile reads (e.g. engine ITL merged over its priority
        children) recompute exact percentiles from these."""
        with self._lock:
            return list(self._window)

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self._bounds) + 1)
            self._sum = 0.0
            self._count = 0
            self._window.clear()
            self._exemplars.clear()


class _Family:
    """A named metric with a fixed label schema and per-labelset children."""

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Tuple[str, ...],
        kind: str,
        child_cls: type,
        buckets: Optional[Tuple[float, ...]] = None,
    ):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for label in labelnames:
            if not _LABEL_RE.match(label) or label.startswith("__"):
                raise ValueError(f"invalid label name {label!r}")
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self.kind = kind
        self._child_cls = child_cls
        self._buckets = buckets
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], Any] = {}
        self._default: Optional[Any] = None
        if not labelnames:
            self._default = self.labels()

    def labels(self, *values: str, **kwargs: str):
        if kwargs:
            if values:
                raise ValueError("pass label values positionally OR by name")
            try:
                values = tuple(str(kwargs[n]) for n in self.labelnames)
            except KeyError as exc:
                raise ValueError(
                    f"{self.name} needs labels {self.labelnames}, got "
                    f"{sorted(kwargs)}"
                ) from exc
            if len(kwargs) != len(self.labelnames):
                raise ValueError(
                    f"{self.name} needs labels {self.labelnames}, got "
                    f"{sorted(kwargs)}"
                )
        else:
            values = tuple(str(v) for v in values)
            if len(values) != len(self.labelnames):
                raise ValueError(
                    f"{self.name} takes {len(self.labelnames)} label "
                    f"value(s) {self.labelnames}, got {len(values)}"
                )
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._child_cls(self, values)
                self._children[values] = child
        return child

    # unlabeled families proxy straight to their single child, so
    # `registry.counter("x", "...").inc()` needs no `.labels()` hop
    def __getattr__(self, attr: str):
        if attr.startswith("_"):  # dunder/private lookups must not recurse
            raise AttributeError(attr)
        default = self.__dict__.get("_default")
        if default is not None:
            return getattr(default, attr)
        raise AttributeError(
            f"{self.name} has labels {self.labelnames} — call .labels(...) "
            f"before .{attr}"
        )

    def children(self) -> List[Tuple[Tuple[str, ...], Any]]:
        with self._lock:
            return list(self._children.items())

    def reset(self) -> None:
        for _, child in self.children():
            child.reset()

    def render(self) -> Iterator[str]:
        yield f"# HELP {self.name} {_escape_help(self.help)}"
        yield f"# TYPE {self.name} {self.kind}"
        for values, child in sorted(self.children()):
            labels = _label_pairs(self.labelnames, values)
            if self.kind == "histogram":
                for bound, cum in child.buckets():
                    le = "+Inf" if math.isinf(bound) else _fmt(bound)
                    pairs = _label_pairs(
                        self.labelnames + ("le",), values + (le,)
                    )
                    yield f"{self.name}_bucket{pairs} {cum}"
                yield f"{self.name}_sum{labels} {_fmt(child.sum)}"
                yield f"{self.name}_count{labels} {child.count}"
            else:
                yield f"{self.name}{labels} {_fmt(child.value)}"


class MetricsRegistry:
    """Thread-safe get-or-create registry of metric families.

    Re-requesting a family with the same name returns the existing one
    (components built at different times share series); a name re-used
    with a different type or label schema raises — silent merging would
    corrupt the exposition.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _get_or_create(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str],
        kind: str,
        child_cls: type,
        buckets: Optional[Tuple[float, ...]] = None,
    ) -> _Family:
        labelnames = tuple(labelnames)
        with self._lock:
            family = self._families.get(name)
            if family is not None:
                if family.kind != kind or family.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name} already registered as {family.kind}"
                        f"{family.labelnames}, requested {kind}{labelnames}"
                    )
                return family
            family = _Family(name, help, labelnames, kind, child_cls, buckets)
            self._families[name] = family
            return family

    def counter(
        self, name: str, help: str = "", labelnames: Sequence[str] = ()
    ) -> _Family:
        return self._get_or_create(name, help, labelnames, "counter", Counter)

    def gauge(
        self, name: str, help: str = "", labelnames: Sequence[str] = ()
    ) -> _Family:
        return self._get_or_create(name, help, labelnames, "gauge", Gauge)

    def histogram(
        self,
        name: str,
        help: str = "",
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_MS_BUCKETS,
    ) -> _Family:
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        family = self._get_or_create(
            name, help, labelnames, "histogram", Histogram, bounds
        )
        if family._buckets != bounds:
            raise ValueError(
                f"metric {name} already registered with buckets "
                f"{family._buckets}, requested {bounds}"
            )
        return family

    def collect(self) -> List[_Family]:
        with self._lock:
            return list(self._families.values())

    def exposition(self) -> str:
        """Prometheus text exposition format 0.0.4 (the ``GET /metrics``
        body; serve with content type :data:`EXPOSITION_CONTENT_TYPE`)."""
        lines: List[str] = []
        for family in sorted(self.collect(), key=lambda f: f.name):
            lines.extend(family.render())
        return "\n".join(lines) + "\n" if lines else ""

    def snapshot(self) -> dict:
        """``{name: {labelset_repr: value_or_histogram_dict}}`` — the
        debug/test view (scrapers should use :meth:`exposition`)."""
        out: dict = {}
        for family in self.collect():
            series = {}
            for values, child in family.children():
                key = ",".join(
                    f"{n}={v}" for n, v in zip(family.labelnames, values)
                )
                if family.kind == "histogram":
                    series[key] = {
                        "count": child.count,
                        "sum": child.sum,
                        "buckets": child.buckets(),
                    }
                else:
                    series[key] = child.value
            out[family.name] = series
        return out

    def reset(self) -> None:
        for family in self.collect():
            family.reset()


EXPOSITION_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


# --------------------------------------------------------------------- #
# metrics federation: exposition parse + merge
# --------------------------------------------------------------------- #

# one exposition sample line: `name{labels} value [timestamp]` or
# `name value` (the subset both our exposition and Prometheus clients
# emit; unparseable lines are dropped rather than corrupting the merge)
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(.+)$"
)
_HELP_RE = re.compile(r"^# HELP ([a-zA-Z_:][a-zA-Z0-9_:]*) ?(.*)$")
_TYPE_RE = re.compile(r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) (\w+)$")
_EXPOSITION_SUFFIXES = ("_bucket", "_sum", "_count")


def _parse_exposition(text: str) -> "List[dict]":
    """Ordered families ``{name, help, type, samples: [(name, labels,
    value)]}`` from one exposition body. Samples are grouped under the
    nearest preceding ``# TYPE``/``# HELP`` family when their name
    matches it (histogram ``_bucket``/``_sum``/``_count`` suffixes
    included); headerless samples open an implicit family."""
    families: List[dict] = []
    by_name: Dict[str, dict] = {}

    def family(name: str) -> dict:
        fam = by_name.get(name)
        if fam is None:
            fam = {"name": name, "help": None, "type": None, "samples": []}
            by_name[name] = fam
            families.append(fam)
        return fam

    current: Optional[dict] = None
    for line in text.splitlines():
        line = line.rstrip()
        if not line:
            continue
        if line.startswith("#"):
            m = _HELP_RE.match(line)
            if m is not None:
                current = family(m.group(1))
                if current["help"] is None:
                    current["help"] = m.group(2)
                continue
            m = _TYPE_RE.match(line)
            if m is not None:
                current = family(m.group(1))
                if current["type"] is None:
                    current["type"] = m.group(2)
                continue
            continue  # other comments dropped
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue  # unparseable line: drop, never corrupt the merge
        name, labels, value = m.groups()
        owner = None
        if current is not None:
            base = current["name"]
            if name == base or (
                name.startswith(base)
                and name[len(base):] in _EXPOSITION_SUFFIXES
            ):
                owner = current
        if owner is None:
            owner = family(name)
        owner["samples"].append((name, labels or "", value))
    return families


def _label_sample(
    sample: "Tuple[str, str, str]", label: str, value: str
) -> str:
    """One sample line with ``label="value"`` injected as the first
    label — unless the sample already carries ``label`` (a federated
    replica that is itself a router keeps its own, more specific,
    replica names)."""
    name, labels, val = sample
    pair = f'{label}="{_escape_label_value(value)}"'
    if labels:
        inner = labels[1:-1]
        if re.search(rf'(^|,){label}="', inner):
            return f"{name}{labels} {val}"
        return f"{name}{{{pair},{inner}}} {val}"
    return f"{name}{{{pair}}} {val}"


def merge_expositions(
    local: str,
    replicas: Dict[str, str],
    label: str = "replica",
) -> str:
    """One fleet-wide Prometheus exposition: ``local`` (the router's
    own registry, untouched) merged with each replica's exposition
    under an injected ``replica="<name>"`` label — the federation body
    the router app serves at ``GET /metrics`` so an operator scrapes
    ONE target for the whole fleet (docs/observability.md "Fleet
    observability").

    Families shared across sources render once (``# HELP``/``# TYPE``
    from the first source that declared them — the text format
    requires a family's samples grouped under one header); the
    ``replica`` label's value set is the router's membership, so its
    cardinality is bounded by the fleet size, never by traffic.
    Replica bodies that fail to parse contribute nothing — a corrupt
    scrape degrades to absent series, never to a broken exposition."""
    merged = _parse_exposition(local)
    by_name = {fam["name"]: fam for fam in merged}
    for replica_name in sorted(replicas):
        text = replicas[replica_name]
        if not text:
            continue
        for fam in _parse_exposition(text):
            target = by_name.get(fam["name"])
            if target is None:
                target = {
                    "name": fam["name"], "help": fam["help"],
                    "type": fam["type"], "samples": [],
                }
                by_name[fam["name"]] = target
                merged.append(target)
            elif target["help"] is None:
                target["help"] = fam["help"]
            if target["type"] is None:
                target["type"] = fam["type"]
            target["samples"].extend(
                (None, None, _label_sample(s, label, replica_name))
                for s in fam["samples"]
            )
    lines: List[str] = []
    for fam in sorted(merged, key=lambda f: f["name"]):
        if not fam["samples"]:
            continue
        if fam["help"] is not None:
            lines.append(f"# HELP {fam['name']} {fam['help']}")
        if fam["type"] is not None:
            lines.append(f"# TYPE {fam['name']} {fam['type']}")
        for sample in fam["samples"]:
            if sample[0] is None:
                lines.append(sample[2])  # pre-rendered replica line
            else:
                name, labels, value = sample
                lines.append(f"{name}{labels} {value}")
    return "\n".join(lines) + "\n" if lines else ""


# --------------------------------------------------------------------- #
# W3C trace context (https://www.w3.org/TR/trace-context/)
# --------------------------------------------------------------------- #

# version 00: `00-<32 hex trace-id>-<16 hex parent-id>-<2 hex flags>`;
# all-zero trace/span ids are invalid per spec and treated as absent
_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


@dataclass(frozen=True)
class TraceContext:
    """One W3C trace-context position: the trace a request belongs to
    (``trace_id``, 32 hex chars) and the span new children should
    parent to (``span_id``, 16 hex chars). ``sampled`` mirrors the
    ``traceparent`` sampled flag (recording here never depends on it;
    it is echoed so downstream samplers see the caller's decision)."""

    trace_id: str
    span_id: str
    sampled: bool = True


def new_trace_id() -> str:
    """A 32-hex-char (128-bit) W3C trace id (never all-zero)."""
    return _random_hex(128)


def new_span_id() -> str:
    """A 16-hex-char (64-bit) W3C span id (never all-zero)."""
    return _random_hex(64)


def parse_traceparent(header: Optional[str]) -> Optional[TraceContext]:
    """Parse a ``traceparent`` header into a :class:`TraceContext`.

    Returns ``None`` for an absent OR malformed header — the transport
    contract is to mint a fresh root in that case, never to 5xx a
    request over its tracing metadata (a broken upstream proxy must not
    take serving down). Rejected per spec: bad shape/hex, version
    ``ff``, all-zero trace or span id. Future versions (``01``+) parse
    leniently as version-00, as the spec requires."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id, flags = m.groups()
    if version == "ff":
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return TraceContext(trace_id, span_id, sampled=bool(int(flags, 16) & 1))


def format_traceparent(ctx: TraceContext) -> str:
    """Render a :class:`TraceContext` as a version-00 ``traceparent``
    header value (what transports echo on responses)."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-{'01' if ctx.sampled else '00'}"


def server_trace_context(raw_header: Optional[str]) -> TraceContext:
    """The context a transport should echo for routes that do not open
    a recorded server timeline (health, metrics, debug): the caller's
    trace id when a valid ``traceparent`` arrived (else a minted root),
    with a fresh span id — enough for the caller to correlate the
    response with its trace."""
    inbound = parse_traceparent(raw_header)
    return TraceContext(
        trace_id=inbound.trace_id if inbound else new_trace_id(),
        span_id=new_span_id(),
        sampled=inbound.sampled if inbound else True,
    )


_trace_tls = threading.local()


@contextmanager
def trace_scope(ctx: Optional[TraceContext]) -> Iterator[None]:
    """Expose ``ctx`` to :meth:`TraceRecorder.new_request` calls made on
    this thread (``None`` is a no-op scope). The transports parse the
    inbound ``traceparent``, open this scope around the predictor call,
    and the engine/batcher timelines created inside it join the
    caller's trace — deadline-scope-style thread-local plumbing, so no
    predictor wrapper has to thread a context kwarg through."""
    prev = getattr(_trace_tls, "ctx", None)
    _trace_tls.ctx = ctx
    try:
        yield
    finally:
        _trace_tls.ctx = prev


def current_trace_context() -> Optional[TraceContext]:
    """The innermost :func:`trace_scope` context on this thread."""
    return getattr(_trace_tls, "ctx", None)


# --------------------------------------------------------------------- #
# trace spans
# --------------------------------------------------------------------- #


class TraceRecorder:
    """Per-request trace spans on the monotonic clock.

    ``new_request()`` issues a generated request id; spans attach to it
    via :meth:`record_span` (explicit start/end, for producer/consumer
    pipelines where one thread dispatches and another harvests) or the
    :meth:`span` context manager. ``finish_request`` moves the request
    to a bounded completed ring (newest ``max_requests`` kept).

    Distributed context: every request timeline carries a W3C trace id,
    a root span id, and (when created inside a :func:`trace_scope`, or
    with an explicit ``trace_ctx``) a parent span id linking it to the
    caller's span — so the exported spans form a connected tree across
    services. Each recorded span gets its own span id, parented to the
    request's root span. A request whose span cap was hit is marked
    ``truncated`` in its meta and counted in
    ``unionml_trace_spans_dropped_total``, so a postmortem reader knows
    the trace is partial rather than silently short.

    Exports:

    - :meth:`export_chrome` — Chrome trace-event JSON (``ph: "X"``
      complete events, µs timestamps), loads in Perfetto and
      ``chrome://tracing``; one virtual thread row per request.
    - :meth:`export_jsonl` — one JSON object per span per line
      (including the trace/span/parent ids), for log shippers.
    - listeners (:meth:`add_listener`) see each finished request once —
      the push seam the OTLP exporter
      (:mod:`unionml_tpu_torch.exporters`) subscribes to.
    """

    MAX_SPANS_PER_REQUEST = 4096
    MAX_EVENTS_PER_REQUEST = 512

    def __init__(
        self,
        max_requests: int = 1024,
        registry: Optional["MetricsRegistry"] = None,
    ):
        self.max_requests = max_requests
        self._lock = threading.Lock()
        self._live: Dict[str, List[dict]] = {}
        self._meta: Dict[str, dict] = {}
        self._done: List[Tuple[str, dict, List[dict]]] = []
        self._tids: Dict[str, int] = {}
        self._next_tid = itertools.count(1)
        # resolved lazily: the process-global recorder is constructed
        # alongside the process-global registry at module init
        self._registry = registry
        self._m_dropped: Optional[Counter] = None
        self._listeners: List[Callable[[str, dict, List[dict]], None]] = []

    def add_listener(
        self, fn: Callable[[str, dict, List[dict]], None]
    ) -> None:
        """Subscribe ``fn(rid, meta, spans)`` to every finished request
        (called outside the recorder lock, exceptions swallowed) — the
        push-export seam."""
        with self._lock:
            self._listeners.append(fn)

    def remove_listener(
        self, fn: Callable[[str, dict, List[dict]], None]
    ) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def _count_dropped(self, n: int = 1) -> None:
        if self._m_dropped is None:
            reg = self._registry if self._registry is not None else get_registry()
            self._m_dropped = reg.counter(
                "unionml_trace_spans_dropped_total",
                "Spans dropped past MAX_SPANS_PER_REQUEST; the affected "
                "request's meta carries truncated=true.",
            )
        self._m_dropped.inc(n)

    def new_request(
        self,
        kind: str = "request",
        trace_ctx: Optional[TraceContext] = None,
        rid: Optional[str] = None,
        **meta: Any,
    ) -> str:
        """Open a request timeline. ``trace_ctx`` (explicit, or the
        ambient :func:`trace_scope` one on this thread) is the PARENT
        context: the timeline joins its trace and its root span parents
        to ``trace_ctx.span_id``; with neither, a fresh root trace is
        minted. ``rid`` keys the timeline under a caller-chosen request
        id (the transports pass their ``X-Request-ID`` so
        ``/debug/trace?rid=`` answers with the id the client actually
        holds); a colliding or absent ``rid`` falls back to a generated
        one — the RETURNED id is authoritative."""
        parent = trace_ctx if trace_ctx is not None else current_trace_context()
        with self._lock:
            if rid is None or rid in self._live or rid in self._tids:
                rid = new_request_id()
            self._live[rid] = []
            self._meta[rid] = {
                "kind": kind,
                "trace_id": parent.trace_id if parent else new_trace_id(),
                "span_id": new_span_id(),
                "parent_span_id": parent.span_id if parent else None,
                # the caller's sampling decision rides along so the
                # response echo carries it back (-00 stays -00)
                "sampled": parent.sampled if parent else True,
                "start_s": time.perf_counter(),
                **meta,
            }
            self._tids[rid] = next(self._next_tid)
        return rid

    def trace_context(self, rid: str) -> Optional[TraceContext]:
        """The (trace id, root span id) position of ``rid`` — what a
        child scope or a response ``traceparent`` echo should carry.
        ``None`` for unknown rids."""
        with self._lock:
            meta = self._meta.get(rid)
            if meta is None:
                for done_rid, done_meta, _ in reversed(self._done):
                    if done_rid == rid:
                        meta = done_meta
                        break
            if meta is None or "trace_id" not in meta:
                return None
            return TraceContext(
                meta["trace_id"], meta["span_id"],
                sampled=meta.get("sampled", True),
            )

    def record_span(
        self,
        rid: str,
        name: str,
        start_s: float,
        end_s: float,
        span_id: Optional[str] = None,
        parent_span_id: Optional[str] = None,
        **args: Any,
    ) -> None:
        """Attach one completed span (``time.perf_counter()`` seconds).
        Unknown/finished rids are ignored — a late harvest for an
        already-exported request must not KeyError the engine. A live
        request past the span cap drops the span, counts it, and flags
        the request ``truncated``.

        ``span_id`` lets a caller PRE-MINT the id (the fleet router
        mints each dispatch attempt's span id before dispatching, so
        the attempt's child context can propagate to the replica while
        the span is still open); ``parent_span_id`` overrides the
        default parent (the request's root span) for nested span
        trees."""
        span = {
            "name": name,
            "start_s": float(start_s),
            "end_s": float(end_s),
            "span_id": span_id if span_id is not None else new_span_id(),
        }
        if parent_span_id is not None:
            span["parent_span_id"] = parent_span_id
        if args:
            span["args"] = args
        with self._lock:
            spans = self._live.get(rid)
            if spans is None:
                return
            if len(spans) >= self.MAX_SPANS_PER_REQUEST:
                meta = self._meta.get(rid)
                if meta is not None:
                    meta["truncated"] = True
                dropped = True
            else:
                spans.append(span)
                dropped = False
        if dropped:
            self._count_dropped()

    def span(self, rid: str, name: str, **args: Any):
        """Context manager measuring one span around its body."""
        return _SpanContext(self, rid, name, args)

    def record_event(
        self, rid: str, name: str, t_s: Optional[float] = None, **args: Any
    ) -> None:
        """Attach one INSTANT event to a live request timeline (the
        OTLP span-event mapping: exported as events on the request's
        synthesized root span, as ``ph: "i"`` instants in the Chrome
        export, and as ``"event": true`` lines in jsonl). The fleet
        router's lifecycle (eject/probe/rejoin) and the autoscaler's
        scale decisions ride the fleet timeline this way, so a latency
        spike is explainable from the trace alone. Unknown rids are
        ignored; a request past the event cap drops the event, counts
        it, and flags the request ``truncated``."""
        event = {
            "name": name,
            "t_s": float(t_s) if t_s is not None else time.perf_counter(),
        }
        if args:
            event["args"] = args
        with self._lock:
            meta = self._meta.get(rid)
            if meta is None or rid not in self._live:
                return
            events = meta.setdefault("events", [])
            if len(events) >= self.MAX_EVENTS_PER_REQUEST:
                meta["truncated"] = True
                dropped = True
            else:
                events.append(event)
                dropped = False
        if dropped:
            self._count_dropped()

    def find_trace_id(self, rid: str) -> Optional[str]:
        """The W3C trace id of a locally-known request id (live or
        completed) — how ``/debug/trace?rid=`` resolves the id a
        client holds into the trace to stitch. ``None`` when
        unknown."""
        with self._lock:
            meta = self._meta.get(rid)
            if meta is None:
                for done_rid, done_meta, _ in reversed(self._done):
                    if done_rid == rid:
                        meta = done_meta
                        break
            if meta is None:
                return None
            return meta.get("trace_id")

    def requests_for_trace(
        self, trace_id: str
    ) -> List[Tuple[str, dict, List[dict]]]:
        """Every retained request (completed AND live) whose timeline
        belongs to ``trace_id`` — the local half of cross-hop trace
        stitching: one transport hop's server timeline, the router's
        routing timeline, and any in-process engine timelines of the
        same trace come back together."""
        return [
            (rid, meta, spans)
            for rid, meta, spans in self._all_requests()
            if meta.get("trace_id") == trace_id
        ]

    def finish_request(self, rid: str) -> None:
        with self._lock:
            spans = self._live.pop(rid, None)
            meta = self._meta.pop(rid, {"kind": "request"})
            if spans is None:
                return
            meta.setdefault("end_s", time.perf_counter())
            self._done.append((rid, meta, spans))
            if len(self._done) > self.max_requests:
                dropped = self._done[: -self.max_requests]
                del self._done[: -self.max_requests]
                for old_rid, _, _ in dropped:
                    self._tids.pop(old_rid, None)
            listeners = list(self._listeners)
        for fn in listeners:  # outside the lock: listeners may be slow
            try:
                fn(rid, meta, list(spans))
            except Exception:
                pass  # an exporter bug must never fail the request path

    def _all_requests(self) -> List[Tuple[str, dict, List[dict]]]:
        with self._lock:
            out = list(self._done)
            out.extend(
                (rid, self._meta.get(rid, {}), list(spans))
                for rid, spans in self._live.items()
            )
            return out

    def export_chrome(self) -> dict:
        """``{"traceEvents": [...], "displayTimeUnit": "ms"}`` — drop
        the JSON in Perfetto / ``chrome://tracing``. Timestamps are µs
        on the process-local monotonic clock (offsets are meaningful,
        absolute values are not)."""
        events: List[dict] = []
        with self._lock:
            tids = dict(self._tids)
        for rid, meta, spans in self._all_requests():
            tid = tids.get(rid, 0)
            for span in spans:
                event = {
                    "name": span["name"],
                    "cat": meta.get("kind", "request"),
                    "ph": "X",
                    "ts": round(span["start_s"] * 1e6, 3),
                    "dur": round((span["end_s"] - span["start_s"]) * 1e6, 3),
                    "pid": 0,
                    "tid": tid,
                    "args": {"request_id": rid, **span.get("args", {})},
                }
                events.append(event)
            for instant in meta.get("events", ()):
                events.append({
                    "name": instant["name"],
                    "cat": meta.get("kind", "request"),
                    "ph": "i",
                    "s": "t",
                    "ts": round(instant["t_s"] * 1e6, 3),
                    "pid": 0,
                    "tid": tid,
                    "args": {"request_id": rid, **instant.get("args", {})},
                })
            events.append({
                "name": "thread_name",
                "ph": "M",
                "pid": 0,
                "tid": tid,
                "args": {"name": f"{meta.get('kind', 'request')} {rid}"},
            })
        events.sort(key=lambda e: e.get("ts", 0.0))
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_jsonl(self) -> str:
        """One span per line: ``{"request_id", "name", "start_ms",
        "duration_ms", "trace_id", "span_id", "parent_span_id", ...}``
        (monotonic-clock ms). The W3C ids let a log pipeline join these
        lines with upstream services' spans: a request's lines share
        ``parent_span_id`` — its root span id, whose own parent (the
        upstream caller's span, when one was propagated) rides along as
        ``request_parent_span_id`` — so the chain
        upstream → request root → span is reconstructible from the
        lines alone. (The root span itself has no line; its timing is
        the min/max of its children, exactly how the OTLP exporter
        synthesizes it.)"""
        lines = []
        for rid, meta, spans in self._all_requests():
            for span in spans:
                record = {
                    "request_id": rid,
                    "kind": meta.get("kind", "request"),
                    "name": span["name"],
                    "start_ms": round(span["start_s"] * 1e3, 3),
                    "duration_ms": round(
                        (span["end_s"] - span["start_s"]) * 1e3, 3
                    ),
                }
                if "trace_id" in meta:
                    record["trace_id"] = meta["trace_id"]
                    record["span_id"] = span.get("span_id")
                    record["parent_span_id"] = (
                        span.get("parent_span_id") or meta["span_id"]
                    )
                    if meta.get("parent_span_id"):
                        record["request_parent_span_id"] = (
                            meta["parent_span_id"]
                        )
                if meta.get("truncated"):
                    record["truncated"] = True
                record.update(span.get("args", {}))
                lines.append(json.dumps(record))
            for instant in meta.get("events", ()):
                record = {
                    "request_id": rid,
                    "kind": meta.get("kind", "request"),
                    "event": True,
                    "name": instant["name"],
                    "t_ms": round(instant["t_s"] * 1e3, 3),
                }
                if "trace_id" in meta:
                    record["trace_id"] = meta["trace_id"]
                    record["span_id"] = meta["span_id"]
                record.update(instant.get("args", {}))
                lines.append(json.dumps(record))
        return "\n".join(lines) + "\n" if lines else ""

    def reset(self) -> None:
        with self._lock:
            self._live.clear()
            self._meta.clear()
            self._done.clear()
            self._tids.clear()


class _SpanContext:
    def __init__(self, recorder: TraceRecorder, rid: str, name: str, args: dict):
        self._recorder = recorder
        self._rid = rid
        self._name = name
        self._args = args
        self._t0 = 0.0

    def __enter__(self) -> "_SpanContext":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._recorder.record_span(
            self._rid, self._name, self._t0, time.perf_counter(), **self._args
        )


def stitched_trace(
    trace_id: Optional[str],
    requests: Sequence[Tuple[str, dict, List[dict]]],
) -> dict:
    """Flatten recorder requests of ONE trace into the stitched
    end-to-end timeline document ``GET /debug/trace?rid=`` serves:

    ``{"trace_id", "request_ids", "spans": [...], "events": [...]}``

    Each request contributes a synthesized root span (named by its
    kind, spanning its children — the same root the OTLP exporter
    ships, so the JSON view and the collector agree) plus its recorded
    spans, every span carrying real W3C ``span_id``/``parent_span_id``
    links: the parent chain caller → transport → router attempt →
    replica server span is reconstructible from one document.

    Timestamps are ``start_unix_ms`` — the monotonic readings anchored
    to THIS process's wall clock at export time — so spans fetched
    from different replicas sort into one timeline at NTP accuracy
    (within one process, offsets keep monotonic-clock exactness).
    """
    # wall anchor (lint: wall clock is fine here — this converts to an
    # epoch timestamp for cross-process alignment, not a duration)
    wall_offset_s = time.time() - time.perf_counter()

    def unix_ms(perf_s: float) -> float:
        return round((perf_s + wall_offset_s) * 1e3, 3)

    spans: List[dict] = []
    events: List[dict] = []
    request_ids: List[str] = []
    for rid, meta, req_spans in requests:
        request_ids.append(rid)
        root_id = meta.get("span_id") or new_span_id()
        start_s = meta.get("start_s")
        end_s = meta.get("end_s")
        if req_spans:
            bounds = [s["start_s"] for s in req_spans]
            start_s = min(bounds + ([start_s] if start_s is not None else []))
            ends = [s["end_s"] for s in req_spans]
            end_s = max(ends + ([end_s] if end_s is not None else []))
        if start_s is None:
            continue  # nothing measurable yet (empty live request)
        if end_s is None:
            end_s = start_s  # live request: zero-length root so far
        root: dict = {
            "request_id": rid,
            "kind": meta.get("kind", "request"),
            "name": str(meta.get("kind", "request")),
            "span_id": root_id,
            "parent_span_id": meta.get("parent_span_id"),
            "root": True,
            "start_unix_ms": unix_ms(start_s),
            "duration_ms": round((end_s - start_s) * 1e3, 3),
        }
        if meta.get("truncated"):
            root["truncated"] = True
        spans.append(root)
        for span in req_spans:
            spans.append({
                "request_id": rid,
                "kind": meta.get("kind", "request"),
                "name": span["name"],
                "span_id": span.get("span_id"),
                "parent_span_id": span.get("parent_span_id") or root_id,
                "start_unix_ms": unix_ms(span["start_s"]),
                "duration_ms": round(
                    (span["end_s"] - span["start_s"]) * 1e3, 3
                ),
                **span.get("args", {}),
            })
        for instant in meta.get("events", ()):
            events.append({
                "request_id": rid,
                "name": instant["name"],
                "span_id": root_id,
                "t_unix_ms": unix_ms(instant["t_s"]),
                **instant.get("args", {}),
            })
    spans.sort(key=lambda s: s["start_unix_ms"])
    events.sort(key=lambda e: e["t_unix_ms"])
    return {
        "trace_id": trace_id,
        "request_ids": request_ids,
        "spans": spans,
        "events": events,
    }


def wall_clock_offset_ms() -> float:
    """Milliseconds to ADD to a monotonic-clock ``t_ms`` reading to
    get epoch milliseconds — the per-host anchor the fleet flight
    merge rebases replica rings with: each host's monotonic epoch is
    its boot time, so raw ``t_ms`` values are incomparable across
    machines (a host up 30 days sorts after a fresh one regardless of
    real time). Wall-anchored times compare at NTP accuracy; within
    one host, offsets between events stay monotonic-exact. (Lint: the
    wall clock is fine here — this is epoch anchoring, not a
    duration.)"""
    return (time.time() - time.monotonic()) * 1e3


# --------------------------------------------------------------------- #
# flight recorder
# --------------------------------------------------------------------- #


class FlightRecorder:
    """Bounded ring buffer of per-request lifecycle events — the
    postmortem record behind ``GET /debug/flight``.

    The engine and batcher :meth:`record` structured events (submit,
    prefill, decode chunks, sheds with their cause, recoveries) as they
    happen; appends are O(1) on a preallocated deque under one lock, so
    the recorder is safe on the dispatcher/harvester hot paths. When a
    recovery fires, the events for the poisoned requests are
    :meth:`snapshot`-ted into the recovery trace span, so a production
    429/504/recovery is explainable after the fact.

    Timestamps are monotonic-clock ms (offsets meaningful, absolutes
    not) — the same clock every other telemetry surface uses.
    """

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._events: "deque[dict]" = deque(maxlen=capacity)
        self._seq = 0

    def record(self, kind: str, **fields: Any) -> None:
        """Append one event (O(1)); ``fields`` must be JSON-safe."""
        with self._lock:
            self._seq += 1
            self._events.append({
                "seq": self._seq,
                "t_ms": round(time.monotonic() * 1e3, 3),
                "kind": kind,
                **fields,
            })

    def dump(
        self,
        n: Optional[int] = None,
        kind: Optional[str] = None,
        rid: Optional[str] = None,
        tenant: Optional[str] = None,
        phase: Optional[str] = None,
    ) -> List[dict]:
        """The newest ``n`` retained events (all when ``None``), oldest
        first; optionally filtered by ``kind``, request id, tenant tag
        (engines/batchers stamp request lifecycle events with the
        submitting tenant — the ``/debug/flight?tenant=`` postmortem
        filter), and/or serving ``phase`` tag (phase-split engines
        stamp their pool — prefill/decode — on every lifecycle event,
        and the router's ``handoff`` events carry both legs')."""
        with self._lock:
            events = list(self._events)
        if kind is not None:
            events = [e for e in events if e["kind"] == kind]
        if rid is not None:
            events = [
                e for e in events
                if e.get("rid") == rid or rid in e.get("rids", ())
            ]
        if tenant is not None:
            events = [e for e in events if e.get("tenant") == tenant]
        if phase is not None:
            events = [
                e for e in events
                if e.get("phase") == phase
                or phase in e.get("phases", ())
            ]
        if n is not None:
            n = int(n)
            events = events[-n:] if n > 0 else []
        return events

    def snapshot(self, rids: Sequence[str], limit: int = 100) -> List[dict]:
        """Events belonging to ``rids`` (newest ``limit``), for
        attaching to a recovery trace span."""
        wanted = set(rids)
        with self._lock:
            events = list(self._events)
        hits = [
            e for e in events
            if e.get("rid") in wanted or wanted & set(e.get("rids", ()))
        ]
        limit = int(limit)
        return hits[-limit:] if limit > 0 else []

    @property
    def total_recorded(self) -> int:
        with self._lock:
            return self._seq

    def stats(self) -> dict:
        with self._lock:
            retained = len(self._events)
            total = self._seq
        return {
            "capacity": self.capacity,
            "retained": retained,
            "total_recorded": total,
            "dropped": total - retained,
        }

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._seq = 0


# --------------------------------------------------------------------- #
# process-level gauges (standard Prometheus conventions)
# --------------------------------------------------------------------- #


def _process_start_time_s() -> float:
    """Epoch seconds this process started: /proc arithmetic on Linux
    (field 22 of /proc/self/stat is start-after-boot in clock ticks;
    btime in /proc/stat is boot epoch), falling back to this module's
    import time — close enough, telemetry imports early."""
    try:
        with open("/proc/self/stat") as f:
            # comm (field 2) may contain spaces/parens: split after it
            stat = f.read().rsplit(")", 1)[1].split()
        ticks = float(stat[19])  # field 22 overall; 20th after comm
        with open("/proc/stat") as f:
            btime = next(
                float(line.split()[1])
                for line in f
                if line.startswith("btime ")
            )
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except Exception:
        return _IMPORT_WALL_S


_IMPORT_WALL_S = time.time()

# one published build-info labelset per registry: a late torch import
# must not leave a second, stale child in the scrape
_build_info_published: Dict[int, Tuple[Tuple[str, ...], Any]] = {}
_build_info_lock = threading.Lock()


def publish_process_metrics(registry: Optional[MetricsRegistry] = None) -> None:
    """Register the standard process-level gauges on ``registry``
    (default: the process-global one): ``process_start_time_seconds``
    and ``unionml_tpu_torch_build_info{version, torch_version, device}``
    = 1.

    Called by ``ServingApp.metrics_text()`` before every exposition, so
    any scraped registry carries them; label values resolve WITHOUT
    importing torch (``device="unloaded"`` until something else loads
    it — this module must stay safe to import before torch), and a later
    resolution replaces the earlier child rather than leaving two.
    ``device`` is the name of CUDA device 0, or ``cpu`` when torch sees
    no CUDA device."""
    reg = registry if registry is not None else _REGISTRY
    reg.gauge(
        "process_start_time_seconds",
        "Start time of the process since unix epoch in seconds.",
    ).set(_process_start_time_s())
    try:
        from unionml_tpu_torch import __version__ as version
    except Exception:
        version = "unknown"
    torch_version, device = "unloaded", "unloaded"
    torch_mod = sys.modules.get("torch")
    if torch_mod is not None:
        torch_version = str(getattr(torch_mod, "__version__", "unknown"))
        try:
            device = (
                str(torch_mod.cuda.get_device_name(0))
                if torch_mod.cuda.is_available() else "cpu"
            )
        except Exception:
            device = "unknown"
    labels = (str(version), torch_version, device)
    family = reg.gauge(
        "unionml_tpu_torch_build_info",
        "Build/runtime identity; value is always 1. Labels carry the "
        "package version, torch version, and CUDA device.",
        ("version", "torch_version", "device"),
    )
    with _build_info_lock:
        prev = _build_info_published.get(id(reg))
        if prev is not None and prev[0] != labels:
            prev[1].set(0.0)  # supersede the pre-torch "unloaded" child
        child = family.labels(*labels)
        child.set(1.0)
        _build_info_published[id(reg)] = (labels, child)


# --------------------------------------------------------------------- #
# process-global defaults
# --------------------------------------------------------------------- #

_REGISTRY = MetricsRegistry()
_TRACER = TraceRecorder()
_FLIGHT = FlightRecorder()


def get_registry() -> MetricsRegistry:
    """The process-global default registry (what ``GET /metrics`` serves
    unless a component was built with an explicit one)."""
    return _REGISTRY


def get_tracer() -> TraceRecorder:
    """The process-global default trace recorder."""
    return _TRACER


def get_flight_recorder() -> FlightRecorder:
    """The process-global default flight recorder (what
    ``GET /debug/flight`` serves, and where engines/batchers record by
    default)."""
    return _FLIGHT


# the default registry always carries the process gauge, even for
# consumers that call exposition() directly without a ServingApp
publish_process_metrics(_REGISTRY)

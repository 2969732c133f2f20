"""Step-time regression detection (the part of the reference's goodput
module the serving tier needs).

The port of :class:`unionml_tpu.goodput.StepTimeRegressionDetector`,
logic unchanged: the serving goodput plane
(:mod:`unionml_tpu_torch.serving.perf`) runs one detector per watched
signal. The reference's training accountant (``GoodputTracker``,
``StepSkewMonitor`` and the multi-host step-time gather) belongs to the
training path and is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import List, Optional

__all__ = ["StepTimeRegressionDetector"]


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

"""Step timing and profiler traces for the trainer.

The port of the parts of :mod:`unionml_tpu.diagnostics` that
:func:`~unionml_tpu_torch.execution.run_step_trainer` uses:
:class:`StepTimer` (windowed samples/sec; the caller makes a window honest
by waiting for the step's device work before the tick that closes it) and
:func:`trace`, which maps ``jax.profiler.trace`` to :mod:`torch.profiler`
(CPU and, with a card, CUDA activity) and writes a Chrome trace into the
log directory.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Any, Dict, Iterator, Optional

import torch

from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.telemetry import percentile_summary


class StepTimer:
    """Windowed samples/sec meter for a training loop: ``tick(examples)``
    once per step; every ``window`` steps a rate is recorded;
    :meth:`summary` reports the median."""

    def __init__(self, window: int = 50):
        self.window = window
        self._t0: Optional[float] = None
        self._steps = 0
        self._examples = 0
        self.rates: list = []
        self.total_steps = 0
        self.total_examples = 0

    def closes_window(self) -> bool:
        """True when the NEXT tick ends a window: wait for the current
        step's device work before that tick."""
        return self._steps + 1 >= self.window

    def tick(self, batch_examples: int) -> None:
        now = time.perf_counter()
        self.total_steps += 1
        self.total_examples += batch_examples
        if self._t0 is None:
            # the first tick only anchors the clock
            self._t0 = now
            return
        self._steps += 1
        self._examples += batch_examples
        if self._steps >= self.window:
            dt = now - self._t0
            if dt > 0:
                self.rates.append(self._examples / dt)
            self._t0 = now
            self._steps = 0
            self._examples = 0

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "steps": float(self.total_steps),
            "examples": float(self.total_examples),
        }
        if self.rates:
            s = percentile_summary(self.rates)
            out["samples_per_sec_median"] = float(s["p50"])
            out["samples_per_sec_last"] = float(self.rates[-1])
            out["samples_per_sec"] = s
        return out


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the body with :mod:`torch.profiler` (CUDA activity too when
    a card is present) and write ``trace.json`` (Chrome trace format) into
    ``log_dir``. Only profiler start/stop failures are logged and
    swallowed; exceptions from the body propagate."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = None
    try:
        prof = profile(activities=activities)
        prof.__enter__()
    except RuntimeError as e:
        logger.info(f"profiler unavailable ({e}); continuing without trace")
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                Path(log_dir).mkdir(parents=True, exist_ok=True)
                prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
                logger.info(f"profiler trace written to {log_dir}")
            except RuntimeError as e:
                logger.info(f"profiler trace failed ({e})")

"""Step timing, profiler traces and the numerical sanitizers.

The port of :mod:`unionml_tpu.diagnostics`:

- :class:`StepTimer` — windowed samples/sec (the caller makes a window
  honest by waiting for the step's device work before the tick that
  closes it).
- :func:`trace` — ``jax.profiler.trace`` mapped to :mod:`torch.profiler`
  (CPU and, with a card, CUDA activity), a Chrome trace written into the
  log directory.
- :func:`nan_guard` — ``jax_debug_nans`` for the port: inside the scope
  the first op that makes a NaN raises ``FloatingPointError``, naming a
  kernel row and its C entry (``row 2, fused_norm.norm_fwd``) or an aten
  op (``aten.mul.Tensor``).
- :func:`assert_finite` — a tree's first non-finite floating leaf, named
  by the reference's ``keystr`` path.
- :func:`describe_sharding` / :func:`assert_sharding` — the realized
  placements of a tree's DTensors as :class:`~unionml_tpu_torch.parallel
  .sharding.PartitionSpec` s, and a check against expected ones.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.ops import _build
from unionml_tpu_torch.parallel.compat import is_dtensor
from unionml_tpu_torch.parallel.sharding import placed_spec
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


@contextlib.contextmanager
def nan_guard(enable: bool = True) -> Iterator[None]:
    """Raise ``FloatingPointError("invalid value (nan) encountered in
    <where>")`` at the first op that makes a NaN inside the scope, as
    ``jax_debug_nans`` does (NaN only: an inf passes, as there).

    Process-wide, as the JAX config is: the engine's dispatcher and
    harvester, the batcher's worker, the threaded feed and autograd's
    workers check under a guard entered on any thread, so the error
    reaches the caller (``DecodeEngine.generate`` raises it). Each kernel
    row is one unit, checked where it returns and named with its C entry;
    the aten ops outside the rows are checked one by one (every check
    reads the value back, so the guard is for repro runs). A captured
    predictor (``predictor(jit=True)``) checks each replay's outputs and
    on a NaN re-runs the call eagerly to name its origin. Unlike the
    reference, the guard also reaches programs made before it was entered
    (ROADMAP.md C15). ``enable=False`` is a no-op; scopes nest and restore
    the previous state."""
    if not enable:
        yield
        return
    prev = _build.NAN_GUARD
    _build.NAN_GUARD = True
    try:
        with _build.nan_scope():
            yield
    finally:
        _build.NAN_GUARD = prev


def _leaf_paths(tree: Any, path: str = ""):
    """``(keystr path, leaf)`` in ``jax.tree_util`` order: dict keys
    sorted (``['block_0']``), sequence indices (``[0]``), NamedTuple and
    train-state fields (``.params``); ``None`` is no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        try:
            keys = sorted(tree)
        except TypeError:
            keys = list(tree)
        for k in keys:
            yield from _leaf_paths(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaf_paths(getattr(tree, name), f"{path}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaf_paths(x, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and hasattr(tree, "state_dict"):
        for name, x in tree.state_dict().items():
            yield from _leaf_paths(x, f"{path}.{name}")
    else:
        yield path, tree


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def assert_finite(tree: Any, *, name: str = "pytree") -> None:
    """Raise ``FloatingPointError`` naming the first non-finite floating
    leaf (NaN or inf), in the reference's words. Integer and bool leaves
    (int8 and packed int4 weights among them) are skipped. A tensor is
    reduced on its device, one readback a leaf, and only the failing leaf
    is counted; a DTensor is reduced over the whole tensor (every rank
    calls it)."""
    for path, leaf in _leaf_paths(tree):
        if isinstance(leaf, torch.Tensor):
            if not leaf.is_floating_point():
                continue
            finite = torch.isfinite(leaf).all()
            if is_dtensor(finite):
                finite = finite.full_tensor()
            if bool(finite):
                continue
            bad = (~torch.isfinite(leaf)).sum()
            if is_dtensor(bad):
                bad = bad.full_tensor()
            shape, dtype = tuple(leaf.shape), _dtype_name(leaf.dtype)
        else:
            arr = np.asarray(leaf)
            if not np.issubdtype(arr.dtype, np.floating) or np.all(np.isfinite(arr)):
                continue
            bad = np.size(arr) - np.sum(np.isfinite(arr))
            shape, dtype = arr.shape, arr.dtype
        raise FloatingPointError(
            f"{name}{path} has {int(bad)} non-finite value(s) "
            f"(shape {shape}, dtype {dtype})"
        )


def realized_spec(leaf: Any) -> Any:
    """A DTensor's :class:`~unionml_tpu_torch.parallel.sharding.PartitionSpec`:
    the one it was placed by (``shard_pytree``, ``NamedSharding``), else
    the spec its placements give, one entry a dimension; ``None`` for
    anything else (a plain tensor is on one device, as the reference's
    single-device arrays have no spec)."""
    return placed_spec(leaf) if is_dtensor(leaf) else None


def describe_sharding(tree: Any) -> Dict[str, str]:
    """Map each leaf path to its placement: a DTensor's mesh and spec, a
    plain tensor's device, ``"<host>"`` for anything else."""
    out: Dict[str, str] = {}
    for path, leaf in _leaf_paths(tree):
        if is_dtensor(leaf):
            mesh = leaf.device_mesh
            axes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
            out[path] = f"NamedSharding(mesh={axes}, spec={realized_spec(leaf)!r})"
        elif isinstance(leaf, torch.Tensor):
            out[path] = f"SingleDeviceSharding(device={leaf.device})"
        else:
            out[path] = "<host>"
    return out


def assert_sharding(tree: Any, expected: Dict[str, Any], *, name: str = "pytree") -> None:
    """Assert the realized leaf specs match ``expected``, which maps leaf
    path substrings to a :class:`~unionml_tpu_torch.parallel.sharding
    .PartitionSpec` (compared as the reference compares them:
    ``P("data", None) != P("data")``) or to a callable ``spec -> bool``.
    Raises ``AssertionError`` on a mismatch and on a pattern no leaf
    matched."""
    checked = set()
    for path, leaf in _leaf_paths(tree):
        for pattern, want in expected.items():
            if pattern in path:
                checked.add(pattern)
                spec = realized_spec(leaf)
                ok = want(spec) if callable(want) else spec == want
                if not ok:
                    raise AssertionError(
                        f"{name}{path}: realized sharding spec {spec!r} != "
                        f"expected {want!r}"
                    )
    missing = set(expected) - checked
    if missing:
        raise AssertionError(
            f"{name}: no leaves matched expected sharding pattern(s) {sorted(missing)}"
        )

"""The port's goodput accountant against the JAX package on the CPU.

The same calls on a fake clock give the reference ``GoodputTracker``'s
``report()`` key by key, the same flight events and timeline spans
(rotation included); ``StepSkewMonitor`` gives the same outputs; the
exposition lists the reference's families. Then ``run_step_trainer(
goodput=...)`` in both feeds, a raising stream, and a thread stress test.
"""

import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from unionml_tpu import goodput as jgoodput
from unionml_tpu import telemetry as jtelemetry

from unionml_tpu_torch import goodput, telemetry
from unionml_tpu_torch.execution import run_step_trainer

import torch_threads

torch_threads.share_cores()


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self) -> float:
        return self.now

    def advance(self, s: float) -> None:
        self.now += s


def _pair(**kwargs):
    """A port tracker and a reference tracker, each on its own fake clock,
    registry, tracer and flight recorder."""
    out = []
    for mod, tel in ((goodput, telemetry), (jgoodput, jtelemetry)):
        clock = FakeClock()
        reg = tel.MetricsRegistry()
        extra = dict(kwargs)
        if "detector" in extra:
            extra["detector"] = mod.StepTimeRegressionDetector(**extra["detector"])
        tracker = mod.GoodputTracker(registry=reg, tracer=tel.TraceRecorder(registry=reg),
                                     flight=tel.FlightRecorder(), clock=clock, **extra)
        out.append((tracker, clock, reg))
    return out


def _script(tracker, clock):
    """One run of calls: phases of every kind, compile debits, regression
    transitions, a skew sample, a pause and a resume."""
    tracker.start()
    for i in range(9):
        with tracker.phase("data_wait"):
            clock.advance(0.01 * (i % 3))
        with tracker.phase("host_to_device"):
            clock.advance(0.002)
        if i == 4:
            tracker.note_compile_ms("trainer.step", 30.0)
        with tracker.phase("compute"):
            clock.advance(0.1 if i < 5 else 0.5)
        if i in (3, 7):
            with tracker.phase("checkpoint"):
                clock.advance(0.2)
        clock.advance(0.003)
        tracker.step_complete(0.1 if i < 5 else 0.5, detect=i != 6)
    tracker.record_step_skew(9, [0.1, 0.1, 0.4, 0.1])
    tracker.finish()
    clock.advance(5.0)   # a pause: excluded from the wall
    tracker.start()
    with tracker.phase("preemption"):
        clock.advance(0.3)
    tracker.finish()
    return tracker.report()


def test_report_matches_the_reference_on_a_fake_clock():
    (t, tc, treg), (j, jc, jreg) = _pair(
        detector=dict(window=10, threshold=1.5, clear_threshold=1.2, consecutive=2,
                      min_steps=2),
        timeline_rotate_steps=4,
    )
    ours, ref = _script(t, tc), _script(j, jc)
    assert set(ours) == set(ref)
    for key in ref:
        assert ours[key] == pytest.approx(ref[key]), key
    assert ours["anomalies"] > 0 and ours["badput_s"]["compile"] == pytest.approx(0.03)
    assert ours["attributed_fraction"] < 1.0   # the loop's bookkeeping is unattributed
    # the same flight events, field by field
    strip = lambda events: [{k: v for k, v in e.items() if k != "t_ms"}
                            for e in events]
    assert strip(t._flight.dump()) == strip(j._flight.dump())
    # the same timelines: rotated requests and their spans
    def timelines(tracer):
        return [[(s["name"], s["start_s"], s["end_s"], s.get("args")) for s in spans]
                for _, meta, spans in tracer._all_requests() if meta.get("kind") == "trainer"]
    assert timelines(t._tracer) == timelines(j._tracer)
    assert len(timelines(t._tracer)) == 4   # steps 4 and 8 rotate; the resume opens one


def test_exposition_lists_the_reference_families():
    (t, tc, treg), (j, jc, jreg) = _pair()
    _script(t, tc), _script(j, jc)

    def families(text):
        return sorted(line.split()[2] for line in text.splitlines()
                      if line.startswith("# TYPE"))

    ours, ref = families(treg.exposition()), families(jreg.exposition())
    assert ours == ref
    for name in ("unionml_train_goodput_ratio", "unionml_train_goodput_seconds_total",
                 "unionml_train_badput_seconds_total", "unionml_train_phase_ms",
                 "unionml_train_step_time_ratio", "unionml_train_step_anomalies_total",
                 "unionml_train_step_skew_ms", "unionml_train_host_step_ms",
                 "unionml_train_stragglers_total"):
        assert name in ours
    ts, js = treg.snapshot(), jreg.snapshot()
    for family in ("unionml_train_badput_seconds_total", "unionml_train_goodput_seconds_total",
                   "unionml_train_goodput_ratio", "unionml_train_host_step_ms"):
        assert ts[family] == pytest.approx(js[family]), family


def test_taxonomy_and_unknown_phase():
    assert goodput.BADPUT_CAUSES == jgoodput.BADPUT_CAUSES
    assert goodput.COMPUTE_PHASE == jgoodput.COMPUTE_PHASE
    (t, _, _), _ = _pair()
    with pytest.raises(ValueError, match="unknown phase"):
        t.phase("coffee_break")
    assert goodput.allgather_step_times(0.5) is None   # one process: no collective


@pytest.mark.parametrize("hosts", [
    [1.0], [1.0, 3.0], [1.0, 1.0, 3.0, 1.0], [0.10, 0.11, 0.12], [2.0, 0.5, 0.5, 0.5, 0.52],
])
@pytest.mark.parametrize("factor,floor", [(1.5, 50.0), (1.2, 0.0)])
def test_skew_monitor_matches_the_reference(hosts, factor, floor):
    ours = goodput.StepSkewMonitor(straggler_factor=factor, min_skew_ms=floor)
    ref = jgoodput.StepSkewMonitor(straggler_factor=factor, min_skew_ms=floor)
    assert ours.observe(7, hosts) == pytest.approx(ref.observe(7, hosts))
    with pytest.raises(ValueError):
        ours.observe(1, [])
    with pytest.raises(ValueError):
        goodput.StepSkewMonitor(straggler_factor=1.0)


def test_tracker_counts_every_phase_under_thread_contention():
    """16 threads (more than the cores) close phases and steps on one
    tracker with a short switch interval: no update is lost."""
    reg = telemetry.MetricsRegistry()
    tracker = goodput.GoodputTracker(registry=reg, tracer=telemetry.TraceRecorder(registry=reg),
                                     flight=telemetry.FlightRecorder(), timeline_rotate_steps=7)
    tracker.start()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(200):
                with tracker.phase("compute"):
                    pass
                tracker.step_complete(0.001)

        threads = [threading.Thread(target=work) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    tracker.finish()
    assert tracker.report()["steps"] == 16 * 200
    assert reg.snapshot()["unionml_train_phase_ms"]["phase=compute"]["count"] == 16 * 200


# --------------------------------------------------------------------- #
# the trainer
# --------------------------------------------------------------------- #


def _linear_problem():
    def step(state, batch):
        x, y = batch
        err = x @ state["w"] - y
        return {"w": state["w"] - 0.01 * x.T @ err}, {"loss": (err ** 2).mean()}

    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    y = rng.normal(size=(64,)).astype(np.float32)
    return step, {"w": torch.zeros(4)}, x, y


@pytest.mark.parametrize("double_buffer", [False, True])
def test_run_step_trainer_goodput_integration(double_buffer):
    step, state, x, y = _linear_problem()
    reg = telemetry.MetricsRegistry()
    tracer = telemetry.TraceRecorder(registry=reg)
    tracker = goodput.GoodputTracker(registry=reg, tracer=tracer,
                                     flight=telemetry.FlightRecorder())
    out = run_step_trainer(step_fn=step, state=state, features=x, targets=y, num_epochs=2,
                           batch_size=16, registry=reg, goodput=tracker,
                           double_buffer=double_buffer)
    plain = run_step_trainer(step_fn=step, state=state, features=x, targets=y, num_epochs=2,
                             batch_size=16, registry=telemetry.MetricsRegistry())
    assert torch.equal(out["w"], plain["w"])
    report = tracker.report()
    assert report["steps"] == 8 and report["goodput_s"] > 0
    # the first step is the counted dispatch (the port's compile event)
    assert report["badput_s"]["compile"] > 0.0
    if double_buffer:
        assert report["badput_s"]["host_to_device"] == 0.0
    snap = reg.snapshot()
    assert 0.0 < snap["unionml_train_goodput_ratio"][""] <= 1.0
    jsonl = tracer.export_jsonl()
    assert '"kind": "trainer"' in jsonl and '"name": "compute"' in jsonl


def test_goodput_true_builds_a_tracker_on_the_trainers_registry():
    step, state, x, y = _linear_problem()
    reg = telemetry.MetricsRegistry()
    before = len(telemetry.get_tracer()._all_requests())
    run_step_trainer(step_fn=step, state=state, features=x, targets=y, batch_size=16,
                     registry=reg, goodput=True)
    assert reg.snapshot()["unionml_train_goodput_seconds_total"][""] > 0
    assert len(telemetry.get_tracer()._all_requests()) == before + 1


@pytest.mark.parametrize("double_buffer", [False, True])
def test_trainer_finishes_the_tracker_on_a_raising_stream(double_buffer):
    step, state, _, _ = _linear_problem()
    reg = telemetry.MetricsRegistry()
    tracer = telemetry.TraceRecorder(registry=reg)
    tracker = goodput.GoodputTracker(registry=reg, tracer=tracer,
                                     flight=telemetry.FlightRecorder())

    def broken_stream():
        rng = np.random.default_rng(0)
        for _ in range(2):
            yield (rng.normal(size=(16, 4)).astype(np.float32),
                   rng.normal(size=(16,)).astype(np.float32))
        raise RuntimeError("loader died")

    with pytest.raises(RuntimeError, match="loader died"):
        run_step_trainer(step_fn=step, state=state, features=broken_stream(), registry=reg,
                         goodput=tracker, double_buffer=double_buffer)
    assert not tracer._live
    assert tracker._t_stop is not None
    # inline, the second pull (made before the first step) is the last
    # good one; threaded, the feeder reads ahead and both batches train
    assert tracker.report()["steps"] == (2 if double_buffer else 1)


# -------------------------------------------------------- SLO coupling


def test_goodput_collapse_breaches_gauge_objective():
    """The port's goodput ratio gauge feeds the port's SLO watchdog: a
    healthy ratio holds, an input-starved step collapses it and breaches
    the gauge objective one fast window later (the twin of the JAX
    package's case, with the same readings in both packages)."""
    from unionml_tpu import slo as jslo

    from unionml_tpu_torch import slo

    reports = []
    for mod, sl, tel in ((goodput, slo, telemetry), (jgoodput, jslo, jtelemetry)):
        clock = FakeClock()
        reg = tel.MetricsRegistry()
        tracker = mod.GoodputTracker(registry=reg, tracer=tel.TraceRecorder(registry=reg),
                                     flight=tel.FlightRecorder(), clock=clock)
        watchdog = sl.SloWatchdog(
            [sl.GaugeObjective("train_goodput", "unionml_train_goodput_ratio", min_value=0.5)],
            registry=reg, fast_window_s=10.0, slow_window_s=10.0,
        )
        tracker.start()
        with tracker.phase("compute"):
            clock.advance(9.0)
        with tracker.phase("data_wait"):
            clock.advance(1.0)
        tracker.step_complete(1.0)  # publishes ratio = 0.9
        first = watchdog.evaluate(now=1000.0)
        assert not first["breached"]

        with tracker.phase("data_wait"):
            clock.advance(90.0)  # input starvation: goodput collapses to 0.09
        tracker.step_complete(90.0)
        second = watchdog.evaluate(now=1015.0)
        assert second["breached"] == ["train_goodput"]
        snap = reg.snapshot()
        assert snap["unionml_slo_breached"]["objective=train_goodput"] == 1.0
        reports.append((first["breached"], second["breached"],
                        snap["unionml_train_goodput_ratio"]))
    assert reports[0] == reports[1]


def test_trace_ids_are_drawn_without_a_system_call(monkeypatch):
    """Request, trace and span ids keep their widths (hex, never all
    zero, distinct) and come from a seeded in-process generator: the
    tracker's per-phase span costs no ``os.urandom`` call between two
    goodput phases, and a forked child draws ids of its own."""
    import os

    def no_urandom(n):
        raise AssertionError("an id drew on os.urandom")

    monkeypatch.setattr(os, "urandom", no_urandom)
    for fn, width in ((telemetry.new_request_id, 16), (telemetry.new_trace_id, 32),
                      (telemetry.new_span_id, 16)):
        ids = [fn() for _ in range(1000)]
        assert all(len(i) == width and int(i, 16) != 0 and i == i.lower() for i in ids)
        assert len(set(ids)) == len(ids)
    monkeypatch.undo()

    # the fork check runs in a fresh single-threaded interpreter
    code = (
        "import os\n"
        "from unionml_tpu_torch import telemetry\n"
        "read, write = os.pipe()\n"
        "pid = os.fork()\n"
        "if pid == 0:\n"
        "    os.write(write, telemetry.new_span_id().encode())\n"
        "    os._exit(0)\n"
        "os.close(write)\n"
        "child = os.read(read, 64).decode()\n"
        "os.waitpid(pid, 0)\n"
        "print(child, telemetry.new_span_id())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(Path(__file__).resolve().parents[1]))
    assert out.returncode == 0, out.stderr
    child, parent = out.stdout.split()
    assert len(child) == 16 and child != parent

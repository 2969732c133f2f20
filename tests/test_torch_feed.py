"""The port's training feed against the JAX package on the CPU.

The C++ host loader, the port's numpy path and the reference's
``BatchLoader`` give the same batches bit for bit; the loader's lending,
single-iterator and concurrent-build rules; the threaded feed against the
inline feed and the reference's ``prefetch_to_device`` (order, fresh
tensors, a raising source, an abandoned consumer, goodput phases).
"""

import gc
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from unionml_tpu.data.native import BatchLoader as JBatchLoader
from unionml_tpu.data.pipeline import prefetch_to_device as jprefetch_to_device

from unionml_tpu_torch import telemetry
from unionml_tpu_torch.data import native
from unionml_tpu_torch.data.native import BatchLoader
from unionml_tpu_torch.data.pipeline import prefetch_to_device
from unionml_tpu_torch.goodput import GoodputTracker
from unionml_tpu_torch.models.train import tree_leaves

REPO = Path(__file__).resolve().parents[1]
JOIN_S = 10.0   # every wait here has its own bound (no pytest-timeout)


def _arrays(n: int, seed: int):
    """Row-aligned arrays of mixed dtypes and row widths."""
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=(n, 4, 3)).astype(np.float32),
        rng.integers(-2**40, 2**40, size=(n,), dtype=np.int64),
        rng.integers(0, 256, size=(n, 5), dtype=np.uint8),
        rng.normal(size=(n, 2)).astype(np.float16),
    ]


def _assert_streams_equal(*streams):
    streams = [list(s) for s in streams]
    assert len({len(s) for s in streams}) == 1, [len(s) for s in streams]
    for batches in zip(*streams):
        for arrays in zip(*batches):
            for a in arrays[1:]:
                assert a.dtype == arrays[0].dtype and a.shape == arrays[0].shape
                assert a.tobytes() == arrays[0].tobytes()


# --------------------------------------------------------------------- #
# the host loader
# --------------------------------------------------------------------- #


def test_native_library_builds_into_build_host():
    lib = native.get_library()
    assert lib is not None, "g++ builds the host loader here"
    path = native.library_path()
    assert path.parent == REPO / "build" / "host" and path.exists()


@pytest.mark.parametrize("seed", [0, 7, 2**40 + 3])
@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("start_batch", [0, 3])
def test_loader_streams_bit_equal_to_the_reference(seed, drop_remainder, start_batch):
    """The C++ loader, the numpy path and the reference loader: the same
    batches, bit for bit, over three epochs from ``start_batch``."""
    arrays = _arrays(103, seed % 1000)
    kw = dict(batch_size=10, seed=seed, drop_remainder=drop_remainder)
    ours = BatchLoader(arrays, use_native=True, num_threads=3, queue_depth=2, **kw)
    numpy_path = BatchLoader(arrays, use_native=False, **kw)
    ref = JBatchLoader(arrays, **kw)
    assert ours.native and not numpy_path.native
    assert ours.num_batches == numpy_path.num_batches == ref.num_batches
    try:
        for epoch in range(3):
            _assert_streams_equal(ours.epoch(epoch, start_batch),
                                  numpy_path.epoch(epoch, start_batch),
                                  ref.epoch(epoch, start_batch))
        _assert_streams_equal(
            (b for _, _, b in ours.epochs(3, start_epoch=1, start_batch=start_batch)),
            (b for _, _, b in ref.epochs(3, start_epoch=1, start_batch=start_batch)),
        )
    finally:
        ours.close()
        ref.close()


def test_loader_without_shuffle_and_short_last_batch():
    arrays = _arrays(23, 1)
    ours = BatchLoader(arrays, batch_size=5, shuffle=False, use_native=True)
    try:
        got = list(ours.epoch(0))
    finally:
        ours.close()
    assert [len(b[0]) for b in got] == [5, 5, 5, 5, 3]
    np.testing.assert_array_equal(np.concatenate([b[1] for b in got]), arrays[1])


def test_loader_copy_false_lends_staging_buffers_until_advance():
    arrays = _arrays(64, 2)
    lent = BatchLoader(arrays, batch_size=8, seed=5, use_native=True, copy=False,
                       queue_depth=1, num_threads=1)
    owned = BatchLoader(arrays, batch_size=8, seed=5, use_native=False)
    try:
        seen = []
        for got, want in zip(lent.epoch(0), owned.epoch(0)):
            # valid until the generator advances
            np.testing.assert_array_equal(got[0], want[0])
            assert not got[0].flags.owndata
            seen.append(got[0])
        # a lent buffer was recycled under a later batch: the earliest view
        # no longer shows its own rows
        assert any(not np.array_equal(v, w[0]) for v, w in zip(seen, owned.epoch(0)))
    finally:
        lent.close()


def test_loader_allows_one_live_iterator():
    ours = BatchLoader(_arrays(40, 3), batch_size=4, use_native=True)
    try:
        first = ours.epoch(0)
        next(first)
        second = ours.epoch(1)
        next(second)
        with pytest.raises(RuntimeError, match="concurrent epoch"):
            next(first)
        second.close()
    finally:
        ours.close()


def test_loader_refuses_native_without_a_toolchain(monkeypatch):
    monkeypatch.setattr(native, "get_library", lambda: None)
    with pytest.raises(RuntimeError, match="cannot be built"):
        BatchLoader(_arrays(8, 0), batch_size=4, use_native=True)
    fallback = BatchLoader(_arrays(8, 0), batch_size=4)
    assert not fallback.native and len(list(fallback.epoch(0))) == 2


def test_two_processes_build_at_once(tmp_path):
    """Two processes build the library into one empty directory at once:
    each loads a whole library (unique temporary names, one atomic
    rename) and no temporary file is left."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        import numpy as np
        from unionml_tpu_torch.data import native
        lib = native.build_library(__import__("pathlib").Path({str(tmp_path)!r}))
        assert lib is not None
        native._LIB = lib
        x = np.arange(40, dtype=np.int64)
        loader = native.BatchLoader([x], batch_size=8, seed=1, use_native=True)
        got = np.concatenate([b[0] for b in loader.epoch(0)])
        assert sorted(got.tolist()) == list(range(40)), got
        print("ok")
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0 and out.strip() == "ok", err[-2000:]
    assert [p.name for p in tmp_path.iterdir()] == [native.library_path(tmp_path).name]


# --------------------------------------------------------------------- #
# the feed
# --------------------------------------------------------------------- #


def _source(count: int = 7):
    rng = np.random.default_rng(11)
    return [(rng.normal(size=(4, 3)).astype(np.float32), np.arange(4) + 10 * i)
            for i in range(count)]


def test_threaded_feed_matches_inline_and_reference_order():
    items = _source()
    inline = list(prefetch_to_device(iter(items), device="cpu"))
    threaded = list(prefetch_to_device(iter(items), device="cpu", double_buffer=True,
                                       buffer_size=3))
    ref = list(jprefetch_to_device(iter(items), double_buffer=True))
    assert len(inline) == len(threaded) == len(ref) == len(items)
    for a, b, c in zip(inline, threaded, ref):
        for x, y, z in zip(a, b, c):
            assert isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
            np.testing.assert_array_equal(x.numpy(), y.numpy())
            np.testing.assert_array_equal(y.numpy(), np.asarray(z))


def test_threaded_feed_yields_fresh_tensors():
    """No buffer is yielded twice: every yielded tensor has memory of its
    own while all are held."""
    out = list(prefetch_to_device((np.full((3,), i, np.float32) for i in range(6)),
                                  device="cpu", double_buffer=True))
    assert len({t.data_ptr() for t in out}) == 6
    assert [float(t[0]) for t in out] == [float(i) for i in range(6)]


def test_threaded_feed_reraises_a_raising_source():
    def broken():
        yield np.zeros(2)
        yield np.ones(2)
        raise ValueError("the source died")

    feed = prefetch_to_device(broken(), device="cpu", double_buffer=True)
    assert float(next(feed)[0]) == 0.0
    assert float(next(feed)[0]) == 1.0
    with pytest.raises(ValueError, match="the source died"):
        next(feed)


def test_abandoned_threaded_feed_stops_its_feeder():
    """A consumer that stops early (closed, or dropped and collected) must
    not leave the feeder blocked on the full queue."""
    def endless():
        i = 0
        while True:
            yield np.full((2,), i, np.float32)
            i += 1

    for drop in (False, True):
        before = set(threading.enumerate())
        feed = prefetch_to_device(endless(), device="cpu", double_buffer=True)
        next(feed)
        feeders = [t for t in set(threading.enumerate()) - before if t.name == "prefetch-feed"]
        assert len(feeders) == 1
        if drop:
            del feed
            gc.collect()
        else:
            feed.close()
        feeders[0].join(timeout=JOIN_S)
        assert not feeders[0].is_alive()


class _StepClock:
    """A monotonic clock that a slow source advances by hand."""

    def __init__(self):
        self.now = 100.0
        self.lock = threading.Lock()

    def __call__(self) -> float:
        with self.lock:
            return self.now

    def advance(self, s: float) -> None:
        with self.lock:
            self.now += s


@pytest.mark.parametrize("double_buffer", [False, True])
def test_feed_goodput_phases(double_buffer):
    """Inline: the source pull lands in data_wait, the placement in
    host_to_device. Threaded: only the consumer's wait lands anywhere
    (data_wait); host_to_device stays 0."""
    clock = _StepClock()
    reg = telemetry.MetricsRegistry()
    tracker = GoodputTracker(registry=reg, tracer=telemetry.TraceRecorder(registry=reg),
                             flight=telemetry.FlightRecorder(), clock=clock)
    tracker.start()
    batches = [np.full((2, 2), float(i), np.float32) for i in range(5)]

    def slow_source():
        for b in batches:
            if double_buffer:
                time.sleep(0.01)   # the consumer really waits on the queue
            else:
                clock.advance(0.25)
            yield b

    out = list(prefetch_to_device(slow_source(), device="cpu", goodput=tracker,
                                  double_buffer=double_buffer))
    assert [float(t[0, 0]) for t in out] == [float(i) for i in range(5)]
    report = tracker.report()
    phases = reg.snapshot()["unionml_train_phase_ms"]
    if double_buffer:
        assert report["badput_s"]["host_to_device"] == 0.0
        assert phases["phase=data_wait"]["count"] == 6   # five batches and the end
        assert "phase=host_to_device" not in phases or \
            phases["phase=host_to_device"]["count"] == 0
    else:
        assert report["badput_s"]["data_wait"] == pytest.approx(1.25)
        assert phases["phase=host_to_device"]["count"] == 5


def test_threaded_feed_start_up_lands_in_the_first_data_wait(monkeypatch):
    """The threaded feed starts its feeder inside the consumer's first
    data_wait phase: the trainer waiting on its input's start-up is
    attributed, not left between two phases."""
    from unionml_tpu_torch.data import pipeline

    events = []

    class Tracker:
        def phase(self, name):
            class Scope:
                def __enter__(self):
                    events.append(("enter", name))

                def __exit__(self, *exc):
                    events.append(("exit", name))
            return Scope()

    class Thread(threading.Thread):
        def start(self):
            events.append(("start", self.name))
            super().start()

    monkeypatch.setattr(pipeline.threading, "Thread", Thread)
    batches = [np.full((2, 2), float(i), np.float32) for i in range(3)]
    out = list(prefetch_to_device(iter(batches), device="cpu", goodput=Tracker(),
                                  double_buffer=True))
    assert [float(t[0, 0]) for t in out] == [0.0, 1.0, 2.0]
    assert events[:3] == [("enter", "data_wait"), ("start", "prefetch-feed"),
                          ("exit", "data_wait")]
    assert events.count(("enter", "data_wait")) == 4   # three batches and the end


def test_sharded_placement_still_refused():
    """Sharded placement needs the ranks' process group: without one the
    feed refuses, naming the bring-up call (the multi-rank feed runs in
    tests/test_torch_parallel.py)."""
    from unionml_tpu_torch.parallel import ShardingConfig

    with pytest.raises(RuntimeError, match="multihost_initialize"):
        next(prefetch_to_device(iter(_source()), device="cpu", sharding=ShardingConfig()))


def test_chip_smoke_feed_phases_rehearsal_on_cpu():
    """chip_smoke.py's phase 3d at ViT-tiny on the CPU, as the script
    drives it on the card: the threaded feed's run gives the inline run's
    loss and state bits with goodput attributing >= 0.95 of its wall time,
    and the preempted, relaunched elastic run ends at the uninterrupted
    run's bits."""
    import dataclasses

    from unionml_tpu_torch.models import ViTConfig

    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    cfg = dataclasses.replace(ViTConfig.tiny(), dtype="float32", attn_impl="fused",
                              norm_impl="fused")
    kw = dict(device="cpu", batch=16, batches_per_epoch=4, epochs=2)
    inline = chip_smoke.vit_train_phase(cfg, keep_state=True, **kw)
    feed = chip_smoke.vit_feed_phase(cfg, inline, inline.pop("state"), **kw)
    assert feed["native_loader"] and feed["same_loss_bits"] and feed["same_state_bits"]
    assert feed["goodput"]["badput_s"]["host_to_device"] == 0.0
    elastic = chip_smoke.vit_elastic_phase(cfg, device="cpu", batch=16)
    assert elastic["resume_step"] == 8 and elastic["same_state_bits"]
    assert len(elastic["save_stall_ms"]) == len(elastic["commit_ms"]) == 4
    # params and the two AdamW moments, fp32
    n_params = sum(t.numel() for t in tree_leaves(inline_state_params(cfg)))
    assert elastic["checkpoint_bytes"] == 3 * 4 * n_params
    assert not list((REPO / "build").glob("elastic-*"))


def inline_state_params(cfg):
    from unionml_tpu_torch.models import ViT

    return ViT(cfg).init(torch.Generator().manual_seed(0), torch.zeros(1, 32, 32, 3))

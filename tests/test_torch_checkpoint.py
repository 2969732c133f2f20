"""The port's checkpoints on the CPU, against the JAX package's managers.

A ``TrainState`` with bf16 and fp32 leaves, counters and nested dicts
round-trips bit for bit through the async manager and the single-file
artifact; rotation, ``latest_step``, torn checkpoints refused, a writer
failure surfacing at ``wait()``, the sync backend, the metrics; and the
same save sequence leaves the same ``step_N`` names as the reference's
manager.
"""

import io
import threading

import pytest
import torch

import jax.numpy as jnp

from unionml_tpu.checkpoint import AsyncCheckpointManager as JAsyncCheckpointManager

from unionml_tpu_torch import telemetry
from unionml_tpu_torch.checkpoint import (
    AsyncCheckpointManager,
    load_pytree,
    make_checkpoint_manager,
    save_pytree,
)
from unionml_tpu_torch.checkpoint.async_writer import COMMIT_MARKER, is_committed
from unionml_tpu_torch.checkpoint.pytree_io import restore_into
from unionml_tpu_torch.models import TrainState, adamw
from unionml_tpu_torch.models.train import tree_leaves

JOIN_S = 10.0


def _train_state(seed: int) -> TrainState:
    """Nested params with bf16 and fp32 leaves, AdamW moments (a bf16 first
    moment) advanced two steps, so the counters are not 0."""
    gen = torch.Generator().manual_seed(seed)
    params = {
        "embed": {"w": torch.randn(6, 4, generator=gen),
                  "scale": torch.randn(4, generator=gen).bfloat16()},
        "blocks": [{"w": torch.randn(4, 4, generator=gen).bfloat16()},
                   {"w": torch.randn(4, 4, generator=gen), "b": torch.zeros(4)}],
    }
    state = TrainState.create(apply_fn=None, params=params,
                              tx=adamw(1e-2, weight_decay=1e-3, mu_dtype="bfloat16"))
    for _ in range(2):
        grads = {"embed": {"w": torch.randn(6, 4, generator=gen),
                           "scale": torch.randn(4, generator=gen).bfloat16()},
                 "blocks": [{"w": torch.randn(4, 4, generator=gen).bfloat16()},
                            {"w": torch.randn(4, 4, generator=gen),
                             "b": torch.randn(4, generator=gen)}]}
        state = state.apply_gradients(grads=grads)
    return state


def _fresh() -> TrainState:
    """The target a relaunch builds: same structure, other values."""
    return _train_state(99)


def _assert_same_bits(a: TrainState, b: TrainState) -> None:
    assert a.step == b.step and a.opt_state["count"] == b.opt_state["count"]
    for x, y in zip(tree_leaves(a.state_dict()), tree_leaves(b.state_dict())):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape and x.device == y.device
            assert x.view(torch.uint8).tolist() == y.view(torch.uint8).tolist()
        else:
            assert x == y


def test_train_state_round_trips_bit_exact(tmp_path):
    state = _train_state(0)
    assert state.step == 2 and state.opt_state["mu"]["embed"]["w"].dtype == torch.bfloat16
    with AsyncCheckpointManager(tmp_path, registry=telemetry.MetricsRegistry()) as mgr:
        mgr.save(2, state)
        restored = mgr.restore(_fresh())
    _assert_same_bits(restored, state)
    # the restored state keeps the target's code: it trains on
    grads = {"embed": {"w": torch.ones(6, 4), "scale": torch.ones(4).bfloat16()},
             "blocks": [{"w": torch.ones(4, 4).bfloat16()},
                        {"w": torch.ones(4, 4), "b": torch.ones(4)}]}
    _assert_same_bits(restored.apply_gradients(grads=grads), state.apply_gradients(grads=grads))


def test_single_file_artifact_round_trips_with_hyperparameters():
    state = _train_state(1)
    buf = io.BytesIO()
    save_pytree(state, {"learning_rate": 0.01, "layers": [1, 2]}, buf)
    buf.seek(0)
    seen = {}

    def factory(hp):
        seen.update(hp)
        return _fresh()

    _assert_same_bits(load_pytree(buf, factory), state)
    assert seen == {"learning_rate": 0.01, "layers": [1, 2]}
    tree = {"a": [torch.arange(3), (torch.ones(2, dtype=torch.float64), 7)]}
    buf = io.BytesIO()
    save_pytree(tree, None, buf)
    buf.seek(0)
    back = load_pytree(buf, lambda hp: {"a": [torch.zeros(3, dtype=torch.long),
                                               (torch.zeros(2, dtype=torch.float64), 0)]})
    assert back["a"][0].tolist() == [0, 1, 2] and back["a"][1][1] == 7
    with pytest.raises(ValueError, match="not a unionml_tpu_torch state artifact"):
        load_pytree(io.BytesIO(b"UTPU1 not torch"), lambda hp: tree)


def test_restore_refuses_another_structure(tmp_path):
    with AsyncCheckpointManager(tmp_path, registry=telemetry.MetricsRegistry()) as mgr:
        mgr.save(1, {"w": torch.ones(3)})
        with pytest.raises(ValueError, match="structure"):
            mgr.restore({"w": torch.ones(3), "b": torch.ones(1)})
        with pytest.raises(ValueError, match="does not fit"):
            mgr.restore({"w": torch.ones(4)})


def test_rotation_latest_step_and_reference_step_names(tmp_path):
    """The same save sequence (rotation at 2, a resave of a step) leaves
    the same committed ``step_N`` names in the port's and the reference's
    managers, and ``latest_step`` agrees after every save."""
    ours = AsyncCheckpointManager(tmp_path / "port", max_to_keep=2,
                                  registry=telemetry.MetricsRegistry())
    ref = JAsyncCheckpointManager(tmp_path / "ref", max_to_keep=2)
    for step in (1, 2, 3, 5, 5, 8):
        ours.save(step, {"w": torch.full((4,), float(step))})
        ref.save(step, {"w": jnp.full((4,), float(step))})
        ours.wait()
        ref.wait()
        assert ours.latest_step() == ref.latest_step() == step
    ours.close()
    ref.close()
    names = lambda root: sorted(p.name for p in root.iterdir())
    assert names(tmp_path / "port") == names(tmp_path / "ref") == ["step_5", "step_8"]
    back = AsyncCheckpointManager(tmp_path / "port", registry=telemetry.MetricsRegistry())
    assert back.restore({"w": torch.zeros(4)}, step=5)["w"].tolist() == [5.0] * 4
    assert all(is_committed(p) for p in (tmp_path / "port").iterdir())


def test_torn_checkpoint_refused_and_skipped(tmp_path):
    mgr = AsyncCheckpointManager(tmp_path, registry=telemetry.MetricsRegistry())
    mgr.save(4, {"w": torch.ones(2)})
    mgr.save(8, {"w": torch.full((2,), 2.0)})
    mgr.wait()
    (tmp_path / "step_8" / COMMIT_MARKER).unlink()   # a torn copy
    assert mgr.latest_step() == 4
    with pytest.raises(ValueError, match="refusing torn checkpoint"):
        mgr.restore({"w": torch.zeros(2)}, step=8)
    assert mgr.restore({"w": torch.zeros(2)})["w"].tolist() == [1.0, 1.0]
    # a directory of marker-less steps only is another format: refused
    other = tmp_path / "other"
    (other / "step_3").mkdir(parents=True)
    with pytest.raises(ValueError, match="without commit markers"):
        AsyncCheckpointManager(other)
    # a crashed predecessor's tmp dirs are swept
    (tmp_path / "step_12.tmp-1-1").mkdir()
    AsyncCheckpointManager(tmp_path, registry=telemetry.MetricsRegistry())
    assert not list(tmp_path.glob("*.tmp-*"))


def test_writer_failure_surfaces_at_wait(tmp_path):
    reg = telemetry.MetricsRegistry()
    with AsyncCheckpointManager(tmp_path, registry=reg) as mgr:
        mgr.save(10, {"w": torch.ones(2)})
        mgr.wait()

    def die(final_path):
        raise OSError("killed mid-commit")

    chaos = AsyncCheckpointManager(tmp_path, registry=reg, commit_hook=die)
    chaos.save(20, {"w": torch.full((2,), 2.0)})
    with pytest.raises(RuntimeError, match="previous checkpoint"):
        chaos.wait()
    chaos.wait()   # raised once
    assert chaos.latest_step() == 10 and not list(tmp_path.glob("step_20*"))
    chaos.save(30, {"w": torch.ones(2)})
    chaos.close()  # only logs
    assert reg.snapshot()["unionml_checkpoint_pending"][""] == 0.0


def test_save_returns_before_commit_and_metrics(tmp_path):
    """save() returns with the commit gated (pending 1, latest_step the
    previous step); save_ms, commit_ms, bytes and restore series land in
    the given registry under kind="async"."""
    reg = telemetry.MetricsRegistry()
    gate = threading.Event()
    mgr = AsyncCheckpointManager(tmp_path, registry=reg,
                                 commit_hook=lambda p: gate.wait(JOIN_S))
    mgr.save(1, {"w": torch.ones(2)})
    gate.set()
    mgr.wait()
    gate.clear()
    source = {"w": torch.full((2,), 3.0)}
    mgr.save(2, source)
    source["w"].add_(1.0)   # after save() returns: the snapshot cannot change
    assert mgr.latest_step() == 1
    snap = reg.snapshot()
    assert snap["unionml_checkpoint_pending"][""] == 1.0
    assert snap["unionml_checkpoint_save_ms"]["kind=async"]["count"] == 2
    gate.set()
    mgr.wait()
    assert mgr.latest_step() == 2
    assert mgr.restore({"w": torch.zeros(2)})["w"].tolist() == [3.0, 3.0]
    snap = reg.snapshot()
    assert snap["unionml_checkpoint_pending"][""] == 0.0
    assert snap["unionml_checkpoint_commit_ms"]["kind=async"]["count"] == 2
    assert snap["unionml_checkpoint_save_bytes_total"]["kind=async"] == 16.0
    assert snap["unionml_checkpoint_restore_ms"]["kind=async"]["count"] == 1
    assert snap["unionml_checkpoint_restore_bytes_total"]["kind=async"] > 0
    for family in ("unionml_checkpoint_save_ms", "unionml_checkpoint_commit_ms",
                   "unionml_checkpoint_pending", "unionml_checkpoint_restore_ms",
                   "unionml_checkpoint_save_bytes_total",
                   "unionml_checkpoint_restore_bytes_total"):
        assert f"# TYPE {family} " in reg.exposition()


def test_backends(tmp_path):
    reg = telemetry.MetricsRegistry()
    sync = make_checkpoint_manager(tmp_path / "sync", backend="sync", registry=reg)
    assert isinstance(sync, AsyncCheckpointManager) and not sync.async_commit
    sync.save(3, {"w": torch.ones(2)})
    assert sync._writer._thread is None and sync.latest_step() == 3  # committed inline
    auto = make_checkpoint_manager(tmp_path / "auto", registry=reg)
    assert auto.async_commit
    # the reference's name for sharded checkpoints gives the port's sharded
    # manager, and "auto" stays with a directory of sharded checkpoints
    from unionml_tpu_torch.checkpoint.sharded import CheckpointManager

    sharded = make_checkpoint_manager(tmp_path / "o", backend="orbax", registry=reg)
    assert isinstance(sharded, CheckpointManager)
    sharded.save(2, {"w": torch.arange(3.0)})
    sharded.wait()
    again = make_checkpoint_manager(tmp_path / "o", registry=reg)
    assert isinstance(again, CheckpointManager) and again.latest_step() == 2
    assert torch.equal(again.restore({"w": torch.zeros(3)})["w"], torch.arange(3.0))
    # the async backend forced onto that directory refuses it, naming the way in
    with pytest.raises(ValueError, match="backend='orbax'"):
        make_checkpoint_manager(tmp_path / "o", backend="async")
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        make_checkpoint_manager(tmp_path / "x", backend="tape")


def test_restore_places_leaves_on_the_target_device_and_dtype():
    saved = {"w": torch.arange(4, dtype=torch.float32), "n": 3}
    out = restore_into({"w": torch.zeros(4, dtype=torch.float64, device="meta"), "n": 0}, saved)
    assert out["w"].device.type == "meta" and out["w"].dtype == torch.float64
    assert out["n"] == 3


def test_restore_pairs_leaves_by_key_not_by_insertion_order(tmp_path):
    """A checkpoint of a tree whose dicts were built in another key order
    (a block reassembled from another source, say) restores each leaf
    into the target leaf of the same key: pairing in insertion order
    handed the scale to the kernel and failed on the shapes."""
    saved = {"block": {"scale": torch.arange(4.0), "kernel": torch.ones(4, 4)}}
    target = {"block": {"kernel": torch.zeros(4, 4), "scale": torch.zeros(4)}}
    out = restore_into(target, saved)
    assert list(out["block"]) == ["kernel", "scale"]
    assert torch.equal(out["block"]["kernel"], torch.ones(4, 4))
    assert torch.equal(out["block"]["scale"], torch.arange(4.0))
    mgr = make_checkpoint_manager(tmp_path, async_commit=False)
    mgr.save(1, saved)
    restored = mgr.restore(target)
    assert torch.equal(restored["block"]["scale"], torch.arange(4.0))
    mgr.close()

"""The port's elastic trainer on the CPU, against the JAX package.

After a ``Preemption`` a resumed run ends bit for bit at its uninterrupted
run's state, on the arrays route, both stream routes and with gradient
accumulation; the port's and the reference's ``run_elastic_trainer`` on
ViT-tiny from bridged params end within the stated fp32 tolerance with
the same checkpoint steps on disk; a hard kill (``os._exit`` in a
subprocess) and a relaunch through ``model.train(checkpoint_dir=)``.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unionml_tpu import elastic as jelastic
from unionml_tpu.models import ViT as JViT
from unionml_tpu.models import ViTConfig as JViTConfig
from unionml_tpu.models import train as jtrain

from unionml_tpu_torch import Model, telemetry
from unionml_tpu_torch.elastic import Preemption, run_elastic_trainer
from unionml_tpu_torch.goodput import GoodputTracker
from unionml_tpu_torch.models import TrainState, ViT, ViTConfig, adamw, classification_step
from unionml_tpu_torch.models import create_train_state, vit_from_jax_params
from unionml_tpu_torch.models.train import tree_leaves

REPO = Path(__file__).resolve().parents[1]
CFG = dict(dataclasses.asdict(ViTConfig.tiny()), dtype="float32")
# after 10 AdamW steps of lr 1e-3 from the same params, fp32 on both sides
# in other summation orders. Adam normalizes each element's update to at
# most ~lr, so an element whose gradient sits at rounding level can move a
# step's worth apart: 1e-4 absolute (one tenth of one step)
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)


def _problem(n: int = 48, accumulate: int = 1):
    cfg = ViTConfig(**CFG)
    module = ViT(cfg)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    y = (x.mean(axis=(1, 2, 3)) > 0).astype(np.int64)
    step = classification_step(module, accumulate_steps=accumulate)

    def fresh():
        return create_train_state(module, torch.zeros(1, 32, 32, 3), learning_rate=1e-3)

    return step, fresh, x, y


def _same_bits(a, b) -> bool:
    la, lb = tree_leaves(a.state_dict()), tree_leaves(b.state_dict())
    return len(la) == len(lb) and all(
        torch.equal(x.view(torch.uint8), y.view(torch.uint8)) if isinstance(x, torch.Tensor)
        else x == y for x, y in zip(la, lb))


def _preempt_at(step_no):
    def hook(step):
        if step == step_no:
            raise Preemption(f"preempted after step {step}")
    return hook


@pytest.mark.parametrize("route", ["arrays", "seekable", "replayable", "accumulate"])
def test_preempted_run_resumes_bit_identical(tmp_path, route):
    accumulate = 2 if route == "accumulate" else 1
    step, fresh, x, y = _problem(accumulate=accumulate)
    batch = 8

    if route in ("arrays", "accumulate"):
        data = dict(arrays=[x, y], num_epochs=2)
    else:
        def batches(start=0):
            for i in range(start, 12):   # two passes over the 48 rows
                rows = slice(i % 6 * batch, (i % 6 + 1) * batch)
                yield x[rows], y[rows]

        data = dict(stream=(lambda start: batches(start)) if route == "seekable"
                    else (lambda: batches()))
    kw = dict(step_fn=step, batch_size=batch // accumulate, accumulate_steps=accumulate,
              checkpoint_every=3, double_buffer=route != "replayable", **data)
    whole, n_whole = run_elastic_trainer(state=fresh(), checkpoint_dir=str(tmp_path / "a"), **kw)
    with pytest.raises(Preemption):
        run_elastic_trainer(state=fresh(), checkpoint_dir=str(tmp_path / "b"),
                            fault_hook=_preempt_at(7), **kw)
    tracker = GoodputTracker(registry=telemetry.MetricsRegistry())
    resumed, n_resumed = run_elastic_trainer(state=fresh(), checkpoint_dir=str(tmp_path / "b"),
                                             goodput=tracker, **kw)
    assert n_whole == n_resumed == whole.step == resumed.step == 12
    assert resumed.opt_state["count"] == 12
    assert _same_bits(whole, resumed)
    report = tracker.report()
    assert report["badput_s"]["preemption"] > 0 and report["badput_s"]["checkpoint"] > 0
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == ["step_12", "step_6", "step_9"]


def test_replayed_stream_shorter_than_the_resume_point_raises(tmp_path):
    step, fresh, x, y = _problem()
    full = lambda: ((x[i:i + 8], y[i:i + 8]) for i in range(0, 48, 8))
    run_elastic_trainer(step_fn=step, state=fresh(), stream=full, batch_size=8,
                        checkpoint_dir=str(tmp_path), checkpoint_every=2)
    short = lambda: ((x[i:i + 8], y[i:i + 8]) for i in range(0, 16, 8))
    with pytest.raises(RuntimeError, match="before the resume position"):
        run_elastic_trainer(step_fn=step, state=fresh(), stream=short, batch_size=8,
                            checkpoint_dir=str(tmp_path), checkpoint_every=2)
    # a sharded run needs the ranks' process group (the multi-rank elastic
    # runs are in tests/test_torch_parallel.py)
    from unionml_tpu_torch.parallel import ShardingConfig

    with pytest.raises(RuntimeError, match="process group"):
        run_elastic_trainer(step_fn=step, state=fresh(), arrays=[x, y],
                            sharding=ShardingConfig(), checkpoint_dir=str(tmp_path / "s"))
    with pytest.raises(ValueError, match="exactly one"):
        run_elastic_trainer(step_fn=step, state=fresh(), checkpoint_dir=str(tmp_path / "n"))


def test_port_and_reference_elastic_trainers_agree(tmp_path):
    """ViT-tiny (fp32) through both ``run_elastic_trainer``s, the port's
    from the reference's initial params bridged: the same checkpoint steps
    on disk, and final params within PARAM_TOL."""
    jmodule = JViT(JViTConfig(**CFG))
    jstate = jtrain.create_train_state(jmodule, jnp.zeros((1, 32, 32, 3)),
                                       optimizer=jtrain.adamw(1e-3))
    cfg = ViTConfig(**CFG)
    params = vit_from_jax_params(jax.tree_util.tree_map(np.asarray, jstate.params), cfg,
                                 device="cpu")
    tstate = TrainState.create(apply_fn=ViT(cfg), params=params, tx=adamw(1e-3))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(40, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=40).astype(np.int32)
    kw = dict(arrays=[x, y], num_epochs=2, batch_size=8, seed=3, checkpoint_every=3)
    jout, jsteps = jelastic.run_elastic_trainer(
        step_fn=jtrain.classification_step(jmodule), state=jstate,
        checkpoint_dir=str(tmp_path / "ref"), checkpoint_backend="async", **kw)
    tout, tsteps = run_elastic_trainer(step_fn=classification_step(ViT(cfg)), state=tstate,
                                       checkpoint_dir=str(tmp_path / "port"), **kw)
    assert tsteps == jsteps == tout.step == int(jout.step) == 10
    names = lambda root: sorted(p.name for p in root.iterdir())
    assert names(tmp_path / "port") == names(tmp_path / "ref") == ["step_10", "step_6",
                                                                     "step_9"]
    want = jax.tree_util.tree_leaves_with_path(jout.params)
    got = dict((jax.tree_util.keystr(p), v)
               for p, v in jax.tree_util.tree_leaves_with_path(tout.params))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_allclose(got[jax.tree_util.keystr(path)].numpy(), np.asarray(leaf),
                                   err_msg=jax.tree_util.keystr(path), **PARAM_TOL)


APP = textwrap.dedent('''
    """A train_step app with checkpoints; UNIONML_TEST_DIE_AT=N on a run that
    finds no checkpoint hard-kills the process (os._exit) after step N."""
    import glob
    import os
    import sys

    import numpy as np
    import torch

    sys.path.insert(0, {repo!r})
    from unionml_tpu_torch import Dataset, Model, elastic

    CKPT = {ckpt!r}
    die_at = int(os.environ.get("UNIONML_TEST_DIE_AT", "0"))
    if die_at and not glob.glob(os.path.join(CKPT, "step_*")):
        real = elastic.run_elastic_trainer

        def with_fault(**kwargs):
            def hook(step):
                if step == die_at:
                    os._exit(17)   # no finally blocks, like SIGKILL
            return real(fault_hook=hook, **kwargs)

        elastic.run_elastic_trainer = with_fault

    dataset = Dataset(name="elastic_dataset", test_size=0.25)
    model = Model(name="elastic_model", dataset=dataset)

    @dataset.reader
    def reader(n: int = 64) -> dict:
        rng = np.random.default_rng(3)
        x = rng.normal(size=(n, 2)).astype(np.float32)
        return {{"features": x, "targets": (2 * x[:, 0] - x[:, 1]).astype(np.float32)}}

    @dataset.splitter
    def splitter(data: dict, test_size: float, shuffle: bool, random_state: int):
        k = int(len(data["features"]) * (1 - test_size))
        return ({{"x": data["features"][:k], "y": data["targets"][:k]}},
                {{"x": data["features"][k:], "y": data["targets"][k:]}})

    @dataset.parser
    def parser(data: dict, features, targets):
        return data["x"], data["y"]

    @model.init
    def init(hyperparameters: dict) -> dict:
        return {{"w": torch.zeros(2), "b": torch.zeros(())}}

    @model.train_step(checkpoint_dir=CKPT, save_every=2, goodput=True, double_buffer=True)
    def step(state: dict, batch: tuple) -> tuple:
        x, y = batch
        err = x @ state["w"] + state["b"] - y
        return ({{"w": state["w"] - 0.05 * x.T @ err / len(y),
                  "b": state["b"] - 0.05 * err.mean()}}, {{"loss": (err ** 2).mean()}})

    @model.evaluator
    def evaluator(state: dict, x: np.ndarray, y: np.ndarray) -> float:
        return float(((torch.from_numpy(x) @ state["w"] + state["b"] - torch.from_numpy(y))
                      ** 2).mean())

    if __name__ == "__main__":
        state, _ = model.train(hyperparameters={{}}, trainer_kwargs={{"num_epochs": 3,
                                                                    "batch_size": 8}})
        np.save(sys.argv[1], np.concatenate([state["w"].numpy(), state["b"].numpy()[None]]))
''')


def test_hard_kill_and_relaunch_through_model_train(tmp_path):
    """A process killed with ``os._exit`` after step 7 leaves committed
    checkpoints (and at most an uncommitted tmp dir); the relaunch resumes
    from the newest committed one and ends at the bits of an uninterrupted
    run (18 steps: 48 rows, batch 8, 3 epochs)."""
    runs = {}
    for name in ("whole", "killed"):
        app = tmp_path / f"{name}_app.py"
        app.write_text(APP.format(repo=str(REPO), ckpt=str(tmp_path / f"{name}_ckpt")))
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        if name == "killed":
            env["UNIONML_TEST_DIE_AT"] = "7"
        out = tmp_path / f"{name}.npy"
        res = subprocess.run([sys.executable, str(app), str(out)], env=env,
                             capture_output=True, text=True, timeout=180)
        if name == "killed":
            assert res.returncode == 17, res.stderr[-2000:]
            assert not out.exists()
            # the kill may land while step 6's commit is in flight: then
            # only its uncommitted tmp dir is there, and step 4 is the
            # newest checkpoint
            committed = sorted(int(p.name[5:]) for p in (tmp_path / "killed_ckpt").iterdir()
                               if "tmp" not in p.name)
            assert committed[-1] in (4, 6) and set(committed) <= {2, 4, 6}
            res = subprocess.run([sys.executable, str(app), str(out)], env=env,
                                 capture_output=True, text=True, timeout=180)
            assert f"resuming from step {committed[-1]}" in res.stderr + res.stdout
        assert res.returncode == 0, res.stderr[-2000:]
        runs[name] = np.load(out)
        assert sorted(p.name for p in (tmp_path / f"{name}_ckpt").iterdir())[-1] == "step_18"
    assert runs["whole"].tobytes() == runs["killed"].tobytes()


def test_checkpoint_dir_route_refuses_unresumable_streams(tmp_path):
    model = Model(name="elastic_streams")
    model.init(lambda hyperparameters: {"w": torch.zeros(2)})
    model.train_step(lambda state, batch: (state, {}), checkpoint_dir=str(tmp_path))
    trainer = model._trainer
    state = {"w": torch.zeros(2)}
    with pytest.raises(ValueError, match="CALLABLE stream"):
        trainer(state, iter([np.zeros((2, 2))]))
    with pytest.raises(ValueError, match="features` alone"):
        trainer(state, lambda: iter([]), np.zeros(2))
    with pytest.raises(ValueError, match="ONE step-indexed"):
        trainer(state, lambda: iter([]), num_epochs=2)

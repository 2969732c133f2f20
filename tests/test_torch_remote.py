"""The port's remote backend on the CPU: the twin of every case of the JAX
package's ``tests/unit/test_remote.py`` (deploy → subprocess execute →
registry, with the ``LocalBackend`` sandbox and a faked SSH / scp / docker
transport for ``GPUHostBackend``, the port's counterpart of
``TPUVMBackend``), the repaired ``chips == 0`` route, the backend config,
and the deploy manifest and execution record against the JAX package's.

The fixture apps are written into temporary directories by this module:
a scikit-learn app, a ``TrainState`` app (moved as saver bytes) and an
elastic ``train_step`` app, each a counterpart of the JAX package's
``tests/apps``. Their stages ask for no card (``chips=0``), so every
runner process resolves the CPU. A ``torch.nn.Module`` app on its default
resources asks for the card, and its runner raises where there is none.
The cases that only read a deployed and trained app share one
module-scoped deployment.
"""

import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_threads

torch_threads.share_cores()

REPO_ROOT = Path(__file__).resolve().parents[1]

SKLEARN_APP = '''
"""Fixture app for remote/serving tests (scikit-learn on the host)."""

import numpy as np
import pandas as pd
from sklearn.linear_model import LogisticRegression

from unionml_tpu_torch import Dataset, Model

dataset = Dataset(name="fixture_dataset", test_size=0.2, shuffle=True, targets=["y"])
model = Model(name="fixture_model", init=LogisticRegression, dataset=dataset)


@dataset.reader
def reader(n: int = 200) -> pd.DataFrame:
    rng = np.random.default_rng(17)
    x1 = rng.normal(size=n)
    x2 = rng.normal(size=n)
    y = ((x1 + x2) > 0).astype(int)
    return pd.DataFrame({"x1": x1, "x2": x2, "y": y})


@model.trainer
def trainer(
    estimator: LogisticRegression, features: pd.DataFrame, target: pd.DataFrame
) -> LogisticRegression:
    return estimator.fit(features, target.squeeze())


@model.predictor
def predictor(estimator: LogisticRegression, features: pd.DataFrame) -> list:
    return [float(p) for p in estimator.predict(features)]


@model.evaluator
def evaluator(
    estimator: LogisticRegression, features: pd.DataFrame, target: pd.DataFrame
) -> float:
    return float(estimator.score(features, target.squeeze()))
'''

STATE_APP = '''
"""Fixture app with a TrainState model object, moved across the execution
boundary as the app's saver bytes; the stage is host-only."""

import numpy as np
import torch

from unionml_tpu_torch import Dataset, Model
from unionml_tpu_torch.defaults import Resources
from unionml_tpu_torch.models import Mlp, MlpConfig, classification_step, create_train_state
from unionml_tpu_torch.models.train import TrainState

dataset = Dataset(name="state_fixture_data", test_size=0.25)
model = Model(name="state_fixture_model", dataset=dataset)

_module = Mlp(MlpConfig(num_classes=2, hidden_dims=(16,), dtype="float32"))


@dataset.reader
def reader(n: int = 64) -> dict:
    rng = np.random.default_rng(3)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.int64)
    return {"features": x, "targets": y}


@dataset.splitter
def splitter(data: dict, test_size: float, shuffle: bool, random_state: int):
    k = int(len(data["features"]) * (1 - test_size))
    return (
        {"features": data["features"][:k], "targets": data["targets"][:k]},
        {"features": data["features"][k:], "targets": data["targets"][k:]},
    )


@dataset.parser
def parser(data: dict, features, targets):
    return (data["features"], data["targets"])


@model.init
def init(hyperparameters: dict) -> TrainState:
    return create_train_state(_module, torch.zeros(1, 8, device="cpu"),
                              learning_rate=hyperparameters.get("learning_rate", 1e-2))


@model.trainer(resources=Resources(cpu="1", mem="1Gi", chips=0))
def trainer(state: TrainState, features: np.ndarray, targets: np.ndarray,
            *, epochs: int = 30) -> TrainState:
    step = classification_step(_module)
    batch = (torch.as_tensor(features), torch.as_tensor(targets))
    for _ in range(epochs):
        state, _ = step(state, batch)
    return state


@model.predictor(resources=Resources(cpu="1", mem="1Gi", chips=0))
def predictor(state: TrainState, features: np.ndarray) -> list:
    with torch.no_grad():
        logits = state.apply_fn(state.params, torch.as_tensor(np.asarray(features)))
    return [int(i) for i in logits.argmax(dim=-1).tolist()]


@model.evaluator
def evaluator(state: TrainState, features: np.ndarray, targets: np.ndarray) -> float:
    return float((np.asarray(predictor(state, features)) == np.asarray(targets)).mean())
'''

ELASTIC_APP = '''
"""Fixture app: a train_step with preemption-safe checkpointing. With a
``die_at`` file holding N in the deployment dir AND no checkpoint yet on
disk, the elastic trainer's fault hook hard-kills the process at global
step N; a relaunch finds checkpoints, disarms, and resumes to
completion."""

import glob
import os

import numpy as np
import pandas as pd
import torch

from unionml_tpu_torch import Dataset, Model
from unionml_tpu_torch.defaults import Resources

_die_at = int(open("die_at").read()) if os.path.exists("die_at") else 0
_ckpt_dir = "elastic_ckpts"   # relative: resolves against the runner cwd
if _die_at and not glob.glob(os.path.join(_ckpt_dir, "step_*")):
    import unionml_tpu_torch.elastic as _elastic

    _real = _elastic.run_elastic_trainer

    def _with_fault(**kwargs):
        def hook(step):
            if step == _die_at:
                os._exit(17)  # hard kill: no finally blocks, like SIGKILL

        return _real(fault_hook=hook, **kwargs)

    _elastic.run_elastic_trainer = _with_fault

dataset = Dataset(name="elastic_dataset", test_size=0.25, shuffle=True,
                  random_state=11, targets=["y"])
model = Model(name="elastic_model", dataset=dataset)


@model.init
def init(hyperparameters: dict) -> dict:
    return {"w": torch.zeros(2), "b": torch.zeros(())}


@dataset.reader
def reader(n: int = 64) -> pd.DataFrame:
    rng = np.random.default_rng(3)
    x1 = rng.normal(size=n)
    x2 = rng.normal(size=n)
    y = 2.0 * x1 - x2 + 0.1 * rng.normal(size=n)
    return pd.DataFrame({"x1": x1, "x2": x2, "y": y})


@model.train_step(
    checkpoint_dir=_ckpt_dir, save_every=2,
    resources=Resources(cpu="1", mem="1Gi", chips=0),
)
def step(state: dict, batch: tuple) -> tuple:
    x, y = batch
    x = torch.as_tensor(np.asarray(x), dtype=torch.float32)
    y = torch.as_tensor(np.asarray(y), dtype=torch.float32).reshape(-1)
    w = state["w"].detach().requires_grad_(True)
    b = state["b"].detach().requires_grad_(True)
    loss = torch.mean((x @ w + b - y) ** 2)
    gw, gb = torch.autograd.grad(loss, (w, b))
    return {"w": (w - 0.05 * gw).detach(), "b": (b - 0.05 * gb).detach()}, {"loss": loss.detach()}


@model.predictor
def predictor(params: dict, features: pd.DataFrame) -> list:
    x = torch.as_tensor(np.asarray(features), dtype=torch.float32)
    return (x @ params["w"] + params["b"]).tolist()


@model.evaluator
def evaluator(params: dict, features: pd.DataFrame, target: pd.DataFrame) -> float:
    x = torch.as_tensor(np.asarray(features), dtype=torch.float32)
    y = torch.as_tensor(np.asarray(target), dtype=torch.float32).reshape(-1)
    return float(torch.mean((x @ params["w"] + params["b"] - y) ** 2))
'''

HIDDEN_CARD_APP = '''
"""Fixture app whose host-only trainer creates a tensor with device=None."""

import os

import pandas as pd
import torch

from unionml_tpu_torch import Dataset, Model
from unionml_tpu_torch._device import resolve_device
from unionml_tpu_torch.defaults import Resources


class Mean:
    """A host-side estimator: the training targets' mean."""

    def fit(self, target):
        self.value = float(target.mean())
        return self


dataset = Dataset(name="hidden_dataset", test_size=0.2, targets=["y"])
model = Model(name="hidden_model", init=Mean, dataset=dataset)


@dataset.reader
def reader() -> pd.DataFrame:
    return pd.DataFrame({"x": [0.0, 1.0] * 10, "y": [0, 1] * 10})


@model.trainer(resources=Resources(cpu="1", mem="1Gi", chips=0))
def trainer(estimator: Mean, features: pd.DataFrame, target: pd.DataFrame) -> Mean:
    print(f"CUDA_VISIBLE_DEVICES={os.environ.get('CUDA_VISIBLE_DEVICES')!r} "
          f"cuda devices {torch.cuda.device_count()}", flush=True)
    torch.zeros(1, device=resolve_device(None))
    return estimator.fit(target.squeeze())
'''


MODULE_APP = '''
"""Fixture app whose model is a torch.nn.Module class, on default resources."""

import numpy as np
import pandas as pd
import torch

from unionml_tpu_torch import Dataset, Model
from unionml_tpu_torch._device import resolve_device


class Linear2(torch.nn.Module):
    """A two-feature logistic regression."""

    def __init__(self):
        super().__init__()
        self.linear = torch.nn.Linear(2, 1)

    def forward(self, x):
        return self.linear(x).squeeze(-1)


dataset = Dataset(name="module_dataset", test_size=0.2, targets=["y"])
model = Model(name="module_model", init=Linear2, dataset=dataset)


@dataset.reader
def reader(n: int = 64) -> pd.DataFrame:
    rng = np.random.default_rng(5)
    x1 = rng.normal(size=n)
    x2 = rng.normal(size=n)
    return pd.DataFrame({"x1": x1, "x2": x2, "y": ((x1 + x2) > 0).astype(float)})


@model.trainer
def trainer(module: Linear2, features: pd.DataFrame, target: pd.DataFrame) -> Linear2:
    device = resolve_device(None)
    module = module.to(device)
    x = torch.as_tensor(features.to_numpy(), dtype=torch.float32, device=device)
    y = torch.as_tensor(target.to_numpy().squeeze(-1), dtype=torch.float32, device=device)
    opt = torch.optim.SGD(module.parameters(), lr=0.5)
    for _ in range(20):
        opt.zero_grad()
        torch.nn.functional.binary_cross_entropy_with_logits(module(x), y).backward()
        opt.step()
    return module


@model.predictor
def predictor(module: Linear2, features: pd.DataFrame) -> list:
    x = torch.as_tensor(features.to_numpy(), dtype=torch.float32,
                        device=next(module.parameters()).device)
    return [float(p) for p in (module(x) > 0).float().cpu()]
'''

# each scenario that runs runner processes has its own copy of its app
# module (its own Model object), backend and root, so they run at once
SKLEARN_COPIES = ("shared", "failed", "restarts", "private_fs", "image")


@pytest.fixture(scope="module")
def apps_dir(tmp_path_factory):
    """The fixture apps' directory on ``sys.path`` for this module."""
    d = tmp_path_factory.mktemp("apps")
    files = {"port_sklearn_app": SKLEARN_APP, "port_state_app": STATE_APP,
             "port_elastic_app": ELASTIC_APP, "port_hidden_app": HIDDEN_CARD_APP,
             "port_module_app": MODULE_APP,
             **{f"port_sklearn_app_{c}": SKLEARN_APP for c in SKLEARN_COPIES}}
    for name, src in files.items():
        (d / f"{name}.py").write_text(textwrap.dedent(src))
    sys.path.insert(0, str(d))
    yield d
    sys.path.remove(str(d))
    for name in files:
        sys.modules.pop(name, None)


def _local(model, root, project="fixture-project"):
    """``model`` on a LocalBackend rooted at ``root`` (explicit: the
    scenarios run at once and never touch the environment)."""
    from unionml_tpu_torch.remote import LocalBackend

    model._backend = LocalBackend(project=project, root=str(root))
    return model


def _shared_run(root):
    """Deploy v1 and train once; then both predictions at once."""
    import port_sklearn_app_shared as app

    model = _local(app.model, root)
    model.remote_deploy(app_version="v1")
    artifact = model.remote_train(app_version="v1", hyperparameters={"max_iter": 200}, n=200)
    versions = model.remote_list_model_versions()
    reader_run = model.remote_predict(model_version="latest", n=50, wait=False)
    features_run = model.remote_predict(
        features=[{"x1": 5.0, "x2": 5.0}, {"x1": -5.0, "x2": -5.0}], wait=False)
    return {"model": model, "artifact": artifact, "versions": versions,
            "preds": model.remote_fetch_predictions(reader_run),
            "preds2": model.remote_fetch_predictions(features_run)}


def _failed_run(root):
    import port_sklearn_app_failed as app

    model = _local(app.model, root)
    model.remote_deploy(app_version="v1")
    try:
        # bogus reader kwarg -> workflow TypeError inside the runner process
        model.remote_train(app_version="v1", bogus_kwarg=1)
    except RuntimeError as exc:
        return exc
    return None


def _restarts_run(root):
    import port_sklearn_app_restarts as app

    model = _local(app.model, root)
    backend = model._remote
    backend.deploy(model, app_version="df1")
    launches = []
    real_launch = backend._launch

    def counting_launch(*a, **k):
        launches.append(1)
        return real_launch(*a, **k)

    backend._launch = counting_launch
    try:
        backend.execute(model, workflow="train", app_version="df1",
                        inputs={"bogus_kwarg": 1},   # deterministic TypeError in-app
                        wait=True, max_restarts=3)
    except RuntimeError as exc:
        return exc, len(launches)
    return None, len(launches)


def _private_fs_run(mp, apps_dir, root):
    """A single-host, shared_fs=False GPU-host deployment over the faked
    transport: train, then a prediction, then one more with the registry
    staging spied on."""
    import port_sklearn_app_private_fs as app

    model = app.model
    backend = _make_gpu_backend(root, ["hostA"], shared_fs=False)
    capture = []
    _fake_transport(mp, backend, apps_dir, capture=capture)
    model._backend = backend
    model.remote_deploy(app_version="v1")
    artifact = model.remote_train(app_version="v1", hyperparameters={"max_iter": 200}, n=200)
    train_capture = list(capture)
    features = [{"x1": 5.0, "x2": 5.0}, {"x1": -5.0, "x2": -5.0}]
    preds = model.remote_predict(app_version="v1", features=features)

    staged = {}
    orig_scp = backend._scp_to

    def spy_scp(host, src, dst):
        if "/executions/" in dst:
            rec = json.loads((Path(src.rstrip(".").rstrip("/")) / "record.json").read_text())
            staged["exec_dir"] = rec["exec_dir"]
            staged["dst"] = dst
        orig_scp(host, src, dst)

    backend._scp_to = spy_scp
    staged_preds = model.remote_predict(app_version="v1", features=features)
    return {"artifact": artifact, "capture": train_capture, "preds": preds,
            "staged": staged, "staged_preds": staged_preds}


def _image_run(mp, apps_dir, root):
    """Image mode over the faked transport and docker: the launch wraps
    the runner in `docker run`; executing it (the docker prefix stripped)
    trains."""
    import port_sklearn_app_image as app

    model = app.model
    backend = _make_gpu_backend(root, ["hostA"], shared_fs=False,
                                image="reg.example/app", image_push=False)
    capture = []
    _fake_transport(mp, backend, apps_dir, capture=capture)
    _fake_docker(mp, backend, capture)
    real_ssh = backend._ssh
    commands = []

    def docker_exec_ssh(host, command, **popen_kwargs):
        if command.startswith("docker run"):
            commands.append(command)
            command = _on_host(backend, host, command)
            m = re.search(r"reg\.example/app:\S+ (python -m unionml_tpu_torch\.remote\.runner "
                          r".*)$", command)
            envs = dict(kv.split("=", 1) for kv in re.findall(r"-e ([A-Z_]+=\S*)", command))
            env = dict(os.environ)
            env.update(envs)
            env["PYTHONPATH"] = os.pathsep.join(
                [str(REPO_ROOT), str(apps_dir), env.get("PYTHONPATH", "")])
            wd = re.search(r"-w (\S+)", command).group(1)
            return subprocess.Popen(["bash", "-c", m.group(1)], cwd=wd, env=env,
                                    **popen_kwargs)
        return real_ssh(host, command, **popen_kwargs)

    backend._ssh = docker_exec_ssh
    model._backend = backend
    model.remote_deploy(app_version="v1")
    artifact = model.remote_train(app_version="v1", hyperparameters={"max_iter": 200}, n=200)
    return {"artifact": artifact, "capture": capture, "commands": commands,
            "root": backend.root}


def _state_run(root):
    import port_state_app as app

    model = _local(app.model, root, project="state-fixture")
    model.remote_deploy(app_version="v1")
    artifact = model.remote_train(app_version="v1", hyperparameters={"learning_rate": 1e-2},
                                  n=64)
    preds = model.remote_predict(features=np.ones((4, 8), dtype=np.float32))
    return {"artifact": artifact, "preds": preds}


def _elastic_run(root):
    """The interrupted run (a ``die_at`` file in its deployment) and the
    uninterrupted control (a fresh deployment, so a fresh relative
    checkpoint dir) at once."""
    import port_elastic_app as app

    model = _local(app.model, root, project="elastic-project")
    backend = model._remote
    trainer_kwargs = {"num_epochs": 4, "batch_size": 8, "seed": 0}
    backend.deploy(model, app_version="e2")
    control = backend.execute(model, workflow="train", app_version="e2",
                              inputs={"trainer_kwargs": trainer_kwargs}, wait=False)
    dest = backend.deploy(model, app_version="e1")
    (dest / "die_at").write_text("5")
    record = backend.execute(model, workflow="train", app_version="e1",
                             inputs={"trainer_kwargs": trainer_kwargs}, wait=True,
                             max_restarts=1)
    return {"backend": backend, "record": record, "control": backend.wait(control)}


def _hidden_run(root):
    import port_hidden_app as app

    model = _local(app.model, root, project="hidden")
    model.remote_deploy(app_version="h1")
    try:
        model.remote_train(app_version="h1")
    except RuntimeError as exc:
        return {"error": exc, "root": root}
    return {"error": None, "root": root}


def _module_run(root):
    """The nn.Module app trained on its default resources."""
    import port_module_app as app

    model = _local(app.model, root, project="module")
    model.remote_deploy(app_version="m1")
    try:
        model.remote_train(app_version="m1")
    except RuntimeError as exc:
        return {"error": exc, "root": root}
    return {"error": None, "root": root}


class _Runs:
    """The scenarios' futures: a case reads its own; ``wait_all`` before a
    case patches ``subprocess.Popen``, which every launch goes through."""

    def __init__(self, futures):
        self._futures = futures

    def result(self, name):
        return self._futures[name].result(timeout=900)

    def wait_all(self):
        for f in self._futures.values():
            f.exception(timeout=900)


@pytest.fixture(scope="module")
def runs(apps_dir, tmp_path_factory):
    """Every scenario that waits on runner processes, started at once on
    threads when the module's first case asks (each a runner-bound chain
    of one to three processes); the module's wall time is then the
    longest chain's, not the sum."""
    from concurrent.futures import ThreadPoolExecutor

    root = tmp_path_factory.mktemp("runs")
    mp = pytest.MonkeyPatch()
    # set once, before any scenario starts, so a case's own setenv only
    # replaces it (the scenarios pass their roots explicitly)
    mp.setenv("UNIONML_TPU_HOME", str(root / "default"))
    scenarios = {
        "shared": lambda: _shared_run(root / "shared"),
        "failed": lambda: _failed_run(root / "failed"),
        "restarts": lambda: _restarts_run(root / "restarts"),
        "private_fs": lambda: _private_fs_run(mp, apps_dir, root / "private_fs"),
        "image": lambda: _image_run(mp, apps_dir, root / "image"),
        "state": lambda: _state_run(root / "state"),
        "elastic": lambda: _elastic_run(root / "elastic"),
        "hidden": lambda: _hidden_run(root / "hidden"),
        "module": lambda: _module_run(root / "module"),
    }
    pool = ThreadPoolExecutor(max_workers=len(scenarios))
    futures = {name: pool.submit(fn) for name, fn in scenarios.items()}
    try:
        yield _Runs(futures)
    finally:
        _Runs(futures).wait_all()
        pool.shutdown()
        mp.undo()


@pytest.fixture
def fixture_model(runs, monkeypatch):
    """The shared scenario's model, deployed and trained, on its backend."""
    shared = runs.result("shared")
    monkeypatch.setenv("UNIONML_TPU_HOME", str(shared["model"]._backend.root))
    return shared["model"]


def test_deploy_and_remote_train(fixture_model, runs):
    dep_dir = fixture_model._remote.deployment_dir("v1")
    assert (dep_dir / "port_sklearn_app_shared.py").exists()
    assert (dep_dir / ".unionml_manifest.json").exists()
    artifact = runs.result("shared")["artifact"]
    assert artifact.model_object is not None
    assert artifact.metrics["test"] > 0.8


def test_remote_predict_and_registry(runs):
    shared = runs.result("shared")
    versions = shared["versions"]
    assert len(versions) == 1 and versions[0].startswith("train-")
    # the two predictions ran at once, each a runner process of its own
    preds = shared["preds"]
    assert isinstance(preds, list) and len(preds) == 50
    assert shared["preds2"] == [1.0, 0.0]


def test_patch_deploy(fixture_model):
    """Patch redeploy overlays source (reference: test_flyte_remote.py:131-146)."""
    version = fixture_model.remote_deploy(app_version="v1", patch=True)
    assert version.startswith("v1-patch")
    assert fixture_model._remote.deployment_dir(version).exists()


def test_failed_execution_surfaces_log(runs):
    err = runs.result("failed")
    assert isinstance(err, RuntimeError) and "FAILED" in str(err)
    assert "bogus_kwarg" in str(err)   # the runner's log tail


def test_execute_requires_deployment(fixture_model):
    with pytest.raises(FileNotFoundError):
        fixture_model.remote_train(app_version="never-deployed")


def test_app_version_dirty_tree_guard(tmp_path):
    from unionml_tpu_torch.remote import VersionFetchError, get_app_version

    repo = tmp_path / "repo"
    repo.mkdir()
    subprocess.run(["git", "init", "-q"], cwd=repo, check=True)
    subprocess.run(["git", "config", "user.email", "t@t"], cwd=repo, check=True)
    subprocess.run(["git", "config", "user.name", "t"], cwd=repo, check=True)
    (repo / "f.txt").write_text("hello")
    subprocess.run(["git", "add", "."], cwd=repo, check=True)
    subprocess.run(["git", "commit", "-q", "-m", "init"], cwd=repo, check=True)

    version = get_app_version(cwd=str(repo))
    assert len(version) == 7

    (repo / "f.txt").write_text("dirty")
    with pytest.raises(VersionFetchError, match="uncommitted"):
        get_app_version(cwd=str(repo))
    assert get_app_version(allow_uncommitted=True, cwd=str(repo)).endswith("-dirty")


# ---------------------------------------------------------------------------
# GPUHostBackend with a faked SSH/scp transport: the transport primitives
# (_ssh/_run_ssh/_scp_*) are replaced with local bash/cp so env wiring,
# per-host logs, failure aggregation, and the no-shared-FS fetch path all
# run for real.
# ---------------------------------------------------------------------------


def _make_gpu_backend(tmp_path, hosts, **kwargs):
    from unionml_tpu_torch.remote import GPUHostBackend

    kwargs.setdefault("provision", False)
    return GPUHostBackend(
        hosts=hosts, project="fixture-project", root=str(tmp_path / "backend"),
        workdir=str(tmp_path / "gpu_work"), **kwargs,
    )


def _on_host(backend, host, text):
    """``text`` (a command or path) as fake ``host`` sees it: the backend's
    workdir at ``<workdir>.hosts/<host>``, the host's own filesystem."""
    workdir = str(backend.workdir).rstrip("/")
    return text.replace(workdir, f"{workdir}.hosts/{host}")


def _fake_transport(monkeypatch, backend, apps_dir, fail_hosts=(), capture=None, stub=False):
    """Local-subprocess stand-ins for the SSH/scp primitives. ``stub=True``
    records remote commands without executing them; otherwise commands run
    locally via bash, so the real runner executes in the pushed workdir.

    Each fake host has a filesystem of its own, as real hosts do: its
    commands and copies see the backend's ``workdir`` at a directory of
    that host's (:func:`_on_host`), so hosts provisioned in parallel never
    delete or write each other's pushed tree. The captured commands are the
    backend's own, before that mapping."""

    def on_host(host, text):
        return _on_host(backend, host, text)

    def fake_run_ssh(host, command):
        if capture is not None:
            capture.append(("run_ssh", host, command))
        if stub and "pip install" in command:
            return subprocess.CompletedProcess([], 0, "", "")
        if "docker pull" in command:
            return subprocess.CompletedProcess([], 0, "", "")
        return subprocess.run(["bash", "-c", on_host(host, command)], capture_output=True,
                              text=True)

    def fake_scp_to(host, src, dst):
        if capture is not None:
            capture.append(("scp_to", host, src, dst))
        dst = on_host(host, dst)
        if Path(src.rstrip("/.")).resolve() == Path(dst).resolve():
            return
        subprocess.run(["bash", "-c", f"mkdir -p {dst} && cp -r {src} {dst}"], check=True)

    def fake_scp_from(host, src, dst):
        if capture is not None:
            capture.append(("scp_from", host, src, dst))
        src = on_host(host, src)
        subprocess.run(["bash", "-c", f"mkdir -p {dst} && cp -r {src} {dst}"], check=True)

    def fake_ssh(host, command, **popen_kwargs):
        if capture is not None:
            capture.append(("ssh", host, command))
        if stub:
            return subprocess.Popen(["true"], **popen_kwargs)
        if host in fail_hosts:
            return subprocess.Popen(
                ["bash", "-c", "echo 'fake host crash' >&2; exit 3"], **popen_kwargs)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(REPO_ROOT), str(apps_dir), env.get("PYTHONPATH", "")])
        return subprocess.Popen(["bash", "-c", on_host(host, command)], env=env,
                                **popen_kwargs)

    monkeypatch.setattr(backend, "_run_ssh", fake_run_ssh)
    monkeypatch.setattr(backend, "_scp_to", fake_scp_to)
    monkeypatch.setattr(backend, "_scp_from", fake_scp_from)
    monkeypatch.setattr(backend, "_ssh", fake_ssh)
    return backend


@pytest.fixture
def gpu_model(apps_dir, monkeypatch, tmp_path):
    import port_sklearn_app

    monkeypatch.setenv("UNIONML_TPU_HOME", str(tmp_path / "backend"))
    model = port_sklearn_app.model
    model._backend = None
    model.remote(project="fixture-project")
    yield model, tmp_path
    model._backend = None


def test_gpu_hosts_multihost_env_wiring(gpu_model, apps_dir, monkeypatch):
    """Every host gets torch.distributed's env (host 0 is the master) and
    its own runner log; processes are tracked for wait()."""
    model, tmp_path = gpu_model
    backend = _make_gpu_backend(tmp_path, ["hostA", "hostB"])
    capture = []
    _fake_transport(monkeypatch, backend, apps_dir, capture=capture, stub=True)
    model._backend = backend

    backend.deploy(model, app_version="v1")
    record = backend.execute(model, workflow="train", app_version="v1", inputs={}, wait=False)
    launched = backend._procs[record.execution_id]
    try:
        cmds = {e[1]: e[2] for e in capture if e[0] == "ssh"}
        assert "MASTER_ADDR=hostA" in cmds["hostA"] and "MASTER_ADDR=hostA" in cmds["hostB"]
        assert "MASTER_PORT=29500" in cmds["hostA"]
        assert "WORLD_SIZE=2" in cmds["hostA"]
        assert "RANK=0" in cmds["hostA"]
        assert "RANK=1" in cmds["hostB"]
        assert "JAX_" not in cmds["hostA"] + cmds["hostB"]
        assert "python -m unionml_tpu_torch.remote.runner" in cmds["hostA"]
        assert len(launched["procs"]) == 2
        for i in range(2):
            assert (Path(record.exec_dir) / f"runner.host{i}.log").exists()
    finally:
        for _, proc, log in launched["procs"]:
            proc.wait(timeout=30)
            log.close()
        backend._procs.pop(record.execution_id, None)


def test_gpu_hosts_per_host_failure_propagates(gpu_model, apps_dir, monkeypatch):
    """A crashed host fails the execution with that host's rc + log tail."""
    model, tmp_path = gpu_model
    backend = _make_gpu_backend(tmp_path, ["hostA", "hostB"])
    _fake_transport(monkeypatch, backend, apps_dir, fail_hosts={"hostB"})
    model._backend = backend

    backend.deploy(model, app_version="v1")
    with pytest.raises(RuntimeError, match=r"host 1 \(hostB\): rc=3"):
        backend.execute(model, workflow="train", app_version="v1", inputs={}, wait=True)
    from unionml_tpu_torch.remote import ExecutionRecord

    execs = list((tmp_path / "backend" / "executions" / "fixture-project").iterdir())
    assert len(execs) == 1
    rec = ExecutionRecord.load(execs[0])
    assert rec.status == "FAILED"
    assert rec.failure_kind == "preempted"


def test_gpu_hosts_single_host_end_to_end_without_shared_fs(runs):
    """Full lifecycle over the faked transport with shared_fs=False: deploy
    push → runner executes in the per-version workdir → inputs staged out,
    host-0 outputs fetched back → artifact loads. A single host launches
    without any torch.distributed env."""
    run = runs.result("private_fs")
    artifact, capture = run["artifact"], run["capture"]
    assert artifact.model_object is not None
    assert artifact.metrics["test"] > 0.8
    (cmd,) = [e[2] for e in capture if e[0] == "ssh"]
    assert "MASTER_ADDR" not in cmd and "WORLD_SIZE" not in cmd
    assert "_exec" in cmd
    assert any(e[0] == "scp_from" for e in capture)
    # predict resolves the trained model on the host: without a shared FS
    # the backend stages the train execution into the host's registry
    assert run["preds"] == [1.0, 0.0]


def test_gpu_hosts_provisioning_installs_on_every_host(gpu_model, apps_dir, monkeypatch):
    """Full deploys push the environment bundle and pip-install it per
    host; patch deploys skip provisioning."""
    model, tmp_path = gpu_model
    backend = _make_gpu_backend(tmp_path, ["hostA", "hostB"], provision=True)
    capture = []
    _fake_transport(monkeypatch, backend, apps_dir, capture=capture, stub=True)
    model._backend = backend

    def fake_bundle(dest):
        env_dir = Path(dest) / "_env"
        env_dir.mkdir(parents=True, exist_ok=True)
        (env_dir / "unionml_tpu_torch-0.1.0-py3-none-any.whl").write_bytes(b"wheel")
        (env_dir / "requirements.lock").write_text("torch==0.0.test\n")
        return env_dir

    import unionml_tpu_torch.remote.packaging as packaging

    monkeypatch.setattr(packaging, "build_environment_bundle", fake_bundle)

    backend.deploy(model, app_version="v1")
    pip_cmds = [(e[1], e[2]) for e in capture if e[0] == "run_ssh" and "pip install" in e[2]]
    assert {h for h, _ in pip_cmds} == {"hostA", "hostB"}
    assert all("requirements.lock" in c and ".whl" in c for _, c in pip_cmds)

    capture.clear()
    backend.deploy(model, app_version="v1-patch123", patch=True)
    assert not [e for e in capture if e[0] == "run_ssh" and "pip install" in e[2]]


def test_environment_bundle_builds_offline(tmp_path):
    """The real wheel build + pinned lock: the port's package and the
    torch extra's dependencies, under a distribution of its own (a wheel
    named ``unionml_tpu`` would replace a JAX installation on the host)."""
    import zipfile

    from unionml_tpu_torch.remote import build_environment_bundle

    env_dir = build_environment_bundle(tmp_path / "dep")
    wheels = list(env_dir.glob("*.whl"))
    assert [w.name for w in wheels] == ["unionml_tpu_torch-0.1.0-py3-none-any.whl"]
    wheel = zipfile.ZipFile(wheels[0])
    names = wheel.namelist()
    meta = wheel.read("unionml_tpu_torch-0.1.0.dist-info/METADATA").decode()
    assert "Name: unionml_tpu_torch" in meta and "Requires-Dist: torch>=2.4" in meta
    assert "jax" not in meta and "flax" not in meta
    assert "unionml_tpu_torch/remote/runner.py" in names
    assert "unionml_tpu_torch/csrc/flash_attention.cu" in names
    assert not any(n.startswith("unionml_tpu/") for n in names)
    lock = (env_dir / "requirements.lock").read_text()
    assert "torch==" in lock and "numpy==" in lock
    assert "jax" not in lock and "flax" not in lock


def test_gpu_hosts_registry_staging_rewrites_exec_dir(runs):
    """The record staged to a no-shared-FS host must carry the HOST-side
    exec_dir, not the deployer-local one."""
    run = runs.result("private_fs")
    assert run["staged_preds"] == [1.0, 0.0]
    staged = run["staged"]
    assert staged, "registry staging never happened"
    assert staged["exec_dir"] == staged["dst"]


def test_remote_train_with_train_state_artifact(runs):
    """TrainState model objects cross the execution boundary as the app's
    saver bytes when they do not pickle (remote/artifacts.py), through
    remote_train AND remote_predict."""
    from unionml_tpu_torch.models.train import TrainState, tree_leaves

    run = runs.result("state")
    artifact = run["artifact"]
    assert isinstance(artifact.model_object, TrainState)
    assert tree_leaves(artifact.model_object.params)
    assert artifact.metrics["test"] >= 0.8
    assert run["preds"] == [1, 1, 1, 1]


def test_gpu_hosts_wait_without_launch_rejected_when_no_shared_fs(gpu_model):
    from unionml_tpu_torch.remote.backend import ExecutionRecord

    model, tmp_path = gpu_model
    backend = _make_gpu_backend(tmp_path, ["hostA"], shared_fs=False)
    exec_dir = tmp_path / "orphan-exec"
    exec_dir.mkdir()
    record = ExecutionRecord(execution_id="orphan", project="fixture-project",
                             workflow="train", app_version="v1", exec_dir=str(exec_dir))
    record.save()
    with pytest.raises(TimeoutError, match="shared_fs"):
        backend.wait(record, timeout=1.0)


def test_dump_outputs_names_non_model_offender(fixture_model):
    from unionml_tpu_torch.remote.artifacts import dump_outputs

    outputs = {
        "model_object": {"w": 1.0},
        "hyperparameters": {},
        "metrics": {"callback": lambda x: x},  # unpicklable, not the model
    }
    with pytest.raises(RuntimeError, match="metrics") as err:
        dump_outputs(fixture_model, outputs, io.BytesIO())
    assert err.value.__cause__ is not None


def _fake_docker(monkeypatch, backend, capture, *, fail_on=None):
    def fake_run_docker(args):
        capture.append(("docker",) + tuple(args[:2]))
        if fail_on and args[0] == fail_on:
            return subprocess.CompletedProcess([], 1, "", f"fake {fail_on} failure")
        return subprocess.CompletedProcess([], 0, "", "")

    monkeypatch.setattr(backend, "_run_docker", fake_run_docker)
    return backend


def test_gpu_hosts_image_deploy_builds_pushes_and_pulls(gpu_model, apps_dir, monkeypatch):
    """Image mode: full deploy = docker build of the port's CUDA Dockerfile
    + push + per-host pull, NO pip provisioning; patch deploy skips all
    image work."""
    model, tmp_path = gpu_model
    backend = _make_gpu_backend(tmp_path, ["hostA", "hostB"], provision=True,
                                image="reg.example/app")
    capture = []
    _fake_transport(monkeypatch, backend, apps_dir, capture=capture, stub=True)
    _fake_docker(monkeypatch, backend, capture)
    built = []
    fake = backend._run_docker

    def spy(args):
        if args[0] == "build":
            built.append(args)
        return fake(args)

    monkeypatch.setattr(backend, "_run_docker", spy)

    backend.deploy(model, app_version="v1")
    assert built and built[0][3:5] == ["-f", str(REPO_ROOT / "Dockerfile.cuda")]
    assert ("docker", "push", "reg.example/app:v1") in capture
    pulls = [(e[1], e[2]) for e in capture if e[0] == "run_ssh" and "docker pull" in e[2]]
    assert {h for h, _ in pulls} == {"hostA", "hostB"}
    assert all("reg.example/app:v1" in c for _, c in pulls)
    assert not [e for e in capture if e[0] == "run_ssh" and "pip install" in e[2]]

    capture.clear()
    backend.deploy(model, app_version="v1-patch123", patch=True)
    assert not [e for e in capture if e[0] == "docker"]
    assert not [e for e in capture if e[0] == "run_ssh" and "docker pull" in e[2]]


def test_gpu_hosts_image_deploy_failure_surfaces(gpu_model, apps_dir, monkeypatch):
    model, tmp_path = gpu_model
    backend = _make_gpu_backend(tmp_path, ["hostA"], image="reg.example/app")
    capture = []
    _fake_transport(monkeypatch, backend, apps_dir, capture=capture, stub=True)
    _fake_docker(monkeypatch, backend, capture, fail_on="push")
    with pytest.raises(RuntimeError, match="docker push failed"):
        backend.deploy(model, app_version="v1")


def test_gpu_hosts_image_execution_runs_in_container(runs):
    """The launch command wraps the runner in `docker run --gpus all` with
    the workdir/registry mounts and env flags; executing it (with the
    docker prefix stripped) completes the full train lifecycle."""
    run = runs.result("image")
    (command,) = run["commands"]
    assert re.search(r"reg\.example/app:\S+ python -m unionml_tpu_torch\.remote\.runner ",
                     command), command
    assert f"-v {run['root']}:{run['root']}" in command
    assert "-e UNIONML_TPU_HOME=" in command and "--network host" in command
    assert "--gpus all" in command and "--privileged" not in command
    assert "MASTER_ADDR" not in command   # single host: no torch.distributed env
    assert run["artifact"].metrics["test"] > 0.8
    assert any(e[0] == "docker" and e[1] == "build" for e in run["capture"])


# ---------------------------------------------------------------------------
# Stage.resources are consumed at launch (reference: unionml/defaults.py:5
# sizes the task container; here the launcher derives the runner env)


def test_resources_env_derivation():
    from unionml_tpu_torch.defaults import (
        DEFAULT_DEVICE_RESOURCES,
        Resources,
        cpu_count,
        resources_env,
    )

    host_only = Resources(cpu="2", mem="1Gi", chips=0)
    env = resources_env(host_only)
    assert env["CUDA_VISIBLE_DEVICES"] == ""  # never sees the card
    assert env["OMP_NUM_THREADS"] == "2"
    device = Resources(cpu="500m", mem="8Gi", chips=1)
    env = resources_env(device)
    assert "CUDA_VISIBLE_DEVICES" not in env  # the card stays visible
    assert env["OMP_NUM_THREADS"] == "1"
    assert cpu_count(Resources(cpu="nonsense")) == 1
    assert not any("JAX" in k for k in resources_env(host_only))
    assert DEFAULT_DEVICE_RESOURCES.accelerator == "nvidia-h100-80gb"


def test_workflow_resources_take_stage_maxima():
    from unionml_tpu_torch.defaults import Resources
    from unionml_tpu_torch.remote.backend import _mem_bytes, _workflow_resources
    from unionml_tpu_torch.stage import Workflow, stage_from_fn

    wf = Workflow("wf")
    reader = stage_from_fn(lambda: [], name="reader", owner=None,
                           resources=Resources(cpu="1", mem="512Mi", chips=0))
    trainer = stage_from_fn(lambda: None, name="trainer", owner=None,
                            resources=Resources(cpu="4", mem="8Gi", chips=1,
                                                accelerator="nvidia-h100-80gb"))
    wf.add_node(reader, {})
    wf.add_node(trainer, {})
    env = _workflow_resources(wf)
    assert env.cpu == "4" and env.chips == 1 and env.mem == "8Gi"
    assert env.accelerator == "nvidia-h100-80gb"
    assert _mem_bytes("512Mi") < _mem_bytes("1Gi") < _mem_bytes("2G")


def test_manifest_env_backcompat_and_chips0():
    from unionml_tpu_torch.remote.backend import _manifest_env

    assert _manifest_env({"app": "x:y"}, "train") == {}
    manifest = {
        "resources": {
            "prep": {"cpu": "2", "mem": "1Gi", "chips": 0, "accelerator": None},
            "train": {"cpu": "4", "mem": "8Gi", "chips": 1, "accelerator": "nvidia-h100-80gb"},
        }
    }
    assert _manifest_env(manifest, "prep")["CUDA_VISIBLE_DEVICES"] == ""
    assert "CUDA_VISIBLE_DEVICES" not in _manifest_env(manifest, "train")
    assert _manifest_env(manifest, "unknown") == {}


def test_local_backend_applies_resources_env(fixture_model, runs, monkeypatch):
    """The launched runner's environment carries the derived resource env:
    the host-only sklearn stages hide the card; a chips=1 stage leaves the
    ambient CUDA_VISIBLE_DEVICES alone."""
    import subprocess as sp

    import unionml_tpu_torch.remote.backend as backend_mod

    runs.wait_all()   # the patch below is process-wide
    model = fixture_model
    backend = model._remote
    backend.deploy(model, app_version="rv1")
    manifest_path = backend.deployment_dir("rv1") / ".unionml_manifest.json"
    assert "resources" in manifest_path.read_text()

    captured = {}
    real_popen = sp.Popen

    def capture_popen(cmd, **kwargs):
        captured["env"] = kwargs.get("env", {})
        captured["cmd"] = cmd
        return real_popen(["true"], stdout=kwargs.get("stdout"), stderr=kwargs.get("stderr"))

    monkeypatch.setattr(backend_mod.subprocess, "Popen", capture_popen)
    record = backend.execute(model, workflow=model.train_workflow_name, app_version="rv1",
                             inputs={}, wait=False)
    assert record is not None
    assert captured["cmd"][1:3] == ["-m", "unionml_tpu_torch.remote.runner"]
    assert captured["env"]["OMP_NUM_THREADS"] == "1"
    assert captured["env"].get("CUDA_VISIBLE_DEVICES") == ""
    assert str(REPO_ROOT) in captured["env"]["PYTHONPATH"].split(os.pathsep)

    from unionml_tpu_torch.defaults import DEFAULT_DEVICE_RESOURCES

    monkeypatch.setitem(model._train_task_kwargs, "resources", DEFAULT_DEVICE_RESOURCES)
    monkeypatch.setattr(model, "_train_task", None)
    backend.deploy(model, app_version="rv2")
    captured.clear()
    record = backend.execute(model, workflow=model.train_workflow_name, app_version="rv2",
                             inputs={}, wait=False)
    assert record is not None
    assert captured["env"]["OMP_NUM_THREADS"] == "4"
    assert captured["env"].get("CUDA_VISIBLE_DEVICES") == os.environ.get("CUDA_VISIBLE_DEVICES")


def test_gpu_hosts_resources_env_in_ssh_command(gpu_model, apps_dir, monkeypatch):
    model, tmp_path = gpu_model
    backend = _make_gpu_backend(tmp_path, ["hostA"])
    capture = []
    _fake_transport(monkeypatch, backend, apps_dir, capture=capture, stub=True)
    model._backend = backend
    backend.deploy(model, app_version="v1")
    record = backend.execute(model, workflow="train", app_version="v1", inputs={}, wait=False)
    launched = backend._procs[record.execution_id]
    try:
        cmds = {e[1]: e[2] for e in capture if e[0] == "ssh"}
        assert "OMP_NUM_THREADS=1" in cmds["hostA"]
        assert "CUDA_VISIBLE_DEVICES= " in cmds["hostA"]
    finally:
        for _, proc, log in launched["procs"]:
            proc.wait(timeout=30)
            log.close()
        backend._procs.pop(record.execution_id, None)


def test_elastic_train_step_survives_preemption(runs):
    """A train_step registered with checkpoint_dir is preemption-safe
    through the remote lifecycle: the runner is HARD-KILLED mid-run;
    LocalBackend.wait detects the dead pid, execute(max_restarts=1)
    relaunches the same execution, the elastic trainer resumes from the
    newest checkpoint, and the final state equals an uninterrupted run's
    bit for bit."""
    run = runs.result("elastic")
    record, backend = run["record"], run["backend"]
    assert record.status == "SUCCEEDED"
    log = (Path(record.exec_dir) / "runner.log").read_text()
    assert "died without reporting" in log   # the kill really happened
    assert "resuming from step" in log       # ...and the relaunch RESUMED
    interrupted = backend.fetch_outputs(record)["model_object"]
    control = backend.fetch_outputs(run["control"])["model_object"]
    assert torch.equal(interrupted["w"], control["w"])
    assert torch.equal(interrupted["b"], control["b"])


def test_max_restarts_skips_deterministic_failures(runs):
    """An app-REPORTED failure must surface immediately — max_restarts only
    retries preemptions (runner died without reporting)."""
    err, launches = runs.result("restarts")
    assert isinstance(err, RuntimeError) and "FAILED" in str(err)
    assert launches == 1, "deterministic failure was relaunched"


def test_pinned_requirements_toml_fallback_parser():
    from unionml_tpu_torch.remote.packaging import _parse_dependencies_toml

    tricky = "\n".join([
        "[build-system]",
        'requires = ["setuptools"]',
        "[project]",
        'name = "x"',
        "dependencies = [",
        '    "jax[tpu]>=0.4.30",  # extras bracket inside the spec',
        "    'flax>=0.8',",
        '    "numpy>=1.24",',
        "]",
        "[project.optional-dependencies]",
        'dev = ["pytest"]',
        'torch = ["torch[opt]>=2.4",  # the port',
        '         "numpy>=1.24"]',
    ])
    assert _parse_dependencies_toml(tricky) == ["jax[tpu]>=0.4.30", "flax>=0.8", "numpy>=1.24"]
    assert _parse_dependencies_toml(
        '[project]\ndependencies = ["a[x]>=1", "b>=2"]\n') == ["a[x]>=1", "b>=2"]
    with pytest.raises(KeyError):
        _parse_dependencies_toml("[project]\nname='x'\n")
    # the port's own table: the torch extra
    assert _parse_dependencies_toml(tricky, "project.optional-dependencies", "torch") == [
        "torch[opt]>=2.4", "numpy>=1.24"]
    repo = (REPO_ROOT / "pyproject.toml").read_text()
    assert _parse_dependencies_toml(repo, "project.optional-dependencies", "torch") == [
        "torch>=2.4", "numpy>=1.24"]


# ------------------------------------------------ the port's own additions


def test_hidden_card_stage_raises_on_device_none(runs):
    """A chips == 0 stage runs with CUDA_VISIBLE_DEVICES="": the runner
    resolves the CPU for itself, and the app's tensor made with
    ``device=None`` raises the port's no-CUDA-device error instead of
    landing on the CPU."""
    run = runs.result("hidden")
    assert isinstance(run["error"], RuntimeError)
    assert "no CUDA device is available" in str(run["error"])
    record = next((run["root"] / "executions" / "hidden").iterdir())
    log = (record / "runner.log").read_text()
    assert "unionml_tpu_torch runner: device cpu" in log
    assert "CUDA_VISIBLE_DEVICES='' cuda devices 0" in log


@pytest.mark.parametrize("app_module,chips", [("port_sklearn_app", 0),
                                               ("port_module_app", 1)])
def test_default_stage_resources_in_manifest(apps_dir, tmp_path, app_module, chips):
    """Only scikit-learn apps default to host-only stages; an nn.Module
    app, which the port runs on the card, asks for one H100."""
    import importlib

    from unionml_tpu_torch.remote.backend import _manifest_env

    app = importlib.import_module(app_module)
    model = _local(app.model, tmp_path / "root", project="resources")
    manifest = json.loads(
        (model._remote.deploy(model, app_version="d1") / ".unionml_manifest.json").read_text())
    table = manifest["resources"]
    assert {name.rsplit(".", 1)[-1] for name in table} == {
        "train", "predict", "predict_from_features"}
    for workflow, rec in table.items():
        assert rec["chips"] == chips, workflow
        env = _manifest_env(manifest, workflow)
        if chips:
            assert rec["accelerator"] == "nvidia-h100-80gb"
            assert "CUDA_VISIBLE_DEVICES" not in env
        else:
            assert env["CUDA_VISIBLE_DEVICES"] == ""


@pytest.mark.parametrize("scenario", ["shared", "module"])
def test_runner_device_line_by_model_family(runs, scenario):
    """The runner's device line follows the app's default resources: the
    sklearn app's runner resolves the CPU; the nn.Module app's runner
    resolves the card, and without one raises the port's no-CUDA-device
    error instead of training on the CPU."""
    run = runs.result(scenario)
    if scenario == "shared":
        # the train execution (the model version it made)
        exec_dir = run["model"]._remote.executions_dir() / run["versions"][0]
        assert "unionml_tpu_torch runner: device cpu" in (exec_dir / "runner.log").read_text()
        return
    (exec_dir,) = (run["root"] / "executions" / "module").iterdir()
    log = (exec_dir / "runner.log").read_text()
    if torch.cuda.is_available():
        assert run["error"] is None
        assert "unionml_tpu_torch runner: device cuda" in log
    else:
        assert isinstance(run["error"], RuntimeError)
        assert "no CUDA device is available" in str(run["error"]) + log
        assert "runner: device cpu" not in log


def test_get_backend_reads_gpu_hosts_and_refuses_tpu_vm(tmp_path):
    from unionml_tpu_torch.remote import GPUHostBackend, LocalBackend, get_backend

    def cfg(text):
        path = tmp_path / f"c{len(list(tmp_path.iterdir()))}.yaml"
        path.write_text(textwrap.dedent(text))
        return str(path)

    b = get_backend(cfg("""
        backend:
          type: gpu_hosts
          hosts: [gpu0, gpu1]
          shared_fs: false
    """), project="p")
    assert isinstance(b, GPUHostBackend)
    assert b.hosts == ["gpu0", "gpu1"] and not b.shared_fs
    assert b.coordinator_port == 29500 and b.workdir == "/tmp/unionml_tpu_torch_app"
    with pytest.raises(ValueError, match="gpu_hosts"):
        get_backend(cfg("backend:\n  type: tpu_vm\n  hosts: [h]\n"), project="p")
    local = get_backend(cfg(f"backend:\n  root: {tmp_path / 'r'}\n"), project="p")
    assert isinstance(local, LocalBackend) and local.root == tmp_path / "r"
    assert isinstance(get_backend(None, project="p"), LocalBackend)


def test_manifest_and_record_match_the_jax_backend(apps_dir, runs, monkeypatch, tmp_path):
    """The same app deployed by both packages' LocalBackends: the deploy
    manifest's keys, workflows and resource records, and the execution
    record's fields, are equal."""
    import port_sklearn_app

    import unionml_tpu.remote.backend as jbackend_mod

    import unionml_tpu_torch.remote.backend as backend_mod

    jax_apps = str(REPO_ROOT / "tests" / "apps")
    sys.path.insert(0, jax_apps)
    try:
        import sklearn_app as jsklearn_app
    finally:
        sys.path.remove(jax_apps)

    runs.wait_all()   # the patch below is process-wide
    real_popen = subprocess.Popen

    def no_runner(cmd, **kwargs):
        return real_popen(["true"], stdout=kwargs.get("stdout"), stderr=kwargs.get("stderr"))

    out = []
    for mod, model, name in ((jbackend_mod, jsklearn_app.model, "jax"),
                             (backend_mod, port_sklearn_app.model, "port")):
        backend = mod.LocalBackend(project="p", root=str(tmp_path / name))
        monkeypatch.setattr(mod.subprocess, "Popen", no_runner)
        dest = backend.deploy(model, app_version="m1")
        manifest = json.loads((dest / ".unionml_manifest.json").read_text())
        record = backend.execute(model, workflow="train", app_version="m1", inputs={},
                                 wait=False)
        out.append((manifest, dataclasses.asdict(record)))
    (jman, jrec), (man, rec) = out
    assert sorted(man) == sorted(jman)
    assert man["workflows"] == jman["workflows"]
    assert man["resources"].keys() == jman["resources"].keys()
    for wf, r in man["resources"].items():
        assert sorted(r) == sorted(jman["resources"][wf])
        assert {k: v for k, v in r.items() if k != "accelerator"} == {
            k: v for k, v in jman["resources"][wf].items() if k != "accelerator"}
    assert sorted(rec) == sorted(jrec)
    assert (rec["status"], rec["workflow"], rec["app_version"], rec["failure_kind"]) == (
        jrec["status"], jrec["workflow"], jrec["app_version"], jrec["failure_kind"])

"""The port's CLI (``unionml-tpu-torch``) on the CPU: the twin of every
case of the JAX package's ``tests/unit/test_cli.py``, and ``init`` against
the JAX package's: the same file set for each template.

The deploy / train / list / fetch round trip runs a scikit-learn app that
this module writes into a temporary directory (the counterpart of the JAX
package's ``tests/apps/sklearn_app.py``). The scaffolded projects' own
test suites run in one pytest process, shared by the five cases that
read its results; it starts with the module and runs beside the other
cases.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

import pytest
from click.testing import CliRunner

import unionml_tpu_torch.cli as cli_mod
from unionml_tpu_torch.cli import app

import torch_threads

torch_threads.share_cores()

REPO_ROOT = Path(__file__).resolve().parents[1]
ALL_TEMPLATES = ["basic", "basic_tpu", "llm_serving", "serverless", "vision_tpu"]
SCAFFOLD_FILES = [
    "app.py", "README.md", "requirements.txt", "Dockerfile", ".gitignore",
    "tests/test_app.py",
]

CLI_APP = '''
"""Fixture app for the CLI round trip (scikit-learn on the host)."""

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
    return pd.DataFrame({"x1": x1, "x2": x2, "y": ((x1 + x2) > 0).astype(int)})


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


@pytest.fixture
def runner():
    return CliRunner()


def test_init_scaffolds_template(runner, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    # bytecode caches appear in templates/ whenever a template app is
    # imported; the scaffolder must skip them. Work on a copy so the
    # package dir is never mutated.
    templates_copy = tmp_path / "templates"
    shutil.copytree(cli_mod.TEMPLATES_DIR, templates_copy)
    pycache = templates_copy / "basic" / "__pycache__"
    pycache.mkdir(exist_ok=True)
    (pycache / "app.cpython-312.pyc").write_bytes(b"\xcb\r\r\n\x00binary")
    monkeypatch.setattr(cli_mod, "TEMPLATES_DIR", templates_copy)

    result = runner.invoke(app, ["init", "my_app"])
    assert result.exit_code == 0, result.output
    assert (tmp_path / "my_app" / "app.py").exists()
    assert not (tmp_path / "my_app" / "__pycache__").exists()
    content = (tmp_path / "my_app" / "app.py").read_text()
    assert "my_app" in content and "{{app_name}}" not in content
    assert "unionml_tpu_torch" in content
    assert (tmp_path / "my_app" / ".git").exists()


def test_init_tpu_template(runner, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    result = runner.invoke(app, ["init", "tpu_app", "--template", "basic_tpu"])
    assert result.exit_code == 0, result.output
    assert "train_step" in (tmp_path / "tpu_app" / "app.py").read_text()


@pytest.mark.parametrize("template", ["serverless", "vision_tpu", "llm_serving"])
def test_init_new_templates_compile_and_register(runner, tmp_path, monkeypatch, template):
    monkeypatch.chdir(tmp_path)
    result = runner.invoke(app, ["init", "cv_app", "--template", template])
    assert result.exit_code == 0, result.output
    app_py = tmp_path / "cv_app" / "app.py"
    assert app_py.exists()
    assert "{{app_name}}" not in app_py.read_text()
    spec = importlib.util.spec_from_file_location(f"port_cv_app_{template}", app_py)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    try:
        spec.loader.exec_module(mod)
        assert mod.model._predictor is not None
        # the port's llm_serving and vision_tpu apps build their spec in
        # build_model(): the registered reader is the model's dataset's
        assert mod.model.dataset._reader is not None
        if template == "serverless":
            assert callable(mod.handler) and callable(mod.on_upload)
    finally:
        sys.modules.pop(spec.name, None)


def test_init_rejects_bad_name(runner, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    result = runner.invoke(app, ["init", "bad-name!"])
    assert result.exit_code != 0
    assert "valid Python identifier" in result.output


def test_init_rejects_existing_dir(runner, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "dup").mkdir()
    result = runner.invoke(app, ["init", "dup"])
    assert result.exit_code != 0 and "already exists" in result.output


def test_deploy_train_predict_roundtrip(runner, tmp_path, monkeypatch):
    apps = tmp_path / "apps"
    apps.mkdir()
    (apps / "port_cli_app.py").write_text(CLI_APP)
    monkeypatch.setenv("UNIONML_TPU_HOME", str(tmp_path / "backend"))
    monkeypatch.chdir(apps)
    sys.path.insert(0, str(apps))
    try:
        import port_cli_app

        port_cli_app.model._backend = None
        port_cli_app.model.remote(project="cli-project")

        result = runner.invoke(app, ["deploy", "port_cli_app:model", "--app-version", "vcli"])
        assert result.exit_code == 0, result.output
        assert "deployed fixture_model version vcli" in result.output

        result = runner.invoke(
            app, ["train", "port_cli_app:model", "--app-version", "vcli",
                  "--inputs", json.dumps({"hyperparameters": {"max_iter": 200}, "n": 200})])
        assert result.exit_code == 0, result.output
        assert "metrics" in result.output

        result = runner.invoke(app, ["list-model-versions", "port_cli_app:model"])
        assert result.exit_code == 0 and "train-" in result.output

        out_path = tmp_path / "fetched.joblib"
        result = runner.invoke(app, ["fetch-model", "port_cli_app:model", "-o", str(out_path)])
        assert result.exit_code == 0, result.output
        assert out_path.exists()
    finally:
        sys.path.remove(str(apps))
        sys.modules.pop("port_cli_app", None)


@pytest.mark.parametrize("template", ALL_TEMPLATES)
def test_init_emits_full_project_scaffold(runner, tmp_path, monkeypatch, template):
    """Every template scaffolds a deployable project, not just an app.py."""
    monkeypatch.chdir(tmp_path)
    result = runner.invoke(app, ["init", "proj", "--template", template])
    assert result.exit_code == 0, result.output
    root = tmp_path / "proj"
    for rel in SCAFFOLD_FILES:
        assert (root / rel).exists(), f"{template} scaffold missing {rel}"
    readme = (root / "README.md").read_text()
    assert "proj" in readme and "{{app_name}}" not in readme
    dockerfile = (root / "Dockerfile").read_text()
    assert "requirements.txt" in dockerfile and "CMD" in dockerfile
    assert "cuda" in dockerfile   # a CUDA PyTorch base image
    assert "torch" in (root / "requirements.txt").read_text()
    assert "jax" not in (root / "requirements.txt").read_text()
    if template == "serverless":
        assert (root / "template.yaml").exists()
        assert (root / "events" / "gateway_predict.json").exists()


@pytest.fixture(scope="module", autouse=True)
def scaffold_suites(tmp_path_factory):
    """Each template scaffolded by ``init`` as generated, then every
    scaffold's own ``tests/`` started in one pytest process when the module
    starts, so it runs while the other cases do."""
    base = tmp_path_factory.mktemp("scaffolds")
    cwd = os.getcwd()
    os.chdir(base)
    try:
        for template in ALL_TEMPLATES:
            result = CliRunner().invoke(app, ["init", f"proj_{template}", "--template", template])
            assert result.exit_code == 0, result.output
    finally:
        os.chdir(cwd)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO_ROOT), env.get("PYTHONPATH", "")])
    junit, log = base / "junit.xml", base / "pytest.log"
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "pytest", *[f"proj_{t}/tests/" for t in ALL_TEMPLATES],
             "-q", "--no-header", "-p", "no:cacheprovider", "--import-mode=importlib",
             f"--junitxml={junit}"],
            cwd=base, env=env, stdout=out, stderr=subprocess.STDOUT,
        )
    yield proc, junit, log
    if proc.poll() is None:
        proc.kill()
    proc.wait()


@pytest.fixture(scope="module")
def scaffold_run(scaffold_suites):
    """The scaffolds' pytest run, waited for: its output and per-test
    results from its junit report."""
    proc, junit, log = scaffold_suites
    proc.wait(timeout=900)
    cases = {}
    for tc in ET.parse(junit).iter("testcase"):
        failed = any(child.tag in ("failure", "error", "skipped") for child in tc)
        cases.setdefault(tc.get("classname", ""), []).append(not failed)
    return log.read_text(), cases


@pytest.mark.parametrize("template", ALL_TEMPLATES)
def test_scaffolded_project_tests_pass(scaffold_run, template):
    """Every scaffold's own test suite passes as generated — ``init``
    output is deployable, not just importable."""
    output, cases = scaffold_run
    mine = [ok for name, oks in cases.items() if f"proj_{template}" in name for ok in oks]
    assert mine and all(mine), output[-6000:]


@pytest.mark.parametrize("template", ALL_TEMPLATES)
def test_init_scaffolds_the_reference_file_set(tmp_path, monkeypatch, template):
    """``init`` of each template gives the files the JAX package's ``init``
    gives for it (the git metadata apart)."""
    from unionml_tpu.cli import app as japp

    sets = []
    for name, cli in (("jax", japp), ("port", app)):
        where = tmp_path / name
        where.mkdir()
        monkeypatch.chdir(where)
        result = CliRunner().invoke(cli, ["init", "proj", "--template", template])
        assert result.exit_code == 0, result.output
        root = where / "proj"
        sets.append(sorted(str(p.relative_to(root)) for p in root.rglob("*")
                           if p.is_file() and ".git" not in p.relative_to(root).parts[:1]))
    assert sets[1] == sets[0]

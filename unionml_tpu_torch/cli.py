"""CLI: init / deploy / train / predict / list-model-versions / fetch-model / serve.

The port of :mod:`unionml_tpu.cli`, installed as ``unionml-tpu-torch``.
Command-for-command parity with reference unionml/cli.py:26-212 (typer →
click, which is dependency-available; uvicorn's role is played by the
stdlib serving transport). ``init`` scaffolds the port's templates. The ``serve`` command exports ``--model-path``
via ``UNIONML_MODEL_PATH`` exactly like the reference's patched uvicorn
callback (reference: cli.py:172-212).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import click

TEMPLATES_DIR = Path(__file__).parent / "templates"
APP_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


@click.group()
def app():
    """unionml-tpu-torch: declarative ML microservices on PyTorch and CUDA."""


@app.command()
@click.argument("app_name")
@click.option("--template", "-t", default="basic",
              type=click.Choice(
                  [p.name for p in sorted(TEMPLATES_DIR.iterdir())]
                  if TEMPLATES_DIR.exists() else ["basic"]
              ),
              help="project template")
def init(app_name: str, template: str):
    """Scaffold a new app (reference: cli.py:33-51 + cookiecutter hooks)."""
    # pre-gen name validation (reference: templates/common/hooks/pre_gen_project.py)
    if not APP_NAME_RE.match(app_name):
        raise click.ClickException(
            f"app name {app_name!r} must be a valid Python identifier"
        )
    src = TEMPLATES_DIR / template
    dest = Path.cwd() / app_name
    if dest.exists():
        raise click.ClickException(f"directory {dest} already exists")
    dest.mkdir(parents=True)
    for f in sorted(src.rglob("*")):
        if f.is_dir() or "__pycache__" in f.parts:
            # bytecode caches appear whenever a template app gets imported
            # (tests, compileall) and must never reach the scaffold
            continue
        rel = Path(str(f.relative_to(src)).replace("{{app_name}}", app_name))
        target = dest / rel
        target.parent.mkdir(parents=True, exist_ok=True)
        try:
            # explicit utf-8: with the locale default, a non-ASCII TEXT
            # template could decode-fail and skip {{app_name}} substitution
            target.write_text(
                f.read_text(encoding="utf-8").replace("{{app_name}}", app_name),
                encoding="utf-8",
            )
        except UnicodeDecodeError:
            target.write_bytes(f.read_bytes())  # binary assets copy verbatim
    # post-gen: git init + initial commit (reference: post_gen_project.py)
    try:
        quiet = {"capture_output": True, "cwd": dest}
        subprocess.run(["git", "init", "-q"], check=True, **quiet)
        subprocess.run(["git", "add", "."], check=True, **quiet)
        subprocess.run(
            ["git", "commit", "-q", "-m", f"initialize {app_name} from {template} template"],
            check=False, **quiet,
        )
    except (subprocess.CalledProcessError, FileNotFoundError):
        pass
    click.echo(f"initialized {app_name} from template {template!r} at {dest}")


def _get_model(app_str: str):
    sys.path.insert(0, os.getcwd())
    from unionml_tpu_torch.remote import get_model

    return get_model(app_str)


@app.command()
@click.argument("app_str", metavar="APP")
@click.option("--app-version", default=None)
@click.option("--allow-uncommitted", is_flag=True, default=False)
@click.option("--patch", is_flag=True, default=False, help="fast source-only redeploy")
def deploy(app_str: str, app_version, allow_uncommitted: bool, patch: bool):
    """Deploy an app to the backend (reference: cli.py:54-82)."""
    model = _get_model(app_str)
    version = model.remote_deploy(
        app_version=app_version, allow_uncommitted=allow_uncommitted, patch=patch
    )
    click.echo(f"deployed {model.name} version {version}")


@app.command()
@click.argument("app_str", metavar="APP")
@click.option("--inputs", "-i", default="{}", help="JSON of train inputs")
@click.option("--app-version", default=None)
def train(app_str: str, inputs: str, app_version):
    """Train on the backend (reference: cli.py:85-103)."""
    model = _get_model(app_str)
    kwargs = json.loads(inputs)
    artifact = model.remote_train(app_version=app_version, wait=True, **kwargs)
    click.echo(f"trained model: {type(artifact.model_object).__name__}")
    click.echo(f"metrics: {artifact.metrics}")


@app.command()
@click.argument("app_str", metavar="APP")
@click.option("--inputs", "-i", default=None, help="JSON of reader kwargs")
@click.option("--features", "-f", default=None, help="path to a features file")
@click.option("--app-version", default=None)
@click.option("--model-version", default="latest")
def predict(app_str: str, inputs, features, app_version, model_version):
    """Predict on the backend (reference: cli.py:106-127)."""
    model = _get_model(app_str)
    kwargs = json.loads(inputs) if inputs else {}
    feats = None
    if features is not None:
        feats = model.dataset.get_features(features)
    preds = model.remote_predict(
        app_version=app_version, model_version=model_version,
        wait=True, features=feats, **kwargs,
    )
    click.echo(json.dumps(preds, default=str))


@app.command(name="list-model-versions")
@click.argument("app_str", metavar="APP")
@click.option("--app-version", default=None)
@click.option("--limit", default=10)
def list_model_versions(app_str: str, app_version, limit: int):
    """List model versions = train executions (reference: cli.py:130-144)."""
    model = _get_model(app_str)
    for v in model.remote_list_model_versions(app_version=app_version, limit=limit):
        click.echo(v)


@app.command(name="fetch-model")
@click.argument("app_str", metavar="APP")
@click.option("--output", "-o", required=True, help="path to save the model artifact")
@click.option("--app-version", default=None)
@click.option("--model-version", default="latest")
def fetch_model(app_str: str, output: str, app_version, model_version: str):
    """Fetch a model artifact from the registry (reference: cli.py:147-165)."""
    model = _get_model(app_str)
    from unionml_tpu_torch.remote import load_latest_artifact

    load_latest_artifact(model, app_version=app_version, model_version=model_version)
    model.save(output)
    click.echo(f"saved model artifact to {output}")


@app.command()
@click.argument("app_str", metavar="APP")
@click.option("--model-path", default=None, help="path to a local model artifact")
@click.option("--host", default="127.0.0.1")
@click.option("--port", default=8000)
@click.option("--batch/--no-batch", default=False, help="enable the micro-batcher")
@click.option(
    "--row-lists/--no-row-lists", default=False,
    help="batch plain lists of ragged rows (LLM token-id prompts) by list concat",
)
def serve(app_str: str, model_path, host: str, port: int, batch: bool, row_lists: bool):
    """Serve an app over HTTP (reference: cli.py:172-212).

    APP is ``module:variable`` naming a Model or a ServingApp. A
    ServingApp constructed with ``stream=`` (e.g. wrapping
    ``DecodeEngine.generate_stream``) additionally serves SSE token
    streaming at ``POST /predict/stream``.
    """
    if model_path is not None:
        if not Path(model_path).exists():
            raise click.ClickException(f"model path {model_path} does not exist")
        os.environ["UNIONML_MODEL_PATH"] = str(model_path)
    target = _get_model(app_str)
    from unionml_tpu_torch.model import Model
    from unionml_tpu_torch.serving.http import ServingApp

    if row_lists and not batch:
        batch = True  # row-list mode only exists inside the micro-batcher
        click.echo("--row-lists implies --batch; enabling the micro-batcher")
    if isinstance(target, Model):
        serving = ServingApp(target, batch=batch, row_lists=row_lists)
    elif isinstance(target, ServingApp):
        if batch or row_lists:
            click.echo(
                "warning: --batch/--row-lists are ignored when APP is a "
                "pre-built ServingApp — its own batcher settings take "
                "precedence (construct the ServingApp with batch=/row_lists=)"
            )
        serving = target
    else:
        raise click.ClickException(
            f"{app_str} must resolve to a unionml_tpu_torch Model or ServingApp, "
            f"got {type(target)}"
        )
    serving.serve(host=host, port=port, blocking=True)


if __name__ == "__main__":
    app()

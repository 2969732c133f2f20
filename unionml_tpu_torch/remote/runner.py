"""Execution-side entrypoint: rehydrate the app and run one workflow.

The port of :mod:`unionml_tpu.remote.runner`, the analog of the flytekit
container entrypoint + the reference's task resolver (reference:
task_resolver.py:16-31): the runner re-imports the deployed app module,
finds the Model variable, regenerates its compiled stages, and executes
the requested workflow with the recorded inputs.

The runner resolves its device as every entry point of the port does:
the CUDA card, raising without one, unless the stage asked for the CPU
(``chips == 0``: :func:`~unionml_tpu_torch.defaults.resources_env` hides
the card with ``CUDA_VISIBLE_DEVICES=""``). Its log names the device.
On multi-host GPU runs it first brings up :mod:`torch.distributed` from
the ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` env set
by :class:`~unionml_tpu_torch.remote.backend.GPUHostBackend`: ``nccl``
with a card, ``gloo`` on the CPU.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import pickle
import sys
import traceback
from pathlib import Path


def _set_status(exec_dir: Path, status: str):
    # atomic replace: the backend's wait() polls this file concurrently
    record_path = exec_dir / "record.json"
    record = json.loads(record_path.read_text())
    record["status"] = status
    tmp = record_path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(record))
    os.replace(tmp, record_path)


def resolve_runner_device() -> str:
    """``"cuda"``, unless the stage hid the card (``CUDA_VISIBLE_DEVICES=""``,
    the ``chips == 0`` route): then ``"cpu"``, without importing torch (a
    host-only app may never need it). A visible-card stage on a machine
    without one raises, as every entry point of the port does."""
    if os.environ.get("CUDA_VISIBLE_DEVICES") == "":
        return "cpu"
    from unionml_tpu_torch._device import resolve_device

    return resolve_device(None).type


def _init_distributed(device: str) -> bool:
    """``torch.distributed`` bring-up from the launcher's env; ``False``
    for a single-process run (no ``MASTER_ADDR`` or ``WORLD_SIZE`` 1)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if "MASTER_ADDR" not in os.environ or world <= 1:
        return False
    import torch.distributed as dist

    dist.init_process_group(
        backend="nccl" if device == "cuda" else "gloo",
        init_method=(
            f"tcp://{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
        ),
        world_size=world,
        rank=int(os.environ["RANK"]),
    )
    return True


def _load_model_artifact(model, exec_dir: Path, model_version: str):
    """Resolve a model version (execution id or 'latest') from the registry
    and load its artifact into ``model`` (reference: model.py:872-894)."""
    from unionml_tpu_torch.remote.backend import DEFAULT_ROOT_ENV, LocalBackend

    backend = LocalBackend(
        project=os.environ.get("UNIONML_TPU_PROJECT", model.name.replace("_", "-")),
        root=os.environ.get(DEFAULT_ROOT_ENV),
    )
    record = backend.get_model_execution(model, model_version=model_version)
    outputs = backend.fetch_outputs(record)
    from unionml_tpu_torch.model import ModelArtifact
    from unionml_tpu_torch.remote.artifacts import decode_model_object

    model.artifact = ModelArtifact(
        decode_model_object(model, outputs["model_object"]),
        outputs.get("hyperparameters"),
        outputs.get("metrics"),
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--app", required=True, help="module:variable of the Model")
    parser.add_argument("--workflow", required=True,
                        choices=["train", "predict", "predict_from_features"])
    parser.add_argument("--exec-dir", required=True)
    parser.add_argument("--model-version", default="latest")
    args = parser.parse_args(argv)

    exec_dir = Path(args.exec_dir)
    _set_status(exec_dir, "RUNNING")
    distributed = False
    try:
        device = resolve_runner_device()
        if device == "cuda":
            import torch

            print(f"unionml_tpu_torch runner: device cuda "
                  f"({torch.cuda.get_device_name(0)})", flush=True)
        else:
            print("unionml_tpu_torch runner: device cpu", flush=True)
        distributed = _init_distributed(device)

        sys.path.insert(0, os.getcwd())
        module_name, var_name = args.app.split(":")
        module = importlib.import_module(module_name)
        model = getattr(module, var_name)

        with open(exec_dir / "inputs.pkl", "rb") as f:
            inputs = pickle.load(f)

        if args.workflow == "train":
            trainer_kwargs = inputs.pop("trainer_kwargs", None) or {}
            model_object, metrics = model.train(
                hyperparameters=inputs.pop("hyperparameters", None),
                loader_kwargs=inputs.pop("loader_kwargs", None),
                splitter_kwargs=inputs.pop("splitter_kwargs", None),
                parser_kwargs=inputs.pop("parser_kwargs", None),
                trainer_kwargs=trainer_kwargs,
                **inputs,
            )
            outputs = {
                "model_object": model.artifact.model_object,
                "hyperparameters": model.artifact.hyperparameters,
                "metrics": metrics,
            }
        else:
            _load_model_artifact(model, exec_dir, args.model_version)
            features = inputs.pop("features", None)
            predictions = model.predict(features=features, **inputs)
            outputs = {"predictions": predictions}

        # only rank 0 writes outputs on multi-host runs
        if int(os.environ.get("RANK", "0")) == 0:
            from unionml_tpu_torch.remote.artifacts import dump_outputs

            with open(exec_dir / "outputs.pkl", "wb") as f:
                # a train state that does not pickle falls back to the
                # app's saver bytes
                dump_outputs(model, outputs, f)
            _set_status(exec_dir, "SUCCEEDED")
        return 0
    except Exception:
        traceback.print_exc()
        _set_status(exec_dir, "FAILED")
        return 1
    finally:
        if distributed:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())

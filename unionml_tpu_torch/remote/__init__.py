"""Remote backend: app packaging, versioned deploys, executions, registry.

The port of :mod:`unionml_tpu.remote` (capability parity with reference
unionml/remote.py:24-218 without Flyte):

- **App versioning** from git SHA with a dirty-tree guard
  (:func:`get_app_version`; reference remote.py:43-57), patch versions for
  fast source-only redeploys (reference remote.py:126-138).
- **Deploy** = package the app source into a versioned deployment directory
  (the container-image analog; reference remote.py:69-147).
- **Execute** = run a workflow in a separate process (the container
  boundary) that **rehydrates** the app by re-importing the app module and
  regenerating its stages — the reference's task-resolver trick
  (reference task_resolver.py:16-31).
- **Registry = execution history**: a model version is a SUCCEEDED train
  execution id; ``latest``-or-pinned fetch (reference remote.py:150-218).

Backends: :class:`~unionml_tpu_torch.remote.backend.LocalBackend`
(subprocess sandbox, the flytectl-sandbox analog used by tests) and
:class:`~unionml_tpu_torch.remote.backend.GPUHostBackend` (SSH control
plane to GPU hosts with :mod:`torch.distributed` multi-host bring-up).
"""

from unionml_tpu_torch.remote.backend import (
    ExecutionRecord,
    GPUHostBackend,
    LocalBackend,
    get_backend,
)
from unionml_tpu_torch.remote.packaging import (
    VersionFetchError,
    build_environment_bundle,
    get_app_version,
    package_source,
    patch_suffix,
    pinned_requirements,
)


def get_model(app: str, reload: bool = False):
    """Load a Model from an ``"module:variable"`` string
    (reference: remote.py:28-33)."""
    import importlib

    module_name, var = app.split(":")
    module = importlib.import_module(module_name)
    if reload:
        importlib.reload(module)
    return getattr(module, var)


def load_latest_artifact(model, app_version=None, model_version: str = "latest"):
    """Fetch a model artifact from the execution registry into
    ``model.artifact`` (reference: remote.py:186-194 + model.py:872-894)."""
    backend = model._remote
    execution = backend.get_model_execution(
        model, app_version=app_version, model_version=model_version
    )
    return model.remote_load(execution)


__all__ = [
    "ExecutionRecord",
    "GPUHostBackend",
    "LocalBackend",
    "get_backend",
    "VersionFetchError",
    "build_environment_bundle",
    "pinned_requirements",
    "get_app_version",
    "package_source",
    "patch_suffix",
    "get_model",
    "load_latest_artifact",
]

"""unionml_tpu_torch: the PyTorch/CUDA port of unionml_tpu.

The same declarative ML-microservice surface — user functions registered
on :class:`Dataset` / :class:`Model` compile into named, cached stages,
and the serving tier batches requests onto the device — written in
PyTorch for an NVIDIA H100, with the TPU package's Pallas kernels
rewritten by hand for Hopper (``csrc/``). Modules mirror
``unionml_tpu``'s relative paths and names; the port imports neither JAX
nor ``unionml_tpu``. ROADMAP.md lists what is ported so far.
"""

from unionml_tpu_torch.dataset import Dataset
from unionml_tpu_torch.model import BaseHyperparameters, Model, ModelArtifact

try:  # single-source the version from package metadata when installed
    from importlib.metadata import version as _version

    __version__ = _version("unionml_tpu")
except Exception:  # pragma: no cover - not installed as a distribution
    __version__ = "0.1.0"

__all__ = [
    "Dataset",
    "Model",
    "ModelArtifact",
    "BaseHyperparameters",
    "__version__",
]

"""Default resources applied to every generated stage.

Reference: unionml/defaults.py:5 (``DEFAULT_RESOURCES = Resources(cpu="1",
mem="1Gi")``), where Resources constrain the Flyte task container. The
port's resource model adds an accelerator request: ``chips`` is the
number of CUDA cards a stage asks for (0 = host-only stage).

Resources are CONSUMED at launch (not decorative): the remote backends
derive the runner's environment from the executed workflow's resource
maxima via :func:`resources_env` — a ``chips=0`` workflow runs with
``CUDA_VISIBLE_DEVICES=""`` (a host-only stage never sees the card a
co-tenant serving process is using, and a tensor it creates with
``device=None`` raises instead of landing on the card), and ``cpu`` caps
the host math threadpools. ``mem`` is advisory on GPU hosts (no container
boundary to enforce it; it documents the expected host footprint and is
recorded in the deploy manifest for schedulers that can act on it).
"""

from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class Resources:
    """Resource request attached to a compiled stage."""

    cpu: str = "1"
    mem: str = "1Gi"
    chips: int = 0
    accelerator: Optional[str] = None  # e.g. "nvidia-h100-80gb"


def cpu_count(resources: "Resources") -> int:
    """Parse the k8s-style cpu request to a whole host-thread count
    (fractional requests round UP: "500m" → 1, "1500m" → 2)."""
    import math

    raw = str(resources.cpu).strip()
    try:
        value = float(raw[:-1]) / 1000.0 if raw.endswith("m") else float(raw)
    except ValueError:
        return 1
    return max(1, math.ceil(value))


def resources_env(resources: "Resources") -> Dict[str, str]:
    """Launch-environment derivation — the consumer that makes a
    resource request real on a GPU host (reference parity anchor:
    unionml/defaults.py:5, where Resources size the task container):

    - ``chips == 0`` → ``CUDA_VISIBLE_DEVICES=""``: host-only workflows
      (data prep, registry ops) must not see the card, create a CUDA
      context on it, or take a serving process's device memory;
    - ``cpu`` → ``OMP_NUM_THREADS`` / ``OPENBLAS_NUM_THREADS`` host
      threadpool caps (oversubscribed BLAS threads stall the input
      pipeline).
    """
    env = {
        "OMP_NUM_THREADS": str(cpu_count(resources)),
        "OPENBLAS_NUM_THREADS": str(cpu_count(resources)),
    }
    if resources.chips == 0:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return env


DEFAULT_RESOURCES = Resources(cpu="1", mem="1Gi", chips=0)
DEFAULT_DEVICE_RESOURCES = Resources(
    cpu="4", mem="8Gi", chips=1, accelerator="nvidia-h100-80gb"
)

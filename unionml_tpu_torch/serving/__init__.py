"""Serving tier of the port: the ported modules only.

- :mod:`~unionml_tpu_torch.serving.batcher` — the micro-batcher that
  coalesces concurrent requests into one device call;
- :mod:`~unionml_tpu_torch.serving.http` — the stdlib HTTP transport
  (``ServingApp``: ``/predict``, ``/health``, ``/metrics``, ``/stats``);
- :mod:`~unionml_tpu_torch.serving.faults`,
  :mod:`~unionml_tpu_torch.serving.scheduler`,
  :mod:`~unionml_tpu_torch.serving.usage` — the fault, priority and
  usage vocabularies the transport speaks.

The decode engine, prefix cache, router and the rest of the reference's
serving tier are not ported yet (ROADMAP.md).
"""

from unionml_tpu_torch.serving.batcher import MicroBatcher
from unionml_tpu_torch.serving.faults import (
    DeadlineExceeded,
    EngineUnavailable,
    FaultInjector,
    Overloaded,
    deadline_scope,
)
from unionml_tpu_torch.serving.http import ServingApp, create_app

__all__ = [
    "MicroBatcher",
    "ServingApp",
    "create_app",
    "DeadlineExceeded",
    "EngineUnavailable",
    "FaultInjector",
    "Overloaded",
    "deadline_scope",
]

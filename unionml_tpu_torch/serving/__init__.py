"""Serving tier of the port: the ported modules only.

- :mod:`~unionml_tpu_torch.serving.engine` — the continuous-batching
  ``DecodeEngine`` (contiguous and block-paged KV);
- :mod:`~unionml_tpu_torch.serving.kv_pool` — the paged pool's host
  allocator (``KVBlockPool``, ``PoolExhausted``);
- :mod:`~unionml_tpu_torch.serving.prefix_cache` — cross-request
  prompt-prefix reuse (``RadixPrefixCache``): a radix tree of KV blocks in
  a byte-budgeted host store; engine admissions splice the longest cached
  prefix and prefill only the uncovered suffix;
- :mod:`~unionml_tpu_torch.serving.perf` — the serving goodput plane;
- :mod:`~unionml_tpu_torch.serving.batcher` — the micro-batcher that
  coalesces concurrent requests into one device call;
- :mod:`~unionml_tpu_torch.serving.http` — the stdlib HTTP transport
  (``ServingApp``: ``/predict``, ``/health``, ``/metrics``, ``/stats``);
- :mod:`~unionml_tpu_torch.serving.faults`,
  :mod:`~unionml_tpu_torch.serving.scheduler`,
  :mod:`~unionml_tpu_torch.serving.usage` — the fault, priority and
  usage vocabularies the transport speaks.

The router and the rest of the reference's serving tier are not ported
yet (ROADMAP.md).
"""

from unionml_tpu_torch.serving.batcher import MicroBatcher
from unionml_tpu_torch.serving.engine import DecodeEngine
from unionml_tpu_torch.serving.faults import (
    DeadlineExceeded,
    EngineUnavailable,
    FaultInjector,
    Overloaded,
    deadline_scope,
)
from unionml_tpu_torch.serving.http import ServingApp, create_app
from unionml_tpu_torch.serving.kv_pool import KVBlockPool, PoolExhausted
from unionml_tpu_torch.serving.prefix_cache import RadixPrefixCache

__all__ = [
    "DecodeEngine",
    "KVBlockPool",
    "MicroBatcher",
    "PoolExhausted",
    "RadixPrefixCache",
    "ServingApp",
    "create_app",
    "DeadlineExceeded",
    "EngineUnavailable",
    "FaultInjector",
    "Overloaded",
    "deadline_scope",
]

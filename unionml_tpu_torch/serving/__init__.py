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
  usage vocabularies the transport speaks;
- :mod:`~unionml_tpu_torch.serving.router` — the cluster front door
  (``FleetRouter`` over ``EngineReplica`` / ``HttpReplica``: prefix
  locality, retry budget, hedging, ejection and half-open rejoin, the
  fleet timeline; ``make_router_app``);
- :mod:`~unionml_tpu_torch.serving.autoscaler` — the closed loop that
  adds and drains replicas (``FleetAutoscaler`` and its provisioners);
- :mod:`~unionml_tpu_torch.serving.disagg` — disaggregated prefill /
  decode (``DisaggRouter``: prefill leg, KV handoff, decode leg);
- :mod:`~unionml_tpu_torch.serving.auto` — the engine-vs-batcher mode
  choice from measured round trip and decode-chunk times;
- :mod:`~unionml_tpu_torch.serving.rollout` — versioned rollouts
  (``VersionRegistry`` on the port's checkpoints, ``RolloutController``:
  canary pools, exact shadow diffs, promote and SLO-guarded rollback);
- :mod:`~unionml_tpu_torch.serving.serverless` — API-Gateway and
  object-store event handlers over ``ServingApp``;
- :mod:`~unionml_tpu_torch.serving.fastapi` — the FastAPI mount
  (``serving_app``; fastapi is imported only when an app is given).
"""

from unionml_tpu_torch.serving.autoscaler import (
    AutoscalerPolicy,
    EngineReplicaProvisioner,
    FleetAutoscaler,
    HttpReplicaProvisioner,
    ReplicaProvisioner,
)

from unionml_tpu_torch.serving.batcher import MicroBatcher
from unionml_tpu_torch.serving.disagg import DisaggRouter
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
from unionml_tpu_torch.serving.router import (
    EngineReplica,
    FleetRouter,
    HttpReplica,
    ReplicaHandle,
    RouterPolicy,
    make_router_app,
)
from unionml_tpu_torch.serving.scheduler import (
    PHASES,
    PRIORITIES,
    PreemptiveScheduler,
    SchedulerConfig,
    WaitingRoom,
    current_priority,
    priority_scope,
    token_cap_scope,
    validate_phase,
    validate_priority,
)
from unionml_tpu_torch.serving.usage import (
    UsageLedger,
    current_tenant,
    tenant_scope,
    validate_tenant,
)

__all__ = [
    "AutoscalerPolicy", "DeadlineExceeded", "DecodeEngine",
    "DisaggRouter", "EngineReplica", "EngineReplicaProvisioner",
    "EngineUnavailable", "FaultInjector", "FleetAutoscaler",
    "FleetRouter", "HttpReplica", "HttpReplicaProvisioner",
    "KVBlockPool", "MicroBatcher", "Overloaded", "PHASES", "PRIORITIES",
    "PoolExhausted", "PreemptiveScheduler", "RadixPrefixCache",
    "ReplicaHandle", "ReplicaProvisioner", "RouterPolicy",
    "SchedulerConfig", "ServingApp", "UsageLedger", "WaitingRoom",
    "create_app", "current_priority", "current_tenant",
    "deadline_scope", "make_router_app", "priority_scope",
    "tenant_scope", "token_cap_scope", "validate_phase",
    "validate_priority", "validate_tenant",
]

"""Online serving (counterpart of ``keystone_tpu/serve``): a frozen
fitted pipeline behind a micro-batching :class:`PipelineService` over a
threaded, process or network replica fleet, with an HTTP front end, a
binary ingress, fleet telemetry and the model lifecycle around it.

- :mod:`~keystone_tpu_torch.serve.service` — ``serve``,
  ``PipelineService``, admission control, padding buckets, deadline
  shedding, poison bisection, hedging, blue/green ``swap``,
  slab-direct admission;
- :mod:`~keystone_tpu_torch.serve.fleet` — ``ReplicaPool`` (the
  least-outstanding router, one CUDA stream a thread replica, the
  artifact bundle each replica captures its bucket graphs from; the
  thread, process and network backends) and ``ReplicaSupervisor``
  (self-healing);
- :mod:`~keystone_tpu_torch.serve.wire` — control frames, shared-memory
  slabs, admission blocks, stream frames;
- :mod:`~keystone_tpu_torch.serve.worker` /
  :mod:`~keystone_tpu_torch.serve.procfleet` — the worker process and
  its router-side handle and replica;
- :mod:`~keystone_tpu_torch.serve.net` — the TCP fleet: listener,
  deploy, lease and heartbeat, ``run_worker``;
- :mod:`~keystone_tpu_torch.serve.telemetry` — worker spans, metric
  deltas and kernel reports, and the router's sink;
- :mod:`~keystone_tpu_torch.serve.ingress` — ``AsyncIngress`` (binary
  batch frames and HTTP on one port), ``BinaryClient``;
- :mod:`~keystone_tpu_torch.serve.registry` — ``ModelRegistry`` (versions,
  ``CURRENT``, the ``BAD`` quarantine mark, artifact bundles) and
  ``RegistryWatcher`` (``--watch``);
- :mod:`~keystone_tpu_torch.serve.rollout` — guarded canary rollouts with
  a judge, a post-commit bake and automatic rollback;
- :mod:`~keystone_tpu_torch.serve.autoscale` — the SLO-driven autoscaler;
- :mod:`~keystone_tpu_torch.serve.tenants` — ``serve_multi``,
  ``MultiTenantService`` and ``MultiTenantApplier``: N tenants behind one
  batcher and fleet, their shared prefix computed once a combined flush
  through the shared stage pool (``workflow/stage_pool.py``);
- :mod:`~keystone_tpu_torch.serve.http` — ``HttpFrontend`` / ``serve_http``.

``import keystone_tpu_torch`` does not import this package.
"""

from keystone_tpu_torch.serve.autoscale import AutoscalePolicy, Autoscaler, Signals
from keystone_tpu_torch.serve.fleet import FleetUnavailable, Replica, ReplicaPool, ReplicaSupervisor
from keystone_tpu_torch.serve.http import HttpFrontend, serve_http
from keystone_tpu_torch.serve.ingress import AsyncIngress, BinaryClient, IngressError, serve_ingress
from keystone_tpu_torch.serve.net import (
    ConnectRetriesExhausted,
    NetReplica,
    NetWorkerHandle,
    WorkerListener,
    run_worker,
)
from keystone_tpu_torch.serve.procfleet import (
    ProcessReplica,
    RemoteApplier,
    WorkerCrashed,
    WorkerHandle,
    WorkerSpawnError,
)
from keystone_tpu_torch.serve.registry import ModelRegistry, RegistryError, RegistryWatcher, write_artifact_bundle
from keystone_tpu_torch.serve.rollout import CanaryController, RollbackGuard, RolloutConfig, canary_hash, guarded_swap
from keystone_tpu_torch.serve.service import (
    Overloaded,
    PipelineService,
    PoisonRequest,
    ServiceClosed,
    default_buckets,
    serve,
)
from keystone_tpu_torch.serve.telemetry import ClockSync, FleetTelemetry, WorkerTelemetry, clamp_span
from keystone_tpu_torch.serve.tenants import MultiTenantApplier, MultiTenantService, UnknownTenant, serve_multi
from keystone_tpu_torch.workflow.stage_pool import SharedStagePool

__all__ = [
    "AsyncIngress",
    "AutoscalePolicy",
    "Autoscaler",
    "BinaryClient",
    "CanaryController",
    "ClockSync",
    "ConnectRetriesExhausted",
    "FleetTelemetry",
    "FleetUnavailable",
    "HttpFrontend",
    "IngressError",
    "ModelRegistry",
    "MultiTenantApplier",
    "MultiTenantService",
    "NetReplica",
    "NetWorkerHandle",
    "Overloaded",
    "PipelineService",
    "PoisonRequest",
    "ProcessReplica",
    "RegistryError",
    "RegistryWatcher",
    "RemoteApplier",
    "Replica",
    "ReplicaPool",
    "ReplicaSupervisor",
    "RollbackGuard",
    "RolloutConfig",
    "ServiceClosed",
    "SharedStagePool",
    "Signals",
    "WorkerCrashed",
    "WorkerHandle",
    "WorkerListener",
    "WorkerSpawnError",
    "UnknownTenant",
    "WorkerTelemetry",
    "canary_hash",
    "clamp_span",
    "default_buckets",
    "guarded_swap",
    "run_worker",
    "serve",
    "serve_http",
    "serve_ingress",
    "serve_multi",
    "write_artifact_bundle",
]

"""Online serving (counterpart of ``keystone_tpu/serve``, its
single-process path): a frozen fitted pipeline behind a micro-batching
:class:`PipelineService` over a threaded replica fleet, with an HTTP
front end and the model lifecycle around it.

- :mod:`~keystone_tpu_torch.serve.service` — ``serve``,
  ``PipelineService``, admission control, padding buckets, deadline
  shedding, poison bisection, hedging, blue/green ``swap``;
- :mod:`~keystone_tpu_torch.serve.fleet` — ``ReplicaPool`` (the
  least-outstanding router, one CUDA stream a replica, the artifact
  bundle each replica captures its bucket graphs from) and
  ``ReplicaSupervisor`` (self-healing);
- :mod:`~keystone_tpu_torch.serve.registry` — ``ModelRegistry`` (versions,
  ``CURRENT``, the ``BAD`` quarantine mark, artifact bundles) and
  ``RegistryWatcher`` (``--watch``);
- :mod:`~keystone_tpu_torch.serve.rollout` — guarded canary rollouts with
  a judge, a post-commit bake and automatic rollback;
- :mod:`~keystone_tpu_torch.serve.autoscale` — the SLO-driven autoscaler;
- :mod:`~keystone_tpu_torch.serve.http` — ``HttpFrontend`` / ``serve_http``.

``import keystone_tpu_torch`` does not import this package.  Still to
port (ROADMAP): the process and network fleets and the binary ingress
(A11c); tenants, the shared stage pool and fleet telemetry (A11d).
"""

from keystone_tpu_torch.serve.autoscale import AutoscalePolicy, Autoscaler, Signals
from keystone_tpu_torch.serve.fleet import FleetUnavailable, Replica, ReplicaPool, ReplicaSupervisor
from keystone_tpu_torch.serve.http import HttpFrontend, serve_http
from keystone_tpu_torch.serve.registry import ModelRegistry, RegistryError, RegistryWatcher, write_artifact_bundle
from keystone_tpu_torch.serve.rollout import CanaryController, RollbackGuard, RolloutConfig, canary_hash, guarded_swap
from keystone_tpu_torch.serve.service import (
    Overloaded,
    PipelineService,
    PoisonRequest,
    RowBlock,
    ServiceClosed,
    default_buckets,
    serve,
)

__all__ = [
    "AutoscalePolicy",
    "Autoscaler",
    "CanaryController",
    "FleetUnavailable",
    "HttpFrontend",
    "ModelRegistry",
    "Overloaded",
    "PipelineService",
    "PoisonRequest",
    "RegistryError",
    "RegistryWatcher",
    "Replica",
    "ReplicaPool",
    "ReplicaSupervisor",
    "RollbackGuard",
    "RolloutConfig",
    "RowBlock",
    "ServiceClosed",
    "Signals",
    "canary_hash",
    "default_buckets",
    "guarded_swap",
    "serve",
    "serve_http",
    "write_artifact_bundle",
]

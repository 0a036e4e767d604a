"""Online serving (counterpart of ``keystone_tpu/serve``, its
single-process path): a frozen fitted pipeline behind a micro-batching
:class:`PipelineService` over a threaded replica fleet, with an HTTP
front end.

- :mod:`~keystone_tpu_torch.serve.service` — ``serve``,
  ``PipelineService``, admission control, padding buckets, deadline
  shedding, poison bisection, hedging, blue/green ``swap``;
- :mod:`~keystone_tpu_torch.serve.fleet` — ``ReplicaPool`` (the
  least-outstanding router, one CUDA stream a replica) and
  ``ReplicaSupervisor`` (self-healing);
- :mod:`~keystone_tpu_torch.serve.http` — ``HttpFrontend`` / ``serve_http``.

``import keystone_tpu_torch`` does not import this package.  Still to
port (ROADMAP): the model registry, its watcher and AOT artifacts (A11b);
the process and network fleets and the binary ingress (A11c); tenants,
guarded rollouts, autoscaling and fleet telemetry (A11d).
"""

from keystone_tpu_torch.serve.fleet import FleetUnavailable, Replica, ReplicaPool, ReplicaSupervisor
from keystone_tpu_torch.serve.http import HttpFrontend, serve_http
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
    "FleetUnavailable",
    "HttpFrontend",
    "Overloaded",
    "PipelineService",
    "PoisonRequest",
    "Replica",
    "ReplicaPool",
    "ReplicaSupervisor",
    "RowBlock",
    "ServiceClosed",
    "default_buckets",
    "serve",
    "serve_http",
]

"""Multi-process jobs over ``torch.distributed`` (counterpart of
``keystone_tpu/parallel/multihost.py`` § SickHostError,
_transient_init_error, initialize, health_barrier, maybe_health_barrier,
hybrid_mesh, process_batch_slice, gather_to_host, global_from_host,
global_rows_from_local, make_global_dataset).

The reference scales by adding Spark executors over ethernet; the port
runs one process a card, NCCL between cards and Gloo on the CPU.  On
each process of a job (or under ``torchrun``, which sets the variables):

    from keystone_tpu_torch.parallel import multihost, set_mesh
    multihost.initialize("host0:29500", num_processes=N, process_id=i)
    set_mesh(multihost.hybrid_mesh(model_parallelism=1))

After that the parallel solvers (``LinearMapEstimator``, the BCD fits,
``DistributedPCAEstimator``, the L-BFGS fits) run unchanged: each rank
feeds its own row slice (``process_batch_slice``, ``make_global_dataset``)
and the row sums all-reduce over the data axis.  Device tensors go
through the default group; small host values (ok-bits, digests, row
counts) through one Gloo side group made at ``initialize``.
"""

from __future__ import annotations

import datetime
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from keystone_tpu_torch.parallel import mesh as _mesh

logger = logging.getLogger(__name__)

ENV_HEALTH_TIMEOUT = "KEYSTONE_HEALTH_TIMEOUT"

#: the process groups' timeout when ``initialize`` is given none: a peer
#: that died inside a collective fails the survivors' call after this
#: many seconds instead of parking them for good
DEFAULT_TIMEOUT_S = 300

_SIDE: dict = {"group": None}


class SickHostError(RuntimeError):
    """A peer reported unhealthy at a :func:`health_barrier`: the job must
    abort *together* (collectives are SPMD; continuing without the sick
    rank would deadlock the healthy ones).  Deliberately not an
    ``OSError``: in-process retry cannot heal a dead peer, job-level
    restart (with checkpoint resume) owns recovery."""


#: substrings marking a RuntimeError as connection-shaped, i.e. worth
#: the retry/backoff budget (the reference's list).  The rendezvous
#: surfaces both transient races and deterministic config errors as
#: RuntimeError; only the former should burn backoff time.
_TRANSIENT_INIT_MARKERS = (
    "connect",
    "connection",
    "unavailable",
    "timed out",
    "timeout",
    "deadline",
    "refused",
    "reset",
    "barrier",
    "coordinator",
    "heartbeat",
    "grpc",
    "socket",
    "temporar",  # temporary/temporarily
    "again",  # EAGAIN-style "try again"
)


def _transient_init_error(e: BaseException) -> bool:
    """Should the init retry loop absorb ``e``?  OSErrors (injected faults
    among them) and ConnectionErrors: always.  Other errors: only when the
    message looks connection-shaped; a deterministic config error (a bad
    rank, a world size that disagrees) fails fast."""
    if isinstance(e, (OSError, ConnectionError)):
        return True
    msg = str(e).lower()
    return any(m in msg for m in _TRANSIENT_INIT_MARKERS)


def choose_backend(backend: Optional[str] = None, device="cuda") -> str:
    """The default group's backend: the caller's, else NCCL when the
    device is the card and Gloo when the caller asked for the CPU.  A card
    that is not there raises (``resolve_device``): nothing falls back to
    Gloo."""
    from keystone_tpu_torch.utils.device import resolve_device

    if backend is not None:
        return str(backend)
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def _configured(coordinator_address, num_processes) -> bool:
    return not (coordinator_address is None and num_processes is None
                and os.environ.get("MASTER_ADDR") is None and os.environ.get("WORLD_SIZE") is None)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    retries: Optional[int] = None,
    initialization_timeout: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
) -> None:
    """``torch.distributed.init_process_group`` over a ``tcp://``
    rendezvous at ``coordinator_address`` ("host:port").  Arguments left
    None come from torchrun's variables (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``).  A no-op when a group is already
    initialized, or when no coordinator is configured (plain
    single-process use).

    ``backend=None`` is NCCL on the card and Gloo when ``device`` is the
    CPU (``choose_backend``); Gloo on CUDA tensors only when named.  On
    the card each rank takes device ``LOCAL_RANK`` (else its rank) modulo
    the cards it sees.  ``initialization_timeout`` (seconds, default
    ``DEFAULT_TIMEOUT_S``) bounds the rendezvous and every collective
    after it, and NCCL's async error handling is on, so a dead peer
    fails its survivors' collectives instead of hanging them.

    Hardened as the reference's: the connect retries with exponential
    backoff and jitter (``retries=None`` reads ``KEYSTONE_INIT_RETRIES``,
    default 2), only for connection-shaped errors
    (``_transient_init_error``); each attempt fires the ``multihost.init``
    fault site and counts ``multihost.init_attempts``, and a half-made
    group is destroyed before the next.  The whole takes
    ``multihost.init_seconds`` and a ``multihost.init`` ledger event.
    Afterwards the Gloo side group exists and the mesh is the world's."""
    import torch.distributed as dist

    from keystone_tpu_torch.faults import fault_point
    from keystone_tpu_torch.obs import ledger, metrics
    from keystone_tpu_torch.utils import durable

    if dist.is_initialized():
        return
    if not _configured(coordinator_address, num_processes):
        logger.debug("no coordinator configured; staying single-process")
        return
    if coordinator_address is None:
        coordinator_address = f"{os.environ.get('MASTER_ADDR', '127.0.0.1')}:{os.environ.get('MASTER_PORT', '29500')}"
    world = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else os.environ["RANK"])
    backend = choose_backend(backend, device)
    if retries is None:
        retries = durable._env_int("KEYSTONE_INIT_RETRIES", 2)
    timeout = datetime.timedelta(seconds=int(initialization_timeout or DEFAULT_TIMEOUT_S))
    if backend == "nccl":
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    t0 = time.perf_counter()

    def _init():
        metrics.inc("multihost.init_attempts")
        fault_point("multihost.init")
        try:
            dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=world,
                                    rank=rank, timeout=timeout)
        except Exception:
            # a failed rendezvous may leave a default group behind: the
            # retry must make a new one, and the error raised is the real one
            if dist.is_initialized():
                try:
                    dist.destroy_process_group()
                except Exception:
                    logger.debug("destroying a half-made group failed", exc_info=True)
            raise

    durable.with_retries(_init, retries=retries, base_delay=0.5, max_delay=10.0,
                         retry_on=(OSError, ConnectionError, RuntimeError), retry_if=_transient_init_error,
                         description="distributed init")
    _SIDE["group"] = dist.group.WORLD if backend == "gloo" else dist.new_group(backend="gloo", timeout=timeout)
    _mesh.reset()
    dt = time.perf_counter() - t0
    metrics.observe("multihost.init_seconds", dt)
    ledger.event("multihost.init", seconds=dt, backend=backend, world=world, rank=rank)


def shutdown() -> None:
    """Destroy the job's groups (every rank calls it at the end); the
    mesh goes back to local."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _SIDE["group"] = None
    _mesh.reset()


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if _mesh.world_size() else 0


def _side_group():
    import torch.distributed as dist

    return _SIDE["group"] if _SIDE["group"] is not None else dist.group.WORLD


def _as_bytes(a: np.ndarray) -> torch.Tensor:
    """A host array's bytes as a uint8 tensor, which Gloo takes whatever
    the array's dtype (it refuses uint64, the digests' type)."""
    return torch.from_numpy(np.ascontiguousarray(a).reshape(-1).view(np.uint8).copy())


def _host_all_gather(a: np.ndarray) -> np.ndarray:
    """Every rank's host array (equal shapes), stacked in rank order, over
    the Gloo side group."""
    import torch.distributed as dist

    a = np.ascontiguousarray(a)
    t = _as_bytes(a)
    parts = [torch.empty_like(t) for _ in range(_mesh.world_size())]
    dist.all_gather(parts, t, group=_side_group())
    return np.stack([p.numpy().view(a.dtype).reshape(a.shape) for p in parts])


def broadcast_host(arrays, src: int = 0) -> list:
    """Rank ``src``'s host arrays on every rank, over the Gloo side group;
    the other ranks pass arrays of the same shapes and dtypes (their
    values are replaced).  At a world of one: the arrays as they are."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    if _mesh.world_size() <= 1:
        return arrays
    import torch.distributed as dist

    from keystone_tpu_torch.parallel import collectives

    out = []
    for a in arrays:
        t = _as_bytes(a)
        collectives._count("broadcast", "world")
        dist.broadcast(t, src, group=_side_group())
        out.append(t.numpy().view(a.dtype).reshape(a.shape))
    return out


def health_barrier(ok: bool = True, timeout: Optional[float] = None, tag: str = "health") -> bool:
    """All-gather one ok-bit a rank over the Gloo side group, under a
    watchdog (``guard.run_with_deadline`` at site ``multihost.health``).

    The multi-process failure mode stage retry cannot cover: one rank
    goes sick while its peers park forever inside the next collective.
    Called at natural sync points (epoch boundaries, restart attempts)
    it turns that deadlock into a clean, *collective* abort: every rank
    sees the sick rank's 0-bit and raises :class:`SickHostError` (and
    counts ``multihost.sick_hosts``); a rank too dead to join trips the
    ``timeout`` watchdog instead (``guard.DeadlineExceeded``).  At a
    world of one: an immediate ``True``.  Pass ``ok=False`` on a rank
    that knows it is failing."""
    if _mesh.world_size() <= 1:
        return True
    from keystone_tpu_torch.obs import ledger, metrics
    from keystone_tpu_torch.utils import guard

    deadline = None if timeout is None else guard.Deadline.after(float(timeout))
    bits = guard.run_with_deadline(lambda: _host_all_gather(np.asarray([1 if ok else 0], np.int32)), deadline,
                                   site="multihost.health", tag=tag)
    sick = [i for i, b in enumerate(bits.reshape(-1).tolist()) if not b]
    if sick:
        metrics.inc("multihost.sick_hosts", tag=tag)
        ledger.event("multihost.sick_host", tag=tag, sick=sick)
        raise SickHostError(f"rank(s) {sick} reported unhealthy at the {tag!r} barrier; aborting collectively "
                            "(restart the job to resume from checkpoints)")
    return True


def maybe_health_barrier(tag: str, ok: bool = True) -> bool:
    """Env-gated :func:`health_barrier` for hook sites (epoch drivers,
    recovery attempts): inert unless ``KEYSTONE_HEALTH_TIMEOUT`` is a
    positive number AND the world is above one; otherwise one env lookup."""
    from keystone_tpu_torch.utils.guard import env_float

    timeout = env_float(ENV_HEALTH_TIMEOUT)
    if timeout is None or _mesh.world_size() <= 1:
        return True
    return health_barrier(ok=ok, timeout=timeout, tag=tag)


def hybrid_mesh(model_parallelism: int = 1) -> _mesh.Mesh:
    """The (data, model) mesh with each model group inside one node: the
    model axis's collectives (the class-column gathers) stay on NVLink,
    the data axis's all-reduces may cross nodes.  torchrun numbers ranks
    node by node, ``LOCAL_WORLD_SIZE`` to a node, so consecutive model
    groups stay inside a node when that count is a multiple of the model
    axis."""
    mp = int(model_parallelism)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", max(1, _mesh.world_size())))
    if local % mp:
        raise ValueError(f"{local} ranks a node not divisible by model_parallelism={mp}: a model group would "
                         "span nodes")
    return _mesh.default_mesh(mp)


def process_batch_slice(global_n: int, mesh: Optional[_mesh.Mesh] = None) -> slice:
    """The [start, stop) of the global rows this rank should load: its
    data index's slice (the ranks of one data index load the same rows)."""
    mesh = mesh or _mesh.current_mesh()
    return _mesh.slice_rows(int(global_n), mesh.data, mesh.data_index)


def gather_to_host(arr, placement: Optional[_mesh.Placement] = None,
                   mesh: Optional[_mesh.Mesh] = None) -> np.ndarray:
    """A full host copy.  At a world of one: plain ``numpy``.  Above it the
    semantics fork by input type, and both are load-bearing:

    - a tensor → ONE full copy of the global value on every rank: its
      row slices (``placement`` rows, the default) gathered over 'data'
      in rank order, padding rows where each slice has them, and its
      ``model_dim`` gathered over 'model'; a ``replicated`` tensor is
      copied as it is (the checkpoint save path of sharded solver state);
    - a host array (or other host value) → every rank's value
      CONCATENATED along axis 0 over the world: a P-rank call with a (k,)
      input returns (P·k,) (the cross-rank digests of the checkpointed
      fits compare per-rank hashes with it).

    Every rank must call it (it is a collective)."""
    from keystone_tpu_torch.parallel import collectives

    if not isinstance(arr, torch.Tensor):
        a = np.asarray(arr)
        if _mesh.world_size() <= 1:
            return a
        g = _host_all_gather(np.atleast_1d(a))
        return g.reshape((-1,) + g.shape[2:])
    placement = placement or _mesh.data_sharding(ndim=arr.ndim)
    if placement.kind == "rows":
        arr = collectives.all_gather(arr, _mesh.DATA_AXIS, 0, mesh)
        if placement.model_dim is not None:
            arr = collectives.all_gather(arr, _mesh.MODEL_AXIS, placement.model_dim, mesh)
    return arr.detach().cpu().numpy()


def global_from_host(host_array, placement: _mesh.Placement, device=None,
                     mesh: Optional[_mesh.Mesh] = None) -> torch.Tensor:
    """This rank's part of a full host copy present on EVERY rank, as
    ``placement`` lays it out: the checkpoint-restore inverse of
    :func:`gather_to_host` (a rows placement's host copy is the gathered
    layout, slices of equal padded length).  ``device``: None is the card."""
    from keystone_tpu_torch.utils.device import resolve_device

    mesh = mesh or _mesh.current_mesh()
    t = torch.as_tensor(np.asarray(host_array))
    if placement.kind == "rows":
        t = _mesh.axis_part(t, 0, mesh.data, mesh.data_index)
        if placement.model_dim is not None:
            t = _mesh.axis_part(t, placement.model_dim, mesh.model, mesh.model_index)
    return t.to(resolve_device() if device is None else device)


def global_rows_from_local(x_local, device=None) -> torch.Tensor:
    """THIS rank's row slice as its part of a row-sharded tensor: the
    staging primitive of per-rank out-of-core stores (each rank spills
    and reads back only its rows, so no rank holds the full matrix).  In
    the port the part is the tensor itself, on ``device`` (None keeps a
    tensor where it is and puts numpy on the card)."""
    from keystone_tpu_torch.utils.device import resolve_device

    is_tensor = isinstance(x_local, torch.Tensor)
    t = torch.as_tensor(x_local)
    if device is None and not is_tensor:
        device = resolve_device()
    return t if device is None else t.to(device)


def data_axis_sum(value: int, mesh: Optional[_mesh.Mesh] = None) -> int:
    """An integer summed over the data axis (one rank per data index
    counts; its model-axis peers hold the same rows), on the side group."""
    mesh = mesh or _mesh.current_mesh()
    if _mesh.world_size() <= 1:
        return int(value)
    vals = _host_all_gather(np.asarray([int(value)], np.int64)).reshape(-1)
    return int(sum(vals[r] for r in range(len(vals)) if r % mesh.model == 0))


def make_global_dataset(host_array, global_n: Optional[int] = None, device=None,
                        mesh: Optional[_mesh.Mesh] = None):
    """A Dataset of THIS rank's rows, for a job whose ranks each load
    their own slice (``process_batch_slice``): the rows zero-padded to
    ``ceil(global_n / data)`` so that every rank holds the same count,
    the Dataset's ``n`` the global count and its ``rank_rows`` the
    slice's own.  ``global_n=None`` sums the slices over the data axis.
    A list of host objects (scipy sparse rows) is kept as it is.  On the
    local mesh: a plain Dataset.  ``device``: as ``Dataset``'s."""
    from keystone_tpu_torch.workflow.dataset import Dataset

    mesh = mesh or _mesh.current_mesh()
    local_n = len(host_array)
    if mesh.data == 1 and _mesh.world_size() <= 1:
        return Dataset(host_array, device=device)
    if global_n is None:
        global_n = data_axis_sum(local_n, mesh)
    per = -(-int(global_n) // mesh.data)
    if local_n > per:
        raise ValueError(f"rank slice of {local_n} rows exceeds {per}, its share of {global_n} over "
                         f"{mesh.data} data ranks")
    if isinstance(host_array, (list, tuple)) and not all(isinstance(a, (np.ndarray, torch.Tensor))
                                                         for a in host_array):
        d = Dataset(list(host_array), device=device)
    else:
        t = torch.as_tensor(np.asarray(host_array) if not isinstance(host_array, torch.Tensor) else host_array)
        if local_n < per:
            t = torch.cat([t, t.new_zeros((per - local_n,) + tuple(t.shape[1:]))])
        d = Dataset(t if isinstance(host_array, torch.Tensor) else t.numpy(), device=device)
    d.n = int(global_n)
    d.rank_rows = local_n
    return d

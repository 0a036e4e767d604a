"""The mesh over a ``torch.distributed`` job (counterpart of
``keystone_tpu/parallel/mesh.py`` § DATA_AXIS, MODEL_AXIS, MeshContext,
device_count, default_mesh, local_mesh, set_mesh, current_mesh,
active_mesh, use_mesh, replicated, data_sharding, pad_to_multiple,
shard_batch).

The port runs one process a card.  A mesh is the world of those
processes laid out as a 2-D grid, rank ``r`` at ``(r // model, r %
model)``:

  - ``'data'``: the example axis.  Each data index holds its own slice
    of the rows, and sums over rows all-reduce over the ranks of one
    model index (the reference's RDD partitions and ``treeReduce``);
  - ``'model'``: the class-column axis of the block solvers.  The ranks
    of one data index hold the same rows and solve disjoint columns.

Each axis is a family of process groups (``torch.distributed.new_group``),
made once a layout, the form ``init_device_mesh`` stands for.  With no
initialized group the mesh is 1×1, every collective is the identity
and no group is made: the reference's "local mode", in which every
single-process path of the port runs unchanged.

A tensor carries no sharding in torch, so the port carries it itself: a
rank's rows are a plain tensor of its slice, zero-padded so that every
rank holds the same row count, and the ``Dataset`` that holds it records
the global ``n`` and the slice's own valid rows
(``workflow/dataset.py``).  ``replicated`` and ``data_sharding`` are
small descriptors the helpers read, not shardings.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Iterator, Optional

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, model) layout of the world and this rank's two axis
    groups (None: the axis is local, its collectives the identity)."""

    data: int = 1
    model: int = 1
    rank: int = 0
    data_group: object = None
    model_group: object = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def group(self, axis: str):
        return {DATA_AXIS: self.data_group, MODEL_AXIS: self.model_group}[axis]

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        return self.data_index if axis == DATA_AXIS else self.model_index

    def __repr__(self):
        return f"Mesh(data={self.data}, model={self.model}, rank={self.rank})"


@dataclasses.dataclass
class MeshContext:
    """Holder for the process-global mesh (cf. workflow/PipelineEnv.scala).
    ``auto``: the mesh was made by ``current_mesh`` on first use, for the
    world as it was then (``world``), and is remade when that changes."""

    mesh: Optional[Mesh] = None
    auto: bool = False
    world: int = 0


_CTX = MeshContext()
_LOCK = threading.Lock()
#: the groups made for each (world, model) layout: ``new_group`` is
#: collective, so each layout's groups are made once, by every rank
_GROUPS: dict = {}


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def world_size() -> int:
    """The initialized group's world size; 0 when there is none."""
    dist = _dist()
    return dist.get_world_size() if dist is not None else 0


def device_count() -> int:
    """The job's devices, one a rank: the world size, 1 with no group."""
    return max(1, world_size())


def default_mesh(model_parallelism: int = 1) -> Mesh:
    """The (data, model) mesh over the initialized world:
    ``model_parallelism`` consecutive ranks make one model group, the
    rest of the world the data axis.  With no group, the 1×1 local mesh
    (``model_parallelism`` must then be 1).  Every rank of the world must
    make the same layout, in the same order (``new_group`` is collective)."""
    mp = int(model_parallelism)
    dist = _dist()
    if dist is None:
        if mp != 1:
            raise ValueError(f"model_parallelism={mp} needs an initialized torch.distributed group of {mp}+ ranks")
        return Mesh()
    world, rank = dist.get_world_size(), dist.get_rank()
    if mp < 1 or world % mp:
        raise ValueError(f"world size {world} not divisible by model_parallelism {mp}")
    data = world // mp
    key = (id(dist.group.WORLD), world, mp)
    if key not in _GROUPS:
        _GROUPS[key] = _axis_groups(dist, world, data, mp)
    data_groups, model_groups = _GROUPS[key]
    return Mesh(data=data, model=mp, rank=rank, data_group=data_groups[rank % mp],
                model_group=None if model_groups is None else model_groups[rank // mp])


def _axis_groups(dist, world: int, data: int, model: int):
    """Each model index's data group and each data index's model group.
    An axis that spans the world is the world's group; a model axis of
    one rank has none (its collectives are the identity)."""
    if model == 1:
        data_groups = [dist.group.WORLD]
    else:
        data_groups = [dist.new_group(list(range(m, world, model))) for m in range(model)]
    if model == 1:
        model_groups = None
    elif data == 1:
        model_groups = [dist.group.WORLD]
    else:
        model_groups = [dist.new_group(list(range(d * model, (d + 1) * model))) for d in range(data)]
    return data_groups, model_groups


def local_mesh() -> Mesh:
    """A trivial 1×1 mesh with no group (single-datum / debug path),
    whatever the world."""
    return Mesh()


def set_mesh(mesh: Optional[Mesh]) -> None:
    with _LOCK:
        _CTX.mesh = mesh
        _CTX.auto = False


def reset() -> None:
    """Forget the mesh and the groups made for it (after the world's
    group is destroyed)."""
    with _LOCK:
        _CTX.mesh, _CTX.auto, _CTX.world = None, False, 0
        _GROUPS.clear()


def current_mesh() -> Mesh:
    """The active mesh; on first use (and after the world changed under a
    mesh made that way) the default mesh of the world as it is."""
    with _LOCK:
        world = world_size()
        if _CTX.mesh is None or (_CTX.auto and _CTX.world != world):
            _CTX.mesh, _CTX.auto, _CTX.world = default_mesh(), True, world
        return _CTX.mesh


def active_mesh() -> Optional[Mesh]:
    """The active mesh if one was set, WITHOUT making the default."""
    with _LOCK:
        return _CTX.mesh


@contextlib.contextmanager
def use_mesh(mesh: Mesh) -> Iterator[Mesh]:
    with _LOCK:
        prev = (_CTX.mesh, _CTX.auto, _CTX.world)
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        with _LOCK:
            _CTX.mesh, _CTX.auto, _CTX.world = prev


def on_local_mesh(fn):
    """Run ``fn`` on the local mesh: for the ``fit_arrays`` entry points,
    whose arrays are every row of the problem, given to one process (in
    a job of several ranks as alone)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with use_mesh(local_mesh()):
            return fn(*args, **kwargs)

    return wrapper


def data_size(mesh: Optional[Mesh] = None) -> int:
    """The data axis's size: how many row slices a dataset is cut into."""
    return (mesh or current_mesh()).data


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a tensor's parts live: ``"rows"`` (each data index holds its
    row slice), or ``"replicated"`` (every rank holds all of it);
    ``model_dim``: the dim cut over the model axis, or None."""

    kind: str
    model_dim: Optional[int] = None


def replicated(mesh: Optional[Mesh] = None) -> Placement:
    """Every rank holds the whole tensor: the analogue of Spark broadcast."""
    return Placement("replicated")


def data_sharding(mesh: Optional[Mesh] = None, ndim: int = 2, feature_axis: Optional[int] = None) -> Placement:
    """Rows over 'data'; optionally one dim over 'model'."""
    if feature_axis is not None and not 0 < feature_axis < ndim:
        raise ValueError(f"feature_axis {feature_axis} is not a non-row dim of a {ndim}-d tensor")
    return Placement("rows", feature_axis)


def pad_to_multiple(n: int, m: int) -> int:
    return int(math.ceil(n / m) * m) if m > 1 else n


def slice_rows(n: int, parts: int, index: int) -> slice:
    """Part ``index`` of ``parts`` equal slices of ``n`` rows (the last
    ones may be short or empty): the row convention of every rank slice."""
    per = -(-n // parts)
    start = min(index * per, n)
    return slice(start, min(start + per, n))


def shard_batch(x, mesh: Optional[Mesh] = None, feature_axis: Optional[int] = None, device=None) -> torch.Tensor:
    """This rank's part of a host array that every rank holds whole: its
    data index's row slice, zero-padded to ``ceil(n / data)`` rows so that
    every rank holds the same count (and, with ``feature_axis``, its model
    index's slice of that dim, zero-padded alike).  The local mesh keeps
    every row.  ``device``: None keeps a tensor where it is and puts
    numpy on the card, as ``Dataset`` does."""
    from keystone_tpu_torch.utils.device import resolve_device

    mesh = mesh or current_mesh()
    is_tensor = isinstance(x, torch.Tensor)
    x = torch.as_tensor(x)
    if device is None and not is_tensor:
        device = resolve_device()
    x = axis_part(x, 0, mesh.data, mesh.data_index)
    if feature_axis is not None:
        x = axis_part(x, feature_axis, mesh.model, mesh.model_index)
    return x if device is None else x.to(device)


def axis_part(x: torch.Tensor, dim: int, parts: int, index: int) -> torch.Tensor:
    """Part ``index`` of ``x`` cut into ``parts`` equal slices along
    ``dim`` (``slice_rows``' convention), zero-padded to the common
    length; ``x`` itself when ``parts`` is 1."""
    if parts == 1:
        return x
    n = x.shape[dim]
    per = -(-n // parts)
    part = x.narrow(dim, min(index * per, n), len(range(n)[slice_rows(n, parts, index)]))
    if part.shape[dim] == per:
        return part
    pad_shape = list(part.shape)
    pad_shape[dim] = per - part.shape[dim]
    return torch.cat([part, part.new_zeros(pad_shape)], dim=dim)


def local_rows_mask(rows: int, valid: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """(rows,) ones on the first ``valid`` rows, zeros on the padding."""
    return (torch.arange(rows, device=device) < valid).to(dtype)


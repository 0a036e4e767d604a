"""Meshes, placements and collectives over ``torch.distributed``
(counterpart of ``keystone_tpu/parallel/__init__.py``).

This package is the single owner of distribution concerns, mirroring how
everything in the reference bottoms out in Spark ``treeReduce`` /
``treeAggregate`` / ``broadcast`` (SURVEY.md §2.9).  The port's
translation:

  ====================================  =====================================
  reference (Spark)                     keystone_tpu_torch (torch.distributed)
  ====================================  =====================================
  RDD partitions across executors       one row slice a rank of mesh 'data'
  treeReduce / treeAggregate            all_reduce over the data axis's group
  broadcast of weights                  replicated: every rank solves the same
  driver-side solve                     replicated on-device solve
  feature blocks solved in time         class columns over mesh 'model'
  ====================================  =====================================

Everything above this package uses only this API.
"""

from keystone_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    MeshContext,
    current_mesh,
    data_sharding,
    default_mesh,
    device_count,
    local_mesh,
    replicated,
    set_mesh,
    shard_batch,
    use_mesh,
)
from keystone_tpu_torch.parallel.collectives import (  # noqa: F401
    pmean,
    psum,
    sharded_gram,
    sharded_matmul,
    tree_psum,
)
from keystone_tpu_torch.parallel.multihost import (  # noqa: F401
    SickHostError,
    health_barrier,
    maybe_health_barrier,
)


def require_one_rank(what: str) -> None:
    """Refuse a fit that has no multi-rank path yet under a data axis of
    more than one rank: it would fit one rank's rows as if they were all."""
    mesh = current_mesh()
    if mesh.data > 1:
        raise NotImplementedError(f"{what} has no multi-rank fit yet (a data axis of {mesh.data} ranks): it waits "
                                  "for ROADMAP A8b; fit it in a single-process job")


def require_rank_slice(data, what: str) -> None:
    """A parallel fit under a data axis of more than one rank takes each
    rank's own row slice (``multihost.make_global_dataset``): a Dataset
    of every row on each rank would be summed once a rank."""
    mesh = current_mesh()
    if mesh.data > 1 and not data.is_rank_slice:
        raise ValueError(f"{what} under a data axis of {mesh.data} ranks takes this rank's row slice "
                         "(multihost.make_global_dataset), not a Dataset of every row")

"""The port's parallel layer in one process (counterpart of the parallel
cases of tests/test_aux.py, tests/test_guard.py and tests/test_regressions.py):
the mesh, the collectives and the multihost helpers at a world of one
(no group: every collective the identity; a Gloo world of one: real
calls of one rank), the init retry's two directions, the inert health
barrier, and DistributedPCAEstimator against the JAX package's."""

import time

import numpy as np
import pytest
import torch

from keystone_tpu_torch import faults
from keystone_tpu_torch.obs import metrics
from keystone_tpu_torch.parallel import collectives, mesh, multihost
from keystone_tpu_torch.utils import durable

# the projector C·Cᵀ against float64: tests/test_solvers.py's bound
TOL_PROJECTOR = 1e-2
# against the JAX package's fit of the same rows (f32 eigh on both sides)
TOL_PROJECTOR_JAX = 1e-4


@pytest.fixture(autouse=True)
def _local():
    mesh.reset()
    collectives.reset_counts()
    yield
    multihost.shutdown()


def test_local_mesh_and_placements():
    m = mesh.current_mesh()
    assert (m.data, m.model, m.rank) == (1, 1, 0) and m.group(mesh.DATA_AXIS) is None
    assert m.shape == {"data": 1, "model": 1} and mesh.device_count() == 1
    assert mesh.active_mesh() is m
    with pytest.raises(ValueError, match="model_parallelism"):
        mesh.default_mesh(2)
    other = mesh.local_mesh()
    with mesh.use_mesh(other):
        assert mesh.current_mesh() is other
    assert mesh.current_mesh() is m
    assert mesh.replicated().kind == "replicated"
    assert mesh.data_sharding(ndim=3, feature_axis=2) == mesh.Placement("rows", 2)
    with pytest.raises(ValueError):
        mesh.data_sharding(ndim=2, feature_axis=2)
    assert mesh.pad_to_multiple(10, 4) == 12 and mesh.pad_to_multiple(10, 1) == 10
    x = np.arange(30, dtype=np.float32).reshape(10, 3)
    np.testing.assert_array_equal(mesh.shard_batch(x, device="cpu").numpy(), x)


def test_shard_batch_cuts_equal_padded_slices():
    """Three data ranks over 10 rows: slices of 4, 4 and 2 rows, each
    padded to 4; a model axis of 2 over 3 columns: 2 columns each."""
    x = np.arange(30, dtype=np.float32).reshape(10, 3)
    parts = [mesh.shard_batch(x, mesh.Mesh(data=3, model=2, rank=r), feature_axis=1, device="cpu").numpy()
             for r in range(6)]
    assert all(p.shape == (4, 2) for p in parts)
    np.testing.assert_array_equal(parts[0], x[0:4, 0:2])
    np.testing.assert_array_equal(parts[3], np.pad(x[4:8, 2:3], ((0, 0), (0, 1))))
    np.testing.assert_array_equal(parts[4], np.pad(x[8:10, 0:2], ((0, 2), (0, 0))))
    assert [multihost.process_batch_slice(10, mesh.Mesh(data=3, model=2, rank=r)) for r in (0, 2, 5)] == [
        slice(0, 4), slice(4, 8), slice(8, 10)]


def test_collectives_are_the_identity_without_a_group():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(7, 3)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(7, 2)).astype(np.float32))
    x = a.clone()
    assert collectives.psum(x) is x and torch.equal(x, a)
    assert torch.equal(collectives.pmean(a.clone()), a)
    tree = collectives.tree_psum({"a": a, "b": [b]})
    assert torch.equal(tree["a"], a) and torch.equal(tree["b"][0], b)
    assert torch.equal(collectives.sharded_matmul(a, b), a.T @ b)
    assert torch.equal(collectives.sharded_gram(a), a.T @ a)
    assert torch.equal(collectives.all_gather(a, mesh.MODEL_AXIS, 1), a)
    assert collectives.COUNTS == {"all_reduce": 0, "all_gather": 0, "broadcast": 0}


def test_multihost_helpers_single_process():
    """The reference's test_aux.py::test_multihost_helpers_single_process,
    and gather_to_host / global_from_host at a world of one."""
    assert multihost.hybrid_mesh(model_parallelism=1).shape == {"data": 1, "model": 1}
    assert multihost.process_batch_slice(100) == slice(0, 100)
    d = multihost.make_global_dataset(np.ones((8, 2), np.float32), device="cpu")
    assert d.numpy().shape == (8, 2) and not d.is_rank_slice and d.n == 8
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    np.testing.assert_array_equal(multihost.gather_to_host(torch.from_numpy(x)), x)
    np.testing.assert_array_equal(multihost.gather_to_host(x), x)
    back = multihost.global_from_host(x, mesh.data_sharding(), device="cpu")
    np.testing.assert_array_equal(back.numpy(), x)
    assert multihost.data_axis_sum(5) == 5
    assert multihost.broadcast_host([x])[0] is not None
    multihost.initialize()  # no coordinator configured: stays single-process
    assert mesh.world_size() == 0


def test_rank_slice_dataset_keeps_global_n():
    """A Dataset of one rank's rows: padded rows, the global n, its own
    valid rows, kept by the derived datasets."""
    from keystone_tpu_torch.workflow.dataset import Dataset

    t = torch.zeros((4, 2))
    t[:3] = 1.0
    d = Dataset(t)
    d.n, d.rank_rows = 7, 3
    assert d.is_rank_slice and d.local_n == 3 and len(d) == 7
    assert d.numpy().shape == (3, 2)
    derived = d.with_array(t * 2)
    assert (derived.n, derived.rank_rows) == (7, 3)


def test_stage_stream_batch_pads_to_a_power_of_two():
    from keystone_tpu_torch.models.common import stage_stream_batch

    x = np.ones((5, 3), np.float32)
    xs, bn, row_ok = stage_stream_batch(x, device="cpu")
    assert xs.shape == (8, 3) and bn == 5 and row_ok[:, 0].tolist() == [1.0] * 5 + [0.0] * 3
    xs, bn, row_ok = stage_stream_batch(x, mesh=mesh.Mesh(data=2, rank=1), device="cpu")
    assert xs.shape == (4, 3) and row_ok[:, 0].tolist() == [1.0, 0.0, 0.0, 0.0]


def test_health_barrier_single_process_inert(monkeypatch):
    t0 = time.perf_counter()
    assert multihost.health_barrier(timeout=0.1) is True
    assert multihost.health_barrier(ok=False, timeout=0.1) is True  # nobody to abort with
    monkeypatch.setenv(multihost.ENV_HEALTH_TIMEOUT, "5")
    assert multihost.maybe_health_barrier("t") is True
    assert time.perf_counter() - t0 < 1.0


def test_transient_init_error_classifier():
    f = multihost._transient_init_error
    assert f(OSError("disk")) and f(ConnectionError("nope")) and f(faults.FaultInjected("multihost.init"))
    assert f(RuntimeError("failed to connect to coordinator: UNAVAILABLE"))
    assert f(RuntimeError("Barrier timed out"))
    assert f(RuntimeError("The client socket has failed to connect to [localhost]:1 (errno: 111 - Connection "
                          "refused)"))
    assert not f(RuntimeError("Number of processes 4 does not match num_processes 2"))
    assert not f(ValueError("Invalid rank -1"))


def test_init_deterministic_error_fails_fast(monkeypatch):
    """A deterministic config error fails on the first attempt: no backoff
    budget burned (tests/test_regressions.py's first direction)."""
    import torch.distributed as dist

    calls = {"n": 0}

    def die(*a, **kw):
        calls["n"] += 1
        raise RuntimeError("Number of processes 4 does not match num_processes 2")

    monkeypatch.setattr(dist, "init_process_group", die)
    with pytest.raises(RuntimeError, match="does not match"):
        multihost.initialize("localhost:1", num_processes=2, process_id=0, retries=3, backend="gloo",
                             device="cpu")
    assert calls["n"] == 1


def test_init_connection_error_still_retried(monkeypatch):
    """The other direction: a connection-shaped error consumes the retries."""
    import torch.distributed as dist

    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        raise RuntimeError("failed to connect to coordinator: UNAVAILABLE")

    monkeypatch.setattr(dist, "init_process_group", flaky)
    monkeypatch.setattr(durable, "backoff_delays", lambda *a, **k: iter([0.0] * 8))
    with pytest.raises(RuntimeError, match="UNAVAILABLE"):
        multihost.initialize("localhost:1", num_processes=2, process_id=0, retries=2, backend="gloo",
                             device="cpu")
    assert calls["n"] == 3


def test_init_fault_at_multihost_init_is_retried(monkeypatch):
    """An injected raise at ``multihost.init`` (a transient connect
    failure) is retried: a Gloo world of one comes up on the second
    attempt, counted, and its collectives are real calls of one rank."""
    import socket

    monkeypatch.setattr(durable, "backoff_delays", lambda *a, **k: iter([0.0] * 8))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    before = metrics.REGISTRY.counter_value("multihost.init_attempts")
    faults.reset_stats()
    with faults.inject("multihost.init:after=0:times=1:raise"):
        multihost.initialize(f"127.0.0.1:{port}", num_processes=1, process_id=0, backend="gloo", device="cpu",
                             initialization_timeout=30)
    assert faults.stats()["multihost.init"] == {"calls": 2, "injected": 1}
    assert metrics.REGISTRY.counter_value("multihost.init_attempts") - before == 2
    assert mesh.world_size() == 1 and multihost.process_index() == 0
    m = mesh.current_mesh()
    assert m.data == 1 and m.group(mesh.DATA_AXIS) is not None
    a = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    assert torch.equal(collectives.sharded_gram(a), a.T @ a)
    assert collectives.COUNTS["all_reduce"] == 1
    assert multihost.health_barrier(ok=False) is True  # a world of one: inert
    np.testing.assert_array_equal(multihost.gather_to_host(np.arange(3)), np.arange(3))
    multihost.initialize(f"127.0.0.1:{port}", num_processes=1, process_id=0)  # initialized: a no-op
    multihost.shutdown()
    assert mesh.world_size() == 0 and mesh.current_mesh().group(mesh.DATA_AXIS) is None


def test_a8b_fits_refuse_a_data_axis_above_one():
    """The fits without a multi-rank path refuse a data axis above one,
    citing ROADMAP A8b, instead of fitting one rank's rows."""
    from keystone_tpu_torch.models.gmm import GaussianMixtureModelEstimator
    from keystone_tpu_torch.models.kmeans import KMeansPlusPlusEstimator
    from keystone_tpu_torch.models.naive_bayes import NaiveBayesEstimator
    from keystone_tpu_torch.models.logistic import LogisticRegressionEstimator
    from keystone_tpu_torch.models import kernel_ridge as kr

    x = np.ones((8, 3), np.float32)
    y = np.zeros((8,), np.int64)
    with mesh.use_mesh(mesh.Mesh(data=2, rank=0)):
        for fit in (lambda: GaussianMixtureModelEstimator(2).fit_arrays(x, device="cpu"),
                    lambda: KMeansPlusPlusEstimator(2).fit_arrays(x, device="cpu"),
                    lambda: NaiveBayesEstimator(2).fit_arrays(x, y, device="cpu"),
                    lambda: LogisticRegressionEstimator(2).fit_arrays(x, y, device="cpu"),
                    lambda: kr.KernelRidgeRegressionEstimator(kr.GaussianKernelGenerator(1.0), lam=1.0)
                    .fit_arrays(x, np.ones((8, 1), np.float32), device="cpu")):
            with pytest.raises(NotImplementedError, match="ROADMAP A8b"):
                fit()


def test_distributed_pca_matches_the_jax_package():
    """DistributedPCAEstimator (the all-reduced Gramian and a replicated
    eigh) against the JAX package's on the same rows: the projector within
    the reference's own bound against float64, and close to the JAX fit."""
    from keystone_tpu.models import DistributedPCAEstimator as JDPCA
    from keystone_tpu.workflow import Dataset as JDataset

    from keystone_tpu_torch.models.pca import DistributedPCAEstimator
    from keystone_tpu_torch.workflow.dataset import Dataset

    rng = np.random.default_rng(3)
    base = rng.normal(size=(200, 6)).astype(np.float32)
    base[:, 2:] *= 0.05
    rot, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    x = (base @ rot.T).astype(np.float32)
    xm = x.astype(np.float64) - x.mean(0)
    _, _, vt = np.linalg.svd(xm, full_matrices=False)
    p64 = vt[:2].T @ vt[:2]
    jm = JDPCA(2).fit_dataset(JDataset(x))
    jc = np.asarray(jm.components)
    for model in (DistributedPCAEstimator(2).fit_dataset(Dataset(x, device="cpu")),
                  DistributedPCAEstimator(2).fit_arrays(x, device="cpu")):
        c = model.components.numpy()
        assert c.shape == (6, 2)
        np.testing.assert_allclose(c @ c.T, p64, atol=TOL_PROJECTOR)
        np.testing.assert_allclose(c @ c.T, jc @ jc.T, atol=TOL_PROJECTOR_JAX)
        np.testing.assert_allclose(model.mean.numpy(), np.asarray(jm.mean), atol=1e-6)
    # the masked case goes to the parent's masked branch, as the reference's
    mask = np.ones((200,), np.float32)
    masked = DistributedPCAEstimator(2).fit_arrays(x, mask=mask, device="cpu").components.numpy()
    np.testing.assert_allclose(masked @ masked.T, p64, atol=TOL_PROJECTOR)


def test_parallel_fits_refuse_every_row_under_a_data_axis():
    """Under a data axis of two ranks the parallel fits take a rank slice:
    a Dataset of every row on each rank would be summed twice."""
    from keystone_tpu_torch.models.block_ls import BlockLeastSquaresEstimator
    from keystone_tpu_torch.models.lbfgs import DenseLBFGSwithL2
    from keystone_tpu_torch.models.linear import LinearMapEstimator
    from keystone_tpu_torch.models.pca import DistributedPCAEstimator
    from keystone_tpu_torch.workflow.dataset import Dataset

    x = Dataset(np.ones((8, 3), np.float32), device="cpu")
    y = Dataset(np.ones((8, 2), np.float32), device="cpu")
    with mesh.use_mesh(mesh.Mesh(data=2, rank=0)):
        for fit in (lambda: LinearMapEstimator(1.0).fit_dataset(x, y),
                    lambda: BlockLeastSquaresEstimator(2).fit_dataset(x, y),
                    lambda: DenseLBFGSwithL2(1.0).fit_dataset(x, y),
                    lambda: DistributedPCAEstimator(2).fit_dataset(x)):
            with pytest.raises(ValueError, match="row slice"):
                fit()

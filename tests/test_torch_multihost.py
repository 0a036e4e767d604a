"""The port's parallel layer across processes: Gloo on the CPU, each rank a
spawned process feeding its own row slice (tests/torch_multihost_worker.py),
held against exact solves, against the port's own single-process fits,
and against the JAX package's single-process fits of the same numpy data
(the counterpart of tests/test_multihost.py and tests/test_faulttol.py).

Every spawned process has its own timeout and the parent kills whatever
is left.  Sums over two ranks run in another order than one process's,
so two ranks are held to one rank and to the reference within stated
tolerances, never bit for bit; only a resumed job and its uninterrupted
control (the same world) are held to equal digests."""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
import torch_multihost_worker as W  # noqa: E402

WORKER = os.path.join(os.path.dirname(__file__), "torch_multihost_worker.py")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 150  # each spawned rank's own bound

# tolerances: two ranks against the JAX package's single-process fit of
# the same data (f32 on both sides, sums in another order)
TOL_LINEAR_JAX = 1e-4
TOL_STORE_JAX = 5e-4  # the reference's own bound against the full in-memory fit
TOL_BCD_JAX = 1e-4
TOL_SPARSE_JAX = 1e-4
TOL_PROJECTOR = 1e-2  # tests/test_solvers.py's bound on the projector against float64
TOL_PROJECTOR_JAX = 1e-4
TOL_MESH = 1e-5  # 2×2 against 2 ranks and against 1 rank, the in-core BCD


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in ("KEYSTONE_FAULTS", "MASTER_ADDR", "WORLD_SIZE")}
    env.update(PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1", **extra)
    return env


def _launch(mode, out, world=2, **env):
    port = _free_port()
    return [subprocess.Popen([sys.executable, WORKER, str(port), str(world), str(r), mode, str(out)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env(**env), cwd=ROOT)
            for r in range(world)]


def _drain(procs, timeout=TIMEOUT_S):
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _ok(outs):
    for rc, out, err in outs:
        assert rc == 0, f"rank failed (rc={rc}):\n{out[-2000:]}\n{err[-3000:]}"
    return "".join(o for _, o, _ in outs)


def _crash(mode, out):
    """Rank 1 dies (exit 42) mid-fit; the survivor, parked in (or failing
    out of) a collective whose peer is gone, is killed as a scheduler would."""
    procs = _launch(mode, out)
    try:
        assert procs[1].wait(timeout=TIMEOUT_S) == 42, procs[1].communicate()[1][-3000:]
        try:
            procs[0].wait(timeout=30)
        except subprocess.TimeoutExpired:
            procs[0].kill()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()


def _rank_npz(out, mode, rank=0):
    with np.load(os.path.join(out, f"{mode}_rank{rank}.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def main_run(tmp_path_factory):
    """The two-rank legs, under a multihost.init fault that each rank's
    initialize retries once."""
    out = tmp_path_factory.mktemp("main")
    text = _ok(_drain(_launch("main", out, KEYSTONE_FAULTS="multihost.init:after=0:times=1:raise")))
    return out, text, [_rank_npz(out, "main", r) for r in range(2)]


@pytest.fixture(scope="module")
def resumed(main_run, tmp_path_factory):
    out = main_run[0]
    _crash("crash-bcd", out)
    _crash("crash-sparse", out)
    text = _ok(_drain(_launch("resume", out)))
    return text, [_rank_npz(out, "resume", r) for r in range(2)]


def test_init_fault_is_retried(main_run):
    _, text, got = main_run
    assert text.count("INIT_ATTEMPTS 2") == 2  # one injected raise and one retry on each rank
    assert all(int(g["init_attempts"]) == 2 for g in got)


def test_two_rank_linear_map_matches_exact_and_jax(main_run):
    """Two ranks against the exact ridge solve (< 2e-3, in the worker) and
    the JAX package's single-process LinearMapEstimator."""
    from keystone_tpu.models import LinearMapEstimator as JLinearMap
    from keystone_tpu.workflow import Dataset as JDataset

    _, text, got = main_run
    assert text.count("LINEAR_OK") == 2
    x, y = W.linear_problem()
    ref = JLinearMap(lam=0.1).fit_dataset(JDataset(x), JDataset(y))
    for g in got:
        np.testing.assert_allclose(g["linear_w"], np.asarray(ref.weights), atol=TOL_LINEAR_JAX)
        np.testing.assert_allclose(g["linear_b"], np.asarray(ref.intercept), atol=TOL_LINEAR_JAX)
    np.testing.assert_array_equal(got[0]["linear_w"], got[1]["linear_w"])  # replicated: every rank solves alike


def test_two_rank_distributed_pca(main_run):
    """DistributedPCAEstimator over two row slices: the projector C·Cᵀ
    against float64 at the reference's own bound and against the JAX
    package's DistributedPCAEstimator on the whole data."""
    from keystone_tpu.models import DistributedPCAEstimator as JDPCA
    from keystone_tpu.workflow import Dataset as JDataset

    from keystone_tpu_torch.models.pca import DistributedPCAEstimator

    _, text, got = main_run
    x = W.pca_problem()
    xm = x.astype(np.float64) - x.mean(0)
    _, _, vt = np.linalg.svd(xm, full_matrices=False)
    p64 = vt[:2].T @ vt[:2]
    jc = np.asarray(JDPCA(2).fit_dataset(JDataset(x)).components)
    one = DistributedPCAEstimator(2).fit_arrays(x, device="cpu").components.numpy()
    for g in got:
        c = g["pca_c"]
        np.testing.assert_allclose(c @ c.T, p64, atol=TOL_PROJECTOR)
        np.testing.assert_allclose(c @ c.T, jc @ jc.T, atol=TOL_PROJECTOR_JAX)
        np.testing.assert_allclose(c @ c.T, one @ one.T, atol=TOL_PROJECTOR_JAX)
        np.testing.assert_allclose(g["pca_mean"], x.mean(0), atol=1e-6)


def test_two_rank_store_fit_holds_only_its_rows(main_run):
    """Per-rank FeatureBlockStores (each rank spilled only its rows; the
    worker checks its store against the full in-memory fit, < 5e-4) against
    the JAX package's weighted fit_arrays of the full data."""
    from keystone_tpu.models import BlockWeightedLeastSquaresEstimator as JBW

    out, text, got = main_run
    assert text.count("STORE_OK") == 2
    x, y = W.store_problem()
    assert [int(g["store_rows"][0]) for g in got] == [64, 64]
    for r in range(2):  # no rank's store holds the full matrix
        files = [f for f in os.listdir(out / f"shard{r}") if f.endswith(".npy")]
        assert files and all(np.load(out / f"shard{r}" / f, mmap_mode="r").shape[0] == 64 for f in files)
    ref = JBW(block_size=16, num_iter=3, lam=1e-2, mixture_weight=0.5).fit_arrays(x, y)
    for g in got:
        np.testing.assert_allclose(g["store_w"], np.asarray(ref.flat_weights), atol=TOL_STORE_JAX)
        np.testing.assert_allclose(g["store_b"], np.asarray(ref.intercept), atol=TOL_STORE_JAX)


def test_sick_rank_aborts_every_rank(main_run):
    _, text, _ = main_run
    assert text.count("SICK_RAISED") == 2


def test_checkpointed_bcd_killed_and_resumed(main_run, resumed):
    """Rank 1 killed before its 4th epoch; both relaunched resume from
    rank 0's checkpoint (epoch ≥ 1) and land on the uninterrupted two-rank
    fit's digest; the weights against the JAX package's single-process
    fit_checkpointed of the full data."""
    from keystone_tpu.models.block_ls import BlockLeastSquaresEstimator as JBLS

    _, control_text, control = main_run
    text, got = resumed
    froms = [int(e) for e in re.findall(r"RESUMED_FROM bcd (\d+)", text)]
    assert len(froms) == 2 and all(e >= 1 for e in froms), froms
    want = set(re.findall(r"BCD_OK how=control digest=(\w+)", control_text))
    assert len(want) == 1
    assert set(re.findall(r"BCD_OK how=resume digest=(\w+)", text)) == want
    for g in got:
        np.testing.assert_array_equal(g["bcd_resume"], control[0]["bcd_control"])
    x, y = W.bcd_problem()
    ref = JBLS(**W.BCD).fit_arrays(x, y)
    np.testing.assert_allclose(got[0]["bcd_resume"], np.asarray(ref.flat_weights), atol=TOL_BCD_JAX)


def test_sparse_lbfgs_killed_and_resumed(main_run, resumed):
    """Rank 1 killed after the carry save at iteration 4; the relaunched
    ranks resume from it and end on the control's digest; the weights
    against the JAX package's single-process checkpointed fit."""
    from keystone_tpu.models.lbfgs import SparseLBFGSwithL2 as JSparse
    from keystone_tpu.workflow import Dataset as JDataset

    _, control_text, control = main_run
    text, got = resumed
    froms = [int(e) for e in re.findall(r"RESUMED_FROM sparse (\d+)", text)]
    assert len(froms) == 2 and all(e >= 4 for e in froms), froms
    want = set(re.findall(r"SPARSE_OK how=control digest=(\w+)", control_text))
    assert len(want) == 1
    assert set(re.findall(r"SPARSE_OK how=resume digest=(\w+)", text)) == want
    for g in got:
        np.testing.assert_array_equal(g["sparse_resume"], control[0]["sparse_control"])
    rows, y = W.sparse_problem()
    ref = JSparse(**W.SPARSE).fit_dataset(JDataset(rows), JDataset(y, shard=False))
    np.testing.assert_allclose(got[0]["sparse_resume"], np.asarray(ref.weights), atol=TOL_SPARSE_JAX)


def test_mesh_2x2_bcd_matches_two_ranks_and_one(main_run, tmp_path):
    """Four ranks as 2 (data) × 2 (model): each data index feeds a row
    slice, each model index solves its class columns; the weights against
    the two-rank fit, the port's one-process fit and the JAX package's.
    Rank 1's health_barrier(ok=False) raises SickHostError on all four."""
    import torch

    from keystone_tpu.models.block_ls import BlockLeastSquaresEstimator as JBLS

    from keystone_tpu_torch.models.block_ls import BlockLeastSquaresEstimator

    text = _ok(_drain(_launch("mesh22", tmp_path, world=4)))
    assert text.count("MESH_OK") == 4 and text.count("SICK_RAISED") == 4
    got = [_rank_npz(tmp_path, "mesh22", r)["incore"] for r in range(4)]
    two = main_run[2][0]["incore"]
    x, y = W.incore_problem()
    m = BlockLeastSquaresEstimator(**W.INCORE).fit_arrays(x, y, device="cpu")
    one = torch.cat([m.flat_weights.reshape(-1), m.intercept.reshape(-1)]).numpy()
    j = JBLS(**W.INCORE).fit_arrays(x, y)
    jax_one = np.concatenate([np.asarray(j.flat_weights).reshape(-1), np.asarray(j.intercept).reshape(-1)])
    for g in got:
        np.testing.assert_allclose(g, two, atol=TOL_MESH)
        np.testing.assert_allclose(g, one, atol=TOL_MESH)
        np.testing.assert_allclose(g, jax_one, atol=TOL_BCD_JAX)

"""The port's parallel layer across processes: Gloo on the CPU, each rank a
spawned process feeding its own row slice (tests/torch_multihost_worker.py),
held against exact solves, against the port's own single-process fits,
and against the JAX package's single-process fits of the same numpy data
(the counterpart of tests/test_multihost.py and tests/test_faulttol.py);
the ``a8b`` launch holds the rest of the parallel layer so, with each
fit's collectives counted (the counterpart of
tests/test_sharding_gate.py's gates on the GMM EM and the KRR sweep).

Every spawned process has its own timeout and the parent kills whatever
is left.  Sums over two ranks run in another order than one process's,
so two ranks are held to one rank and to the reference within stated
tolerances, never bit for bit; only a resumed job and its uninterrupted
control (the same world) are held to equal digests."""

import json
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


@pytest.fixture(scope="module")
def mesh22_run(tmp_path_factory):
    """The four-rank 2 (data) × 2 (model) legs, launched once."""
    out = tmp_path_factory.mktemp("mesh22")
    return out, _ok(_drain(_launch("mesh22", out, world=4)))


def test_mesh_2x2_bcd_matches_two_ranks_and_one(main_run, mesh22_run):
    """Four ranks as 2 (data) × 2 (model): each data index feeds a row
    slice, each model index solves its class columns; the weights against
    the two-rank fit, the port's one-process fit and the JAX package's.
    Rank 1's health_barrier(ok=False) raises SickHostError on all four."""
    import torch

    from keystone_tpu.models.block_ls import BlockLeastSquaresEstimator as JBLS

    from keystone_tpu_torch.models.block_ls import BlockLeastSquaresEstimator

    tmp_path, text = mesh22_run
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


# ---- the rest of the parallel layer: two ranks on rank slices ----------
#
# tolerances: two ranks against one process of the port and against the
# JAX package's single-process fit, each the single-process parity
# test's own (tests/test_torch_fit.py, test_torch_text_ops.py,
# test_torch_kernel_tier.py); the k-means++ draws and ColumnSampler's rows
# exactly
ATOL_LLOYD = 1e-5
ATOL_W, ATOL_MU, ATOL_VAR = 2e-5, 2e-4, 2e-4  # the EM's (tests/test_torch_fit.py)
ATOL_PCA = 1e-5  # the projector, well-separated spectra
RTOL_NB_PRIOR, TOL_NB_COND = 1e-6, 1e-5
RTOL_OBJECTIVE, TOL_WEIGHTS = 1e-5, 1e-3  # two f32 L-BFGS runs, each to its optimum
ATOL_ALPHA, ATOL_PRED = 2e-5, 1e-4
RTOL_POLY = 1e-4  # polynomial grams reach |K| ~ 10 (tests/test_torch_kernel_tier.py)
# ImageNetSiftLcsFV.run: two ranks' vocabularies and solve differ from
# one process's by f32 rounding; their held-out top-1 predictions agree
# on at least this share, and the error moves by at most the reference
# test's margin (tests/test_torch_fit_slice.py's TOP1_MARGIN)
RUN_TOP1_AGREEMENT, RUN_TOP1_MARGIN = 0.75, 0.25


def _gmm_flat(fit):
    return np.concatenate([np.asarray(a).ravel() for a in fit])


def _gmm_tol(a, b):
    k, d = W.GMM["k"], (a.size // W.GMM["k"] - 1) // 2
    for sl, atol in ((slice(0, k), ATOL_W), (slice(k, k + k * d), ATOL_MU), (slice(k + k * d, None), ATOL_VAR)):
        np.testing.assert_allclose(a[sl], b[sl], atol=atol)


@pytest.fixture(scope="module")
def a8b_run(tmp_path_factory):
    """The reference's k-means++ centres (the given starts) written for
    the ranks, then the two-rank ``a8b`` legs."""
    import jax
    import jax.numpy as jnp

    from keystone_tpu.models.kmeans import _kmeans_fit as j_kmeans_fit

    out = tmp_path_factory.mktemp("a8b")
    x = W.kmeans_problem()
    ones = jnp.ones(x.shape[0])
    km_start = np.asarray(j_kmeans_fit(jnp.asarray(x), ones, W.KM["num_means"], 0, jax.random.PRNGKey(0)))
    xg = W.gmm_problem()
    gmm_start = np.asarray(j_kmeans_fit(jnp.asarray(xg), jnp.ones(xg.shape[0]), W.GMM["k"], W.GMM["kmeans_iters"],
                                        jax.random.PRNGKey(W.GMM["seed"])))
    xr, mr = W.ragged_problem()
    flat, ok = xr.reshape(-1, 3), mr.reshape(-1)
    ragged_start = np.asarray(j_kmeans_fit(jnp.asarray(flat * ok[:, None]), jnp.asarray(ok), W.GMM["k"],
                                           W.GMM["kmeans_iters"], jax.random.PRNGKey(W.GMM["seed"])))
    np.savez(out / "a8b_inputs.npz", km_start=km_start, gmm_start=gmm_start, ragged_start=ragged_start)
    text = _ok(_drain(_launch("a8b", out)))
    got = [_rank_npz(out, "a8b", r) for r in range(2)]
    return out, text, got, [json.loads(str(g["counts"])) for g in got]


def test_kmeanspp_draws_at_two_ranks_are_one_ranks_exactly(a8b_run):
    """The Gumbel-max draw over the global row order: two ranks pick the
    rows one process picks, exactly, and exchange no row but the chosen
    one (an all-reduce of one row a centre, no all-gather)."""
    import torch

    from keystone_tpu_torch.models import kmeans

    _, text, got, counts = a8b_run
    x = W.kmeans_problem()
    one = kmeans._kmeans_seed(torch.from_numpy(x), torch.ones(x.shape[0]), W.KM["num_means"],
                              kmeans.generator(W.KM["seed"], "cpu")).numpy()
    idx = [int(np.flatnonzero((x == c).all(1))[0]) for c in one]
    for g, c in zip(got, counts):
        np.testing.assert_array_equal(g["kmeans_seeds"], one)
        assert [int(np.flatnonzero((x == r).all(1))[0]) for r in g["kmeans_seeds"]] == idx
        k = W.KM["num_means"]
        assert c["kmeans_seed"] == {"all_reduce": k, "all_gather": 0, "broadcast": 0, "argmax": k}


def test_two_rank_kmeans_matches_one_process_and_jax(a8b_run):
    """The fit against one process's; Lloyd from the reference's centres
    against the reference's fit, one all-reduce a step."""
    import jax
    import jax.numpy as jnp

    from keystone_tpu.models.kmeans import _kmeans_fit as j_kmeans_fit
    from keystone_tpu_torch.models.kmeans import KMeansPlusPlusEstimator
    from keystone_tpu_torch.workflow.dataset import Dataset

    _, _, got, counts = a8b_run
    x = W.kmeans_problem()
    one = KMeansPlusPlusEstimator(**W.KM).fit_dataset(Dataset(x, device="cpu")).centers.numpy()
    want = np.asarray(j_kmeans_fit(jnp.asarray(x), jnp.ones(x.shape[0]), W.KM["num_means"],
                                   W.KM["max_iterations"], jax.random.PRNGKey(0)))
    for g, c in zip(got, counts):
        np.testing.assert_allclose(g["kmeans"], one, atol=ATOL_LLOYD)
        np.testing.assert_allclose(g["lloyd"], want, atol=ATOL_LLOYD)
        assert c["lloyd"] == {"all_reduce": W.KM["max_iterations"], "all_gather": 0, "broadcast": 0, "argmax": 0}


@pytest.mark.parametrize("form", ["dense", "ragged"])
def test_two_rank_gmm_em_matches_one_process_and_jax_and_stays_sharded(a8b_run, form):
    """The EM at two ranks from the reference's centres against the
    reference's _gmm_fit, and from the port's own start against one
    process's fit; exactly two all-reduces before the EM (the count and
    mean, the variance) and one a step, never an all-gather of the rows
    (the counterpart of tests/test_sharding_gate.py::test_gmm_em_stays_sharded)."""
    import jax.numpy as jnp

    from keystone_tpu.models.gmm import _gmm_fit as j_gmm_fit
    from keystone_tpu_torch.models.gmm import GaussianMixtureModelEstimator
    from keystone_tpu_torch.workflow.dataset import Dataset

    _, _, got, counts = a8b_run
    g_ = W.GMM
    if form == "dense":
        x = W.gmm_problem()
        want = j_gmm_fit(jnp.asarray(x), jnp.float32(x.shape[0]), None, g_["k"], g_["max_iterations"], 1e-6,
                         g_["seed"], g_["kmeans_iters"])
        one = GaussianMixtureModelEstimator(**g_).fit_dataset(Dataset(x, device="cpu"))
        keys = ("gmm_from_start", "gmm", "gmm_em")
    else:
        x, mask = W.ragged_problem()
        want = j_gmm_fit(jnp.asarray(x), None, jnp.asarray(mask), g_["k"], g_["max_iterations"], 1e-6, g_["seed"],
                         g_["kmeans_iters"])
        one = GaussianMixtureModelEstimator(**g_).fit_dataset(Dataset(x, mask=mask, device="cpu"))
        keys = ("gmm_ragged_from_start", "gmm_ragged", "gmm_ragged_em")
    one = _gmm_flat((one.weights.numpy(), one.means.numpy(), one.variances.numpy()))
    for g, c in zip(got, counts):
        _gmm_tol(g[keys[0]], _gmm_flat(want))
        _gmm_tol(g[keys[1]], one)
        assert c[keys[2]] == {"all_reduce": 2 + g_["max_iterations"], "all_gather": 0, "broadcast": 0, "argmax": 0}


def test_mesh_2x2_gmm_matches_two_ranks_and_one(a8b_run, mesh22_run):
    """The GMM fit on a 2 (data) × 2 (model) mesh: the model axis's ranks
    hold the same rows and fit alike; against the two-rank and the
    one-process fits."""
    from keystone_tpu_torch.models.gmm import GaussianMixtureModelEstimator
    from keystone_tpu_torch.workflow.dataset import Dataset

    out, text = mesh22_run
    assert text.count("MESH_OK") == 4
    got = [_rank_npz(out, "mesh22", r)["gmm"] for r in range(4)]
    m = GaussianMixtureModelEstimator(**W.GMM).fit_dataset(Dataset(W.gmm_problem(), device="cpu"))
    one = _gmm_flat((m.weights.numpy(), m.means.numpy(), m.variances.numpy()))
    for g in got:
        _gmm_tol(g, a8b_run[2][0]["gmm"])
        _gmm_tol(g, one)


def test_column_sampler_on_two_slices_gives_one_processes_rows(a8b_run):
    import torch

    from keystone_tpu_torch.ops.stats import ColumnSampler
    from keystone_tpu_torch.workflow.dataset import Dataset

    _, _, got, _ = a8b_run
    xs, ms = W.sampler_problem()
    one = ColumnSampler(4, seed=5).apply_dataset(Dataset(xs, mask=torch.from_numpy(ms), device="cpu")).array.numpy()
    per = -(-len(xs) // 2)
    assert [list(g["sampled_n"]) for g in got] == [[28, 16, 0], [28, 12, 16]]
    for g in got:
        assert per * 4 == 16
        np.testing.assert_array_equal(g["sampled"], one)


@pytest.mark.parametrize("masked", [False, True])
def test_two_rank_pca_matches_one_process_and_jax(a8b_run, masked):
    """The unmasked PCA: the rows all-gathered once and the SVD on every
    rank; the masked one: its sums all-reduced, no gather."""
    import jax.numpy as jnp
    import torch

    from keystone_tpu.models.pca import PCAEstimator as JPCA
    from keystone_tpu.models.pca import _pca_masked as j_pca_masked
    from keystone_tpu.workflow import Dataset as JDataset
    from keystone_tpu_torch.models.pca import PCAEstimator
    from keystone_tpu_torch.workflow.dataset import Dataset

    _, _, got, counts = a8b_run
    if masked:
        x, mask = W.ragged_problem()
        one = PCAEstimator(2).fit_dataset(Dataset(x, mask=torch.from_numpy(mask), device="cpu"))
        jc, jm = (np.asarray(a) for a in j_pca_masked(jnp.asarray(x), jnp.asarray(mask), 2, True))
        key, want_counts = "pca_masked", {"all_reduce": 2, "all_gather": 0, "broadcast": 0, "argmax": 0}
    else:
        x = W.pca_rows_problem()
        one = PCAEstimator(3).fit_dataset(Dataset(x, device="cpu"))
        jfit = JPCA(3).fit_dataset(JDataset(x))
        jc, jm = np.asarray(jfit.components), np.asarray(jfit.mean)
        key, want_counts = "pca", {"all_reduce": 0, "all_gather": 1, "broadcast": 0, "argmax": 0}
    oc = one.components.numpy()
    for g, c in zip(got, counts):
        gc = g[f"{key}_c"]
        np.testing.assert_allclose(gc @ gc.T, oc @ oc.T, atol=ATOL_PCA)
        np.testing.assert_allclose(gc @ gc.T, jc @ jc.T, atol=ATOL_PCA)
        np.testing.assert_allclose(g[f"{key}_mean"], jm, atol=ATOL_PCA)
        assert c[key] == want_counts


@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_two_rank_naive_bayes_matches_one_process_and_jax(a8b_run, form):
    from keystone_tpu.models.naive_bayes import NaiveBayesEstimator as JNB
    from keystone_tpu.workflow import Dataset as JDataset
    from keystone_tpu_torch.models.naive_bayes import NaiveBayesEstimator
    from keystone_tpu_torch.workflow.dataset import Dataset

    _, _, got, counts = a8b_run
    dense, rows, labels, k = W.nb_problem()
    data = dense if form == "dense" else rows
    one = NaiveBayesEstimator(k).fit_dataset(Dataset(data, device="cpu"), Dataset(labels, device="cpu"))
    jm = JNB(k).fit_dataset(JDataset(data), JDataset(labels))
    for g, c in zip(got, counts):
        for want_prior, want_cond in ((one.log_prior.numpy(), one.log_cond.numpy()),
                                      (np.asarray(jm.log_prior), np.asarray(jm.log_cond))):
            np.testing.assert_allclose(g[f"nb_{form}_prior"], want_prior, rtol=RTOL_NB_PRIOR)
            np.testing.assert_allclose(g[f"nb_{form}_cond"], want_cond, rtol=TOL_NB_COND, atol=TOL_NB_COND)
        assert c[f"nb_{form}"]["all_reduce"] == 1 and c[f"nb_{form}"]["all_gather"] == 0


@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_two_rank_logistic_regression_matches_one_process_and_jax(a8b_run, form):
    """Every rank takes the same steps (the weights equal on both ranks);
    against one process and the reference as two f32 runs to the optimum."""
    import scipy.sparse as sparse

    from keystone_tpu.models.logistic import LogisticRegressionEstimator as JLR
    from keystone_tpu.workflow import Dataset as JDataset
    from keystone_tpu_torch.models.logistic import LogisticRegressionEstimator
    from keystone_tpu_torch.workflow.dataset import Dataset

    _, _, got, counts = a8b_run
    dense, labels, k = W.logistic_problem()
    data = dense if form == "dense" else [sparse.csr_matrix(dense[i:i + 1]) for i in range(dense.shape[0])]
    one = LogisticRegressionEstimator(k, **W.LOGISTIC).fit_dataset(Dataset(data, device="cpu"),
                                                                    Dataset(labels, device="cpu")).weights.numpy()
    jw = np.asarray(JLR(k, **W.LOGISTIC).fit_dataset(JDataset(data), JDataset(labels)).weights)
    onehot = np.eye(k, dtype=np.float64)[labels]

    def objective(w):
        z = dense.astype(np.float64) @ w
        zmax = z.max(1, keepdims=True)
        lse = (zmax + np.log(np.exp(z - zmax).sum(1, keepdims=True)))[:, 0]
        return -np.sum(np.sum(z * onehot, 1) - lse) / dense.shape[0] + 0.5 * W.LOGISTIC["lam"] * np.sum(w * w)

    np.testing.assert_array_equal(got[0][f"logistic_{form}"], got[1][f"logistic_{form}"])
    w = got[0][f"logistic_{form}"]
    for want in (one, jw):
        assert abs(objective(w) - objective(want)) <= RTOL_OBJECTIVE * abs(objective(want))
        assert np.abs(w - want).max() <= TOL_WEIGHTS * np.abs(want).max()
    assert all(c[f"logistic_{form}"]["all_gather"] == 0 and c[f"logistic_{form}"]["all_reduce"] > 0 for c in counts)


@pytest.mark.parametrize("cached", [False, True], ids=["in_core", "cached_polynomial"])
def test_two_rank_krr_matches_one_process_and_jax(a8b_run, cached):
    """The sweep at two ranks: α (gathered here for the test) against one
    process's and the reference's; one all-reduce a block step, never an
    all-gather; the prediction one all-reduce of Σ_r K(x, X_r)·α_r."""
    import torch

    from keystone_tpu.models import kernel_ridge as jkr
    from keystone_tpu_torch.models import kernel_ridge as kr

    _, _, got, counts = a8b_run
    x, y, xt = W.krr_problem()
    if cached:
        gens = (jkr.PolynomialKernelGenerator(2, 0.1, 1.0), kr.PolynomialKernelGenerator(2, 0.1, 1.0))
        key, rtol = "krr_cached", RTOL_POLY
    else:
        gens = (jkr.GaussianKernelGenerator(W.KRR_GAMMA), kr.GaussianKernelGenerator(W.KRR_GAMMA))
        key, rtol = "krr", 0.0
    kw = dict(W.KRR, cache_kernel_blocks=cached)
    want = jkr.KernelRidgeRegressionEstimator(gens[0], **kw).fit_arrays(x, y)
    one = kr.KernelRidgeRegressionEstimator(gens[1], **kw).fit_arrays(x, y, device="cpu")
    steps = W.KRR["num_epochs"] * -(-x.shape[0] // W.KRR["block_size"])
    for g, c in zip(got, counts):
        for a in (one.alpha.numpy()[:x.shape[0]], np.asarray(want.alpha)[:x.shape[0]]):
            np.testing.assert_allclose(g[f"{key}_alpha"], a, atol=ATOL_ALPHA, rtol=rtol)
        # the cached sweep agrees on its device budget first (one MIN all-reduce)
        assert c[key] == {"all_reduce": steps + cached, "all_gather": 0, "broadcast": 0, "argmax": 0}
        if not cached:
            np.testing.assert_allclose(g["krr_pred"], one(torch.from_numpy(xt)).numpy(), atol=ATOL_PRED)
            assert c["krr_predict"] == {"all_reduce": 1, "all_gather": 0, "broadcast": 0, "argmax": 0}


def test_two_rank_krr_cache_decision_agrees_under_split_budgets(a8b_run):
    """The cached sweep with rank 0's budget between the two slices' needs
    (102 and 101 rows) and rank 1's above both: every rank decides from
    the largest slice against the least budget, so neither keeps its
    tiles and the block steps' all-reduces stay alike; α is the cached
    fit's, which kept them, bit for bit."""
    _, _, got, counts = a8b_run
    x, _, _ = W.krr_problem()
    steps = W.KRR["num_epochs"] * -(-x.shape[0] // W.KRR["block_size"])
    for g, c in zip(got, counts):
        np.testing.assert_array_equal(g["krr_cached_split_alpha"], g["krr_cached_alpha"])
        assert c["krr_cached_split"] == {"all_reduce": steps + 1, "all_gather": 0, "broadcast": 0, "argmax": 0}


def test_two_rank_krr_mapper_saves_whole_and_refuses_another_axis(a8b_run):
    """A two-rank KRR mapper holds its rank's rows: it refused to predict
    on the local mesh and to pickle (in the worker); its gathered() model,
    saved by rank 0, loads in one process and predicts as one process's
    fit of every row."""
    import torch

    from keystone_tpu_torch.models import kernel_ridge as kr

    out, text, got, _ = a8b_run
    assert text.count("KRR_MAPPER_OK") == 2
    x, y, xt = W.krr_problem()
    whole = torch.load(out / "krr_whole.pt", weights_only=False)
    assert whole.data_axis is None and whole.train_x.shape[0] == 2 * 128  # two ranks' 102 rows in 4 blocks of 32
    pred = whole(torch.from_numpy(xt)).numpy()
    one = kr.KernelRidgeRegressionEstimator(kr.GaussianKernelGenerator(W.KRR_GAMMA), **W.KRR).fit_arrays(
        x, y, device="cpu")
    np.testing.assert_allclose(pred, one(torch.from_numpy(xt)).numpy(), atol=ATOL_PRED)
    for g in got:
        np.testing.assert_array_equal(g["krr_whole_pred"], pred)
        np.testing.assert_allclose(g["krr_whole_pred"], g["krr_pred"], atol=ATOL_PRED)


def test_sharded_state_loads_at_one_rank_and_at_another_data_axis(a8b_run):
    """The two ranks' sharded save (each loaded its own file back, in the
    worker) loads whole in one process, and re-sliced under a data axis
    of three."""
    import torch

    from keystone_tpu_torch.ops.stats import NormalizeRows
    from keystone_tpu_torch.parallel import mesh
    from keystone_tpu_torch.workflow import state

    out, text, got, _ = a8b_run
    assert text.count("STATE_OK") == 2
    key = str(got[0]["state_key"])
    assert sorted(f for f in os.listdir(out / "state") if f.endswith(".npz")) == [f"{key}.d2.00000.npz",
                                                                                  f"{key}.d2.00001.npz"]
    x = W.pca_rows_problem()
    want = NormalizeRows().apply_batch(torch.from_numpy(x))
    whole = state.load_prefix(str(out / "state"), key, "cpu")
    assert not whole.is_rank_slice and whole.n == x.shape[0]
    torch.testing.assert_close(whole.array, want)
    for r in range(3):
        with mesh.use_mesh(mesh.Mesh(data=3, rank=r)):
            part = state.load_prefix(str(out / "state"), key, "cpu")
        sl = mesh.slice_rows(x.shape[0], 3, r)
        assert part.is_rank_slice and part.rank_offset == sl.start and part.local_n == sl.stop - sl.start
        assert part.array.shape[0] == -(-x.shape[0] // 3)
        torch.testing.assert_close(part.array[:part.local_n], want[sl])


def test_run_at_two_ranks_matches_one_process(a8b_run):
    """ImageNetSiftLcsFV.run as a job of two ranks (each featurizing its
    slice of the 25 training images) against the same run in one process:
    both ranks report the same predictions, which agree with one
    process's top-1 on at least RUN_TOP1_AGREEMENT of the test images."""
    from keystone_tpu_torch.pipelines.imagenet_sift_lcs_fv import Config, ImageNetSiftLcsFV

    _, text, got, _ = a8b_run
    assert text.count("RUN_OK") == 2
    res = {}
    one = ImageNetSiftLcsFV.run(Config(**W.RUN), device="cpu", out=res)
    np.testing.assert_array_equal(got[0]["run_predictions"], got[1]["run_predictions"])
    top1 = np.mean(got[0]["run_predictions"][:, 0] == np.asarray(res["predictions"])[:, 0])
    assert top1 >= RUN_TOP1_AGREEMENT, (top1, got[0]["run_predictions"], res["predictions"])
    assert abs(float(got[0]["run_top1_error"]) - one["top1_error"]) <= RUN_TOP1_MARGIN

"""One rank of the port's multi-process tests (tests/test_torch_multihost.py).

Each rank initializes ``keystone_tpu_torch.parallel.multihost`` over Gloo
on the CPU, feeds only its own slice of deterministic global problems,
fits, and writes what it got to ``<out>/<mode>_rank<r>.npz``; markers on
stdout name each leg that held.  Modes:

- ``main`` (2 ranks): LinearMapEstimator against the exact ridge solve,
  DistributedPCAEstimator, the weighted BCD's ``fit_store`` over a store
  of each rank's own rows against the in-memory fit of the full data, the
  in-core BCD, a health barrier with rank 1 sick, and the uninterrupted
  checkpointed BCD and sparse L-BFGS (the controls of the kill tests);
  run under a ``multihost.init`` fault plan, retried once;
- ``crash-bcd`` / ``crash-sparse`` (2 ranks): rank 1 dies mid-fit;
- ``resume`` (2 ranks): both fits relaunched on the crashed directories;
- ``mesh22`` (4 ranks): the in-core BCD and the GMM fit on a 2 (data) ×
  2 (model) mesh, and the sick barrier on every rank;
- ``a8b`` (2 ranks): the rest of the parallel layer on rank slices:
  k-means++ (its seeds and its Lloyd steps from given centres), the GMM
  EM (dense and ragged, from the port's own start and from given
  centres), ColumnSampler, PCAEstimator (the gathered SVD and the masked
  sums), naive Bayes and logistic regression (dense and sparse), the
  in-core and cached KRR with its prediction (and a cached fit under
  budgets that differ by rank), the mapper's refusals and its gathered
  whole model (saved by rank 0), a sharded saved state
  (saved, then loaded at the same data axis), and
  ``ImageNetSiftLcsFV.run``; each fit's collectives are counted.  The
  given centres come from ``<out>/a8b_inputs.npz``, which the test writes.
"""

import hashlib
import json
import os
import sys

import numpy as np


def linear_problem():
    rng = np.random.default_rng(0)
    n, d, k = 256, 32, 4
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, k)).astype(np.float32)
    return x, (x @ w + 0.01 * rng.normal(size=(n, k))).astype(np.float32)


def pca_problem():
    rng = np.random.default_rng(3)
    base = rng.normal(size=(200, 6)).astype(np.float32)
    base[:, 2:] *= 0.05
    rot, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    return (base @ rot.T).astype(np.float32)


def store_problem():
    rng = np.random.default_rng(0)
    n, d, k = 128, 48, 4
    x = rng.normal(size=(n, d)).astype(np.float32)
    lbl = rng.choice(k, size=n, p=[0.6, 0.2, 0.12, 0.08])
    y = -np.ones((n, k), np.float32)
    y[np.arange(n), lbl] = 1.0
    return x, y


def bcd_problem():
    """The checkpointed fit's (as the reference's fault test), n odd so
    that the last rank's slice is padded."""
    rng = np.random.default_rng(0)
    n, d, k = 255, 48, 3
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, k)).astype(np.float32)
    return x, (x @ w + 0.01 * rng.normal(size=(n, k))).astype(np.float32)


def incore_problem():
    """The in-core BCD of the mesh tests: 5 classes, so that a model axis
    of 2 pads the columns, and an odd n."""
    rng = np.random.default_rng(7)
    n, d, k = 203, 40, 5
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x, rng.normal(size=(n, k)).astype(np.float32)


def sparse_problem():
    import scipy.sparse as sparse

    rng = np.random.default_rng(0)
    n, d, k, nnz = 128, 20_000, 3, 8
    rows = []
    for _ in range(n):
        idx = rng.choice(d, size=nnz, replace=False)
        rows.append(sparse.csr_matrix((rng.normal(size=nnz).astype(np.float32), (np.zeros(nnz), idx)),
                                      shape=(1, d)))
    return rows, rng.normal(size=(n, k)).astype(np.float32)


def clustered(seed, n, d, k, spread=1.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 4.0
    return (centers[rng.integers(0, k, size=n)] + spread * rng.normal(size=(n, d))).astype(np.float32)


def kmeans_problem():
    return clustered(11, 203, 4, 5)


def gmm_problem():
    return clustered(12, 301, 3, 3)


def ragged_problem():
    """(9, 7, 3) descriptor sets and an (9, 7) mask; item 0 has none."""
    rng = np.random.default_rng(13)
    x = clustered(13, 63, 3, 3).reshape(9, 7, 3)
    mask = (rng.random((9, 7)) < 0.8).astype(np.float32)
    mask[0] = 0.0
    return x, mask


def sampler_problem():
    rng = np.random.default_rng(14)
    mask = (rng.random((7, 5)) < 0.7).astype(np.float32)
    mask[:, 0] = 1.0
    return rng.normal(size=(7, 5, 3)).astype(np.float32), mask


def pca_rows_problem():
    rng = np.random.default_rng(15)
    base = rng.normal(size=(157, 6)) * 3.0 * 0.6 ** np.arange(6)
    rot = np.linalg.qr(rng.normal(size=(6, 6)))[0]
    return (base @ rot.T + rng.normal(size=6)).astype(np.float32)


def nb_problem():
    """Counts-like rows (dense and as scipy rows) and int labels."""
    import scipy.sparse as sparse

    rng = np.random.default_rng(16)
    n, d, k = 121, 30, 4
    dense = (rng.random((n, d)) < 0.2) * rng.integers(1, 5, size=(n, d))
    dense = dense.astype(np.float32)
    rows = [sparse.csr_matrix(dense[i:i + 1]) for i in range(n)]
    return dense, rows, rng.integers(0, k, size=n).astype(np.int32), k


def logistic_problem():
    rng = np.random.default_rng(17)
    n, d, k = 151, 20, 3
    dense = (rng.normal(size=(n, d)) * (rng.random((n, d)) < 0.3)).astype(np.float32)
    labels = np.argmax(dense @ rng.normal(size=(d, k)), 1).astype(np.int32)
    return dense, labels, k


def krr_problem():
    rng = np.random.default_rng(18)
    n, d, k = 203, 6, 2
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.stack([np.sin(x[:, 0]) + 0.1 * x[:, 1], np.cos(x[:, 2])], 1).astype(np.float32)
    return x, y, rng.normal(size=(17, d)).astype(np.float32)


KM = dict(num_means=5, max_iterations=6, seed=3)
GMM = dict(k=3, max_iterations=8, seed=2, kmeans_iters=4)
LOGISTIC = dict(lam=1e-3, num_iters=60)
KRR = dict(lam=1e-3, block_size=32, num_epochs=2)
KRR_GAMMA = 0.3
# a device budget (before the cache's half) between the cached sweep's
# needs at 102 rows a rank and at 101 (7 blocks of 32: 120 064 and
# 119 168 bytes of column tiles and K_bb)
KRR_SPLIT_BUDGET = 2 * 119_600
RUN = dict(num_classes=4, gmm_k=4, gmm_iters=4, pca_dims=16, descriptor_samples_per_image=16,
           solver_block_size=512, synthetic_n=25, image_size=32, sift_step=8, lcs_step=8)
BCD = dict(block_size=16, num_iter=6, lam=1e-3, fit_intercept=False)
INCORE = dict(block_size=16, num_iter=3, lam=1e-2, fit_intercept=True)
SPARSE = dict(lam=1e-2, num_iterations=12, history=4)


def digest(w) -> str:
    return hashlib.sha256(np.round(np.asarray(w, np.float64), 4).tobytes()).hexdigest()[:16]


def main() -> None:
    port, world, rank, mode, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
    import torch

    torch.set_num_threads(1)
    from keystone_tpu_torch.obs import metrics
    from keystone_tpu_torch.parallel import multihost, set_mesh

    multihost.initialize(f"127.0.0.1:{port}", num_processes=world, process_id=rank, backend="gloo",
                         device="cpu", initialization_timeout=60)
    set_mesh(multihost.hybrid_mesh(model_parallelism=2 if mode == "mesh22" else 1))
    got = {}
    try:
        if mode == "main":
            got["init_attempts"] = metrics.REGISTRY.counter_value("multihost.init_attempts")
            print("INIT_ATTEMPTS", int(got["init_attempts"]), flush=True)
            main_legs(rank, out, got)
        elif mode == "mesh22":
            got["incore"] = incore_fit()
            got["gmm"] = gmm_fit()
            print("MESH_OK", flush=True)
            sick_leg(rank)
        elif mode == "a8b":
            a8b_legs(rank, out, got)
        elif mode in ("crash-bcd", "resume"):
            bcd_leg(rank, out, "crash" if mode == "crash-bcd" else "resume", got)
        if mode in ("crash-sparse", "resume"):
            sparse_leg(rank, out, "crash" if mode == "crash-sparse" else "resume", got)
        np.savez(os.path.join(out, f"{mode}_rank{rank}.npz"), **got)
        print(f"DONE rank={rank}", flush=True)
    finally:
        multihost.shutdown()


def main_legs(rank, out, got) -> None:
    from keystone_tpu_torch.models.block_weighted_ls import BlockWeightedLeastSquaresEstimator
    from keystone_tpu_torch.models.linear import LinearMapEstimator
    from keystone_tpu_torch.models.pca import DistributedPCAEstimator
    from keystone_tpu_torch.parallel import multihost
    from keystone_tpu_torch.workflow.blockstore import FeatureBlockStore

    # the exact ridge solve of the full data (the reference's "distributed
    # == exact local" pattern), within 2e-3 (tests/multihost_worker.py)
    x, y = linear_problem()
    n, lam = x.shape[0], 0.1
    sl = multihost.process_batch_slice(n)
    model = LinearMapEstimator(lam=lam).fit_dataset(multihost.make_global_dataset(x[sl], n, device="cpu"),
                                                    multihost.make_global_dataset(y[sl], n, device="cpu"))
    xc, yc = x.astype(np.float64) - x.mean(0), y.astype(np.float64) - y.mean(0)
    w_ref = np.linalg.solve(xc.T @ xc + lam * n * np.eye(x.shape[1]), xc.T @ yc)
    err = float(np.abs(model.weights.numpy() - w_ref).max())
    assert err < 2e-3, err
    got["linear_w"], got["linear_b"] = model.weights.numpy(), model.intercept.numpy()
    print(f"LINEAR_OK err={err:.2e}", flush=True)

    x = pca_problem()
    sl = multihost.process_batch_slice(x.shape[0])
    pca = DistributedPCAEstimator(2).fit_dataset(multihost.make_global_dataset(x[sl], x.shape[0], device="cpu"))
    got["pca_c"], got["pca_mean"] = pca.components.numpy(), pca.mean.numpy()
    print("PCA_OK", flush=True)

    # each rank spills ONLY its slice to its own store; no rank holds the
    # full matrix (the per-executor spilled partitions of the reference)
    x, y = store_problem()
    n = x.shape[0]
    sl = multihost.process_batch_slice(n)
    store = FeatureBlockStore.from_array(os.path.join(out, f"shard{rank}"), x[sl], block_size=16)
    assert store.n == len(range(n)[sl]) and all(store.read_block(b).shape[0] == store.n
                                                for b in range(store.num_blocks))
    est = BlockWeightedLeastSquaresEstimator(block_size=16, num_iter=3, lam=1e-2, mixture_weight=0.5)
    oc = est.fit_store(store, multihost.make_global_dataset(y[sl], n, device="cpu"))
    ref = est.fit_arrays(x, y, device="cpu")  # the in-memory fit of the FULL data, on this rank alone
    err = float((oc.flat_weights - ref.flat_weights).abs().max())
    assert err < 5e-4, err
    got["store_w"], got["store_b"] = oc.flat_weights.numpy(), oc.intercept.numpy()
    got["store_rows"] = np.asarray([store.n])
    print(f"STORE_OK err={err:.2e} rows={store.n}", flush=True)

    incore = incore_fit()
    got["incore"] = incore
    sick_leg(rank)
    bcd_leg(rank, out, "control", got)
    sparse_leg(rank, out, "control", got)


def incore_fit() -> np.ndarray:
    """The in-core BCD (fit_dataset) on this rank's data slice; the
    weights and intercept flattened into one array."""
    import torch

    from keystone_tpu_torch.models.block_ls import BlockLeastSquaresEstimator
    from keystone_tpu_torch.parallel import multihost

    x, y = incore_problem()
    n = x.shape[0]
    sl = multihost.process_batch_slice(n)
    m = BlockLeastSquaresEstimator(**INCORE).fit_dataset(multihost.make_global_dataset(x[sl], n, device="cpu"),
                                                         multihost.make_global_dataset(y[sl], n, device="cpu"))
    return torch.cat([m.flat_weights.reshape(-1), m.intercept.reshape(-1)]).numpy()


def _slice(a, n=None):
    """This rank's rows of ``a`` as a rank-slice Dataset on the CPU."""
    from keystone_tpu_torch.parallel import multihost

    n = len(a) if n is None else n
    return multihost.make_global_dataset(a[multihost.process_batch_slice(n)], n, device="cpu")


def _counted(fn):
    """``fn()`` and the collectives it issued."""
    from keystone_tpu_torch.parallel import collectives

    collectives.reset_counts()
    out = fn()
    return out, dict(collectives.COUNTS)


def _gather_rows(t, valid):
    """Every rank's first ``valid`` rows of t, in rank order (a test probe)."""
    from keystone_tpu_torch.parallel import multihost

    counts = multihost.data_axis_counts(valid)
    rows = max(counts)
    padded = np.zeros((rows,) + tuple(t.shape[1:]), np.float32)
    padded[:valid] = t[:valid].numpy()
    every = multihost.gather_to_host(padded)
    return np.concatenate([every[i * rows:i * rows + c] for i, c in enumerate(counts)])


def gmm_fit() -> np.ndarray:
    """The GMM fit_dataset on this rank's slice of gmm_problem(), flat."""
    from keystone_tpu_torch.models.gmm import GaussianMixtureModelEstimator

    m = GaussianMixtureModelEstimator(**GMM).fit_dataset(_slice(gmm_problem()))
    return np.concatenate([m.weights.numpy().ravel(), m.means.numpy().ravel(), m.variances.numpy().ravel()])


def a8b_legs(rank, out, got) -> None:
    import torch

    from keystone_tpu_torch.models import gmm as G
    from keystone_tpu_torch.models import kernel_ridge as kr
    from keystone_tpu_torch.models import kmeans as KM_
    from keystone_tpu_torch.models.logistic import LogisticRegressionEstimator
    from keystone_tpu_torch.models.naive_bayes import NaiveBayesEstimator
    from keystone_tpu_torch.models.pca import PCAEstimator
    from keystone_tpu_torch.ops.stats import ColumnSampler
    from keystone_tpu_torch.parallel import collectives, mesh, multihost
    from keystone_tpu_torch.workflow.dataset import Dataset

    given = dict(np.load(os.path.join(out, "a8b_inputs.npz")))
    counts = {}
    # k-means++: the seeds (exact rows of x), the fit, and Lloyd from given centres
    x = kmeans_problem()
    d = _slice(x)
    row_ok = mesh.local_rows_mask(d.array.shape[0], d.local_n)
    seeds, counts["kmeans_seed"] = _counted(lambda: KM_._kmeans_seed(d.array, row_ok, KM["num_means"],
                                                                     KM_.generator(KM["seed"], "cpu"),
                                                                     span=(d.rank_offset, d.local_n, d.n)))
    got["kmeans_seeds"] = seeds.numpy()
    got["kmeans"] = KM_.KMeansPlusPlusEstimator(**KM).fit_dataset(d).centers.numpy()
    lloyd, counts["lloyd"] = _counted(lambda: KM_._lloyd(d.array, row_ok, torch.from_numpy(given["km_start"]),
                                                         KM["max_iterations"]))
    got["lloyd"] = lloyd.numpy()
    # the GMM: dense from the port's own start, from the reference's
    # centres, and ragged sets with a mask
    got["gmm"] = gmm_fit()
    d = _slice(gmm_problem())
    fit, counts["gmm_em"] = _counted(lambda: G._gmm_fit(
        d.array, d.n, None, GMM["k"], GMM["max_iterations"], 1e-6, GMM["seed"], GMM["kmeans_iters"],
        init_means=torch.from_numpy(given["gmm_start"]), span=(d.rank_offset, d.local_n, d.n)))
    got["gmm_from_start"] = np.concatenate([a.numpy().ravel() for a in fit])
    xr, mr = ragged_problem()
    sl = multihost.process_batch_slice(len(xr))
    dr = _slice(xr)
    dr.mask = torch.from_numpy(np.concatenate([mr[sl], np.zeros((dr.array.shape[0] - len(mr[sl]), mr.shape[1]),
                                                                np.float32)]))
    m = G.GaussianMixtureModelEstimator(**GMM).fit_dataset(dr)
    got["gmm_ragged"] = np.concatenate([m.weights.numpy().ravel(), m.means.numpy().ravel(),
                                        m.variances.numpy().ravel()])
    fit, counts["gmm_ragged_em"] = _counted(lambda: G._gmm_fit(
        dr.array, None, dr.mask, GMM["k"], GMM["max_iterations"], 1e-6, GMM["seed"], GMM["kmeans_iters"],
        init_means=torch.from_numpy(given["ragged_start"]), span=(dr.rank_offset, dr.local_n, dr.n)))
    got["gmm_ragged_from_start"] = np.concatenate([a.numpy().ravel() for a in fit])
    # ColumnSampler: this rank's flat rows, gathered for the test
    xs, ms = sampler_problem()
    sl = multihost.process_batch_slice(len(xs))
    ds = _slice(xs)
    ds.mask = torch.from_numpy(np.concatenate([ms[sl], np.zeros((ds.array.shape[0] - len(ms[sl]), ms.shape[1]),
                                                                np.float32)]))
    sampled = ColumnSampler(4, seed=5).apply_dataset(ds)
    got["sampled"] = _gather_rows(sampled.array, sampled.local_n)
    got["sampled_n"] = np.asarray([sampled.n, sampled.local_n, sampled.rank_offset])
    # PCA: the gathered SVD, and the masked branch's all-reduced sums
    pca, counts["pca"] = _counted(lambda: PCAEstimator(3).fit_dataset(_slice(pca_rows_problem())))
    got["pca_c"], got["pca_mean"] = pca.components.numpy(), pca.mean.numpy()
    mp, counts["pca_masked"] = _counted(lambda: PCAEstimator(2).fit_dataset(dr))
    got["pca_masked_c"], got["pca_masked_mean"] = mp.components.numpy(), mp.mean.numpy()
    # naive Bayes, dense and sparse
    dense, rows, labels, k = nb_problem()
    for form, data in (("dense", _slice(dense)), ("sparse", _slice(rows))):
        nb, counts[f"nb_{form}"] = _counted(lambda: NaiveBayesEstimator(k).fit_dataset(data, _slice(labels)))
        got[f"nb_{form}_prior"], got[f"nb_{form}_cond"] = nb.log_prior.numpy(), nb.log_cond.numpy()
    # logistic regression, dense and sparse
    import scipy.sparse as sparse

    dense, labels, k = logistic_problem()
    rows = [sparse.csr_matrix(dense[i:i + 1]) for i in range(dense.shape[0])]
    for form, data in (("dense", _slice(dense)), ("sparse", _slice(rows))):
        lr, counts[f"logistic_{form}"] = _counted(
            lambda: LogisticRegressionEstimator(k, **LOGISTIC).fit_dataset(data, _slice(labels)))
        got[f"logistic_{form}"] = lr.weights.numpy()
    # KRR: the in-core sweep, its prediction, the cached sweep with a
    # polynomial generator
    x, y, xt = krr_problem()
    est = kr.KernelRidgeRegressionEstimator(kr.GaussianKernelGenerator(KRR_GAMMA), **KRR)
    dx, dy = _slice(x), _slice(y)
    krr, counts["krr"] = _counted(lambda: est.fit_dataset(dx, dy))
    got["krr_alpha"] = _gather_rows(krr.alpha, dx.local_n)
    pred, counts["krr_predict"] = _counted(lambda: krr.apply_batch(torch.from_numpy(xt)))
    got["krr_pred"] = pred.numpy()
    poly = kr.KernelRidgeRegressionEstimator(kr.PolynomialKernelGenerator(2, 0.1, 1.0), cache_kernel_blocks=True,
                                             **KRR)
    model, counts["krr_cached"] = _counted(lambda: poly.fit_dataset(dx, dy))
    got["krr_cached_alpha"] = _gather_rows(model.alpha, dx.local_n)
    # the cache decision under budgets that differ by rank: rank 0's lies
    # between the two slices' tiles (102 and 101 rows), rank 1's above both
    prev = os.environ.get("KEYSTONE_HBM_BUDGET_BYTES")
    os.environ["KEYSTONE_HBM_BUDGET_BYTES"] = str(KRR_SPLIT_BUDGET if rank == 0 else 1 << 30)
    try:
        model, counts["krr_cached_split"] = _counted(lambda: poly.fit_dataset(dx, dy))
    finally:
        os.environ.pop("KEYSTONE_HBM_BUDGET_BYTES")
        if prev is not None:
            os.environ["KEYSTONE_HBM_BUDGET_BYTES"] = prev
    got["krr_cached_split_alpha"] = _gather_rows(model.alpha, dx.local_n)
    krr_mapper_leg(rank, out, got, krr, xt)
    print("FITS_OK", flush=True)
    # the sharded saved state of a named rank slice's prefix
    state_leg(rank, out, got)
    # ImageNetSiftLcsFV.run as a job of two ranks
    from keystone_tpu_torch.ops import fisher_kernels
    from keystone_tpu_torch.pipelines.imagenet_sift_lcs_fv import Config, ImageNetSiftLcsFV

    res = {}
    metrics = ImageNetSiftLcsFV.run(Config(**RUN), device="cpu", out=res)
    got["run_predictions"] = np.asarray(res["predictions"])
    got["run_top1_error"] = np.asarray(metrics["top1_error"])
    print(f"RUN_OK {json.dumps({k: v for k, v in metrics.items() if k != 'pipeline'})}", flush=True)
    got["counts"] = np.asarray(json.dumps(counts))
    assert collectives.COUNTS is not None and fisher_kernels is not None


def krr_mapper_leg(rank, out, got, model, xt) -> None:
    """A two-rank KRR mapper refuses another data axis and a pickle of
    its part; its gathered() model, saved by rank 0, is the whole fit."""
    import pickle

    import torch

    from keystone_tpu_torch.parallel import mesh

    with mesh.use_mesh(mesh.local_mesh()):
        try:
            model.apply_batch(torch.from_numpy(xt))
        except ValueError as e:
            assert "data axis of 2" in str(e), e
        else:
            raise AssertionError("a two-rank KRR mapper predicted alone")
    try:
        pickle.dumps(model)
    except TypeError as e:
        assert "gathered()" in str(e), e
    else:
        raise AssertionError("a two-rank KRR mapper's part pickled")
    whole = model.gathered()
    if rank == 0:
        torch.save(whole, os.path.join(out, "krr_whole.pt"))
    got["krr_whole_pred"] = whole.apply_batch(torch.from_numpy(xt)).numpy()
    print("KRR_MAPPER_OK", flush=True)


def state_leg(rank, out, got) -> None:
    """A named rank slice through a transformer, saved sharded; then the
    prefix loaded back at this data axis (its own file)."""
    import torch

    from keystone_tpu_torch.ops.stats import NormalizeRows
    from keystone_tpu_torch.parallel import multihost
    from keystone_tpu_torch.workflow import state
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    x = pca_rows_problem()
    n = x.shape[0]
    d = multihost.make_global_dataset(x[multihost.process_batch_slice(n)], n, device="cpu", name="state-rows")
    pipe = Pipeline.of(NormalizeRows())
    saved = state.save_pipeline_state(pipe(d), os.path.join(out, "state"))
    keys = sorted({f.split(".")[0] for f in os.listdir(os.path.join(out, "state")) if ".d2." in f})
    assert saved == 1 and len(keys) == 1, (saved, keys)
    back = state.load_prefix(os.path.join(out, "state"), keys[0], "cpu")
    assert back.is_rank_slice and back.local_n == d.local_n and back.rank_offset == d.rank_offset, back
    torch.testing.assert_close(back.array[:back.local_n], NormalizeRows().apply_batch(d.array[:d.local_n]))
    got["state_key"] = np.asarray(keys[0])
    print("STATE_OK", flush=True)


def sick_leg(rank) -> None:
    from keystone_tpu_torch.parallel import SickHostError, health_barrier

    assert health_barrier(ok=True, timeout=60.0, tag="all_well")
    try:
        health_barrier(ok=rank != 1, timeout=60.0, tag="sick")
    except SickHostError as e:
        assert "[1]" in str(e), e
        print("SICK_RAISED", flush=True)
    else:
        raise AssertionError("a sick rank did not abort the barrier")


def bcd_leg(rank, out, how, got) -> None:
    import keystone_tpu_torch.models.block_ls as bls
    from keystone_tpu_torch.parallel import multihost

    x, y = bcd_problem()
    n = x.shape[0]
    sl = multihost.process_batch_slice(n)
    ckpt = os.path.join(out, "bcd_control" if how == "control" else "bcd_ckpt")
    path = os.path.join(ckpt, "bcd_epoch.npz")
    if how == "crash" and rank == 1:
        orig, calls = bls._bcd_epoch_body, {"n": 0}

        def crashing(*a, **kw):
            if calls["n"] >= 3:  # before the 4th epoch: between collectives
                sys.stderr.write("FAULT: injected crash before epoch 3\n")
                sys.stderr.flush()
                os._exit(42)
            calls["n"] += 1
            return orig(*a, **kw)

        bls._bcd_epoch_body = crashing
    if how == "resume":
        with np.load(path) as z:
            print(f"RESUMED_FROM bcd {int(z['epoch'])}", flush=True)
    est = bls.BlockLeastSquaresEstimator(**BCD)
    model = est.fit_checkpointed(multihost.make_global_dataset(x[sl], n, device="cpu"),
                                 multihost.make_global_dataset(y[sl], n, device="cpu"), checkpoint_dir=ckpt)
    w = model.flat_weights.numpy()
    got[f"bcd_{how}"] = w
    print(f"BCD_OK how={how} digest={digest(w)}", flush=True)


def sparse_leg(rank, out, how, got) -> None:
    import keystone_tpu_torch.models.lbfgs as lb
    from keystone_tpu_torch.parallel import multihost

    rows, y = sparse_problem()
    n = len(rows)
    sl = multihost.process_batch_slice(n)
    ckpt = os.path.join(out, "sparse_control" if how == "control" else "sparse_ckpt")
    if how == "crash" and rank == 1:
        orig = lb._lbfgs_checkpoint_callbacks

        def crashing_callbacks(*a, **kw):
            load_cb, save_cb = orig(*a, **kw)

            def save(it, carry):
                save_cb(it, carry)
                if it >= 4:
                    sys.stderr.write(f"FAULT: injected crash after the carry save at it={it}\n")
                    sys.stderr.flush()
                    os._exit(42)

            return load_cb, save

        lb._lbfgs_checkpoint_callbacks = crashing_callbacks
    if how == "resume":
        with np.load(os.path.join(ckpt, "lbfgs_sparse.npz")) as z:
            print(f"RESUMED_FROM sparse {int(z['it'])}", flush=True)
    model = lb.SparseLBFGSwithL2(**SPARSE).fit_checkpointed(
        multihost.make_global_dataset(rows[sl], n, device="cpu"),
        multihost.make_global_dataset(y[sl], n, device="cpu"), checkpoint_dir=ckpt, checkpoint_every=4)
    w = model.weights.numpy()
    got[f"sparse_{how}"] = w
    print(f"SPARSE_OK how={how} digest={digest(w)} {json.dumps({'rows': len(rows[sl])})}", flush=True)


if __name__ == "__main__":
    main()

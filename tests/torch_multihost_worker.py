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
- ``mesh22`` (4 ranks): the in-core BCD on a 2 (data) × 2 (model) mesh,
  and the sick barrier on every rank.
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
            print("MESH_OK", flush=True)
            sick_leg(rank)
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

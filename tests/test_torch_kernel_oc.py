"""The port's out-of-core kernel tier against the JAX package on the CPU:
the row-block store (round trips, either package reading the other's
store, the shared device feed, integrity checks), the out-of-core kernel
sweep against the reference's and the port's in-core sweep, the streamed
fit and its model's save/load, the epoch checkpoint, the BlockKernelMatrix
disk tier and the cached fit that takes it over the memory budget.

Tolerances are the reference's own (tests/test_kernel_oc.py): α within
1e-5 between the out-of-core and in-core sweeps, which sum F's tiles in
another order, and prediction r² ≥ 0.999; checkpoint resumes are held
bit for bit.  Across the two packages α is held at 1e-5 of its largest
entry: on the reference's problem (λn ≈ 0.015, |α| up to ~20) the two
packages' f32 Cholesky solves round apart by ~4e-6 of that."""

import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.models import kernel_ridge as jkr
from keystone_tpu.models.kernel_matrix import BlockKernelMatrix as JBlockKernelMatrix
from keystone_tpu.workflow import Dataset as JDataset
from keystone_tpu.workflow.blockstore import RowBlockStore as JRowStore
from keystone_tpu_torch.convert import oc_krr_mapper_from_numpy
from keystone_tpu_torch.loaders.stream import batched
from keystone_tpu_torch.models import kernel_ridge as kr
from keystone_tpu_torch.models.kernel_matrix import BlockKernelMatrix
from keystone_tpu_torch.utils import durable
from keystone_tpu_torch.workflow import profiling
from keystone_tpu_torch.workflow.blockstore import FeatureBlockStore, RowBlockStore
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset
from keystone_tpu_torch.workflow.pipeline import FittedPipeline, Pipeline

ATOL_ALPHA = 1e-5  # tests/test_kernel_oc.py:107
R2_MIN = 0.999


def _problem(n=150, d=12, k=3, seed=0):
    """The reference's out-of-core problem (tests/test_kernel_oc.py::_problem)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, k)).astype(np.float32)
    y = (x @ w + 0.01 * rng.normal(size=(n, k))).astype(np.float32)
    return x, y


def _est(bs=32, epochs=4, gamma=0.05, lam=1e-4, **kw):
    return kr.KernelRidgeRegressionEstimator(kr.GaussianKernelGenerator(gamma), lam=lam, block_size=bs,
                                             num_epochs=epochs, **kw)


def _jest(bs=32, epochs=4, gamma=0.05, lam=1e-4, **kw):
    return jkr.KernelRidgeRegressionEstimator(jkr.GaussianKernelGenerator(gamma), lam=lam, block_size=bs,
                                              num_epochs=epochs, **kw)


def _labels(y):
    return Dataset(torch.from_numpy(y), device="cpu")


def _r2(a, b):
    return 1.0 - ((a - b) ** 2).sum() / ((b - b.mean(axis=0)) ** 2).sum()


def _uneven(x):
    """Batches of uneven sizes that cross the blocks' boundaries."""
    i = 0
    for m in (7, 20, 16, 3, 24):
        yield x[i:i + m]
        i += m


# ------------------------------------------------------------- the store


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_block_store_round_trip_matches_reference(tmp_path, dtype):
    x, _ = _problem(n=70, d=5)
    port = RowBlockStore.from_batches(str(tmp_path / "p"), _uneven(x), 70, 16, dtype=dtype)
    ref = JRowStore.from_batches(str(tmp_path / "r"), _uneven(x), 70, 16, dtype=dtype)
    assert (port.num_blocks, port.n, port.d, port.nbytes()) == (ref.num_blocks, ref.n, ref.d, ref.nbytes()) \
        == (5, 70, 5, 5 * 16 * 5 * (2 if dtype == "bfloat16" else 4))
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "r"))
    blocks = [port.read_block(b) for b in range(5)]
    assert blocks[0].dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    rec = torch.cat(blocks).to(torch.float32).numpy()
    np.testing.assert_array_equal(rec, np.concatenate([np.asarray(ref.read_block(b)).astype(np.float32)
                                                       for b in range(5)]))
    if dtype == "float32":
        np.testing.assert_array_equal(rec[:70], x)
    assert not rec[70:].any()  # the final block's padding rows stay zero
    for b in range(5):  # the same bytes on disk, sidecars included
        name = f"rblock_{b:04d}.npy"
        for suffix in ("", ".b2"):
            with open(tmp_path / "p" / (name + suffix), "rb") as f, open(tmp_path / "r" / (name + suffix), "rb") as g:
                assert f.read() == g.read()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_each_package_reads_the_others_row_store(tmp_path, dtype):
    x, _ = _problem(n=50, d=7, seed=1)
    RowBlockStore.from_array(str(tmp_path / "p"), x, 16, dtype=dtype)
    JRowStore.from_array(str(tmp_path / "r"), x, 16, dtype=dtype)
    by_ref = JRowStore(str(tmp_path / "p"))
    by_port = RowBlockStore(str(tmp_path / "r"))
    assert (by_ref.n, by_ref.num_blocks, by_port.n, by_port.num_blocks) == (50, 4, 50, 4)
    for b in range(4):
        np.testing.assert_array_equal(np.asarray(by_ref.read_block(b)).astype(np.float32),
                                      by_port.read_block(b).to(torch.float32).numpy())


def test_row_store_rides_the_shared_device_feed_and_checks_integrity(tmp_path):
    assert RowBlockStore.iter_device_blocks is FeatureBlockStore.iter_device_blocks
    x, _ = _problem(n=64, d=6)
    st = RowBlockStore.from_array(str(tmp_path / "s"), x, 16)
    got = dict(st.iter_device_blocks([2, 0], "cpu"))
    np.testing.assert_array_equal(got[2].numpy(), x[32:48])
    np.testing.assert_array_equal(got[0].numpy(), x[:16])
    path = st._block_path(st.directory, 2)
    with open(path, "r+b") as f:  # a flipped byte: the sidecar catches it
        f.seek(200)
        f.write(b"\x11\x22\x33\x44")
    with pytest.raises(durable.CorruptStateError):
        RowBlockStore(st.directory).read_block(2)
    with open(st._block_path(st.directory, 1), "r+b") as f:  # a truncated block
        f.truncate(100)
    with pytest.raises(durable.CorruptStateError, match="truncated"):
        st.read_block(1)
    with pytest.raises(ValueError, match="would reach"):
        RowBlockStore.create(str(tmp_path / "t"), 4, 6, 16).append_rows(np.zeros((5, 6), np.float32))
    with pytest.raises(ValueError, match="expected 10"):
        RowBlockStore.from_batches(str(tmp_path / "u"), [x[:4]], 10, 16)


# ----------------------------------------------------- the out-of-core sweep


@pytest.mark.parametrize("n,bs", [(150, 32), (128, 32)])
def test_oc_krr_fit_matches_reference_and_in_core(tmp_path, n, bs):
    x, y = _problem(n=n)
    store = RowBlockStore.from_array(str(tmp_path / "s"), x, bs)
    oc = _est(bs).fit_store(store, _labels(y))
    assert isinstance(oc, kr.OutOfCoreKernelBlockLinearMapper) and oc.alpha.shape == (store.num_blocks * bs, 3)
    want = jkr._oc_krr_fit(JRowStore(store.directory), jnp.asarray(y), float(n), 0.05, 1e-4, 4)
    np.testing.assert_allclose(oc.alpha.numpy(), np.asarray(want), atol=ATOL_ALPHA * np.abs(want).max())
    ref = _est(bs).fit_arrays(x, y, device="cpu")
    np.testing.assert_allclose(oc.alpha.numpy(), ref.alpha.numpy(), atol=ATOL_ALPHA)
    assert not oc.alpha[n:].any()
    xt = np.random.default_rng(9).normal(size=(40, x.shape[1])).astype(np.float32)
    p_oc = oc(torch.from_numpy(xt)).numpy()
    assert _r2(p_oc, ref(torch.from_numpy(xt)).numpy()) >= R2_MIN
    # the reference's mapper on its own fit
    jmap = jkr.OutOfCoreKernelBlockLinearMapper(jkr.GaussianKernelGenerator(0.05), store.directory, want, n)
    np.testing.assert_allclose(p_oc, np.asarray(jmap.apply_batch(jnp.asarray(xt))), atol=1e-4)


def test_oc_sweep_stages_nb_squared_blocks_an_epoch(tmp_path, monkeypatch):
    x, y = _problem(n=96)
    store = RowBlockStore.from_array(str(tmp_path / "s"), x, 32)
    seen = []
    feed = RowBlockStore.iter_device_blocks

    def spy(self, order, device="cuda", **kw):
        seen.append(list(order))
        return feed(self, order, device, **kw)

    monkeypatch.setattr(RowBlockStore, "iter_device_blocks", spy)
    _est(32, epochs=2).fit_store(store, _labels(y))
    assert seen == [[0, 1, 2, 1, 0, 2, 2, 0, 1] * 2]  # one iterator: [b, then every i ≠ b], per epoch


def test_oc_stream_dataset_path_and_save_load(tmp_path, monkeypatch):
    """A StreamDataset reaching the estimator spills a store that backs
    the model: kept after the fit, reopened after a save and a load."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    x, y = _problem(seed=4)
    est = _est(epochs=3)
    sd = StreamDataset(batched(x, 64), n=x.shape[0], device="cpu")
    oc = est.fit_dataset(sd, _labels(y))
    assert isinstance(oc, kr.OutOfCoreKernelBlockLinearMapper)
    assert os.path.isdir(oc.store_directory) and os.path.dirname(oc.store_directory) == str(tmp_path)
    ref = est.fit_arrays(x, y, device="cpu")
    np.testing.assert_allclose(oc.alpha.numpy(), ref.alpha.numpy(), atol=ATOL_ALPHA)
    xt = torch.from_numpy(x[:16])
    p_oc = oc(xt).numpy()
    assert _r2(p_oc, ref(xt).numpy()) >= R2_MIN
    oc(xt)  # opens the store
    assert "_store_obj" in oc.__dict__
    torch.save(oc, tmp_path / "m.pt")
    clone = torch.load(tmp_path / "m.pt", weights_only=False)
    assert "_store_obj" not in clone.__dict__ and clone.store_directory == oc.store_directory
    np.testing.assert_array_equal(clone(xt).numpy(), p_oc)
    # through the graph: Pipeline.fit keeps the store, FittedPipeline.save/load keep the path
    fitted = Pipeline.from_estimator(est, StreamDataset(batched(x, 40), n=x.shape[0], device="cpu"),
                                     _labels(y)).fit()
    got = fitted(Dataset(x[:16], device="cpu")).get().numpy()
    assert _r2(got, ref(xt).numpy()) >= R2_MIN
    fitted.save(str(tmp_path / "p.pt"))
    again = FittedPipeline.load(str(tmp_path / "p.pt"))
    np.testing.assert_array_equal(again(Dataset(x[:16], device="cpu")).get().numpy(), got)
    assert len([e for e in os.listdir(tmp_path) if e.startswith("kst_spill_")]) == 2


def test_oc_mapper_scores_a_dataset_in_one_store_sweep(tmp_path, monkeypatch):
    """Scoring a dataset through a fitted pipeline reads each store block
    once, not once a 128-row chunk, and its gram's row chunks change no
    prediction."""
    x, y = _problem(n=96)
    store = RowBlockStore.from_array(str(tmp_path / "s"), x, 32)
    oc = _est(32, epochs=2).fit_store(store, _labels(y))
    xt = np.random.default_rng(3).normal(size=(300, x.shape[1])).astype(np.float32)
    want = torch.cat([oc.apply_batch(t) for t in torch.from_numpy(xt).split(100)])
    reads = []
    read = RowBlockStore.read_block
    monkeypatch.setattr(RowBlockStore, "read_block", lambda self, b: reads.append(b) or read(self, b))
    monkeypatch.setattr(kr, "_PREDICT_ROWS", 64)
    got = Pipeline.of(oc)(Dataset(xt, device="cpu")).get()
    assert reads == [0, 1, 2]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    assert not kr.OutOfCoreKernelBlockLinearMapper.fusable


def test_failed_sweep_removes_only_a_spill_it_placed(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    os.makedirs(tmp_path / "tmp")

    def boom(*a, **k):
        raise RuntimeError("sweep failed")

    monkeypatch.setattr(kr, "_oc_krr_fit", boom)
    x, y = _problem(n=40)
    for spill_dir in (None, str(tmp_path / "mine")):
        with pytest.raises(RuntimeError, match="sweep failed"):
            _est().fit_stream_dataset(StreamDataset(batched(x, 16), n=40, device="cpu"), _labels(y),
                                      spill_dir=spill_dir)
    assert os.listdir(tmp_path / "tmp") == []
    assert len(os.listdir(tmp_path / "mine")) == 1


def test_host_payload_refused():
    with pytest.raises(TypeError, match="host-payload"):
        _est().fit_dataset(Dataset(["a", "b"]), _labels(np.zeros((2, 1), np.float32)))
    # a host stream (the text apps' documents) is taken, and the kernel
    # solver refuses it as it refuses a host list
    with pytest.raises(TypeError, match="host-payload"):
        _est().fit_dataset(StreamDataset([["a", "b"]], n=2, host=True, device="cpu"),
                           _labels(np.zeros((2, 1), np.float32)))


def test_checkpoint_resume_bit_identical(tmp_path):
    """An interrupted fit (1 of 3 epochs) resumes to α bit for bit as the
    uninterrupted fit; a damaged newest checkpoint falls back to the one
    before it, still bit for bit."""
    x, y = _problem(seed=7, n=96, d=8, k=2)
    store = RowBlockStore.from_array(str(tmp_path / "s"), x, 32)
    labels = _labels(y)
    ref = _est(epochs=3).fit_store(store, labels).alpha
    ck = str(tmp_path / "ck")
    _est(epochs=1).fit_store(store, labels, checkpoint_dir=ck)
    z = np.load(os.path.join(ck, "krr_epoch.npz"))
    assert int(z["epoch"]) == 0 and z["alpha"].shape == (3, 32, 2)
    got = _est(epochs=3).fit_store(store, labels, checkpoint_dir=ck).alpha
    assert torch.equal(got, ref)
    assert os.path.exists(os.path.join(ck, "krr_epoch.npz.1"))
    with open(os.path.join(ck, "krr_epoch.npz"), "r+b") as f:
        f.seek(100)
        f.write(b"\xff\xff\xff\xff")
    assert torch.equal(_est(epochs=3).fit_store(store, labels, checkpoint_dir=ck).alpha, ref)
    # a re-spill of the same rows elsewhere resumes: the fingerprint is content, not the path
    store2 = RowBlockStore.from_array(str(tmp_path / "s2"), x, 32)
    assert torch.equal(_est(epochs=3).fit_store(store2, labels, checkpoint_dir=ck).alpha, ref)


def test_checkpoint_of_another_problem_refused(tmp_path):
    x, y = _problem(seed=8, n=96, d=8, k=2)
    ck = str(tmp_path / "ck")
    _est(epochs=2).fit_store(RowBlockStore.from_array(str(tmp_path / "s1"), x, 32), _labels(y), checkpoint_dir=ck)
    store2 = RowBlockStore.from_array(str(tmp_path / "s2"), x + 1.0, 32)
    want = _est(epochs=2).fit_store(store2, _labels(y)).alpha
    assert torch.equal(_est(epochs=2).fit_store(store2, _labels(y), checkpoint_dir=ck).alpha, want)
    # other labels, or another λ, restart too
    store1 = RowBlockStore(str(tmp_path / "s1"))
    want_y = _est(epochs=2).fit_store(store1, _labels(-y)).alpha
    assert torch.equal(_est(epochs=2).fit_store(store1, _labels(-y), checkpoint_dir=ck).alpha, want_y)
    want_lam = _est(epochs=2, lam=1e-3).fit_store(store1, _labels(y)).alpha
    assert torch.equal(_est(epochs=2, lam=1e-3).fit_store(store1, _labels(y), checkpoint_dir=ck).alpha, want_lam)


def test_fingerprint_is_the_references(tmp_path):
    """The port's problem fingerprint is the reference's formula, so a
    checkpoint's identity carries across the packages."""
    import hashlib

    x, y = _problem(n=100, d=6, k=2)
    store = RowBlockStore.from_array(str(tmp_path / "s"), x, 32)
    n_rows = store.num_blocks * 32
    yp = np.zeros((n_rows, 2), np.float32)
    yp[:100] = y
    got = kr._oc_problem(store, torch.from_numpy(yp), n_rows, 2, 1e-4, 0.05, 100.0)
    h = hashlib.sha256()
    jst = JRowStore(store.directory)
    for pb in sorted({0, 2, 3}):
        h.update(np.ascontiguousarray(jst.read_block(pb)).tobytes())
    fp = hashlib.sha256()
    fp.update(repr((100, 6, 32, (n_rows, 2), 1e-4, 0.05, 100.0, h.hexdigest())).encode())
    fp.update(yp[:1].tobytes())
    fp.update(yp[-1:].tobytes())
    fp.update(yp[::max(1, n_rows // 64)].tobytes())
    assert got == fp.hexdigest()


def test_oc_mapper_from_a_reference_fit(tmp_path):
    """A model the reference fitted out of core, carried across: its α and
    its store's directory, read by the port as they are."""
    x, y = _problem(n=100, seed=3)
    jstore = JRowStore.from_array(str(tmp_path / "r"), x, 32)
    jm = _jest(epochs=2).fit_store(jstore, JDataset(y, n=100))
    model = oc_krr_mapper_from_numpy(np.asarray(jm.alpha), str(tmp_path / "r"), 0.05, device="cpu")
    xt = np.random.default_rng(2).normal(size=(24, 12)).astype(np.float32)
    np.testing.assert_allclose(model(torch.from_numpy(xt)).numpy(), np.asarray(jm.apply_batch(jnp.asarray(xt))),
                               atol=1e-4)
    with pytest.raises(ValueError, match="alpha"):
        oc_krr_mapper_from_numpy(np.asarray(jm.alpha)[:100], str(tmp_path / "r"), 0.05, device="cpu")


# ------------------------------------------------------------ the disk tier


GENERATORS = {
    "gaussian": (kr.GaussianKernelGenerator(0.1), jkr.GaussianKernelGenerator(0.1)),
    "polynomial": (kr.PolynomialKernelGenerator(2, 1 / 8, 1.0), jkr.PolynomialKernelGenerator(2, 1 / 8, 1.0)),
    "linear": (kr.LinearKernelGenerator(), jkr.LinearKernelGenerator()),
}


@pytest.mark.parametrize("which", sorted(GENERATORS))
def test_disk_tier_matches_in_memory_matrix(tmp_path, which):
    gen, jgen = GENERATORS[which]
    x = np.random.default_rng(5).normal(size=(80, 8)).astype(np.float32)
    mem = BlockKernelMatrix(gen, torch.from_numpy(x), 32, cache_blocks=9)
    disk = BlockKernelMatrix(gen, torch.from_numpy(x), 32, cache_blocks=0, spill_dir=str(tmp_path / "k"),
                             hbm_cols=1)
    jdisk = JBlockKernelMatrix(jgen, jnp.asarray(x), 32, cache_blocks=0, spill_dir=str(tmp_path / "j"), hbm_cols=1)
    for epoch in range(2):
        for j in range(3):
            got = disk.column_block(j)
            assert torch.equal(got, mem.column_block(j))
            np.testing.assert_allclose(got.numpy(), np.asarray(jdisk.column_block(j)), rtol=1e-5, atol=1e-5)
    # epoch 1 computed and spilled each column once; epoch 2 reread them all
    assert (disk.spill_writes, disk.spill_reads, disk.cache_misses, disk.cache_hits) == (3, 3, 6, 0)
    assert sorted(e for e in os.listdir(tmp_path / "k") if e.startswith("kcol_")) == \
        sorted(e for e in os.listdir(tmp_path / "j") if e.startswith("kcol_"))
    assert torch.equal(disk.diag_block(1), mem.diag_block(1))
    v = torch.from_numpy(np.random.default_rng(6).normal(size=(80, 2)).astype(np.float32))
    assert torch.equal(disk.matvec(v), mem.matvec(v))


def test_disk_tier_owns_its_directory(tmp_path):
    """A directory of this problem is reused, one of another problem is
    cleared of the cache's own files, and one holding anything else is
    refused (tests/test_solvers.py:485)."""
    gen = kr.GaussianKernelGenerator(0.1)
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(64, 4)).astype(np.float32))
    d = str(tmp_path / "k")
    first = BlockKernelMatrix(gen, x, 32, cache_blocks=0, spill_dir=d)
    first.column_block(0)
    again = BlockKernelMatrix(gen, x, 32, cache_blocks=0, spill_dir=d)
    again.column_block(0)
    assert (again.spill_reads, again.spill_writes) == (1, 0)
    other = BlockKernelMatrix(kr.GaussianKernelGenerator(0.2), x, 32, cache_blocks=0, spill_dir=d)
    assert sorted(os.listdir(d)) == ["kcache_meta.json"]
    other.column_block(1)
    with open(os.path.join(d, "notes.txt"), "w") as f:
        f.write("mine")
    open(os.path.join(d, ".nfs0001"), "w").close()  # an OS artifact, not grounds to refuse
    with pytest.raises(ValueError, match="does not own"):
        BlockKernelMatrix(gen, x, 32, cache_blocks=0, spill_dir=d)
    assert os.path.exists(os.path.join(d, "kcol_00001.npy"))


def test_disk_tier_recomputes_a_damaged_spill(tmp_path):
    gen = kr.GaussianKernelGenerator(0.1)
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(64, 4)).astype(np.float32))
    km = BlockKernelMatrix(gen, x, 32, cache_blocks=0, spill_dir=str(tmp_path / "k"))
    want = km.column_block(0).clone()
    km.column_block(1)  # evicts column 0 to disk
    with open(tmp_path / "k" / "kcol_00000.npy", "r+b") as f:
        f.seek(300)
        f.write(b"\x00\x01\x02\x03")
    assert torch.equal(km.column_block(0), want)
    assert (km.spill_corruption, km.spill_writes) == (1, 3)


@pytest.mark.parametrize("which", sorted(GENERATORS))
def test_cached_fit_over_budget_takes_the_disk_tier(tmp_path, monkeypatch, which):
    gen, jgen = GENERATORS[which]
    # the kernel tier's cached-fit problem (tests/test_torch_kernel_tier.py),
    # 90 rows so that the last block is padded
    rng = np.random.default_rng(3)
    x = rng.normal(size=(90, 8)).astype(np.float32)
    y = np.tanh(x @ rng.normal(size=(8, 2)).astype(np.float32) / np.sqrt(8)).astype(np.float32)
    # that file's λ: the linear kernel's rank-8 blocks solve at 1e-2
    kw = dict(lam=1e-2 if which == "linear" else 1e-3, block_size=32, num_epochs=2, cache_kernel_blocks=True)
    in_memory = kr.KernelRidgeRegressionEstimator(gen, **kw).fit_arrays(x, y, device="cpu").alpha
    want = jkr.KernelRidgeRegressionEstimator(jgen, **kw).fit_arrays(x, y).alpha
    made = []
    real = BlockKernelMatrix.__init__

    def spy(self, *a, **k):
        real(self, *a, **k)
        made.append(self)

    monkeypatch.setattr(BlockKernelMatrix, "__init__", spy)
    # a budget one byte short of K (96 × 96 f32), two columns' worth
    monkeypatch.setattr(profiling, "device_hbm_budget", lambda fraction, device: 96 * 96 * 4 - 1)
    cache = str(tmp_path / "kc")
    got = kr.KernelRidgeRegressionEstimator(gen, kernel_cache_dir=cache, **kw).fit_arrays(x, y, device="cpu").alpha
    km = made[-1]
    assert (km.spill_dir, km.hbm_cols, km.spill_writes, km.spill_reads) == (cache, 2, 3, 3)
    assert torch.equal(got, in_memory)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)  # that file's tolerance
    assert sorted(os.listdir(cache)) == ["kcache_meta.json"] + [f"kcol_{j:05d}.npy{s}" for j in range(3)
                                                                for s in ("", ".b2")]
    # without a cache directory the fit spills to a temporary one and removes it
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    os.makedirs(tmp_path / "tmp")
    got2 = kr.KernelRidgeRegressionEstimator(gen, **kw).fit_arrays(x, y, device="cpu").alpha
    assert torch.equal(got2, in_memory) and os.listdir(tmp_path / "tmp") == []

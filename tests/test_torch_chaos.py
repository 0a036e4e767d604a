"""Chaos in the port: injected faults (keystone_tpu_torch/faults.py)
against the hardened layers (utils/durable.py, the block stores, the
streams, the executor) and the checkpointed solvers, scenario by scenario
as the JAX package's tests/test_chaos.py holds its own.  Each
checkpointed solver is interrupted and resumed here and lands on the
reference's uninterrupted fit within that solver's parity tolerance;
where the two packages share checkpoint files the port resumes from a
checkpoint the reference wrote mid-fit."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.models import BlockLeastSquaresEstimator as JBls
from keystone_tpu.models import kernel_ridge as jkr
from keystone_tpu.workflow import Dataset as JDataset
from keystone_tpu.workflow.blockstore import FeatureBlockStore as JStore
from keystone_tpu.workflow.blockstore import RowBlockStore as JRowStore
from keystone_tpu_torch import faults
from keystone_tpu_torch.loaders.stream import batched, resilient
from keystone_tpu_torch.models import kernel_ridge as kr
from keystone_tpu_torch.models.block_ls import BlockLeastSquaresEstimator
from keystone_tpu_torch.utils import durable
from keystone_tpu_torch.utils.durable import CorruptStateError
from keystone_tpu_torch.workflow.blockstore import FeatureBlockStore, RowBlockStore
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset

pytestmark = pytest.mark.chaos

ATOL_BCD_REF = 2e-5  # tests/test_torch_fit.py's, the in-core BCD against the reference
ATOL_OC = 2e-4  # tests/test_torch_stream_store.py's, the out-of-core BCD
ATOL_ALPHA = 1e-5  # tests/test_torch_kernel_oc.py's, the out-of-core KRR (times max |α|)


def _problem(seed=0, n=96, d=24, k=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32), rng.normal(size=(n, k)).astype(np.float32)


def _cpu(a):
    return Dataset(np.asarray(a, np.float32), device="cpu")


def _bcd(num_iter, intercept=False):
    return BlockLeastSquaresEstimator(block_size=8, num_iter=num_iter, lam=1e-3, fit_intercept=intercept)


# ---------------------------------------------------- in-core BCD


@pytest.mark.parametrize("intercept", [False, True])
def test_corrupt_epoch_checkpoint_resumes_from_last_good_bitmatch(tmp_path, monkeypatch, intercept):
    x, y = _problem()
    ref = _bcd(5, intercept).fit_checkpointed(_cpu(x), _cpu(y), str(tmp_path / "ref"))
    ckpt = str(tmp_path / "chaos")
    monkeypatch.setenv(faults.ENV_VAR, "ckpt.save:after=2:times=1:corrupt")
    _bcd(3, intercept).fit_checkpointed(_cpu(x), _cpu(y), ckpt)
    monkeypatch.delenv(faults.ENV_VAR)
    path = os.path.join(ckpt, "bcd_epoch.npz")
    with pytest.raises(CorruptStateError):
        durable.verify_checksum(path)
    assert os.path.exists(path + ".1")
    out = _bcd(5, intercept).fit_checkpointed(_cpu(x), _cpu(y), ckpt)
    assert torch.equal(out.weights, ref.weights)
    jref = JBls(block_size=8, num_iter=5, lam=1e-3, fit_intercept=intercept).fit_checkpointed(
        JDataset(x), JDataset(y), checkpoint_dir=str(tmp_path / "jref"))
    np.testing.assert_allclose(out.weights.numpy(), np.asarray(jref.weights), atol=ATOL_BCD_REF)
    if intercept:
        np.testing.assert_allclose(out.intercept.numpy(), np.asarray(jref.intercept), atol=ATOL_BCD_REF)


def test_save_raise_interrupts_in_core_fit_which_resumes(tmp_path):
    """A ckpt.save raise past the I/O retries stops the fit after epoch 1;
    the rerun resumes from it (two epochs left, not four) and equals the
    uninterrupted fit bit for bit."""
    x, y = _problem(1)
    ckpt = str(tmp_path / "ckpt")
    with faults.inject("ckpt.save:after=1:times=3:raise"):
        with pytest.raises(faults.FaultInjected):
            _bcd(4).fit_checkpointed(_cpu(x), _cpu(y), ckpt)
    z, _ = durable.load_npz(os.path.join(ckpt, "bcd_epoch.npz"))
    assert int(z["epoch"]) == 0
    saves = []
    orig = durable.save_npz

    def spy(path, arrays, **kw):
        saves.append(int(arrays["epoch"]))
        return orig(path, arrays, **kw)

    durable.save_npz = spy
    try:
        out = _bcd(4).fit_checkpointed(_cpu(x), _cpu(y), ckpt)
    finally:
        durable.save_npz = orig
    assert saves == [1, 2, 3]
    assert torch.equal(out.weights, _bcd(4).fit_checkpointed(_cpu(x), _cpu(y), str(tmp_path / "u")).weights)


def test_in_core_fit_resumes_the_references_checkpoint(tmp_path):
    """The in-core fingerprint is the reference's: the port resumes an
    epoch checkpoint the reference wrote after two of five epochs.  The
    reference probes the first row shard of its mesh, so the files are
    shared where its data is unsharded (one device), as here."""
    x, y = _problem(2)
    ckpt = str(tmp_path / "ckpt")
    JBls(block_size=8, num_iter=2, lam=1e-3, fit_intercept=False).fit_checkpointed(
        JDataset(x, shard=False), JDataset(y, shard=False), checkpoint_dir=ckpt)
    saves = []
    orig = durable.save_npz
    durable.save_npz = lambda p, a, **kw: (saves.append(int(a["epoch"])), orig(p, a, **kw))[1]
    try:
        out = _bcd(5).fit_checkpointed(_cpu(x), _cpu(y), ckpt)
    finally:
        durable.save_npz = orig
    assert saves == [2, 3, 4]
    jref = JBls(block_size=8, num_iter=5, lam=1e-3, fit_intercept=False).fit_checkpointed(
        JDataset(x), JDataset(y), checkpoint_dir=str(tmp_path / "jref"))
    np.testing.assert_allclose(out.weights.numpy(), np.asarray(jref.weights), atol=ATOL_BCD_REF)


def test_checkpoint_of_another_problem_is_not_resumed(tmp_path):
    x, y = _problem(3)
    ckpt = str(tmp_path / "ckpt")
    _bcd(2).fit_checkpointed(_cpu(x), _cpu(y), ckpt)
    x2, _ = _problem(4)
    out = _bcd(2).fit_checkpointed(_cpu(x2), _cpu(y), ckpt)
    assert torch.equal(out.weights, _bcd(2).fit_checkpointed(_cpu(x2), _cpu(y), str(tmp_path / "f")).weights)


# ------------------------------------------------------- L-BFGS


def test_corrupt_lbfgs_checkpoint_falls_back_bitmatch(tmp_path):
    from keystone_tpu_torch.models.lbfgs import DenseLBFGSwithL2

    x, y = _problem(seed=1, n=64, d=10, k=2)

    def fit(num_iter, ckpt_dir):
        return DenseLBFGSwithL2(lam=1e-3, num_iterations=num_iter, history=4).fit_checkpointed(
            _cpu(x), _cpu(y), checkpoint_dir=ckpt_dir, checkpoint_every=2)

    ref = fit(8, str(tmp_path / "ref"))
    ckpt = str(tmp_path / "chaos")
    with faults.inject("ckpt.save:after=1:times=1:corrupt"):
        fit(4, ckpt)
    with pytest.raises(CorruptStateError):
        durable.verify_checksum(os.path.join(ckpt, "lbfgs_dense.npz"))
    assert torch.equal(fit(8, ckpt).weights, ref.weights)


# ---------------------------------------------------- out-of-core BCD


def _oc_est(num_iter):
    return BlockLeastSquaresEstimator(block_size=8, num_iter=num_iter, lam=1e-3)


def test_oc_fit_interrupted_at_save_resumes_to_the_reference(tmp_path):
    x, y = _problem(5)
    store = FeatureBlockStore.from_array(str(tmp_path / "s"), x, 8)
    ckpt = str(tmp_path / "ckpt")
    with faults.inject("ckpt.save:after=1:times=3:raise"):
        with pytest.raises(faults.FaultInjected):
            _oc_est(3).fit_store(store, _cpu(y), checkpoint_dir=ckpt)
    out = _oc_est(3).fit_store(store, _cpu(y), checkpoint_dir=ckpt)
    straight = _oc_est(3).fit_store(store, _cpu(y))
    assert torch.equal(out.weights, straight.weights)
    jstore = JStore(store.directory)
    jref = JBls(block_size=8, num_iter=3, lam=1e-3).fit_store(jstore, JDataset(y),
                                                              checkpoint_dir=str(tmp_path / "jref"))
    np.testing.assert_allclose(out.flat_weights.numpy(), np.asarray(jref.flat_weights), atol=ATOL_OC)
    np.testing.assert_allclose(out.intercept.numpy(), np.asarray(jref.intercept), atol=ATOL_OC)


def test_oc_fit_resumes_the_references_checkpoint(tmp_path):
    """The out-of-core fingerprint is the reference's too: a checkpoint the
    reference wrote after epoch 1 of a store resumes in the port."""
    x, y = _problem(6)
    store = FeatureBlockStore.from_array(str(tmp_path / "s"), x, 8)
    ckpt = str(tmp_path / "ckpt")
    JBls(block_size=8, num_iter=1, lam=1e-3).fit_store(JStore(store.directory), JDataset(y), checkpoint_dir=ckpt)
    orders = []
    orig = FeatureBlockStore.iter_device_blocks

    def spy(self, order, *a, **kw):
        orders.append(list(order))
        return orig(self, order, *a, **kw)

    FeatureBlockStore.iter_device_blocks = spy
    try:
        out = _oc_est(3).fit_store(store, _cpu(y), checkpoint_dir=ckpt)
    finally:
        FeatureBlockStore.iter_device_blocks = orig
    assert orders[-1] == [0, 1, 2] * 2  # epochs 2 and 3 only
    jref = JBls(block_size=8, num_iter=3, lam=1e-3).fit_store(JStore(store.directory), JDataset(y))
    np.testing.assert_allclose(out.flat_weights.numpy(), np.asarray(jref.flat_weights), atol=ATOL_OC)


def test_oc_weighted_fit_save_timing_and_faults(tmp_path):
    from keystone_tpu_torch.models.block_weighted_ls import BlockWeightedLeastSquaresEstimator
    from keystone_tpu_torch.obs import metrics

    x, _ = _problem(7)
    labels = np.random.default_rng(7).integers(0, 3, 96)
    y = -np.ones((96, 3), np.float32)
    y[np.arange(96), labels] = 1.0
    store = FeatureBlockStore.from_array(str(tmp_path / "s"), x, 8)
    est = BlockWeightedLeastSquaresEstimator(block_size=8, num_iter=2, lam=1e-2)
    metrics.reset()
    faults.reset_stats()
    with faults.inject("blockstore.read:after=3:times=2:raise"):
        got = est.fit_store(store, _cpu(y), checkpoint_dir=str(tmp_path / "ckpt"))
    assert torch.equal(got.weights, est.fit_store(store, _cpu(y)).weights)
    assert faults.stats()["blockstore.read"]["injected"] == 2
    assert metrics.REGISTRY.counter_value("blockstore.read_retries") == 2
    assert metrics.snapshot()["histograms"]["solver.checkpoint_save_seconds"]["count"] == 2


# ------------------------------------------------------ out-of-core KRR


def _krr_problem(seed, n, d=12, k=3):
    """The reference's out-of-core KRR problem (tests/test_kernel_oc.py::_problem)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (x @ rng.normal(size=(d, k)).astype(np.float32) + 0.01 * rng.normal(size=(n, k))).astype(np.float32)
    return x, y


def _krr(epochs):
    return kr.KernelRidgeRegressionEstimator(kr.GaussianKernelGenerator(0.05), lam=1e-4, block_size=32,
                                             num_epochs=epochs)


def test_oc_krr_sweep_fault_interrupts_and_resume_is_bitwise(tmp_path):
    """A kernel.sweep raise at a diagonal step of epoch 2 stops the sweep;
    the rerun resumes after epoch 1 and its α equals the uninterrupted
    fit's bit for bit, and the reference's within its parity tolerance.
    A corrupt newest checkpoint then falls back to the last good one."""
    x, y = _krr_problem(8, 128)
    store = RowBlockStore.from_array(str(tmp_path / "s"), x, 32)
    nb = store.num_blocks
    ckpt = str(tmp_path / "ckpt")
    straight = _krr(3).fit_store(store, _cpu(y))
    faults.reset_stats()
    with faults.inject(f"kernel.sweep:after={nb + 1}:times=1:raise"):
        with pytest.raises(faults.FaultInjected):
            _krr(3).fit_store(store, _cpu(y), checkpoint_dir=ckpt)
    assert faults.stats()["kernel.sweep"] == {"calls": nb + 2, "injected": 1}
    faults.reset_stats()
    resumed = _krr(3).fit_store(store, _cpu(y), checkpoint_dir=ckpt)
    assert faults.stats()["kernel.sweep"]["calls"] == 2 * nb  # epochs 2 and 3 only
    assert torch.equal(resumed.alpha, straight.alpha)
    want = jkr._oc_krr_fit(JRowStore(store.directory), jnp.asarray(y), 128.0, 0.05, 1e-4, 3,
                           checkpoint_dir=str(tmp_path / "jref"))
    np.testing.assert_allclose(resumed.alpha.numpy(), np.asarray(want), atol=ATOL_ALPHA * np.abs(want).max())
    # the newest checkpoint (epoch 3) damaged: fall back to epoch 2, rerun 3
    with faults.inject("ckpt.save:after=2:times=1:corrupt"):
        _krr(3).fit_store(store, _cpu(y), checkpoint_dir=str(tmp_path / "c2"))
    with pytest.raises(CorruptStateError):
        durable.verify_checksum(str(tmp_path / "c2" / "krr_epoch.npz"))
    faults.reset_stats()
    again = _krr(3).fit_store(store, _cpu(y), checkpoint_dir=str(tmp_path / "c2"))
    assert faults.stats()["kernel.sweep"]["calls"] == nb
    assert torch.equal(again.alpha, straight.alpha)


def test_oc_krr_resumes_the_references_checkpoint(tmp_path):
    x, y = _krr_problem(9, 96)
    store = RowBlockStore.from_array(str(tmp_path / "s"), x, 32)
    ckpt = str(tmp_path / "ckpt")
    jkr._oc_krr_fit(JRowStore(store.directory), jnp.asarray(y), 96.0, 0.05, 1e-4, 1, checkpoint_dir=ckpt)
    faults.reset_stats()
    got = _krr(2).fit_store(store, _cpu(y), checkpoint_dir=ckpt)
    assert faults.stats()["kernel.sweep"]["calls"] == store.num_blocks  # epoch 2 only
    want = jkr._oc_krr_fit(JRowStore(store.directory), jnp.asarray(y), 96.0, 0.05, 1e-4, 2)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want), atol=ATOL_ALPHA * np.abs(want).max())


# ---------------------------------------------------- block stores


def test_truncated_block_detected_before_solver(tmp_path):
    x, _ = _problem()
    store = FeatureBlockStore.from_array(str(tmp_path / "store"), x, block_size=8)
    path = store._block_path(store.directory, 1)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    with pytest.raises(CorruptStateError, match="truncated"):
        store.read_block(1)
    assert store.read_block(0).shape == (96, 8)


def test_corrupt_block_content_caught_by_checksum(tmp_path):
    x, _ = _problem()
    store = FeatureBlockStore.from_array(str(tmp_path / "store"), x, block_size=8)
    with faults.inject("blockstore.read:corrupt:times=1"):
        with pytest.raises(CorruptStateError, match="checksum mismatch"):
            store.read_block(0)
    with pytest.raises(CorruptStateError, match="checksum mismatch"):
        store.read_block(0)


@pytest.mark.parametrize("cls", [FeatureBlockStore, RowBlockStore])
def test_corrupt_write_caught_at_seal_time(tmp_path, cls):
    x, _ = _problem()
    with faults.inject("blockstore.write:after=1:times=1:corrupt"):
        with pytest.raises(CorruptStateError, match="write verification"):
            cls.from_array(str(tmp_path / "store"), x, block_size=8 if cls is FeatureBlockStore else 32)


def test_truncated_spill_recovers_via_refit(tmp_path):
    from keystone_tpu_torch.workflow.recovery import fit_with_recovery

    x, y = _problem()
    est = BlockLeastSquaresEstimator(block_size=8, num_iter=2, lam=1e-3, fit_intercept=False)

    def build():
        return est.with_data(StreamDataset(batched(x, x.shape[0]), n=x.shape[0], device="cpu"), _cpu(y))

    ref = build().fit()(_cpu(x)).get().numpy()
    with faults.inject("blockstore.write:after=2:times=1:truncate"):
        fitted, attempts = fit_with_recovery(build, max_restarts=2)
    assert attempts >= 1
    np.testing.assert_allclose(fitted(_cpu(x)).get().numpy(), ref, rtol=1e-5, atol=1e-6)


def test_injected_read_flakiness_absorbed_by_retries(tmp_path):
    x, _ = _problem()
    store = FeatureBlockStore.from_array(str(tmp_path / "store"), x, block_size=8)
    faults.reset_stats()
    with faults.inject("blockstore.read:every=2:raise"):
        for b in range(store.num_blocks):
            assert store.read_block(b).shape == (store.n, store.block_size)
    assert faults.stats()["blockstore.read"]["injected"] >= store.num_blocks // 2


# ------------------------------------------------------------ streams


def test_flaky_stream_source_retries_transparently():
    state = {"fails": 0}

    def src():
        def it():
            for i in range(5):
                if i == 2 and state["fails"] < 2:
                    state["fails"] += 1
                    raise OSError("flaky read")
                yield np.full((4, 3), i, np.float32)

        return it()

    out = list(resilient(src, retries=2, base_delay=0.0)())
    assert state["fails"] == 2 and len(out) == 5
    np.testing.assert_array_equal(out[2], np.full((4, 3), 2, np.float32))


class _SkippableIter:
    def __init__(self, n, bad):
        self.i, self.n, self.bad = 0, n, bad

    def __iter__(self):
        return self

    def __next__(self):
        if self.i >= self.n:
            raise StopIteration
        i = self.i
        self.i += 1
        if i == self.bad:
            raise OSError(f"batch {i} is rotten")
        return i


def test_retry_budget_is_per_batch_not_pooled():
    from collections import defaultdict

    counts = defaultdict(int)

    class It:
        def __init__(self):
            self.i = 0

        def __iter__(self):
            return self

        def __next__(self):
            if self.i >= 5:
                raise StopIteration
            i = self.i
            self.i += 1
            counts[i] += 1
            if i == 3 and counts[3] == 1:
                raise OSError("transient at 3")
            if i == 1 and counts[1] == 2:
                raise OSError("transient at 1, during replay")
            return i

    assert list(resilient(It, retries=1, base_delay=0.0)()) == [0, 1, 2, 3, 4]
    assert counts[3] >= 2 and counts[1] >= 3


def test_bad_batch_quota_drops_then_fails():
    assert list(resilient(lambda: _SkippableIter(5, 2), retries=1, max_bad_batches=1, base_delay=0.0)()) == [
        0, 1, 3, 4]
    with pytest.raises(OSError, match="rotten"):
        list(resilient(lambda: _SkippableIter(5, 2), retries=1, base_delay=0.0)())


@pytest.mark.parametrize("plan", ["stream.batch:after=2:times=1:raise", "stream.batch:after=1:every=3:times=2"])
def test_stream_dataset_retries_injected_batch_faults(monkeypatch, plan):
    x, _ = _problem()
    monkeypatch.setenv(faults.ENV_VAR, plan)
    ds = StreamDataset(batched(x, 16), n=x.shape[0], retries=2, device="cpu")
    np.testing.assert_array_equal(np.concatenate(list(ds.batches())), x)


def test_loader_streams_fire_the_site_under_retries():
    """A loader's own generator fires ``stream.batch`` through the
    resilient wrapper its retries add (``batched`` fires it itself)."""
    from keystone_tpu_torch.loaders.imagenet import ImageNetLoader

    ref = ImageNetLoader.synthetic_stream(12, 3, (16, 16), seed=4, batch_size=4, device="cpu")
    flaky = ImageNetLoader.synthetic_stream(12, 3, (16, 16), seed=4, batch_size=4, device="cpu", retries=2)
    faults.reset_stats()
    with faults.inject("stream.batch:after=1:times=2:raise"):
        got = np.concatenate(list(flaky.data.batches()))
    np.testing.assert_array_equal(got, np.concatenate(list(ref.data.batches())))
    assert faults.stats()["stream.batch"]["injected"] == 2


# ------------------------------------------------------ executor, state


def test_executor_stage_faults_survived_with_retries():
    from keystone_tpu_torch.workflow.executor import GraphExecutor
    from keystone_tpu_torch.workflow.pipeline import Pipeline
    from keystone_tpu_torch.workflow.transformer import Transformer

    class AddOne(Transformer):
        def params(self):
            return ()

        def apply_dataset(self, ds):
            return ds.with_array(ds.array + 1.0)

    lazy = Pipeline.of(AddOne())(_cpu(np.ones((4, 2))))
    with faults.inject("executor.stage:times=2:raise"):
        out = GraphExecutor(lazy.graph, node_retries=2).execute(lazy.graph.sinks[0])
    np.testing.assert_allclose(out.dataset.array.numpy(), 2.0)
    with faults.inject("executor.stage:times=3:raise"):
        with pytest.raises(faults.FaultInjected):
            GraphExecutor(lazy.graph, node_retries=1).execute(lazy.graph.sinks[0])


def test_purge_invalid_state_quarantines_only_corrupt(tmp_path):
    from keystone_tpu_torch.workflow.recovery import purge_invalid_state, scan_state_dir

    good, bad = str(tmp_path / "good.npz"), str(tmp_path / "bad.npz")
    durable.save_npz(good, {"w": np.ones(4)})
    durable.save_npz(bad, {"w": np.ones(4)})
    with open(bad, "r+b") as f:
        f.seek(os.path.getsize(bad) // 2)
        f.write(b"\xff\xff\xff\xff")
    scan = scan_state_dir(str(tmp_path))
    assert scan == {"valid": [good], "corrupt": [bad]}
    assert purge_invalid_state(str(tmp_path)) == [bad + ".corrupt"]
    assert not os.path.exists(bad) and os.path.exists(good)

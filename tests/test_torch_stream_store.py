"""The port's out-of-core tier against the JAX package on the CPU: the
feature block store (round trips, bf16 spill, the read-ahead and device
feeds, integrity checks), the out-of-core BCD and both block solvers'
streamed fits, the per-epoch checkpoint, and the durable checkpoint files.

The solvers are held at the reference's own tolerances
(tests/test_outofcore.py): 2e-4 on weights and intercept from the same
store contents, labels and weights, 2e-2 for a bf16 spill."""

import os

import numpy as np
import pytest
import torch

from keystone_tpu.models import BlockLeastSquaresEstimator as JBls
from keystone_tpu.models import BlockWeightedLeastSquaresEstimator as JBwls
from keystone_tpu.workflow import Dataset as JDataset
from keystone_tpu.workflow import FeatureBlockStore as JStore
from keystone_tpu.workflow import StreamDataset as JStream
from keystone_tpu_torch.models import block_ls
from keystone_tpu_torch.models.block_ls import BlockLeastSquaresEstimator, _oc_bcd_fit
from keystone_tpu_torch.models.block_weighted_ls import BlockWeightedLeastSquaresEstimator
from keystone_tpu_torch.utils import durable
from keystone_tpu_torch.workflow.blockstore import FeatureBlockStore
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset

ATOL_OC = 2e-4  # tests/test_outofcore.py's, f32 spill
ATOL_OC_BF16 = 2e-2  # tests/test_outofcore.py's, bf16 spill


def _problem(n=96, d=37, k=5, seed=0, skew=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if skew:  # imbalanced classes, so that the weights matter
        p = np.array([0.6, 0.2, 0.1, 0.06, 0.04])[:k]
        lbl = rng.choice(k, size=n, p=p / p.sum())
    else:
        lbl = rng.integers(0, k, size=n)
    y = -np.ones((n, k), np.float32)
    y[np.arange(n), lbl] = 1.0
    return x, y


def _labels(y):
    return Dataset(torch.from_numpy(y), device="cpu")


# ------------------------------------------------------------------ store


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_store_round_trip_matches_reference(tmp_path, dtype):
    x = np.random.default_rng(1).normal(size=(23, 10)).astype(np.float32)
    port = FeatureBlockStore.from_array(str(tmp_path / "p"), x, block_size=4, dtype=dtype)
    ref = JStore.from_array(str(tmp_path / "r"), x, block_size=4, dtype=dtype)
    assert (port.n, port.d, port.num_blocks, port.nbytes()) == (ref.n, ref.d, ref.num_blocks, ref.nbytes())
    for b in range(port.num_blocks):
        got = port.read_block(b)
        assert got.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        want = np.asarray(ref.read_block(b)).astype(np.float32)
        np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)
        # the same bytes on disk: one format, either package reads the other's
        raw = np.load(os.path.join(str(tmp_path / "p"), f"block_{b:04d}.npy"))
        np.testing.assert_array_equal(raw, np.load(os.path.join(str(tmp_path / "r"), f"block_{b:04d}.npy")))
    np.testing.assert_array_equal(port.read_block(2)[:, 2:].to(torch.float32).numpy(), 0)  # column padding


def test_store_from_batches_equals_from_array(tmp_path):
    x = np.random.default_rng(2).normal(size=(23, 9)).astype(np.float32)
    a = FeatureBlockStore.from_array(str(tmp_path / "a"), x, block_size=4)
    batches = [x[:7], torch.from_numpy(x[7:15]), x[15:]]  # numpy and tensors alike
    b = FeatureBlockStore.from_batches(str(tmp_path / "b"), batches, 23, 4)
    for i in range(a.num_blocks):
        assert torch.equal(a.read_block(i), b.read_block(i))


def test_store_row_count_mismatch(tmp_path):
    with pytest.raises(ValueError, match="produced 3 rows"):
        FeatureBlockStore.from_batches(str(tmp_path / "c"), [np.zeros((3, 4), np.float32)], 5, 2)
    with pytest.raises(ValueError, match="dtype"):
        FeatureBlockStore.create(str(tmp_path / "d"), 4, 4, 2, dtype="float16")


def test_store_detects_truncation_and_corruption(tmp_path):
    x = np.random.default_rng(3).normal(size=(8, 8)).astype(np.float32)
    store = FeatureBlockStore.from_array(str(tmp_path / "s"), x, block_size=4)
    path = os.path.join(store.directory, "block_0001.npy")
    with open(path, "r+b") as f:  # flip one payload byte: the sidecar catches it
        f.seek(-1, os.SEEK_END)
        last = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last[0] ^ 0xFF]))
    with pytest.raises(durable.CorruptStateError, match="checksum mismatch"):
        store.read_block(1)
    with open(path, "r+b") as f:
        f.truncate(64)
    with pytest.raises(durable.CorruptStateError, match="truncated"):
        store.read_block(1)
    np.testing.assert_array_equal(store.read_block(0).numpy(), x[:, :4])


def test_iter_blocks_order_values_and_errors(tmp_path, monkeypatch):
    x = np.random.default_rng(4).normal(size=(8, 12)).astype(np.float32)
    store = FeatureBlockStore.from_array(str(tmp_path / "s"), x, block_size=4)
    order = [0, 1, 2, 0, 1, 2]
    seen = list(store.iter_blocks(order))
    assert [b for b, _ in seen] == order
    for b, blk in seen:
        assert torch.equal(blk, store.read_block(b))
    orig = FeatureBlockStore.read_block

    def failing(self, b):
        if b == 2:
            raise ValueError("disk says no")
        return orig(self, b)

    monkeypatch.setattr(FeatureBlockStore, "read_block", failing)
    with pytest.raises(ValueError, match="block 2: disk says no"):
        list(store.iter_blocks([0, 1, 2]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_iter_device_blocks_on_the_cpu_equal_read_block(tmp_path, dtype):
    x = np.random.default_rng(5).normal(size=(12, 20)).astype(np.float32)
    store = FeatureBlockStore.from_array(str(tmp_path / dtype), x, block_size=8, dtype=dtype)
    order = [0, 2, 1, 0]
    seen = list(store.iter_device_blocks(order, "cpu"))
    assert [b for b, _ in seen] == order
    for b, a in seen:
        assert a.dtype == torch.float32 and a.device.type == "cpu"
        assert torch.equal(a, store.read_block(b).to(torch.float32))


# ------------------------------------------------- the out-of-core solvers


def _fit_both(tmp_path, est, jest, x, y, dtype="float32"):
    store = FeatureBlockStore.from_array(str(tmp_path / "p"), x, block_size=est.block_size, dtype=dtype)
    jstore = JStore.from_array(str(tmp_path / "r"), x, block_size=est.block_size, dtype=dtype)
    got = est.fit_store(store, _labels(y))
    want = jest.fit_store(jstore, JDataset(y, n=y.shape[0]))
    return got, want


def _assert_model(got, want, atol, intercept=True):
    np.testing.assert_allclose(got.flat_weights.numpy(), np.asarray(want.flat_weights), atol=atol)
    if intercept:
        np.testing.assert_allclose(got.intercept.numpy(), np.asarray(want.intercept), atol=atol)
    else:
        assert got.intercept is None and want.intercept is None


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_oc_fit_matches_reference(tmp_path, weighted, fit_intercept):
    x, y = _problem(skew=weighted)
    if weighted:
        kw = dict(block_size=16, num_iter=3, lam=1e-2, mixture_weight=0.5, fit_intercept=fit_intercept)
        est, jest = BlockWeightedLeastSquaresEstimator(**kw), JBwls(**kw)
    else:
        kw = dict(block_size=16, num_iter=3, lam=1e-2, fit_intercept=fit_intercept)
        est, jest = BlockLeastSquaresEstimator(**kw), JBls(**kw)
    got, want = _fit_both(tmp_path, est, jest, x, y)
    _assert_model(got, want, ATOL_OC, fit_intercept)
    # and the port's out-of-core fit is its in-memory fit
    mem = est.fit_arrays(x, y, device="cpu")
    np.testing.assert_allclose(got.flat_weights.numpy(), mem.flat_weights.numpy(), atol=ATOL_OC)


@pytest.mark.parametrize("weighted", [False, True])
def test_oc_bf16_spill_matches_reference(tmp_path, weighted):
    x, y = _problem(seed=7, skew=weighted)
    cls, jcls = (BlockWeightedLeastSquaresEstimator, JBwls) if weighted else (BlockLeastSquaresEstimator, JBls)
    got, want = _fit_both(tmp_path, cls(block_size=16, num_iter=3, lam=1e-2),
                          jcls(block_size=16, num_iter=3, lam=1e-2), x, y, dtype="bfloat16")
    _assert_model(got, want, ATOL_OC_BF16)
    # the bf16 store's model is the f32 in-memory model to bf16's rounding
    mem = cls(block_size=16, num_iter=3, lam=1e-2).fit_arrays(x, y, device="cpu")
    np.testing.assert_allclose(got.flat_weights.numpy(), mem.flat_weights.numpy(), atol=ATOL_OC_BF16)


@pytest.mark.parametrize("weighted", [False, True])
def test_stream_fit_matches_reference(tmp_path, weighted):
    """fit_stream_dataset: the streamed features spill once, the fit
    sweeps the spill, and the spill is gone afterwards."""
    x, y = _problem(seed=9, skew=weighted)
    cls, jcls = (BlockWeightedLeastSquaresEstimator, JBwls) if weighted else (BlockLeastSquaresEstimator, JBls)
    kw = dict(block_size=16, num_iter=2, lam=1e-2)
    parts = [x[:30], x[30:61], x[61:]]
    spill = tmp_path / "spill"
    got = cls(**kw).fit_stream_dataset(StreamDataset(parts, n=96, device="cpu"), _labels(y), spill_dir=str(spill))
    want = jcls(**kw).fit_stream_dataset(JStream(parts, n=96), JDataset(y, n=96), spill_dir=str(tmp_path / "r"))
    _assert_model(got, want, ATOL_OC)
    assert spill.is_dir() and not os.listdir(spill)


def test_oc_checkpoint_resume_equals_uninterrupted_fit(tmp_path):
    x, y = _problem(seed=3)
    store = FeatureBlockStore.from_array(str(tmp_path / "s"), x, block_size=16)
    ckpt = str(tmp_path / "ckpt")
    BlockWeightedLeastSquaresEstimator(block_size=16, num_iter=2, lam=1e-2).fit_store(store, _labels(y),
                                                                                     checkpoint_dir=ckpt)
    assert os.path.exists(os.path.join(ckpt, "oc_bcd_epoch.npz"))
    full = BlockWeightedLeastSquaresEstimator(block_size=16, num_iter=4, lam=1e-2)
    calls = []
    orig = FeatureBlockStore.iter_device_blocks

    def spy(self, order, *a, **kw):
        calls.append(list(order))
        return orig(self, order, *a, **kw)

    FeatureBlockStore.iter_device_blocks = spy
    try:
        resumed = full.fit_store(store, _labels(y), checkpoint_dir=ckpt)
    finally:
        FeatureBlockStore.iter_device_blocks = orig
    assert calls[-1] == [0, 1, 2] * 2  # epochs 2 and 3 only: resumed after epoch 1
    straight = full.fit_store(store, _labels(y))
    np.testing.assert_allclose(resumed.flat_weights.numpy(), straight.flat_weights.numpy(), atol=ATOL_OC)
    np.testing.assert_allclose(resumed.intercept.numpy(), straight.intercept.numpy(), atol=ATOL_OC)


def test_oc_checkpoint_of_another_problem_is_not_resumed(tmp_path):
    x, y = _problem(seed=7, skew=True)
    store = FeatureBlockStore.from_array(str(tmp_path / "s"), x, block_size=16)
    ckpt = str(tmp_path / "ckpt")
    a = BlockWeightedLeastSquaresEstimator(block_size=16, num_iter=2, lam=1e-2, mixture_weight=0.5)
    a.fit_store(store, _labels(y), checkpoint_dir=ckpt)  # leaves epoch 1's state
    b = BlockWeightedLeastSquaresEstimator(block_size=16, num_iter=2, lam=1e-2, mixture_weight=0.9)
    stale_aware = b.fit_store(store, _labels(y), checkpoint_dir=ckpt)
    fresh = b.fit_store(store, _labels(y))
    np.testing.assert_allclose(stale_aware.flat_weights.numpy(), fresh.flat_weights.numpy(), atol=ATOL_OC)
    c = BlockWeightedLeastSquaresEstimator(block_size=16, num_iter=2, lam=1e-2, mixture_weight=0.5)
    assert not np.allclose(c.fit_store(store, _labels(y), checkpoint_dir=ckpt).flat_weights.numpy(),
                           fresh.flat_weights.numpy(), atol=1e-3)


def test_oc_row_mismatch_raises_before_the_sweep(tmp_path, monkeypatch):
    x, y = _problem(seed=13)
    store = FeatureBlockStore.from_array(str(tmp_path / "s"), x, block_size=16)
    y_long = torch.from_numpy(np.pad(y, ((0, 4), (0, 0))))
    alpha = (torch.arange(y_long.shape[0]) < y.shape[0]).to(torch.float32)

    def no_read(self, b):
        raise AssertionError("a block was read before the row check")

    monkeypatch.setattr(FeatureBlockStore, "read_block", no_read)
    with pytest.raises(ValueError, match="store rows 96 != label rows 100"):
        _oc_bcd_fit(store, y_long, alpha, 96.0, 1e-2, 1, True)
    with pytest.raises(ValueError, match="labels n=100 != store n=96"):
        BlockLeastSquaresEstimator(block_size=16).fit_store(store, Dataset(y_long, device="cpu"))


def test_oc_ragged_row_weighs_nothing(tmp_path):
    """A row with α = 0 (the reference's mesh padding) changes nothing:
    the fit with it equals the fit without it."""
    x, y = _problem(seed=15)
    k = y.shape[1]
    xp = np.concatenate([x, 100.0 * np.ones((1, x.shape[1]), np.float32)])
    yp = np.concatenate([y, np.ones((1, k), np.float32)])
    alpha = torch.cat([torch.ones(96), torch.zeros(1)])
    s1 = FeatureBlockStore.from_array(str(tmp_path / "a"), x, block_size=16)
    s2 = FeatureBlockStore.from_array(str(tmp_path / "b"), xp, block_size=16)
    w1, xm1, ym1 = _oc_bcd_fit(s1, torch.from_numpy(y), torch.ones(96), 96.0, 1e-2, 2, True)
    w2, xm2, ym2 = _oc_bcd_fit(s2, torch.from_numpy(yp), alpha, 96.0, 1e-2, 2, True)
    for a, b in ((w1, w2), (xm1, xm2), (ym1, ym2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_spill_dir_is_fresh_under_its_hint(tmp_path):
    a, b = block_ls._spill_dir(str(tmp_path / "h")), block_ls._spill_dir(str(tmp_path / "h"))
    assert a != b and os.path.dirname(a) == str(tmp_path / "h")


# ----------------------------------------------------------------- durable


def test_save_npz_rotates_and_load_npz_falls_back(tmp_path):
    path = str(tmp_path / "ck.npz")
    durable.save_npz(path, {"epoch": 0, "w": np.zeros(3)})
    durable.save_npz(path, {"epoch": 1, "w": np.ones(3)})
    assert os.path.exists(path + ".1") and os.path.exists(path + ".b2")
    arrays, used = durable.load_npz(path)
    assert used == path and int(arrays["epoch"]) == 1
    with open(path, "r+b") as f:  # damage the newest: the previous one is read
        f.seek(10)
        f.write(b"\x00\x01\x02")
    arrays, used = durable.load_npz(path)
    assert used == path + ".1" and int(arrays["epoch"]) == 0
    assert durable.load_npz(path, validate=lambda z: False) is None

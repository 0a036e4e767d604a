"""The loaders' and out-of-core solvers' knobs, the apply chunk and the
matmul mode, held against the JAX package on the CPU.

- Loaders: ``label_map`` and ``limit`` on tars written here and on the
  committed fixture (``tests/data/imagenet_tars``, member 6 not a JPEG),
  pixels and labels equal to the reference's, and ``prefetch`` reaching
  every loader's stream.  No tolerance: the decoders agree bit for bit.
- Stream helpers: ``prefetched``'s order, ``transform`` and
  re-iteration (tests/test_loaders.py:320-336), ``stream_labeled``'s
  ``prefetch``.
- Out of core: the bf16 spill within the reference's 2e-2 of the f32
  in-memory fit and of the reference's own bf16 fit
  (tests/test_outofcore.py:267), the f32 fits within its 2e-4;
  ``KEYSTONE_OC_PREFETCH`` and ``prefetch=`` with the reference's
  messages (tests/test_outofcore.py:335-400, tests/test_kernel_oc.py:200-230).
- Block store: the feed's window with a ``stage`` spy
  (tests/test_outofcore.py:476) and ``KEYSTONE_VERIFY_BLOCKS``.
- Chunked applies: bit for bit against whole-batch applies
  (tests/test_workflow.py:261,279); SIFT at chunk 64 against the
  reference's at 64 within ``ATOL_SIFT``.
- ``KEYSTONE_MATMUL`` in a child process each package (it is read at
  import), ``default_optimizer``'s sample sizes and ``Pipeline.apply``.
"""

import io
import json
import logging
import os
import subprocess
import sys
import tarfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.loaders.imagenet import ImageNetLoader as JLoader
from keystone_tpu.loaders.stream import batched as j_batched
from keystone_tpu.loaders.stream import prefetched as j_prefetched
from keystone_tpu.models import BlockLeastSquaresEstimator as JBls
from keystone_tpu.models import BlockWeightedLeastSquaresEstimator as JBwls
from keystone_tpu.ops.sift import SIFTExtractor as JSift
from keystone_tpu.workflow import Dataset as JDataset
from keystone_tpu.workflow import Pipeline as JPipeline
from keystone_tpu.workflow import StreamDataset as JStream
from keystone_tpu.workflow import optimizer as JO
from keystone_tpu.workflow.transformer import transformer as j_transformer
from keystone_tpu_torch.loaders import stream as stream_mod
from keystone_tpu_torch.loaders.cifar import CifarLoader, write_records
from keystone_tpu_torch.loaders.csv_loader import CsvDataLoader
from keystone_tpu_torch.loaders.imagenet import ImageNetLoader
from keystone_tpu_torch.loaders.labeled import LabeledData
from keystone_tpu_torch.loaders.mnist import MnistLoader, write_csv
from keystone_tpu_torch.loaders.stream import batched, prefetched, stream_labeled
from keystone_tpu_torch.loaders.timit import TimitFeaturesDataLoader
from keystone_tpu_torch.loaders.voc import VOCLoader
from keystone_tpu_torch.models import block_ls
from keystone_tpu_torch.models import kernel_ridge as kr
from keystone_tpu_torch.models.block_ls import (
    _OC_PREFETCH_MAX,
    BlockLeastSquaresEstimator,
    _oc_bcd_fit,
    _oc_prefetch,
)
from keystone_tpu_torch.models.block_weighted_ls import BlockWeightedLeastSquaresEstimator
from keystone_tpu_torch.ops.sift import SIFTExtractor
from keystone_tpu_torch.ops.stats import ColumnSampler
from keystone_tpu_torch.planner import registry
from keystone_tpu_torch.tools import lint
from keystone_tpu_torch.utils import durable
from keystone_tpu_torch.workflow import optimizer as O
from keystone_tpu_torch.workflow import transformer as T
from keystone_tpu_torch.workflow.blockstore import FeatureBlockStore, RowBlockStore
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset
from keystone_tpu_torch.workflow.pipeline import Pipeline
from keystone_tpu_torch.workflow.transformer import iter_row_chunks, transformer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
TARS = os.path.join(DATA, "imagenet_tars")
PIXELS = os.path.join(DATA, "imagenet_tars_decoded.npy")
VOC = {"images_dir": os.path.join(DATA, "voc", "JPEGImages"),
       "annotations_dir": os.path.join(DATA, "voc", "Annotations")}
BAD = 6  # the fixture's member that is not a JPEG, in index order

ATOL_OC = 2e-4  # tests/test_outofcore.py's, f32 store
ATOL_OC_BF16 = 2e-2  # tests/test_outofcore.py's, bf16 spill
ATOL_ALPHA = 1e-5  # tests/test_kernel_oc.py:107
# SIFT's descriptors, port against reference: the same f32 chain in
# another op order; entries are at most 0.2 after the clamp
ATOL_SIFT = 1e-5


def _jpeg(rng, size=(8, 8)):
    from PIL import Image

    img = np.clip(rng.uniform(40, 220, size=3) + rng.normal(0, 8, (*size, 3)), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


def _write_tars(root, per_tar=(5, 4), bad=None):
    """Synsets ``syn_a``, ``syn_b``, ... of ``per_tar`` JPEGs each; ``bad``:
    (tar, member) pairs written as bytes that are not a JPEG."""
    rng = np.random.default_rng(0)
    os.makedirs(root, exist_ok=True)
    for t, count in enumerate(per_tar):
        with tarfile.open(os.path.join(root, f"syn_{'abc'[t]}.tar"), "w") as tf:
            for k in range(count):
                blob = b"not a jpeg" if bad and (t, k) in bad else _jpeg(rng)
                info = tarfile.TarInfo(f"img{k}.JPEG")
                info.size = len(blob)
                tf.addfile(info, io.BytesIO(blob))
    return root


def _cat(ld):
    return np.concatenate(list(ld.data.batches()))


# ------------------------------------------------------------------ loaders


@pytest.mark.parametrize("limit", [None, 3, 7])
def test_label_map_and_limit_on_tars_match_the_reference(tmp_path, limit):
    """test_loaders.py:223 on two synset tars: the map's labels, the first
    ``limit`` members (7 crosses into the second tar), the same pixels."""
    root = _write_tars(str(tmp_path / "tars"))
    lm = {"syn_a": 7, "syn_b": 3}
    got = ImageNetLoader.load(root, label_map=lm, size=(8, 8), limit=limit, device="cpu")
    want = JLoader.load(root, label_map=lm, size=(8, 8), limit=limit)
    np.testing.assert_array_equal(got.data.numpy(), want.data.numpy())
    np.testing.assert_array_equal(got.labels.numpy(), want.labels.numpy())
    assert got.data.n == (9 if limit is None else limit)
    assert got.data.name.endswith(f":lim{limit}") and want.data.name.endswith(f":lim{limit}")
    st = ImageNetLoader.stream(root, label_map=lm, size=(8, 8), batch_size=2, limit=limit, device="cpu")
    jst = JLoader.stream(root, label_map=lm, size=(8, 8), batch_size=2, limit=limit)
    np.testing.assert_array_equal(_cat(st), _cat(jst))
    np.testing.assert_array_equal(st.labels.numpy(), jst.labels.numpy())
    assert f":lim{limit}:" in st.data.name
    # a synset the map lacks is label 0, as the reference's .get(synset, 0)
    part = ImageNetLoader.index(root, label_map={"syn_b": 5})
    assert [e[3] for e in part] == [0] * 5 + [5] * 4 == [e[3] for e in JLoader.index(root, {"syn_b": 5})]


def test_stream_limit_equals_the_reference_stream():
    """test_stream_e2e.py:82 on the committed fixture: the index's first 7
    members, the undecodable one a zero image with its label kept."""
    st = ImageNetLoader.stream(TARS, size=(32, 32), batch_size=4, limit=7, device="cpu")
    jst = JLoader.stream(TARS, size=(32, 32), batch_size=4, limit=7)
    assert st.data.n == st.labels.n == 7 == jst.data.n
    got = _cat(st)
    np.testing.assert_array_equal(got, _cat(jst))
    np.testing.assert_array_equal(got, np.load(PIXELS)[:7])
    np.testing.assert_array_equal(st.labels.numpy(), [0, 0, 0, 0, 1, 1, 1])
    np.testing.assert_array_equal(st.labels.numpy(), jst.labels.numpy())


def test_load_limit_keeps_the_first_decodable_members():
    """``load(limit=7)`` on the fixture: members 0-5 and 7, the first seven
    that decode in index order (the reference's tarfile path and its
    docstring).  The reference's native path gives members 0-5 and 9
    instead (keystone_tpu/loaders/imagenet.py:194-212): it reads
    ``limit - len(images)`` blobs of a tar before decoding them, and when
    one of them fails the rest of that tar is never read."""
    ref = np.load(PIXELS)
    got = ImageNetLoader.load(TARS, size=(32, 32), limit=7, device="cpu")
    np.testing.assert_array_equal(got.data.numpy(), ref[[0, 1, 2, 3, 4, 5, 7]])
    np.testing.assert_array_equal(got.labels.numpy(), [0, 0, 0, 0, 1, 1, 1])
    native = JLoader.load(TARS, size=(32, 32), limit=7)
    np.testing.assert_array_equal(native.data.numpy(), ref[[0, 1, 2, 3, 4, 5, 9]])
    np.testing.assert_array_equal(native.labels.numpy(), [0, 0, 0, 0, 1, 1, 2])
    # a limit past the decodable members keeps them all
    every = ImageNetLoader.load(TARS, size=(32, 32), limit=40, device="cpu")
    np.testing.assert_array_equal(every.data.numpy(), np.delete(ref, BAD, axis=0))


def test_load_limit_rereads_past_several_failures(tmp_path):
    """Two undecodable members inside the cut: each costs another round,
    and the rounds keep index order across the tars."""
    root = _write_tars(str(tmp_path / "tars"), per_tar=(3, 4), bad={(0, 1), (1, 0)})
    got = ImageNetLoader.load(root, size=(8, 8), limit=4, device="cpu")
    full = _cat(ImageNetLoader.stream(root, size=(8, 8), batch_size=7, device="cpu"))
    np.testing.assert_array_equal(got.data.numpy(), full[[0, 2, 4, 5]])
    np.testing.assert_array_equal(got.labels.numpy(), [0, 0, 1, 1])


def _prefetch_spy(monkeypatch):
    """Record the ``prefetch`` every StreamDataset passes to ``prefetched``."""
    seen = []
    orig = stream_mod.prefetched

    def spy(source, transform=None, prefetch=2):
        seen.append(prefetch)
        return orig(source, transform=transform, prefetch=prefetch)

    monkeypatch.setattr(stream_mod, "prefetched", spy)
    return seen


def _loader_cases(tmp):
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 255, size=(21, 6)).round().astype(np.float32)
    labels = rng.integers(0, 4, 21)
    csv = os.path.join(tmp, "rows.csv")
    np.savetxt(csv, np.column_stack([labels, x]), fmt="%d", delimiter=",")
    mnist = os.path.join(tmp, "mnist.csv")
    write_csv(mnist, x, labels)
    cifar = os.path.join(tmp, "cifar.bin")
    write_records(cifar, rng.uniform(size=(21, 32, 32, 3)).astype(np.float32), labels)
    feats, labs = os.path.join(tmp, "f.npy"), os.path.join(tmp, "l.npy")
    np.save(feats, x)
    np.save(labs, labels)
    return {
        "imagenet": lambda p: ImageNetLoader.stream(TARS, size=(16, 16), batch_size=5, prefetch=p, device="cpu"),
        "imagenet_synthetic": lambda p: ImageNetLoader.synthetic_stream(10, 3, (16, 16), batch_size=4, prefetch=p,
                                                                        device="cpu"),
        "voc": lambda p: VOCLoader.stream(**VOC, size=(16, 16), batch_size=4, prefetch=p, device="cpu"),
        "voc_synthetic": lambda p: VOCLoader.synthetic_stream(10, (16, 16), batch_size=4, prefetch=p, device="cpu"),
        "cifar": lambda p: CifarLoader.stream(cifar, batch_size=8, prefetch=p, device="cpu"),
        "csv": lambda p: CsvDataLoader.stream(csv, batch_size=8, prefetch=p, device="cpu"),
        "mnist": lambda p: MnistLoader.stream(mnist, batch_size=8, prefetch=p, device="cpu"),
        "timit": lambda p: TimitFeaturesDataLoader.stream(feats, labs, batch_size=8, prefetch=p, device="cpu"),
    }


@pytest.mark.parametrize("loader", ["imagenet", "imagenet_synthetic", "voc", "voc_synthetic", "cifar", "csv",
                                    "mnist", "timit"])
def test_loader_prefetch_reaches_the_stream(tmp_path, monkeypatch, loader):
    """Each loader's ``prefetch`` is its stream's producer depth (0: no
    producer thread), and no depth changes a pixel or a label."""
    make = _loader_cases(str(tmp_path))[loader]
    want = make(2)
    want_x, want_y = _cat(want), want.labels.numpy()
    seen = _prefetch_spy(monkeypatch)
    for p in (0, 1, 4):
        seen.clear()
        got = make(p)
        np.testing.assert_array_equal(_cat(got), want_x)
        np.testing.assert_array_equal(got.labels.numpy(), want_y)
        assert seen == ([] if p == 0 else [p]), (p, seen)


# ----------------------------------------------------------- stream helpers


def test_prefetched_order_transform_and_reiteration():
    """test_loaders.py:320-336: the batches in order through ``transform``
    (on the producer thread), twice, equal to the reference's."""
    data = np.arange(64, dtype=np.float32).reshape(16, 4)
    threads = []

    def double(b):
        import threading

        threads.append(threading.current_thread().name)
        return b * 2

    src = prefetched(batched(data, 6), transform=double, prefetch=1)
    jsrc = j_prefetched(j_batched(data, 6), transform=lambda b: b * 2, prefetch=1)
    for _ in range(2):
        got = [np.asarray(b) for b in src()]
        want = [np.asarray(b) for b in jsrc()]
        assert [g.shape for g in got] == [w.shape for w in want] == [(6, 4), (6, 4), (4, 4)]
        np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
        np.testing.assert_array_equal(np.concatenate(got), data * 2)
    assert threads and all(t == "stream-prefetch" for t in threads)


def test_prefetched_transform_error_reaches_the_consumer():
    def bad(b):
        if b[0, 0] >= 8:
            raise RuntimeError("transform failed")
        return b

    src = prefetched(batched(np.arange(16, dtype=np.float32).reshape(8, 2), 4), transform=bad)
    it = src()
    assert next(it).shape == (4, 2)
    with pytest.raises(RuntimeError, match="transform failed"):
        next(it)


def test_stream_labeled_prefetch_is_plumbed(monkeypatch):
    x = np.random.default_rng(1).normal(size=(13, 3)).astype(np.float32)
    ld = LabeledData.of(x, np.arange(13) % 2, "cpu")
    seen = _prefetch_spy(monkeypatch)
    plain = stream_labeled(ld, 4)
    assert seen == []  # the default: no producer thread
    deep = stream_labeled(ld, 4, prefetch=3)
    assert seen == [3]
    np.testing.assert_array_equal(_cat(deep), x)
    np.testing.assert_array_equal(_cat(plain), x)
    assert deep.labels is ld.labels


# ------------------------------------------------------------ out of core


def _problem(n=96, d=37, k=5, seed=0, skew=False):
    """tests/test_outofcore.py::_problem: ±1 indicators of k classes."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if skew:
        p = np.array([0.6, 0.2, 0.1, 0.06, 0.04])[:k]
        lbl = rng.choice(k, size=n, p=p / p.sum())
    else:
        lbl = rng.integers(0, k, size=n)
    y = -np.ones((n, k), np.float32)
    y[np.arange(n), lbl] = 1.0
    return x, y


def _labels(y):
    return Dataset(torch.from_numpy(y), device="cpu")


def _classes(weighted):
    return (BlockWeightedLeastSquaresEstimator, JBwls) if weighted else (BlockLeastSquaresEstimator, JBls)


@pytest.mark.parametrize("weighted", [False, True])
def test_bf16_spill_through_fit_stream_dataset(tmp_path, monkeypatch, weighted):
    """``spill_dtype`` reaches the spill (tests/test_outofcore.py:289), the
    bf16 model is within 2e-2 of the f32 in-memory fit and of the
    reference's own bf16 streamed fit (test_outofcore.py:267)."""
    seen = []
    orig = FeatureBlockStore.from_batches.__func__

    def spy(cls, directory, batches, n, block_size, dtype="float32"):
        seen.append(dtype)
        return orig(cls, directory, batches, n, block_size, dtype=dtype)

    monkeypatch.setattr(FeatureBlockStore, "from_batches", classmethod(spy))
    x, y = _problem(seed=7, skew=weighted)
    cls, jcls = _classes(weighted)
    kw = dict(block_size=16, num_iter=3, lam=1e-2)
    est = cls(spill_dtype="bfloat16", **kw)
    parts = [x[:32], x[32:64], x[64:]]
    got = est.fit_stream_dataset(StreamDataset(parts, n=96, device="cpu"), _labels(y))
    assert seen == ["bfloat16"]
    want = jcls(spill_dtype="bfloat16", **kw).fit_stream_dataset(JStream(parts, n=96), JDataset(y, n=96))
    np.testing.assert_allclose(got.flat_weights.numpy(), np.asarray(want.flat_weights), atol=ATOL_OC_BF16)
    np.testing.assert_allclose(got.intercept.numpy(), np.asarray(want.intercept), atol=ATOL_OC_BF16)
    mem = cls(**kw).fit_arrays(x, y, device="cpu")
    np.testing.assert_allclose(got.flat_weights.numpy(), mem.flat_weights.numpy(), atol=ATOL_OC_BF16)
    np.testing.assert_allclose(got.intercept.numpy(), mem.intercept.numpy(), atol=ATOL_OC_BF16)
    assert est.params()[-1] == "bfloat16" and est.params() != cls(**kw).params()
    assert est.params()[-1] == jcls(spill_dtype="bfloat16", **kw).params()[-1]


@pytest.mark.parametrize("weighted", [False, True])
def test_bf16_store_fit_matches_the_reference_on_the_same_bits(tmp_path, weighted):
    """One bf16 store, fitted by both packages: the same bits widened to
    f32 by each, so the reference's f32 tolerance holds; and within 2e-2
    of the port's in-memory f32 fit."""
    from keystone_tpu.workflow import FeatureBlockStore as JStore

    x, y = _problem(seed=8, skew=weighted)
    cls, jcls = _classes(weighted)
    store = FeatureBlockStore.from_array(str(tmp_path / "s"), x, block_size=16, dtype="bfloat16")
    got = cls(block_size=16, num_iter=3, lam=1e-2).fit_store(store, _labels(y))
    want = jcls(block_size=16, num_iter=3, lam=1e-2).fit_store(JStore(store.directory), JDataset(y, n=96))
    np.testing.assert_allclose(got.flat_weights.numpy(), np.asarray(want.flat_weights), atol=ATOL_OC)
    np.testing.assert_allclose(got.intercept.numpy(), np.asarray(want.intercept), atol=ATOL_OC)
    mem = cls(block_size=16, num_iter=3, lam=1e-2).fit_arrays(x, y, device="cpu")
    np.testing.assert_allclose(got.flat_weights.numpy(), mem.flat_weights.numpy(), atol=ATOL_OC_BF16)


@pytest.mark.parametrize("weighted", [False, True])
def test_spill_dtype_defaults_and_refusals(tmp_path, weighted):
    cls, _ = _classes(weighted)
    old = cls.__new__(cls)  # an estimator pickled before spill_dtype existed
    assert old.spill_dtype == "float32"
    est = cls(block_size=16, spill_dtype="float16")
    x, y = _problem(seed=2)
    with pytest.raises(ValueError, match="dtype must be one of"):
        est.fit_stream_dataset(StreamDataset([x], n=96, device="cpu"), _labels(y), spill_dir=str(tmp_path))


def _iter_blocks_spy(monkeypatch, cls=FeatureBlockStore):
    seen = []
    orig = cls.iter_blocks

    def spy(self, order, prefetch=2):
        seen.append(prefetch)
        return orig(self, order, prefetch=prefetch)

    monkeypatch.setattr(cls, "iter_blocks", spy)
    return seen


def test_oc_prefetch_explicit_reaches_every_sweep(tmp_path, monkeypatch):
    """tests/test_outofcore.py:335: fit_store(prefetch=3) reaches every
    iter_blocks of the sweep, and the model is the in-memory one."""
    seen = _iter_blocks_spy(monkeypatch)
    x, y = _problem(seed=11)
    est = BlockLeastSquaresEstimator(block_size=16, num_iter=2, lam=1e-2)
    store = FeatureBlockStore.from_array(str(tmp_path / "s"), x, block_size=16)
    got = est.fit_store(store, _labels(y), prefetch=3)
    assert seen and all(p == 3 for p in seen), seen
    mem = est.fit_arrays(x, y, device="cpu")
    np.testing.assert_allclose(got.flat_weights.numpy(), mem.flat_weights.numpy(), atol=ATOL_OC)
    seen.clear()
    est.fit_stream_dataset(StreamDataset([x], n=96, device="cpu"), _labels(y), prefetch=5)
    assert seen and all(p == 5 for p in seen), seen


def test_oc_prefetch_env_override(tmp_path, monkeypatch):
    """tests/test_outofcore.py:352: the variable governs when the caller
    passes nothing; an explicit value wins."""
    monkeypatch.setenv("KEYSTONE_OC_PREFETCH", "5")
    assert _oc_prefetch() == 5
    assert _oc_prefetch(3) == 3
    monkeypatch.setenv("KEYSTONE_OC_PREFETCH", "4")
    seen = _iter_blocks_spy(monkeypatch)
    x, y = _problem(seed=12)
    est = BlockWeightedLeastSquaresEstimator(block_size=16, num_iter=1, lam=1e-2, mixture_weight=0.25)
    store = FeatureBlockStore.from_array(str(tmp_path / "s"), x, block_size=16)
    est.fit_store(store, _labels(y))
    assert seen and all(p == 4 for p in seen), seen


@pytest.mark.parametrize("bad", ["junk", "eight", "0", "-3", "100000", "2.5"])
def test_oc_prefetch_rejects_garbage_env(monkeypatch, bad):
    """tests/test_outofcore.py:372: the same values raise in both packages,
    naming the variable; an explicit value still wins."""
    from keystone_tpu.models.block_ls import _oc_prefetch as j_oc_prefetch

    monkeypatch.setenv("KEYSTONE_OC_PREFETCH", bad)
    with pytest.raises(ValueError, match="KEYSTONE_OC_PREFETCH"):
        _oc_prefetch()
    with pytest.raises(ValueError, match="KEYSTONE_OC_PREFETCH"):
        j_oc_prefetch()
    assert _oc_prefetch(3) == 3 == j_oc_prefetch(3)


def test_oc_prefetch_defaults_and_bounds(monkeypatch):
    """tests/test_outofcore.py:387, and the port's messages are the reference's."""
    from keystone_tpu.models.block_ls import _OC_PREFETCH_MAX as J_MAX
    from keystone_tpu.models.block_ls import _oc_prefetch as j_oc_prefetch

    assert _OC_PREFETCH_MAX == J_MAX == 64
    monkeypatch.delenv("KEYSTONE_OC_PREFETCH", raising=False)
    assert _oc_prefetch() == 2
    monkeypatch.setenv("KEYSTONE_OC_PREFETCH", "")
    assert _oc_prefetch() == 2
    monkeypatch.setenv("KEYSTONE_OC_PREFETCH", str(_OC_PREFETCH_MAX))
    assert _oc_prefetch() == _OC_PREFETCH_MAX
    monkeypatch.delenv("KEYSTONE_OC_PREFETCH", raising=False)
    for bad, pattern in ((100000, "prefetch=100000"), (0, "prefetch=0")):
        with pytest.raises(ValueError, match=pattern) as got:
            _oc_prefetch(bad)
        with pytest.raises(ValueError, match=pattern) as want:
            j_oc_prefetch(bad)
        assert str(got.value) == str(want.value)
    monkeypatch.setenv("KEYSTONE_OC_PREFETCH", "eight")
    with pytest.raises(ValueError) as got:
        _oc_prefetch()
    with pytest.raises(ValueError) as want:
        j_oc_prefetch()
    assert str(got.value) == str(want.value)


def test_oc_bcd_fit_refuses_a_bad_depth_before_reading(tmp_path, monkeypatch):
    x, y = _problem(seed=13)
    store = FeatureBlockStore.from_array(str(tmp_path / "s"), x, block_size=16)
    seen = _iter_blocks_spy(monkeypatch)
    yt = torch.from_numpy(y)
    with pytest.raises(ValueError, match="prefetch=65"):
        _oc_bcd_fit(store, yt, torch.ones(96), 96.0, 1e-2, 1, True, prefetch=65)
    assert seen == []


def _krr_problem(n=150, d=12, k=3, seed=0):
    """tests/test_kernel_oc.py::_problem."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, k)).astype(np.float32)
    return x, (x @ w + 0.01 * rng.normal(size=(n, k))).astype(np.float32)


def _krr(epochs=1):
    return kr.KernelRidgeRegressionEstimator(kr.GaussianKernelGenerator(0.05), lam=1e-4, block_size=32,
                                             num_epochs=epochs)


def test_krr_prefetch_explicit_and_alpha_unchanged(tmp_path, monkeypatch):
    """tests/test_kernel_oc.py:200: fit_store(prefetch=3) reaches the
    sweep's iter_blocks, and α is the default depth's bit for bit and
    the reference's within its 1e-5."""
    from keystone_tpu.models import kernel_ridge as jkr
    from keystone_tpu.workflow.blockstore import RowBlockStore as JRowStore

    x, y = _krr_problem(seed=5)
    store = RowBlockStore.from_array(str(tmp_path / "s"), x, 32)
    base = _krr(2).fit_store(store, _labels(y)).alpha
    seen = _iter_blocks_spy(monkeypatch, RowBlockStore)
    got = _krr(2).fit_store(store, _labels(y), prefetch=3).alpha
    assert seen and all(p == 3 for p in seen), seen
    assert torch.equal(got, base)
    want = jkr._oc_krr_fit(JRowStore(store.directory), jnp.asarray(y), 150.0, 0.05, 1e-4, 2, prefetch=3)
    # across the packages, 1e-5 of α's largest entry (tests/test_torch_kernel_oc.py's)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_ALPHA * np.abs(want).max())
    seen.clear()
    sd = StreamDataset([x[:70], x[70:]], n=150, device="cpu")
    _krr().fit_stream_dataset(sd, _labels(y), spill_dir=str(tmp_path / "spill"), prefetch=6)
    assert seen and all(p == 6 for p in seen), seen


def test_krr_prefetch_env_and_bounds(tmp_path, monkeypatch):
    """tests/test_kernel_oc.py:211: the KRR sweep rides the same bounded
    resolution: the variable honoured, garbage and out of range refused."""
    monkeypatch.setenv("KEYSTONE_OC_PREFETCH", "4")
    seen = _iter_blocks_spy(monkeypatch, RowBlockStore)
    x, y = _krr_problem(seed=6)
    store = RowBlockStore.from_array(str(tmp_path / "s"), x, 32)
    _krr().fit_store(store, _labels(y))
    assert seen and all(p == 4 for p in seen), seen
    monkeypatch.setenv("KEYSTONE_OC_PREFETCH", "eight")
    with pytest.raises(ValueError, match="KEYSTONE_OC_PREFETCH"):
        _krr().fit_store(store, _labels(y))
    monkeypatch.delenv("KEYSTONE_OC_PREFETCH")
    with pytest.raises(ValueError, match="prefetch"):
        _krr().fit_store(store, _labels(y), prefetch=100)


# -------------------------------------------------------------- block store


@pytest.mark.parametrize("window", [1, 2, 4])
def test_iter_device_blocks_bounds_the_window_with_a_stage(tmp_path, window):
    """tests/test_outofcore.py:476: the feed never runs more than
    ``window`` staged blocks ahead of the consumer, and reaches that lead."""
    x = np.random.default_rng(23).normal(size=(8, 80)).astype(np.float32)
    store = FeatureBlockStore.from_array(str(tmp_path / "s"), x, block_size=8)
    staged = []

    def spy_stage(blk):
        staged.append(blk)
        return blk.to(torch.float64)

    consumed, leads = 0, []
    for b, a in store.iter_device_blocks(range(10), "cpu", prefetch=2, stage=spy_stage, window=window):
        assert a.dtype == torch.float64
        np.testing.assert_array_equal(a.numpy(), store.read_block(b).double().numpy())
        consumed += 1
        leads.append(len(staged) - consumed)
    assert consumed == 10 and max(leads) == window, leads


def test_iter_device_blocks_prefetch_and_window_change_no_block(tmp_path, monkeypatch):
    x = np.random.default_rng(24).normal(size=(8, 40)).astype(np.float32)
    store = FeatureBlockStore.from_array(str(tmp_path / "s"), x, block_size=8, dtype="bfloat16")
    order = [0, 3, 1, 4, 2, 0]
    want = [(b, a) for b, a in store.iter_device_blocks(order, "cpu")]
    seen = _iter_blocks_spy(monkeypatch)
    for prefetch, window in ((1, 1), (4, 4), (7, 3)):
        got = list(store.iter_device_blocks(order, "cpu", prefetch=prefetch, window=window))
        assert [b for b, _ in got] == order
        assert all(torch.equal(a, w) and a.dtype == torch.float32 for (_, a), (_, w) in zip(got, want))
        assert seen[-1] == prefetch


def _alter_payload(path):
    """Flip one payload byte: the same size, other contents."""
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        last = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last[0] ^ 0x01]))


def test_verify_blocks_switch(tmp_path, monkeypatch):
    """``KEYSTONE_VERIFY_BLOCKS=0`` skips only the checksum: an altered
    block of the same size reads back as altered, where ``=1`` (and the
    default) raises; truncation is still caught; another value raises."""
    x = np.random.default_rng(3).normal(size=(8, 8)).astype(np.float32)
    store = FeatureBlockStore.from_array(str(tmp_path / "s"), x, block_size=4)
    path = os.path.join(store.directory, "block_0001.npy")
    _alter_payload(path)
    monkeypatch.setenv("KEYSTONE_VERIFY_BLOCKS", "0")
    blk = store.read_block(1).numpy()
    assert blk.shape == (8, 4) and (blk != x[:, 4:]).sum() == 1
    for value in ("1", None):
        if value is None:
            monkeypatch.delenv("KEYSTONE_VERIFY_BLOCKS")
        else:
            monkeypatch.setenv("KEYSTONE_VERIFY_BLOCKS", value)
        with pytest.raises(durable.CorruptStateError, match="checksum mismatch"):
            store.read_block(1)
    monkeypatch.setenv("KEYSTONE_VERIFY_BLOCKS", "yes")
    with pytest.raises(ValueError, match="KEYSTONE_VERIFY_BLOCKS"):
        store.read_block(0)
    monkeypatch.setenv("KEYSTONE_VERIFY_BLOCKS", "0")
    with open(path, "r+b") as f:
        f.truncate(64)
    with pytest.raises(durable.CorruptStateError, match="truncated"):
        store.read_block(1)


def test_verify_blocks_off_leaves_the_fit_unchanged(tmp_path, monkeypatch):
    x, y = _problem(seed=14)
    store = FeatureBlockStore.from_array(str(tmp_path / "s"), x, block_size=16)
    est = BlockLeastSquaresEstimator(block_size=16, num_iter=2, lam=1e-2)
    on = est.fit_store(store, _labels(y))
    verified = []
    orig = durable.verify_checksum
    monkeypatch.setattr(durable, "verify_checksum", lambda p, *a, **k: verified.append(p) or orig(p, *a, **k))
    monkeypatch.setenv("KEYSTONE_VERIFY_BLOCKS", "0")
    off = est.fit_store(store, _labels(y))
    assert verified == []
    assert torch.equal(on.flat_weights, off.flat_weights) and torch.equal(on.intercept, off.intercept)


# ------------------------------------------------------------ chunked apply


def test_chunk_64_equals_whole_batch_applies(monkeypatch):
    """tests/test_workflow.py:261: 205 rows in chunks of 64 (three and a
    ragged tail) against one whole-batch apply, bit for bit."""
    x = np.random.default_rng(11).normal(size=(205, 6)).astype(np.float32)
    rows = []
    op = transformer(lambda v: v + 1.5, batch=lambda xs: rows.append(xs.shape[0]) or xs + 1.5)
    monkeypatch.setenv("KEYSTONE_APPLY_CHUNK", "64")
    chunked = op.apply_dataset(Dataset(x, device="cpu"))
    assert rows == [64, 64, 64, 13]
    monkeypatch.setenv("KEYSTONE_APPLY_CHUNK", "0")
    rows.clear()
    whole = op.apply_dataset(Dataset(x, device="cpu"))
    assert rows == [205]
    assert torch.equal(chunked.array, whole.array) and chunked.n == whole.n == 205
    jop = j_transformer(lambda v: v + 1.5, batch=lambda xs: xs + 1.5)
    monkeypatch.setenv("KEYSTONE_APPLY_CHUNK", "64")
    np.testing.assert_array_equal(chunked.array.numpy(), np.asarray(jop.apply_dataset(JDataset(x)).array)[:205])


def test_chunked_sift_and_sampler_equal_whole_batch(monkeypatch):
    """tests/test_workflow.py:279: SIFT (a (values, mask) producer) and
    ColumnSampler (draws keyed by the global item) at chunk 32 against 0."""
    imgs = np.random.default_rng(4).uniform(0, 1, (70, 40, 40)).astype(np.float32)
    sift, sampler = SIFTExtractor(step=6, bin_sizes=(4,)), ColumnSampler(8, seed=3)
    monkeypatch.setenv("KEYSTONE_APPLY_CHUNK", "32")
    d1 = sift.apply_dataset(Dataset(imgs, device="cpu"))
    s1 = sampler.apply_dataset(d1)
    monkeypatch.setenv("KEYSTONE_APPLY_CHUNK", "0")
    d0 = sift.apply_dataset(Dataset(imgs, device="cpu"))
    s0 = sampler.apply_dataset(d0)
    assert torch.equal(d1.array, d0.array) and torch.equal(d1.mask, d0.mask)
    assert torch.equal(s1.array, s0.array)


def test_sift_at_chunk_64_matches_the_reference_at_64(monkeypatch):
    monkeypatch.setenv("KEYSTONE_APPLY_CHUNK", "64")
    imgs = np.random.default_rng(5).uniform(0, 1, (70, 40, 40)).astype(np.float32)
    got = SIFTExtractor(step=6, bin_sizes=(4,)).apply_dataset(Dataset(imgs, device="cpu"))
    want = JSift(step=6, bin_sizes=(4,)).apply_dataset(JDataset(imgs))
    np.testing.assert_allclose(got.array.numpy(), np.asarray(want.array)[:70], atol=ATOL_SIFT, rtol=0)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask)[:70])


def test_apply_chunk_resolution(monkeypatch, caplog):
    monkeypatch.delenv("KEYSTONE_APPLY_CHUNK", raising=False)
    assert T._apply_chunk_rows() == T.APPLY_CHUNK_ROWS == 128
    for raw, rows in (("100", 100), (" 7 ", 7), ("0", 0), ("-5", 0)):
        monkeypatch.setenv("KEYSTONE_APPLY_CHUNK", raw)
        assert T._apply_chunk_rows() == rows
    x = torch.arange(10.0).reshape(5, 2)
    monkeypatch.setenv("KEYSTONE_APPLY_CHUNK", "2")
    assert [i for _, _, i in iter_row_chunks(x, None)] == [0, 2, 4]
    assert [a.shape[0] for a, _, _ in iter_row_chunks(x, None, 3)] == [3, 2]
    assert [a.shape[0] for a, _, _ in iter_row_chunks(x, None, 0)] == [5]
    monkeypatch.setenv("KEYSTONE_APPLY_CHUNK", "lots")
    with caplog.at_level(logging.WARNING, "keystone_tpu_torch.workflow.transformer"):
        assert T._apply_chunk_rows() == 0
    assert any("is not an integer; chunking stays DISABLED" in r.message for r in caplog.records)


# ------------------------------------------------- precision and small API

_PROBE = r"""
import importlib, json, os, sys
mod, force = sys.argv[1], sys.argv[2]
out = {}
for mode in ("auto", "f32", "bf16", "bf16_apply", "fp8"):
    os.environ["KEYSTONE_MATMUL"] = mode
    os.environ["KEYSTONE_BF16_APPLY_FORCE"] = force
    try:
        p = importlib.reload(importlib.import_module(mod))
    except ValueError as e:
        out[mode] = ["error", str(e)]
        continue
    name = str(p.fdtype()).replace("torch.", "").replace("<class 'jax.numpy.", "").rstrip("'>")
    out[mode] = [name, p.apply_mode() if hasattr(p, "apply_mode") else None]
print(json.dumps(out))
"""


def _probe(module, force="0"):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _PROBE, module, force], capture_output=True, text=True, env=env,
                       timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_keystone_matmul_is_read_at_import():
    """Each mode's descriptor dtype is the reference's: on the CPU for
    auto, f32 and bf16; for bf16_apply the reference's resolution on its
    chip (its CPU gate lifted by KEYSTONE_BF16_APPLY_FORCE=1), while the
    port's apply side stays f32.  A bad value raises in both."""
    port = _probe("keystone_tpu_torch.utils.precision")
    ref = _probe("keystone_tpu.utils.precision")
    ref_chip = _probe("keystone_tpu.utils.precision", force="1")
    assert port["auto"] == ["float32", "f32"] and ref["auto"][0] == "float32"
    assert port["f32"] == ["float32", "f32"] and ref["f32"][0] == "float32"
    assert port["bf16"] == ["bfloat16", "f32"] and ref["bf16"][0] == "bfloat16"
    assert port["bf16_apply"] == ["bfloat16", "f32"] and ref_chip["bf16_apply"][0] == "bfloat16"
    for got in (port["fp8"], ref["fp8"]):
        assert got[0] == "error" and "KEYSTONE_MATMUL must be one of" in got[1] and "'fp8'" in got[1]
    assert port["fp8"][1] == ref["fp8"][1]


def test_default_optimizer_sample_sizes():
    def sizes(opt, o):
        return [r.sample_size for b in opt.batches for r in b.rules
                if isinstance(r, (o.NodeChoiceRule, o.ProfiledMaterializeRule))]

    assert sizes(O.default_optimizer(), O) == [256, 64] == sizes(JO.default_optimizer(), JO)
    assert sizes(O.default_optimizer(16, materialize_sample_size=8), O) == [16, 8]
    assert sizes(JO.default_optimizer(16, materialize_sample_size=8), JO) == [16, 8]
    assert O.NodeChoiceRule(12).sample_size == 12 and O.NodeChoiceRule.sample_size == 256
    assert O.ProfiledMaterializeRule(5).sample_size == 5 and O.ProfiledMaterializeRule.sample_size == 64


def test_pipeline_apply_is_call():
    x = np.random.default_rng(6).normal(size=(9, 4)).astype(np.float32)
    pipe = Pipeline.of(transformer(lambda v: v * 2.0, batch=lambda xs: xs * 2.0))
    got = pipe.apply(Dataset(x, device="cpu")).get().array
    assert torch.equal(got, pipe(Dataset(x, device="cpu")).get().array)
    jpipe = JPipeline.of(j_transformer(lambda v: v * 2.0, batch=lambda xs: xs * 2.0))
    want = jpipe.apply(JDataset(x)).get()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.array)[:want.n])


def test_new_variables_are_registered_for_the_lint_rule():
    names = lint.load_gate_env()
    for v in ("KEYSTONE_APPLY_CHUNK", "KEYSTONE_OC_PREFETCH", "KEYSTONE_VERIFY_BLOCKS", "KEYSTONE_MATMUL"):
        assert v in registry.OPERATIONAL_ENV and v in names
    assert registry.gate_env_names() == {"KEYSTONE_FUSED_FV", "KEYSTONE_POOL_BUDGET_BYTES"}
    assert registry.gate_env_names() <= names
    assert registry.GATES["matmul"]["env"] is None  # a plan never changes numerics

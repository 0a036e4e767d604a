"""The port's streamed path on the CPU: StreamDataset through the workflow
graph, the samplers over a stream, the streamed ImageNetSiftLcsFV fit
against the port's in-memory fit, and the ImageNet tar loader on the
committed fixture against the reference's native libjpeg decode.

The fixture (``tests/data/imagenet_tars``: three synsets of four 32×32
JPEGs, and one member that is not a JPEG) and its decoded pixels
(``tests/data/imagenet_tars_decoded.npy``) come from
``tests/data/make_imagenet_tars.py``."""

import dataclasses
import logging
import os
import time

import numpy as np
import pytest
import torch

from keystone_tpu import native
from keystone_tpu.loaders.imagenet import ImageNetLoader as JLoader
from keystone_tpu.loaders.imagenet import _decode_entry_batch as j_decode_entry_batch
from keystone_tpu_torch.loaders import jpeg
from keystone_tpu_torch.loaders.imagenet import ImageNetLoader
from keystone_tpu_torch.loaders.stream import batched, prefetched, stream_labeled
from keystone_tpu_torch.models.block_weighted_ls import BlockWeightedLeastSquaresEstimator
from keystone_tpu_torch.ops.images import GrayScaler, PixelScaler
from keystone_tpu_torch.ops.stats import ColumnSampler, Sampler
from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as port
from keystone_tpu_torch.pipelines.imagenet_sift_lcs_fv import Config, ImageNetSiftLcsFV
from keystone_tpu_torch.workflow import blockstore, optimizer
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset
from keystone_tpu_torch.workflow.pipeline import Pipeline, fit_relevant_config
from keystone_tpu_torch.workflow.transformer import transformer

DATA = os.path.join(os.path.dirname(__file__), "data")
TARS = os.path.join(DATA, "imagenet_tars")
PIXELS = os.path.join(DATA, "imagenet_tars_decoded.npy")
BAD = 6  # the member of the fixture that is not a JPEG, in index order

# the streamed fit against the in-memory fit: the same images and draws,
# features made in other batches (7 a stream batch, 128 an in-memory
# chunk); f32 sums of other lengths round apart by ~1e-6 relative, which
# the solve carries into scores of order 1
ATOL_STREAM_SCORES = 5e-4

# test_stream_e2e.py's configuration of the north-star gate
BASE = dict(num_classes=4, synthetic_n=24, image_size=48, gmm_k=4, pca_dims=16, num_epochs=2,
            descriptor_samples_per_image=16, solver_block_size=64, stream_batch_size=7)


def _stream(x, batch, **kw):
    return StreamDataset(batched(x, batch), n=len(x), device="cpu", **kw)


# ----------------------------------------------------------- StreamDataset


def test_stream_dataset_is_reiterable_and_lazy():
    x = np.arange(23 * 3, dtype=np.float32).reshape(23, 3)
    calls = []

    def double(xs):
        calls.append(xs.shape[0])
        return xs * 2

    s = _stream(x, 5, prefetch=2)
    mapped = transformer(double, batch=double)(s)
    assert isinstance(mapped, StreamDataset) and mapped.n == 23 and calls == []  # a recipe
    for _ in range(2):
        np.testing.assert_array_equal(np.concatenate(list(mapped.batches())), 2 * x)
    assert calls == [5, 5, 5, 5, 3] * 2
    assert mapped.peek_shape() == (3,) and mapped.item_shape == (3,)
    assert mapped.cache() is mapped


def test_stream_dataset_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="re-iterable"):
        StreamDataset(iter([np.zeros((2, 2))]), n=2, device="cpu")
    # a host stream is taken, and a host transformer maps it lazily
    calls = []
    host = StreamDataset([["a doc", "b"], ["c"]], n=3, host=True, device="cpu")
    upper = transformer(lambda v: calls.append(v) or v.upper(), host=True)(host)
    assert isinstance(upper, StreamDataset) and upper.is_host and calls == []
    assert list(upper.batches()) == [["A DOC", "B"], ["C"]] and calls == ["a doc", "b", "c"]
    assert upper.items == ["A DOC", "B", "C"] and upper._host_chain[0] is host
    with pytest.raises(TypeError, match="host-payload"):
        upper.array
    with pytest.raises(TypeError, match="device transformer"):
        transformer(lambda v: v)(host)
    with pytest.raises(TypeError, match="host transformer"):
        transformer(lambda v: v, host=True)(_stream(np.zeros((4, 2), np.float32), 2))


def test_stream_array_materializes_with_the_warning(caplog):
    x = np.random.default_rng(0).normal(size=(9, 4)).astype(np.float32)
    s = StreamDataset([(x[:4], np.ones((4,), np.float32)), (x[4:], np.zeros((5,), np.float32))], n=9,
                      device="cpu")
    with caplog.at_level(logging.WARNING, "keystone_tpu_torch.workflow.dataset"):
        np.testing.assert_array_equal(s.array.numpy(), x)
    assert any("materializing StreamDataset" in r.message for r in caplog.records)
    np.testing.assert_array_equal(s.mask.numpy(), [1] * 4 + [0] * 5)


def test_prefetched_reraises_the_producers_error():
    def source():
        yield np.zeros((2, 2))
        raise OSError("the disk went away")

    gen = prefetched(source, prefetch=1)
    with pytest.raises(OSError, match="went away"):
        list(gen())


def test_prefetched_stops_its_thread_when_the_consumer_leaves():
    made = []

    def source():
        for i in range(1000):
            made.append(i)
            yield np.full((2,), i)

    gen = prefetched(source, prefetch=2)()
    assert int(next(gen)[0]) == 0
    gen.close()  # the consumer leaves after one batch
    n = len(made)
    assert n <= 4  # the one taken, the queue's two, one parked in put
    time.sleep(0.3)
    assert len(made) == n  # the thread made nothing more


def test_stream_gather_two_branches_equals_the_in_memory_gather():
    x = np.random.default_rng(1).normal(size=(17, 4)).astype(np.float32)
    a = transformer(lambda v: v * 2, batch=lambda v: v * 2, name="twice")
    b = transformer(lambda v: v + 1, batch=lambda v: v + 1, name="plus1")
    pipe = Pipeline.gather([Pipeline.of(a), Pipeline.of(b)])
    streamed = pipe(_stream(x, 5)).get()
    assert isinstance(streamed, StreamDataset)
    mem = pipe(Dataset(x, device="cpu")).get()
    np.testing.assert_array_equal(np.concatenate(list(streamed.batches())), mem.numpy())
    with pytest.raises(ValueError, match="disagree on n"):
        StreamDataset.zip_concat([_stream(x, 5), _stream(x[:3], 5)])


def test_stream_labeled_wraps_in_memory_data():
    data = ImageNetLoader.synthetic(10, 3, (16, 16), seed=4, device="cpu")
    st = stream_labeled(data, 4)
    assert isinstance(st.data, StreamDataset) and st.labels is data.labels
    assert [b.shape[0] for b in st.data.batches()] == [4, 4, 2]
    np.testing.assert_array_equal(np.concatenate(list(st.data.batches())), data.data.numpy())


def test_synthetic_stream_is_pixel_identical_to_synthetic():
    st = ImageNetLoader.synthetic_stream(24, 4, (48, 48), seed=1, batch_size=7, device="cpu")
    mem = ImageNetLoader.synthetic(24, 4, (48, 48), seed=1, device="cpu")
    assert [b.shape[0] for b in st.data.batches()] == [7, 7, 7, 3]
    np.testing.assert_array_equal(np.concatenate(list(st.data.batches())), mem.data.numpy())
    np.testing.assert_array_equal(st.labels.numpy(), mem.labels.numpy())
    ref = JLoader.synthetic_stream(24, 4, size=(48, 48), seed=1, batch_size=7)
    np.testing.assert_array_equal(np.concatenate(list(ref.data.batches())), mem.data.numpy())


# ---------------------------------------------------------------- samplers


def test_column_sampler_over_a_stream_draws_the_in_memory_rows():
    rng = np.random.default_rng(3)
    descs = rng.normal(size=(20, 15, 6)).astype(np.float32)
    masks = (rng.uniform(size=(20, 15)) < 0.7).astype(np.float32)
    masks[:, 0] = 1.0
    cs = ColumnSampler(8, seed=5)
    mem = cs.apply_dataset(Dataset(descs, mask=torch.from_numpy(masks), device="cpu"))
    batches = [(descs[:7], masks[:7]), (descs[7:12], masks[7:12]), (descs[12:], masks[12:])]
    st = cs.apply_dataset(StreamDataset(batches, n=20, device="cpu"))
    assert not isinstance(st, StreamDataset)
    np.testing.assert_array_equal(st.numpy(), mem.numpy())
    with pytest.raises(ValueError, match="produced 20 items, expected 21"):
        cs.apply_dataset(StreamDataset(batches, n=21, device="cpu"))


def test_sampler_over_a_stream_keeps_the_in_memory_rows():
    x = np.random.default_rng(6).normal(size=(31, 3)).astype(np.float32)
    s = Sampler(9, seed=2)
    mem = s.apply_dataset(Dataset(x, device="cpu"))
    st = s.apply_dataset(_stream(x, 4))
    np.testing.assert_array_equal(st.numpy(), mem.numpy())


def test_optimizer_samples_a_stream_from_its_first_batches():
    x = np.random.default_rng(7).normal(size=(40, 3)).astype(np.float32)
    head = optimizer._stream_head(_stream(x, 6), 10)
    np.testing.assert_array_equal(head.numpy(), x[:10])
    cuda_stream = StreamDataset._wrap(lambda: iter(()), 5, torch.device("cuda"))
    g, _ = Pipeline.of(GrayScaler()).graph.replace_source_with_node(
        Pipeline.of(GrayScaler()).source, optimizer.G.DatasetOperator(cuda_stream))
    assert optimizer.data_device(g) == torch.device("cuda")  # from the stream's device, without sweeping it


# ------------------------------------------------------- the streamed fit


def _spy_spills(monkeypatch):
    spills = []
    orig = blockstore.FeatureBlockStore.from_batches.__func__

    def spy(cls, directory, batches, n, block_size, dtype="float32"):
        store = orig(cls, directory, batches, n, block_size, dtype=dtype)
        spills.append((store.n, store.d, store.num_blocks))
        return store

    monkeypatch.setattr(blockstore.FeatureBlockStore, "from_batches", classmethod(spy))
    return spills


def test_streamed_fit_predicts_what_the_in_memory_fit_predicts(monkeypatch, caplog):
    """The north-star gate (tests/test_stream_e2e.py:179) for the port:
    the streamed two-branch fit spills n rows and predicts the in-memory
    fit's top-k ids, its scores within ATOL_STREAM_SCORES, and no stage
    materializes the stream."""
    cfg = Config(**BASE)
    mem = ImageNetLoader.synthetic(24, 4, (48, 48), seed=1, device="cpu")
    test = ImageNetLoader.synthetic(8, 4, (48, 48), seed=2, device="cpu")
    spills = _spy_spills(monkeypatch)
    st = ImageNetLoader.synthetic_stream(24, 4, (48, 48), seed=1, batch_size=7, device="cpu")
    with caplog.at_level(logging.WARNING, "keystone_tpu_torch.workflow.dataset"):
        fitted_st = ImageNetSiftLcsFV.build_scorer(dataclasses.replace(cfg, stream=True), st.data,
                                                   st.labels).fit()
        scores_st = fitted_st(test.data).get().numpy()
    assert not [r for r in caplog.records if "materializing StreamDataset" in r.message]
    d = 2 * 2 * cfg.gmm_k * cfg.pca_dims
    assert spills == [(24, d, -(-d // cfg.solver_block_size))]
    scores_mem = ImageNetSiftLcsFV.build_scorer(cfg, mem.data, mem.labels).fit()(test.data).get().numpy()
    np.testing.assert_allclose(scores_st, scores_mem, atol=ATOL_STREAM_SCORES)
    top = ImageNetSiftLcsFV.build(cfg, mem.data, mem.labels).fit()(test.data).get().numpy()
    top_st = ImageNetSiftLcsFV.build(cfg, st.data, st.labels).fit()(test.data).get().numpy()
    np.testing.assert_array_equal(top_st, top)


def test_streamed_fit_sweeps_the_stream_as_predicted(monkeypatch):
    """Each consumer re-sweeps the training stream: the two samplers of a
    branch and the solver's spill each run its extractor once over it
    (three sweeps a branch), and the spill's gather decodes the source
    once a branch.  The profiled materialization pass before them reads
    the stream's head (its sample of 64 rows, here all 24) and runs the
    shared extractors on it once; its pricing at full batch runs them on
    fake tensors, which read no data and are not counted."""
    from torch._subclasses.fake_tensor import FakeTensor

    from keystone_tpu_torch.ops.lcs import LCSExtractor
    from keystone_tpu_torch.ops.sift import SIFTExtractor
    from keystone_tpu_torch.workflow import profiling

    rows = {"fit": {"SIFTExtractor": 0, "LCSExtractor": 0, "source": 0},
            "profile": {"SIFTExtractor": 0, "LCSExtractor": 0, "source": 0}}
    where = ["fit"]
    for cls in (SIFTExtractor, LCSExtractor):
        orig = cls.apply_batch

        def counted(self, xs, mask=None, _orig=orig, _name=cls.__name__):
            if not isinstance(xs, FakeTensor):
                rows[where[0]][_name] += xs.shape[0]
            return _orig(self, xs, mask)

        monkeypatch.setattr(cls, "apply_batch", counted)
    orig_profile = profiling.profile_graph

    def profiled(*a, **kw):
        where[0] = "profile"
        try:
            return orig_profile(*a, **kw)
        finally:
            where[0] = "fit"

    monkeypatch.setattr(profiling, "profile_graph", profiled)
    st = ImageNetLoader.synthetic_stream(24, 4, (48, 48), seed=1, batch_size=7, device="cpu")
    src = st.data._gen

    def counted_source():
        for arr, mask in src():
            rows[where[0]]["source"] += arr.shape[0]
            yield arr, mask

    st.data._gen = counted_source
    ImageNetSiftLcsFV.build(Config(**BASE, stream=True), st.data, st.labels).fit()
    assert rows == {"fit": {"SIFTExtractor": 3 * 24, "LCSExtractor": 3 * 24, "source": 6 * 24},
                    "profile": {"SIFTExtractor": 24, "LCSExtractor": 24, "source": 24}}


def test_run_streams_with_stream_batch_size(monkeypatch):
    sizes = []
    orig = ImageNetLoader.synthetic_stream

    def spy(*a, **kw):
        sizes.append(kw["batch_size"])
        return orig(*a, **kw)

    monkeypatch.setattr(ImageNetLoader, "synthetic_stream", staticmethod(spy))
    spills = _spy_spills(monkeypatch)
    out = ImageNetSiftLcsFV.run(Config(**BASE, stream=True), device="cpu")
    assert sizes == [7] and spills and spills[0][0] == 24
    assert out["pipeline"] == "ImageNetSiftLcsFV" and 0.0 <= out["top5_error"] <= 1.0
    assert out["accuracy"] > 0.5  # the synthetic textures are learnable


def test_augmented_eval_composes_with_stream():
    out_mem = ImageNetSiftLcsFV.run(Config(**BASE, augmented_eval=True), device="cpu")
    out_st = ImageNetSiftLcsFV.run(Config(**BASE, augmented_eval=True, stream=True), device="cpu")
    np.testing.assert_allclose(out_st["top5_error"], out_mem["top5_error"], atol=1e-6)
    np.testing.assert_allclose(out_st["accuracy"], out_mem["accuracy"], atol=1e-6)


def test_stream_settings_do_not_stale_a_saved_model():
    a = fit_relevant_config(Config(**BASE))
    b = fit_relevant_config(Config(**{**BASE, "stream_batch_size": 64}, stream=True))
    assert a == b and "stream_batch_size" not in a


def test_main_takes_stream_flags(capsys):
    port.main(["--device", "cpu", "--num-classes", "3", "--gmm-k", "4", "--pca-dims", "8", "--synthetic-n", "12",
               "--image-size", "40", "--stream", "--stream-batch-size", "5"])
    assert "'pipeline': 'ImageNetSiftLcsFV'" in capsys.readouterr().out


def test_block_solver_routes_a_stream_to_its_streamed_fit(monkeypatch):
    called = []
    monkeypatch.setattr(BlockWeightedLeastSquaresEstimator, "fit_stream_dataset",
                        lambda self, data, labels: called.append(data.n) or "fitted")
    x = np.zeros((6, 4), np.float32)
    est = BlockWeightedLeastSquaresEstimator(block_size=4)
    assert est.fit_dataset(_stream(x, 4), Dataset(np.ones((6, 2), np.float32), device="cpu")) == "fitted"
    assert called == [6]


# -------------------------------------------------------------- tar loader


def test_index_counts_members_and_labels():
    entries = ImageNetLoader.index(TARS)
    assert len(entries) == 13
    assert [e[3] for e in entries] == [0] * 4 + [1] * 5 + [2] * 4
    assert [e[1:] for e in entries] == [e[1:] for e in JLoader.index(TARS)]


def test_stream_pixels_equal_the_reference_decode(caplog):
    ref = np.load(PIXELS)
    with caplog.at_level(logging.WARNING, "keystone_tpu_torch.loaders.imagenet"):
        st = ImageNetLoader.stream(TARS, size=(32, 32), batch_size=5, device="cpu")
        got = np.concatenate(list(st.data.batches()))
    np.testing.assert_array_equal(got, ref)
    assert not got[BAD].any()  # the undecodable member: a zero image, its label kept
    np.testing.assert_array_equal(st.labels.numpy(), [0] * 4 + [1] * 5 + [2] * 4)
    assert [r for r in caplog.records if "undecodable member" in r.message]
    np.testing.assert_array_equal(np.concatenate(list(st.data.batches())), ref)  # re-iterable


def test_load_skips_the_undecodable_member_and_agrees_with_stream():
    ref = np.load(PIXELS)
    mem = ImageNetLoader.load(TARS, size=(32, 32), device="cpu")
    assert mem.data.n == 12
    np.testing.assert_array_equal(mem.data.numpy(), np.delete(ref, BAD, axis=0))
    np.testing.assert_array_equal(mem.labels.numpy(), [0] * 4 + [1] * 4 + [2] * 4)
    st = ImageNetLoader.stream(TARS, size=(32, 32), batch_size=4, device="cpu")
    assert st.data.n == 13 and st.labels.n == 13


@pytest.mark.parametrize("size", [(32, 32), (20, 45), (64, 48)])
def test_decode_equals_the_reference_native_decode(size):
    """The port's libjpeg copy against the reference's native library on
    the same bytes, at the identity size and at resizes both ways."""
    assert native.available()
    entries = ImageNetLoader.index(TARS)
    want = j_decode_entry_batch(entries, size)
    jpeg.reset_launches()
    got = ImageNetLoader.stream(TARS, size=size, batch_size=13, device="cpu")
    np.testing.assert_array_equal(np.concatenate(list(got.data.batches())), want)
    assert jpeg.LAUNCHES == {"libjpeg": 1, "nvjpeg": 0}


def test_run_from_tars_with_stream():
    cfg = Config(**{**BASE, "num_classes": 3, "image_size": 32, "stream_batch_size": 5}, stream=True,
                 train_path=TARS, test_path=TARS)
    out = ImageNetSiftLcsFV.run(cfg, device="cpu")
    assert out["accuracy"] > 0.9  # three colour-separated synsets (test_stream_e2e.py:232)
    out_mem = ImageNetSiftLcsFV.run(dataclasses.replace(cfg, stream=False), device="cpu")
    assert out_mem["accuracy"] > 0.9


def test_tar_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the CPU-only refusal is not observable")
    for call in (lambda: ImageNetLoader.load(TARS, size=(32, 32)),
                 lambda: ImageNetLoader.stream(TARS, size=(32, 32)),
                 lambda: ImageNetLoader.synthetic_stream(4, 2, (16, 16))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_decoders_refuse_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        jpeg.decode(*jpeg.pack([b"x"]), (8, 8), "meta")

"""The port's kernel pipelines against the JAX package on the CPU: the
Nyström estimator (its stream sampling included), the scaler as an
estimator (its streamed moments included), the TIMIT and CIFAR loaders
on files written here, the ``--stream`` plumbing, and
KernelTimitPipeline.run and KernelCifarPipeline.run through the graph,
in memory and streamed, at the reference's own test configs
(tests/test_pipelines.py:77-113).

Tolerances: the landmarks are the same rows, held bit for bit; the
scaler's moments, which the port sums in float64, within 1e-6 of the
reference's f32 sums (relative); the loaders' arrays bit for bit (the
reference's native CIFAR reader aside, one ulp from its numpy path); each
run's accuracy equal to the reference's and its predicted classes equal
on every test item; a streamed run equal to the in-memory run."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.loaders import stream as jstream
from keystone_tpu.loaders.cifar import CifarLoader as JCifar
from keystone_tpu.loaders.timit import TimitFeaturesDataLoader as JTimit
from keystone_tpu.models import kernel_ridge as jkr
from keystone_tpu.models.nystrom import NystromFeatures as JNystrom
from keystone_tpu.ops.images import ImageVectorizer as JImageVectorizer
from keystone_tpu.ops.stats import StandardScaler as JScaler
from keystone_tpu.pipelines import kernel_cifar as jkc
from keystone_tpu.pipelines import kernel_timit as jkt
from keystone_tpu.workflow import StreamDataset as JStream
from keystone_tpu_torch.convert import kernel_cifar_params_from_numpy
from keystone_tpu_torch.loaders import cifar, stream
from keystone_tpu_torch.loaders.cifar import CifarLoader
from keystone_tpu_torch.loaders.timit import TimitFeaturesDataLoader
from keystone_tpu_torch.models import kernel_ridge as kr
from keystone_tpu_torch.models.nystrom import NystromFeatures
from keystone_tpu_torch.ops.images import ImageVectorizer
from keystone_tpu_torch.ops.stats import StandardScaler
from keystone_tpu_torch.pipelines import kernel_cifar as pkc
from keystone_tpu_torch.pipelines import kernel_timit as pkt
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset

RTOL_MOMENTS = 1e-6

TIMIT_CFG = dict(num_landmarks=96, solver_block_size=96, num_epochs=2, num_classes=8, synthetic_n=512)
CIFAR_CFG = dict(num_landmarks=64, solver_block_size=64, num_epochs=2, synthetic_n=256)


def _stream(x, batch):
    return StreamDataset(stream.batched(x, batch), n=x.shape[0], device="cpu")


# ------------------------------------------------------------------ Nyström


@pytest.mark.parametrize("batch", [7, 64, 200])
def test_sample_stream_equals_the_in_memory_draw(batch):
    x = np.random.default_rng(0).normal(size=(150, 6)).astype(np.float32)
    est = NystromFeatures(kr.GaussianKernelGenerator(0.2), num_landmarks=40, reg=1e-3, seed=5)
    in_memory = est.fit_dataset(Dataset(x, device="cpu"))
    streamed = est.fit_dataset(_stream(x, batch))
    assert torch.equal(streamed.landmarks, in_memory.landmarks)
    assert torch.equal(streamed.whiten, in_memory.whiten)
    assert torch.equal(in_memory.landmarks, est.fit_arrays(x, device="cpu").landmarks)
    # the reference's stream sampling picks the same rows
    jfit = JNystrom(jkr.GaussianKernelGenerator(0.2), num_landmarks=40, reg=1e-3, seed=5).fit_dataset(
        JStream(jstream.batched(x, batch), n=150))
    np.testing.assert_array_equal(streamed.landmarks.numpy(), np.asarray(jfit.landmarks))


def test_sample_stream_short_delivery_raises():
    x = np.zeros((10, 4), np.float32)
    sd = StreamDataset([x[:5]], n=64, device="cpu")
    with pytest.raises(ValueError, match="landmarks"):
        NystromFeatures(kr.GaussianKernelGenerator(0.1), 32).fit_dataset(sd)
    with pytest.raises(TypeError, match="host-payload"):
        NystromFeatures(kr.GaussianKernelGenerator(0.1), 2).fit_dataset(Dataset(["a", "b"]))


def test_estimators_carry_the_references_params():
    est = NystromFeatures(kr.GaussianKernelGenerator(0.2), num_landmarks=40, reg=1e-3, seed=5)
    jest = JNystrom(jkr.GaussianKernelGenerator(0.2), num_landmarks=40, reg=1e-3, seed=5)
    assert est.params() == jest.params()
    assert StandardScaler(False, 1e-6).params() == JScaler(False, 1e-6).params()


# ------------------------------------------------------------------- scaler


@pytest.mark.parametrize("normalize_std", [True, False])
def test_scaler_fit_stream_matches_reference(normalize_std):
    rng = np.random.default_rng(1)
    x = (30.0 + 0.1 * rng.normal(size=(203, 9))).astype(np.float32)  # large mean, small spread
    x[:, 4] = 2.0  # a constant column: the std clamps at eps
    batches = [x[i:i + 32] for i in range(0, 203, 32)]
    got = StandardScaler(normalize_std).fit_stream([torch.from_numpy(b) for b in batches])
    want = JScaler(normalize_std).fit_stream(batches)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=RTOL_MOMENTS)
    if normalize_std:
        np.testing.assert_allclose(got.std.numpy(), np.asarray(want.std), rtol=1e-4)  # tests/test_torch_kernel_tier.py's
        # float64 sums: the stream's and the whole tensor's f32 moments are the same
        whole = StandardScaler().fit_dataset(Dataset(x, device="cpu"))
        assert torch.equal(got.mean, whole.mean) and torch.equal(got.std, whole.std)
        streamed = StandardScaler().fit_dataset(_stream(x, 50))
        assert torch.equal(streamed.std, whole.std) and streamed.std.device.type == "cpu"
        # against the moments in float64
        cols = [0, 1, 2, 3, 5]
        np.testing.assert_allclose(got.std.numpy()[cols], x.astype(np.float64).std(0, ddof=1)[cols], rtol=1e-6)
    else:
        assert got.std is None and want.std is None


def test_scaler_fit_stream_refuses_bad_streams():
    x = torch.ones((4, 3))
    with pytest.raises(ValueError, match="empty"):
        StandardScaler().fit_stream([])
    with pytest.raises(ValueError, match="re-iterable"):
        StandardScaler().fit_stream(iter([x, x]))


def test_image_vectorizer_matches_reference():
    imgs = np.random.default_rng(2).random((3, 4, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(ImageVectorizer()(torch.from_numpy(imgs)).numpy(),
                                  np.asarray(JImageVectorizer().apply_batch(jnp.asarray(imgs))))


# ------------------------------------------------------------------ loaders


def _timit_files(tmp_path, n=50, fmt="npy"):
    x, labels = TimitFeaturesDataLoader.synthetic_arrays(n, 8, seed=3)
    if fmt == "npy":
        fp, lp = str(tmp_path / "f.npy"), str(tmp_path / "l.npy")
        np.save(fp, x)
        np.save(lp, labels)
    else:
        fp, lp = str(tmp_path / "f.csv"), str(tmp_path / "l.txt")
        np.savetxt(fp, x, delimiter=",", fmt="%.9g")
        np.savetxt(lp, labels, fmt="%d")
    return x, labels, fp, lp


@pytest.mark.parametrize("fmt", ["npy", "csv"])
def test_timit_load_and_stream_match_reference(tmp_path, fmt):
    x, labels, fp, lp = _timit_files(tmp_path, fmt=fmt)
    got = TimitFeaturesDataLoader.load(fp, lp, device="cpu")
    want = JTimit.load(fp, lp)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data.array)[:want.data.n])
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels.array)[:want.labels.n])
    if fmt == "npy":
        np.testing.assert_array_equal(got.data.numpy(), x)
    st = TimitFeaturesDataLoader.stream(fp, lp, batch_size=16, device="cpu")
    jst = JTimit.stream(fp, lp, batch_size=16)
    assert isinstance(st.data, StreamDataset) and st.data.n == 50
    got_b, want_b = list(st.data.batches()), list(jst.data.batches())
    assert [b.shape for b in got_b] == [b.shape for b in want_b] == [(16, 440)] * 3 + [(2, 440)]
    np.testing.assert_array_equal(np.concatenate(got_b), np.concatenate(want_b))
    np.testing.assert_array_equal(st.labels.numpy(), got.labels.numpy())


def test_timit_synthetic_matches_reference():
    got = TimitFeaturesDataLoader.synthetic(64, 8, seed=2, device="cpu")
    want = JTimit.synthetic(64, 8, seed=2)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data.array)[:64])
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels.array)[:64])


def test_cifar_load_and_stream_match_reference(tmp_path):
    imgs, labels = CifarLoader.synthetic_arrays(37, seed=4)
    path = str(tmp_path / "data_batch.bin")
    cifar.write_records(path, imgs, labels)
    assert os.path.getsize(path) == 37 * cifar.RECORD
    got = CifarLoader.load(path, device="cpu")
    want = JCifar.load(path)
    # the reference's native reader scales by 1/255f, its numpy path (and
    # its stream) divides by 255, one ulp apart on ~40% of the pixels; the
    # port takes the numpy path everywhere
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data.array)[:37], rtol=1.2e-7, atol=0)
    np.testing.assert_array_equal(got.data.numpy(), cifar._decode_records(np.fromfile(path, np.uint8).reshape(37, -1)))
    np.testing.assert_array_equal(got.labels.numpy(), labels)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels.array)[:37])
    np.testing.assert_allclose(got.data.numpy(), imgs, atol=0.5 / 255 + 1e-7)  # one byte a pixel
    st = CifarLoader.stream(path, batch_size=16, device="cpu")
    jst = JCifar.stream(path, batch_size=16)
    got_b, want_b = list(st.data.batches()), list(jst.data.batches())
    assert [b.shape[0] for b in got_b] == [16, 16, 5]
    np.testing.assert_array_equal(np.concatenate(got_b), np.concatenate(want_b))
    np.testing.assert_array_equal(np.concatenate(got_b), got.data.numpy())
    np.testing.assert_array_equal(st.labels.numpy(), labels)
    open(tmp_path / "empty.bin", "wb").close()
    assert CifarLoader.stream(str(tmp_path / "empty.bin"), device="cpu").data.n == 0
    with open(tmp_path / "bad.bin", "wb") as f:
        f.write(b"\x00" * 100)
    for load in (CifarLoader.load, CifarLoader.stream):
        with pytest.raises(ValueError, match="multiple"):
            load(str(tmp_path / "bad.bin"), device="cpu")


def test_cifar_synthetic_matches_reference():
    got = CifarLoader.synthetic(40, seed=2, device="cpu")
    want = JCifar.synthetic(40, seed=2)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data.array)[:40])
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels.array)[:40])


def test_stream_plumbing():
    import argparse

    cfg = pkc.Config(train_path="train.bin", stream=True)
    with pytest.raises(ValueError, match="--test-path"):
        stream.require_stream_test_path(cfg)
    stream.require_stream_test_path(dataclasses.replace(cfg, test_path="test.bin"))
    calls = []

    def load(p):
        calls.append(("load", p))
        return "loaded"

    def streamed(p, batch_size):
        calls.append(("stream", p, batch_size))
        return "streamed"

    synth = TimitFeaturesDataLoader.synthetic(10, 4, device="cpu")
    for c, want in ((cfg, "streamed"), (dataclasses.replace(cfg, stream=False), "loaded"),
                    (dataclasses.replace(cfg, train_path=None, stream=False), synth)):
        assert stream.resolve_train_source(c, load, streamed, lambda: synth) is want
    demo = stream.resolve_train_source(dataclasses.replace(cfg, train_path=None, stream_batch_size=4), load,
                                       streamed, lambda: synth)
    assert isinstance(demo.data, StreamDataset) and [b.shape[0] for b in demo.data.batches()] == [4, 4, 2]
    assert calls == [("stream", "train.bin", 1024), ("load", "train.bin")]
    p = argparse.ArgumentParser()
    stream.add_stream_args(p, 77, "frames")
    a = p.parse_args(["--out-of-core"])
    assert (a.stream, a.stream_batch_size) == (True, 77)


# ---------------------------------------------------------------- pipelines


def _reference_timit_predictions(cfg):
    """What the reference's run predicts: its pipeline built and fitted as
    ``run`` builds it, applied to run's test set."""
    train = JTimit.synthetic(cfg.synthetic_n, cfg.num_classes, seed=1)
    test = JTimit.synthetic(cfg.synthetic_n // 4, cfg.num_classes, seed=2)
    fitted = jkt.KernelTimitPipeline.build(cfg, train.data, train.labels).fit()
    return fitted(test.data).get().numpy()[:test.data.n]


def test_kernel_timit_run_matches_reference():
    out, out_s = {}, {}
    got = pkt.KernelTimitPipeline.run(pkt.Config(**TIMIT_CFG), device="cpu", out=out)
    want = jkt.KernelTimitPipeline.run(jkt.Config(**TIMIT_CFG))
    assert got["accuracy"] == want["accuracy"] and got["accuracy"] > 0.5, (got, want)
    np.testing.assert_array_equal(out["predictions"], _reference_timit_predictions(jkt.Config(**TIMIT_CFG)))
    streamed = pkt.KernelTimitPipeline.run(pkt.Config(**TIMIT_CFG, stream=True, stream_batch_size=128),
                                           device="cpu", out=out_s)
    assert streamed["accuracy"] == got["accuracy"]
    np.testing.assert_array_equal(out_s["predictions"], out["predictions"])


def _nystrom_map(fitted):
    from keystone_tpu_torch.models.nystrom import NystromFeatureMap

    g = fitted.graph
    ts = [getattr(g.operators.get(n), "transformer", None) for n in g.topological_nodes()]
    return [s for t in ts for s in getattr(t, "stages", [t]) if isinstance(s, NystromFeatureMap)][0]


def test_kernel_timit_run_from_files_in_memory_and_streamed(tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    x, labels = TimitFeaturesDataLoader.synthetic_arrays(512, 8, seed=1)
    xt, lt = TimitFeaturesDataLoader.synthetic_arrays(128, 8, seed=2)
    paths = {}
    for key, arr in (("features_path", x), ("labels_path", labels), ("test_features_path", xt),
                     ("test_labels_path", lt)):
        paths[key] = str(tmp_path / f"{key}.npy")
        np.save(paths[key], arr)
    cfg = pkt.Config(num_landmarks=96, solver_block_size=96, num_epochs=2, num_classes=8, **paths)
    out, out_s = {}, {}
    got = pkt.KernelTimitPipeline.run(cfg, device="cpu", out=out)
    streamed = pkt.KernelTimitPipeline.run(dataclasses.replace(cfg, stream=True, stream_batch_size=100),
                                           device="cpu", out=out_s)
    assert got["accuracy"] == streamed["accuracy"] and got["accuracy"] > 0.5
    np.testing.assert_array_equal(out_s["predictions"], out["predictions"])
    assert torch.equal(_nystrom_map(out_s["fitted"]).landmarks, _nystrom_map(out["fitted"]).landmarks)
    want = jkt.KernelTimitPipeline.run(jkt.Config(num_landmarks=96, solver_block_size=96, num_epochs=2,
                                                  num_classes=8, stream=True, stream_batch_size=100, **paths))
    assert want["accuracy"] == got["accuracy"]
    assert not [e for e in os.listdir(tmp_path) if e.startswith("kst_spill_")]  # the solver's spill is removed


def test_kernel_timit_model_path_round_trip(tmp_path):
    cfg = pkt.Config(**TIMIT_CFG, model_path=str(tmp_path / "kt.pt"))
    out, out2 = {}, {}
    first = pkt.KernelTimitPipeline.run(cfg, device="cpu", out=out)
    second = pkt.KernelTimitPipeline.run(cfg, device="cpu", out=out2)
    assert (first["model_loaded"], second["model_loaded"]) == (False, True)
    np.testing.assert_array_equal(out2["predictions"], out["predictions"])


def test_kernel_cifar_run_matches_reference():
    out, out_s = {}, {}
    got = pkc.KernelCifarPipeline.run(pkc.Config(**CIFAR_CFG), device="cpu", out=out)
    want = jkc.KernelCifarPipeline.run(jkc.Config(**CIFAR_CFG))
    assert got["accuracy"] == want["accuracy"] and got["accuracy"] > 0.5, (got, want)
    train = JCifar.synthetic(256, seed=1)
    test = JCifar.synthetic(64, seed=2)
    fitted = jkc.KernelCifarPipeline.build(jkc.Config(**CIFAR_CFG), train.data, train.labels).fit()
    np.testing.assert_array_equal(out["predictions"], fitted(test.data).get().numpy()[:64])
    streamed = pkc.KernelCifarPipeline.run(pkc.Config(**CIFAR_CFG, stream=True, stream_batch_size=100),
                                           device="cpu", out=out_s)
    assert streamed["accuracy"] == got["accuracy"]
    np.testing.assert_array_equal(out_s["predictions"], out["predictions"])


def test_kernel_cifar_run_from_record_files(tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    paths = {}
    for key, n, seed in (("train_path", 256, 1), ("test_path", 64, 2)):
        paths[key] = str(tmp_path / f"{key}.bin")
        cifar.write_records(paths[key], *CifarLoader.synthetic_arrays(n, seed=seed))
    cfg = pkc.Config(**CIFAR_CFG, **paths)
    out, out_s = {}, {}
    got = pkc.KernelCifarPipeline.run(cfg, device="cpu", out=out)
    streamed = pkc.KernelCifarPipeline.run(dataclasses.replace(cfg, stream=True, stream_batch_size=100),
                                           device="cpu", out=out_s)
    assert streamed["accuracy"] == got["accuracy"] and got["accuracy"] > 0.5
    np.testing.assert_array_equal(out_s["predictions"], out["predictions"])
    want = jkc.KernelCifarPipeline.run(jkc.Config(**CIFAR_CFG, **paths))
    assert want["accuracy"] == got["accuracy"]
    with pytest.raises(ValueError, match="--test-path"):
        pkc.KernelCifarPipeline.run(dataclasses.replace(cfg, test_path=None, stream=True), device="cpu")


def test_mains_run_on_the_cpu(capsys):
    pkt.main(["--device", "cpu", "--num-landmarks", "32", "--synthetic-n", "256", "--num-classes", "4",
              "--num-epochs", "1", "--stream", "--stream-batch-size", "100"])
    pkc.main(["--device", "cpu", "--num-landmarks", "32", "--synthetic-n", "128", "--num-epochs", "1"])
    out = capsys.readouterr().out
    assert "'pipeline': 'KernelTimitPipeline'" in out and "'pipeline': 'KernelCifarPipeline'" in out


def test_jax_fitted_kernel_cifar_carried_across():
    from test_torch_kernel_tier import _kernel_timit_stages

    cfg = jkc.Config(**CIFAR_CFG)
    train = JCifar.synthetic(cfg.synthetic_n, seed=1)
    fitted = jkc.KernelCifarPipeline.build(cfg, train.data, train.labels).fit()
    test = JCifar.synthetic(32, seed=2)
    want = fitted(test.data).get().numpy()[:32]
    _, arrays = _kernel_timit_stages(fitted)
    scorer = pkc.build_scorer_from_params(kernel_cifar_params_from_numpy(arrays, device="cpu"),
                                          pkc.Config(gamma=cfg.gamma), device="cpu")
    np.testing.assert_array_equal(scorer(torch.from_numpy(np.asarray(test.data.array)[:32])).numpy(), want)
    with pytest.raises(ValueError, match="shape"):
        kernel_cifar_params_from_numpy({**arrays, "nystrom.landmarks": arrays["nystrom.landmarks"][:, :440]},
                                       device="cpu")

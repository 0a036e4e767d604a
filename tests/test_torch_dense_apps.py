"""The port's five dense apps (MnistRandomFFT, LinearPixels,
RandomPatchCifar, TimitPipeline, VOCSIFTFisher) against the JAX package on
the CPU, each fitted through the workflow graph:

- each ``run`` at the reference's own test config
  (tests/test_pipelines.py:23-43,63,156) against the reference's ``run``:
  accuracy within ACC_MARGIN (classification) or mean average precision
  within MAP_MARGIN (VOC), each app above the reference test's own gate;
- each app built with the reference's draws carried across (the sign
  flips, the cosine features' W and b, the patch offsets through
  ``convert``; VOC's fitted PCA and GMM, which hold its sampler and
  k-means++ draws): held-out class scores within ATOL_SCORES +
  RTOL_SCORES·|ref| of the reference's, and the predicted classes equal;
- the streamed runs (MNIST from a CSV file, LinearPixels, TIMIT from
  .npy files, VOC synthetic and from the committed fixture) against the
  in-memory runs: scores within ATOL_STREAM, classes and metrics equal;
- the VOC loader on the committed fixture against the reference's, the
  optimizer's FV fusion of VOC's branch, a saved model, and the mains
  with ``--device cpu``.

LinearPixels has no draw: its predictions equal the reference's at once.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from keystone_tpu.loaders.voc import VOCLoader as JVOC
from keystone_tpu.models.pca import PCATransformer as JPCA
from keystone_tpu.ops import stats as jstats
from keystone_tpu.ops.fisher import FisherVector as JFV
from keystone_tpu.ops.util import MaxClassifier as JMax
from keystone_tpu.pipelines import linear_pixels as jlp
from keystone_tpu.pipelines import mnist_random_fft as jmn
from keystone_tpu.pipelines import random_patch_cifar as jrp
from keystone_tpu.pipelines import timit as jti
from keystone_tpu.pipelines import voc_sift_fisher as jvo
from keystone_tpu.workflow import graph as JG
from keystone_tpu.workflow.optimizer import FusedTransformer as JFused
from keystone_tpu.workflow.pipeline import FittedPipeline as JFitted
from keystone_tpu_torch import convert
from keystone_tpu_torch.loaders.cifar import CifarLoader
from keystone_tpu_torch.loaders.mnist import MnistLoader, write_csv
from keystone_tpu_torch.loaders.timit import TimitFeaturesDataLoader
from keystone_tpu_torch.loaders.voc import VOCLoader
from keystone_tpu_torch.models.gmm import GaussianMixtureModel
from keystone_tpu_torch.models.pca import PCAEstimator, PCATransformer
from keystone_tpu_torch.ops import fisher_kernels
from keystone_tpu_torch.ops.fisher import FisherVector, FusedPcaFisherVector, GMMFisherVectorEstimator
from keystone_tpu_torch.ops.util import MaxClassifier
from keystone_tpu_torch.pipelines import linear_pixels as plp
from keystone_tpu_torch.pipelines import mnist_random_fft as pmn
from keystone_tpu_torch.pipelines import random_patch_cifar as prp
from keystone_tpu_torch.pipelines import timit as pti
from keystone_tpu_torch.pipelines import voc_sift_fisher as pvo
from keystone_tpu_torch.workflow import graph as G
from keystone_tpu_torch.workflow import optimizer as opt
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.optimizer import FusedTransformer
from keystone_tpu_torch.workflow.pipeline import FittedPipeline, PipelineEnv

ACC_MARGIN = 0.05
MAP_MARGIN = 0.15
# scores (|s| ≲ 2) of two packages' f32 fits of the same features: normal
# equations or block solves in other summation orders
ATOL_SCORES, RTOL_SCORES = 1e-3, 1e-3
# a streamed fit against the in-memory fit in one package: the same
# solve, its sums taken batch by batch
ATOL_STREAM = 1e-4

MNIST = dict(num_ffts=2, lam=1e-2, synthetic_n=512)
PIXELS = dict(lam=1e-3, synthetic_n=256)
PATCH = dict(num_filters=64, patches_per_image=4, block_size=256, num_iter=2, synthetic_n=192)
TIMIT = dict(num_cosine_features=1024, cosine_block_size=512, num_epochs=2, num_classes=20, synthetic_n=1024,
             lam=1e-4, gamma=0.02)
VOC = dict(gmm_k=4, gmm_iters=4, pca_dims=16, descriptor_samples_per_image=32, solver_block_size=512,
           synthetic_n=36, image_size=48, sift_step=8)
FIXTURE = os.path.join(os.path.dirname(__file__), "data", "voc")
FIXTURE_DIRS = dict(images_dir=os.path.join(FIXTURE, "JPEGImages"), annotations_dir=os.path.join(FIXTURE, "Annotations"))


def _drop_head(fitted, graph_mod, fused_cls, fitted_cls, head_cls):
    """A fitted pipeline without its MaxClassifier head (the head may be
    fused into the last stage): raw class scores.  Either package's."""
    g = fitted.graph
    node = g.sink_dependencies[fitted.sink]
    t = g.operators[node].transformer
    if isinstance(t, head_cls):
        g = g.replace_dependency(node, g.dependencies[node][0]).remove_node(node)
    else:
        assert isinstance(t, fused_cls) and isinstance(t.stages[-1], head_cls), t
        g = g.set_operator(node, graph_mod.TransformerOperator(fused_cls(list(t.stages)[:-1])))
    return fitted_cls(g, fitted.source, fitted.sink)


def _port_scores(fitted, x, head=True):
    scorer = _drop_head(fitted, G, FusedTransformer, FittedPipeline, MaxClassifier) if head else fitted
    return scorer(Dataset(torch.as_tensor(x), device="cpu")).get().numpy()


def _ref_scores(fitted, x, head=True):
    scorer = _drop_head(fitted, JG, JFused, JFitted, JMax) if head else fitted
    out = scorer(x).get()
    return np.asarray(out.array)[:out.n]


def _close_scores(got, want):
    np.testing.assert_allclose(got, want, atol=ATOL_SCORES, rtol=RTOL_SCORES)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


# ----------------------------------------------------- run against the reference


@pytest.mark.parametrize("app", ["mnist", "pixels", "patch", "timit"])
def test_run_matches_reference_run(app):
    port, ref, cfg, gate = {
        "mnist": (pmn.MnistRandomFFT, jmn.MnistRandomFFT, MNIST, 0.8),
        "pixels": (plp.LinearPixels, jlp.LinearPixels, PIXELS, 0.8),
        "patch": (prp.RandomPatchCifar, jrp.RandomPatchCifar, PATCH, 0.6),
        "timit": (pti.TimitPipeline, jti.TimitPipeline, TIMIT, 0.5),
    }[app]
    got = port.run(port.Config(**cfg), device="cpu")
    want = ref.run(ref.Config(**cfg))
    assert got["pipeline"] == want["pipeline"] and not got["model_loaded"]
    assert got["accuracy"] > gate, got
    assert abs(got["accuracy"] - want["accuracy"]) <= ACC_MARGIN, (got, want)


def test_voc_run_matches_reference_run():
    fisher_kernels.reset_launches()
    got = pvo.VOCSIFTFisher.run(pvo.Config(**VOC), device="cpu")
    want = jvo.VOCSIFTFisher.run(jvo.Config(**VOC))
    assert got["mean_ap"] > 0.2 and abs(got["mean_ap"] - want["mean_ap"]) <= MAP_MARGIN, (got, want)
    assert not any(fisher_kernels.LAUNCHES.values()), fisher_kernels.LAUNCHES


# ------------------------------------------------ the reference's draws carried across


def _patch_signs(monkeypatch):
    def init(num_features, seed=0, device="cuda"):
        return convert.random_sign_node_from_numpy(np.asarray(jstats.RandomSignNode.init(num_features, seed).signs),
                                                    device=device)

    monkeypatch.setattr(pmn.RandomSignNode, "init", staticmethod(init))


def _patch_cosines(monkeypatch):
    def init(num_in, num_out, gamma=1.0, seed=0, distribution="gaussian", device="cuda"):
        ref = jstats.CosineRandomFeatures.init(num_in, num_out, gamma=gamma, seed=seed, distribution=distribution)
        return convert.cosine_random_features_from_numpy(np.asarray(ref.w), np.asarray(ref.b), device=device)

    monkeypatch.setattr(pti.CosineRandomFeatures, "init", staticmethod(init))


def _patch_offsets(monkeypatch):
    def offsets(self, n, h, w):
        # the reference's _random_patches draws
        ky, kx = jax.random.split(jax.random.PRNGKey(self.seed))
        ys = jax.random.randint(ky, (n, self.num_patches), 0, h - self.patch_h + 1)
        xs = jax.random.randint(kx, (n, self.num_patches), 0, w - self.patch_w + 1)
        return torch.from_numpy(np.array(ys)).long(), torch.from_numpy(np.array(xs)).long()

    monkeypatch.setattr(prp.RandomPatcher, "offsets", offsets)


@pytest.mark.parametrize("app", ["mnist", "pixels", "patch", "timit"])
def test_reference_draws_give_the_references_scores(app, monkeypatch):
    port, ref, cfg, patch, loader, jloader = {
        "mnist": (pmn.MnistRandomFFT, jmn.MnistRandomFFT, MNIST, _patch_signs, MnistLoader, jmn.MnistLoader),
        "pixels": (plp.LinearPixels, jlp.LinearPixels, PIXELS, None, CifarLoader, jlp.CifarLoader),
        "patch": (prp.RandomPatchCifar, jrp.RandomPatchCifar, PATCH, _patch_offsets, CifarLoader, jrp.CifarLoader),
        "timit": (pti.TimitPipeline, jti.TimitPipeline, TIMIT, _patch_cosines, TimitFeaturesDataLoader,
                  jti.TimitFeaturesDataLoader),
    }[app]
    if patch is not None:
        patch(monkeypatch)
    n = cfg["synthetic_n"]
    classes = (cfg["num_classes"],) if app == "timit" else ()
    train, test = loader.synthetic(n, *classes, seed=1, device="cpu"), loader.synthetic(n // 4, *classes, seed=2,
                                                                                         device="cpu")
    jtrain = jloader.synthetic(n, *classes, seed=1)
    fitted = port.build(port.Config(**cfg), train.data, train.labels).fit()
    jfitted = ref.build(ref.Config(**cfg), jtrain.data, jtrain.labels).fit()
    x = test.data.numpy()
    got, want = _port_scores(fitted, x), _ref_scores(jfitted, x)
    assert got.shape == want.shape and np.isfinite(got).all()
    if app == "pixels":  # no draw, one exact solve: the predictions equal the reference's
        np.testing.assert_array_equal(fitted(test.data).get().numpy(), want.argmax(1))
    _close_scores(got, want)


def _vocabulary(fitted, pca_cls, fv_cls):
    stages = []
    for op in fitted.graph.operators.values():
        t = getattr(op, "transformer", None)
        stages += list(getattr(t, "stages", [t]))
    pca = [s for s in stages if isinstance(s, pca_cls)]
    fv = [s for s in stages if isinstance(s, fv_cls)]
    assert len(pca) == len(fv) == 1
    return pca[0], fv[0]


@pytest.fixture(scope="module")
def voc_reference():
    """The reference's VOC pipeline fitted on run's synthetic training set."""
    cfg = jvo.Config(**VOC)
    train = JVOC.synthetic(cfg.synthetic_n, size=(cfg.image_size,) * 2, seed=1)
    return jvo.VOCSIFTFisher.build(cfg, train.data, train.labels).fit()


def test_voc_with_the_references_vocabulary(voc_reference, monkeypatch):
    """The reference's fitted PCA and GMM (its sampler's and k-means++'s
    draws) substituted for the port's vocabulary fits: the port's graph
    then featurizes, solves and scores as the reference."""
    jpca, jfv = _vocabulary(voc_reference, JPCA, JFV)
    pca = PCATransformer(torch.from_numpy(np.array(jpca.components)), torch.from_numpy(np.array(jpca.mean)))
    g = jfv.gmm
    fv = FisherVector(GaussianMixtureModel(*(torch.from_numpy(np.array(a)) for a in (g.weights, g.means,
                                                                                       g.variances))))
    monkeypatch.setattr(PCAEstimator, "fit_dataset", lambda self, data: pca)
    monkeypatch.setattr(GMMFisherVectorEstimator, "fit_dataset", lambda self, data: fv)
    cfg = pvo.Config(**VOC)
    size = (cfg.image_size,) * 2
    train = VOCLoader.synthetic(cfg.synthetic_n, size=size, seed=1, device="cpu")
    test = VOCLoader.synthetic(max(8, cfg.synthetic_n // 3), size=size, seed=2, device="cpu")
    fitted = pvo.VOCSIFTFisher.build(cfg, train.data, train.labels).fit()
    x = test.data.numpy()
    _close_scores(_port_scores(fitted, x, head=False), _ref_scores(voc_reference, x, head=False))


def test_voc_scoring_fuses_the_sift_branch(monkeypatch):
    """FvFusionRule (made to fire on the CPU) turns VOC's one branch into
    one fused node that takes the SIFT normalize, with the same scores."""
    cfg = pvo.Config(**VOC)
    size = (cfg.image_size,) * 2
    train = VOCLoader.synthetic(24, size=size, seed=1, device="cpu")
    test = VOCLoader.synthetic(8, size=size, seed=2, device="cpu")
    fitted = pvo.VOCSIFTFisher.build(dataclasses.replace(cfg, synthetic_n=24), train.data, train.labels).fit()
    plain = fitted(test.data).get().numpy()
    monkeypatch.setattr(opt, "device_is_cuda", lambda device: True)
    g = PipelineEnv.get_optimizer().execute(fitted(test.data).graph)
    fused = [op.transformer for op in g.operators.values()
             if isinstance(getattr(op, "transformer", None), FusedPcaFisherVector)]
    assert [f.sift_normalize for f in fused] == [True]
    np.testing.assert_allclose(fitted(test.data).get().numpy(), plain, atol=ATOL_STREAM, rtol=0)


# ------------------------------------------------------------ streamed runs


def test_mnist_from_csv_in_memory_and_streamed(tmp_path):
    # 4 branches: n·d = 512·4104 > 2²¹, so the normal equations (and their
    # out-of-core pass over the stream) fit it, not the local solve
    paths = {}
    for key, n, seed in (("train_path", 512, 1), ("test_path", 128, 2)):
        paths[key] = str(tmp_path / f"{key}.csv")
        write_csv(paths[key], *MnistLoader.synthetic_arrays(n, seed))
    cfg = pmn.Config(num_ffts=4, **paths)
    out, out_s = {}, {}
    got = pmn.MnistRandomFFT.run(cfg, device="cpu", out=out)
    streamed = pmn.MnistRandomFFT.run(dataclasses.replace(cfg, stream=True, stream_batch_size=100), device="cpu",
                                      out=out_s)
    assert got["accuracy"] == streamed["accuracy"] and got["accuracy"] > 0.8
    np.testing.assert_array_equal(out_s["predictions"], out["predictions"])
    x = MnistLoader.load(paths["test_path"], device="cpu").data.numpy()
    np.testing.assert_allclose(_port_scores(out_s["fitted"], x), _port_scores(out["fitted"], x), atol=ATOL_STREAM,
                               rtol=0)
    with pytest.raises(ValueError, match="--test-path"):
        pmn.MnistRandomFFT.run(dataclasses.replace(cfg, test_path=None, stream=True), device="cpu")


def test_mnist_csv_loader_matches_reference(tmp_path):
    path = str(tmp_path / "m.csv")
    x, labels = MnistLoader.synthetic_arrays(37, seed=3)
    write_csv(path, x, labels)
    got, want = MnistLoader.load(path, device="cpu"), jmn.MnistLoader.load(path)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data.array)[:37])
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels.array)[:37])
    np.testing.assert_array_equal(got.data.numpy(), np.rint(x))
    st, jst = MnistLoader.stream(path, batch_size=16, device="cpu"), jmn.MnistLoader.stream(path, batch_size=16)
    got_b, want_b = list(st.data.batches()), list(jst.data.batches())
    assert [b.shape for b in got_b] == [b.shape for b in want_b] == [(16, 784), (16, 784), (5, 784)]
    np.testing.assert_array_equal(np.concatenate(got_b), got.data.numpy())
    np.testing.assert_array_equal(st.labels.numpy(), labels)
    synth, jsynth = MnistLoader.synthetic(20, seed=5, device="cpu"), jmn.MnistLoader.synthetic(20, seed=5)
    np.testing.assert_array_equal(synth.data.numpy(), np.asarray(jsynth.data.array)[:20])


def test_linear_pixels_streamed_matches_in_memory():
    out, out_s = {}, {}
    got = plp.LinearPixels.run(plp.Config(synthetic_n=512, lam=1e-3), device="cpu", out=out)
    streamed = plp.LinearPixels.run(plp.Config(synthetic_n=512, lam=1e-3, stream=True, stream_batch_size=100),
                                    device="cpu", out=out_s)
    assert got["accuracy"] == streamed["accuracy"]
    np.testing.assert_array_equal(out_s["predictions"], out["predictions"])


def test_timit_from_npy_in_memory_and_streamed(tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    paths = {}
    for key, n, seed in (("features_path", 1024, 1), ("test_features_path", 256, 2)):
        x, labels = TimitFeaturesDataLoader.synthetic_arrays(n, 20, seed)
        paths[key] = str(tmp_path / f"{key}.npy")
        paths[key.replace("features", "labels")] = str(tmp_path / f"{key}_labels.npy")
        np.save(paths[key], x)
        np.save(paths[key.replace("features", "labels")], labels)
    cfg = pti.Config(**{**TIMIT, **paths})
    out, out_s = {}, {}
    got = pti.TimitPipeline.run(cfg, device="cpu", out=out)
    streamed = pti.TimitPipeline.run(dataclasses.replace(cfg, stream=True, stream_batch_size=300), device="cpu",
                                     out=out_s)
    assert got["accuracy"] == streamed["accuracy"] and got["accuracy"] > 0.5
    np.testing.assert_array_equal(out_s["predictions"], out["predictions"])
    np.testing.assert_allclose(_port_scores(out_s["fitted"], x), _port_scores(out["fitted"], x), atol=ATOL_STREAM,
                               rtol=0)
    assert not [e for e in os.listdir(tmp_path) if e.startswith("kst_spill_")]  # the solver's spill is removed


def test_voc_streamed_matches_in_memory():
    out, out_s = {}, {}
    got = pvo.VOCSIFTFisher.run(pvo.Config(**VOC), device="cpu", out=out)
    streamed = pvo.VOCSIFTFisher.run(pvo.Config(**VOC, stream=True, stream_batch_size=10), device="cpu", out=out_s)
    assert got["mean_ap"] == streamed["mean_ap"]
    np.testing.assert_allclose(out_s["scores"], out["scores"], atol=ATOL_STREAM, rtol=0)


# ------------------------------------------------------------ the VOC fixture


def test_voc_loader_on_the_fixture_matches_reference():
    d, a = FIXTURE_DIRS["images_dir"], FIXTURE_DIRS["annotations_dir"]
    paths, labels = VOCLoader.index(d, a)
    jpaths, jlabels = JVOC.index(d, a)
    assert paths == jpaths and len(paths) == 31  # the annotation without a JPEG is skipped
    np.testing.assert_array_equal(np.stack(labels), np.stack(jlabels))
    assert np.stack(labels).sum(1).min() == 1 and np.stack(labels).sum(1).max() == 2
    pixels = np.load(os.path.join(os.path.dirname(FIXTURE), "voc_decoded.npy"))
    got = VOCLoader.load(d, a, size=(48, 48), device="cpu")
    np.testing.assert_array_equal(got.data.numpy(), pixels)  # the undecodable file: a zero image
    assert not pixels[-1].any() and got.labels.numpy()[-1].sum() == 1
    idx = np.arange(3, 17)
    sub = VOCLoader.load(d, a, size=(48, 48), indices=idx[:9], device="cpu")
    jsub = JVOC.load(d, a, size=(48, 48), indices=idx, limit=9)
    np.testing.assert_array_equal(sub.data.numpy(), np.asarray(jsub.data.array)[:9])
    np.testing.assert_array_equal(sub.labels.numpy(), np.asarray(jsub.labels.array)[:9])
    st = VOCLoader.stream(d, a, size=(48, 48), batch_size=7, device="cpu")
    np.testing.assert_array_equal(np.concatenate(list(st.data.batches())), pixels)
    np.testing.assert_array_equal(st.labels.numpy(), got.labels.numpy())


def test_voc_run_on_the_fixture():
    cfg = pvo.Config(**{**VOC, **FIXTURE_DIRS})
    out, out_s = {}, {}
    got = pvo.VOCSIFTFisher.run(cfg, device="cpu", out=out)
    streamed = pvo.VOCSIFTFisher.run(dataclasses.replace(cfg, stream=True, stream_batch_size=8), device="cpu",
                                     out=out_s)
    want = jvo.VOCSIFTFisher.run(jvo.Config(**{**VOC, **FIXTURE_DIRS}))
    assert got["mean_ap"] > 0.5 and abs(got["mean_ap"] - want["mean_ap"]) <= MAP_MARGIN, (got, want)
    assert streamed["mean_ap"] == got["mean_ap"]
    np.testing.assert_allclose(out_s["scores"], out["scores"], atol=ATOL_STREAM, rtol=0)


def test_voc_synthetic_matches_reference():
    got = VOCLoader.synthetic(20, size=(32, 32), seed=3, device="cpu")
    want = JVOC.synthetic(20, size=(32, 32), seed=3)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data.array)[:20])
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels.array)[:20])
    st = VOCLoader.synthetic_stream(20, size=(32, 32), seed=3, batch_size=6, device="cpu")
    np.testing.assert_array_equal(np.concatenate(list(st.data.batches())), got.data.numpy())
    np.testing.assert_array_equal(st.labels.numpy(), got.labels.numpy())


# ------------------------------------------------------------- the rest


def test_model_path_round_trip(tmp_path):
    cfg = pmn.Config(**MNIST, model_path=str(tmp_path / "mnist.pt"))
    out, out2 = {}, {}
    first = pmn.MnistRandomFFT.run(cfg, device="cpu", out=out)
    second = pmn.MnistRandomFFT.run(cfg, device="cpu", out=out2)
    assert (first["model_loaded"], second["model_loaded"]) == (False, True)
    np.testing.assert_array_equal(out2["predictions"], out["predictions"])


def test_mains_run_on_the_cpu(capsys):
    pmn.main(["--device", "cpu", "--num-ffts", "1", "--synthetic-n", "128"])
    plp.main(["--device", "cpu", "--synthetic-n", "128", "--stream", "--stream-batch-size", "50"])
    prp.main(["--device", "cpu", "--num-filters", "16", "--synthetic-n", "64"])
    pti.main(["--device", "cpu", "--num-cosine-features", "256", "--num-classes", "4", "--synthetic-n", "256",
              "--num-epochs", "1"])
    pvo.main(["--device", "cpu", "--gmm-k", "2", "--pca-dims", "8", "--synthetic-n", "16", "--image-size", "32",
              "--stream", "--stream-batch-size", "8"])
    out = capsys.readouterr().out
    for name in ("MnistRandomFFT", "LinearPixels", "RandomPatchCifar", "TimitPipeline", "VOCSIFTFisher"):
        assert f"'pipeline': '{name}'" in out


def test_pipelines_package_exports_the_apps():
    from keystone_tpu.pipelines import ALL_PIPELINES as J_ALL
    from keystone_tpu_torch.pipelines import ALL_PIPELINES

    assert set(ALL_PIPELINES) == set(J_ALL)
    for name, app in ALL_PIPELINES.items():
        assert app.name == name and dataclasses.is_dataclass(app.Config)


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the CPU-only refusal is not observable")
    from keystone_tpu_torch.loaders.csv_loader import CsvDataLoader
    from keystone_tpu_torch.models.linear import LinearMapEstimator, LocalLeastSquaresEstimator
    from keystone_tpu_torch.models.zca import ZCAWhitenerEstimator
    from keystone_tpu_torch.ops.stats import CosineRandomFeatures, RandomSignNode

    path = str(tmp_path / "m.csv")
    write_csv(path, *MnistLoader.synthetic_arrays(4, seed=0))
    x, y = np.ones((6, 3), np.float32), np.ones((6, 2), np.float32)
    d, a = FIXTURE_DIRS["images_dir"], FIXTURE_DIRS["annotations_dir"]
    for call in (
        lambda: pmn.MnistRandomFFT.run(pmn.Config(synthetic_n=64)),
        lambda: plp.LinearPixels.run(plp.Config(synthetic_n=64)),
        lambda: prp.RandomPatchCifar.run(prp.Config(synthetic_n=64)),
        lambda: pti.TimitPipeline.run(pti.Config(synthetic_n=64)),
        lambda: pvo.VOCSIFTFisher.run(pvo.Config(synthetic_n=16)),
        lambda: MnistLoader.load(path),
        lambda: MnistLoader.stream(path),
        lambda: MnistLoader.synthetic(4),
        lambda: CsvDataLoader.load_unlabeled(path),
        lambda: VOCLoader.load(d, a, size=(8, 8)),
        lambda: VOCLoader.stream(d, a, size=(8, 8)),
        lambda: VOCLoader.synthetic(4),
        lambda: VOCLoader.synthetic_stream(4),
        lambda: CosineRandomFeatures.init(3, 4),
        lambda: RandomSignNode.init(3),
        lambda: LinearMapEstimator().fit_arrays(x, y),
        lambda: LocalLeastSquaresEstimator().fit_arrays(x, y),
        lambda: ZCAWhitenerEstimator().fit_arrays(x),
        lambda: convert.linear_mapper_from_numpy(np.ones((3, 2))),
        lambda: convert.convolver_from_numpy(np.ones((2, 3, 3, 1))),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()

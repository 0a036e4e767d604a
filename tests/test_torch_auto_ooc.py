"""The fit's pre-flight against the JAX package's, on the CPU
(tests/test_auto_ooc.py): over the device budget the port's fit converts
the image source to a stream and completes out of core with the
in-memory fit's predictions; under the same ``KEYSTONE_HBM_BUDGET_BYTES``
both packages convert the same sources, or none; with
``KEYSTONE_AUTO_SPILL=0`` both refuse with the predicted GB and the
``--stream`` pointer.

The port's fits take the reference's fitted vocabulary (its samplers'
and k-means++'s draws, which the port cannot repeat) in place of their
own PCA and GMM fits, as tests/test_torch_dense_apps.py does for VOC;
they then featurize, solve and score as the reference does.
"""

import numpy as np
import pytest
import torch

from keystone_tpu.loaders.imagenet import ImageNetLoader as JLoader
from keystone_tpu.models.pca import PCATransformer as JPca
from keystone_tpu.ops.fisher import FisherVector as JFisherVector
from keystone_tpu.pipelines.imagenet_sift_lcs_fv import ImageNetSiftLcsFV as JApp
from keystone_tpu.workflow import pipeline as jpipeline
from keystone_tpu.workflow.dataset import StreamDataset as JStreamDataset
from keystone_tpu_torch.loaders.imagenet import ImageNetLoader
from keystone_tpu_torch.models.gmm import GaussianMixtureModel
from keystone_tpu_torch.models.pca import PCAEstimator, PCATransformer
from keystone_tpu_torch.ops.fisher import FisherVector, GMMFisherVectorEstimator
from keystone_tpu_torch.pipelines.imagenet_sift_lcs_fv import BRANCH_SEED_OFFSET, SIFT_DIM, Config, ImageNetSiftLcsFV
from keystone_tpu_torch.workflow import pipeline
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset
from keystone_tpu_torch.workflow.pipeline import PipelineEnv, PreflightOOMError

# the reference test's config: 128 images at 64 px make a 1.6 MB source,
# over the 1 MiB below which no source converts
FIELDS = dict(num_classes=4, synthetic_n=128, image_size=64, gmm_k=4, pca_dims=8, descriptor_samples_per_image=8,
              gmm_iters=2, num_epochs=1, solver_block_size=64)
SIZE = (64, 64)
# the scale the reference's test shrinks the device to: the source is over
# 0.45 of it
BUDGET = 200_000
# the port's scores against the reference's on the same vocabulary and
# images: tests/test_torch_fit_slice.py's tolerance for the two packages'
# fitted scorers (each solve amplifies its own f32 rounding of the
# Gramian; |s| ~ 1), with the predicted classes equal.  Two port fits
# (in memory and spilled) are held bit for bit
ATOL_SCORES = 1e-3


@pytest.fixture(scope="module")
def reference():
    """The reference's in-memory fit: its vocabulary by branch, its
    held-out scores and the held-out images."""
    cfg = JApp.Config(**FIELDS)
    train = JLoader.synthetic(cfg.synthetic_n, cfg.num_classes, size=SIZE, seed=1)
    test = JLoader.synthetic(16, cfg.num_classes, size=SIZE, seed=2)
    scorer = JApp.build_scorer(cfg, train.data, train.labels).fit()
    vocab = {}
    g = scorer.graph
    for n, op in g.operators.items():
        fv = getattr(op, "transformer", None)
        if isinstance(fv, JFisherVector):
            pca = g.operators[g.dependencies[n][0]].transformer
            assert isinstance(pca, JPca)
            vocab["sift" if pca.components.shape[0] == SIFT_DIM else "lcs"] = (pca, fv)
    assert sorted(vocab) == ["lcs", "sift"]
    scores = np.asarray(scorer(test.data).get().array)[:16]
    return vocab, scores, np.array(test.data.array)[:16]


@pytest.fixture
def reference_vocabulary(reference, monkeypatch):
    """The port's PCA and GMM fits return the reference's fitted arrays:
    the PCA by its descriptors' width, the GMM by its branch's seed."""
    vocab = {}
    for b, (jpca, jfv) in reference[0].items():
        g = jfv.gmm
        vocab[b] = (PCATransformer(torch.from_numpy(np.array(jpca.components)), torch.from_numpy(np.array(jpca.mean))),
                    FisherVector(GaussianMixtureModel(*(torch.from_numpy(np.array(a))
                                                        for a in (g.weights, g.means, g.variances)))))
    seeds = {Config().seed + off: b for b, off in BRANCH_SEED_OFFSET.items()}
    monkeypatch.setattr(PCAEstimator, "fit_dataset",
                        lambda self, data: vocab["sift" if data.item_shape[-1] == SIFT_DIM else "lcs"][0])
    monkeypatch.setattr(GMMFisherVectorEstimator, "fit_dataset", lambda self, data: vocab[seeds[self.seed]][1])


def _port_scores(test_x):
    """The held-out class scores of the port's graph fit."""
    train = ImageNetLoader.synthetic(FIELDS["synthetic_n"], FIELDS["num_classes"], SIZE, seed=1, device="cpu")
    fitted = ImageNetSiftLcsFV.build_scorer(Config(**FIELDS), train.data, train.labels).fit()
    return fitted(Dataset(torch.from_numpy(test_x))).get().numpy()


def _spy_conversions(monkeypatch):
    """The sources each fit's pre-flight converted, as (n, item shape)."""
    converted = []
    orig = pipeline._auto_out_of_core

    def spy(g):
        out = orig(g)
        converted.extend((op.dataset.n, op.dataset.item_shape) for op in out.operators.values()
                         if isinstance(getattr(op, "dataset", None), StreamDataset))
        return out

    monkeypatch.setattr(pipeline, "_auto_out_of_core", spy)
    return converted


def test_auto_spill_completes_and_matches_in_memory(reference, reference_vocabulary, monkeypatch):
    """The in-memory fit, and the fit with the device shrunk below its
    source (which the pre-flight converts to a stream, out of core), give
    the same scores bit for bit; both match the reference's scores."""
    _, want, test_x = reference
    converted = _spy_conversions(monkeypatch)
    scores = _port_scores(test_x)
    assert converted == []
    monkeypatch.setenv("KEYSTONE_HBM_BUDGET_BYTES", str(BUDGET))
    spilled = _port_scores(test_x)
    assert converted == [(FIELDS["synthetic_n"], SIZE + (3,))]
    np.testing.assert_array_equal(spilled, scores)
    np.testing.assert_allclose(scores, want, atol=ATOL_SCORES, rtol=0)
    np.testing.assert_array_equal(scores.argmax(1), want.argmax(1))


def _converted_sources(g_out, stream_cls):
    return sorted((op.dataset.n, tuple(op.dataset.item_shape)) for op in g_out.operators.values()
                  if isinstance(getattr(op, "dataset", None), stream_cls))


@pytest.mark.parametrize("budget,fraction,converts",
                         [(BUDGET, None, True), (1 << 40, None, False), (1 << 40, "1e-9", True), (BUDGET, "1e6", False)],
                         ids=["over_budget", "within_budget", "over_a_smaller_fraction", "within_a_larger_fraction"])
def test_both_packages_convert_the_same_sources(budget, fraction, converts, monkeypatch):
    """The pre-flight of one optimized fit graph in each package, under the
    same budget and ``KEYSTONE_OOC_FRACTION`` (0.45 when unset): the same
    (n, item shape) sources become streams."""
    monkeypatch.setenv("KEYSTONE_HBM_BUDGET_BYTES", str(budget))
    if fraction is not None:
        monkeypatch.setenv("KEYSTONE_OOC_FRACTION", fraction)
    train = ImageNetLoader.synthetic(FIELDS["synthetic_n"], FIELDS["num_classes"], SIZE, seed=1, device="cpu")
    jtrain = JLoader.synthetic(FIELDS["synthetic_n"], FIELDS["num_classes"], size=SIZE, seed=1)
    g = PipelineEnv.get_optimizer().execute(ImageNetSiftLcsFV.build(Config(**FIELDS), train.data, train.labels).graph)
    got = _converted_sources(pipeline._auto_out_of_core(g), StreamDataset)
    jg = jpipeline.PipelineEnv.get_optimizer().execute(
        JApp.build(JApp.Config(**FIELDS), jtrain.data, jtrain.labels).graph)
    want = _converted_sources(jpipeline._auto_out_of_core(jg), JStreamDataset)
    assert got == want
    assert got == ([(FIELDS["synthetic_n"], SIZE + (3,))] if converts else [])


def test_auto_spill_disabled_refuses_cleanly(monkeypatch):
    monkeypatch.setenv("KEYSTONE_HBM_BUDGET_BYTES", str(BUDGET))
    monkeypatch.setenv("KEYSTONE_AUTO_SPILL", "0")
    train = ImageNetLoader.synthetic(FIELDS["synthetic_n"], FIELDS["num_classes"], SIZE, seed=1, device="cpu")
    with pytest.raises(PreflightOOMError) as ei:
        ImageNetSiftLcsFV.build(Config(**FIELDS), train.data, train.labels).fit()
    jtrain = JLoader.synthetic(FIELDS["synthetic_n"], FIELDS["num_classes"], size=SIZE, seed=1)
    with pytest.raises(jpipeline.PreflightOOMError) as jei:
        JApp.build(JApp.Config(**FIELDS), jtrain.data, jtrain.labels).fit()
    for msg in (str(ei.value), str(jei.value)):
        assert "GB" in msg and "--stream" in msg
    # the same predicted footprint, to the printed digit
    assert str(ei.value).split(" GB")[0] == str(jei.value).split(" GB")[0]


def test_small_sources_stay_resident(monkeypatch):
    """Sources under max(1 MiB, largest / 8) are never streamed, however
    small the budget: labels and constants stay on the device."""
    from keystone_tpu_torch.workflow import graph as G

    monkeypatch.setenv("KEYSTONE_HBM_BUDGET_BYTES", "1")
    g = G.Graph()
    g, big = g.add_node(G.DatasetOperator(Dataset(np.zeros((512, 1024), np.float32), device="cpu")), ())
    g, small = g.add_node(G.DatasetOperator(Dataset(np.zeros((512, 16), np.float32), device="cpu")), ())
    out = pipeline._auto_out_of_core(g)
    assert isinstance(out.operators[big].dataset, StreamDataset)
    assert not isinstance(out.operators[small].dataset, StreamDataset)
    batches = [a for a, _ in out.operators[big].dataset.device_batches()]
    assert [b.shape[0] for b in batches] == [512] and batches[0].device.type == "cpu"
    monkeypatch.setenv("KEYSTONE_SPILL_BATCH", "100")
    out = pipeline._auto_out_of_core(g)
    assert [a.shape[0] for a, _ in out.operators[big].dataset.device_batches()] == [100] * 5 + [12]

"""The port's ``ImageNetSiftLcsFV.run`` through the workflow graph against
the JAX package's ``run``, on the CPU, at the reference test's config
(tests/test_pipelines.py::test_imagenet_sift_lcs_fv_e2e), on the standard
and the augmented path; the graph fit against ``fit_params`` at the same
seeds; CenterCornerPatcher; and the blur above 512 px against the
reference's conv path.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fit_slice import FIELDS, TOP1_MARGIN

from keystone_tpu.ops.filters import separable_gaussian_blur as j_blur
from keystone_tpu.ops.images import CenterCornerPatcher as JPatcher
from keystone_tpu.pipelines.imagenet_sift_lcs_fv import ImageNetSiftLcsFV as JApp
from keystone_tpu_torch.loaders.imagenet import ImageNetLoader
from keystone_tpu_torch.models.pca import PCATransformer
from keystone_tpu_torch.ops.filters import separable_gaussian_blur
from keystone_tpu_torch.ops.fisher import FisherVector
from keystone_tpu_torch.ops.images import CenterCornerPatcher, PixelScaler
from keystone_tpu_torch.ops.lcs import LCSExtractor
from keystone_tpu_torch.ops.sift import SIFTExtractor
from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as port
from keystone_tpu_torch.pipelines.imagenet_sift_lcs_fv import Config, ImageNetSiftLcsFV

CFG = Config(**FIELDS)
SIZE = (CFG.image_size, CFG.image_size)
# the graph fit against fit_params on the same rows and draws: on the CPU
# both run the plain chains of the same stages, so PCA and GMM agree to
# f32 rounding and the held-out scores (|s| ≲ 2) to 1e-5
ATOL_VOCAB, ATOL_SCORES = 1e-5, 1e-5
# the blur against the reference's conv path: both are f32 convolutions
# of the same taps, summed in other orders
ATOL_BLUR = 1e-5


@pytest.mark.parametrize("augmented", [False, True], ids=["standard", "augmented"])
def test_run_matches_reference_run(augmented):
    got = ImageNetSiftLcsFV.run(dataclasses.replace(CFG, augmented_eval=augmented), device="cpu")
    want = JApp.run(JApp.Config(**FIELDS, augmented_eval=augmented))
    assert got["accuracy"] > 0.5, got
    assert 0.0 <= got["top5_error"] <= got["top1_error"] + 1e-9, got
    assert not got["model_loaded"]
    assert abs(got["top1_error"] - want["top1_error"]) <= TOP1_MARGIN, (got, want)


@pytest.fixture(scope="module")
def graph_and_params():
    """The graph-fitted scorer (build_scorer → Pipeline.fit) and fit_params'
    arrays, from the same training images, and the held-out images."""
    train = ImageNetLoader.synthetic(CFG.synthetic_n, CFG.num_classes, SIZE, seed=1, device="cpu")
    test = ImageNetLoader.synthetic(max(8, CFG.synthetic_n // 4), CFG.num_classes, SIZE, seed=2, device="cpu")
    fitted = ImageNetSiftLcsFV.build_scorer(CFG, train.data, train.labels).fit()
    params = port.fit_params(CFG, train.data.numpy(), train.labels.numpy(), device="cpu")
    return fitted, params, test


def _vocabulary(fitted):
    """{branch: (PCATransformer, FisherVector)} of a graph-fitted pipeline."""
    g, out = fitted.graph, {}
    for n, op in g.operators.items():
        if isinstance(getattr(op, "transformer", None), FisherVector):
            pca = g.operators[g.dependencies[n][0]].transformer
            assert isinstance(pca, PCATransformer)
            out["sift" if pca.components.shape[0] == port.SIFT_DIM else "lcs"] = (pca, op.transformer)
    return out


@pytest.mark.parametrize("branch", ["sift", "lcs"])
def test_graph_fit_vocabulary_matches_fit_params(graph_and_params, branch):
    fitted, params, _ = graph_and_params
    pca, fv = _vocabulary(fitted)[branch]
    torch.testing.assert_close(pca.components, params[f"{branch}.pca.components"], atol=ATOL_VOCAB, rtol=0)
    torch.testing.assert_close(pca.mean, params[f"{branch}.pca.mean"], atol=ATOL_VOCAB, rtol=0)
    for a in ("weights", "means", "variances"):
        torch.testing.assert_close(getattr(fv.gmm, a), params[f"{branch}.gmm.{a}"], atol=ATOL_VOCAB, rtol=0)


def test_graph_fit_scores_match_fit_params(graph_and_params):
    fitted, params, test = graph_and_params
    got = fitted(test.data).get().array
    want = port.scores_of(port.build_scorer_from_params(params, CFG, "cpu"))(test.data.array)
    assert got.shape == (test.n, CFG.num_classes)
    torch.testing.assert_close(got, want, atol=ATOL_SCORES, rtol=0)


def test_fit_featurizes_the_training_set_once(monkeypatch):
    """CSE merges the samplers' and the solver's featurizations of the
    training set (and both branches' PixelScaler): each runs once.  The
    profiled materialization pass runs the shared ones once more on its
    sample (the first 64 rows, a third of a 192-row set); its pricing at
    full batch runs them on fake tensors, which read no data and are not
    counted."""
    from torch._subclasses.fake_tensor import FakeTensor

    from keystone_tpu_torch.workflow import profiling

    n = 192
    rows = {"fit": {}, "profile": {}}
    where = ["fit"]
    for cls in (PixelScaler, SIFTExtractor, LCSExtractor):
        def counted(self, xs, mask=None, _orig=cls.apply_batch, _name=cls.__name__):
            if not isinstance(xs, FakeTensor):
                rows[where[0]][_name] = rows[where[0]].get(_name, 0) + xs.shape[0]
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
    train = ImageNetLoader.synthetic(n, CFG.num_classes, SIZE, seed=1, device="cpu")
    ImageNetSiftLcsFV.build(CFG, train.data, train.labels).fit()
    assert rows == {"fit": {"PixelScaler": n, "SIFTExtractor": n, "LCSExtractor": n},
                    "profile": {"PixelScaler": 64, "SIFTExtractor": 64, "LCSExtractor": 64}}


def test_model_path_round_trip(tmp_path):
    cfg = dataclasses.replace(CFG, model_path=str(tmp_path / "model.pt"))
    first, again = {}, {}
    a = ImageNetSiftLcsFV.run(cfg, device="cpu", out=first)
    b = ImageNetSiftLcsFV.run(cfg, device="cpu", out=again)
    assert not a["model_loaded"] and b["model_loaded"]
    np.testing.assert_array_equal(first["predictions"], again["predictions"])
    assert a["top1_error"] == b["top1_error"]
    with pytest.raises(ValueError, match="different config"):
        ImageNetSiftLcsFV.run(dataclasses.replace(cfg, lam=1e-3), device="cpu")


def test_main_runs_on_the_cpu(capsys):
    port.main(["--device", "cpu", "--num-classes", "3", "--gmm-k", "4", "--pca-dims", "8",
               "--synthetic-n", "12", "--image-size", "40"])
    assert "'pipeline': 'ImageNetSiftLcsFV'" in capsys.readouterr().out


@pytest.mark.parametrize("flips", [False, True])
@pytest.mark.parametrize("shape, patch", [((2, 48, 40, 3), (42, 35)), ((3, 17, 17), (15, 9))])
def test_center_corner_patcher_matches_reference(flips, shape, patch):
    x = np.random.default_rng(5).random(shape).astype(np.float32)
    got = CenterCornerPatcher(*patch, horizontal_flips=flips)(torch.from_numpy(x))
    want = JPatcher(*patch, horizontal_flips=flips).apply_batch(jnp.asarray(x))
    assert got.shape == want.shape == (shape[0], 10 if flips else 5, *patch, 3 if len(shape) == 4 else 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_blur_above_512_px_matches_reference_conv():
    """Above 512 px the port used to raise; it now blurs by the
    depthwise convolution, as the reference's conv path."""
    x = np.random.default_rng(6).random((2, 520, 530, 3)).astype(np.float32)
    got = separable_gaussian_blur(torch.from_numpy(x), 1.2)
    want = j_blur(jnp.asarray(x), 1.2, strategy="conv")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_BLUR)

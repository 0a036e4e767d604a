"""The dense apps' ops, solvers and helpers against the JAX package on the
CPU: the random-feature transformers (the reference's draws carried
across by ``convert``), PaddedFFT, the rectifiers, Pooler, both Convolver
forms with ``from_whitened_patches``, RandomPatcher given the reference's
offsets, Windower, ZCAWhitenerEstimator, LinearMapEstimator (in memory
and streamed, with and without an intercept), LocalLeastSquaresEstimator
and the optimizer's solver choice, and the small utils.

Tolerances, each against the reference on the same float32 inputs:
elementwise maps and gathers bit for bit; products and transforms of
O(1) values (the cosine features' phase, the FFT, the conv, the pooled
sums) within 1e-5 absolute plus 1e-5 relative, both sides summing in
their own order; the ZCA map and the least-squares weights, which go
through an eigendecomposition or a Cholesky solve, within 1e-4 absolute
plus 1e-4 relative (f32 solves of conditioned problems in two libraries);
against float64 the same limits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.models import linear as jlin
from keystone_tpu.models.zca import ZCAWhitenerEstimator as JZCA
from keystone_tpu.ops import images as jimg
from keystone_tpu.ops import stats as jstats
from keystone_tpu.utils import image as jimage
from keystone_tpu.utils import matrix as jmatrix
from keystone_tpu.utils import stats as justats
from keystone_tpu.workflow import Dataset as JDataset
from keystone_tpu.workflow import Pipeline as JPipeline
from keystone_tpu.workflow.optimizer import NodeChoiceRule as JNodeChoiceRule
from keystone_tpu_torch import convert
from keystone_tpu_torch.loaders import stream
from keystone_tpu_torch.models import linear as lin
from keystone_tpu_torch.models.zca import ZCAWhitenerEstimator
from keystone_tpu_torch.ops import images as img
from keystone_tpu_torch.ops import stats
from keystone_tpu_torch.utils import image as uimage
from keystone_tpu_torch.utils import matrix as umatrix
from keystone_tpu_torch.utils import stats as ustats
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset
from keystone_tpu_torch.workflow.optimizer import NodeChoiceRule
from keystone_tpu_torch.workflow.pipeline import Pipeline
from keystone_tpu_torch.workflow.transformer import Identity

ATOL, RTOL = 1e-5, 1e-5
ATOL_SOLVE, RTOL_SOLVE = 1e-4, 1e-4


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


# ------------------------------------------------------------- random features


@pytest.mark.parametrize("distribution", ["gaussian", "cauchy"])
def test_cosine_random_features_with_reference_draws(distribution):
    ref = jstats.CosineRandomFeatures.init(12, 40, gamma=0.3, seed=3, distribution=distribution)
    port = convert.cosine_random_features_from_numpy(np.asarray(ref.w), np.asarray(ref.b), device="cpu")
    x = _rng().normal(size=(9, 12)).astype(np.float32)
    _close(port(_t(x)).numpy(), ref.apply_batch(jnp.asarray(x)))
    assert port.params() != convert.cosine_random_features_from_numpy(np.asarray(ref.w), np.asarray(ref.b),
                                                                       device="cpu").params()


def test_cosine_random_features_own_draws():
    a = stats.CosineRandomFeatures.init(20, 4096, gamma=0.5, seed=7, device="cpu")
    b = stats.CosineRandomFeatures.init(20, 4096, gamma=0.5, seed=7, device="cpu")
    c = stats.CosineRandomFeatures.init(20, 4096, gamma=0.5, seed=8, device="cpu")
    assert torch.equal(a.w, b.w) and torch.equal(a.b, b.b) and not torch.equal(a.w, c.w)
    assert a.w.shape == (4096, 20) and a.b.shape == (4096,)
    assert abs(float(a.w.std()) - 0.5) < 0.01  # γ·N(0, 1)
    assert float(a.b.min()) >= 0.0 and float(a.b.max()) < 2 * np.pi
    cauchy = stats.CosineRandomFeatures.init(20, 4096, seed=7, distribution="cauchy", device="cpu")
    assert abs(float(cauchy.w.median())) < 0.05 and float(cauchy.w.abs().max()) > 100.0  # heavy tails
    with pytest.raises(ValueError, match="distribution"):
        stats.CosineRandomFeatures.init(2, 2, distribution="laplace", device="cpu")


def test_random_sign_node():
    ref = jstats.RandomSignNode.init(33, seed=4)
    port = convert.random_sign_node_from_numpy(np.asarray(ref.signs), device="cpu")
    x = _rng(1).normal(size=(5, 33)).astype(np.float32)
    np.testing.assert_array_equal(port(_t(x)).numpy(), np.asarray(ref.apply_batch(jnp.asarray(x))))
    own = stats.RandomSignNode.init(1000, seed=4, device="cpu")
    assert torch.equal(own.signs, stats.RandomSignNode.init(1000, seed=4, device="cpu").signs)
    assert set(own.signs.tolist()) == {-1.0, 1.0} and abs(float(own.signs.mean())) < 0.1
    with pytest.raises(ValueError, match="±1"):
        convert.random_sign_node_from_numpy(np.full(3, 0.5), device="cpu")


@pytest.mark.parametrize("width", [7, 8, 784])
def test_padded_fft(width):
    x = _rng(2).normal(size=(6, width)).astype(np.float32)
    got = stats.PaddedFFT()(_t(x)).numpy()
    want = np.asarray(jstats.PaddedFFT().apply_batch(jnp.asarray(x)))
    padded = 1 << (width - 1).bit_length()
    assert got.shape == want.shape == (6, 2 * (padded // 2 + 1))
    _close(got, want)


@pytest.mark.parametrize("max_val, alpha", [(0.0, 0.0), (0.1, 0.25), (-1.0, 0.5)])
def test_rectifiers(max_val, alpha):
    x = _rng(3).normal(size=(4, 5, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(stats.LinearRectifier(max_val, alpha)(_t(x)).numpy(),
                                  np.asarray(jstats.LinearRectifier(max_val, alpha).apply_batch(jnp.asarray(x))))
    np.testing.assert_array_equal(img.SymmetricRectifier(max_val, alpha)(_t(x)).numpy(),
                                  np.asarray(jimg.SymmetricRectifier(max_val, alpha).apply_batch(jnp.asarray(x))))


# ------------------------------------------------------------------ images


@pytest.mark.parametrize("mode", ["sum", "max"])
@pytest.mark.parametrize("shape, size, stride", [((2, 27, 27, 5), 13, 13), ((3, 10, 9, 2), 3, 2),
                                                 ((1, 7, 8, 1), 7, 1)])
@pytest.mark.parametrize("pixel_fn", [None, "square"])
def test_pooler(mode, shape, size, stride, pixel_fn):
    x = _rng(4).normal(size=shape).astype(np.float32)
    fns = {None: (None, None), "square": (lambda v: v * v, lambda v: v * v)}
    got = img.Pooler(stride, size, fns[pixel_fn][0], mode)(_t(x)).numpy()
    want = np.asarray(jimg.Pooler(stride, size, fns[pixel_fn][1], mode).apply_batch(jnp.asarray(x)))
    assert got.shape == want.shape  # VALID: a last partial window is dropped
    _close(got, want)
    with pytest.raises(ValueError, match="pool mode"):
        img.Pooler(1, 1, pool_mode="mean")


def _whitened_convolvers(seed, patch, c, k, stride):
    """The reference's Convolver from its whitened random patches, and the
    port's from the same patches and the reference's ZCA map carried across."""
    patches = _rng(seed).random((200, patch * patch * c)).astype(np.float32)
    jw = JZCA(eps=0.1).fit_arrays(patches)
    white = np.asarray(jw.apply_batch(jnp.asarray(patches[:k])))
    ref = jimg.Convolver.from_whitened_patches(jnp.asarray(white), jw, (patch, patch, c), stride=stride)
    pw = convert.zca_whitener_from_numpy(np.asarray(jw.whitener), np.asarray(jw.mean), device="cpu")
    port = img.Convolver.from_whitened_patches(_t(white), pw, (patch, patch, c), stride=stride)
    return ref, port


def _conv_f64(x, filters, offset, stride):
    out = torch.nn.functional.conv2d(torch.as_tensor(x, dtype=torch.float64).permute(0, 3, 1, 2),
                                     torch.as_tensor(filters, dtype=torch.float64).permute(0, 3, 1, 2),
                                     stride=stride).permute(0, 2, 3, 1)
    return out + torch.as_tensor(offset, dtype=torch.float64)


@pytest.mark.parametrize("h, w, patch, c, k, stride", [(32, 32, 6, 3, 16, 1), (17, 13, 5, 2, 7, 2)])
def test_convolver_forms_match_reference(h, w, patch, c, k, stride):
    ref, port = _whitened_convolvers(5, patch, c, k, stride)
    np.testing.assert_allclose(port.filters.numpy(), np.asarray(ref.filters), atol=ATOL_SOLVE, rtol=RTOL_SOLVE)
    np.testing.assert_allclose(port.offset.numpy(), np.asarray(ref.offset), atol=ATOL_SOLVE, rtol=RTOL_SOLVE)
    x = _rng(6).random((3, h, w, c)).astype(np.float32)
    # both packages' forms on the reference's own filters
    port = convert.convolver_from_numpy(np.asarray(ref.filters), np.asarray(ref.offset), stride=stride,
                                        device="cpu")
    exact = _conv_f64(x, np.asarray(ref.filters), np.asarray(ref.offset), stride).numpy()
    scale = np.abs(exact).max()
    outs = {}
    for form in ("direct", "im2col"):
        port.strategy = form
        outs[form] = port(_t(x)).numpy()
        want = np.asarray(jimg.Convolver(ref.filters, stride=stride, offset=ref.offset, strategy=form)
                          .apply_batch(jnp.asarray(x)))
        assert outs[form].shape == want.shape
        _close(outs[form], want, atol=ATOL * scale)
        _close(outs[form], exact, atol=ATOL * scale)
    _close(outs["direct"], outs["im2col"], atol=ATOL * scale)


def test_convolver_choice_and_params(monkeypatch):
    """``"auto"`` is resolved per batch, from the images' shape, to the
    form ``_pick_conv_strategy`` gives it."""
    filters = _t(_rng(6).normal(size=(4, 3, 3, 2)).astype(np.float32))
    conv = img.Convolver(filters)
    x = _t(_rng(6).random((2, 10, 10, 2)).astype(np.float32))
    for size, picked in ((10, "direct"), (400, "im2col")):
        assert img._pick_conv_strategy(size, size, (4, 3, 3, 2), 1) == picked
    # the card's measured crossover: RandomPatchCifar's 32 px direct, 128 px im2col
    assert img._pick_conv_strategy(32, 32, (256, 6, 6, 3), 1) == "direct"
    assert img._pick_conv_strategy(128, 128, (256, 6, 6, 3), 1) == "im2col"
    chosen = img.Convolver(filters, strategy="direct")
    assert torch.equal(conv(x), chosen(x))
    assert conv.params() != chosen.params()
    with pytest.raises(ValueError, match="strategy"):
        img.Convolver(torch.ones(1, 1, 1, 1), strategy="fft")
    with pytest.raises(ValueError, match="shape"):
        convert.convolver_from_numpy(np.ones((4, 3, 3, 2)), np.ones(3), device="cpu")
    monkeypatch.setattr(img, "_IM2COL_MIN_PATCH_ELEMENTS", 1)
    assert torch.equal(conv(x), img.Convolver(filters, strategy="im2col")(x))


@pytest.mark.parametrize("shape, k, ph, pw", [((5, 32, 32, 3), 10, 6, 6), ((3, 9, 11, 1), 4, 3, 5)])
def test_random_patcher_given_reference_offsets(shape, k, ph, pw):
    x = _rng(7).random(shape).astype(np.float32)
    n, h, w, _ = shape
    # the reference's draws, as its _random_patches makes them
    ky, kx = jax.random.split(jax.random.PRNGKey(11))
    ys = np.asarray(jax.random.randint(ky, (n, k), 0, h - ph + 1))
    xs = np.asarray(jax.random.randint(kx, (n, k), 0, w - pw + 1))
    patcher = img.RandomPatcher(k, ph, pw, seed=11)
    got = patcher.extract(_t(x), _t(ys), _t(xs)).numpy()
    want = np.asarray(jimg.RandomPatcher(k, ph, pw, seed=11).apply_batch(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    oy, ox = patcher.offsets(n, h, w)
    assert oy.shape == (n, k) and int(oy.max()) <= h - ph and int(ox.max()) <= w - pw and int(oy.min()) >= 0
    own = patcher.apply_dataset(Dataset(_t(x))).array
    assert own.shape == (n * k, ph * pw * shape[3])
    assert torch.equal(own, patcher.extract(_t(x), oy, ox))


@pytest.mark.parametrize("shape, step, ws", [((2, 12, 10, 3), 2, 4), ((1, 9, 9), 3, 3)])
def test_windower(shape, step, ws):
    x = _rng(8).random(shape).astype(np.float32)
    np.testing.assert_array_equal(img.Windower(step, ws)(_t(x)).numpy(),
                                  np.asarray(jimg.Windower(step, ws).apply_batch(jnp.asarray(x))))


def test_zca_whitener_estimator():
    x = (_rng(9).random((500, 27)) * np.linspace(0.5, 3.0, 27)).astype(np.float32)
    got = ZCAWhitenerEstimator(eps=0.1).fit_dataset(Dataset(_t(x)))
    want = JZCA(eps=0.1).fit_arrays(x)
    _close(got.whitener.numpy(), want.whitener, ATOL_SOLVE, RTOL_SOLVE)
    _close(got.mean.numpy(), want.mean)
    x64 = x.astype(np.float64)
    xc = x64 - x64.mean(0)
    ev, vec = np.linalg.eigh(xc.T @ xc / len(x))
    w64 = (vec / np.sqrt(np.maximum(ev, 0) + 0.1)) @ vec.T
    _close(got.whitener.numpy(), w64, ATOL_SOLVE, RTOL_SOLVE)
    _close(got(_t(x[:5])).numpy(), want.apply_batch(jnp.asarray(x[:5])), ATOL_SOLVE, RTOL_SOLVE)
    assert torch.equal(ZCAWhitenerEstimator(0.1).fit_arrays(x, device="cpu").whitener, got.whitener)


# ----------------------------------------------------------- least squares


def _ls_data(n=300, d=20, k=3, seed=10):
    r = _rng(seed)
    x = (r.normal(size=(n, d)) * 3.0 + 5.0).astype(np.float32)
    y = (x @ r.normal(size=(d, k)) + 0.1 * r.normal(size=(n, k)) + 2.0).astype(np.float32)
    return x, y


@pytest.mark.parametrize("n", [1, 4096, 10_000])
def test_blocked_gram_against_float64(n):
    """``models/common.py::gram`` over ``row_blocks``: the Gramians of row
    blocks, Kahan-summed, against float64 (f32's 1e-5 relative to the
    largest entry), uncentred and centred."""
    from keystone_tpu_torch.models.common import gram, row_blocks

    r = _rng(14)
    x, y = r.normal(size=(n, 9)).astype(np.float32) + 3.0, r.normal(size=(n, 2)).astype(np.float32)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    xx, xy, rows = gram(row_blocks(_t(x), _t(y)))
    assert rows == n
    _close(xx.numpy(), x64.T @ x64, atol=ATOL * np.abs(x64.T @ x64).max(), rtol=0)
    _close(xy.numpy(), x64.T @ y64, atol=ATOL * np.abs(x64.T @ x64).max(), rtol=0)
    assert gram(row_blocks(_t(x)))[1] is None
    xm, ym = x.mean(0), y.mean(0)
    cxx, cxy, _ = gram(row_blocks(_t(x), _t(y)), center=(_t(xm), _t(ym)))
    xc, yc = x64 - xm, y64 - ym
    _close(cxx.numpy(), xc.T @ xc, atol=ATOL * max(np.abs(xc.T @ xc).max(), 1.0), rtol=0)
    _close(cxy.numpy(), xc.T @ yc, atol=ATOL * max(np.abs(xc.T @ xc).max(), 1.0), rtol=0)
    assert gram(row_blocks(_t(x), _t(y)), center=(_t(xm), None))[1] is None


@pytest.mark.parametrize("fit_intercept", [True, False])
def test_linear_map_estimator_matches_reference(fit_intercept):
    x, y = _ls_data()
    est = lin.LinearMapEstimator(lam=1e-2, fit_intercept=fit_intercept)
    got = est.fit_arrays(x, y, device="cpu")
    want = jlin.LinearMapEstimator(lam=1e-2, fit_intercept=fit_intercept).fit_arrays(x, y)
    _close(got.weights.numpy(), want.weights, ATOL_SOLVE, RTOL_SOLVE)
    if fit_intercept:
        _close(got.intercept.numpy(), want.intercept, ATOL_SOLVE, RTOL_SOLVE)
    else:
        assert got.intercept is None
    _close(got(_t(x[:7])).numpy(), want.apply_batch(jnp.asarray(x[:7])), ATOL_SOLVE * 10, RTOL_SOLVE)
    via_graph = est.fit_dataset(Dataset(_t(x)), Dataset(_t(y)))
    assert torch.equal(via_graph.weights, got.weights)
    # in memory is fit_stream over row blocks: one batch of all rows, the same bits
    assert torch.equal(est.fit_stream([(_t(x), _t(y))]).weights, got.weights)
    # the streamed fit: Kahan-compensated batch sums, the same solution
    batches = [(x[i:i + 64], y[i:i + 64]) for i in range(0, len(x), 64)]
    streamed = est.fit_stream(lambda: ((_t(a), _t(b)) for a, b in batches))
    jstreamed = jlin.LinearMapEstimator(lam=1e-2, fit_intercept=fit_intercept).fit_stream(batches)
    _close(streamed.weights.numpy(), got.weights.numpy(), ATOL_SOLVE, RTOL_SOLVE)
    _close(streamed.weights.numpy(), jstreamed.weights, ATOL_SOLVE, RTOL_SOLVE)
    sd = StreamDataset(stream.batched(x, 50), n=len(x), device="cpu")
    from_stream = est.fit_dataset(sd, Dataset(_t(y)))
    _close(from_stream.weights.numpy(), streamed.weights.numpy(), ATOL_SOLVE, RTOL_SOLVE)


def test_linear_map_fit_stream_refuses_bad_streams():
    x, y = _ls_data(n=10)
    with pytest.raises(ValueError, match="empty"):
        lin.LinearMapEstimator().fit_stream([])
    with pytest.raises(ValueError, match="re-iterable"):
        lin.LinearMapEstimator().fit_stream(iter([(_t(x), _t(y))]))
    with pytest.raises(ValueError, match="labels"):
        lin.LinearMapEstimator().fit_dataset(Dataset(_t(x)))


@pytest.mark.parametrize("lam, fit_intercept", [(0.0, True), (0.0, False), (1e-2, True), (1e-2, False)])
def test_local_least_squares_matches_reference(lam, fit_intercept):
    x, y = _ls_data(n=120, d=8, seed=12)
    got = lin.LocalLeastSquaresEstimator(lam, fit_intercept).fit_arrays(x, y, device="cpu")
    want = jlin.LocalLeastSquaresEstimator(lam, fit_intercept).fit_arrays(x, y)
    _close(got.weights.numpy(), want.weights, ATOL_SOLVE, RTOL_SOLVE)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    if fit_intercept:
        _close(got.intercept.numpy(), want.intercept, ATOL_SOLVE * 10, RTOL_SOLVE)
        x64, y64 = x64 - x64.mean(0), y64 - y64.mean(0)
    w64 = np.linalg.solve(x64.T @ x64 + lam * len(x) * np.eye(8), x64.T @ y64)
    _close(got.weights.numpy(), w64, ATOL_SOLVE, RTOL_SOLVE)
    via_graph = lin.LocalLeastSquaresEstimator(lam, fit_intercept).fit_dataset(Dataset(_t(x)), Dataset(_t(y)))
    _close(via_graph.weights.numpy(), got.weights.numpy(), 1e-6, 1e-6)


@pytest.mark.parametrize("n, d", [(256, 64), (4096, 512), (2048, 1024), (2049, 1024)])
def test_choose_physical_picks_the_references_solver(n, d):
    """Through each package's NodeChoiceRule on a pipeline fitted on n
    rows of width d: the local solve at n·d ≤ 2²¹, the normal equations
    above."""
    x = np.zeros((n, d), np.float32)
    y = np.zeros((n, 2), np.float32)
    pipe = Pipeline.of(Identity()).and_then(lin.LinearMapEstimator(1e-3), Dataset(_t(x)), Dataset(_t(y)))
    jpipe = JPipeline.of(jimg.ImageVectorizer()).and_then(jlin.LinearMapEstimator(1e-3), JDataset(x), JDataset(y))

    def chosen(graph, est_type):
        return [type(op.estimator).__name__ for op in graph.operators.values() if hasattr(op, "estimator")]

    got = chosen(NodeChoiceRule().apply(pipe.graph), lin.LinearMapEstimator)
    want = chosen(JNodeChoiceRule().apply(jpipe.graph), jlin.LinearMapEstimator)
    assert got == want == (["LocalLeastSquaresEstimator"] if n * d <= 1 << 21 else ["LinearMapEstimator"])


def test_sparse_rows_wait_for_the_text_pipelines():
    """Scipy sparse rows take the sparse L-BFGS route, as in the reference:
    the same choice, and a fit whose weights agree with the reference's."""
    sp = pytest.importorskip("scipy.sparse")
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(24, 6)) * (rng.random((24, 6)) > 0.5)).astype(np.float32)
    y = rng.normal(size=(24, 2)).astype(np.float32)
    rows = [sp.csr_matrix(x[i:i + 1]) for i in range(24)]
    est, jest = lin.LinearMapEstimator(1e-2), jlin.LinearMapEstimator(1e-2)
    chosen, jchosen = est.choose_physical(Dataset(rows, device="cpu")), jest.choose_physical(JDataset(rows))
    assert type(chosen).__name__ == type(jchosen).__name__ == "SparseLBFGSwithL2"
    assert (chosen.lam, chosen.num_iterations, chosen.fit_intercept) == (jchosen.lam, jchosen.num_iterations,
                                                                         jchosen.fit_intercept)
    m = est.fit_dataset(Dataset(rows, device="cpu"), Dataset(torch.from_numpy(y)))
    jm = jest.fit_dataset(JDataset(rows), JDataset(y))
    scale = np.abs(np.asarray(jm.weights)).max()
    np.testing.assert_allclose(m.weights.numpy(), np.asarray(jm.weights), rtol=0, atol=1e-3 * scale)
    np.testing.assert_allclose(m.intercept.numpy(), np.asarray(jm.intercept), rtol=0, atol=1e-3 * scale)


def test_converters_reject_bad_input():
    with pytest.raises(ValueError, match="shape"):
        convert.cosine_random_features_from_numpy(np.ones((4, 3)), np.ones(5), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        convert.zca_whitener_from_numpy(np.ones((4, 3)), np.ones(4), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        convert.linear_mapper_from_numpy(np.ones((4, 3)), np.ones(4), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        convert.linear_mapper_from_numpy(np.ones(4), device="cpu")
    m = convert.linear_mapper_from_numpy(np.ones((4, 3)), np.zeros(3), device="cpu")
    assert m(torch.ones(2, 4)).tolist() == [[4.0] * 3] * 2


# ------------------------------------------------------------------- utils


def test_utils_match_reference():
    x = _rng(13).random((2, 5, 6, 3)).astype(np.float32)
    for name in ("flip_horizontal", "flip_vertical"):
        np.testing.assert_array_equal(getattr(uimage, name)(_t(x)).numpy(),
                                      np.asarray(getattr(jimage, name)(jnp.asarray(x))))
    _close(uimage.grayscale(_t(x)).numpy(), jimage.grayscale(jnp.asarray(x)))
    np.testing.assert_array_equal(uimage.crop(_t(x), 1, 2, 3, 2).numpy(), np.asarray(jimage.crop(jnp.asarray(x), 1, 2, 3, 2)))
    for got, want in zip(uimage.pixel_stats(_t(x)), jimage.pixel_stats(jnp.asarray(x))):
        _close(got.numpy(), want)
    im = uimage.image_from_array(_t(x[0, :, :, 0]))
    assert im.metadata.shape == (5, 6, 1) and im.to_vector().shape == (30,)
    np.testing.assert_array_equal(umatrix.shuffle_rows(_t(x[0, 0]), seed=3).numpy(),
                                  np.asarray(jmatrix.shuffle_rows(x[0, 0], seed=3)))
    assert umatrix.block_ranges(10, 4) == jmatrix.block_ranges(10, 4)
    assert torch.equal(umatrix.rows_to_matrix(umatrix.matrix_to_rows(_t(x[0, 0]))), _t(x[0, 0]))
    assert ustats.about_eq(x, x + 1e-9) == justats.about_eq(x, x + 1e-9) is True
    g = torch.Generator().manual_seed(0)
    for fn in (ustats.rand_matrix_gaussian, ustats.rand_matrix_uniform, ustats.rand_matrix_cauchy):
        assert fn(g, 3, 4).shape == (3, 4)

"""The ops the port had left out until now, against the JAX package on the
CPU: DAISY (``ops/daisy.py``), VectorSplitter/VectorCombiner
(``ops/util.py``) and SIFT's conv windowing (``ops/sift.py``), at the
reference's own test sizes and tolerances (``tests/test_ops.py``), and
their exports from ``keystone_tpu_torch.ops``."""

import pickle
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.ops.daisy import DaisyExtractor as JDaisy
from keystone_tpu.ops.sift import SIFTExtractor as JSIFT
from keystone_tpu.ops.sift import _dsift as j_dsift
from keystone_tpu.ops.util import VectorCombiner as JCombiner
from keystone_tpu.ops.util import VectorSplitter as JSplitter
from keystone_tpu_torch import ops
from keystone_tpu_torch.ops.daisy import DaisyExtractor
from keystone_tpu_torch.ops.sift import SIFTExtractor, _dsift
from keystone_tpu_torch.ops.util import VectorCombiner, VectorSplitter

# descriptors are L2-normalized histograms: f32 blurs and products summed
# in another order by another library
ATOL_DESC = 1e-5
# the reference's conv-against-matmul windowing tolerance (tests/test_ops.py:592)
ATOL_WINDOWING = 1e-6


@pytest.mark.parametrize("kw,shape", [
    (dict(step=8, radius=8, rings=2, ring_points=4, orientations=4), (1, 64, 64)),  # tests/test_ops.py:204
    ({}, (2, 80, 80)),  # the defaults: (1 + 3·8)·8 = 200
    (dict(step=5, radius=6, rings=3, ring_points=6, orientations=8), (3, 41, 47)),
])
def test_daisy_matches_the_reference(kw, shape):
    imgs = np.random.default_rng(8).normal(size=shape).astype(np.float32)
    want, wmask = (np.asarray(a) for a in JDaisy(**kw).apply_batch(jnp.asarray(imgs)))
    ext = DaisyExtractor(**kw)
    got, mask = ext.apply_batch(torch.from_numpy(imgs))
    assert got.shape == want.shape and got.shape[-1] == ext.descriptor_dim and got.shape[1] > 0
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_DESC, rtol=0)
    np.testing.assert_array_equal(mask.numpy(), wmask)
    norms = np.linalg.norm(got.numpy().reshape(shape[0], got.shape[1], -1, ext.orientations), axis=-1)
    assert (norms <= 1.01).all()
    one = ext.apply_one(torch.from_numpy(imgs[0]))
    np.testing.assert_allclose(one.numpy(), got[0].numpy(), atol=ATOL_DESC, rtol=0)


def test_daisy_too_small_an_image_gives_no_descriptor():
    got, mask = DaisyExtractor().apply_batch(torch.zeros(2, 30, 30, 1))
    assert tuple(got.shape) == (2, 0, 200) and tuple(mask.shape) == (2, 0)


@pytest.mark.parametrize("d,block", [(10, 4), (12, 4), (13, 1), (13, 16), (7, 7)])
def test_vector_splitter_and_combiner_match_the_reference(d, block):
    x = np.random.default_rng(d * block).normal(size=(6, d)).astype(np.float32)
    want = np.asarray(JSplitter(block).apply_batch(jnp.asarray(x)))
    blocks = VectorSplitter(block).apply_batch(torch.from_numpy(x))
    np.testing.assert_array_equal(blocks.numpy(), want)
    back = VectorCombiner().apply_batch(blocks)
    np.testing.assert_array_equal(back.numpy(), np.asarray(JCombiner().apply_batch(jnp.asarray(want))))
    np.testing.assert_array_equal(back.numpy()[:, :d], x)
    assert (back.numpy()[:, d:] == 0).all()  # zero padding, never garbage
    np.testing.assert_array_equal(VectorSplitter(block).apply_one(torch.from_numpy(x[0])).numpy(), want[0])
    np.testing.assert_array_equal(VectorCombiner().apply_one(blocks[0]).numpy(), back[0].numpy())


@pytest.mark.parametrize("hw,step,b,sigma", [(64, 4, 4, 0.0), (48, 6, 4, 0.55), (33, 5, 3, 0.0), (40, 4, 6, 0.9)])
def test_sift_conv_windowing_matches_the_reference_and_the_matmul_form(hw, step, b, sigma):
    imgs = np.random.default_rng(hw).uniform(size=(2, hw, hw)).astype(np.float32)
    for normalize in (True, False):
        want = np.asarray(j_dsift(jnp.asarray(imgs), step, b, sigma=sigma, windowing="conv", normalize=normalize))
        conv = _dsift(torch.from_numpy(imgs), step, b, sigma=sigma, windowing="conv", normalize=normalize).numpy()
        mm = _dsift(torch.from_numpy(imgs), step, b, sigma=sigma, windowing="matmul", normalize=normalize).numpy()
        assert conv.shape == want.shape == mm.shape
        np.testing.assert_allclose(conv, want, atol=ATOL_WINDOWING * max(1.0, np.abs(want).max()), rtol=0)
        np.testing.assert_allclose(mm, conv, atol=ATOL_WINDOWING * max(1.0, np.abs(want).max()), rtol=0)


def test_sift_extractor_conv_windowing_multiscale_matches_the_reference():
    imgs = np.random.default_rng(3).uniform(size=(2, 56, 56)).astype(np.float32)
    kw = dict(step=4, bin_sizes=(4, 6), smoothing_magnif=6.0, windowing="conv")
    want, _ = JSIFT(**kw).apply_batch(jnp.asarray(imgs))
    got, mask = SIFTExtractor(**kw).apply_batch(torch.from_numpy(imgs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_WINDOWING, rtol=0)
    assert tuple(mask.shape) == tuple(got.shape[:2])
    with pytest.raises(ValueError, match="windowing"):
        SIFTExtractor(windowing="fft")


def test_sift_windowing_is_a_parameter_and_old_pickles_keep_the_matmul_form():
    conv, mm = SIFTExtractor(windowing="conv"), SIFTExtractor()
    assert mm.windowing == "matmul" and conv.params() != mm.params()
    old = SIFTExtractor.__new__(SIFTExtractor)
    assert old.windowing == "matmul"  # the port's pickles before the conv form ran matmul
    back = pickle.loads(pickle.dumps(conv))
    assert back.windowing == "conv" and back.params() == conv.params()


def test_ops_exports_the_reference_names():
    import keystone_tpu.ops as jops

    for name in ("DaisyExtractor", "VectorSplitter", "VectorCombiner", "SIFTExtractor"):
        assert name in ops.__all__ and getattr(ops, name).__name__ == name
    ref = {n for n in dir(jops) if not n.startswith("_") and not isinstance(getattr(jops, n), types.ModuleType)}
    assert set(ops.__all__) == ref
    missing = [n for n in ops.__all__ if not hasattr(ops, n)]
    assert not missing
    with pytest.raises(AttributeError):
        ops.NoSuchOp

"""The port's streamed path on the card: the block store's device feed
(pinned buffers, the side copy stream, events) against ``read_block``, a
stream's batches crossing to the card, the nvJPEG decoder against the
reference's libjpeg pixels, the PCA of a rank-deficient sample, and a
small streamed fit launching the FV kernels.

Every test here needs an NVIDIA GPU and skips where torch sees none.  The
file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_stream_cuda.py --noconftest -q
"""

import os

import numpy as np
import pytest
import torch

from keystone_tpu_torch.loaders import jpeg
from keystone_tpu_torch.loaders.imagenet import ImageNetLoader
from keystone_tpu_torch.loaders.stream import batched
from keystone_tpu_torch.models.pca import PCAEstimator
from keystone_tpu_torch.ops import fisher_kernels as fk
from keystone_tpu_torch.pipelines.imagenet_sift_lcs_fv import Config, ImageNetSiftLcsFV
from keystone_tpu_torch.workflow import blockstore
from keystone_tpu_torch.workflow.blockstore import FeatureBlockStore
from keystone_tpu_torch.workflow.dataset import StreamDataset

pytestmark = pytest.mark.cuda

DATA = os.path.join(os.path.dirname(__file__), "data")
TARS = os.path.join(DATA, "imagenet_tars")
BAD = 6
# nvJPEG's pixels against libjpeg's on the fixture (chip_smoke.py states
# the same and why): its IDCT and chroma upsampling differ, by up to 10
# levels here; a wrong decode reads 27 or more
NVJPEG_MAX_DIFF = 16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device feed, nvJPEG and the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [1, 2, 3])
def test_iter_device_blocks_on_the_copy_stream_equal_read_block(dev, tmp_path, monkeypatch, dtype, window):
    """A consumer slower than the copies: every yielded block must still
    hold its own bytes (a refilled pinned buffer or a reused device block
    would show here).  ``window`` sets the blocks queued ahead."""
    monkeypatch.setattr(blockstore, "_WINDOW", window)
    x = np.random.default_rng(0).normal(size=(512, 6 * 256)).astype(np.float32)
    store = FeatureBlockStore.from_array(str(tmp_path / "s"), x, 256, dtype=dtype)
    refs = [store.read_block(b).to(dev).to(torch.float32) for b in range(store.num_blocks)]
    order = list(range(store.num_blocks)) * 3
    bad, seen = [], []
    for b, a in store.iter_device_blocks(order, dev):
        assert a.is_cuda and a.dtype == torch.float32
        torch.cuda._sleep(2_000_000)
        bad.append((a != refs[b]).sum())
        seen.append(b)
    torch.cuda.synchronize()
    assert seen == order
    assert [int(v) for v in bad] == [0] * len(order)


def test_stream_batches_cross_to_the_card(dev):
    x = np.arange(37 * 5, dtype=np.float32).reshape(37, 5)
    s = StreamDataset(batched(x, 8), n=37, prefetch=2, device=dev)
    parts = [a for a, _ in s.device_batches()]
    assert all(p.is_cuda for p in parts)
    np.testing.assert_array_equal(torch.cat(parts).cpu().numpy(), x)


def test_nvjpeg_decodes_the_fixture_near_libjpeg(dev):
    ref = torch.from_numpy(np.load(os.path.join(DATA, "imagenet_tars_decoded.npy"))).to(dev)
    jpeg.reset_launches()
    st = ImageNetLoader.stream(TARS, size=(32, 32), batch_size=5, device=dev)
    got = torch.cat([a for a, _ in st.data.device_batches()])
    assert got.is_cuda and not got[BAD].any()
    assert int((got.int() - ref.int()).abs().max()) <= NVJPEG_MAX_DIFF
    assert jpeg.LAUNCHES["nvjpeg"] == 3 and jpeg.LAUNCHES["libjpeg"] == 0
    mem = ImageNetLoader.load(TARS, size=(32, 32), device=dev)
    keep = torch.tensor([i for i in range(13) if i != BAD], device=dev)
    assert mem.data.n == 12 and torch.equal(mem.data.array, got[keep])


def test_nvjpeg_decode_behind_queued_work_on_its_stream(dev):
    """Work queued ahead on the decode's stream must not change a pixel:
    a batch decode equals each image decoded alone on an idle stream."""
    from keystone_tpu_torch.loaders.imagenet import _read_blobs

    entries = [e for i, e in enumerate(ImageNetLoader.index(TARS)) if i != BAD]
    alone = torch.cat([jpeg.decode(*_read_blobs([e]), (32, 32), dev)[0] for e in entries])
    for _ in range(5):
        torch.cuda._sleep(40_000_000)
        got, ok = jpeg.decode(*_read_blobs(entries), (32, 32), dev)
        assert ok.all() and torch.equal(got, alone)


def test_nvjpeg_resize_keeps_the_corners(dev):
    """The resize samples the decoded image's corners exactly at any size,
    whatever the decode gave."""
    entries = ImageNetLoader.index(TARS)[:4]
    from keystone_tpu_torch.loaders.imagenet import _read_blobs

    packed = _read_blobs(entries)
    same, ok = jpeg.decode(*packed, (32, 32), dev)
    big, ok2 = jpeg.decode(*packed, (63, 63), dev)
    assert ok.all() and ok2.all()
    # the corners of a bilinear resize sample the source's corners exactly
    for (y, x), (yb, xb) in (((0, 0), (0, 0)), ((31, 31), (62, 62)), ((0, 31), (0, 62))):
        assert torch.equal(same[:, y, x], big[:, yb, xb])


def test_pca_of_a_rank_deficient_sample_on_the_card(dev):
    """Flat-coloured images give repeated zero singular values, on which
    cuSOLVER's gesvda reports no convergence; the fit must still come out."""
    rng = np.random.default_rng(1)
    x = np.zeros((4096, 128), np.float32)
    x[:, :3] = rng.normal(size=(4096, 3))
    pca = PCAEstimator(16).fit_arrays(x, device=dev)
    c = pca.components
    assert c.shape == (128, 16) and bool(torch.isfinite(c).all())
    top = c[:, :3].cpu().numpy()  # spans the three live columns
    np.testing.assert_allclose(np.linalg.norm(top[:3], axis=1), 1.0, atol=1e-4)
    np.testing.assert_allclose(top[3:], 0.0, atol=1e-4)


def test_streamed_fit_on_the_card_launches_the_fv_kernels(dev):
    cfg = Config(num_classes=4, synthetic_n=48, image_size=48, gmm_k=16, pca_dims=32, num_epochs=2,
                 descriptor_samples_per_image=16, solver_block_size=512, stream=True, stream_batch_size=16)
    fk.reset_launches()
    out = ImageNetSiftLcsFV.run(cfg, dev)
    encode = fk.LAUNCHES["fisher_encode"] + fk.LAUNCHES["fisher_encode_general"]
    fused = fk.LAUNCHES["fused_forward"] + fk.LAUNCHES["fused_forward_general"]
    assert encode == 2 * 3 and fused == 2  # 3 streamed batches a branch; 12 test images, one chunk
    assert out["accuracy"] > 0.5

"""The port's out-of-core kernel tier and kernel pipelines on the card: the
row store's device feed, the out-of-core sweep and its predictions
launching B3, the disk tier rereading its columns without a launch, and
both kernel pipelines fitted in memory and streamed.

Every test here needs an NVIDIA GPU and skips where torch sees none.  The
file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_kernel_cuda.py --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from keystone_tpu_torch.loaders.stream import batched
from keystone_tpu_torch.models import kernel_ridge as kr
from keystone_tpu_torch.models.kernel_matrix import BlockKernelMatrix
from keystone_tpu_torch.ops import gram_kernels as gk
from keystone_tpu_torch.pipelines import kernel_cifar as pkc
from keystone_tpu_torch.pipelines import kernel_timit as pkt
from keystone_tpu_torch.workflow.blockstore import RowBlockStore
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset

pytestmark = pytest.mark.cuda

ATOL_ALPHA = 1e-5  # the reference's out-of-core against in-core (tests/test_kernel_oc.py:107)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the gram kernels and the device feed have no CPU mode")
    return torch.device("cuda")


def _problem(n=300, d=24, k=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.tanh(x @ rng.normal(size=(d, k)).astype(np.float32) / np.sqrt(d)).astype(np.float32)
    return x, y


def _est(epochs=2):
    return kr.KernelRidgeRegressionEstimator(kr.GaussianKernelGenerator(0.05), lam=1e-3, block_size=64,
                                             num_epochs=epochs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_store_device_feed_equals_read_block(dev, tmp_path, dtype):
    x, _ = _problem()
    st = RowBlockStore.from_array(str(tmp_path / "s"), x, 64, dtype=dtype)
    order = [0, 3, 1, 4, 2] * 2
    for b, a in st.iter_device_blocks(order, dev):
        assert a.device.type == "cuda" and a.dtype == torch.float32
        assert torch.equal(a.cpu(), st.read_block(b).to(torch.float32))


def test_oc_sweep_on_the_card(dev, tmp_path):
    x, y = _problem()
    st = RowBlockStore.from_array(str(tmp_path / "s"), x, 64)
    nb = st.num_blocks
    in_core = _est().fit_arrays(x, y, device=dev)
    gk.reset_launches()
    oc = _est().fit_store(st, Dataset(y, device=dev))
    torch.cuda.synchronize()
    assert gk.LAUNCHES == {"gram_block": 2 * nb * nb, "poly_block": 0}
    assert gk.LAUNCH_SHAPES == {("gram_block", 64, 64, 24): 2 * nb * nb}
    assert oc.alpha.device.type == "cuda"
    torch.testing.assert_close(oc.alpha, in_core.alpha, atol=ATOL_ALPHA, rtol=0)
    cpu = _est().fit_store(st, Dataset(y, device="cpu"))
    torch.testing.assert_close(oc.alpha.cpu(), cpu.alpha, atol=ATOL_ALPHA, rtol=0)
    xt = torch.from_numpy(x[:50]).to(dev)
    gk.reset_launches()
    p = oc(xt)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["gram_block"] == nb
    want = in_core(xt)
    assert 1.0 - float(((p - want) ** 2).sum() / ((want - want.mean(0)) ** 2).sum()) >= 0.999


def test_streamed_fit_and_resume_on_the_card(dev, tmp_path):
    x, y = _problem(seed=1)
    sd = StreamDataset(batched(x, 70), n=x.shape[0], device=dev)
    model = _est().fit_stream_dataset(sd, Dataset(y, device=dev), spill_dir=str(tmp_path / "spill"))
    st = RowBlockStore(model.store_directory)
    _est(1).fit_store(st, Dataset(y, device=dev), checkpoint_dir=str(tmp_path / "ck"))
    resumed = _est(2).fit_store(st, Dataset(y, device=dev), checkpoint_dir=str(tmp_path / "ck"))
    assert torch.equal(resumed.alpha, model.alpha)


@pytest.mark.parametrize("gen,kname", [(kr.GaussianKernelGenerator(0.05), "gram_block"),
                                       (kr.PolynomialKernelGenerator(2, 1 / 24, 1.0), "poly_block")])
def test_disk_tier_rereads_without_a_launch(dev, tmp_path, gen, kname):
    x = torch.from_numpy(_problem()[0]).to(dev)
    mem = BlockKernelMatrix(gen, x, 64, cache_blocks=25)
    want = [mem.column_block(j) for j in range(5)]
    km = BlockKernelMatrix(gen, x, 64, cache_blocks=0, spill_dir=str(tmp_path / "k"), hbm_cols=1)
    for epoch in range(2):
        gk.reset_launches()
        for j in range(5):
            assert torch.equal(km.column_block(j), want[j])
        torch.cuda.synchronize()
        assert gk.LAUNCHES[kname] == (5 if epoch == 0 else 0)
    assert (km.spill_writes, km.spill_reads) == (5, 5)


def test_kernel_pipelines_on_the_card(dev):
    for mod, cfg, batch in ((pkt.KernelTimitPipeline, pkt.Config(num_landmarks=96, solver_block_size=96,
                                                                  num_epochs=2, num_classes=8, synthetic_n=512), 128),
                            (pkc.KernelCifarPipeline, pkc.Config(num_landmarks=64, solver_block_size=64, num_epochs=2,
                                                                 synthetic_n=256), 100)):
        out, out_s = {}, {}
        gk.reset_launches()
        res = mod.run(cfg, dev, out=out)
        torch.cuda.synchronize()
        assert gk.LAUNCHES["gram_block"] > 0 and res["accuracy"] > 0.5
        res_s = mod.run(dataclasses.replace(cfg, stream=True, stream_batch_size=batch), dev, out=out_s)
        assert res_s["accuracy"] == res["accuracy"]
        assert np.mean(out_s["predictions"] == out["predictions"]) >= 0.99

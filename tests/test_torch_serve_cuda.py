"""The serving path on the card: a small two-branch scorer behind
``serve()`` launches B1 (the fused FV kernel) twice a flush, never B2,
and answers as the offline ``scorer(x)``.  Needs an NVIDIA GPU and skips
where torch sees none; imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_serve_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.convert import params_from_numpy
from keystone_tpu_torch.obs import metrics
from keystone_tpu_torch.ops import fisher_kernels as fk
from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as P
from keystone_tpu_torch.serve import serve
from keystone_tpu_torch.workflow.pipeline import Pipeline

pytestmark = [pytest.mark.cuda, pytest.mark.serve]

# B1's stated tolerance (chip_smoke.py): the padded flush changes the
# scoring product's batch shape, so scores need not match bit for bit
ATOL, RTOL = 2e-5, 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def test_served_scorer_launches_b1_and_matches_offline(dev):
    cfg = P.Config(sift_step=8, lcs_step=8)
    params = params_from_numpy(P.random_params(pca_dims=16, gmm_k=8, num_classes=10, block_size=64), dev)
    scorer = P.build_scorer_from_params(params, cfg, dev)
    imgs = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (20, 48, 48, 3), dtype=np.uint8)).to(dev)
    want = P.scores_of(scorer)(imgs).cpu().numpy()
    torch.cuda.synchronize()
    with serve(Pipeline.of(P.scores_of(scorer)), max_batch=16, buckets=(8, 16), max_wait_ms=2.0,
               example=imgs[0].cpu().numpy()) as svc:
        fk.reset_launches()
        b0 = metrics.REGISTRY.counter_total("serve.batches")
        got = np.stack([f.result(timeout=120) for f in svc.submit_many(imgs.cpu().numpy())])
        flushes = metrics.REGISTRY.counter_total("serve.batches") - b0
    assert fk.LAUNCHES["fused_forward"] == 2 * flushes and fk.LAUNCHES["fisher_encode"] == 0, fk.LAUNCHES
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)

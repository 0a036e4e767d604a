"""The frozen applier's bucket graphs on the card: a small two-branch
scorer's bundle installed, each of two buckets captured (B1 recorded
twice into each graph) and replayed bit for bit as the same applier's
walk, the replays counted in ``utils.graphs.REPLAYED`` and not in the
wrappers' counts, and a served flush replaying its graph.  Needs an
NVIDIA GPU and skips where torch sees none; imports neither JAX nor the
JAX package:

    python -m pytest tests/test_torch_artifacts_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.convert import params_from_numpy
from keystone_tpu_torch.obs import metrics
from keystone_tpu_torch.ops import fisher_kernels as fk
from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as P
from keystone_tpu_torch.serve import serve
from keystone_tpu_torch.utils import graphs
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.pipeline import Pipeline

pytestmark = [pytest.mark.cuda, pytest.mark.serve]

BUCKETS = (8, 16)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def _scores(dev):
    cfg = P.Config(sift_step=8, lcs_step=8)
    params = params_from_numpy(P.random_params(pca_dims=16, gmm_k=8, num_classes=10, block_size=64), dev)
    return Pipeline.of(P.scores_of(P.build_scorer_from_params(params, cfg, dev))).fit()


def test_bucket_graphs_replay_bit_for_bit(dev):
    fitted = _scores(dev)
    imgs = np.random.default_rng(4).integers(0, 256, (32, 48, 48, 3), dtype=np.uint8)
    walk = fitted.freeze(device=dev)
    ap = fitted.freeze(device=dev)
    f0 = metrics.REGISTRY.counter_total("serve.artifact_fallbacks")
    assert ap.install_artifacts(walk.export_artifacts(example=imgs[0], buckets=BUCKETS)) == len(BUCKETS)
    stream = torch.cuda.Stream()
    for b in BUCKETS:
        with torch.cuda.stream(stream):
            first = ap(Dataset(torch.from_numpy(imgs[:b]).to(dev))).array  # the capture
            fk.reset_launches()
            graphs.reset_replayed()
            for x in (imgs[:b], imgs[16:16 + b]):
                xd = torch.from_numpy(x).to(dev)
                got = ap(Dataset(xd)).array
                want = walk._walk(Dataset(xd)).array
                torch.cuda.synchronize()
                assert torch.equal(got, want), f"bucket {b}: replay != walk"
        st = ap.graph_stats()[b]
        assert st["captured"] and st["replays"] == 2 and st["launches"] == {"fused_forward": 2}
        assert graphs.REPLAYED["fused_forward"] == 4
        assert fk.LAUNCHES["fused_forward"] == 4  # the two walks only, B1 twice each
        assert torch.equal(first, walk._walk(Dataset(torch.from_numpy(imgs[:b]).to(dev))).array)
    assert metrics.REGISTRY.counter_total("serve.artifact_fallbacks") == f0


def test_served_flush_replays_its_bucket_graph(dev):
    fitted = _scores(dev)
    imgs = np.random.default_rng(5).integers(0, 256, (16, 48, 48, 3), dtype=np.uint8)
    bundle = fitted.freeze(device=dev).export_artifacts(example=imgs[0], buckets=BUCKETS)
    with serve(fitted, max_batch=16, buckets=BUCKETS, max_wait_ms=2.0, example=imgs[0], artifacts=bundle) as svc:
        ap = svc._pool.replicas[0].applier
        assert sorted(ap.graph_stats()) == list(BUCKETS)
        graphs.reset_replayed()
        got = np.stack([f.result(timeout=120) for f in svc.submit_many(list(imgs))])
        assert graphs.REPLAYED["fused_forward"] >= 2
        assert svc.status()["artifacts"]["installed_buckets"] == len(BUCKETS)
    want = fitted.freeze(device=dev)._walk(Dataset(torch.from_numpy(imgs).to(dev))).array.cpu().numpy()
    assert got.tobytes() == want.tobytes()

"""VOCSIFTFisher (counterpart of ``keystone_tpu/pipelines/voc_sift_fisher.py``;
reference pipelines/images/voc/VOCSIFTFisher.scala): PixelScaler →
GrayScaler → SIFT → PCA → GMM Fisher vectors → SignedHellinger →
NormalizeRows (ImageNetSiftLcsFV's SIFT branch, ``_fv_branch``) →
BlockWeightedLeastSquares on ±1 multilabel targets, scored by mean
average precision; fitted through the workflow graph.

On the card the fit's featurization of the training set launches B2
(the branch's FisherVector) and scoring B1 (the optimizer's
``FvFusionRule`` fuses the SIFT normalize, the PCA and the FV encode
into one node).  ``stream`` decodes the training images batch by batch
every sweep and the solver spills the Fisher vectors to a
FeatureBlockStore."""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np

from keystone_tpu_torch.evaluation.evaluators import MeanAveragePrecisionEvaluator
from keystone_tpu_torch.loaders.voc import NUM_CLASSES, VOCLoader
from keystone_tpu_torch.models.block_weighted_ls import BlockWeightedLeastSquaresEstimator
from keystone_tpu_torch.ops.images import GrayScaler, PixelScaler
from keystone_tpu_torch.ops.sift import SIFTExtractor
from keystone_tpu_torch.pipelines.imagenet_sift_lcs_fv import _fv_branch
from keystone_tpu_torch.utils import precision
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.pipeline import FittedPipeline, Pipeline, fit_relevant_config
from keystone_tpu_torch.workflow.transformer import Transformer


@dataclasses.dataclass
class Config:
    images_dir: Optional[str] = None
    annotations_dir: Optional[str] = None
    sift_step: int = 6
    sift_bin_size: int = 4
    pca_dims: int = 64
    gmm_k: int = 16
    gmm_iters: int = 10
    descriptor_samples_per_image: int = 64
    lam: float = 1e-4
    mixture_weight: float = 0.25
    solver_block_size: int = 4096
    num_epochs: int = 2
    seed: int = 0
    synthetic_n: int = 48
    image_size: int = 64
    model_path: Optional[str] = None
    # out of core: decode the training JPEGs batch by batch every sweep;
    # the Fisher vectors spill to a disk block store
    stream: bool = False
    stream_batch_size: int = 32


class MultilabelPM1(Transformer):
    """0/1 multilabels → ±1 least-squares targets."""

    def params(self):
        return ()

    def apply_batch(self, xs, mask=None):
        return xs * 2.0 - 1.0


class VOCSIFTFisher:
    name = "VOCSIFTFisher"
    Config = Config

    @staticmethod
    def build(config: Config, train_x: Dataset, train_multilabels: Dataset) -> Pipeline:
        # uint8 images reach the card and are scaled there
        sift_base = (Pipeline.of(PixelScaler(only_if_integer=True))
                     .and_then(GrayScaler())
                     .and_then(SIFTExtractor(step=config.sift_step, bin_sizes=(config.sift_bin_size,))))
        branch = _fv_branch(sift_base, config, train_x, seed=config.seed)
        return branch.and_then(
            BlockWeightedLeastSquaresEstimator(block_size=config.solver_block_size, num_iter=config.num_epochs,
                                               lam=config.lam, mixture_weight=config.mixture_weight),
            train_x, MultilabelPM1()(train_multilabels),
        )

    @staticmethod
    def run(config: Config, device="cuda", out: Optional[dict] = None) -> dict:
        """Fit (or load, with ``config.model_path``) and evaluate on
        ``device``, in f32 with TF32 off.  With ``images_dir`` and
        ``annotations_dir`` the images come from VOC's JPEGs at
        ``image_size``, split 70/30 by a permutation seeded 0 over the
        index (the training rows can then stream without decoding the
        test rows); otherwise ``synthetic_n`` synthetic training images
        (seed 1) and max(8, n // 3) test images (seed 2).  ``out``, when
        given, receives the fitted pipeline (``"fitted"``) and the test
        set's class scores (``"scores"``)."""
        dev = resolve_device(device)
        precision.disable_tf32()
        sz = (config.image_size, config.image_size)
        if config.images_dir:
            idx = VOCLoader.index(config.images_dir, config.annotations_dir)
            perm = np.random.default_rng(0).permutation(len(idx[0]))
            cut = int(len(idx[0]) * 0.7)
            test = VOCLoader.load(config.images_dir, config.annotations_dir, size=sz, indices=perm[cut:],
                                  index=idx, device=dev)

            def _train():
                if config.stream:
                    return VOCLoader.stream(config.images_dir, config.annotations_dir, size=sz,
                                            batch_size=config.stream_batch_size, indices=perm[:cut], index=idx,
                                            device=dev)
                return VOCLoader.load(config.images_dir, config.annotations_dir, size=sz, indices=perm[:cut],
                                      index=idx, device=dev)
        else:
            test = VOCLoader.synthetic(max(8, config.synthetic_n // 3), size=sz, seed=2, device=dev)

            def _train():
                if config.stream:
                    return VOCLoader.synthetic_stream(config.synthetic_n, size=sz, seed=1,
                                                      batch_size=config.stream_batch_size, device=dev)
                return VOCLoader.synthetic(config.synthetic_n, size=sz, seed=1, device=dev)

        def build():
            # loaded only when a fit is needed (a saved model skips it)
            train = _train()
            return VOCSIFTFisher.build(config, train.data, train.labels)

        t0 = time.perf_counter()
        fitted, loaded = FittedPipeline.fit_or_load(config.model_path, build, config=fit_relevant_config(config),
                                                    map_location=dev)
        fit_time = time.perf_counter() - t0
        scores = fitted(test.data).get().numpy()
        mean_ap = MeanAveragePrecisionEvaluator(NUM_CLASSES).evaluate(scores, test.labels.numpy())
        if out is not None:
            out.update(fitted=fitted, scores=scores)
        return {
            "pipeline": VOCSIFTFisher.name,
            "fit_seconds": fit_time,
            "model_loaded": loaded,
            "mean_ap": mean_ap,
        }


def main(argv=None):
    p = argparse.ArgumentParser(description=VOCSIFTFisher.name)
    p.add_argument("--images-dir")
    p.add_argument("--annotations-dir")
    p.add_argument("--gmm-k", type=int, default=16)
    p.add_argument("--pca-dims", type=int, default=64)
    p.add_argument("--synthetic-n", type=int, default=48)
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--model-path")
    p.add_argument("--stream", "--out-of-core", action="store_true", dest="stream",
                   help="decode the training JPEGs batch by batch every sweep; the Fisher vectors spill to a disk "
                        "block store instead of device memory")
    p.add_argument("--stream-batch-size", type=int, default=32)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    cfg = Config(images_dir=a.images_dir, annotations_dir=a.annotations_dir, gmm_k=a.gmm_k, pca_dims=a.pca_dims,
                 synthetic_n=a.synthetic_n, image_size=a.image_size, model_path=a.model_path, stream=a.stream,
                 stream_batch_size=a.stream_batch_size)
    print(VOCSIFTFisher.run(cfg, device=a.device))


if __name__ == "__main__":
    main()

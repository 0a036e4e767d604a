"""The bundled pipelines, built for the pre-flight analyzer (counterpart of
``keystone_tpu/analysis/bundled.py``).

``cli check <PipelineName>`` (and the analyzer's false-positive gate in
the tests) needs every pipeline of ``cli._PIPELINE_MODULES``
*constructed* (graph assembled, estimators unbound) without a fit.  Each
builder here calls the app's own ``build()`` over tiny synthetic loader
data on ``device``, with the reference's small configurations; only
RandomPatchCifar's filter learning in its ``build`` runs on the data (a
few dozen rows).

Returns ``(pipeline, example)``, where ``example`` is the training-data
Dataset: the input the shapes pass seeds the open source with.
"""

from __future__ import annotations

from typing import Tuple


def _mnist(device):
    from keystone_tpu_torch.loaders.mnist import MnistLoader
    from keystone_tpu_torch.pipelines.mnist_random_fft import Config, MnistRandomFFT

    cfg = Config(num_ffts=2, synthetic_n=128)
    train = MnistLoader.synthetic(cfg.synthetic_n, seed=1, device=device)
    return MnistRandomFFT.build(cfg, train.data, train.labels), train.data


def _linear_pixels(device):
    from keystone_tpu_torch.loaders.cifar import CifarLoader
    from keystone_tpu_torch.pipelines.linear_pixels import Config, LinearPixels

    cfg = Config(synthetic_n=128)
    train = CifarLoader.synthetic(cfg.synthetic_n, seed=1, device=device)
    return LinearPixels.build(cfg, train.data, train.labels), train.data


def _random_patch_cifar(device):
    from keystone_tpu_torch.loaders.cifar import CifarLoader
    from keystone_tpu_torch.pipelines.random_patch_cifar import Config, RandomPatchCifar

    cfg = Config(num_filters=32, patches_per_image=2, block_size=128, num_iter=1, synthetic_n=64)
    train = CifarLoader.synthetic(cfg.synthetic_n, seed=1, device=device)
    return RandomPatchCifar.build(cfg, train.data, train.labels), train.data


def _newsgroups(device):
    from keystone_tpu_torch.loaders.newsgroups import NewsgroupsDataLoader
    from keystone_tpu_torch.pipelines.newsgroups import Config, NewsgroupsPipeline

    cfg = Config(num_features=512, head="nb", num_classes=4, synthetic_n=120)
    train = NewsgroupsDataLoader.synthetic(cfg.synthetic_n, cfg.num_classes, seed=1, device=device)
    return NewsgroupsPipeline.build(cfg, train.data, train.labels), train.data


def _timit(device):
    from keystone_tpu_torch.loaders.timit import TimitFeaturesDataLoader
    from keystone_tpu_torch.pipelines.timit import Config, TimitPipeline

    cfg = Config(num_cosine_features=256, cosine_block_size=128, num_epochs=1, num_classes=8, synthetic_n=256)
    train = TimitFeaturesDataLoader.synthetic(cfg.synthetic_n, cfg.num_classes, seed=1, device=device)
    return TimitPipeline.build(cfg, train.data, train.labels), train.data


def _imagenet(device):
    from keystone_tpu_torch.loaders.imagenet import ImageNetLoader
    from keystone_tpu_torch.pipelines.imagenet_sift_lcs_fv import Config, ImageNetSiftLcsFV

    cfg = Config(num_classes=4, gmm_k=4, gmm_iters=2, pca_dims=16, descriptor_samples_per_image=16,
                 solver_block_size=256, synthetic_n=24, image_size=48, sift_step=8, lcs_step=8)
    train = ImageNetLoader.synthetic(cfg.synthetic_n, cfg.num_classes, size=(cfg.image_size, cfg.image_size), seed=1,
                                     device=device)
    return ImageNetSiftLcsFV.build(cfg, train.data, train.labels), train.data


def _voc(device):
    from keystone_tpu_torch.loaders.voc import VOCLoader
    from keystone_tpu_torch.pipelines.voc_sift_fisher import Config, VOCSIFTFisher

    cfg = Config(gmm_k=4, gmm_iters=2, pca_dims=16, descriptor_samples_per_image=16, solver_block_size=256,
                 synthetic_n=16, image_size=48, sift_step=8)
    train = VOCLoader.synthetic(cfg.synthetic_n, size=(cfg.image_size, cfg.image_size), seed=1, device=device)
    return VOCSIFTFisher.build(cfg, train.data, train.labels), train.data


def _amazon(device):
    from keystone_tpu_torch.loaders.amazon import AmazonReviewsDataLoader
    from keystone_tpu_torch.pipelines.amazon_reviews import AmazonReviewsPipeline, Config

    cfg = Config(num_features=1024, ngrams=2, num_iters=4, synthetic_n=120)
    train = AmazonReviewsDataLoader.synthetic(cfg.synthetic_n, seed=1, device=device)
    return AmazonReviewsPipeline.build(cfg, train.data, train.labels), train.data


def _kernel_timit(device):
    from keystone_tpu_torch.loaders.timit import TimitFeaturesDataLoader
    from keystone_tpu_torch.pipelines.kernel_timit import Config, KernelTimitPipeline

    cfg = Config(num_landmarks=64, solver_block_size=64, num_epochs=1, num_classes=8, synthetic_n=256)
    train = TimitFeaturesDataLoader.synthetic(cfg.synthetic_n, cfg.num_classes, seed=1, device=device)
    return KernelTimitPipeline.build(cfg, train.data, train.labels), train.data


def _kernel_cifar(device):
    from keystone_tpu_torch.loaders.cifar import CifarLoader
    from keystone_tpu_torch.pipelines.kernel_cifar import Config, KernelCifarPipeline

    cfg = Config(num_landmarks=48, solver_block_size=48, num_epochs=1, synthetic_n=96)
    train = CifarLoader.synthetic(cfg.synthetic_n, seed=1, device=device)
    return KernelCifarPipeline.build(cfg, train.data, train.labels), train.data


_BUILDERS = {
    "MnistRandomFFT": _mnist,
    "LinearPixels": _linear_pixels,
    "RandomPatchCifar": _random_patch_cifar,
    "NewsgroupsPipeline": _newsgroups,
    "TimitPipeline": _timit,
    "ImageNetSiftLcsFV": _imagenet,
    "VOCSIFTFisher": _voc,
    "AmazonReviewsPipeline": _amazon,
    "KernelTimitPipeline": _kernel_timit,
    "KernelCifarPipeline": _kernel_cifar,
}

BUNDLED = tuple(_BUILDERS)


def build_bundled(name: str, device="cuda") -> Tuple[object, object]:
    """(pipeline, example Dataset) for one bundled app, assembled over tiny
    synthetic data on ``device``: the ``cli check`` construction path."""
    from keystone_tpu_torch.utils.device import resolve_device

    try:
        builder = _BUILDERS[name]
    except KeyError:
        raise ValueError(f"unknown bundled pipeline {name!r}; known: {sorted(_BUILDERS)}") from None
    return builder(resolve_device(device))

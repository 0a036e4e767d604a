"""The apps (counterpart of ``keystone_tpu/pipelines/__init__.py``; reference
src/main/scala/pipelines/).  Each has a Config dataclass, ``build``
assembling its pipeline, ``run(config, device=...)`` returning its
metrics, and a ``main`` (``python -m keystone_tpu_torch.pipelines.<module>
--device cpu``)."""

from keystone_tpu_torch.pipelines.amazon_reviews import AmazonReviewsPipeline  # noqa: F401
from keystone_tpu_torch.pipelines.imagenet_sift_lcs_fv import ImageNetSiftLcsFV  # noqa: F401
from keystone_tpu_torch.pipelines.kernel_cifar import KernelCifarPipeline  # noqa: F401
from keystone_tpu_torch.pipelines.kernel_timit import KernelTimitPipeline  # noqa: F401
from keystone_tpu_torch.pipelines.linear_pixels import LinearPixels  # noqa: F401
from keystone_tpu_torch.pipelines.mnist_random_fft import MnistRandomFFT  # noqa: F401
from keystone_tpu_torch.pipelines.newsgroups import NewsgroupsPipeline  # noqa: F401
from keystone_tpu_torch.pipelines.random_patch_cifar import RandomPatchCifar  # noqa: F401
from keystone_tpu_torch.pipelines.timit import TimitPipeline  # noqa: F401
from keystone_tpu_torch.pipelines.voc_sift_fisher import VOCSIFTFisher  # noqa: F401

ALL_PIPELINES = {
    "MnistRandomFFT": MnistRandomFFT,
    "LinearPixels": LinearPixels,
    "RandomPatchCifar": RandomPatchCifar,
    "TimitPipeline": TimitPipeline,
    "ImageNetSiftLcsFV": ImageNetSiftLcsFV,
    "VOCSIFTFisher": VOCSIFTFisher,
    "KernelTimitPipeline": KernelTimitPipeline,
    "KernelCifarPipeline": KernelCifarPipeline,
    "NewsgroupsPipeline": NewsgroupsPipeline,
    "AmazonReviewsPipeline": AmazonReviewsPipeline,
}

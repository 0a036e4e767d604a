"""KernelTimitPipeline scoring forward (counterpart of
``keystone_tpu/pipelines/kernel_timit.py``; the fit stays in the JAX
package): MFCC frames → StandardScaler → NystromFeatureMap (the Gaussian
gram kernel against the landmarks, then the whitening product) →
BlockLinearMapper (147 classes) → MaxClassifier.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from keystone_tpu_torch.loaders import timit
from keystone_tpu_torch.models.block_ls import BlockLinearMapper
from keystone_tpu_torch.models.kernel_ridge import GaussianKernelGenerator
from keystone_tpu_torch.models.nystrom import NystromFeatureMap, NystromFeatures
from keystone_tpu_torch.ops.stats import StandardScaler, StandardScalerModel
from keystone_tpu_torch.ops.util import MaxClassifier
from keystone_tpu_torch.utils import precision
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.optimizer import FusedTransformer


@dataclasses.dataclass
class Config:
    """The reference Config (its fit and data fields kept for parity; the
    scoring forward reads ``gamma``)."""

    features_path: Optional[str] = None
    labels_path: Optional[str] = None
    test_features_path: Optional[str] = None
    test_labels_path: Optional[str] = None
    num_landmarks: int = 2048
    gamma: float = 0.015
    nystrom_reg: float = 1e-7
    num_epochs: int = 3
    lam: float = 1e-5
    solver_block_size: int = 1024
    num_classes: int = timit.NUM_CLASSES
    seed: int = 0
    synthetic_n: int = 4096
    model_path: Optional[str] = None
    stream: bool = False
    stream_batch_size: int = 8192


def build_scorer_from_params(
    params: Dict[str, torch.Tensor],
    config: Config = Config(),
    device="cuda",
    use_kernel: Optional[bool] = None,
) -> FusedTransformer:
    """The fitted scorer, ending in MaxClassifier class ids.  ``params`` as
    ``convert.kernel_timit_params_from_numpy`` returns them.
    ``use_kernel=False`` computes the Nyström gram by the plain chain in
    place of the kernel (the comparison on the card)."""
    dev = resolve_device(device)
    precision.disable_tf32()
    w = params["blm.weights"]
    scorer = FusedTransformer([
        StandardScalerModel(params["scaler.mean"], params.get("scaler.std")),
        NystromFeatureMap(GaussianKernelGenerator(config.gamma), params["nystrom.landmarks"],
                          params["nystrom.whiten"], use_kernel),
        BlockLinearMapper(w, w.shape[1], params.get("blm.intercept"), params.get("blm.feature_mean")),
        MaxClassifier(),
    ])
    return scorer.to(dev).eval()


def scores_of(scorer: FusedTransformer) -> FusedTransformer:
    """The scorer without its MaxClassifier head: raw class scores."""
    return FusedTransformer(list(scorer.stages)[:-1])


def random_params(
    config: Config = Config(),
    block_size: int = 1024,
    scaler_frames: int = 8192,
    seed: int = 0,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Seeded full-width parameters as numpy arrays under
    ``convert.kernel_timit_params_from_numpy``'s keys: the scaler's mean
    and std from ``scaler_frames`` synthetic TIMIT frames, the config's
    ``num_landmarks`` further frames (scaled) as landmarks, their whitening
    fitted by ``NystromFeatures._fit_landmarks`` on ``device`` with the
    config's reg, and 0.01·normal BLM weights (block_size columns a block),
    as ``bench.py`` makes BLM weights."""
    dev = resolve_device(device)
    frames, _ = timit.synthetic(scaler_frames + config.num_landmarks, config.num_classes, seed)
    scaler = StandardScaler().fit_arrays(frames[:scaler_frames], device=dev)
    lmk = scaler(torch.from_numpy(frames[scaler_frames:]).to(dev))
    nys = NystromFeatures(GaussianKernelGenerator(config.gamma), config.num_landmarks,
                          config.nystrom_reg)._fit_landmarks(lmk)
    nb = -(-config.num_landmarks // block_size)
    rng = np.random.default_rng(seed)
    out = {
        "scaler.mean": scaler.mean, "scaler.std": scaler.std,
        "nystrom.landmarks": lmk, "nystrom.whiten": nys.whiten,
    }
    out = {k: v.cpu().numpy() for k, v in out.items()}
    out["blm.weights"] = (0.01 * rng.normal(size=(nb, block_size, config.num_classes))).astype(np.float32)
    return out

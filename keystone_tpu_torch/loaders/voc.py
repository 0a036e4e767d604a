"""PASCAL VOC 2007 loader (counterpart of ``keystone_tpu/loaders/voc.py``;
reference loaders/VOCLoader.scala): JPEG images and multilabel
annotations over 20 classes (an image carries every class its XML
annotation names).

``index`` is the XML pass; ``load`` decodes every image into one
Dataset; ``stream`` decodes them batch by batch each sweep.  Decoding
follows the device (``loaders/jpeg.py``): libjpeg on the CPU (the
reference's pixels exactly), nvJPEG on the card, on the consumer's
thread (the producer reads the files' bytes).  A file that does not
decode becomes a zero image with its labels kept, and a warning."""

from __future__ import annotations

import logging
import os
import xml.etree.ElementTree as ET
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from keystone_tpu_torch.loaders import jpeg
from keystone_tpu_torch.loaders.imagenet import ImageNetLoader, _Packed
from keystone_tpu_torch.loaders.labeled import LabeledData
from keystone_tpu_torch.loaders.stream import PREFETCH
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset

logger = logging.getLogger(__name__)

VOC_CLASSES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]
NUM_CLASSES = len(VOC_CLASSES)


class VOCLoader:
    @staticmethod
    def index(images_dir: str, annotations_dir: str) -> Tuple[List[str], List[np.ndarray]]:
        """The XML pass: (jpg paths, multilabels) in sorted annotation
        order, for annotations whose JPEG exists.  A caller splitting the
        set passes it back to ``load``/``stream`` (``index=``), so that the
        directory is parsed once."""
        cls_index = {c: i for i, c in enumerate(VOC_CLASSES)}
        paths: List[str] = []
        labels: List[np.ndarray] = []
        for fname in sorted(os.listdir(annotations_dir)):
            if not fname.endswith(".xml"):
                continue
            jpg = os.path.join(images_dir, os.path.splitext(fname)[0] + ".jpg")
            if not os.path.exists(jpg):
                continue
            multilabel = np.zeros((NUM_CLASSES,), np.float32)
            for obj in ET.parse(os.path.join(annotations_dir, fname)).findall(".//object/name"):
                idx = cls_index.get(obj.text)
                if idx is not None:
                    multilabel[idx] = 1.0
            paths.append(jpg)
            labels.append(multilabel)
        return paths, labels

    @staticmethod
    def load(images_dir: str, annotations_dir: str, size: Tuple[int, int] = (256, 256),
             limit: Optional[int] = None, indices: Optional[Sequence[int]] = None, index=None,
             device="cuda") -> LabeledData:
        """The images (``indices`` of the index, or all of it; then the
        first ``limit`` of these), decoded and resized to ``size``:
        (n, H, W, 3) uint8 and (n, 20) 0/1 multilabels, Datasets on
        ``device``."""
        dev = resolve_device(device)
        paths, labels = _subset(images_dir, annotations_dir, indices, index)
        if limit is not None:
            paths, labels = paths[:limit], labels[:limit]
        x = _decode_paths(paths, size, dev, _read(paths))
        name = (f"voc:{os.path.abspath(images_dir)}:{os.path.abspath(annotations_dir)}:{size[0]}x{size[1]}"
                f":lim{limit}{_idx_tag(indices, len(paths))}")
        return LabeledData(Dataset(x, name=name), Dataset(_stack(labels), name=name + "-labels", device=dev))

    @staticmethod
    def stream(images_dir: str, annotations_dir: str, size: Tuple[int, int] = (256, 256), batch_size: int = 64,
               prefetch: int = PREFETCH, indices: Optional[Sequence[int]] = None, index=None,
               device="cuda") -> LabeledData:
        """Out of core: the index fixes the files and the multilabels; the
        JPEGs are reread and decoded ``batch_size`` at a time every sweep,
        read ``prefetch`` batches ahead on a producer thread."""
        dev = resolve_device(device)
        paths, labels = _subset(images_dir, annotations_dir, indices, index)
        n = len(paths)
        chunks = [paths[i:i + batch_size] for i in range(0, n, batch_size)]
        if dev.type == "cuda":
            # the producer reads bytes; nvJPEG decodes on the consumer's thread
            def batches() -> Iterator:
                for c in chunks:
                    yield _Packed(c, _read(c))

            def stage(p):
                return _decode_paths(p.entries, size, dev, p.packed)
        else:
            def batches() -> Iterator:
                for c in chunks:
                    yield _decode_paths(c, size, dev, _read(c))

            stage = None
        name = (f"voc-stream:{os.path.abspath(images_dir)}:{os.path.abspath(annotations_dir)}:{size[0]}x{size[1]}"
                f":b{batch_size}{_idx_tag(indices, n)}")
        return LabeledData(StreamDataset(batches, n, name=name, prefetch=prefetch, device=dev, stage=stage),
                           Dataset(_stack(labels), name=name + "-labels", device=dev))

    @staticmethod
    def synthetic(n: int = 48, size: Tuple[int, int] = (64, 64), seed: int = 0, device="cuda") -> LabeledData:
        """ImageNetLoader's class-structured images over the 20 classes,
        each with its class and, for 30% of them, a second one; pixel and
        label for label the reference's."""
        dev = resolve_device(device)
        pixels, single = ImageNetLoader.synthetic_arrays(n, NUM_CLASSES, size, seed)
        return LabeledData(Dataset(pixels, device=dev), Dataset(_synthetic_multilabels(single, n, seed),
                                                                name=f"voc-synth-multilabels-n{n}-s{seed}", device=dev))

    @staticmethod
    def synthetic_stream(n: int = 48, size: Tuple[int, int] = (64, 64), seed: int = 0, batch_size: int = 32,
                         prefetch: int = PREFETCH, device="cuda") -> LabeledData:
        """The streamed ``synthetic``, pixel- and label-identical to it."""
        base = ImageNetLoader.synthetic_stream(n=n, num_classes=NUM_CLASSES, size=size, seed=seed,
                                               batch_size=batch_size, prefetch=prefetch, device=device)
        multi = _synthetic_multilabels(base.labels.numpy(), n, seed)
        return LabeledData(base.data, Dataset(multi, name=f"voc-synth-stream-multilabels-n{n}-s{seed}",
                                              device=base.labels.device))


def _subset(images_dir, annotations_dir, indices, index):
    paths, labels = index if index is not None else VOCLoader.index(images_dir, annotations_dir)
    if indices is not None:
        paths = [paths[i] for i in indices]
        labels = [labels[i] for i in indices]
    return paths, labels


def _stack(labels: List[np.ndarray]) -> np.ndarray:
    return np.stack(labels) if labels else np.zeros((0, NUM_CLASSES), np.float32)


def _idx_tag(indices, n: int) -> str:
    """A subset's part of a Dataset's name (CSE and saved-state identity):
    ``hash`` of an int tuple is the same in every process."""
    if indices is None:
        return ""
    return f":idx{n}-{hash(tuple(int(i) for i in indices)) & 0xFFFFFFFF:08x}"


def _synthetic_multilabels(single: np.ndarray, n: int, seed: int) -> np.ndarray:
    """Multilabels from class ids, shared by ``synthetic`` and
    ``synthetic_stream`` so that the two agree: the class, and for 30% of
    the images a second class drawn with seed + 1."""
    multi = np.zeros((n, NUM_CLASSES), np.float32)
    multi[np.arange(n), single] = 1.0
    rng = np.random.default_rng(seed + 1)
    extra = rng.integers(0, NUM_CLASSES, size=n)
    mask = rng.random(n) < 0.3
    multi[np.arange(n)[mask], extra[mask]] = 1.0
    return multi


def _read(paths: List[str]):
    """The files' bytes, packed for ``jpeg.decode``."""
    blobs = []
    for p in paths:
        with open(p, "rb") as f:
            blobs.append(f.read())
    return jpeg.pack(blobs)


def _decode_paths(paths: List[str], size: Tuple[int, int], device, packed) -> torch.Tensor:
    """(m, H, W, 3) uint8 images on ``device``, shared by ``load`` and
    ``stream`` so that their pixels cannot drift."""
    imgs, ok = jpeg.decode(*packed, size, device)
    for j in np.flatnonzero(~ok):
        logger.warning("undecodable JPEG %s; substituting a zero image (labels kept)", paths[j])
    return imgs

"""ImageNet-style images (counterpart of ``keystone_tpu/loaders/imagenet.py``;
reference loaders/ImageNetLoader.scala, ImageLoaderUtils.scala): tar
archives of JPEGs, one synset a tar, the label from the archive's name
through a synset → label map; and class-structured synthetic images.

Two entry points mirror the reference's scaling story:

- ``load``: decode everything into one in-memory Dataset;
- ``stream``: the out-of-core path.  An index pass over the tar headers
  (Python's ``tarfile``) fixes ``n`` and the labels; then a re-iterable
  ``StreamDataset`` reads each batch's members on a producer thread and
  decodes them every time a pipeline stage sweeps the data.

Both take the reference's ``label_map`` (synset → label; by default the
synsets numbered in sorted order, an unknown synset 0) and ``limit``.
``stream(limit=L)`` keeps the index's first ``L`` members;
``load(limit=L)`` the first ``L`` members that decode, in index order,
on either decoder.  (The reference's native ``load`` path reads
``L − len(images)`` members of a tar before it decodes them and leaves
the rest of that tar when one fails, so it can skip decodable members;
its ``tarfile`` path and its docstring cut as here.)

Decoding follows the device (``loaders/jpeg.py``): on the CPU the port's
copy of the reference's libjpeg decode, on the producer thread; on the
card nvJPEG, on the consumer's thread (the producer reads bytes only),
the images landing on the card.  ``synthetic_stream`` is the streamed
twin of ``synthetic``, pixel for pixel.
"""

from __future__ import annotations

import logging
import os
import tarfile
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from keystone_tpu_torch.loaders import jpeg
from keystone_tpu_torch.loaders.labeled import LabeledData
from keystone_tpu_torch.loaders.stream import PREFETCH
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset

logger = logging.getLogger(__name__)

#: one index entry: (tar path, member data offset, member size, label)
Entry = Tuple[str, int, int, int]


def _list_tars(path: str) -> List[str]:
    if os.path.isfile(path):
        return [path]
    return [os.path.join(path, f) for f in sorted(os.listdir(path)) if f.endswith(".tar")]


def _default_label_map(tars: List[str]) -> Dict[str, int]:
    return {os.path.splitext(os.path.basename(t))[0]: i for i, t in enumerate(tars)}


def _read_blobs(entries: List[Entry]):
    """The members' bytes, packed (``jpeg.pack``), each tar opened once."""
    by_tar: Dict[str, List[int]] = {}
    for j, (t, _off, _sz, _lab) in enumerate(entries):
        by_tar.setdefault(t, []).append(j)
    blobs: List[bytes] = [b""] * len(entries)
    for t, idxs in by_tar.items():
        with open(t, "rb") as f:
            for j in idxs:
                _, off, sz, _ = entries[j]
                f.seek(off)
                blobs[j] = f.read(sz)
    return jpeg.pack(blobs)


def _decode_entry_batch(entries: List[Entry], size: Tuple[int, int], device="cuda", packed=None) -> torch.Tensor:
    """One batch of index entries → (m, H, W, 3) uint8 images on ``device``.

    An undecodable member becomes a zero image with its label kept, and a
    warning is logged: the stream must keep the rows and labels the index
    pass fixed, where ``load`` can skip the member.  ``packed``: the
    members' bytes when already read (``_read_blobs``)."""
    imgs, ok = jpeg.decode(*(packed if packed is not None else _read_blobs(entries)), size, device)
    for j in np.flatnonzero(~ok):
        logger.warning("undecodable member in %s at offset %d; substituting a zero image (label kept)",
                       entries[j][0], entries[j][1])
    return imgs


class ImageNetLoader:
    @staticmethod
    def index(path: str, label_map: Optional[Dict[str, int]] = None) -> List[Entry]:
        """A header-only pass: ``(tar, offset, size, label)`` for each file
        member, which fixes ``n`` and the labels of a stream without
        decoding a JPEG.  The label is ``label_map.get(synset, 0)``; by
        default the synsets are numbered in sorted order."""
        tars = _list_tars(path)
        if label_map is None:
            label_map = _default_label_map(tars)
        entries: List[Entry] = []
        for t in tars:
            lab = label_map.get(os.path.splitext(os.path.basename(t))[0], 0)
            with tarfile.open(t) as tf:
                entries.extend((t, m.offset_data, m.size, lab) for m in tf.getmembers() if m.isfile())
        return entries

    @staticmethod
    def stream(
        path: str,
        label_map: Optional[Dict[str, int]] = None,
        size: Tuple[int, int] = (256, 256),
        batch_size: int = 64,
        limit: Optional[int] = None,
        prefetch: int = PREFETCH,
        device="cuda",
        retries: int = 0,
    ) -> LabeledData:
        """Labels from an index pass, pixels from a re-iterable decoded
        stream on ``device``.

        Each stage that sweeps the data re-reads and re-decodes the tar
        shards: the disk is the backing tier, and the host holds
        ``prefetch + 1`` batches.  The labels stay in memory (4 bytes an
        image).  ``limit``: the index's first ``limit`` members only.
        ``retries``: per-batch retries of a failed read
        (``StreamDataset``'s resilient source)."""
        dev = resolve_device(device)
        entries = ImageNetLoader.index(path, label_map)
        if limit is not None:
            entries = entries[:limit]
        labels = np.asarray([e[3] for e in entries], np.int32)
        n = len(entries)
        chunks = [entries[i:i + batch_size] for i in range(0, n, batch_size)]
        if dev.type == "cuda":
            # the producer reads bytes; nvJPEG decodes on the consumer's thread
            def batches() -> Iterator:
                for c in chunks:
                    yield _Packed(c, _read_blobs(c))

            def stage(p):
                return _decode_entry_batch(p.entries, size, dev, p.packed)
        else:
            def batches() -> Iterator:
                for c in chunks:
                    yield _decode_entry_batch(c, size, dev)

            stage = None
        name = f"imagenet-stream:{os.path.abspath(path)}:{size[0]}x{size[1]}:lim{limit}:b{batch_size}"
        return LabeledData(
            StreamDataset(batches, n, name=name, prefetch=prefetch, device=dev, stage=stage, retries=retries),
            Dataset(labels, name=name + "-labels", device=dev),
        )

    @staticmethod
    def load(
        path: str,
        label_map: Optional[Dict[str, int]] = None,
        size: Tuple[int, int] = (256, 256),
        limit: Optional[int] = None,
        device="cuda",
    ) -> LabeledData:
        """The members of the tar file, or of the directory of per-synset
        tars, ``path``, decoded into one Dataset on ``device``; labels as
        ``index`` gives them.  Undecodable members are skipped; ``limit``
        keeps the first ``limit`` members that decode, in index order."""
        dev = resolve_device(device)
        entries = ImageNetLoader.index(path, label_map)
        images, labels = [], []
        pos = 0
        # with a limit, a round decodes as many members as are still
        # wanted; each one that fails costs another round
        while pos < len(entries) and (limit is None or len(labels) < limit):
            take = entries[pos:] if limit is None else entries[pos:pos + limit - len(labels)]
            pos += len(take)
            for t in dict.fromkeys(e[0] for e in take):  # tar by tar, in order
                ents = [e for e in take if e[0] == t]
                imgs, ok = jpeg.decode(*_read_blobs(ents), size, dev)
                keep = torch.from_numpy(np.flatnonzero(ok)).to(dev)
                images.append(imgs[keep])
                labels.extend(e[3] for e, good in zip(ents, ok) if good)
        x = torch.cat(images) if images else torch.zeros((0, *size, 3), dtype=torch.uint8, device=dev)
        name = f"imagenet:{os.path.abspath(path)}:{size[0]}x{size[1]}:lim{limit}"
        return LabeledData(
            Dataset(x, name=name),
            Dataset(np.asarray(labels, np.int32), name=name + "-labels", device=dev),
        )

    @staticmethod
    def synthetic_stream(
        n: int = 64,
        num_classes: int = 16,
        size: Tuple[int, int] = (64, 64),
        seed: int = 0,
        batch_size: int = 32,
        prefetch: int = PREFETCH,
        device="cuda",
        retries: int = 0,
    ) -> LabeledData:
        """The streamed ``synthetic``, pixel-identical to it for the same
        (n, num_classes, size, seed): each sweep replays the generator,
        making ``batch_size`` images at a time on the producer thread
        (``prefetch`` batches ahead).
        ``retries``: per-batch retries of a failed batch (a retry replays
        the generator to the batch)."""
        dev = resolve_device(device)
        labels = np.random.default_rng(seed).integers(0, num_classes, size=n).astype(np.int32)

        def batches() -> Iterator[np.ndarray]:
            rng = np.random.default_rng(seed)
            labs = rng.integers(0, num_classes, size=n)
            buf: List[np.ndarray] = []
            for i in range(n):
                buf.append(_synth_image(labs[i], num_classes, size, rng))
                if len(buf) == batch_size:
                    yield np.stack(buf)
                    buf = []
            if buf:
                yield np.stack(buf)

        name = f"imagenet-synth-stream-n{n}-c{num_classes}-{size[0]}x{size[1]}-s{seed}-b{batch_size}"
        return LabeledData(
            StreamDataset(batches, n, name=name, prefetch=prefetch, device=dev, retries=retries),
            Dataset(labels, name=name + "-labels", device=dev),
        )

    @staticmethod
    def synthetic(
        n: int = 64,
        num_classes: int = 16,
        size: Tuple[int, int] = (64, 64),
        seed: int = 0,
        device="cuda",
    ) -> LabeledData:
        """``synthetic_arrays`` as a LabeledData: (n, H, W, 3) uint8 images
        and (n,) int32 labels, Datasets on ``device``."""
        pixels, labels = ImageNetLoader.synthetic_arrays(n, num_classes, size, seed)
        return LabeledData.of(pixels, labels, resolve_device(device))

    @staticmethod
    def synthetic_arrays(
        n: int = 64,
        num_classes: int = 16,
        size: Tuple[int, int] = (64, 64),
        seed: int = 0,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(pixels (n, H, W, 3) uint8, labels (n,) int32): class-structured
        textures (oriented gratings and a colour per class), so that SIFT
        and LCS features carry the label; pixel for pixel the reference's."""
        labels, pixels = _synth_all(n, num_classes, size, seed)
        return pixels, labels.astype(np.int32)


class _Packed:
    """A batch's entries (index entries, or file paths) and their bytes,
    on their way to nvJPEG."""

    def __init__(self, entries: List[Entry], packed):
        self.entries = entries
        self.packed = packed


def _synth_image(
    c: int, num_classes: int, size: Tuple[int, int], rng: np.random.Generator
) -> np.ndarray:
    """One class-structured texture image (uint8).  Draws exactly one
    uniform (phase) then one normal block (noise) from ``rng``."""
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    angle = np.pi * c / num_classes
    freq = 0.2 + 0.05 * (c % 4)
    phase = rng.uniform(0, 2 * np.pi)
    grating = 0.5 + 0.5 * np.sin(
        freq * (np.cos(angle) * xx + np.sin(angle) * yy) + phase
    )
    color = 0.3 + 0.6 * np.array([((c >> b) & 1) for b in range(3)], np.float32)
    img = grating[..., None] * color[None, None, :]
    img += 0.05 * rng.normal(size=(h, w, 3))
    return np.rint(np.clip(img, 0, 1) * 255.0).astype(np.uint8)


def _synth_all(
    n: int, num_classes: int, size: Tuple[int, int], seed: int
) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n)
    pixels = np.stack(
        [_synth_image(labels[i], num_classes, size, rng) for i in range(n)]
    )
    return labels, pixels

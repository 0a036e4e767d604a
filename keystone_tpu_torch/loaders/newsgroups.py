"""20 Newsgroups loader (counterpart of ``keystone_tpu/loaders/newsgroups.py``;
reference loaders/NewsgroupsDataLoader.scala): a directory tree
``root/<group-name>/<doc-file>`` of plain-text posts.  The documents are a
host Dataset (or stream) whose featurized rows go to ``device``; the
labels are a Dataset on ``device``."""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from keystone_tpu_torch.loaders.labeled import LabeledData
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset

# the reference's canonical class order
NEWSGROUPS = [
    "alt.atheism", "comp.graphics", "comp.os.ms-windows.misc",
    "comp.sys.ibm.pc.hardware", "comp.sys.mac.hardware", "comp.windows.x",
    "misc.forsale", "rec.autos", "rec.motorcycles", "rec.sport.baseball",
    "rec.sport.hockey", "sci.crypt", "sci.electronics", "sci.med",
    "sci.space", "soc.religion.christian", "talk.politics.guns",
    "talk.politics.mideast", "talk.politics.misc", "talk.religion.misc",
]


def _listing(root: str, groups: Optional[Sequence[str]]):
    """(file paths, labels) in group order, each group's files sorted."""
    groups = list(groups) if groups is not None else sorted(os.listdir(root))
    paths: List[str] = []
    labels: List[int] = []
    for gi, g in enumerate(groups):
        gdir = os.path.join(root, g)
        if not os.path.isdir(gdir):
            continue
        for fname in sorted(os.listdir(gdir)):
            paths.append(os.path.join(gdir, fname))
            labels.append(gi)
    return paths, labels


class NewsgroupsDataLoader:
    @staticmethod
    def load(root: str, groups: Optional[Sequence[str]] = None, device="cuda") -> LabeledData:
        """Every document in memory; ``groups`` fixes the group → label map
        (default: the sorted entries of ``root``)."""
        dev = resolve_device(device)
        texts: List[str] = []
        labels: List[int] = []
        for p, lab in zip(*_listing(root, groups)):
            try:
                with open(p, "r", errors="replace") as f:
                    texts.append(f.read())
                labels.append(lab)
            except OSError:
                continue
        name = f"newsgroups:{os.path.abspath(root)}"
        return LabeledData(Dataset(texts, name=name, device=dev),
                           Dataset(np.asarray(labels, np.int32), name=name + "-labels", device=dev))

    @staticmethod
    def stream(root: str, groups: Optional[Sequence[str]] = None, batch_size: int = 512, prefetch: int = 2,
               device="cuda") -> LabeledData:
        """Out of core: one directory walk fixes the files and labels; the
        texts are re-read in ``batch_size`` chunks every sweep through a
        host StreamDataset (an unreadable file an empty document, so that
        rows and labels stay aligned)."""
        dev = resolve_device(device)
        paths, labels = _listing(root, groups)

        def batches():
            for i in range(0, len(paths), batch_size):
                chunk = []
                for p in paths[i:i + batch_size]:
                    try:
                        with open(p, "r", errors="replace") as f:
                            chunk.append(f.read())
                    except OSError:
                        chunk.append("")
                yield chunk

        name = f"newsgroups-stream:{os.path.abspath(root)}:b{batch_size}"
        return LabeledData(StreamDataset(batches, len(paths), name=name, prefetch=prefetch, host=True, device=dev),
                           Dataset(np.asarray(labels, np.int32), name=name + "-labels", device=dev))

    @staticmethod
    def synthetic(n: int = 400, num_classes: int = 4, seed: int = 0, device="cuda") -> LabeledData:
        """Topic vocabularies mixed with shared words, the reference's draws."""
        dev = resolve_device(device)
        texts, labels = synthetic_texts(n, num_classes, seed)
        name = f"newsgroups-synth-n{n}-c{num_classes}-s{seed}"
        return LabeledData(Dataset(texts, name=name, device=dev),
                           Dataset(np.asarray(labels, np.int32), name=name + "-labels", device=dev))


def synthetic_texts(n: int, num_classes: int, seed: int):
    """(texts, labels): each document 10-29 words of its class's 30 topic
    words and 10-29 of 50 shared words, shuffled (the reference's draws,
    document for document)."""
    rng = np.random.default_rng(seed)
    shared = [f"word{i}" for i in range(50)]
    topics = [[f"topic{c}term{i}" for i in range(30)] for c in range(num_classes)]
    texts, labels = [], []
    for _ in range(n):
        c = int(rng.integers(0, num_classes))
        k_topic = int(rng.integers(10, 30))
        k_shared = int(rng.integers(10, 30))
        words = list(rng.choice(topics[c], size=k_topic)) + list(rng.choice(shared, size=k_shared))
        rng.shuffle(words)
        texts.append(" ".join(words))
        labels.append(c)
    return texts, labels


def write_tree(root: str, texts: Sequence[str], labels: Sequence[int], groups: Sequence[str]) -> None:
    """Write documents as the ``root/<group>/<doc>`` tree ``load`` and
    ``stream`` read: document i of label c as ``groups[c]/<i:07d>``."""
    for g in groups:
        os.makedirs(os.path.join(root, g), exist_ok=True)
    for i, (t, c) in enumerate(zip(texts, labels)):
        with open(os.path.join(root, groups[int(c)], f"{i:07d}"), "w") as f:
            f.write(t)

"""Amazon reviews loader (counterpart of ``keystone_tpu/loaders/amazon.py``;
reference loaders/AmazonReviewsDataLoader.scala): JSON-lines reviews, the
text under ``reviewText`` (or ``text``), the binary label rating >
``threshold`` from ``overall`` (or ``rating``).  The reviews are a host
Dataset (or stream) whose featurized rows go to ``device``."""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np

from keystone_tpu_torch.loaders.labeled import LabeledData
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset


def _records(path: str):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def _text(rec) -> str:
    return rec.get("reviewText", rec.get("text", ""))


def _label(rec, threshold: float) -> int:
    return 1 if float(rec.get("overall", rec.get("rating", 0.0))) > threshold else 0


class AmazonReviewsDataLoader:
    @staticmethod
    def load(path: str, threshold: float = 3.5, device="cuda") -> LabeledData:
        dev = resolve_device(device)
        texts, labels = [], []
        for rec in _records(path):
            texts.append(_text(rec))
            labels.append(_label(rec, threshold))
        name = f"amazon:{os.path.abspath(path)}:t{threshold}"
        return LabeledData(Dataset(texts, name=name, device=dev),
                           Dataset(np.asarray(labels, np.int32), name=name + "-labels", device=dev))

    @staticmethod
    def stream(path: str, threshold: float = 3.5, batch_size: int = 1024, prefetch: int = 2,
               device="cuda") -> LabeledData:
        """Out of core: one pass reads the ratings (the labels); the texts
        are re-parsed in ``batch_size`` chunks every sweep through a host
        StreamDataset."""
        dev = resolve_device(device)
        labels = [_label(rec, threshold) for rec in _records(path)]

        def batches():
            chunk = []
            for rec in _records(path):
                chunk.append(_text(rec))
                if len(chunk) == batch_size:
                    yield chunk
                    chunk = []
            if chunk:
                yield chunk

        name = f"amazon-stream:{os.path.abspath(path)}:t{threshold}:b{batch_size}"
        return LabeledData(StreamDataset(batches, len(labels), name=name, prefetch=prefetch, host=True, device=dev),
                           Dataset(np.asarray(labels, np.int32), name=name + "-labels", device=dev))

    @staticmethod
    def synthetic(n: int = 600, seed: int = 0, device="cuda") -> LabeledData:
        dev = resolve_device(device)
        texts, labels = synthetic_reviews(n, seed)
        name = f"amazon-synth-n{n}-s{seed}"
        return LabeledData(Dataset(texts, name=name, device=dev),
                           Dataset(np.asarray(labels, np.int32), name=name + "-labels", device=dev))


def synthetic_reviews(n: int, seed: int):
    """(texts, labels): 3-7 sentiment words of the review's class among
    10-24 of 40 neutral fillers, shuffled (the reference's draws, review
    for review)."""
    rng = np.random.default_rng(seed)
    pos = ["great", "excellent", "love", "perfect", "amazing", "best"]
    neg = ["terrible", "broken", "waste", "awful", "disappointed", "worst"]
    neutral = [f"filler{i}" for i in range(40)]
    texts, labels = [], []
    for _ in range(n):
        lab = int(rng.integers(0, 2))
        words = list(rng.choice(pos if lab else neg, size=int(rng.integers(3, 8)))) + list(
            rng.choice(neutral, size=int(rng.integers(10, 25))))
        rng.shuffle(words)
        texts.append(" ".join(words))
        labels.append(lab)
    return texts, labels


def write_jsonl(path: str, texts: Sequence[str], labels: Sequence[int]) -> None:
    """Write reviews as the JSON lines ``load`` and ``stream`` read: label
    1 as rating 5.0, label 0 as 1.0."""
    with open(path, "w") as f:
        for t, lab in zip(texts, labels):
            f.write(json.dumps({"reviewText": t, "overall": 5.0 if lab else 1.0}) + "\n")

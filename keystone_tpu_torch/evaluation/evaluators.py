"""Evaluators (counterpart of ``keystone_tpu/evaluation/evaluators.py``).

Metric math on the host in numpy: predictions and labels are small next
to the features, and the confusion matrix is one ``np.add.at`` (the
reference forms it by a one-hot product on its device).  Predictions
and labels may be numpy arrays or tensors on any device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class MulticlassMetrics:
    """evaluation/MulticlassClassifierEvaluator.scala § MulticlassMetrics."""

    confusion_matrix: np.ndarray  # (K, K) rows = actual, cols = predicted
    total_error: float
    per_class_error: np.ndarray
    macro_precision: float
    macro_recall: float
    macro_f1: float
    micro_f1: float

    @property
    def accuracy(self) -> float:
        return 1.0 - self.total_error

    def summary(self) -> str:
        return (
            f"accuracy: {self.accuracy:.4f}\n"
            f"total error: {self.total_error:.4f}\n"
            f"macro F1: {self.macro_f1:.4f}  micro F1: {self.micro_f1:.4f}"
        )


class MulticlassClassifierEvaluator:
    """Confusion matrix, total/per-class error, micro/macro F1
    (evaluation/MulticlassClassifierEvaluator.scala)."""

    def __init__(self, num_classes: int):
        self.num_classes = int(num_classes)

    def evaluate(self, predictions, labels) -> MulticlassMetrics:
        pred = _as_int_array(predictions)
        lab = _as_int_array(labels)
        n = min(pred.shape[0], lab.shape[0])
        return _metrics_from_confusion(_confusion(pred[:n], lab[:n], self.num_classes))


def _metrics_from_confusion(cm: np.ndarray) -> MulticlassMetrics:
    cm = np.asarray(cm, np.int64)
    total = cm.sum()
    correct = np.trace(cm)
    class_counts = cm.sum(axis=1)  # actual
    pred_counts = cm.sum(axis=0)
    tp = np.diag(cm).astype(np.float64)
    per_class_error = np.where(
        class_counts > 0, 1.0 - tp / np.maximum(class_counts, 1), 0.0
    )
    prec = np.where(pred_counts > 0, tp / np.maximum(pred_counts, 1), 0.0)
    rec = np.where(class_counts > 0, tp / np.maximum(class_counts, 1), 0.0)
    f1 = np.where(prec + rec > 0, 2 * prec * rec / np.maximum(prec + rec, 1e-12), 0.0)
    micro_p = correct / max(total, 1)
    return MulticlassMetrics(
        confusion_matrix=cm,
        total_error=float(1.0 - correct / max(total, 1)),
        per_class_error=per_class_error,
        macro_precision=float(prec.mean()),
        macro_recall=float(rec.mean()),
        macro_f1=float(f1.mean()),
        micro_f1=float(micro_p),  # micro P=R=F1=accuracy for single-label
    )


def _confusion(pred, lab, k) -> np.ndarray:
    """(k, k) counts, rows the actual class, columns the predicted one; a
    class outside [0, k) is counted nowhere, as a one-hot of it is zero."""
    cm = np.zeros((k, k), np.int64)
    ok = (pred >= 0) & (pred < k) & (lab >= 0) & (lab < k)
    np.add.at(cm, (lab[ok], pred[ok]), 1)
    return cm


@dataclasses.dataclass
class BinaryClassificationMetrics:
    """evaluation/BinaryClassifierEvaluator.scala."""

    tp: int
    fp: int
    tn: int
    fn: int

    @property
    def accuracy(self):
        t = self.tp + self.fp + self.tn + self.fn
        return (self.tp + self.tn) / max(t, 1)

    @property
    def precision(self):
        return self.tp / max(self.tp + self.fp, 1)

    @property
    def recall(self):
        return self.tp / max(self.tp + self.fn, 1)

    @property
    def f1(self):
        p, r = self.precision, self.recall
        return 2 * p * r / max(p + r, 1e-12)


class BinaryClassifierEvaluator:
    def evaluate(self, predictions, labels) -> BinaryClassificationMetrics:
        pred = _as_int_array(predictions) > 0
        lab = _as_int_array(labels) > 0
        n = min(pred.shape[0], lab.shape[0])
        pred, lab = pred[:n], lab[:n]
        return BinaryClassificationMetrics(
            tp=int(np.sum(pred & lab)),
            fp=int(np.sum(pred & ~lab)),
            tn=int(np.sum(~pred & ~lab)),
            fn=int(np.sum(~pred & lab)),
        )


class MeanAveragePrecisionEvaluator:
    """VOC-style mean average precision over per-class rankings
    (evaluation/MeanAveragePrecisionEvaluator.scala): AP computed with the
    11-point-free 'every positive rank' averaging the reference uses."""

    def __init__(self, num_classes: int):
        self.num_classes = int(num_classes)

    def evaluate(self, scores, multilabels) -> float:
        """scores: (n, K) class scores; multilabels: (n, K) 0/1."""
        s = np.asarray(_maybe_numpy(scores), np.float64)
        y = np.asarray(_maybe_numpy(multilabels)) > 0
        n = min(s.shape[0], y.shape[0])
        s, y = s[:n], y[:n]
        aps = []
        for c in range(self.num_classes):
            order = np.argsort(-s[:, c], kind="stable")
            rel = y[order, c]
            if rel.sum() == 0:
                continue
            ranks = np.arange(1, n + 1)
            cum = np.cumsum(rel)
            precision_at = cum / ranks
            aps.append((precision_at * rel).sum() / rel.sum())
        return float(np.mean(aps)) if aps else 0.0


class AugmentedExamplesEvaluator:
    """Averages prediction scores across augmented views of each image id
    before scoring (evaluation/AugmentedExamplesEvaluator.scala — the
    ImageNet 10-view eval)."""

    def __init__(self, num_classes: int):
        self.num_classes = int(num_classes)

    @staticmethod
    def averaged_scores(scores, image_ids) -> tuple:
        """Mean score per image id.  Returns ``(agg, first_idx)`` where
        ``agg`` rows follow np.unique's sorted id order and ``first_idx``
        is each unique id's first view index (for label realignment).
        The single source of the view-aggregation logic — ``evaluate``
        and top-k consumers both derive from it."""
        s = np.asarray(_maybe_numpy(scores), np.float64)
        ids = np.asarray(_maybe_numpy(image_ids))
        uniq, first_idx, inverse = np.unique(
            ids, return_index=True, return_inverse=True
        )
        agg = np.zeros((uniq.shape[0], s.shape[1]))
        np.add.at(agg, inverse, s)
        counts = np.bincount(inverse, minlength=uniq.shape[0])[:, None]
        return agg / np.maximum(counts, 1), first_idx

    def evaluate(self, scores, image_ids, labels) -> MulticlassMetrics:
        """scores: (n_views_total, K); image_ids: (n_views_total,) group
        key per view; labels: per-image true class keyed by first
        occurrence order of image_ids."""
        labs = _as_int_array(labels)
        agg, first_idx = self.averaged_scores(scores, image_ids)
        pred = agg.argmax(axis=1)
        if labs.shape[0] == agg.shape[0]:
            # labs are per-image in FIRST-OCCURRENCE order; np.unique's uniq
            # is sorted — realign by each unique id's occurrence rank
            occ_order = np.argsort(first_idx)
            lab_per_img = np.empty_like(labs)
            lab_per_img[occ_order] = labs
        else:
            # labs are per-view: take each image's first view's label
            lab_per_img = labs[first_idx]
        return _metrics_from_confusion(_confusion(pred, lab_per_img, self.num_classes))


def _maybe_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _as_int_array(x) -> np.ndarray:
    arr = np.asarray(_maybe_numpy(x))
    if arr.ndim > 1:
        arr = arr.argmax(axis=-1) if arr.shape[-1] > 1 else arr.ravel()
    return arr.astype(np.int64)

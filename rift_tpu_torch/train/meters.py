"""Meters, copies of `rift_tpu/train/meters.py`: `MeterClassification`
(accuracy), `MeterRegistration` (per-pair registration errors and solver
time) and `MeterShapeNetIoU` (part segmentation's instance mIoU)."""
from __future__ import annotations

import numpy as np


class MeterClassification:
    """Accuracy over every `update(logits, labels)` since construction."""

    def __init__(self):
        self.correct = 0
        self.total = 0

    def update(self, logits: np.ndarray, labels: np.ndarray) -> None:
        pred = np.argmax(np.asarray(logits), axis=-1)
        self.correct += int((pred == np.asarray(labels)).sum())
        self.total += len(labels)

    def compute(self) -> float:
        return self.correct / max(self.total, 1)


class MeterRegistration:
    """Means over pairs of the per-pair metric dicts of
    `registration.pair_errors` (numpy arrays), and of the solver's wall
    time (`reg_time`, the total a batch's pairs took)."""

    def __init__(self):
        self.sums = {"rre": 0.0, "rte": 0.0, "rmse": 0.0, "succ": 0.0,
                     "rmse_succ": 0.0, "reg_time": 0.0}
        self.num = 0

    def update(self, errors: dict, reg_time: float = 0.0) -> None:
        batch = np.asarray(errors["rre"]).shape[0] if np.ndim(errors["rre"]) else 1
        for key in ("rre", "rte", "rmse", "succ", "rmse_succ"):
            self.sums[key] += float(np.sum(np.asarray(errors[key])))
        self.sums["reg_time"] += reg_time
        self.num += batch

    def compute(self) -> dict:
        n = max(self.num, 1)
        return {k: v / n for k, v in self.sums.items()}


class MeterShapeNetIoU:
    """Mean over instances of each instance's mean part IoU, over the
    union of the parts in its prediction and in its ground truth (an empty
    union counts 1.0); the reference's loop, so its sums are the same."""

    def __init__(self, num_classes: int = 50):
        self.num_classes = num_classes
        self.iou_sum = 0.0
        self.num = 0

    def update(self, logits: np.ndarray, labels: np.ndarray) -> None:
        pred = np.argmax(np.asarray(logits), axis=-1)  # [b, n]
        labels = np.asarray(labels)
        for i in range(pred.shape[0]):
            parts = np.union1d(np.unique(pred[i]), np.unique(labels[i]))
            ious = []
            for part in parts:
                inter = np.sum((pred[i] == part) & (labels[i] == part))
                union = np.sum((pred[i] == part) | (labels[i] == part))
                ious.append(inter / union if union else 1.0)
            self.iou_sum += float(np.mean(ious))
            self.num += 1

    def compute(self) -> float:
        return self.iou_sum / max(self.num, 1)

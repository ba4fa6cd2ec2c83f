"""Meters, copies of `rift_tpu/train/meters.py`: `MeterClassification`
(accuracy), `MeterRegistration` (per-pair registration errors and solver
time), `MeterRPMNet` (the RPM-Net family of `registration.rpmnet_metrics`),
`MeterReflection` (the 4-way reflection head's accuracy) and
`MeterShapeNetIoU` (part segmentation's instance mIoU). `MeterRPMNet`
takes tensors on any device as well as numpy arrays."""
from __future__ import annotations

import numpy as np
import torch


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


def _numpy(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class MeterRPMNet:
    """Means over pairs of `registration.rpmnet_metrics`' dicts; r_mse and
    t_mse are reported as their square roots (RMSE), the rest as means."""

    KEYS = ("r_mse", "r_mae", "t_mse", "t_mae", "err_r_deg", "err_t", "chamfer")

    def __init__(self):
        self.sums = {k: 0.0 for k in self.KEYS}
        self.num = 0

    def update(self, metrics: dict) -> None:
        first = _numpy(metrics["err_r_deg"])
        batch = first.shape[0] if first.ndim else 1
        for key in self.KEYS:
            self.sums[key] += float(np.sum(_numpy(metrics[key])))
        self.num += batch

    def compute(self) -> dict:
        n = max(self.num, 1)
        out = {k: v / n for k, v in self.sums.items()}
        out["r_mse"] = float(np.sqrt(out["r_mse"]))
        out["t_mse"] = float(np.sqrt(out["t_mse"]))
        return out


class MeterReflection:
    """Accuracy of the 4-way PCA-reflection head; `labels` are the
    reflection labels [b], or the (class, reflection) pairs [b, 2] of
    `data.ModelNet40FourClass`."""

    def __init__(self):
        self.correct = 0
        self.num = 0

    def update(self, logits: np.ndarray, labels) -> None:
        labels = np.asarray(labels)
        if labels.ndim == 2:
            labels = labels[:, 1]
        pred = np.argmax(np.asarray(logits), axis=-1)
        self.correct += int((pred == labels).sum())
        self.num += len(labels)

    def compute(self) -> dict:
        return {"reflect_acc": self.correct / max(self.num, 1)}


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

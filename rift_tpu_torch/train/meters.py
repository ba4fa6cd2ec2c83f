"""Meters, copies of `rift_tpu/train/meters.py`: `MeterClassification`
(accuracy) and `MeterRegistration` (per-pair registration errors and
solver time)."""
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

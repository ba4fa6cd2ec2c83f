"""Classification meter, a copy of `rift_tpu/train/meters.py:MeterClassification`."""
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

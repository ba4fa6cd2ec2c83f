"""Logging and a JSONL metric stream, copies of `rift_tpu/train/utils.py`."""
from __future__ import annotations

import json
import logging
import os
import time


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(f"rift_tpu_torch.{name}")
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("[%(levelname)s] %(asctime)s %(name)s: %(message)s",
                              "%Y-%m-%d %H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


class MetricWriter:
    """Append-only JSONL metrics under `out_dir`: one line per event."""

    def __init__(self, out_dir: str, name: str):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"{name}.metrics.jsonl")

    def write(self, **fields) -> None:
        fields.setdefault("time", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(fields) + "\n")

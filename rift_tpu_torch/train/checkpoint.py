"""Checkpoints in torch's own format, twin of
`rift_tpu/train/checkpoint.py:CheckpointManager` (which uses orbax): a
rolling `common` checkpoint and per-metric `best_<metric>` copies under
`ckpt_dir`. Each is `<name>.pt` (`torch.save` of the model's state_dict,
the optimizer's, the update count and the best metrics) beside the
`<name>.meta.json` the reference writes ({"best": ..., "config": ...}).

The reference's own checkpoints, orbax directories `<name>/` (the
committed runs under `checkpoints/`), are read too, without orbax
(`orbax_read.read_orbax`), for evaluation; training does not resume from
them.
"""
from __future__ import annotations

import dataclasses
import json
import os

import torch

from .orbax_read import is_orbax_dir, read_orbax
from .steps import TrainState


def checkpoint_exists(ckpt_dir: str, name: str) -> bool:
    """Whether `ckpt_dir` holds `name`, as a port checkpoint `<name>.pt` or
    an orbax directory `<name>/` (nothing is created)."""
    path = os.path.join(ckpt_dir, name)
    return os.path.isfile(path + ".pt") or is_orbax_dir(path)


class CheckpointManager:
    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.ckpt_dir, name)

    def _save(self, name: str, state: TrainState, best: dict, config) -> None:
        path = self._path(name)
        tmp = path + f".pt.tmp{os.getpid()}"
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": state.step,
                    "best": {k: float(v) for k, v in best.items()}}, tmp)
        os.replace(tmp, path + ".pt")
        meta = {"best": {k: float(v) for k, v in best.items()},
                "config": dataclasses.asdict(config) if dataclasses.is_dataclass(config)
                else dict(config or {})}
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f, indent=2)

    def save_common(self, state: TrainState, best: dict, config) -> None:
        self._save("common", state, best, config)

    def save_best(self, metric_name: str, state: TrainState, best: dict, config) -> None:
        self._save(f"best_{metric_name}", state, best, config)

    def load_meta(self, name: str = "common") -> dict | None:
        """The JSON side file: {'best': {...}, 'config': <snapshot dict>}."""
        path = self._path(name) + ".meta.json"
        if not os.path.isfile(path):
            return None
        with open(path) as f:
            return json.load(f)

    def restore_raw(self, name: str = "common") -> dict | None:
        """The saved dict of `name` on the CPU: `<name>.pt`'s ({'model':
        state_dict, 'optimizer': ..., 'step': int, 'best': {...}}); else,
        where `<name>/` is an orbax directory, the reference's tree as its
        `restore_raw` returns it ({'step', 'params', 'batch_stats',
        'opt_state'} as numpy); else None."""
        path = self._path(name)
        if os.path.isfile(path + ".pt"):
            return torch.load(path + ".pt", map_location="cpu", weights_only=True)
        if is_orbax_dir(path):
            return read_orbax(path)
        return None

    def restore(self, state: TrainState, name: str = "common") -> dict | None:
        """Load `name` into `state` in place (model, optimizer, step) and
        return its best metrics; None when there is no such checkpoint."""
        saved = self.restore_raw(name)
        if saved is None:
            return None
        if "model" not in saved:
            raise NotImplementedError(
                f"{self._path(name)} is an orbax checkpoint of rift_tpu: evaluation reads "
                "it, but training does not resume from it (Adam's state is not mapped "
                "onto torch's)")
        state.model.load_state_dict(saved["model"])
        state.optimizer.load_state_dict(saved["optimizer"])
        state.step = int(saved["step"])
        return dict(saved["best"])

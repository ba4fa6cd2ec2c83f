"""Checkpoints in torch's own format, twin of
`rift_tpu/train/checkpoint.py:CheckpointManager` (which uses orbax): a
rolling `common` checkpoint and per-metric `best_<metric>` copies under
`ckpt_dir`. Each is `<name>.pt` (`torch.save` of the model's state_dict,
the optimizer's, the update count and the best metrics) beside the
`<name>.meta.json` the reference writes ({"best": ..., "config": ...}).

The reference's own checkpoints, orbax directories `<name>/` (the
committed runs under `checkpoints/`), are read too, without orbax
(`orbax_read.read_orbax`): for evaluation, and to resume training, with
optax's Adam state carried onto torch's (`weights.adam_from_flax`). An
orbax directory is only ever read. Where `<name>.pt` and `<name>/` are
both there, `<name>.pt` wins: after a resume from the reference's
`common/`, the first `save_common` writes `common.pt` beside it, and the
next resume reads that.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from collections.abc import Callable

import torch

from ..weights import adam_from_flax, from_flax, from_flax_shapenet
from .orbax_read import is_orbax_dir, read_orbax
from .steps import TrainState


def checkpoint_exists(ckpt_dir: str, name: str) -> bool:
    """Whether `ckpt_dir` holds `name`, as a port checkpoint `<name>.pt` or
    an orbax directory `<name>/` (nothing is created)."""
    path = os.path.join(ckpt_dir, name)
    return os.path.isfile(path + ".pt") or is_orbax_dir(path)


def _is_seg_tree(params: dict) -> bool:
    """A ShapeNetPVCNN tree: SharedMLP_i, PVConv_i and the per-point
    classifier Dense_0 at the top, none of the classifier head's
    BatchNorm_i or Dense_1."""
    return "Dense_0" in params and all(
        re.fullmatch(r"SharedMLP_\d+|PVConv_\d+|Dense_0", name) for name in params)


def flax_converter(params: dict, batch_stats: dict, snapshot: dict
                   ) -> Callable[[dict], dict[str, torch.Tensor]]:
    """The map of a reference tree shaped as `params` (the parameters
    themselves, or Adam's moments) onto the port's state-dict names, with
    `batch_stats`: `weights.from_flax_shapenet` for a segmentation tree,
    else `weights.from_flax` with the config snapshot's
    `with_transform_fine_tune`."""
    if _is_seg_tree(params):
        return lambda tree: from_flax_shapenet(tree, batch_stats)
    fine_tune = bool((snapshot.get("model") or {}).get("with_transform_fine_tune"))
    return lambda tree: from_flax(tree, batch_stats, fine_tune=fine_tune)


def _check_fits(model: torch.nn.Module, weights: dict, where: str) -> None:
    """Raise, naming the first key that fails, unless `weights` has exactly
    the model's state-dict keys at the model's shapes: checked before
    anything is loaded, since a strict `load_state_dict` copies the keys
    that fit before it raises."""
    own = model.state_dict()
    for key, value in own.items():
        if key not in weights:
            raise KeyError(f"{where}: the model's {key} is not in the checkpoint")
        if tuple(weights[key].shape) != tuple(value.shape):
            raise ValueError(f"{where}: {key} is {tuple(weights[key].shape)} in the checkpoint, "
                             f"{tuple(value.shape)} in the model")
    for key in weights:
        if key not in own:
            raise KeyError(f"{where}: the checkpoint's {key} is not in the model")


def set_adam_state(optimizer: torch.optim.Optimizer, params: dict[str, torch.Tensor],
                   count: int, moments: dict[str, tuple[torch.Tensor, torch.Tensor]]) -> None:
    """Put `weights.adam_from_flax`'s update count and moments into torch's
    `Adam` over `params` (name -> parameter), where its own update keeps
    them: `step` as a CPU float tensor unless the optimizer is capturable
    or fused, the moments on each parameter's device; at a count of 0 no
    state at all, as before torch's first update."""
    names = {id(p): n for n, p in params.items()}
    optimizer.state.clear()
    for group in optimizer.param_groups if count else ():
        fused = bool(group.get("fused"))
        on_device = fused or bool(group.get("capturable"))
        dtype = (torch.float64 if torch.get_default_dtype() == torch.float64 and not fused
                 else torch.float32)
        for p in group["params"]:
            exp_avg, exp_avg_sq = moments[names[id(p)]]
            optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=dtype,
                                     device=p.device if on_device else "cpu"),
                "exp_avg": exp_avg.to(device=p.device, dtype=p.dtype),
                "exp_avg_sq": exp_avg_sq.to(device=p.device, dtype=p.dtype)}


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
        return its best metrics; None when there is no such checkpoint.
        `<name>.pt` is loaded as saved. An orbax directory of the
        reference is converted as `loop.load_trained_state` converts it
        (`flax_converter`), its Adam moments and count carried onto torch's
        `Adam` (`weights.adam_from_flax`, `set_adam_state`), and its best
        metrics read from `<name>.meta.json`, as the reference's `restore`
        reads them. A tree that does not fit the model raises, naming the
        first key that fails."""
        saved = self.restore_raw(name)
        if saved is None:
            return None
        if "model" in saved:
            state.model.load_state_dict(saved["model"])
            state.optimizer.load_state_dict(saved["optimizer"])
            state.step = int(saved["step"])
            return dict(saved["best"])
        meta = self.load_meta(name) or {}
        convert = flax_converter(saved["params"], saved.get("batch_stats") or {},
                                 meta.get("config") or {})
        weights = convert(saved["params"])
        _check_fits(state.model, weights, self._path(name))
        state.model.load_state_dict(weights)
        params = dict(state.model.named_parameters())
        count, moments = adam_from_flax(saved["opt_state"], int(saved["step"]), convert, params)
        set_adam_state(state.optimizer, params, count, moments)
        state.step = int(saved["step"])
        return dict(meta.get("best") or {})

"""Convert a flax parameter tree of `rift_tpu.models.PVCNNClassifier` into a
`state_dict` of `rift_tpu_torch.models.PVCNNClassifier` (`from_flax`), and
one of `rift_tpu.models.ShapeNetPVCNN` into one of
`rift_tpu_torch.models.ShapeNetPVCNN` (`from_flax_shapenet`). The PointNet
models and PointNet++ modules name their submodules the same way, so
`from_flax` maps their trees too. `adam_from_flax` carries optax's Adam
state of such a tree (its update count and its moments `mu`, `nu`) onto
the parameter names of torch's `Adam`.

The input is plain nested dicts of numpy arrays (restore the checkpoint
wherever JAX lives and hand over the arrays); nothing here imports JAX.
Flax's automatic names map explicitly:

  top level  SharedMLP_i / PVConv_i      -> layers.<same name>
             Dense_i / BatchNorm_i       -> head.<same name> (the classifier head)
             with `fine_tune`: SharedMLP_0, Dense_0, BatchNorm_0, Dense_1
                                         -> fine_tune.<same name> (the 6-D
                                            rotation block, which flax
                                            creates first; the indices of
                                            the rest follow it)
  SharedMLP  Dense_i, BatchNorm_i        -> layers.i.dense, layers.i.bn
  PVConv     Conv_i, BatchNorm_i         -> convs.i, bns.i
             SE3d_0/Dense_0, /Dense_1    -> se.fc1, se.fc2
             SharedMLP_0                 -> point (its Dense_0 kernel is
                                            [2·c_in, out] in a dgcnn_kernel
                                            block, [c_in, out] in a
                                            pointnet_kernel one)
             coefficient                 -> coefficient (a scalar)
  Dense kernel [in, out]                 -> Linear weight [out, in]
  Conv kernel [kd, kh, kw, in, out]      -> Conv3d weight [out, in, kd, kh, kw]
  BatchNorm scale, bias + mean, var      -> weight, bias, running_mean, running_var

Any key that no rule consumes raises, so a tree from another configuration
(a third conv in a block) fails loudly instead of loading partly; a width
that differs from the torch model's fails in `load_state_dict`, and so
does a fine-tune tree converted without `fine_tune` (its block lands in
`head.`, which the model has not or holds at other widths).
"""
from __future__ import annotations

import re
from collections.abc import Callable, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


class _Tree:
    """Reads leaves of a nested dict and remembers which were read."""

    def __init__(self, tree: dict, name: str):
        self.tree = tree
        self.name = name
        self.used: set[tuple[str, ...]] = set()

    def get(self, *path: str):
        node = self.tree
        for key in path:
            if not isinstance(node, dict) or key not in node:
                raise KeyError(f"{self.name}: missing {'/'.join(path)}")
            node = node[key]
        self.used.add(path)
        return node

    def has(self, *path: str) -> bool:
        node = self.tree
        for key in path:
            if not isinstance(node, dict) or key not in node:
                return False
            node = node[key]
        return True

    def check_all_used(self) -> None:
        left = []

        def walk(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (k,))
            elif path not in self.used:
                left.append("/".join(path))

        walk(self.tree, ())
        if left:
            raise ValueError(f"{self.name}: keys with no torch counterpart: {left}")


def _dense(out: dict, prefix: str, params: _Tree, path: tuple, bias: bool = True):
    out[prefix + "weight"] = _t(params.get(*path, "kernel")).T.contiguous()
    if bias:
        out[prefix + "bias"] = _t(params.get(*path, "bias"))


def _bn(out: dict, prefix: str, params: _Tree, stats: _Tree, path: tuple):
    out[prefix + "weight"] = _t(params.get(*path, "scale"))
    out[prefix + "bias"] = _t(params.get(*path, "bias"))
    out[prefix + "running_mean"] = _t(stats.get(*path, "mean"))
    out[prefix + "running_var"] = _t(stats.get(*path, "var"))


def _shared_mlp(out, prefix, params, stats, path):
    i = 0
    while params.has(*path, f"Dense_{i}"):
        _dense(out, f"{prefix}layers.{i}.dense.", params, path + (f"Dense_{i}",))
        _bn(out, f"{prefix}layers.{i}.bn.", params, stats, path + (f"BatchNorm_{i}",))
        i += 1


def _pvconv(out, prefix, params, stats, path):
    for i in range(2):
        kernel = _t(params.get(*path, f"Conv_{i}", "kernel"))
        out[f"{prefix}convs.{i}.weight"] = kernel.permute(4, 3, 0, 1, 2).contiguous()
        out[f"{prefix}convs.{i}.bias"] = _t(params.get(*path, f"Conv_{i}", "bias"))
        _bn(out, f"{prefix}bns.{i}.", params, stats, path + (f"BatchNorm_{i}",))
    if params.has(*path, "SE3d_0"):
        _dense(out, f"{prefix}se.fc1.", params, path + ("SE3d_0", "Dense_0"), bias=False)
        _dense(out, f"{prefix}se.fc2.", params, path + ("SE3d_0", "Dense_1"), bias=False)
    _shared_mlp(out, f"{prefix}point.", params, stats, path + ("SharedMLP_0",))
    if params.has(*path, "coefficient"):
        out[f"{prefix}coefficient"] = _t(params.get(*path, "coefficient")).reshape(())


FINE_TUNE = ("SharedMLP_0", "Dense_0", "BatchNorm_0", "Dense_1")


def from_flax(params: dict, batch_stats: dict,
              fine_tune: bool = False) -> dict[str, torch.Tensor]:
    """flax `params` and `batch_stats` (nested dicts of numpy arrays) ->
    state_dict for `rift_tpu_torch.models.PVCNNClassifier`; `fine_tune`
    says the tree is of a model with `with_transform_fine_tune` (its
    FINE_TUNE modules go to `fine_tune.`, and must be there)."""
    p = _Tree(params, "params")
    s = _Tree(batch_stats, "batch_stats")
    out: dict[str, torch.Tensor] = {}
    if fine_tune:
        for name in FINE_TUNE:
            if not p.has(name):
                raise KeyError(f"params: no {name}, which a fine-tune tree has")
    for name in params:
        group = "fine_tune" if fine_tune and name in FINE_TUNE else None
        if re.fullmatch(r"SharedMLP_\d+", name):
            _shared_mlp(out, f"{group or 'layers'}.{name}.", p, s, (name,))
        elif re.fullmatch(r"PVConv_\d+", name):
            _pvconv(out, f"layers.{name}.", p, s, (name,))
        elif re.fullmatch(r"Dense_\d+", name):
            _dense(out, f"{group or 'head'}.{name}.", p, (name,))
        elif re.fullmatch(r"BatchNorm_\d+", name):
            _bn(out, f"{group or 'head'}.{name}.", p, s, (name,))
    p.check_all_used()
    s.check_all_used()
    return out


def from_flax_shapenet(params: dict, batch_stats: dict) -> dict[str, torch.Tensor]:
    """flax `params` and `batch_stats` of `rift_tpu.models.ShapeNetPVCNN`
    -> state_dict for `rift_tpu_torch.models.ShapeNetPVCNN`: SharedMLP_i
    (the local branch, the backbone's MLP blocks, the head's three) and
    PVConv_i (no SE3d, no coefficient: the model builds neither) under
    `layers`, and the per-point classifier Dense_0 under `head`. Any other
    top-level name, and any key left unread, raises."""
    other = [name for name in params
             if not re.fullmatch(r"SharedMLP_\d+|PVConv_\d+|Dense_0", name)]
    if other:
        raise ValueError(f"params: not a ShapeNetPVCNN tree, unexpected {other}")
    for name in params:
        if name.startswith("PVConv_") and {"SE3d_0", "coefficient"} & set(params[name]):
            raise ValueError(f"params: {name} has an SE3d or a coefficient, which "
                             f"ShapeNetPVCNN's blocks do not")
    return from_flax(params, batch_stats)


def _optax_states(node, adam: list, counts: list) -> None:
    """Collect, anywhere in an optax state tree (dicts, lists and named
    tuples, as `read_orbax` or optax itself gives them), the Adam states
    (keys count, mu, nu) and the schedules' states (a count alone)."""
    if hasattr(node, "_asdict"):  # optax's own NamedTuple states
        node = node._asdict()
    if isinstance(node, dict):
        if set(node) == {"count", "mu", "nu"}:
            adam.append(node)
        elif set(node) == {"count"}:
            counts.append(int(np.asarray(node["count"])))
        else:
            for value in node.values():
                _optax_states(value, adam, counts)
    elif isinstance(node, (list, tuple)):
        for value in node:
            _optax_states(value, adam, counts)


def adam_from_flax(opt_state, step: int, convert: Callable[[dict], dict],
                   params: Mapping[str, torch.Tensor]
                   ) -> tuple[int, dict[str, tuple[torch.Tensor, torch.Tensor]]]:
    """optax's Adam state -> torch's: the update count and, for each name of
    `params` (the model's parameters), `(exp_avg, exp_avg_sq)`.

    `opt_state` is the state of the reference's chain (`make_optimizer`:
    `clip_by_global_norm` when clipping, `add_decayed_weights` when there
    is weight decay, then `adam`, whose own chain ends in a schedule's
    count when the rate is a schedule); the Adam state is found by its
    keys wherever it sits. `convert` maps a tree shaped as the flax
    parameters onto the model's state-dict names (`from_flax` or
    `from_flax_shapenet` with the checkpoint's batch statistics): the
    moments are elementwise, so the kernels' transposes apply to them
    unchanged, and the entries of the BN statistics it adds are dropped.
    Raises when the chain holds no Adam state or more than one, when a
    schedule's count differs from Adam's or from `step`, and when a
    parameter has no moment or one of another shape."""
    adam, counts = [], []
    _optax_states(opt_state, adam, counts)
    if len(adam) != 1:
        raise ValueError(f"opt_state: {len(adam)} Adam states (count, mu, nu), expected one")
    count = int(np.asarray(adam[0]["count"]))
    for other in counts:
        if other != count or other != int(step):
            raise ValueError(f"opt_state: a schedule's count {other} differs from Adam's "
                             f"{count} or the step {int(step)}")
    mu, nu = convert(adam[0]["mu"]), convert(adam[0]["nu"])
    out = {}
    for name, p in params.items():
        for key, moments in (("mu", mu), ("nu", nu)):
            if name not in moments:
                raise KeyError(f"opt_state: {key} has no moment for the parameter {name}")
            if tuple(moments[name].shape) != tuple(p.shape):
                raise ValueError(f"opt_state: {key} of {name} is {tuple(moments[name].shape)}, "
                                 f"the parameter {tuple(p.shape)}")
        out[name] = (mu[name], nu[name])
    return count, out

"""Classification and part segmentation training, classification
evaluation, registration evaluation, twin of `rift_tpu/train/loop.py`:
`build_model` (f32 or the bf16 `dtype` model), `make_distributed_step`,
`train` (one card, or data-parallel over a torchrun process group, with
the in-training `registration_probe`), `build_seg_model` and
`train_segmentation` (ShapeNet parts, likewise on one card or
data-parallel),
`run_meters`, `update_best`, `_improved`, `evaluate_classification`,
`evaluate_classification_ckpt` (with `hard_tier_dataset`,
`rotation_consistency` and the `CORRUPTION_LEVELS` sweep), and
`load_trained_state`, `extractor_from_snapshot`, `resolve_extractor`,
`evaluate_registration` (every method of `registration.METHODS`, with or
without the flip-hypothesis consensus), `evaluate_registration_sweep`
(several methods on one matching pass), `extract_features`,
`extract_features_flips` and `run_map_sequence` (the multi-scan mapping
of `registration/sequence.py`).
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..data import SyntheticPairs, get_pairs, get_sequence
from ..data.modelnet40 import ModelNet40, get_datasets
from ..data.shapenet import ShapeNetConfig, get_shapenet
from ..data.synthetic_pairs import random_rotation
from ..device import resolve_device
from ..models import PVCNNClassifier, ShapeNetPVCNN
from ..ops.lrf import lrf_basis, lrf_flip_hypotheses
from ..ops.neighbors import gather_rows, mutual_nearest_neighbors
from ..ops.normals import estimate_normals
from ..ops.precision import f32_geometry
from ..parallel.mesh import (broadcast_object, mesh_group, rank_and_world, replicate,
                             shard_batch)
from ..registration import (consensus_match, gnc_pose, map_sequence, pair_errors,
                            register_pair, register_pair_from_matches)
from ..registration.pipeline import split_method
from .checkpoint import CheckpointManager
from .config import EvalConfig, ExperimentConfig, ModelConfig, apply_overrides
from .meters import MeterClassification, MeterRegistration, MeterShapeNetIoU
from .steps import TrainState, create_state, eval_step, init_params, train_step
from .utils import MetricWriter, get_logger

Tensor = torch.Tensor


def build_model(config: ExperimentConfig) -> PVCNNClassifier:
    m = config.model
    if m.with_transform_fine_tune:
        raise NotImplementedError("with_transform_fine_tune is not ported yet (ROADMAP item 10)")
    return PVCNNClassifier(
        blocks=tuple(tuple(b) for b in m.blocks),
        dim_k=m.dim_k,
        num_classes=m.num_classes,
        point_kernel_formal=m.point_kernel_formal,
        voxel_shape=m.voxel_shape,
        with_coeff=m.with_coeff,
        with_se=m.with_se,
        extra_feature_channels=m.extra_feature_channels,
        width_multiplier=m.width_multiplier,
        voxel_resolution_multiplier=m.voxel_resolution_multiplier,
        is_classify=m.is_classify,
        rot_invariant_preprocess=m.rot_invariant_preprocess,
        lrf_kind=m.lrf_kind,
        with_local_feat=m.with_local_feat,
        local_neighbors=m.local_neighbors,
        use_new_coords_for_voxel=m.use_new_coords_for_voxel,
        dtype=m.dtype)


def make_distributed_step(data_parallel: bool = True, batch_size: int | None = None,
                          log: logging.Logger | None = None):
    """(step, group): the data-parallel step over the default process group
    (`parallel.make_sharded_train_step`) when one of more than one rank
    exists and `data_parallel` is set, else (`train_step`, None). As in the
    reference, a batch_size that the ranks do not divide warns and trains
    each rank alone on the whole batch; that is the reference's rule for a
    mesh, not a device fallback. One process drives one card (torchrun),
    where the reference's one process drives every local device."""
    _, world = rank_and_world()
    if not data_parallel or world < 2:
        return train_step, None
    if batch_size is not None and batch_size % world:
        if log is not None:
            log.warning("data_parallel requested but batch_size %d %% %d ranks != 0; "
                        "each rank trains alone on the whole batch", batch_size, world)
        return train_step, None
    from ..parallel.sharded_ops import make_sharded_train_step  # it imports train.steps

    if log is not None:
        log.info("data-parallel over %d ranks (%s)", world, dist.get_backend())
    return make_sharded_train_step(dist.group.WORLD), dist.group.WORLD


# Metric keys where smaller is better, the reference's set (registration
# errors and times, losses, the RPM-Net meter's errors); every other key is
# higher-is-better.
_LOWER_BETTER = {
    "rre", "rte", "rmse", "rmse_succ", "reg_time", "loss", "logit_drift",
    "r_mse", "r_mae", "t_mse", "t_mae", "err_r_deg", "err_t", "chamfer",
}


def _improved(key: str, new: float, old: float | None) -> bool:
    """Strict improvement of metric `key`: a tie (the probe's reg_time is
    always 0.0) does not re-save the checkpoint."""
    if old is None:
        return True
    return new < old if key in _LOWER_BETTER else new > old


def update_best(best: dict, results: dict, ckpt: CheckpointManager, state: TrainState,
                config: ExperimentConfig, log: logging.Logger | None = None) -> None:
    """Per-metric best tracking, saving a `best_{name}` checkpoint per
    improved metric (none when `ckpt` is None: the ranks other than 0); a
    dict-valued result (the probe's meter) saves `best_{name}_{key}` per
    improved key."""
    for name, value in results.items():
        items = ({f"{name}_{k}": (k, v) for k, v in value.items()} if isinstance(value, dict)
                 else {name: (name, value)})
        for tag, (key, v) in items.items():
            if _improved(key, float(v), best.get(tag)):
                best[tag] = float(v)
                if ckpt is not None:
                    ckpt.save_best(tag, state, best, config)
                if log is not None and isinstance(value, dict):
                    log.info("new best %s = %.4f", tag, float(v))


def run_meters(state: TrainState, dataset, config: ExperimentConfig,
               meter_factories: dict) -> dict:
    """One pass over `dataset` feeding every meter from one forward."""
    meters = {k: f() for k, f in meter_factories.items()}
    device = next(state.model.parameters()).device
    for clouds, labels in dataset.batches(config.train.eval_batch_size, seed=0,
                                          shuffle=False, drop_last=False):
        logits = eval_step(state, torch.as_tensor(clouds, device=device)).cpu().numpy()
        for m in meters.values():
            m.update(logits, labels)
    return {k: m.compute() for k, m in meters.items()}


def evaluate_classification(state: TrainState, dataset, config: ExperimentConfig) -> float:
    return run_meters(state, dataset, config, {"acc": MeterClassification})["acc"]


def registration_probe(state: TrainState, config: ExperimentConfig, num_pairs: int = 16) -> dict:
    """The in-training feature-quality probe: `num_pairs` synthetic noise
    pairs of `dataset.num_points` points (seed `config.seed`), registered
    by the current trunk as a feature extractor (the classifier head
    unused): normals, one 2b forward, mutual-NN matches and GNC-TLS with
    `evaluate.noise_bound`. Returns the MeterRegistration dict (reg_time
    0.0), which `update_best` tracks as best_reg_rre etc."""
    device = next(state.model.parameters()).device
    model = build_model(dataclasses.replace(
        config, model=dataclasses.replace(config.model, is_classify=False)))
    model.load_state_dict({k: v for k, v in state.model.state_dict().items()
                           if not k.startswith("head.")})
    model = model.to(device).eval()
    pairs = SyntheticPairs(num_pairs=num_pairs, num_points=config.dataset.num_points,
                           mode="noise", seed=config.seed)
    src, dst, gt = (torch.as_tensor(a, device=device) for a in pairs.arrays())
    b = src.shape[0]
    with torch.no_grad(), f32_geometry():
        clouds = torch.cat([src, dst], 0)
        feats = model(torch.cat([clouds, estimate_normals(clouds)], -1))
        i1, i2, mask = mutual_nearest_neighbors(feats[:b], feats[b:])
        est, _ = gnc_pose(gather_rows(src, i1.expand(i2.shape)), gather_rows(dst, i2), mask,
                          noise_bound=config.evaluate.noise_bound)
        errors = pair_errors(src, gt, est)
    meter = MeterRegistration()
    meter.update({k: v.cpu().numpy() for k, v in errors.items()})
    return meter.compute()


def train(config: ExperimentConfig, resume: bool = True, meters: dict | None = None,
          device: str | torch.device | None = None) -> dict:
    """Classification training (the card unless `device` says otherwise):
    per epoch, `steps_per_epoch` updates, then every `valid_interval`
    epochs the `meters` ({name: factory}; default {'acc':
    MeterClassification}) on the valid split, and, at those epochs that
    `train.reg_probe_interval` also divides, `registration_probe` as
    result 'reg'; best checkpoints per improved metric (`update_best`) and
    the rolling `common` checkpoint. With `resume`, continues from
    `common` in `ckpt_dir`. Under a torch.distributed process group
    (torchrun, `parallel.initialize_multihost`) the global batch runs
    data-parallel over its ranks (`make_distributed_step`); every rank
    reads the same batches and keeps its rows, rank 0's state is
    replicated first, rank 0 alone writes checkpoints and the metric log,
    and it runs validation and the probe and gives every rank their
    results. Returns {'state', 'best', 'loss'} (loss: the last epoch's
    mean train loss; under data parallelism, of the global batches)."""
    device = resolve_device(device)
    log = get_logger(config.name)
    rank, world = rank_and_world()
    main = rank == 0
    writer = MetricWriter(config.train.ckpt_dir, config.name) if main else None
    datasets = get_datasets(config.dataset)
    meters = meters or {"acc": MeterClassification}

    steps_per_epoch = max(len(datasets["train"]) // config.train.batch_size, 1)
    if config.train.steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, config.train.steps_per_epoch)
    state = create_state(build_model(config), config, steps_per_epoch, device,
                         seed=config.seed)
    step_fn, group = make_distributed_step(config.train.data_parallel,
                                           config.train.batch_size, log)

    ckpt = CheckpointManager(config.train.ckpt_dir)
    best: dict = {}
    start_epoch = 0
    if resume:
        restored = ckpt.restore(state)
        if restored is not None:
            best = restored
            start_epoch = state.step // steps_per_epoch
            log.info("resumed from step %d (epoch %d)", state.step, start_epoch)
    if group is not None:
        replicate(state, group)

    # The dropout mask of update t comes from a generator seeded with
    # (seed, t), as the reference folds the step into its key.
    generator = torch.Generator(device=device)
    loss = float("nan")  # a resumed, finished run skips the loop
    for epoch in range(start_epoch, config.optim.num_epochs):
        t0 = time.time()
        metrics = []
        for i, (clouds, labels) in enumerate(
                datasets["train"].batches(config.train.batch_size, seed=epoch)):
            if i >= steps_per_epoch:
                break
            if group is not None:
                clouds, labels = shard_batch((clouds, labels), group)
            generator.manual_seed(config.seed * 1_000_003 + state.step)
            metrics.append(step_fn(state, torch.as_tensor(clouds, device=device),
                                   torch.as_tensor(labels, device=device), generator))
        loss = float(np.mean([float(m["loss"]) for m in metrics]))
        acc = float(np.mean([float(m["acc"]) for m in metrics]))
        if main:
            writer.write(step=state.step, epoch=epoch, split="train", loss=loss, acc=acc,
                         sec=time.time() - t0)
            log.info("epoch %d: loss %.4f acc %.4f (%.1fs)", epoch, loss, acc,
                     time.time() - t0)

        if (epoch + 1) % config.train.valid_interval == 0:
            results = None
            if main:
                results = run_meters(state, datasets["valid"], config, meters)
                probe_every = config.train.reg_probe_interval
                if probe_every and (epoch + 1) % probe_every == 0:
                    results["reg"] = registration_probe(state, config,
                                                        config.train.reg_probe_pairs)
            if world > 1:
                results = broadcast_object(results)
            flat = {}
            for k, v in results.items():
                if isinstance(v, dict):
                    flat.update({f"{k}_{kk}": float(vv) for kk, vv in v.items()})
                else:
                    flat[k] = float(v)
            if main:
                writer.write(step=state.step, epoch=epoch, split="valid", **flat)
                log.info("epoch %d: valid %s", epoch, flat)
            update_best(best, results, ckpt if main else None, state, config, log)
            if main:
                ckpt.save_common(state, best, config)
    return {"state": state, "best": best, "loss": loss}


def build_seg_model(config: ExperimentConfig, in_channels: int = 6) -> ShapeNetPVCNN:
    """The part segmentation model from exactly the fields the reference's
    `train_segmentation` reads (`num_classes`, `with_se`, `with_coeff`,
    `lrf_kind`, `extra_feature_channels` and `dtype` are not among them:
    50 classes, no SE, no coefficient, the reference LRF, f32), for items
    of `in_channels` channels before the one-hot id (6 with normals, 3
    without; flax reads it from the input)."""
    m = config.model
    return ShapeNetPVCNN(blocks=tuple(tuple(b) for b in m.blocks),
                         in_channels=in_channels,
                         point_kernel_formal=m.point_kernel_formal,
                         voxel_shape=m.voxel_shape,
                         rot_invariant_preprocess=m.rot_invariant_preprocess,
                         with_local_feat=bool(m.with_local_feat),
                         local_neighbors=m.local_neighbors,
                         width_multiplier=m.width_multiplier)


def train_segmentation(config: ExperimentConfig, shapenet_config: ShapeNetConfig | None = None,
                       resume: bool = True, device: str | torch.device | None = None) -> dict:
    """ShapeNet part segmentation training (the card unless `device` says
    otherwise), as the reference's: the data of `shapenet_config`, else
    the synthetic split at `dataset.num_points` (`dataset.root` is not
    read, as in the reference); the model of `build_seg_model`, Adam and
    the cosine schedule; per epoch `steps_per_epoch` updates of the mean
    cross-entropy over every point (`train_step`), then the test split's
    instance mIoU (`MeterShapeNetIoU` through `run_meters`), `best_iou`
    saved when it is at least the best so far, and `common`. With
    `resume`, continues from `common` in `ckpt_dir`. Under a process
    group of more than one rank the global batch runs data-parallel, as
    `train()` runs it (global BatchNorm statistics and dropout masks; a
    batch size the ranks do not divide trains each rank alone); rank 0
    alone evaluates, writes the metric log and the checkpoints, and gives
    every rank the mIoU.
    Returns {'state', 'best'}."""
    device = resolve_device(device)
    log = get_logger(config.name)
    rank, world = rank_and_world()
    main = rank == 0
    writer = MetricWriter(config.train.ckpt_dir, config.name) if main else None
    sn_cfg = shapenet_config or ShapeNetConfig(num_points=config.dataset.num_points)
    datasets = get_shapenet(sn_cfg)
    steps_per_epoch = max(len(datasets["train"]) // config.train.batch_size, 1)
    if config.train.steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, config.train.steps_per_epoch)
    state = create_state(build_seg_model(config, 6 if sn_cfg.with_normals else 3), config,
                         steps_per_epoch, device,
                         seed=config.seed)
    step_fn, group = make_distributed_step(config.train.data_parallel,
                                           config.train.batch_size, log)
    ckpt = CheckpointManager(config.train.ckpt_dir)
    best: dict = {}
    start_epoch = 0
    if resume:
        restored = ckpt.restore(state)
        if restored is not None:
            best = restored
            start_epoch = state.step // steps_per_epoch
            log.info("seg resumed from step %d (epoch %d)", state.step, start_epoch)
    if group is not None:
        replicate(state, group)

    generator = torch.Generator(device=device)  # seeded per update, as in train()
    for epoch in range(start_epoch, config.optim.num_epochs):
        t0 = time.time()
        losses = []
        for i, (clouds, labels) in enumerate(
                datasets["train"].batches(config.train.batch_size, seed=epoch)):
            if i >= steps_per_epoch:
                break
            if group is not None:
                clouds, labels = shard_batch((clouds, labels), group)
            generator.manual_seed(config.seed * 1_000_003 + state.step)
            losses.append(step_fn(state, torch.as_tensor(clouds, device=device),
                                  torch.as_tensor(labels, device=device), generator)["loss"])
        loss = float(np.mean([float(x) for x in losses]))
        iou = None
        if main:
            iou = run_meters(state, datasets["test"], config, {"iou": MeterShapeNetIoU})["iou"]
        if world > 1:
            iou = broadcast_object(iou)
        if main:
            writer.write(step=state.step, epoch=epoch, split="train", loss=loss, iou=iou,
                         sec=time.time() - t0)
            log.info("seg epoch %d: loss %.4f mIoU %.4f", epoch, loss, iou)
        if iou >= best.get("iou", -1.0):
            best["iou"] = iou
            if main:
                ckpt.save_best("iou", state, best, config)
        if main:
            ckpt.save_common(state, best, config)
    return {"state": state, "best": best}


def load_trained_state(ckpt_dir: str, name: str = "common") -> tuple[dict, dict]:
    """A port checkpoint for evaluation: (the saved dict, whose 'model' is
    the state dict and 'step' the update count; the config snapshot saved
    beside it, {} when there is none)."""
    ckpt = CheckpointManager(ckpt_dir)
    raw = ckpt.restore_raw(name)
    if raw is None:
        raise FileNotFoundError(f"no checkpoint {name!r} under {ckpt_dir!r} "
                                f"(expected {os.path.join(ckpt_dir, name)}.pt)")
    meta = ckpt.load_meta(name) or {}
    return raw, meta.get("config", {})


def extractor_from_snapshot(config: ExperimentConfig, snapshot: dict) -> PVCNNClassifier:
    """The registration feature extractor with the trained trunk's
    architecture: the snapshot's model config wins over `config.model`,
    `is_classify` is off, and `evaluate.canonical_voxel` on a
    'change_coords' trunk turns on `use_new_coords_for_voxel` (the same
    parameters, the voxel grid in the canonical frame)."""
    snap_model = dict(snapshot.get("model") or {})
    if snap_model:
        known = {f.name for f in dataclasses.fields(ModelConfig)}
        mcfg = ModelConfig(**{k: v for k, v in snap_model.items() if k in known})
    else:
        mcfg = dataclasses.replace(config.model)
    mcfg.is_classify = False
    if config.evaluate.canonical_voxel and mcfg.rot_invariant_preprocess == "change_coords":
        mcfg.use_new_coords_for_voxel = True
    return build_model(dataclasses.replace(config, model=mcfg))


def resolve_extractor(config: ExperimentConfig, model: PVCNNClassifier | None = None,
                      ckpt_dir: str | None = None, ckpt_name: str | None = None,
                      device: str | torch.device | None = None,
                      log: logging.Logger | None = None) -> PVCNNClassifier:
    """The feature extractor to evaluate, in eval mode on `device`: an
    explicit `model` (already on `device`) > the checkpoint `ckpt_name`
    (default `evaluate.ckpt_name`, else 'common') in `ckpt_dir` or
    `evaluate.ckpt_dir` > `train.ckpt_dir`'s, when it holds one > a seeded
    init of `config.model` (logged as untrained). A checkpoint's classifier
    head is dropped."""
    device = resolve_device(device)
    log = log or get_logger(config.name)
    if model is not None:
        p = next(model.parameters())
        if p.device.type != device.type:
            raise ValueError(f"model is on {p.device}, the run on {device}")
        return model.eval()
    ckpt_dir = ckpt_dir or config.evaluate.ckpt_dir
    ckpt_name = ckpt_name or config.evaluate.ckpt_name or "common"
    if ckpt_dir is None and os.path.isfile(
            os.path.join(config.train.ckpt_dir, ckpt_name + ".pt")):
        ckpt_dir = config.train.ckpt_dir
    if ckpt_dir is not None:
        raw, snapshot = load_trained_state(ckpt_dir, ckpt_name)
        model = extractor_from_snapshot(config, snapshot)
        model.load_state_dict({k: v for k, v in raw["model"].items()
                               if not k.startswith("head.")})
        log.info("restored %s/%s (step %d)", ckpt_dir, ckpt_name, int(raw["step"]))
    else:
        log.warning("evaluating an UNTRAINED model (no checkpoint found; pass ckpt_dir or "
                    "evaluate.ckpt_dir for trained features)")
        model = build_model(config)
        init_params(model, config.seed)
    return model.to(device).eval()


def flip_features(model: PVCNNClassifier, x: Tensor, b: int) -> Tensor:
    """Features [5b, n, c] of the 2b clouds x [2b, n, 6] (b sources, then
    b targets): each source under its 4 LRF sign flips, in sources' order,
    then each target under its own basis, in one forward. The bases are
    those of the centred clouds, as the reference computes them outside
    the model (which centres again inside)."""
    clouds = x[..., :3].contiguous()  # reduced in the same order as the cat's inputs
    basis = lrf_basis(clouds - clouds.mean(-2, keepdim=True), model.lrf_kind)
    lrf_all = torch.cat([lrf_flip_hypotheses(basis[:b]).reshape(-1, 3, 3), basis[b:]], 0)
    return model(torch.cat([x[:b].repeat_interleave(4, dim=0), x[b:]], 0), lrf=lrf_all)


def uses_flips(model: PVCNNClassifier, evaluate: EvalConfig) -> bool:
    """The flip hypotheses run when `evaluate.flip_hypotheses` asks for them
    and the trunk's preprocess is 'change_coords', whose frame they flip."""
    return evaluate.flip_hypotheses and model.rot_invariant_preprocess == "change_coords"


def match_eval_batch(model: PVCNNClassifier, src: Tensor, dst: Tensor, evaluate: EvalConfig
                     ) -> tuple[Tensor, Tensor, Tensor]:
    """The matching pass of b pairs [b, n, 3] on the model's device, the
    part of a registration that no method changes: normals of the 2b
    clouds; with the flips (`uses_flips`), `flip_features` (one [5b, n, 6]
    forward) and `consensus_match`; without, one 2b forward and mutual
    nearest neighbours. Returns the matches (i1, i2, mask) [b, n]."""
    if model.head is not None:
        raise ValueError("registration needs a feature extractor (is_classify=False)")
    b, n = src.shape[:2]
    with torch.no_grad(), f32_geometry():
        clouds = torch.cat([src, dst], 0)
        x = torch.cat([clouds, estimate_normals(clouds)], -1)
        if not uses_flips(model, evaluate):
            feats = model(x)
            i1, i2, mask = mutual_nearest_neighbors(feats[:b], feats[b:])
            return i1.expand(i2.shape), i2, mask
        feats = flip_features(model, x, b)
        f_src_h = feats[:4 * b].reshape(b, 4, n, -1)
        i1, i2, mask, _ = consensus_match(src, dst, f_src_h, feats[4 * b:],
                                          tau=2.0 * evaluate.noise_bound)
        return i1, i2, mask


def solve_eval_batch(src: Tensor, dst: Tensor, matches: tuple[Tensor, Tensor, Tensor],
                     evaluate: EvalConfig, method: str | None = None,
                     generator: torch.Generator | None = None) -> Tensor:
    """Transforms [b, 4, 4] from the matches of `match_eval_batch`:
    `register_pair_from_matches` with `method` (default
    `evaluate.method`) and `evaluate`'s solver fields; RANSAC draws from
    `generator` (seeded with 0 when None)."""
    with torch.no_grad():
        return register_pair_from_matches(
            src, dst, *matches, method=method or evaluate.method,
            noise_bound=evaluate.noise_bound, inlier_threshold=evaluate.inlier_threshold,
            num_hypotheses=evaluate.num_hypotheses, irls_iterations=evaluate.ransac_irls,
            irls_shrink=evaluate.ransac_irls_shrink, generator=generator)[0]


def register_eval_batch(model: PVCNNClassifier, src: Tensor, dst: Tensor,
                        evaluate: EvalConfig, generator: torch.Generator | None = None
                        ) -> Tensor:
    """Estimated transforms [b, 4, 4] of b pairs [b, n, 3] on the model's
    device: normals of the 2b clouds; with the flips (`uses_flips`),
    `flip_features` (one [5b, n, 6] forward), `consensus_match` and
    `register_pair_from_matches`; without, one 2b forward and
    `register_pair`. `evaluate`'s method and its RANSAC fields go to the
    solver, and RANSAC draws from `generator` (seeded with 0 when None)."""
    if uses_flips(model, evaluate):
        return solve_eval_batch(src, dst, match_eval_batch(model, src, dst, evaluate), evaluate,
                                generator=generator)
    if model.head is not None:
        raise ValueError("registration needs a feature extractor (is_classify=False)")
    b = src.shape[0]
    kw = dict(method=evaluate.method, noise_bound=evaluate.noise_bound,
              inlier_threshold=evaluate.inlier_threshold,
              num_hypotheses=evaluate.num_hypotheses, irls_iterations=evaluate.ransac_irls,
              irls_shrink=evaluate.ransac_irls_shrink, generator=generator)
    with torch.no_grad(), f32_geometry():
        clouds = torch.cat([src, dst], 0)
        feats = model(torch.cat([clouds, estimate_normals(clouds)], -1))
        return register_pair(src, dst, feats[:b], feats[b:], **kw)[0]


def _sync(device: torch.device) -> None:
    """Wait for the card's queue (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pad_batch(src: Tensor, dst: Tensor, batch_pairs: int) -> tuple[Tensor, Tensor]:
    """The tail batch padded to `batch_pairs` with copies of its first pair."""
    pad = batch_pairs - src.shape[0]
    if pad <= 0:
        return src, dst
    return (torch.cat([src, src[:1].expand(pad, -1, -1)], 0),
            torch.cat([dst, dst[:1].expand(pad, -1, -1)], 0))


def evaluate_registration(config: ExperimentConfig, model: PVCNNClassifier | None = None,
                          ckpt_dir: str | None = None, ckpt_name: str | None = None,
                          device: str | torch.device | None = None) -> dict:
    """Registration evaluation of `config.evaluate` on one device (the card
    unless `device` says otherwise): per batch of `batch_pairs` pairs, the
    tail padded with copies of the first pair, `register_eval_batch` then
    `pair_errors` of the real pairs. One untimed warm-up batch goes first
    (the kernel build, cuDNN's choice of algorithm); `reg_time` is a
    batch's wall time, ended by a synchronize, times its share of real
    pairs. RANSAC's samples come from one generator on the device, seeded
    with `config.seed`, each batch drawing from it in turn; the warm-up's
    draws are given back, so no result depends on the warm-up. Returns the
    means over pairs of rre, rte, rmse, succ, rmse_succ and reg_time. The
    extractor comes from `resolve_extractor`."""
    device = resolve_device(device)
    log = get_logger(config.name)
    ev = config.evaluate
    split_method(ev.method)  # an unknown method fails before the forward
    pairs = get_pairs(ev.pairs_path, ev.num_points, ev.pairs_mode, ev.num_pairs)
    model = resolve_extractor(config, model, ckpt_dir, ckpt_name, device, log)
    meter = MeterRegistration()
    generator = torch.Generator(device=device).manual_seed(config.seed)
    batch_pairs = max(min(int(ev.batch_pairs), len(pairs)), 1)
    warmed = False
    for batch in pairs.batches(batch_pairs):
        n_real = batch.source.shape[0]
        src, dst = _pad_batch(torch.as_tensor(batch.source, device=device),
                              torch.as_tensor(batch.target, device=device), batch_pairs)
        gt = torch.as_tensor(batch.transform, device=device)
        if not warmed:
            state = generator.get_state()
            register_eval_batch(model, src, dst, ev, generator)
            _sync(device)
            generator.set_state(state)
            warmed = True
        t0 = time.perf_counter()
        est = register_eval_batch(model, src, dst, ev, generator)
        _sync(device)
        reg_time = time.perf_counter() - t0
        errors = pair_errors(src[:n_real], gt, est[:n_real])
        meter.update({k: v.cpu().numpy() for k, v in errors.items()},
                     reg_time * n_real / src.shape[0])
    results = meter.compute()
    log.info("registration eval [%s/%s]: %s", ev.pairs_mode, ev.method, results)
    return results


def evaluate_registration_sweep(config: ExperimentConfig, methods: list[str],
                                model: PVCNNClassifier | None = None,
                                ckpt_dir: str | None = None, ckpt_name: str | None = None,
                                device: str | torch.device | None = None) -> dict[str, dict]:
    """Several robust estimators over one shared matching pass (the card
    unless `device` says otherwise): per batch of `batch_pairs` pairs (the
    tail padded), `match_eval_batch` once, then `solve_eval_batch` with
    each method on the same matches. Every method of a batch draws from
    the same generator state (the reference gives every method of a batch
    the same keys); the next batch starts from the state after RANSAC's
    draw (unchanged when no method draws), so a sweep of one method is
    `evaluate_registration`. One untimed warm-up batch goes first, its
    draws given back. A method's `reg_time` is the batch's match time
    plus its solve time, each ended by a synchronize, times the share of
    real pairs. Returns {method: MeterRegistration's results}."""
    device = resolve_device(device)
    log = get_logger(config.name)
    ev = config.evaluate
    for m in methods:
        split_method(m)  # an unknown method fails before the forward
    pairs = get_pairs(ev.pairs_path, ev.num_points, ev.pairs_mode, ev.num_pairs)
    model = resolve_extractor(config, model, ckpt_dir, ckpt_name, device, log)
    meters = {m: MeterRegistration() for m in methods}
    generator = torch.Generator(device=device).manual_seed(config.seed)
    batch_pairs = max(min(int(ev.batch_pairs), len(pairs)), 1)

    def run(src, dst):
        """(match seconds, {method: (transform, solve seconds)}), the
        generator left after the batch's draws."""
        t0 = time.perf_counter()
        matches = match_eval_batch(model, src, dst, ev)
        _sync(device)
        t_match = time.perf_counter() - t0
        start = generator.get_state()
        after, out = start, {}
        for m in methods:
            generator.set_state(start)
            t0 = time.perf_counter()
            est = solve_eval_batch(src, dst, matches, ev, m, generator)
            _sync(device)
            out[m] = (est, time.perf_counter() - t0)
            state = generator.get_state()
            if not torch.equal(state, start):
                after = state
        generator.set_state(after)
        return t_match, out

    warmed = False
    match_s = []
    for batch in pairs.batches(batch_pairs):
        n_real = batch.source.shape[0]
        src, dst = _pad_batch(torch.as_tensor(batch.source, device=device),
                              torch.as_tensor(batch.target, device=device), batch_pairs)
        gt = torch.as_tensor(batch.transform, device=device)
        if not warmed:
            state = generator.get_state()
            run(src, dst)
            generator.set_state(state)
            warmed = True
        t_match, out = run(src, dst)
        match_s.append(t_match)
        for m, (est, t_solve) in out.items():
            errors = pair_errors(src[:n_real], gt, est[:n_real])
            meters[m].update({k: v.cpu().numpy() for k, v in errors.items()},
                             (t_match + t_solve) * n_real / src.shape[0])
    results = {m: meters[m].compute() for m in methods}
    log.info("registration sweep [%s]: matching %.2f ms a batch (mean of %d)", ev.pairs_mode,
             1e3 * float(np.mean(match_s)), len(match_s))
    for m in methods:
        log.info("registration sweep [%s/%s]: %s", ev.pairs_mode, m, results[m])
    return results


def _chunks(model: PVCNNClassifier, clouds, batch_size: int, forward) -> Tensor:
    """forward(x [b, n, 6]) over `clouds` [m, n, 3] in chunks of
    `batch_size` (the tail padded with copies of its first cloud), x the
    clouds with their estimated normals, on the model's device; the
    results of the real clouds concatenated."""
    device = next(model.parameters()).device
    clouds = torch.as_tensor(clouds, dtype=torch.float32, device=device)
    m = clouds.shape[0]
    b = min(batch_size, m)
    outs = []
    with torch.no_grad(), f32_geometry():
        for start in range(0, m, b):
            chunk = clouds[start:start + b]
            n_real = chunk.shape[0]
            if n_real < b:
                chunk = torch.cat([chunk, chunk[:1].expand(b - n_real, -1, -1)], 0)
            x = torch.cat([chunk, estimate_normals(chunk)], -1)
            outs.append(forward(x)[:n_real])
    return torch.cat(outs, 0)


def extract_features(model: PVCNNClassifier, clouds, batch_size: int = 32) -> Tensor:
    """Per-point features [m, n, c] of clouds [m, n, 3] on the model's
    device: normals, then one forward a chunk of `batch_size`."""
    return _chunks(model, clouds, batch_size, model)


def extract_features_flips(model: PVCNNClassifier, clouds, batch_size: int = 16) -> Tensor:
    """Per-point features [m, 4, n, c] of every cloud under the 4
    right-handed sign assignments of its LRF (`flip_features` with every
    cloud a source, one [4b, n, 6] forward a chunk). Slot 0 is the
    primary frame, so `out[:, 0]` is what `extract_features` gives."""
    def forward(x):
        b, n = x.shape[:2]
        return flip_features(model, x, b).reshape(b, 4, n, -1)

    return _chunks(model, clouds, batch_size, forward)


def run_map_sequence(config: ExperimentConfig, ckpt_dir: str | None = None,
                     ckpt_name: str | None = None, loop_stride: int = 6,
                     landmarks_per_edge: int = 64, use_mesh: bool = False,
                     device: str | torch.device | None = None) -> dict:
    """The multi-scan mapping pipeline (the card unless `device` says
    otherwise): the scans of `config.sequence`, their features from the
    trunk of `resolve_extractor` (under the 4 flips when `uses_flips`),
    then `registration.map_sequence` with `config.evaluate`'s method and
    solver fields. With `use_mesh`, the pose-graph and BA solves are
    sharded over the default process group (torchrun's), or over a group
    of this process alone when there is none. Logs every stage's seconds
    and returns the map's metrics."""
    device = resolve_device(device)
    log = get_logger(config.name)
    seq = get_sequence(config.sequence)
    model = resolve_extractor(config, None, ckpt_dir, ckpt_name, device, log)
    t0 = time.perf_counter()
    flip_feats = None
    if uses_flips(model, config.evaluate):
        flip_feats = extract_features_flips(model, seq.scans)
        feats = flip_feats[:, 0]
    else:
        feats = extract_features(model, seq.scans)
    _sync(device)
    features_s = time.perf_counter() - t0
    ev = config.evaluate
    with mesh_group(device, enabled=use_mesh) as group:
        result = map_sequence(
            seq.scans, feats, gt_poses=seq.gt_poses, method=ev.method,
            noise_bound=ev.noise_bound, num_hypotheses=ev.num_hypotheses,
            inlier_threshold=ev.inlier_threshold, loop_stride=loop_stride,
            landmarks_per_edge=landmarks_per_edge, group=group, seed=config.seed,
            flip_features=flip_feats, device=device)
    log.info("map-sequence [%d scans, %d edges]: %s", len(seq), len(result.edges[0]),
             result.metrics)
    log.info("map-sequence seconds: %s", {"features": features_s, **result.seconds})
    return result.metrics


def rotation_consistency(state: TrainState, dataset, num_items: int = 64,
                         num_rotations: int = 4, seed: int = 0) -> dict:
    """SO(3) consistency of the trained classifier: the first `num_items`
    items of `dataset` (drawn with one RandomState seeded `seed`) under
    `num_rotations` random rotations each, from the same RandomState.
    Returns rot_agree, the share of (item, rotation) predictions equal to
    the item's most frequent one, and logit_drift, the mean over them of
    |logits − their mean over rotations| / |that mean|."""
    device = next(state.model.parameters()).device
    rs = np.random.RandomState(seed)
    num_items = min(num_items, len(dataset))
    clouds = np.stack([dataset.get(i, rs)[0] for i in range(num_items)])
    logits_per_rot = []
    for _ in range(num_rotations):
        rotated = []
        for cloud in clouds:
            _, p, nrm = random_rotation(cloud[:, :3], cloud[:, 3:6], 360.0, 0.0, rs=rs)
            rotated.append(np.concatenate([p, nrm], -1))
        logits_per_rot.append(eval_step(
            state, torch.as_tensor(np.stack(rotated), device=device)).cpu().numpy())
    logits = np.stack(logits_per_rot)           # [K, m, C]
    preds = np.argmax(logits, -1)               # [K, m]
    modal = np.apply_along_axis(lambda col: np.bincount(col).argmax(), 0, preds)
    center = logits.mean(0, keepdims=True)
    drift = np.linalg.norm(logits - center, axis=-1) / (np.linalg.norm(center, axis=-1) + 1e-9)
    return {"rot_agree": float(np.mean(preds == modal[None])), "logit_drift": float(np.mean(drift))}


def hard_tier_dataset(dataset_cfg):
    """The reference's hard evaluation tier: a copy of `dataset_cfg` with
    at most 512 points, within-class shape jitter 0.25, clipped sensor
    noise 0.01 and 5% of each cloud cropped behind a random half-space
    (the standard synthetic test split saturates)."""
    return dataclasses.replace(dataset_cfg, num_points=min(dataset_cfg.num_points, 512),
                               instance_jitter=0.25, noise_sigma=0.01, occlusion=0.05)


# The sweep's (instance_jitter, noise_sigma, occlusion) levels, from clean
# through the hard tier (level 3) to beyond it, all at hard_tier_dataset's
# point budget.
CORRUPTION_LEVELS = ((0.0, 0.0, 0.0), (0.10, 0.005, 0.02),
                     (0.18, 0.0075, 0.035), (0.25, 0.01, 0.05),
                     (0.32, 0.015, 0.10), (0.40, 0.02, 0.15))


def _corruption_sweep(state: TrainState, config: ExperimentConfig,
                      log: logging.Logger) -> dict:
    """Test accuracy at each of CORRUPTION_LEVELS (sweep_acc_l0..5) and
    their mean (sweep_auc)."""
    out, accs = {}, []
    for i, (jitter, noise, occlusion) in enumerate(CORRUPTION_LEVELS):
        cfg = dataclasses.replace(config.dataset, num_points=min(config.dataset.num_points, 512),
                                  instance_jitter=jitter, noise_sigma=noise,
                                  occlusion=occlusion)
        acc = evaluate_classification(state, ModelNet40(cfg, "test"), config)
        out[f"sweep_acc_l{i}"] = acc
        accs.append(acc)
        log.info("corruption level %d (jitter %.2f noise %.3f occl %.2f): acc %.4f",
                 i, jitter, noise, occlusion, acc)
    out["sweep_auc"] = float(np.mean(accs))
    return out


def evaluate_classification_ckpt(config: ExperimentConfig, ckpt_dir: str | None = None,
                                 ckpt_name: str | None = None, rotations: int = 4,
                                 state: TrainState | None = None, hard_tier: bool = True,
                                 cli_overrides: list[str] | None = None,
                                 corruption_sweep: bool = False,
                                 device: str | torch.device | None = None) -> dict:
    """Test-split accuracy of a trained classifier (the card unless
    `device` says otherwise): `acc`; with `hard_tier`, `acc_hard` on
    `hard_tier_dataset`; with `corruption_sweep`, `sweep_acc_l0..5` and
    `sweep_auc`; with `rotations` > 0, `rot_agree` and `logit_drift` of
    `rotation_consistency`. The model is `state`'s, or the checkpoint
    `ckpt_name` (`evaluate.ckpt_name`, else 'common') in `ckpt_dir`
    (`evaluate.ckpt_dir`, else `train.ckpt_dir`), built from its saved
    `model` config. The saved `dataset` config applies over `config`'s,
    and the `dataset.*` items of `cli_overrides` over both. `config` is
    not changed."""
    device = resolve_device(device)
    log = get_logger(config.name)
    config = dataclasses.replace(config, dataset=dataclasses.replace(config.dataset))
    if state is None:
        raw, snapshot = load_trained_state(
            ckpt_dir or config.evaluate.ckpt_dir or config.train.ckpt_dir,
            ckpt_name or config.evaluate.ckpt_name or "common")
        snap_model = dict(snapshot.get("model") or {})
        if snap_model:
            known = {f.name for f in dataclasses.fields(ModelConfig)}
            config.model = ModelConfig(**{k: v for k, v in snap_model.items() if k in known})
        for key, value in (snapshot.get("dataset") or {}).items():
            if hasattr(config.dataset, key):
                setattr(config.dataset, key, value)
        model = build_model(config)
        model.load_state_dict(raw["model"])
        state = TrainState(model.to(device), None, None, step=int(raw["step"]))
    if cli_overrides:
        apply_overrides(config, [o for o in cli_overrides
                                 if o.lstrip("-").startswith("dataset.")])
    test = ModelNet40(config.dataset, "test")
    results = {"acc": evaluate_classification(state, test, config)}
    if hard_tier:
        results["acc_hard"] = evaluate_classification(
            state, ModelNet40(hard_tier_dataset(config.dataset), "test"), config)
    if corruption_sweep:
        results.update(_corruption_sweep(state, config, log))
    if rotations > 0:
        results.update(rotation_consistency(state, test, num_rotations=rotations,
                                            seed=config.seed))
    log.info("classification eval: %s", results)
    return results

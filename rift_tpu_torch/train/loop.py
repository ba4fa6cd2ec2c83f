"""Classification training and validation, twin of `rift_tpu/train/loop.py`
(`build_model`, `train`, `run_meters`, `update_best`, `_improved`,
`evaluate_classification`) on one card.

Not ported yet (ROADMAP): the data-parallel step (`make_distributed_step`),
the in-training registration probe, `train_segmentation`, and
`evaluate_classification_ckpt`.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..data.modelnet40 import get_datasets
from ..device import resolve_device
from ..models import PVCNNClassifier
from .checkpoint import CheckpointManager
from .config import ExperimentConfig
from .meters import MeterClassification
from .steps import TrainState, create_state, eval_step, train_step
from .utils import MetricWriter, get_logger


def build_model(config: ExperimentConfig) -> PVCNNClassifier:
    m = config.model
    if m.with_transform_fine_tune or m.use_new_coords_for_voxel or m.dtype:
        raise NotImplementedError("with_transform_fine_tune, use_new_coords_for_voxel and "
                                  "dtype are not ported yet")
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
        local_neighbors=m.local_neighbors)


def _improved(new: float, old: float | None) -> bool:
    """Strict improvement of a higher-is-better metric: a tie does not
    re-save the checkpoint."""
    return old is None or new > old


def update_best(best: dict, results: dict, ckpt: CheckpointManager, state: TrainState,
                config: ExperimentConfig) -> None:
    """Per-metric best tracking, saving a `best_{name}` checkpoint per
    improved metric."""
    for name, value in results.items():
        if _improved(float(value), best.get(name)):
            best[name] = float(value)
            ckpt.save_best(name, state, best, config)


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


def train(config: ExperimentConfig, resume: bool = True, meters: dict | None = None,
          device: str | torch.device | None = None) -> dict:
    """Classification training on one device (the card unless `device` says
    otherwise): per epoch, `steps_per_epoch` updates, then every
    `valid_interval` epochs the `meters` ({name: factory} of meters whose
    scalar is higher-is-better; default {'acc': MeterClassification}) on
    the valid split, best checkpoints per improved metric and the rolling
    `common` checkpoint. With `resume`,
    continues from `common` in `ckpt_dir`. Returns {'state', 'best',
    'loss'} (loss: the last epoch's mean train loss)."""
    if config.train.half_precision or config.train.reg_probe_interval:
        raise NotImplementedError("half_precision and the registration probe are not "
                                  "ported yet")
    device = resolve_device(device)
    log = get_logger(config.name)
    writer = MetricWriter(config.train.ckpt_dir, config.name)
    datasets = get_datasets(config.dataset)
    meters = meters or {"acc": MeterClassification}

    steps_per_epoch = max(len(datasets["train"]) // config.train.batch_size, 1)
    if config.train.steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, config.train.steps_per_epoch)
    state = create_state(build_model(config), config, steps_per_epoch, device,
                         seed=config.seed)

    ckpt = CheckpointManager(config.train.ckpt_dir)
    best: dict = {}
    start_epoch = 0
    if resume:
        restored = ckpt.restore(state)
        if restored is not None:
            best = restored
            start_epoch = state.step // steps_per_epoch
            log.info("resumed from step %d (epoch %d)", state.step, start_epoch)

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
            generator.manual_seed(config.seed * 1_000_003 + state.step)
            metrics.append(train_step(state, torch.as_tensor(clouds, device=device),
                                      torch.as_tensor(labels, device=device), generator))
        loss = float(np.mean([float(m["loss"]) for m in metrics]))
        acc = float(np.mean([float(m["acc"]) for m in metrics]))
        writer.write(step=state.step, epoch=epoch, split="train", loss=loss, acc=acc,
                     sec=time.time() - t0)
        log.info("epoch %d: loss %.4f acc %.4f (%.1fs)", epoch, loss, acc, time.time() - t0)

        if (epoch + 1) % config.train.valid_interval == 0:
            results = {k: float(v) for k, v in
                       run_meters(state, datasets["valid"], config, meters).items()}
            writer.write(step=state.step, epoch=epoch, split="valid", **results)
            log.info("epoch %d: valid %s", epoch, results)
            update_best(best, results, ckpt, state, config)
            ckpt.save_common(state, best, config)
    return {"state": state, "best": best, "loss": loss}

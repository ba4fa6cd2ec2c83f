"""Driver: `rift_tpu_torch.train.steps.train_step(state, clouds, labels,
generator)` on the part segmentation model of
`rift_tpu_torch.train.loop.build_seg_model`, one update on one card: the
train-mode forward, the mean cross-entropy over every point of the batch,
its backward and Adam (`make_optimizer` with the configuration's `optim`
block). A call is one step on a batch of the traffic's part-labelled clouds
(`seg_clouds.py`: [batch, points, 22] with labels [batch, points]).

Set-up is `training.py`'s with these inputs and this model; the reference
is `reference/rift_ref/models/shapenet.py:ShapeNetPVCNN` under
`TrainReference`, and the comparison (`loss1_gap`, `grad_gap_median`,
`update_gap`, `bn_stats_gap`) is `TrainingCell.check`'s.
"""
from __future__ import annotations

import time
import types

import numpy as np
import torch

from benchmark import reference, seg_clouds, weights
from benchmark.reference.rift_ref.models.shapenet import ShapeNetPVCNN
from benchmark.training import TrainingCell

# The reference's fields read from the configuration's `model` block.
REF_KEYS = ("num_classes", "num_shapes", "point_kernel_formal", "voxel_shape",
            "width_multiplier", "voxel_resolution_multiplier", "rot_invariant_preprocess",
            "local_radius", "local_neighbors", "local_fuse_dim", "in_channels", "dropout")


class Cell(TrainingCell):
    def __init__(self, ctx):
        tr, cfg = ctx.spec.traffic, ctx.spec.config
        self.ctx = ctx
        self.device = ctx.device
        self.batch, self.pool = tr["batch"], tr["pool"]
        self.units_per_call = self.batch
        self.config = cfg
        self.limits = ctx.spec.limits
        t0 = time.perf_counter()
        clouds, labels = seg_clouds.seg_clouds(ctx.seed, self.pool * self.batch, tr["points"],
                                               cfg["dataset"]["max_degree"])
        self.clouds = torch.from_numpy(clouds).to(self.device).view(
            self.pool, self.batch, tr["points"], clouds.shape[-1])
        self.labels = torch.from_numpy(labels).to(self.device).view(
            self.pool, self.batch, tr["points"])
        self.dropout_seed = int(np.random.SeedSequence([int(ctx.seed) % 2 ** 63, 11])
                                .generate_state(1)[0])
        t1 = time.perf_counter()
        lower = cfg["lower_precision"] if ctx.program == "control" else None
        self.model, self.optimizer, self._step = self.make_step(lower)
        self.weights = weights.seeded_state(self.model, ctx.seed, self.device)
        self.model.load_state_dict(self.weights)
        self.model.to(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(self.dropout_seed)
        # The checked first steps, through the window's call: set-up's warm-up too.
        t2 = time.perf_counter()
        self.calls_in_setup = tr["checked_steps"]
        self.losses = []
        for i in range(self.calls_in_setup):
            self.losses.append(self.call(i))
            if i == 0:
                self.first_grad = self._first_moments()
        self.after = self._snapshot()
        self.setup_parts = {"inputs_s": t1 - t0, "model_and_weights_s": t2 - t1,
                            "checked_steps_s": time.perf_counter() - t2}

    def make_step(self, lower):
        if lower is not None:
            return self.reference_step(lower)
        from rift_tpu_torch.train.loop import build_seg_model
        from rift_tpu_torch.train.steps import TrainState, make_optimizer, train_step

        m = self.config["model"]
        model = build_seg_model(types.SimpleNamespace(model=types.SimpleNamespace(**m)),
                                in_channels=m["in_channels"])
        optimizer, schedule = make_optimizer(model, self.program_config(),
                                             self.config["train"]["steps_per_epoch"])
        state = TrainState(model, optimizer, schedule, self.config["optim"]["grad_clip"])

        def step(clouds, labels, generator):
            return train_step(state, clouds, labels, generator)["loss"]
        return model, optimizer, step

    def reference_step(self, lower):
        m = self.config["model"]
        model = ShapeNetPVCNN(blocks=tuple(tuple(b) for b in m["blocks"]),
                              with_local_feat=bool(m["with_local_feat"]),
                              **{k: m[k] for k in REF_KEYS})
        ref = reference.TrainReference(model, self.config["optim"],
                                       self.config["train"]["steps_per_epoch"])

        def step(clouds, labels, generator):
            with reference.lower_precision(lower):
                return ref.step(clouds, labels, generator)
        return model, ref.opt, step


def build(ctx) -> Cell:
    return Cell(ctx)

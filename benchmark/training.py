"""The training cells' common body.

Set-up makes a pool of `pool` distinct batches of `batch` labelled clouds
from the seed (`pairs.class_clouds`), builds one training state (the
configuration's classifier with seeded weights on the card, its Adam and
cosine rate) and drives it through its first `checked_steps` steps by the
window's own call, on batches whose rows all differ; the window then goes
on from there with the same object. A call is one step; it ends when the
step's loss is on the host. Dropout masks come from a card generator
seeded from the run's seed.

What those first steps leave is kept for the comparison: each step's
loss, the first gradient as the optimizer got it (Adam's first moment
after one step over 1 − β1, weight decay's term included), and the
parameters and BatchNorm statistics after the last checked step. After
the window the reference runs the same steps from the same weights,
batches and dropout seed. The numbers compared:

- `loss1_gap`: |loss − loss_ref| / |loss_ref| of the first step;
- `grad_gap_median`: the median leaf's |‖g‖ − ‖g_ref‖| / max(‖g_ref‖, the
  median leaf's ‖g_ref‖), of the first gradient;
- `update_gap`: the worst leaf's gap of the same kind of each parameter's
  change over the checked steps, over the leaves whose reference gradient
  is at least 1e-3 of the median leaf's (the others move under Adam by
  round-off alone);
- `bn_stats_gap`: the worst leaf's gap of each BatchNorm statistic's change.

The later steps' losses and the worst leaf's first gradient are kept as
diagnostics, not compared. Adam's first steps move every element by about
±lr whatever its gradient's size, so an element whose gradient is nought
to rounding takes either sign by rounding, and the loss after them swings
from seed to seed by far more than f32 rounding; the worst leaf of the
first gradient is as a rule a PVConv's scalar coefficient, a sum over
every point whose terms nearly cancel.

A driver subclasses `TrainingCell` with `make_step`: the program's step
on a global batch (or the control's: the reference in the configuration's
lower precision).
"""
from __future__ import annotations

import time
import types

import numpy as np
import torch

from benchmark import common, pairs, reference, weights

BETA1 = 0.9


class TrainingCell:
    def __init__(self, ctx):
        tr, cfg = ctx.spec.traffic, ctx.spec.config
        self.ctx = ctx
        self.device = ctx.device
        self.batch, self.pool = tr["batch"], tr["pool"]
        self.units_per_call = self.batch
        self.config = cfg
        self.limits = ctx.spec.limits
        self.model_kw = common.model_kwargs(cfg["model"])
        ds = cfg["dataset"]
        t0 = time.perf_counter()
        clouds, labels = pairs.class_clouds(ctx.seed, self.pool * self.batch, tr["points"],
                                            ds["max_degree"], ds["max_amp"])
        self.clouds = torch.from_numpy(clouds).to(self.device).view(
            self.pool, self.batch, tr["points"], 6)
        self.labels = torch.from_numpy(labels).to(self.device).view(self.pool, self.batch)
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

    def make_step(self, lower: str | None):
        """(model, optimizer, step(clouds, labels, generator) -> loss tensor)
        of the program, or with `lower` of the reference in its place."""
        raise NotImplementedError

    def reference_step(self, lower: str | None):
        """(model, optimizer, step) of the reference on one device."""
        model = reference.PVCNNClassifier(**self.model_kw)
        ref = reference.TrainReference(model, self.config["optim"],
                                       self.config["train"]["steps_per_epoch"])

        def step(clouds, labels, generator):
            with reference.lower_precision(lower):
                return ref.step(clouds, labels, generator)
        return model, ref.opt, step

    def program_config(self):
        """The configuration's `optim` block as the port's `make_optimizer`
        reads it."""
        return types.SimpleNamespace(optim=types.SimpleNamespace(**self.config["optim"]))

    def call(self, i: int) -> float:
        k = i % self.pool
        return float(self._step(self.clouds[k], self.labels[k], self.generator))

    def _first_moments(self) -> dict:
        # A step that made no update leaves no moment: its gradient reads 0.
        return {name: self.optimizer.state[p].get("exp_avg", torch.zeros_like(p)).detach()
                / (1.0 - BETA1) for name, p in self.model.named_parameters()}

    def _snapshot(self) -> dict:
        return {name: v.detach().clone() for name, v in self.model.state_dict().items()}

    def release(self) -> None:
        del self.model, self.optimizer, self._step

    def check(self) -> list[common.Check]:
        model, optimizer, step = self.reference_step(None)
        model.load_state_dict(self.weights)
        model.to(self.device)
        self.model, self.optimizer = model, optimizer
        gen = torch.Generator(device=self.device).manual_seed(self.dropout_seed)
        ref_losses = []
        for i in range(self.calls_in_setup):
            k = i % self.pool
            ref_losses.append(float(step(self.clouds[k], self.labels[k], gen)))
            if i == 0:
                ref_grad = self._first_moments()
        ref_after = self._snapshot()
        loss_gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(self.losses, ref_losses)]
        grads = common.leaf_gaps(self.first_grad, ref_grad)
        params = dict(model.named_parameters())
        change = {k: self.after[k] - self.weights[k] for k in params}
        ref_change = {k: ref_after[k] - self.weights[k] for k in params}
        updates = common.leaf_gaps(change, ref_change, common.moved_leaves(ref_grad))
        stats = {k for k in ref_after if k.endswith("running_mean") or k.endswith("running_var")}
        bns = common.leaf_gaps({k: self.after[k] - self.weights[k] for k in stats},
                               {k: ref_after[k] - self.weights[k] for k in stats})
        self.diagnostics = {
            "loss_gaps": loss_gaps, "grad_gap_worst": common.worst(grads),
            **{f"{n}_worst_leaf": max(g, key=g.get) for n, g in
               (("grad", grads), ("update", updates), ("bn", bns))},
            **{f"{n}_median_leaf": float(np.median(list(g.values()))) for n, g in
               (("grad", grads), ("update", updates), ("bn", bns))}}
        lim = self.limits
        return [common.Check("loss1_gap", loss_gaps[0], lim["loss1_gap"]),
                common.Check("grad_gap_median", float(np.median(list(grads.values()))),
                             lim["grad_gap_median"]),
                common.Check("update_gap", common.worst(updates), lim["update_gap"]),
                common.Check("bn_stats_gap", common.worst(bns), lim["bn_stats_gap"])]

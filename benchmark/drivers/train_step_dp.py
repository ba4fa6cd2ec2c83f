"""Driver: the data-parallel step of
`rift_tpu_torch.parallel.sharded_ops.make_sharded_train_step`, one process
a card over NCCL: each rank takes its equal share of the global batch,
BatchNorm normalizes with the global batch's statistics and dropout draws
the global batch's mask, the gradients are all-reduced before the shared
Adam update, and the loss is averaged over the ranks. A call is one step
of the global batch; rank 0's window is timed between barriers. The
comparison (`training.py`) runs on rank 0 against the reference's step on
the whole global batch on one card."""
from __future__ import annotations

from benchmark.training import TrainingCell


class Cell(TrainingCell):
    def make_step(self, lower):
        if lower is not None:
            return self.reference_step(lower)
        from rift_tpu_torch.models.pvcnn import PVCNNClassifier
        from rift_tpu_torch.parallel.sharded_ops import make_sharded_train_step
        from rift_tpu_torch.train.steps import TrainState, make_optimizer

        rank, world = self.ctx.rank, self.ctx.world
        share = self.batch // world
        model = PVCNNClassifier(**self.model_kw)
        optimizer, schedule = make_optimizer(model, self.program_config(),
                                             self.config["train"]["steps_per_epoch"])
        state = TrainState(model, optimizer, schedule, self.config["optim"]["grad_clip"])
        sharded = make_sharded_train_step(self.ctx.group)
        rows = slice(rank * share, (rank + 1) * share)

        def step(clouds, labels, generator):
            return sharded(state, clouds[rows], labels[rows], generator)["loss"]
        return model, optimizer, step


def build(ctx) -> Cell:
    return Cell(ctx)

"""Driver: `rift_tpu_torch.train.steps.train_step(state, clouds, labels,
generator)`, one update of the configuration's classifier on one card:
the train-mode forward, the mean cross-entropy, its backward and Adam
(`make_optimizer` with the configuration's `optim` block). A call is one
step on a batch of the traffic's labelled clouds; `training.py` holds the
rest and the comparison."""
from __future__ import annotations

from benchmark.training import TrainingCell


class Cell(TrainingCell):
    def make_step(self, lower):
        if lower is not None:
            return self.reference_step(lower)
        from rift_tpu_torch.models.pvcnn import PVCNNClassifier
        from rift_tpu_torch.train.steps import TrainState, make_optimizer, train_step

        model = PVCNNClassifier(**self.model_kw)
        optimizer, schedule = make_optimizer(model, self.program_config(),
                                             self.config["train"]["steps_per_epoch"])
        state = TrainState(model, optimizer, schedule, self.config["optim"]["grad_clip"])

        def step(clouds, labels, generator):
            return train_step(state, clouds, labels, generator)["loss"]
        return model, optimizer, step


def build(ctx) -> Cell:
    return Cell(ctx)

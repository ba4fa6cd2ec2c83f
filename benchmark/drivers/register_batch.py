"""Driver: `rift_tpu_torch.registration.pipeline.register_batch(model, src,
dst)`, the reference benchmark's registration path: normals of the 2b
clouds, one forward, mutual-NN matches, GNC-TLS (with the configuration's
`register` block: noise bound and early exit). A call is one batch of the
traffic's noise pairs; `registration.py` holds the rest and the
comparison."""
from __future__ import annotations

from benchmark import common, reference
from benchmark.registration import RegistrationCell


class Cell(RegistrationCell):
    def __init__(self, ctx):
        reg = ctx.spec.config["register"]
        self.noise_bound, self.early_exit = reg["noise_bound"], reg["early_exit"]
        super().__init__(ctx, common.model_kwargs(ctx.spec.config["model"]))

    def make_program(self, lower):
        if lower is None:
            from rift_tpu_torch.models.pvcnn import PVCNNClassifier
            from rift_tpu_torch.registration.pipeline import register_batch

            model = PVCNNClassifier(**self.model_kw)

            def run(s, d):
                return register_batch(model, s, d, device=self.device,
                                      early_exit=self.early_exit)
            return model, run
        model = reference.PVCNNClassifier(**self.model_kw)

        def run(s, d):
            with reference.lower_precision(lower):
                return reference.register_batch(model, s, d, self.noise_bound, self.early_exit)
        return model, run

    def reference_features(self, model, x):
        return reference.features(model, x)

    def reference_pose(self, src, dst, feats):
        return reference.register_from_features(src, dst, feats, self.noise_bound,
                                                self.early_exit)


def build(ctx) -> Cell:
    return Cell(ctx)

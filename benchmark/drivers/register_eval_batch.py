"""Driver: `rift_tpu_torch.train.loop.register_eval_batch(model, src, dst,
evaluate)`, the flagship's registration evaluation: normals of the 2b
clouds, one [5b, n, 6] forward (each source under its 4 LRF flips, then
the targets), consensus matching and TEASER, as the configuration's
`evaluate` block sets them. The model is the trunk as the feature
extractor (`is_classify` off; with `canonical_voxel` the voxel grid in
the LRF frame, as `train/loop.py:extractor_from_snapshot` builds it). A
call is one batch of the traffic's noise pairs; `registration.py` holds
the rest and the comparison."""
from __future__ import annotations

import dataclasses

import torch

from benchmark import common, reference
from benchmark.registration import RegistrationCell


class Cell(RegistrationCell):
    def __init__(self, ctx):
        self.evaluate = ev = ctx.spec.config["evaluate"]
        self.noise_bound = ev["noise_bound"]
        super().__init__(ctx, common.model_kwargs(
            ctx.spec.config["model"], is_classify=False,
            use_new_coords_for_voxel=bool(ev["canonical_voxel"])))

    def make_program(self, lower):
        if lower is None:
            from rift_tpu_torch.models.pvcnn import PVCNNClassifier
            from rift_tpu_torch.train.config import EvalConfig
            from rift_tpu_torch.train.loop import register_eval_batch

            known = {f.name for f in dataclasses.fields(EvalConfig)}
            evaluate = EvalConfig(**{k: v for k, v in self.evaluate.items() if k in known})
            model = PVCNNClassifier(**self.model_kw)

            def run(s, d):
                return register_eval_batch(model, s, d, evaluate)
            return model, run
        model = reference.PVCNNClassifier(**self.model_kw)

        def run(s, d):
            with reference.lower_precision(lower):
                return reference.register_eval_batch(model, s, d, self.noise_bound)
        return model, run

    def reference_normals(self, nrm):
        b = self.b  # the forward's inputs: each source 4 times, then the targets
        return torch.cat([nrm[:b].repeat_interleave(4, dim=0), nrm[b:]], 0)

    def reference_features(self, model, x):
        return reference.flip_features(model, x, self.b)

    def reference_pose(self, src, dst, feats):
        return reference.teaser_from_features(src, dst, feats, self.noise_bound)


def build(ctx) -> Cell:
    return Cell(ctx)

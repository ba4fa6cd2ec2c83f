"""The registration cells' common body: a pool of noise-pair batches made from
the seed, the model of the configuration with seeded weights on the card,
one call a batch that ends when the transforms are on the host, and the
comparison of the sampled calls with the reference.

A driver subclasses `RegistrationCell` with `make_program` (the program's
or the control's call on a batch), `reference_features` and
`reference_pose`. Hooks on the model hold, for `check_calls` calls drawn
from the seed among the window's first `check_among`, the forward's input
(the normals the program estimated) and output (the features); the
transforms are the call's result. The numbers compared:

- `normals_off`: the share of points whose normal lies more than 1° from
  the reference's, from the same clouds;
- `features_rel_median`: the median cloud's ‖f − f_ref‖ / ‖f_ref‖, the
  reference's features worked out from the clouds, its own normals and
  the weights (the worst cloud's swings from seed to seed: a point whose
  normal lies nearly across its direction to the origin takes either
  orientation by rounding, and its PPF features with it);
- `features_off`: the share of the forward's clouds whose ‖f − f_ref‖ /
  ‖f_ref‖ exceeds the limits file's `features_cloud_rel`, so that a
  minority of wrong clouds (the targets, a later tile of the batch) fails
  where the median cannot see it;
- `pose_gap`: the largest entry of |T − T_ref| over the pairs, the
  reference's matching and solve run on the program's features.
"""
from __future__ import annotations

import math
import time

import torch

from benchmark import common, pairs, reference, weights

# Per-cloud gaps at which the share of clouds over them is kept beside the
# checks: `control.py`'s readings, from which `features_cloud_rel` and the
# `features_off` limit are set.
CLOUD_GAPS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 5e-2, 1e-1)


def _share_over(gaps: torch.Tensor, limit: float) -> float:
    """The share of clouds whose gap exceeds `limit`; a gap that is not
    finite counts as over."""
    return float((~(gaps <= limit)).double().mean())


class RegistrationCell:
    def __init__(self, ctx, model_kw: dict):
        tr, cfg = ctx.spec.traffic, ctx.spec.config
        self.device = ctx.device
        self.b, self.n, self.pool = tr["pairs"], tr["points"], tr["pool"]
        self.units_per_call = self.b
        self.model_kw = model_kw
        t0 = time.perf_counter()
        src, dst = pairs.noise_pairs(ctx.seed, self.pool * self.b, self.n, tr["max_degree"],
                                     tr["max_amp"], tr["noise_sigma"], tr["noise_clip"])
        shape = (self.pool, self.b, self.n, 3)
        self.src = torch.from_numpy(src).to(self.device).view(shape)
        self.dst = torch.from_numpy(dst).to(self.device).view(shape)
        self.sample = set(common.check_sample(ctx.seed, tr["check_among"], tr["check_calls"]))
        self.limits = ctx.spec.limits
        self.captured: dict[int, dict] = {}
        self._current = None
        t1 = time.perf_counter()
        lower = cfg["lower_precision"] if ctx.program == "control" else None
        model, self._run = self.make_program(lower)
        self.weights = weights.seeded_state(model, ctx.seed, self.device)
        model.load_state_dict(self.weights)
        self.model = model.to(self.device).eval()
        self._hook = self.model.register_forward_hook(self._capture)
        t2 = time.perf_counter()
        self.call(-1)  # warm-up: the kernels' build, cuDNN's choice, the allocator
        self.setup_parts = {"inputs_s": t1 - t0, "model_and_weights_s": t2 - t1,
                            "warm_up_s": time.perf_counter() - t2}

    def make_program(self, lower: str | None):
        """(model, run(src, dst) -> transforms): the program's entry, or with
        `lower` the reference in that precision in its place."""
        raise NotImplementedError

    def reference_features(self, model, x: torch.Tensor) -> torch.Tensor:
        """The reference's features of the forward the program ran on x
        [2b, n, 6]."""
        raise NotImplementedError

    def reference_normals(self, nrm: torch.Tensor) -> torch.Tensor:
        """The normals of the forward's inputs from those of the 2b clouds."""
        return nrm

    def reference_pose(self, src, dst, feats: torch.Tensor) -> torch.Tensor:
        """The reference's transforms from the program's features."""
        raise NotImplementedError

    def _capture(self, module, args, output):
        # A forward run in blocks of clouds (the control's) is held block by block.
        if self._current is not None:
            self._current.setdefault("normals", []).append(args[0][..., 3:6])
            self._current.setdefault("features", []).append(output)

    def call(self, i: int) -> None:
        self._current = {} if i in self.sample else None
        k = i % self.pool
        transforms = self._run(self.src[k], self.dst[k]).cpu()
        if self._current is not None:
            self._current = {"batch": k, "transforms": transforms,
                             "normals": torch.cat(self._current["normals"]),
                             "features": torch.cat(self._current["features"])}
            self.captured[i] = self._current
        self._current = None

    def release(self) -> None:
        self._hook.remove()
        del self.model, self._run

    def check(self) -> list[common.Check]:
        if not self.captured:
            return [common.Check("sampled_calls", 0.0, -1.0)]
        model = reference.PVCNNClassifier(**self.model_kw)
        model.load_state_dict(self.weights)
        model = model.to(self.device).eval()
        lim = self.limits
        normals_off = features_rel = features_off = pose_gap = 0.0
        self.diagnostics = {"features_rel_worst": [], "normals_worst_deg": [],
                            "features_off_at": []}
        for got in self.captured.values():
            src, dst = self.src[got["batch"]], self.dst[got["batch"]]
            clouds = torch.cat([src, dst], 0)
            nrm = reference.normals(clouds)
            cos = (got["normals"].double() * self.reference_normals(nrm).double()).sum(-1)
            normals_off = max(normals_off, float((cos < math.cos(math.radians(1.0)))
                                                 .double().mean()))
            self.diagnostics["normals_worst_deg"].append(
                math.degrees(math.acos(float(cos.clamp(-1.0, 1.0).min()))))
            feats = self.reference_features(model, torch.cat([clouds, nrm], -1))
            gaps = common.rel_gaps(got["features"], feats)
            features_rel = max(features_rel, float(gaps.median()))
            features_off = max(features_off, _share_over(gaps, lim["features_cloud_rel"]))
            self.diagnostics["features_rel_worst"].append(float(gaps.max()))
            self.diagnostics["features_off_at"].append(
                {g: _share_over(gaps, g) for g in CLOUD_GAPS})
            del feats
            t_ref = self.reference_pose(src, dst, got["features"].float())
            pose_gap = max(pose_gap, float((got["transforms"].double()
                                            - t_ref.cpu().double()).abs().max()))
        return [common.Check("normals_off", normals_off, lim["normals_off"]),
                common.Check("features_rel_median", features_rel, lim["features_rel_median"]),
                common.Check("features_off", features_off, lim["features_off"]),
                common.Check("pose_gap", pose_gap, lim["pose_gap"])]

"""Pieces the drivers share: the model's arguments from a configuration file,
the comparisons that decide `correct`, and the check-call sample."""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

MODEL_KEYS = ("dim_k", "num_classes", "point_kernel_formal", "voxel_shape", "with_coeff",
              "with_se", "extra_feature_channels", "width_multiplier",
              "voxel_resolution_multiplier", "is_classify", "rot_invariant_preprocess",
              "lrf_kind", "with_local_feat", "with_transform_fine_tune", "local_neighbors",
              "use_new_coords_for_voxel", "dtype")


def model_kwargs(model: dict, **overrides) -> dict:
    """`PVCNNClassifier`'s arguments from a configuration's `model` block
    (the port's and the reference's classes take the same)."""
    kw = {k: model[k] for k in MODEL_KEYS if k in model}
    kw["blocks"] = tuple(tuple(b) for b in model["blocks"])
    kw.update(overrides)
    return kw


@dataclass(frozen=True)
class Check:
    """One number compared with its limit: the run is correct where every
    value is finite and at most its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def check_sample(seed: int, among: int, count: int) -> list[int]:
    """The indices of the window's calls whose answers are compared: `count`
    of the first `among`, drawn from the seed."""
    state = np.random.SeedSequence([int(seed) % 2 ** 63, 7]).generate_state(1)[0]
    rs = np.random.RandomState(state)
    return sorted(int(i) for i in rs.choice(among, size=min(count, among), replace=False))


def rel_gaps(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """‖prog − ref‖ / ‖ref‖ of each row of the leading axis, in f64."""
    p, r = prog.double().flatten(1), ref.double().flatten(1)
    num = torch.linalg.vector_norm(p - r, dim=1)
    return num / torch.linalg.vector_norm(r, dim=1).clamp(min=1e-30)


def leaf_gaps(prog: dict, ref: dict, keep: set[str] | None = None) -> dict[str, float]:
    """Each leaf's gap of norms, |‖p‖ − ‖r‖| / max(‖r‖, the median leaf's
    ‖r‖), over the leaves in `keep` (all when None)."""
    names = [k for k in ref if keep is None or k in keep]
    ref_n = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in names}
    median = float(np.median(list(ref_n.values())))
    return {k: abs(float(torch.linalg.vector_norm(prog[k].double())) - ref_n[k])
            / max(ref_n[k], median, 1e-30) for k in names}


def worst(gaps: dict[str, float]) -> float:
    """The largest gap (inf where one is not finite)."""
    values = list(gaps.values())
    return max((v if math.isfinite(v) else math.inf for v in values), default=0.0)


def moved_leaves(grads: dict, floor: float = 1e-3) -> set[str]:
    """Leaves whose reference gradient norm is at least `floor` × the median
    leaf's: the others move under Adam by round-off alone."""
    norms = {k: float(torch.linalg.vector_norm(g.double())) for k, g in grads.items()}
    median = float(np.median(list(norms.values())))
    return {k for k, v in norms.items() if v >= floor * median}

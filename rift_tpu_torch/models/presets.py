"""Model presets: `bench_model` is `bench.py:_make_model`, the headline
model of the reference's registration benchmark.

    bench_model("dgcnn")     # the r1-r4 series model, sph_dg: the default
    bench_model("pointnet")  # the same trunk with the pointnet point branch

Spherical voxels at r = 32, blocks 64/128/256/512, the 'change_coords'
preprocess with the reference LRF and 4 global-PPF channels, local PPF with
k = 128, coefficient and SE, registration features (no head), bf16. The
weights are the module's initial ones; load a state dict or seed them.
"""
from __future__ import annotations

from .pvcnn import DEFAULT_BLOCKS, PVCNNClassifier


def bench_model(kernel: str = "dgcnn") -> PVCNNClassifier:
    return PVCNNClassifier(
        blocks=DEFAULT_BLOCKS, dim_k=512, is_classify=False,
        point_kernel_formal=kernel + "_kernel", voxel_shape="spherical",
        rot_invariant_preprocess="change_coords", lrf_kind="reference",
        with_local_feat="ppf", extra_feature_channels=4, local_neighbors=128,
        with_coeff=True, with_se=True, dtype="bfloat16")

"""Utilities (copies of `rift_tpu.utils`, numpy only): headless PLY export
and a PLY/PCD reader (`visualize`), and correspondence-pair hashing
(`pair_hash`). Besides, the port's own host code: the g++ build of
`csrc/host/*.cpp` (`host_build`) and the zstd decoder bound on it
(`zstd`), imported by their users only."""
from .pair_hash import filter_intersection, find_row, hash_pairs, hash_rows  # noqa: F401
from .visualize import (  # noqa: F401
    FRAG1_COLOR,
    FRAG2_COLOR,
    KEYPOINT_COLOR,
    LINE_COLOR,
    read_pcd_ply,
    save_correspondences_ply,
    save_pcd_ply,
    save_registration_ply,
)

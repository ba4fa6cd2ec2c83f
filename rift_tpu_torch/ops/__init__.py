"""Geometry ops (twins of `rift_tpu.ops`); CUDA kernels live in `ops/cuda/`.
The reference's public names import from here, but for the TPU shapes of
functions the port has in another form (`factored_vox`, the `*_fast`
voxel ops) and `ppf`, which stays the name of the module (its function
is `ops.ppf.ppf`)."""
from . import se3  # noqa: F401
from .frustum import frustum_pointnet_loss, get_box_corners_3d  # noqa: F401
from .losses import chamfer_distance, huber_loss, kl_loss  # noqa: F401
from .lrf import change_coords, global_lrf, local_lrf, pca_align  # noqa: F401
from .neighbors import (  # noqa: F401
    ball_group,
    ball_query,
    ball_query_group,
    bilateral_knn,
    grouping,
    knn,
    knn_select,
    mutual_nearest_neighbors,
    pairwise_sqdist,
    three_nn_interpolate,
)
from .normals import estimate_normals  # noqa: F401
from .ppf import global_ppf, local_ppf, new_ppf  # noqa: F401
from .sampling import furthest_point_sample, gather, random_choice  # noqa: F401
from .spherical import (  # noqa: F401
    spherical_avg_voxelize,
    spherical_trilinear_devoxelize,
    spherical_voxel_indices,
)
from .voxelize import avg_voxelize, scatter_mean, trilinear_devoxelize  # noqa: F401

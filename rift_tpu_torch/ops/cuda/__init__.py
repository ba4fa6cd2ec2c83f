"""The port's hand-written CUDA kernels (sources in `rift_tpu_torch/csrc/`):
K1 `normals_kernel.neighborhood_moments`, K2 `onehot_ops.scatter_mean`,
K3 `onehot_ops.corner_gather`, K4 `onehot_ops.corner_scatter`, K5
`conv3d.conv3d_same`. Each wrapper keeps its launch count in a plain
integer attribute, `launches`."""
from .conv3d import conv3d_same  # noqa: F401
from .normals_kernel import neighborhood_moments  # noqa: F401
from .onehot_ops import corner_gather, corner_scatter, scatter_mean  # noqa: F401


def kernel_wrappers() -> dict:
    """The wrappers by name, for reading and resetting their launch counts."""
    return {"normals_moments": neighborhood_moments,
            "scatter_mean": scatter_mean,
            "corner_gather": corner_gather,
            "corner_scatter": corner_scatter,
            "conv3d_same": conv3d_same}

"""Neural modules: SharedMLP, SE3d, PVConv (twins of `rift_tpu.nn`)."""
from .pvconv import PVConv, SE3d  # noqa: F401
from .shared_mlp import SharedMLP  # noqa: F401

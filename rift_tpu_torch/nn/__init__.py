"""Neural modules: SharedMLP, SE3d, PVConv and the PointNet++ modules
(twins of `rift_tpu.nn`), and flax's dropout with explicit draws."""
from .dropout import train_dropout  # noqa: F401
from .pointnet2 import PointNetAModule, PointNetFPModule, PointNetSAModule  # noqa: F401
from .pvconv import PVConv, SE3d  # noqa: F401
from .shared_mlp import SharedMLP  # noqa: F401

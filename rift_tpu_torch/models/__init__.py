"""Models: the PVCNN classifier and feature extractor (twin of
`rift_tpu.models.pvcnn`), the ShapeNet part segmentation PVCNN (of
`rift_tpu.models.shapenet`), the PointNet baselines (of
`rift_tpu.models.pointnet`) and `bench_model`, the twin of
`bench.py:_make_model`."""
from .pointnet import PointNet, PointNetClassifier  # noqa: F401
from .presets import bench_model  # noqa: F401
from .pvcnn import DEFAULT_BLOCKS, PVCNNClassifier  # noqa: F401
from .shapenet import DEFAULT_SEG_BLOCKS, ShapeNetPVCNN  # noqa: F401

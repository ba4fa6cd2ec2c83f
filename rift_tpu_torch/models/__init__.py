"""Models: the PVCNN feature extractor (twin of `rift_tpu.models.pvcnn`)
and `bench_model`, the twin of `bench.py:_make_model`."""
from .presets import bench_model  # noqa: F401
from .pvcnn import DEFAULT_BLOCKS, PVCNNClassifier  # noqa: F401

"""Models: the PVCNN feature extractor (twin of `rift_tpu.models.pvcnn`)."""
from .pvcnn import DEFAULT_BLOCKS, PVCNNClassifier  # noqa: F401

"""rift_tpu_torch — the PyTorch/CUDA twin of `rift_tpu`.

Registers point-cloud pairs on an NVIDIA H100 (normals, the PVCNN
rotation-invariant feature extractor on a spherical or cube voxel grid,
mutual-NN or flip-hypothesis consensus matching, and the robust solvers:
GNC-TLS/TEASER, RANSAC, FGR and ICP), trains the PVCNN classifier and the
ShapeNet part segmentation PVCNN (`train/`), and has the reference's
PointNet and PointNet++ modules. The layout mirrors `rift_tpu/` module by
module. Every kernel that `rift_tpu` wrote in Pallas for the TPU is a
CUDA C++ kernel under `csrc/`, built with `nvcc` at its first CUDA
launch (`ops/cuda/build.py`), so importing this package needs no
compiler and no JAX.

Entry points take `device=None`, which means the CUDA card; they raise when
there is none. Pass `device="cpu"` to run the plain PyTorch versions.
"""
from .device import resolve_device  # noqa: F401

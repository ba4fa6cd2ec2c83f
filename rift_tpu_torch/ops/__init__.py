"""Geometry ops (twins of `rift_tpu.ops`); CUDA kernels live in `ops/cuda/`."""

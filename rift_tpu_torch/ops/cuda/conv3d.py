"""K5, the 3×3×3 SAME Conv3d of the bf16 eval voxel branch (CUDA kernel and
plain version).

Twin of `scripts/conv3d_kernel_experiment.py:conv3d_same_pallas`: a
channels-last grid x [b, r, r, r, cin] (axes γ, α, β) and a Conv3d weight,
bf16 × bf16 products summed in f32, rounded once to bf16, zero padding on
all three axes, no bias. The weight is the port's `nn.Conv3d` layout
[cout, cin, 3, 3, 3]; tap (i, j, k) reads x at offset (i, j, k) − 1 with
w[:, :, i, j, k], the flax kernel [i, j, k, cin, cout] through
`weights.from_flax`. The kernel is `csrc/conv3d.cu`; the wrapper launches
it for CUDA tensors and takes the plain version only for CPU tensors.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from ..precision import f32_geometry
from . import build

Tensor = torch.Tensor

CIN_STEP = 16  # the kernel stages input channels 16 at a time (one MMA depth)
COUT_STEP = 64  # and computes 64 output channels per block
KERNEL_RESOLUTIONS = (16, 32, 64, 128)  # r with 128 voxels = whole β rows of one γ


def _check(x: Tensor, w: Tensor) -> None:
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"conv3d_same takes bf16 x and w, got {x.dtype} and {w.dtype}")
    if x.dim() != 5 or not x.shape[1] == x.shape[2] == x.shape[3]:
        raise ValueError(f"x must be [b, r, r, r, cin], got {tuple(x.shape)}")
    if w.dim() != 5 or tuple(w.shape[2:]) != (3, 3, 3) or w.shape[1] != x.shape[-1]:
        raise ValueError(f"w must be [cout, {x.shape[-1]}, 3, 3, 3], got {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3d_same takes contiguous x and w")
    if w.device != x.device:
        raise ValueError(f"x is on {x.device}, w on {w.device}")


def conv3d_same_plain(x: Tensor, w: Tensor) -> Tensor:
    """Plain PyTorch version of K5: the bf16 inputs upcast to f32 (every
    bf16 product is exact in f32), one f32 convolution with TF32 off, and
    the result rounded to bf16."""
    with f32_geometry():
        y = F.conv3d(x.permute(0, 4, 1, 2, 3).float(), w.float(), padding=1)
    return y.permute(0, 2, 3, 4, 1).to(torch.bfloat16).contiguous()


def _weight_taps(w: Tensor) -> Tensor:
    """[cout, cin, 3, 3, 3] -> the kernel's [27, cin_p, cout_p], tap
    (i·3 + j)·3 + k, zero-padded to cin_p = 16·⌈cin/16⌉, cout_p = 64·⌈cout/64⌉."""
    cout, cin = w.shape[:2]
    cin_p = -(-cin // CIN_STEP) * CIN_STEP
    cout_p = -(-cout // COUT_STEP) * COUT_STEP
    taps = w.permute(2, 3, 4, 1, 0).reshape(27, cin, cout)
    return F.pad(taps, (0, cout_p - cout, 0, cin_p - cin)).contiguous()


def conv3d_same(x: Tensor, w: Tensor) -> Tensor:
    """K5. x [b, r, r, r, cin] bf16 channels-last, w [cout, cin, 3, 3, 3]
    bf16 -> [b, r, r, r, cout] bf16. CPU tensors: the plain version; CUDA
    tensors: the kernel (r in 16, 32, 64, 128)."""
    _check(x, w)
    if x.device.type == "cpu":
        return conv3d_same_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, r = x.shape[:2]
    cin, cout = x.shape[-1], w.shape[0]
    if r not in KERNEL_RESOLUTIONS:
        raise ValueError(f"the conv3d kernel takes r in {KERNEL_RESOLUTIONS}, got {r}")
    lib = build.load()
    taps = _weight_taps(w)
    out = torch.empty((b, r, r, r, cout), dtype=torch.bfloat16, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(lib.rift_conv3d_same(x.data_ptr(), taps.data_ptr(), out.data_ptr(), b, r, cin,
                                     taps.shape[1], cout, taps.shape[2], stream),
                "rift_conv3d_same")
    conv3d_same.launches += 1
    return out


conv3d_same.launches = 0

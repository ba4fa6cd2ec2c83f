"""K5, the 3×3×3 SAME Conv3d of the bf16 eval voxel branch (CUDA kernel and
plain version).

Twin of `scripts/conv3d_kernel_experiment.py:conv3d_same_pallas`: a
channels-last grid x [b, r, r, r, cin] (axes γ, α, β) and a Conv3d weight,
bf16 × bf16 products summed in f32, rounded once to bf16, zero padding on
all three axes, no bias. The weight is the port's `nn.Conv3d` layout
[cout, cin, 3, 3, 3]; tap (i, j, k) reads x at offset (i, j, k) − 1 with
w[:, :, i, j, k], the flax kernel [i, j, k, cin, cout] through
`weights.from_flax`. The kernel is `csrc/conv3d.cu` (TMA + wgmma); the
wrapper launches it for CUDA tensors and takes the plain version only for
CPU tensors.

The kernel reads x through a TMA tensor map, whose strides must be
multiples of 16 bytes: x may be a channels-last view whose voxel stride is
cin rounded up to 8 (`padded_bf16` makes one in the same pass as a cast
to bf16, as the bf16 voxel branch does); any other x is copied into such
a layout first, one extra pass over it.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from ..precision import f32_geometry
from . import build

Tensor = torch.Tensor

CIN_STEP = 16  # the kernel loads input channels 16 at a time (one MMA depth)
VOXEL_STEP = 8  # x's voxel stride in elements: a multiple of 16 bytes for TMA
KERNEL_RESOLUTIONS = (16, 32, 64, 128)  # r whose tiles hold 128 voxels a γ plane (whole β rows)


def _voxel_stride(x: Tensor) -> int | None:
    """x's voxel stride in elements if x is channels-last with unit channel
    stride and dense voxels ([b, r, r, r] row-major over that stride), else
    None."""
    s = x.stride()
    r, cs = x.shape[1], s[3]
    if s[4] != 1 and x.shape[4] > 1:
        return None
    if cs < x.shape[4] or s[2] != r * cs or s[1] != r * r * cs or (x.shape[0] > 1
                                                                     and s[0] != r ** 3 * cs):
        return None
    return cs


def _check(x: Tensor, w: Tensor) -> None:
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"conv3d_same takes bf16 x and w, got {x.dtype} and {w.dtype}")
    if x.dim() != 5 or not x.shape[1] == x.shape[2] == x.shape[3]:
        raise ValueError(f"x must be [b, r, r, r, cin], got {tuple(x.shape)}")
    if w.dim() != 5 or tuple(w.shape[2:]) != (3, 3, 3) or w.shape[1] != x.shape[-1]:
        raise ValueError(f"w must be [cout, {x.shape[-1]}, 3, 3, 3], got {tuple(w.shape)}")
    if _voxel_stride(x) is None or not w.is_contiguous():
        raise ValueError("conv3d_same takes contiguous w and x contiguous up to a padded "
                         "voxel stride (channels-last, unit channel stride)")
    if w.device != x.device:
        raise ValueError(f"x is on {x.device}, w on {w.device}")


def conv3d_same_plain(x: Tensor, w: Tensor) -> Tensor:
    """Plain PyTorch version of K5: the bf16 inputs upcast to f32 (every
    bf16 product is exact in f32), one f32 convolution with TF32 off, and
    the result rounded to bf16."""
    with f32_geometry():
        y = F.conv3d(x.permute(0, 4, 1, 2, 3).float(), w.float(), padding=1)
    return y.permute(0, 2, 3, 4, 1).to(torch.bfloat16).contiguous()


def padded_bf16(x: Tensor) -> Tensor:
    """x [b, r, r, r, c] (any type) as bf16 in a buffer whose voxel stride is
    c rounded up to VOXEL_STEP, returned as the [b, r, r, r, c] view: the
    layout K5 loads by TMA, written in one pass. The pad channels are never
    read."""
    c = x.shape[-1]
    cs = -(-c // VOXEL_STEP) * VOXEL_STEP
    buf = torch.empty((*x.shape[:-1], cs), dtype=torch.bfloat16, device=x.device)
    view = buf[..., :c]
    view.copy_(x)
    return view


def tile_width(cout: int) -> int:
    """Output channels a block computes at once (the MMA's N): all of cout
    up to 128, 64 for cout <= 64."""
    return 64 if cout <= 64 else 128


def _weight_taps(w: Tensor) -> Tensor:
    """[cout, cin, 3, 3, 3] -> the kernel's [27, cout_p, cin_p] (K-major
    taps), tap (i·3 + j)·3 + k holding w[:, :, i, j, k], zero-padded to
    cin_p = 16·⌈cin/16⌉ and cout_p = N·⌈cout/N⌉, N = tile_width(cout)."""
    cout, cin = w.shape[:2]
    n = tile_width(cout)
    cin_p = -(-cin // CIN_STEP) * CIN_STEP
    cout_p = -(-cout // n) * n
    taps = w.permute(2, 3, 4, 0, 1).reshape(27, cout, cin)
    return F.pad(taps, (0, cin_p - cin, 0, cout_p - cout)).contiguous()


def conv3d_same(x: Tensor, w: Tensor) -> Tensor:
    """K5. x [b, r, r, r, cin] bf16 channels-last (contiguous, or with a
    padded voxel stride as `padded_bf16` gives), w [cout, cin, 3, 3, 3]
    bf16 -> [b, r, r, r, cout] bf16. CPU tensors: the plain version; CUDA
    tensors: the kernel (r in 16, 32, 64, 128; any other r raises)."""
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
    cs = _voxel_stride(x)
    if cs % VOXEL_STEP != 0 or x.data_ptr() % 16 != 0:
        x = padded_bf16(x)
        cs = _voxel_stride(x)
    taps = _weight_taps(w)
    out = torch.empty((b, r, r, r, cout), dtype=torch.bfloat16, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(lib.rift_conv3d_same(x.data_ptr(), cs, taps.data_ptr(), out.data_ptr(), b, r,
                                     cin, taps.shape[2], cout, taps.shape[1], tile_width(cout),
                                     stream),
                "rift_conv3d_same")
    conv3d_same.launches += 1
    return out


conv3d_same.launches = 0

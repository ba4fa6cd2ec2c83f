"""K2 voxel scatter-mean and K3 8-corner gather (CUDA kernels and plain
versions).

Twins of `rift_tpu/ops/pallas/onehot_ops.py`: `scatter_mean_pallas` (K2)
and `corner_gather_pallas` (K3). The TPU kernels build one-hot selectors
for the MXU; on the card the same functions are a sort-then-segment-sum
and a direct 8-row gather (`csrc/voxel_ops.cu`). Each wrapper launches its
kernel for a CUDA tensor and takes its plain version only for a CPU tensor.
"""
from __future__ import annotations

import torch

from . import build

Tensor = torch.Tensor

MAX_SORT_POINTS = 4096  # K2 sorts one cloud's keys in shared memory


def scatter_mean_plain(features: Tensor, inds: Tensor, num_segments: int
                       ) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version of K2: features [b, n, c], inds [b, n]
    (negative = dropped) -> (out [b, s, c], cnt [b, s] f32); empty voxels
    hold 0. Sums in point order, then scales by 1/count."""
    b, n, c = features.shape
    s = num_segments
    valid = inds >= 0
    # Dropped points go to a trash row past each cloud's segments.
    row = torch.where(valid, inds.long(), torch.full_like(inds.long(), s))
    flat = (row + torch.arange(b, device=inds.device)[:, None] * (s + 1)).reshape(-1)
    sums = torch.zeros((b * (s + 1), c), dtype=features.dtype, device=features.device)
    sums.index_add_(0, flat, features.reshape(b * n, c))
    cnt = torch.zeros(b * (s + 1), dtype=features.dtype, device=features.device)
    cnt.index_add_(0, flat, valid.reshape(-1).to(features.dtype))
    sums = sums.reshape(b, s + 1, c)[:, :s]
    cnt = cnt.reshape(b, s + 1)[:, :s]
    inv = torch.where(cnt > 0, 1.0 / torch.clamp(cnt, min=1.0), torch.zeros_like(cnt))
    return sums * inv[..., None], cnt


def scatter_mean(features: Tensor, inds: Tensor, num_segments: int
                 ) -> tuple[Tensor, Tensor]:
    """K2. features [b, n, c] f32, inds [b, n] int (negative = dropped) ->
    (out [b, s, c], cnt [b, s] f32). CPU tensor: the plain version; CUDA
    tensor: the kernel."""
    if features.device.type == "cpu":
        return scatter_mean_plain(features, inds, num_segments)
    if features.device.type != "cuda" or inds.device != features.device:
        raise ValueError(f"unsupported devices {features.device}, {inds.device}")
    if features.dtype != torch.float32 or features.dim() != 3:
        raise ValueError(f"features must be f32 [b, n, c], got {features.dtype} "
                         f"{tuple(features.shape)}")
    b, n, c = features.shape
    if tuple(inds.shape) != (b, n):
        raise ValueError(f"inds must be [{b}, {n}], got {tuple(inds.shape)}")
    if n > MAX_SORT_POINTS:
        raise ValueError(f"the scatter-mean kernel takes n <= {MAX_SORT_POINTS}, got {n}")
    lib = build.load()
    feat = features.contiguous()
    ind = inds.to(torch.int32).contiguous()
    s = int(num_segments)
    dev = features.device
    order = torch.empty((b, n), dtype=torch.int32, device=dev)
    vstart = torch.empty((b, s), dtype=torch.int32, device=dev)
    out = torch.empty((b, s, c), dtype=torch.float32, device=dev)
    cnt = torch.empty((b, s), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib.rift_scatter_mean(feat.data_ptr(), ind.data_ptr(), b, n, c, s,
                                      order.data_ptr(), vstart.data_ptr(),
                                      out.data_ptr(), cnt.data_ptr(), stream),
                "rift_scatter_mean")
    scatter_mean.launches += 1
    return out, cnt


scatter_mean.launches = 0


def corner_gather_plain(grid: Tensor, corner_idx: Tensor, corner_w: Tensor
                        ) -> Tensor:
    """Plain PyTorch version of K3: grid [b, s, c], corner_idx [b, n, 8]
    (negative = skipped), corner_w [b, n, 8] -> out [b, n, c], the corners
    summed in k order."""
    b, n, _ = corner_idx.shape
    c = grid.shape[-1]
    out = torch.zeros((b, n, c), dtype=grid.dtype, device=grid.device)
    for k in range(8):
        idx = corner_idx[..., k]
        rows = torch.gather(grid, 1, torch.clamp(idx, min=0).long()[..., None].expand(b, n, c))
        w = torch.where(idx >= 0, corner_w[..., k], torch.zeros_like(corner_w[..., k]))
        out = out + w[..., None] * rows
    return out


def corner_gather(grid: Tensor, corner_idx: Tensor, corner_w: Tensor) -> Tensor:
    """K3. out[b, p, c] = Σ_k w[b, p, k]·grid[b, idx[b, p, k], c], skipping
    idx < 0. CPU tensor: the plain version; CUDA tensor: the kernel."""
    if grid.device.type == "cpu":
        return corner_gather_plain(grid, corner_idx, corner_w)
    if grid.device.type != "cuda" or corner_idx.device != grid.device \
            or corner_w.device != grid.device:
        raise ValueError("grid, corner_idx and corner_w must share one CUDA device")
    if grid.dtype != torch.float32 or grid.dim() != 3:
        raise ValueError(f"grid must be f32 [b, s, c], got {grid.dtype} {tuple(grid.shape)}")
    b, s, c = grid.shape
    if corner_idx.dim() != 3 or corner_idx.shape[0] != b or corner_idx.shape[-1] != 8 \
            or corner_w.shape != corner_idx.shape:
        raise ValueError(f"corner_idx/corner_w must be [{b}, n, 8], got "
                         f"{tuple(corner_idx.shape)} / {tuple(corner_w.shape)}")
    n = corner_idx.shape[1]
    lib = build.load()
    g = grid.contiguous()
    idx = corner_idx.to(torch.int32).contiguous()
    w = corner_w.to(torch.float32).contiguous()
    out = torch.empty((b, n, c), dtype=torch.float32, device=grid.device)
    stream = torch.cuda.current_stream(grid.device).cuda_stream
    build.check(lib.rift_corner_gather(g.data_ptr(), idx.data_ptr(), w.data_ptr(),
                                       b, n, c, s, out.data_ptr(), stream),
                "rift_corner_gather")
    corner_gather.launches += 1
    return out


corner_gather.launches = 0

"""K2 voxel scatter-mean, K3 8-corner gather and K4 8-corner scatter (CUDA
kernels and plain versions).

Twins of `rift_tpu/ops/pallas/onehot_ops.py`: `scatter_mean_pallas` (K2),
`corner_gather_pallas` (K3) and its transpose `corner_scatter_pallas` (K4).
The TPU kernels build one-hot selectors for the MXU; on the card the same
functions are a counting sort by voxel then a segment sum in index order
(K2, K4; any n and s) and a direct 8-row gather (K3), in
`csrc/voxel_ops.cu`. Each wrapper launches its kernel for a CUDA
tensor and takes its plain version only for a CPU tensor. An index outside
[0, s) matches no voxel and drops out, as in the one-hot kernels.
"""
from __future__ import annotations

import torch

from . import build

Tensor = torch.Tensor

_SCAN_TILE = 4096  # voxels per block of the kernels' prefix sum (csrc/voxel_ops.cu)


def _runs_scratch(b: int, s: int, entries: int, device) -> Tensor:
    """The int32 scratch of K2's and K4's runs over b clouds of s voxels and
    `entries` indices each: counts, starts and order of the runs, the
    placement's slots and cursors, and the scan's tile sums. The kernels
    index it with 32-bit ints."""
    segs, total = b * s, b * entries
    if segs >= 2 ** 31 or total >= 2 ** 31:
        raise ValueError(f"b·s = {segs} and b·entries = {total} must be below 2^31")
    return torch.empty(3 * segs + 2 * total + -(-segs // _SCAN_TILE), dtype=torch.int32,
                       device=device)


# Input types of the K2 and K3 kernels, with the type code their C entry
# points take (0: f32, 1: bf16); they sum and write f32 either way.
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def scatter_mean_plain(features: Tensor, inds: Tensor, num_segments: int
                       ) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version of K2: features [b, n, c] (f32, f64 or bf16),
    inds [b, n] (outside [0, s) = dropped) -> (out [b, s, c], cnt [b, s]),
    both f32 for bf16 features; empty voxels hold 0. Sums in point order,
    then scales by 1/count."""
    b, n, c = features.shape
    s = num_segments
    acc = torch.promote_types(features.dtype, torch.float32)
    valid = (inds >= 0) & (inds < s)
    # Dropped points go to a trash row past each cloud's segments.
    row = torch.where(valid, inds.long(), torch.full_like(inds.long(), s))
    flat = (row + torch.arange(b, device=inds.device)[:, None] * (s + 1)).reshape(-1)
    sums = torch.zeros((b * (s + 1), c), dtype=acc, device=features.device)
    sums.index_add_(0, flat, features.reshape(b * n, c).to(acc))
    cnt = torch.zeros(b * (s + 1), dtype=acc, device=features.device)
    cnt.index_add_(0, flat, valid.reshape(-1).to(acc))
    sums = sums.reshape(b, s + 1, c)[:, :s]
    cnt = cnt.reshape(b, s + 1)[:, :s]
    inv = torch.where(cnt > 0, 1.0 / torch.clamp(cnt, min=1.0), torch.zeros_like(cnt))
    return sums * inv[..., None], cnt


def scatter_mean(features: Tensor, inds: Tensor, num_segments: int
                 ) -> tuple[Tensor, Tensor]:
    """K2. features [b, n, c] f32 or bf16, inds [b, n] int (outside [0, s) =
    dropped) -> (out [b, s, c] f32, cnt [b, s] f32): bf16 features are
    summed in f32, as the Pallas kernel sums them. CPU tensor: the plain
    version; CUDA tensor: the kernel."""
    if features.device.type == "cpu":
        return scatter_mean_plain(features, inds, num_segments)
    if features.device.type != "cuda" or inds.device != features.device:
        raise ValueError(f"unsupported devices {features.device}, {inds.device}")
    if features.dtype not in _KERNEL_DTYPES or features.dim() != 3:
        raise ValueError(f"features must be f32 or bf16 [b, n, c], got {features.dtype} "
                         f"{tuple(features.shape)}")
    b, n, c = features.shape
    if tuple(inds.shape) != (b, n):
        raise ValueError(f"inds must be [{b}, {n}], got {tuple(inds.shape)}")
    lib = build.load()
    feat = features.contiguous()
    ind = inds.to(torch.int32).contiguous()
    s = int(num_segments)
    dev = features.device
    runs = _runs_scratch(b, s, n, dev)
    out = torch.empty((b, s, c), dtype=torch.float32, device=dev)
    cnt = torch.empty((b, s), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib.rift_scatter_mean(feat.data_ptr(), _KERNEL_DTYPES[feat.dtype],
                                      ind.data_ptr(), b, n, c, s, runs.data_ptr(),
                                      out.data_ptr(), cnt.data_ptr(), stream),
                "rift_scatter_mean")
    scatter_mean.launches += 1
    return out, cnt


scatter_mean.launches = 0


def corner_gather_plain(grid: Tensor, corner_idx: Tensor, corner_w: Tensor
                        ) -> Tensor:
    """Plain PyTorch version of K3: grid [b, s, c] (f32, f64 or bf16),
    corner_idx [b, n, 8] (outside [0, s) = skipped), corner_w [b, n, 8] ->
    out [b, n, c], f32 for a bf16 grid, the corners summed in k order."""
    b, n, _ = corner_idx.shape
    s, c = grid.shape[1:]
    acc = torch.promote_types(grid.dtype, torch.float32)
    out = torch.zeros((b, n, c), dtype=acc, device=grid.device)
    for k in range(8):
        idx = corner_idx[..., k]
        valid = (idx >= 0) & (idx < s)
        safe = torch.where(valid, idx, torch.zeros_like(idx)).long()
        rows = torch.gather(grid, 1, safe[..., None].expand(b, n, c)).to(acc)
        w = torch.where(valid, corner_w[..., k], torch.zeros_like(corner_w[..., k]))
        out = out + w[..., None] * rows
    return out


def corner_gather(grid: Tensor, corner_idx: Tensor, corner_w: Tensor) -> Tensor:
    """K3. out[b, p, c] = Σ_k w[b, p, k]·grid[b, idx[b, p, k], c], skipping
    idx outside [0, s); grid f32 or bf16, out f32 (a bf16 grid is read as
    it is and summed in f32, as the Pallas kernel does). CPU tensor: the
    plain version; CUDA tensor: the kernel."""
    if grid.device.type == "cpu":
        return corner_gather_plain(grid, corner_idx, corner_w)
    if grid.device.type != "cuda" or corner_idx.device != grid.device \
            or corner_w.device != grid.device:
        raise ValueError("grid, corner_idx and corner_w must share one CUDA device")
    if grid.dtype not in _KERNEL_DTYPES or grid.dim() != 3:
        raise ValueError(f"grid must be f32 or bf16 [b, s, c], got {grid.dtype} "
                         f"{tuple(grid.shape)}")
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
    build.check(lib.rift_corner_gather(g.data_ptr(), _KERNEL_DTYPES[g.dtype], idx.data_ptr(),
                                       w.data_ptr(), b, n, c, s, out.data_ptr(), stream),
                "rift_corner_gather")
    corner_gather.launches += 1
    return out


corner_gather.launches = 0


def corner_scatter_plain(dout: Tensor, corner_idx: Tensor, corner_w: Tensor,
                         num_segments: int) -> Tensor:
    """Plain PyTorch version of K4, the transpose of K3: dout [b, n, c],
    corner_idx [b, n, 8] (outside [0, s) = skipped), corner_w [b, n, 8] ->
    dgrid [b, s, c] with dgrid[v] = Σ_{p,k: idx = v} w[p, k]·dout[p]. The
    products are summed in (p, k) order (`index_add_` on the CPU)."""
    b, n, c = dout.shape
    s = num_segments
    valid = (corner_idx >= 0) & (corner_idx < s)
    # Skipped corners go to a trash row past each cloud's segments.
    row = torch.where(valid, corner_idx.long(), torch.full_like(corner_idx.long(), s))
    flat = (row + torch.arange(b, device=dout.device)[:, None, None] * (s + 1)).reshape(-1)
    rows = (corner_w.to(dout.dtype)[..., None] * dout[:, :, None, :]).reshape(b * n * 8, c)
    out = torch.zeros((b * (s + 1), c), dtype=dout.dtype, device=dout.device)
    out.index_add_(0, flat, rows)
    return out.reshape(b, s + 1, c)[:, :s]


def corner_scatter(dout: Tensor, corner_idx: Tensor, corner_w: Tensor,
                   num_segments: int) -> Tensor:
    """K4. dgrid[b, v, c] = Σ_{p,k: idx[b,p,k] = v} w[b,p,k]·dout[b,p,c],
    skipping idx outside [0, s); every voxel written. CPU tensor: the plain
    version; CUDA tensor: the kernel."""
    if dout.device.type == "cpu":
        return corner_scatter_plain(dout, corner_idx, corner_w, num_segments)
    if dout.device.type != "cuda" or corner_idx.device != dout.device \
            or corner_w.device != dout.device:
        raise ValueError("dout, corner_idx and corner_w must share one CUDA device")
    if dout.dtype != torch.float32 or dout.dim() != 3:
        raise ValueError(f"dout must be f32 [b, n, c], got {dout.dtype} {tuple(dout.shape)}")
    b, n, c = dout.shape
    if tuple(corner_idx.shape) != (b, n, 8) or corner_w.shape != corner_idx.shape:
        raise ValueError(f"corner_idx/corner_w must be [{b}, {n}, 8], got "
                         f"{tuple(corner_idx.shape)} / {tuple(corner_w.shape)}")
    s = int(num_segments)
    lib = build.load()
    d = dout.contiguous()
    idx = corner_idx.to(torch.int32).contiguous()
    w = corner_w.to(torch.float32).contiguous()
    dev = dout.device
    runs = _runs_scratch(b, s, 8 * n, dev)
    dgrid = torch.empty((b, s, c), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib.rift_corner_scatter(d.data_ptr(), idx.data_ptr(), w.data_ptr(), b, n, c, s,
                                        runs.data_ptr(), dgrid.data_ptr(), stream),
                "rift_corner_scatter")
    corner_scatter.launches += 1
    return dgrid


corner_scatter.launches = 0

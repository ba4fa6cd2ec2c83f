"""K2 voxel scatter-mean, K3 8-corner gather and K4 8-corner scatter (CUDA
kernels and plain versions).

Twins of `rift_tpu/ops/pallas/onehot_ops.py`: `scatter_mean_pallas` (K2,
`_scatter_kernel`), `corner_gather_pallas` (K3, `_gather_kernel`) and its
transpose `corner_scatter_pallas` (K4, `_scatter_w_kernel`). The TPU
kernels build one-hot selectors for the MXU; on the card, in
`csrc/voxel_ops.cu`, K3 is a direct 8-row gather (one launch; a block
covers a run of points of one cloud, its threads 16-byte vectors of each
point's row, the 8 corner rows loaded together and summed in k order; it
reads int32 or int64 indices as they are), and K2 and K4 are one launch
each of `voxel_sum_kernel`: a block owns
`voxel_tile(b, s, entries, c)` consecutive voxels of one cloud, keeps the
cloud's entries that fall in them in ascending order (a block-wide scan
of each thread's count), groups them by voxel with a stable counting
sort in shared memory, sums each group in entry order and writes its
whole span of the dense [b, s, c] grid once with 16-byte stores, zeros
(and K2's counts) included. No global scratch, no float atomics: two
calls on the same inputs are bit-equal. K2 and K4 are bound by that
dense write (bytes); tensor cores do not fit, since the one-hot product
would be > 99% multiplications by zero and TF32 or bf16 would break the
1e-5 tolerance. Each wrapper launches its kernel for a CUDA tensor and
takes its plain version only for a CPU tensor. An index outside [0, s)
matches no voxel and drops out, as in the one-hot kernels.
"""
from __future__ import annotations

import torch

from . import build

Tensor = torch.Tensor

# Voxels per block of K2 and K4, smallest first; the least output span of
# a block in floats (64 KB); the blocks a launch should have at least (8
# on each of the H100's 132 SMs, rounded).
VOXEL_TILES = (32, 64, 128, 256, 512, 1024)
TILE_MIN_SPAN = 16384
TILE_MIN_BLOCKS = 1024


def voxel_tile(b: int, s: int, entries: int, c: int) -> int:
    """Voxels per block of K2 and K4 for b clouds of s voxels, `entries`
    indices per cloud and c channels. Every block reads its cloud's whole
    index list, so the tile is the smallest of VOXEL_TILES whose output
    span (tile·c floats) is at least TILE_MIN_SPAN and at least twice that
    list (else the largest), then halved while the launch has fewer than
    TILE_MIN_BLOCKS blocks (few large clouds); never more than s. On the
    H100 these are the fastest tiles within a few percent at the main
    path's shapes and at clouds of 2048-16384 points (`scatter_ab.py
    --tiles`)."""
    tile = next((t for t in VOXEL_TILES if t * c >= max(TILE_MIN_SPAN, 2 * entries)),
                VOXEL_TILES[-1])
    while tile > VOXEL_TILES[0] and b * -(-s // tile) < TILE_MIN_BLOCKS:
        tile //= 2
    return min(tile, s)


def _stream(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on a CUDA device, without
    the Python Stream object that `torch.cuda.current_stream(device)`
    builds on every call (host time before each launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _check_sizes(b: int, s: int, entries: int) -> None:
    """K2 and K4 index the grid and the entries of the batch with 32-bit
    ints."""
    if b * s >= 2 ** 31 or b * entries >= 2 ** 31:
        raise ValueError(f"b·s = {b * s} and b·entries = {b * entries} must be below 2^31")


# Input types of the K2 and K3 kernels, with the type code their C entry
# points take (0: f32, 1: bf16); they sum and write f32 either way.
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Index types K3 reads as they are, with their type code: the path's int64
# corner indices go to the kernel with no conversion.
_INDEX_TYPES = {torch.int32: 0, torch.int64: 1}


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
    _check_sizes(b, s, n)
    dev = features.device
    out = torch.empty((b, s, c), dtype=torch.float32, device=dev)
    cnt = torch.empty((b, s), dtype=torch.float32, device=dev)
    stream = _stream(dev)
    build.check(lib.rift_scatter_mean(feat.data_ptr(), _KERNEL_DTYPES[feat.dtype],
                                      ind.data_ptr(), b, n, c, s, voxel_tile(b, s, n, c),
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
    it is and summed in f32, as the Pallas kernel does); int32 and int64
    indices are read as they are (other integer types are converted to
    int32). CPU tensor: the plain version; CUDA tensor: the kernel."""
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
    if b > 65535 or s * c >= 2 ** 31:
        raise ValueError(f"K3 takes b <= 65535 and s·c below 2^31, got b = {b}, s·c = {s * c}")
    lib = build.load()
    g = grid.contiguous()
    idx = corner_idx if corner_idx.dtype in _INDEX_TYPES else corner_idx.to(torch.int32)
    idx = idx.contiguous()
    w = corner_w.to(torch.float32).contiguous()
    out = torch.empty((b, n, c), dtype=torch.float32, device=grid.device)
    stream = _stream(grid.device)
    build.check(lib.rift_corner_gather(g.data_ptr(), _KERNEL_DTYPES[g.dtype], idx.data_ptr(),
                                       _INDEX_TYPES[idx.dtype], w.data_ptr(), b, n, c, s,
                                       out.data_ptr(), stream),
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
    _check_sizes(b, s, 8 * n)
    lib = build.load()
    d = dout.contiguous()
    idx = corner_idx.to(torch.int32).contiguous()
    w = corner_w.to(torch.float32).contiguous()
    dev = dout.device
    dgrid = torch.empty((b, s, c), dtype=torch.float32, device=dev)
    stream = _stream(dev)
    build.check(lib.rift_corner_scatter(d.data_ptr(), idx.data_ptr(), w.data_ptr(), b, n, c, s,
                                        voxel_tile(b, s, 8 * n, c), dgrid.data_ptr(), stream),
                "rift_corner_scatter")
    corner_scatter.launches += 1
    return dgrid


corner_scatter.launches = 0

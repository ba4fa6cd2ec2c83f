// K2 — deterministic voxel scatter-mean, and K3 — 8-corner weighted gather.
//
// K2 replaces: rift_tpu/ops/pallas/onehot_ops.py, `_scatter_kernel`
// (launched by `scatter_mean_pallas`; the TPU's default route computes the
// same function as `scatter_mean_factored`).
//   out[b, v, c] = mean of features[b, p, c] over the points p with
//   inds[b, p] == v; cnt[b, v] = that number (f32); indices outside [0, s)
//   are dropped; empty voxels hold 0. Features are f32 or bf16 (the bf16
//   model's blocks); sums and outputs are f32 either way, as the Pallas
//   kernel's f32 accumulation gives.
// Bound on this card: bytes. The dense grid is written in full
// (b·s·c floats: 281 MB at b = 32, s = 32768, c = 67) against b·n·c
// floats read; the arithmetic is one add per point and channel.
// Design: no float atomics, so the result does not depend on scheduling.
// A counting sort over the whole grid groups the points by voxel, in
// point order inside each voxel (see "Runs" below); then one thread per
// (voxel, channel), channel fastest so stores coalesce, sums its run in
// that order, scales by 1/count, or writes 0.
//
// K3 replaces: onehot_ops.py, `_gather_kernel` (launched by
// `corner_gather_pallas`; factored twin `corner_gather_factored`).
//   out[b, p, c] = Σ_k w[b, p, k] · grid[b, idx[b, p, k], c] over the 8
//   corners, skipping idx outside [0, s). The grid is f32 or bf16; the
//   products and sums are f32 and so is the output.
// Bound on this card: bytes — each output element needs 8 grid loads and
// 1 store; the grid rows a cloud touches are few (≤ 8·n rows) and stay in
// L2, so the least traffic is the b·n·c output plus the b·n·8 corner
// indices and weights (the grid is counted once as an input).
// Design: one thread per (point, channel), channel fastest, so the 8 loads
// of a warp read contiguous grid rows. Corners are summed in k order with
// unfused multiply and add, as the plain PyTorch version does.
//
// K4 replaces: onehot_ops.py, `_scatter_w_kernel` (launched by
// `corner_scatter_pallas`), the transpose of K3 and the backward of the
// spherical devoxelization:
//   dgrid[b, v, c] = Σ_{p,k : idx[b, p, k] = v} w[b, p, k] · dout[b, p, c],
//   skipping idx outside [0, s); every voxel is written, zeros included.
// Bound on this card: bytes — the dense dgrid write (b·s·c floats: 403 MB
// per training step at b = 16, s = 32768, c = 64 + 128) against b·n·c
// floats of dout and the b·n·8 corners read; two flops per corner entry
// and channel.
// Design: K2's runs over the 8·n corner entries (entry 8·p + k), again
// without float atomics; one thread per (voxel, channel) sums w·dout over
// its run in (p, k) order, unfused, as the plain version does.
//
// Runs (K2 and K4): any n, any s with b·s and b·(entries) below 2^31.
// Every kernel is a grid over all points or all voxels of the batch, so
// all SMs work whatever b is:
//   1. count: an integer atomicAdd per valid entry into cnt[b·s + v];
//   2. scan: start = the exclusive prefix sum of cnt over the flat b·s
//      voxels (tile sums, one block scanning them, then each tile);
//   3. place: each entry takes a slot of its voxel's run by an integer
//      atomicAdd (so the order inside a run is the scheduler's);
//   4. rank: each entry counts the entries of its run with a smaller
//      index and writes itself at start + rank. Indices are unique, so the
//      order is ascending index whatever step 3 did: deterministic.
// Step 4 costs Σ run² compares, a few per entry for the model's clouds and
// n² only when every point falls in one voxel. Integer atomics give exact
// counts, so no step depends on scheduling.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;
constexpr int kScanTile = kScanThreads * kScanItems;  // voxels per scan block

inline unsigned int blocks_for(long long total, int threads) {
  return (unsigned int)((total + threads - 1) / threads);
}

// The voxel of entry e (flat over b clouds of m entries each), as an index
// into the flat [b, s] grid, or -1 when its index lies outside [0, s).
__device__ __forceinline__ long long entry_segment(const int* __restrict__ ind, long long e,
                                                   int m, int s) {
  const int v = ind[e];
  if (v < 0 || v >= s) return -1;
  return (e / m) * (long long)s + v;
}

__global__ void count_kernel(const int* __restrict__ ind, long long total, int m, int s,
                             int* __restrict__ cnt) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long seg = entry_segment(ind, e, m, s);
  if (seg >= 0) atomicAdd(cnt + seg, 1);
}

// Inclusive sum of v over the block (blockDim.x == kScanThreads), and the
// block's total in *block_total; `warp_tot` is 32 ints of shared memory.
// Ends synchronized.
__device__ int block_inclusive_scan(int v, int* warp_tot, int* block_total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int t = warp_tot[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += u;
    }
    warp_tot[lane] = t;
  }
  __syncthreads();
  if (warp > 0) v += warp_tot[warp - 1];
  *block_total = warp_tot[31];
  __syncthreads();
  return v;
}

// Scan pass 1: the sum of each tile of kScanTile voxels.
__global__ void __launch_bounds__(kScanThreads)
tile_sum_kernel(const int* __restrict__ cnt, long long total, int* __restrict__ tile_sum) {
  __shared__ int warp_tot[32];
  const long long base = (long long)blockIdx.x * kScanTile + (long long)threadIdx.x * kScanItems;
  int v = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i)
    if (base + i < total) v += cnt[base + i];
  int sum;
  block_inclusive_scan(v, warp_tot, &sum);
  if (threadIdx.x == 0) tile_sum[blockIdx.x] = sum;
}

// Scan pass 2 (one block): tile sums -> exclusive tile offsets, in place.
__global__ void __launch_bounds__(kScanThreads)
tile_offset_kernel(int* __restrict__ tile_sum, int tiles) {
  __shared__ int warp_tot[32];
  int carry = 0;
  for (int t0 = 0; t0 < tiles; t0 += kScanThreads) {
    const int t = t0 + threadIdx.x;
    const int v = t < tiles ? tile_sum[t] : 0;
    int sum;
    const int inc = block_inclusive_scan(v, warp_tot, &sum);
    if (t < tiles) tile_sum[t] = carry + inc - v;
    carry += sum;
  }
}

// Scan pass 3: start[v] = the exclusive prefix sum of cnt.
__global__ void __launch_bounds__(kScanThreads)
tile_scan_kernel(const int* __restrict__ cnt, long long total,
                 const int* __restrict__ tile_offset, int* __restrict__ start) {
  __shared__ int warp_tot[32];
  const long long base = (long long)blockIdx.x * kScanTile + (long long)threadIdx.x * kScanItems;
  int item[kScanItems];
  int v = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    item[i] = base + i < total ? cnt[base + i] : 0;
    v += item[i];
  }
  int sum;
  int run = block_inclusive_scan(v, warp_tot, &sum) - v + tile_offset[blockIdx.x];
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    if (base + i < total) start[base + i] = run;
    run += item[i];
  }
}

__global__ void place_kernel(const int* __restrict__ ind, long long total, int m, int s,
                             const int* __restrict__ start, int* __restrict__ fill,
                             int* __restrict__ slots) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long seg = entry_segment(ind, e, m, s);
  if (seg >= 0) slots[start[seg] + atomicAdd(fill + seg, 1)] = (int)e;
}

__global__ void rank_kernel(const int* __restrict__ ind, long long total, int m, int s,
                            const int* __restrict__ start, const int* __restrict__ cnt,
                            const int* __restrict__ slots, int* __restrict__ order) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long seg = entry_segment(ind, e, m, s);
  if (seg < 0) return;
  const int* run = slots + start[seg];
  const int len = cnt[seg];
  int rank = 0;
  for (int t = 0; t < len; ++t) rank += run[t] < (int)e;
  order[start[seg] + rank] = (int)e;
}

// The runs of the `total` = b·m entries over the b·s voxels: cnt (entries
// per voxel), start (where each voxel's run begins in `order`) and order
// (entry indices, flat over the batch, grouped by voxel in ascending
// order). scratch holds ⌈b·s / kScanTile⌉ + b·s + b·m ints.
int build_runs(const int* ind, int b, int m, int s, int* cnt, int* start, int* order,
               int* scratch, cudaStream_t st) {
  const long long segs = (long long)b * s, total = (long long)b * m;
  const int tiles = (int)((segs + kScanTile - 1) / kScanTile);
  int* tile_sum = scratch;
  int* fill = scratch + tiles;
  int* slots = fill + segs;
  cudaError_t err = cudaMemsetAsync(cnt, 0, segs * sizeof(int), st);
  if (err == cudaSuccess) err = cudaMemsetAsync(fill, 0, segs * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (total > 0) count_kernel<<<blocks_for(total, kThreads), kThreads, 0, st>>>(ind, total, m, s, cnt);
  tile_sum_kernel<<<tiles, kScanThreads, 0, st>>>(cnt, segs, tile_sum);
  tile_offset_kernel<<<1, kScanThreads, 0, st>>>(tile_sum, tiles);
  tile_scan_kernel<<<tiles, kScanThreads, 0, st>>>(cnt, segs, tile_sum, start);
  if (total > 0) {
    place_kernel<<<blocks_for(total, kThreads), kThreads, 0, st>>>(ind, total, m, s, start,
                                                                   fill, slots);
    rank_kernel<<<blocks_for(total, kThreads), kThreads, 0, st>>>(ind, total, m, s, start, cnt,
                                                                  slots, order);
  }
  return (int)cudaGetLastError();
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void voxel_mean_kernel(const T* __restrict__ feat, const int* __restrict__ order,
                                  const int* __restrict__ start, const int* __restrict__ cnt,
                                  float* __restrict__ out, float* __restrict__ cnt_out, int c,
                                  long long total) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int ch = (int)(e % c);
  const long long bv = e / c;          // b * s + v
  const int len = cnt[bv];
  float v = 0.0f;
  if (len > 0) {
    const int* ord = order + start[bv];  // points, flat over the batch (b·n + p)
    float sum = 0.0f;
    for (int t = 0; t < len; ++t) sum = __fadd_rn(sum, to_f32(feat[(size_t)ord[t] * c + ch]));
    v = __fmul_rn(sum, __frcp_rn((float)len));
  }
  out[e] = v;
  if (ch == 0) cnt_out[bv] = (float)len;
}

template <typename T>
__global__ void corner_gather_kernel(const T* __restrict__ grid, const int* __restrict__ idx,
                                     const float* __restrict__ w, float* __restrict__ out,
                                     int n, int s, int c, long long total) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int ch = (int)(e % c);
  const long long bp = e / c;          // b * n + p
  const int b = (int)(bp / n);
  const int* ix = idx + bp * 8;
  const float* wt = w + bp * 8;
  const T* g = grid + (size_t)b * s * c + ch;
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int v = ix[k];
    if (v >= 0 && v < s) acc = __fadd_rn(acc, __fmul_rn(wt[k], to_f32(g[(size_t)v * c])));
  }
  out[e] = acc;
}

__global__ void corner_scatter_kernel(const float* __restrict__ dout, const float* __restrict__ w,
                                      const int* __restrict__ order,
                                      const int* __restrict__ start,
                                      const int* __restrict__ cnt, float* __restrict__ dgrid,
                                      int c, long long total) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int ch = (int)(e % c);
  const long long bv = e / c;          // b * s + v
  const int len = cnt[bv];
  float acc = 0.0f;
  if (len > 0) {
    const int* ord = order + start[bv];  // entries (b·n + p)·8 + k, flat over the batch
    for (int t = 0; t < len; ++t) {
      const int entry = ord[t];
      acc = __fadd_rn(acc, __fmul_rn(w[entry], dout[(size_t)(entry >> 3) * c + ch]));
    }
  }
  dgrid[e] = acc;
}

}  // namespace

// features [b, n, c], f32 (dtype 0) or bf16 (dtype 1); inds [b, n] int32
// (outside [0, s) = dropped); outputs out [b, s, c] and cnt [b, s] f32;
// scratch: runs [3·b·s + 2·b·n + ⌈b·s / 4096⌉] int32 (b·s and b·n below
// 2^31). Returns cudaGetLastError() after the launches.
extern "C" int rift_scatter_mean(const void* features, int dtype, const int* inds, int b, int n,
                                 int c, int s, int* runs, float* out, float* cnt,
                                 void* stream) {
  if (b <= 0 || s <= 0 || c <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const long long segs = (long long)b * s;
  int* vcnt = runs;
  int* vstart = vcnt + segs;
  int* order = vstart + segs;
  int err = build_runs(inds, b, n, s, vcnt, vstart, order, order + (long long)b * n, st);
  if (err != 0) return err;
  const long long total = segs * c;
  if (dtype == 1)
    voxel_mean_kernel<<<blocks_for(total, kThreads), kThreads, 0, st>>>(
        (const __nv_bfloat16*)features, order, vstart, vcnt, out, cnt, c, total);
  else
    voxel_mean_kernel<<<blocks_for(total, kThreads), kThreads, 0, st>>>(
        (const float*)features, order, vstart, vcnt, out, cnt, c, total);
  return (int)cudaGetLastError();
}

// grid [b, s, c], f32 (dtype 0) or bf16 (dtype 1); idx [b, n, 8] int32
// (outside [0, s) = skipped), w [b, n, 8] f32 -> out [b, n, c] f32.
// Returns cudaGetLastError() after the launch.
extern "C" int rift_corner_gather(const void* grid, int dtype, const int* idx, const float* w,
                                  int b, int n, int c, int s, float* out, void* stream) {
  const long long total = (long long)b * n * c;
  if (total <= 0) return 0;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    corner_gather_kernel<<<blocks, threads, 0, st>>>((const __nv_bfloat16*)grid, idx, w, out, n,
                                                     s, c, total);
  else
    corner_gather_kernel<<<blocks, threads, 0, st>>>((const float*)grid, idx, w, out, n, s, c,
                                                     total);
  return (int)cudaGetLastError();
}

// dout [b, n, c] f32, idx [b, n, 8] int32 (outside [0, s) = skipped),
// w [b, n, 8] f32; scratch: runs [3·b·s + 16·b·n + ⌈b·s / 4096⌉] int32
// (b·s and 8·b·n below 2^31); output dgrid [b, s, c] f32, every voxel
// written. Returns cudaGetLastError() after the launches.
extern "C" int rift_corner_scatter(const float* dout, const int* idx, const float* w, int b,
                                   int n, int c, int s, int* runs, float* dgrid, void* stream) {
  if (b <= 0 || s <= 0 || c <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const long long segs = (long long)b * s;
  int* vcnt = runs;
  int* vstart = vcnt + segs;
  int* order = vstart + segs;
  int err = build_runs(idx, b, 8 * n, s, vcnt, vstart, order, order + (long long)b * 8 * n, st);
  if (err != 0) return err;
  const long long total = segs * c;
  corner_scatter_kernel<<<blocks_for(total, kThreads), kThreads, 0, st>>>(
      dout, w, order, vstart, vcnt, dgrid, c, total);
  return (int)cudaGetLastError();
}

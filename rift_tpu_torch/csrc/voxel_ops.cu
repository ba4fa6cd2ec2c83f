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
// Pass 1 (one block per cloud) sorts the keys (voxel, point index) with a
// bitonic sort in shared memory — unique keys, so the order is total and
// stable by construction — then writes, per voxel, where its run of points
// starts in the sorted order (-1 when empty) and its count. Pass 2 runs one
// thread per (voxel, channel), channel fastest so stores coalesce: it sums
// its run in point-index order, scales by 1/count, or writes 0.
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
// Design: K2's scheme applied to the 8·n corner entries, again without
// float atomics. Pass 1 (one block per cloud) sorts 32-bit keys
// (voxel << 13 | entry), entry = 8·p + k, so the 8192 keys of a
// 1024-point cloud fit 32 KB of static shared memory; it writes each
// voxel's run start (-1 when empty) and length. Pass 2 runs one thread per
// (voxel, channel) and sums w·dout over its run in (p, k) order, unfused,
// as the plain version does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSortThreads = 1024;
constexpr int kMaxSortPoints = 4096;  // 32 KB of 64-bit keys
constexpr int kMaxCornerEntries = 8192;  // 8·n for n <= 1024: 32 KB of 32-bit keys
constexpr int kEntryBits = 13;
constexpr unsigned int kEntryMask = (1u << kEntryBits) - 1u;
constexpr unsigned int kNoKey = 0xffffffffu;  // skipped entry or padding: sorts last

// Ascending bitonic sort of p2 (a power of two) keys in shared memory by
// the whole block; the caller synchronizes before it.
template <typename Key>
__device__ void bitonic_sort_block(Key* keys, int p2) {
  for (int size = 2; size <= p2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < p2; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const bool up = (i & size) == 0;
          const Key a = keys[i], c = keys[j];
          if ((a > c) == up) { keys[i] = c; keys[j] = a; }
        }
      }
      __syncthreads();
    }
  }
}

__global__ void voxel_runs_kernel(const int* __restrict__ inds, int n, int s,
                                  int* __restrict__ order, int* __restrict__ vstart,
                                  float* __restrict__ cnt) {
  __shared__ unsigned long long keys[kMaxSortPoints];
  const int b = blockIdx.x;
  const int* ind = inds + (size_t)b * n;
  int p2 = 1;
  while (p2 < n) p2 <<= 1;
  for (int i = threadIdx.x; i < p2; i += blockDim.x) {
    unsigned long long v = 0xffffffffull;  // dropped point or padding: sorts last
    if (i < n && ind[i] >= 0 && ind[i] < s) v = (unsigned long long)ind[i];
    keys[i] = (v << 32) | (unsigned long long)i;
  }
  int* vs = vstart + (size_t)b * s;
  float* cn = cnt + (size_t)b * s;
  for (int v = threadIdx.x; v < s; v += blockDim.x) {
    vs[v] = -1;
    cn[v] = 0.0f;
  }
  __syncthreads();
  bitonic_sort_block(keys, p2);
  int* ord = order + (size_t)b * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const unsigned long long key = keys[i];
    ord[i] = (int)(key & 0xffffffffull);
    const unsigned int v = (unsigned int)(key >> 32);
    if (v == 0xffffffffu) continue;
    if (i > 0 && (unsigned int)(keys[i - 1] >> 32) == v) continue;  // not a run head
    int len = 1;
    while (i + len < n && (unsigned int)(keys[i + len] >> 32) == v) ++len;
    vs[v] = i;
    cn[v] = (float)len;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void voxel_mean_kernel(const T* __restrict__ feat, const int* __restrict__ order,
                                  const int* __restrict__ vstart, const float* __restrict__ cnt,
                                  float* __restrict__ out, int n, int s, int c, long long total) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int ch = (int)(e % c);
  const long long bv = e / c;          // b * s + v
  const int b = (int)(bv / s);
  const int start = vstart[bv];
  float v = 0.0f;
  if (start >= 0) {
    const int len = (int)cnt[bv];
    const int* ord = order + (size_t)b * n + start;
    const T* f = feat + (size_t)b * n * c + ch;
    float sum = 0.0f;
    for (int t = 0; t < len; ++t) sum = __fadd_rn(sum, to_f32(f[(size_t)ord[t] * c]));
    v = __fmul_rn(sum, __frcp_rn((float)len));
  }
  out[e] = v;
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

__global__ void corner_runs_kernel(const int* __restrict__ idx, int n, int s,
                                   int* __restrict__ order, int* __restrict__ vstart,
                                   int* __restrict__ vlen) {
  __shared__ unsigned int keys[kMaxCornerEntries];
  const int b = blockIdx.x;
  const int m = 8 * n;
  const int* ix = idx + (size_t)b * m;
  int p2 = 1;
  while (p2 < m) p2 <<= 1;
  for (int i = threadIdx.x; i < p2; i += blockDim.x) {
    unsigned int key = kNoKey;
    if (i < m && ix[i] >= 0 && ix[i] < s) key = ((unsigned int)ix[i] << kEntryBits) | (unsigned int)i;
    keys[i] = key;
  }
  int* vs = vstart + (size_t)b * s;
  int* vl = vlen + (size_t)b * s;
  for (int v = threadIdx.x; v < s; v += blockDim.x) {
    vs[v] = -1;
    vl[v] = 0;
  }
  __syncthreads();
  bitonic_sort_block(keys, p2);
  int* ord = order + (size_t)b * m;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const unsigned int key = keys[i];
    ord[i] = (int)(key & kEntryMask);
    if (key == kNoKey) continue;
    const unsigned int v = key >> kEntryBits;
    if (i > 0 && (keys[i - 1] >> kEntryBits) == v) continue;  // not a run head
    int len = 1;
    // kNoKey >> kEntryBits exceeds every voxel index (s < 2^19), so a run
    // never reaches into the skipped entries.
    while (i + len < m && (keys[i + len] >> kEntryBits) == v) ++len;
    vs[v] = i;
    vl[v] = len;
  }
}

__global__ void corner_scatter_kernel(const float* __restrict__ dout, const float* __restrict__ w,
                                      const int* __restrict__ order,
                                      const int* __restrict__ vstart,
                                      const int* __restrict__ vlen, float* __restrict__ dgrid,
                                      int n, int s, int c, long long total) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int ch = (int)(e % c);
  const long long bv = e / c;          // b * s + v
  const int b = (int)(bv / s);
  const int start = vstart[bv];
  float acc = 0.0f;
  if (start >= 0) {
    const int len = vlen[bv];
    const int* ord = order + (size_t)b * 8 * n + start;
    const float* wt = w + (size_t)b * 8 * n;
    const float* d = dout + (size_t)b * n * c + ch;
    for (int t = 0; t < len; ++t) {
      const int entry = ord[t];  // 8·p + k
      acc = __fadd_rn(acc, __fmul_rn(wt[entry], d[(size_t)(entry >> 3) * c]));
    }
  }
  dgrid[e] = acc;
}

}  // namespace

// features [b, n, c], f32 (dtype 0) or bf16 (dtype 1); inds [b, n] int32
// (outside [0, s) = dropped; n <= 4096); scratch order [b, n] int32 and
// vstart [b, s] int32; outputs out [b, s, c] and cnt [b, s] f32. Returns
// cudaGetLastError() after the two launches.
extern "C" int rift_scatter_mean(const void* features, int dtype, const int* inds, int b, int n,
                                 int c, int s, int* order, int* vstart, float* out, float* cnt,
                                 void* stream) {
  if (b <= 0 || s <= 0 || c <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  voxel_runs_kernel<<<b, kSortThreads, 0, st>>>(inds, n, s, order, vstart, cnt);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long total = (long long)b * s * c;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
  if (dtype == 1)
    voxel_mean_kernel<<<blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)features, order, vstart, cnt, out, n, s, c, total);
  else
    voxel_mean_kernel<<<blocks, threads, 0, st>>>(
        (const float*)features, order, vstart, cnt, out, n, s, c, total);
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

// dout [b, n, c] f32, idx [b, n, 8] int32 (outside [0, s) = skipped; n <= 1024,
// s < 2^19), w [b, n, 8] f32; scratch order [b, 8n], vstart [b, s] and
// vlen [b, s] int32; output dgrid [b, s, c] f32, every voxel written.
// Returns cudaGetLastError() after the two launches.
extern "C" int rift_corner_scatter(const float* dout, const int* idx, const float* w, int b,
                                   int n, int c, int s, int* order, int* vstart, int* vlen,
                                   float* dgrid, void* stream) {
  if (b <= 0 || s <= 0 || c <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  corner_runs_kernel<<<b, kSortThreads, 0, st>>>(idx, n, s, order, vstart, vlen);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long total = (long long)b * s * c;
  const int threads = 256;
  corner_scatter_kernel<<<(unsigned int)((total + threads - 1) / threads), threads, 0, st>>>(
      dout, w, order, vstart, vlen, dgrid, n, s, c, total);
  return (int)cudaGetLastError();
}

// K1 — hybrid-radius neighbourhood moments for normal estimation.
//
// Replaces: rift_tpu/ops/pallas/normals_kernel.py, `_moments_kernel`
// (launched by `neighborhood_moments_pallas`).
//
// Function: for each query point i of a cloud, d²(i, j) to every point j
// by the expansion (|q|² + |p|²) − 2·q·p clamped at 0; the k-th smallest
// d² by a 32-step bracket bisection by counting, then the min inside the
// bracket (an empty bracket gives 0); r² = max(radius², kth·(1 + 1e-6));
// then the 13 moments [Σp (3), Σp⊗p (9), count] over the j with d² < r².
// Output out[b, i, 13] in that order.
//
// Bound on this card: operations, not bytes. Per cloud the kernel reads
// n·3 floats and writes n·13. Per (query, point) it does 77 flops: d² 9,
// 32 bisection steps of a compare and an add 64, the bracket min 3, the
// radius mask 1; per neighbour found, 22 flops for the 13 moments. That
// is 77·n²·b + 22·neighbours in all, the count chip_smoke.py reports the
// bound from: at b = 32, n = 1024 about 2.6 GFLOP, ~0.039 ms at the
// 67 TFLOP/s f32 (non-tensor) peak.
//
// Design: one warp per query. The cloud (12 KB at n = 1024) and its |p|²
// sit in shared memory; each lane owns n/32 points and keeps their d² in
// registers, so d² is computed once and every bisection step is 32
// register compares plus a 5-step warp sum. Sums run in a fixed order
// (lane-local in index order, then an xor-shuffle tree), so the result is
// deterministic. The d² expansion is written with __fmul_rn/__fadd_rn so
// no multiply-add is fused: it rounds exactly as the plain PyTorch version
// does, which keeps the neighbour sets identical at the radius boundary.
//
// Clouds of more than 1024 points (ShapeNet's 2048 and up) take a second
// kernel, one warp per query as well. Its d² no longer fit a lane's
// registers, so every pass (the max, each of the 32 bisection steps, the
// bracket min, the moments) forms them again, by the same unfused
// expansion, so the neighbour counts still equal the plain version's. Up
// to kSharedPoints = 12288 points (192 KB at 16 B a point) the cloud and
// its |p|² are staged in dynamic shared memory; above that each pass
// streams the cloud from device memory (L2) and forms |p|² again. Sums run
// in the same order as in the first kernel (lane-local in index order,
// then the xor tree).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxPoints = 1024;       // shared-memory cloud size
constexpr int kPerLane = kMaxPoints / 32;
constexpr int kWarps = 8;              // queries in flight per block
constexpr int kQueriesPerBlock = 32;   // 4 per warp
constexpr int kBisectSteps = 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// |p|² = (x·x + y·y) + z·z, unfused.
__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__device__ __forceinline__ float sqdist(float qx, float qy, float qz, float q2, float x,
                                       float y, float z, float p2) {
  const float cross = __fadd_rn(__fadd_rn(__fmul_rn(qx, x), __fmul_rn(qy, y)), __fmul_rn(qz, z));
  return fmaxf(__fsub_rn(__fadd_rn(q2, p2), __fmul_rn(2.0f, cross)), 0.0f);
}

__global__ void moments_kernel(const float* __restrict__ pts, float* __restrict__ out,
                               int n, int k, float radius_sq) {
  __shared__ float sx[kMaxPoints], sy[kMaxPoints], sz[kMaxPoints], s2[kMaxPoints];
  const int b = blockIdx.y;
  const float* cloud = pts + (size_t)b * n * 3;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float x = cloud[3 * j], y = cloud[3 * j + 1], z = cloud[3 * j + 2];
    sx[j] = x; sy[j] = y; sz[j] = z;
    s2[j] = sq3(x, y, z);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inf = __int_as_float(0x7f800000);
  for (int qi = warp; qi < kQueriesPerBlock; qi += kWarps) {
    const int i = blockIdx.x * kQueriesPerBlock + qi;
    if (i >= n) break;  // warp-uniform
    const float qx = sx[i], qy = sy[i], qz = sz[i], q2 = s2[i];
    float d[kPerLane];
    float dmax = 0.0f;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < n) {
        float cross = __fadd_rn(__fadd_rn(__fmul_rn(qx, sx[j]), __fmul_rn(qy, sy[j])),
                                __fmul_rn(qz, sz[j]));
        float v = __fsub_rn(__fadd_rn(q2, s2[j]), __fmul_rn(2.0f, cross));
        v = fmaxf(v, 0.0f);
        d[t] = v;
        dmax = fmaxf(dmax, v);
      } else {
        d[t] = inf;  // padding: never counted, never in a bracket or the mask
      }
    }

    float r2 = radius_sq;
    if (k > 0) {
      float lo = 0.0f, hi = warp_max(dmax);
      for (int step = 0; step < kBisectSteps; ++step) {
        const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
        int c = 0;
#pragma unroll
        for (int t = 0; t < kPerLane; ++t) c += (d[t] <= mid);
        if (warp_sum_int(c) >= k) hi = mid; else lo = mid;
      }
      float m = inf;
#pragma unroll
      for (int t = 0; t < kPerLane; ++t)
        if (d[t] > lo && d[t] <= hi) m = fminf(m, d[t]);
      float kth = warp_min(m);
      if (isinf(kth)) kth = 0.0f;  // empty bracket: >= k points at distance 0
      r2 = fmaxf(radius_sq, __fmul_rn(kth, 1.000001f));
    }

    float acc[13];
#pragma unroll
    for (int c = 0; c < 13; ++c) acc[c] = 0.0f;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      if (d[t] < r2) {
        const int j = lane + 32 * t;
        const float x = sx[j], y = sy[j], z = sz[j];
        acc[0] = __fadd_rn(acc[0], x);
        acc[1] = __fadd_rn(acc[1], y);
        acc[2] = __fadd_rn(acc[2], z);
        acc[3] = __fadd_rn(acc[3], __fmul_rn(x, x));
        acc[4] = __fadd_rn(acc[4], __fmul_rn(x, y));
        acc[5] = __fadd_rn(acc[5], __fmul_rn(x, z));
        acc[6] = __fadd_rn(acc[6], __fmul_rn(y, x));
        acc[7] = __fadd_rn(acc[7], __fmul_rn(y, y));
        acc[8] = __fadd_rn(acc[8], __fmul_rn(y, z));
        acc[9] = __fadd_rn(acc[9], __fmul_rn(z, x));
        acc[10] = __fadd_rn(acc[10], __fmul_rn(z, y));
        acc[11] = __fadd_rn(acc[11], __fmul_rn(z, z));
        acc[12] = __fadd_rn(acc[12], 1.0f);
      }
    }
    float* o = out + ((size_t)b * n + i) * 13;
#pragma unroll
    for (int c = 0; c < 13; ++c) {
      const float v = warp_sum(acc[c]);
      if (lane == c) o[c] = v;
    }
  }
}

constexpr int kSharedPoints = 12288;   // the large kernel's staged cloud: 192 KB
constexpr int kLargeWarps = 16;
constexpr int kLargeQueriesPerBlock = 64;  // 4 per warp

// Point j of the cloud: staged in shared memory, or read from device memory
// with |p|² formed again (the same unfused expression, the same bits).
template <bool kStaged>
struct Cloud {
  const float* g;                      // [n, 3] in device memory
  const float *sx, *sy, *sz, *s2;      // [n] each in shared memory
  __device__ __forceinline__ void get(int j, float& x, float& y, float& z, float& p2) const {
    if (kStaged) {
      x = sx[j]; y = sy[j]; z = sz[j]; p2 = s2[j];
    } else {
      x = g[3 * j]; y = g[3 * j + 1]; z = g[3 * j + 2];
      p2 = sq3(x, y, z);
    }
  }
};

template <bool kStaged>
__global__ void __launch_bounds__(kLargeWarps * 32)
moments_large_kernel(const float* __restrict__ pts, float* __restrict__ out, int n, int k,
                     float radius_sq) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  Cloud<kStaged> cl;
  cl.g = pts + (size_t)b * n * 3;
  cl.sx = smem; cl.sy = smem + n; cl.sz = smem + 2 * n; cl.s2 = smem + 3 * n;
  if (kStaged) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float x = cl.g[3 * j], y = cl.g[3 * j + 1], z = cl.g[3 * j + 2];
      smem[j] = x; smem[n + j] = y; smem[2 * n + j] = z;
      smem[3 * n + j] = sq3(x, y, z);
    }
    __syncthreads();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inf = __int_as_float(0x7f800000);
  for (int qi = warp; qi < kLargeQueriesPerBlock; qi += kLargeWarps) {
    const int i = blockIdx.x * kLargeQueriesPerBlock + qi;
    if (i >= n) break;  // warp-uniform
    float qx, qy, qz, q2;
    cl.get(i, qx, qy, qz, q2);

    float r2 = radius_sq;
    if (k > 0) {
      float dmax = 0.0f;
      for (int j = lane; j < n; j += 32) {
        float x, y, z, p2;
        cl.get(j, x, y, z, p2);
        dmax = fmaxf(dmax, sqdist(qx, qy, qz, q2, x, y, z, p2));
      }
      float lo = 0.0f, hi = warp_max(dmax);
      for (int step = 0; step < kBisectSteps; ++step) {
        const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
        int c = 0;
        for (int j = lane; j < n; j += 32) {
          float x, y, z, p2;
          cl.get(j, x, y, z, p2);
          c += (sqdist(qx, qy, qz, q2, x, y, z, p2) <= mid);
        }
        if (warp_sum_int(c) >= k) hi = mid; else lo = mid;
      }
      float m = inf;
      for (int j = lane; j < n; j += 32) {
        float x, y, z, p2;
        cl.get(j, x, y, z, p2);
        const float d = sqdist(qx, qy, qz, q2, x, y, z, p2);
        if (d > lo && d <= hi) m = fminf(m, d);
      }
      float kth = warp_min(m);
      if (isinf(kth)) kth = 0.0f;  // empty bracket: >= k points at distance 0
      r2 = fmaxf(radius_sq, __fmul_rn(kth, 1.000001f));
    }

    float acc[13];
#pragma unroll
    for (int c = 0; c < 13; ++c) acc[c] = 0.0f;
    for (int j = lane; j < n; j += 32) {
      float x, y, z, p2;
      cl.get(j, x, y, z, p2);
      if (sqdist(qx, qy, qz, q2, x, y, z, p2) < r2) {
        acc[0] = __fadd_rn(acc[0], x);
        acc[1] = __fadd_rn(acc[1], y);
        acc[2] = __fadd_rn(acc[2], z);
        acc[3] = __fadd_rn(acc[3], __fmul_rn(x, x));
        acc[4] = __fadd_rn(acc[4], __fmul_rn(x, y));
        acc[5] = __fadd_rn(acc[5], __fmul_rn(x, z));
        acc[6] = __fadd_rn(acc[6], __fmul_rn(y, x));
        acc[7] = __fadd_rn(acc[7], __fmul_rn(y, y));
        acc[8] = __fadd_rn(acc[8], __fmul_rn(y, z));
        acc[9] = __fadd_rn(acc[9], __fmul_rn(z, x));
        acc[10] = __fadd_rn(acc[10], __fmul_rn(z, y));
        acc[11] = __fadd_rn(acc[11], __fmul_rn(z, z));
        acc[12] = __fadd_rn(acc[12], 1.0f);
      }
    }
    float* o = out + ((size_t)b * n + i) * 13;
#pragma unroll
    for (int c = 0; c < 13; ++c) {
      const float v = warp_sum(acc[c]);
      if (lane == c) o[c] = v;
    }
  }
}

}  // namespace

// points [b, n, 3] f32 contiguous, out [b, n, 13] f32; any n. n <= 1024:
// the register-resident kernel; up to kSharedPoints: the large kernel on a
// cloud staged in shared memory; above: the large kernel streaming it.
// Returns cudaGetLastError() after the launch.
extern "C" int rift_normals_moments(const float* points, float* out, int b, int n, int k,
                                    float radius_sq, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= kMaxPoints) {
    dim3 grid((n + kQueriesPerBlock - 1) / kQueriesPerBlock, b);
    moments_kernel<<<grid, kWarps * 32, 0, st>>>(points, out, n, k, radius_sq);
    return (int)cudaGetLastError();
  }
  dim3 grid((n + kLargeQueriesPerBlock - 1) / kLargeQueriesPerBlock, b);
  if (n <= kSharedPoints) {
    const int smem = 4 * n * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(moments_large_kernel<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    moments_large_kernel<true><<<grid, kLargeWarps * 32, smem, st>>>(points, out, n, k,
                                                                     radius_sq);
  } else {
    moments_large_kernel<false><<<grid, kLargeWarps * 32, 0, st>>>(points, out, n, k,
                                                                   radius_sq);
  }
  return (int)cudaGetLastError();
}

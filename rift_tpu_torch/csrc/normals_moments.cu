// K1 — hybrid-radius neighbourhood moments for normal estimation.
//
// Replaces: rift_tpu/ops/pallas/normals_kernel.py, `_moments_kernel`
// (launched by `neighborhood_moments_pallas`).
//
// Function: for each query point i of a cloud, d²(i, j) to every point j
// by the expansion (|q|² + |p|²) − 2·q·p clamped at 0; `lo`, `hi` from 32
// bisection steps from [0, max d²] (mid = 0.5·(lo + hi); hi = mid when
// count(d² <= mid) >= k, else lo = mid); kth = the min of the d² inside
// (lo, hi], 0 when that is empty; r² = max(radius², kth·(1 + 1e-6)) (k = 0:
// radius²); then the 13 moments [Σp (3), Σp⊗p (9), count] over the j with
// d² < r². Output out[b, i, 13] in that order.
//
// Bound on this card: operations, not bytes (the kernel reads n·3 floats
// and writes n·13 per cloud). The least work per (query, point) is d² (9
// operations), one step of an exact selection and the radius test; per
// neighbour found, 22 operations for the 13 moments: 11·n²·b + 22·
// neighbours, about 0.4 GFLOP at b = 32, n = 1024 (~0.006 ms at the
// 67 TFLOP/s f32 peak, which counts a fused multiply-add as two: unfused
// operations run at most at half that rate).
//
// Design. The reference's answer is not the exact k-th smallest d²: the
// bracket (lo, hi] left by 32 steps can hold several distinct values near
// 0, and its min is then smaller. But each step asks count(d² <= mid) >= k,
// which holds exactly when kth <= mid for the exact k-th smallest kth
// (duplicates counted; none when fewer than k points). So the kernel
// selects kth exactly once, replays the 32 steps on that one scalar (no
// pass over d²) and takes the min in (lo, hi] in one more pass: the same
// lo, hi and r², bit for bit, and the same neighbours as the plain version.
// The selection works on the bits: a non-negative float sorts as its
// uint32 bits (the sign bit is masked, so −0 is +0).
//   1. Threshold. T = the k-th smallest of the 32 lanes' minima (k <= 32;
//      else T = +inf): k lanes each hold a d² <= T, so kth <= T. On the
//      path's clouds a few tens of the 1024 points lie at or below T.
//   2. The d² <= T are compacted into the warp's list in shared memory,
//      lane by lane (a lane counts its own, a warp scan gives its offset).
//      At most 32 of them (every query of the path's clouds): one per
//      lane, a bitonic sort across the warp gives kth. More: an exact
//      radix select over the list, four passes of 8-bit digits, each a
//      histogram of 256 bins in shared memory counted with integer atomics
//      and a warp scan that picks the bin holding rank k.
//   3. The replay; then the bracket min over the list when hi <= T (every
//      d² in (lo, hi] is in it), else over all d².
//   4. The neighbours (d² < r²) are compacted into the same list; lanes
//      sum the 13 moments over it in list order, then an xor-shuffle tree
//      adds the lanes: a fixed order, so the result is deterministic.
// d² is written with __fmul_rn/__fadd_rn so no multiply-add is fused: it
// rounds exactly as the plain PyTorch version does, which keeps the
// neighbour sets identical at the radius boundary. No tensor cores: a d²
// from a TF32 or bf16 product, or even an f32 one whose adds are fused,
// moves points across the radius and the counts off the plain version's;
// the moments are sums over tens of rows.
//
// Clouds of up to 1024 points (`moments_kernel`): one warp per query, 4
// queries a warp, 8 warps a block; the cloud (x, y, z, |p|² as one float4
// a point) and each warp's list and histogram sit in shared memory, and a
// lane keeps the d² of its 32 points in registers, so d² is formed once.
// Larger clouds (`moments_large_kernel`, ShapeNet's 2048 and up): d² no
// longer fit a lane's registers, so each pass forms them again by the same
// expression: the max and the lane minima, the candidates, the moments;
// the list holds kLargeList candidates, and a query with more (a
// degenerate cloud) runs the four radix passes and the bracket min over
// d² formed again: 3 passes a query on ordinary clouds, at most 8 (35
// before this design). Up to kSharedPoints = 12288 points the cloud is
// staged in shared memory; larger ones are read from device memory (L2) on
// each pass, |p|² formed again. One launch per call either way.
// Measured (PERF.md §6, chip_smoke.py and scatter_ab.py, NVIDIA H100 80GB
// HBM3, 700 W), on the device alone: 0.080 ms at b = 32, n = 1024 (the
// earlier 32-step bisection by counting: 0.28), 1.25 ms at 1 × 16384 (7.9).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kInfKey = 0x7f800000u;  // the bits of +inf
constexpr unsigned kPadKey = 0xffffffffu;  // above every key (keys have the sign bit clear)
constexpr int kBins = 256;                 // one 8-bit digit of the radix select
constexpr int kBisectSteps = 32;

constexpr int kMaxPoints = 1024;           // the register-resident kernel's clouds
constexpr int kPerLane = kMaxPoints / 32;
constexpr int kWarps = 8;                  // queries in flight per block
constexpr int kQueriesPerBlock = 32;       // 4 per warp

__device__ __forceinline__ unsigned key_of(float d) { return __float_as_uint(d) & 0x7fffffffu; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Bitonic sort of one key per lane across the warp: lane i ends with the
// i-th smallest.
__device__ __forceinline__ unsigned warp_sort(unsigned v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const unsigned o = __shfl_xor_sync(kFull, v, stride);
      const bool up = (lane & size) == 0;
      const bool low = (lane & stride) == 0;
      v = (low == up) ? min(v, o) : max(v, o);
    }
  }
  return v;
}

// |p|² = (x·x + y·y) + z·z, unfused.
__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// d² of query q and point p, each (x, y, z, |.|²), by the plain version's
// unfused expansion and order.
__device__ __forceinline__ float sqdist(float4 q, float4 p) {
  const float cross = __fadd_rn(__fadd_rn(__fmul_rn(q.x, p.x), __fmul_rn(q.y, p.y)),
                                __fmul_rn(q.z, p.z));
  return fmaxf(__fsub_rn(__fadd_rn(q.w, p.w), __fmul_rn(2.0f, cross)), 0.0f);
}

// The rank-th smallest (1 <= rank <= number of keys) of the keys that
// `keys` hands to its visitor, this lane's share of them, by four passes
// of 8-bit digits, most significant first; hist is the warp's 256 bins.
template <class Keys>
__device__ unsigned radix_select(const Keys& keys, int rank, int* hist, int lane) {
  unsigned prefix = 0, mask = 0;
#pragma unroll 1
  for (int shift = 24; shift >= 0; shift -= 8) {
#pragma unroll
    for (int i = 0; i < kBins / 32; ++i) hist[i * 32 + lane] = 0;
    __syncwarp();
    keys([&](unsigned key) {
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 0xffu], 1);
    });
    __syncwarp();
    // Lane l holds bins [8l, 8l + 8); a warp scan of their totals finds the
    // lane, then the bin, where the running count reaches rank.
    int c[kBins / 32], tot = 0;
#pragma unroll
    for (int i = 0; i < kBins / 32; ++i) {
      c[i] = hist[lane * (kBins / 32) + i];
      tot += c[i];
    }
    int incl = tot;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    const int excl = incl - tot;
    const bool mine = excl < rank && rank <= incl;
    int digit = 0, below = 0;
    if (mine) {
      int run = excl;
      bool found = false;
#pragma unroll
      for (int i = 0; i < kBins / 32; ++i) {
        if (!found && run + c[i] >= rank) {
          digit = lane * (kBins / 32) + i;
          below = run;
          found = true;
        }
        run += c[i];
      }
    }
    const int src = __ffs(__ballot_sync(kFull, mine)) - 1;
    digit = __shfl_sync(kFull, digit, src);
    below = __shfl_sync(kFull, below, src);
    rank -= below;
    prefix |= (unsigned)digit << shift;
    mask |= 0xffu << shift;
    __syncwarp();  // every lane has read the bins before the next pass clears them
  }
  return prefix;
}

// The candidates in a warp's list: lane l visits entries l, l + 32, ...
struct ListKeys {
  const unsigned* list;
  int m, lane;
  template <class F>
  __device__ __forceinline__ void operator()(F visit) const {
    for (int e = lane; e < m; e += 32) visit(list[e]);
  }
};

// kth (as a key): the rank-th smallest of the m candidates in a warp's list
// (rank <= m): a sort across the warp when they fit one a lane, else the
// radix select.
__device__ __forceinline__ unsigned select_from_list(const unsigned* list, int m, int rank,
                                                     int* hist, int lane) {
  if (m <= 32) {
    const unsigned v = warp_sort(lane < m ? list[lane] : kPadKey, lane);
    return __shfl_sync(kFull, v, rank - 1);
  }
  return radix_select(ListKeys{list, m, lane}, rank, hist, lane);
}

// The 32 bisection steps of the plain version, replayed on kth: the step's
// count(d² <= mid) >= k is (have && kth <= mid), have = at least k points.
__device__ __forceinline__ void replay(float kth, bool have, float hi0, float& lo, float& hi) {
  lo = 0.0f;
  hi = hi0;
#pragma unroll 8
  for (int step = 0; step < kBisectSteps; ++step) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    if (have && kth <= mid) hi = mid; else lo = mid;
  }
}

// r² from the lanes' bracket minima (+inf where a lane had none in (lo, hi]).
__device__ __forceinline__ float radius_from(float bracket_min, float radius_sq) {
  float kth = warp_min(bracket_min);
  if (isinf(kth)) kth = 0.0f;  // empty bracket: >= k points at distance 0
  return fmaxf(radius_sq, __fmul_rn(kth, 1.000001f));
}

__device__ __forceinline__ void add_moments(float acc[13], float4 p) {
  const float x = p.x, y = p.y, z = p.z;
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

__device__ __forceinline__ void write_moments(float acc[13], float* o, int lane) {
#pragma unroll
  for (int c = 0; c < 13; ++c) {
    const float v = warp_sum(acc[c]);
    if (lane == c) o[c] = v;
  }
}

// Stages a cloud as (x, y, z, |p|²) float4s.
__device__ __forceinline__ void stage_cloud(const float* g, float4* cloud, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float x = g[3 * j], y = g[3 * j + 1], z = g[3 * j + 2];
    cloud[j] = make_float4(x, y, z, sq3(x, y, z));
  }
}

inline size_t small_shared_bytes(int n) {
  return sizeof(float4) * n + kWarps * (sizeof(unsigned) * n + sizeof(int) * kBins);
}

// Exclusive warp scan of v; total gets the warp's sum.
__device__ __forceinline__ int warp_scan(int v, int lane, int& total) {
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  total = __shfl_sync(kFull, incl, 31);
  return incl - v;
}

// n <= 1024 (kWhole: n == 1024, every register slot a point, so no slot
// tests its index: the path's clouds run markedly faster so). Shared memory:
// cloud [n] float4, then per warp a list [n] and a histogram [256]. Lists
// are compacted lane by lane (a lane's slots in order, lanes in order),
// each lane's offset from a warp scan of the lanes' counts.
template <bool kWhole>
__global__ void __launch_bounds__(kWarps * 32)
moments_kernel(const float* __restrict__ pts, float* __restrict__ out, int n, int k,
               float radius_sq) {
  extern __shared__ float4 smem4[];
  float4* cloud = smem4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned* list = reinterpret_cast<unsigned*>(cloud + n) + warp * n;
  int* hist = reinterpret_cast<int*>(reinterpret_cast<unsigned*>(cloud + n) + kWarps * n) +
              warp * kBins;
  const int b = blockIdx.y;
  stage_cloud(pts + (size_t)b * n * 3, cloud, n);
  __syncthreads();

  const float inf = __int_as_float(0x7f800000);
  for (int qi = warp; qi < kQueriesPerBlock; qi += kWarps) {
    const int i = blockIdx.x * kQueriesPerBlock + qi;
    if (i >= n) break;  // warp-uniform
    const float4 q = cloud[i];
    float d[kPerLane];  // padding slots (j >= n) hold +inf: never below T, r² or in (lo, hi]
    float dmax = 0.0f, dmin = inf;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int j = lane + 32 * t;
      d[t] = inf;
      if (kWhole || j < n) {
        d[t] = sqdist(q, cloud[j]);
        dmax = fmaxf(dmax, d[t]);
        dmin = fminf(dmin, d[t]);
      }
    }

    float r2 = radius_sq;
    if (k > 0) {
      // T = +inf takes every point (its key is +inf's, which the padding
      // also has: padding is kept out by its index).
      unsigned tkey = kInfKey;
      if (k <= 32) tkey = __shfl_sync(kFull, warp_sort(key_of(dmin), lane), k - 1);
      int mine = 0;
#pragma unroll
      for (int t = 0; t < kPerLane; ++t)
        mine += (kWhole || lane + 32 * t < n) && key_of(d[t]) <= tkey;
      int m;
      int at = warp_scan(mine, lane, m);
#pragma unroll
      for (int t = 0; t < kPerLane; ++t)
        if ((kWhole || lane + 32 * t < n) && key_of(d[t]) <= tkey) list[at++] = key_of(d[t]);
      __syncwarp();
      const bool have = m >= k;
      float kth = inf;
      if (have) kth = __uint_as_float(select_from_list(list, m, k, hist, lane));
      float lo, hi;
      replay(kth, have, warp_max(dmax), lo, hi);
      float bmin = inf;
      if (key_of(hi) <= tkey) {  // every d² in (lo, hi] is in the list
        for (int e = lane; e < m; e += 32) {
          const float v = __uint_as_float(list[e]);
          if (v > lo && v <= hi) bmin = fminf(bmin, v);
        }
      } else {
#pragma unroll
        for (int t = 0; t < kPerLane; ++t)
          if (d[t] > lo && d[t] <= hi) bmin = fminf(bmin, d[t]);
      }
      r2 = radius_from(bmin, radius_sq);
      __syncwarp();  // the list is read; it now takes the neighbours
    }

    int* nb = reinterpret_cast<int*>(list);
    int mine = 0;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) mine += d[t] < r2;
    int cnt;
    int at = warp_scan(mine, lane, cnt);
#pragma unroll
    for (int t = 0; t < kPerLane; ++t)
      if (d[t] < r2) nb[at++] = lane + 32 * t;
    __syncwarp();
    float acc[13];
#pragma unroll
    for (int c = 0; c < 13; ++c) acc[c] = 0.0f;
    for (int e = lane; e < cnt; e += 32) add_moments(acc, cloud[nb[e]]);
    write_moments(acc, out + ((size_t)b * n + i) * 13, lane);
    __syncwarp();  // the neighbour list is read before the next query writes it
  }
}

constexpr int kSharedPoints = 12288;       // the large kernel's staged cloud: 192 KB
constexpr int kLargeWarps = 16;
constexpr int kLargeQueriesPerBlock = 32;  // 2 per warp
constexpr int kLargeList = 256;            // candidates a warp's list holds

inline size_t large_shared_bytes(int n, bool staged) {
  return (staged ? sizeof(float4) * n : 0) +
         kLargeWarps * (sizeof(unsigned) * kLargeList + sizeof(int) * kBins);
}

// Point j of the cloud: staged in shared memory, or read from device memory
// with |p|² formed again (the same unfused expression, the same bits).
template <bool kStaged>
struct Cloud {
  const float* g;      // [n, 3] in device memory
  const float4* s;     // [n] in shared memory
  __device__ __forceinline__ float4 get(int j) const {
    if (kStaged) return s[j];
    const float x = g[3 * j], y = g[3 * j + 1], z = g[3 * j + 2];
    return make_float4(x, y, z, sq3(x, y, z));
  }
};

// The candidates (d² <= T) of a query, d² formed again: lane l visits
// points l, l + 32, ...
template <bool kStaged>
struct CloudKeys {
  Cloud<kStaged> cl;
  float4 q;
  int n, lane;
  unsigned tkey;
  template <class F>
  __device__ __forceinline__ void operator()(F visit) const {
    for (int j = lane; j < n; j += 32) {
      const unsigned key = key_of(sqdist(q, cl.get(j)));
      if (key <= tkey) visit(key);
    }
  }
};

template <bool kStaged>
__global__ void __launch_bounds__(kLargeWarps * 32)
moments_large_kernel(const float* __restrict__ pts, float* __restrict__ out, int n, int k,
                     float radius_sq) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  Cloud<kStaged> cl;
  cl.g = pts + (size_t)b * n * 3;
  cl.s = smem4;
  unsigned* lists = reinterpret_cast<unsigned*>(smem4 + (kStaged ? n : 0));
  unsigned* list = lists + warp * kLargeList;
  int* hist = reinterpret_cast<int*>(lists + kLargeWarps * kLargeList) + warp * kBins;
  if (kStaged) {
    stage_cloud(cl.g, smem4, n);
    __syncthreads();
  }

  const unsigned below_me = (1u << lane) - 1u;
  const float inf = __int_as_float(0x7f800000);
  for (int qi = warp; qi < kLargeQueriesPerBlock; qi += kLargeWarps) {
    const int i = blockIdx.x * kLargeQueriesPerBlock + qi;
    if (i >= n) break;  // warp-uniform
    const float4 q = cl.get(i);

    float r2 = radius_sq;
    if (k > 0) {
      float dmax = 0.0f, dmin = inf;
      for (int j = lane; j < n; j += 32) {
        const float v = sqdist(q, cl.get(j));
        dmax = fmaxf(dmax, v);
        dmin = fminf(dmin, v);
      }
      unsigned tkey = kInfKey;
      if (k <= 32) tkey = __shfl_sync(kFull, warp_sort(key_of(dmin), lane), k - 1);
      int m = 0;
      for (int j0 = 0; j0 < n; j0 += 32) {  // the same trip count on every lane
        const int j = j0 + lane;
        unsigned key = kPadKey;
        if (j < n) key = key_of(sqdist(q, cl.get(j)));
        const bool p = key <= tkey;
        const unsigned bal = __ballot_sync(kFull, p);
        const int at = m + __popc(bal & below_me);
        if (p && at < kLargeList) list[at] = key;
        m += __popc(bal);
      }
      __syncwarp();
      const bool have = m >= k;
      float kth = inf;
      if (have && m <= kLargeList) {
        kth = __uint_as_float(select_from_list(list, m, k, hist, lane));
      } else if (have) {  // the list could not hold them: select over d² formed again
        kth = __uint_as_float(radix_select(CloudKeys<kStaged>{cl, q, n, lane, tkey}, k, hist,
                                           lane));
      }
      float lo, hi;
      replay(kth, have, warp_max(dmax), lo, hi);
      float bmin = inf;
      if (key_of(hi) <= tkey && m <= kLargeList) {
        for (int e = lane; e < m; e += 32) {
          const float v = __uint_as_float(list[e]);
          if (v > lo && v <= hi) bmin = fminf(bmin, v);
        }
      } else {
        for (int j = lane; j < n; j += 32) {
          const float v = sqdist(q, cl.get(j));
          if (v > lo && v <= hi) bmin = fminf(bmin, v);
        }
      }
      r2 = radius_from(bmin, radius_sq);
      __syncwarp();  // the list is read before the next query writes it
    }

    float acc[13];
#pragma unroll
    for (int c = 0; c < 13; ++c) acc[c] = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float4 p = cl.get(j);
      if (sqdist(q, p) < r2) add_moments(acc, p);
    }
    write_moments(acc, out + ((size_t)b * n + i) * 13, lane);
  }
}

template <class Kernel>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t st,
           const float* points, float* out, int n, int k, float radius_sq) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, threads, smem, st>>>(points, out, n, k, radius_sq);
  return (int)cudaGetLastError();
}

}  // namespace

// points [b, n, 3] f32 contiguous, out [b, n, 13] f32; any n. n <= 1024:
// the register-resident kernel; up to kSharedPoints: the large kernel on a
// cloud staged in shared memory; above: the large kernel streaming it. One
// launch; returns cudaGetLastError() after it.
extern "C" int rift_normals_moments(const float* points, float* out, int b, int n, int k,
                                    float radius_sq, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= kMaxPoints) {
    const dim3 grid((n + kQueriesPerBlock - 1) / kQueriesPerBlock, b);
    return launch(n == kMaxPoints ? moments_kernel<true> : moments_kernel<false>, grid,
                  kWarps * 32, small_shared_bytes(n), st, points, out, n, k, radius_sq);
  }
  const dim3 grid((n + kLargeQueriesPerBlock - 1) / kLargeQueriesPerBlock, b);
  if (n <= kSharedPoints)
    return launch(moments_large_kernel<true>, grid, kLargeWarps * 32,
                  large_shared_bytes(n, true), st, points, out, n, k, radius_sq);
  return launch(moments_large_kernel<false>, grid, kLargeWarps * 32,
                large_shared_bytes(n, false), st, points, out, n, k, radius_sq);
}

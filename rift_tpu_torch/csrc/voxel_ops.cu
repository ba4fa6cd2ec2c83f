// K2 — deterministic voxel scatter-mean, K3 — 8-corner weighted gather, and
// K4 — 8-corner weighted scatter (K3's transpose).
//
// K2 replaces: rift_tpu/ops/pallas/onehot_ops.py, `_scatter_kernel`
// (launched by `scatter_mean_pallas`; the TPU's default route computes the
// same function as `scatter_mean_factored`).
//   out[b, v, c] = mean of features[b, p, c] over the points p with
//   inds[b, p] == v; cnt[b, v] = that number (f32); indices outside [0, s)
//   are dropped; empty voxels hold 0. Features are f32 or bf16 (the bf16
//   model's blocks); sums and outputs are f32 either way, as the Pallas
//   kernel's f32 accumulation gives.
// K4 replaces: onehot_ops.py, `_scatter_w_kernel` (launched by
// `corner_scatter_pallas`), the transpose of K3 and the backward of the
// spherical devoxelization:
//   dgrid[b, v, c] = Σ_{p,k : idx[b, p, k] = v} w[b, p, k] · dout[b, p, c],
//   skipping idx outside [0, s); every voxel is written, zeros included.
//   dout is f32.
// Bound on this card (K2 and K4): bytes. The dense grid is written in full
// and is mostly zeros: b·s·c floats, 281 MB for K2 at b = 32, s = 32768,
// c = 67 (plus the b·s counts), 403 MB for K4's two calls of a training
// step (b = 16, c = 64 + 128), against b·n·c floats and the b·n (K2) or
// b·n·8 (K4) indices read; one add (K2) or multiply-add (K4) per kept
// entry and channel.
//
// Design of K2 and K4: one launch per call (`voxel_sum_kernel`), no global
// scratch, no float atomics. A block owns `tile` consecutive voxels of one
// cloud and writes every byte of that span of the output once; blocks take
// the tiles of all clouds together, the last tile first (the outer shells
// of the spherical grid, where the points crowd, start first and light
// tiles fill the tail). Per block:
//   1. Keep: stream the cloud's index list (n or 8·n int32; L2-resident)
//      kChunk entries at a time, kPer consecutive entries a thread (two
//      16-byte loads, one chunk ahead), and keep the entries whose voxel
//      lies in the tile, in ascending entry order: a warp scan of the
//      threads' counts and the warps' totals give each kept entry its slot
//      (one __syncthreads per chunk). Each voxel's count goes into shared
//      memory by an integer atomicAdd per run of equal voxels in a thread.
//   2. Group: a block scan of the counts gives each voxel's group start;
//      each warp owns an eighth of the tile's voxels and places its
//      entries, 32 of the list at a time in list order, equal voxels
//      ranked by lane (__match_any_sync): a stable counting sort, so each
//      group stays in ascending entry order whatever the scheduler does.
//   3. Sum and write: threads walk the tile's span of the output 4 floats
//      at a time (one division by c per thread, then 32-bit increments),
//      sum their voxel's group in order (point order for K2, (p, k) order
//      for K4) with unfused __fadd_rn/__fmul_rn as the plain versions do,
//      scale by 1/count (K2) and store 16 bytes, zeros included. For
//      c % 4 == 0 four channels of one voxel are one float4 (a 16-byte f32
//      or 8-byte bf16 load per entry); otherwise each float of the store
//      finds its own (voxel, channel), so c = 67 rows need no alignment of
//      their own: a tile of a multiple of 4 voxels is a 16-byte-aligned
//      span. K2's counts are written in the same pass, 16 bytes a store.
//   4. A tile that keeps more than kCap entries (every point in one voxel)
//      takes them in rounds of at most kCap, each resuming at the first
//      entry the last could not keep: the first round writes the whole
//      span, later rounds add to their voxels' partial sums in order (a
//      warp per voxel); K2 counts every entry in the first round and
//      scales a voxel in the round that adds its last entry. Cost stays
//      linear in n.
// The wrapper picks the tile (onehot_ops.voxel_tile: at least 64 KB of
// output and twice the index list per block, smaller while the launch has
// fewer than 1024 blocks). Any n, any s with b·s and
// b·(entries) below 2^31; 32-bit index arithmetic inside the block. Two
// calls on the same inputs are bit-equal.
// No tensor cores: the Pallas kernels contract a one-hot matrix on the MXU,
// which here would be > 99% multiplications by zero, and in TF32 or bf16
// would break the 1e-5 tolerance; the work is the dense write.
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md §6,
// chip_smoke.py, scatter_ab.py): K2's two calls 0.25 ms back to back in
// f32 (0.23 in bf16) against a 0.17 ms bound (0.54 for the count, scan,
// place and rank chain this design replaced); K4's 0.18 ms against 0.12
// (0.43 before), where `w·dout` + `index_add_` takes 0.40.
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
// Design (`corner_gather_kernel`, one launch a call): a block covers a run
// of points of one cloud (blockIdx.y, so no division finds the cloud) and
// its threads cover each point's row in 16-byte vectors, 4 f32 or 8 bf16
// channels a thread, with 32-bit offsets inside the cloud. The block reads
// its points' 8 indices and 8 weights once, as 16-byte loads, checks the
// indices against [0, s) and keeps them in shared memory for the point's
// threads; int32 and int64 indices are template cases, so the path's int64
// corner indices need no conversion op. A thread issues its point's 8 row
// loads (16 bytes each, kept as raw words) before it sums any, adds them
// in k order with unfused multiply and add, as the plain PyTorch version
// does (the same bits), and stores 16 bytes. A c that is no multiple of
// the vector, or a grid or output off 16-byte alignment, takes the scalar
// tail (one channel a thread); indices or weights off alignment are
// staged by scalar loads. No tensor cores: the Pallas kernel contracts a
// one-hot matrix on the MXU, here 8 nonzeros in s columns.
// Measured (PERF.md §6, chip_smoke.py and scatter_ab.py, NVIDIA H100 80GB
// HBM3, 700 W): the two f32 calls of a registration batch 0.044 ms on the
// device alone against a 0.0236 ms bound (the earlier one-thread-per-element
// kernel: 0.071 with the int32 copy of the indices), bf16 0.025.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // threads per K2/K4 block
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                 // consecutive entries a thread reads per chunk
constexpr int kChunk = kThreads * kPer; // entries one compaction step reads
constexpr int kCap = 2048;              // kept entries one round holds
static_assert(kPer % 4 == 0, "a thread's entries are whole 16-byte loads");
constexpr int kTileLimit = 1024;        // voxels a block may own: under 48 KB of shared memory
constexpr unsigned kFull = 0xffffffffu;

// Shared memory of a K2 (mean) or K4 block over `tile` voxels.
struct Shared {
  int* rc;              // [tile] entries per voxel in this round
  int* cur;             // [tile] group starts, then ends once placed
  int* tot;             // [tile] K2: entries per voxel in the whole list
  int* seen;            // [tile] K2: entries summed in earlier rounds
  int* wc;              // [2][kWarps] kept entries per warp in a chunk, 2 buffers
  int* wtot;            // [kWarps] the scan's warp totals
  int* over;            // [1] the first entry a full round could not keep
  int* ke;              // [kCap] kept entries, ascending
  int* ge;              // [kCap] kept entries grouped by voxel
  float* kw;            // [kCap] K4: weights of ke
  float* gw;            // [kCap] K4: weights of ge
  unsigned short* kv;   // [kCap] local voxel of ke
};

inline size_t shared_bytes(int tile, bool mean) {
  return sizeof(int) * ((mean ? 4 : 2) * (size_t)tile + 3 * kWarps + 1 + 2 * kCap) +
         (mean ? 0 : sizeof(float) * 2 * kCap) + sizeof(unsigned short) * kCap;
}

__device__ __forceinline__ Shared carve(int* p, int tile, bool mean) {
  Shared sh;
  sh.rc = p;
  p += tile;
  sh.cur = p;
  p += tile;
  sh.tot = p;
  sh.seen = p + (mean ? tile : 0);
  p += mean ? 2 * tile : 0;
  sh.wc = p;
  p += 2 * kWarps;
  sh.wtot = p;
  p += kWarps;
  sh.over = p;
  p += 1;
  sh.ke = p;
  p += kCap;
  sh.ge = p;
  p += kCap;
  float* f = reinterpret_cast<float*>(p);
  sh.kw = f;
  sh.gw = f + (mean ? 0 : kCap);
  f += mean ? 0 : 2 * kCap;
  sh.kv = reinterpret_cast<unsigned short*>(f);
  return sh;
}

// The kPer indices a thread reads from a chunk starting at `base` (a
// multiple of 4): 16-byte loads where the list allows, else one by one.
__device__ __forceinline__ void load_chunk(int (&v)[kPer], const int* ind, int base, int m,
                                           bool vec) {
  const int e = base + kPer * threadIdx.x;
  if (vec && e + kPer <= m) {
#pragma unroll
    for (int q = 0; q < kPer; q += 4) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(ind + e + q));
      v[q] = a.x, v[q + 1] = a.y, v[q + 2] = a.z, v[q + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[i] = e + i < m ? __ldg(ind + e + i) : -1;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Four consecutive values as f32: one 16-byte (f32) or 8-byte (bf16) load.
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Four consecutive values of a row whose start may not be 16-byte aligned.
template <typename T>
__device__ __forceinline__ float4 load4u(const T* p) {
  return make_float4(to_f32(p[0]), to_f32(p[1]), to_f32(p[2]), to_f32(p[3]));
}

// acc + the terms of group [end - g, end) at channel ch, in group order:
// the row itself (K2) or w · row (K4, row = entry / 8).
template <typename T, bool kMean>
__device__ __forceinline__ float group_sum1(const Shared& sh, const T* src, int c, int ch,
                                            int end, int g, float acc) {
#pragma unroll 4
  for (int t = end - g; t < end; ++t) {
    const int e = sh.ge[t];
    const float x = to_f32(src[(size_t)(kMean ? e : e >> 3) * c + ch]);
    acc = __fadd_rn(acc, kMean ? x : __fmul_rn(sh.gw[t], x));
  }
  return acc;
}

// The same for channels ch..ch+3 of one voxel, four sums in step;
// kAligned: c % 4 == 0 and the rows 4-value aligned (one vector load).
template <typename T, bool kMean, bool kAligned>
__device__ __forceinline__ float4 group_sum4(const Shared& sh, const T* src, int c, int ch,
                                             int end, int g, float4 acc) {
#pragma unroll 4
  for (int t = end - g; t < end; ++t) {
    const int e = sh.ge[t];
    const T* row = src + (size_t)(kMean ? e : e >> 3) * c + ch;
    float4 x = kAligned ? load4(row) : load4u(row);
    if (!kMean) {
      const float wt = sh.gw[t];
      x = make_float4(__fmul_rn(wt, x.x), __fmul_rn(wt, x.y), __fmul_rn(wt, x.z),
                      __fmul_rn(wt, x.w));
    }
    acc = make_float4(__fadd_rn(acc.x, x.x), __fadd_rn(acc.y, x.y), __fadd_rn(acc.z, x.z),
                      __fadd_rn(acc.w, x.w));
  }
  return acc;
}

__device__ __forceinline__ float4 scale4(float4 v, float r) {
  return make_float4(__fmul_rn(v.x, r), __fmul_rn(v.y, r), __fmul_rn(v.z, r), __fmul_rn(v.w, r));
}

// K2 (kMean) and K4 over one tile of one cloud per block. src: rows [b,
// rows, c]; ind: [b, m] voxel of each entry; w: [b, m] (K4); out [b, s, c];
// cnt [b, s] (K2). kVec: c % 4 == 0 and src, out aligned for 4-wide rows.
template <typename T, bool kMean, bool kVec>
__global__ void __launch_bounds__(kThreads)
voxel_sum_kernel(const T* __restrict__ src, const int* __restrict__ ind,
                 const float* __restrict__ w, int m, int rows, int c, int s, int tile, int tiles,
                 float* __restrict__ out, float* __restrict__ cnt) {
  extern __shared__ int smem[];
  const Shared sh = carve(smem, tile, kMean);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  // Blocks take the tiles of all clouds together, the last tile first: the
  // outer shells of the spherical grid, where a cloud's points crowd,
  // start first, and light tiles fill the tail.
  const int clouds = gridDim.x / tiles;
  const int cloud = blockIdx.x % clouds;
  const int v0 = (tiles - 1 - (int)(blockIdx.x / clouds)) * tile;
  const int nv = min(tile, s - v0);  // voxels of this tile
  const int* ind_c = ind + (size_t)cloud * m;
  const float* w_c = kMean ? w : w + (size_t)cloud * m;
  const T* src_c = src + (size_t)cloud * rows * c;
  float* ob = out + ((size_t)cloud * s + v0) * c;

  if (kMean)
    for (int i = tid; i < nv; i += kThreads) sh.tot[i] = sh.seen[i] = 0;
  // 16-byte index loads: the list's rows start 16-byte aligned.
  const bool vec_ind = (m & 3) == 0 && (reinterpret_cast<uintptr_t>(ind) & 15) == 0;
  int pos = 0;  // first entry of the list not yet kept
  bool first = true;
  do {
    for (int i = tid; i < nv; i += kThreads) sh.rc[i] = 0;
    __syncthreads();

    // 1. Keep this tile's entries from pos on, ascending, up to kCap of
    // them. A thread reads kPer consecutive entries of each chunk; a warp
    // scan and the warps' totals give each its slots in list order.
    int kept = 0, buf = 0, base = pos & ~3;
    bool full = false;
    int next[kPer];  // the chunk's indices, loaded one chunk ahead
    load_chunk(next, ind_c, base, m, vec_ind);
    for (; base < m; base += kChunk, buf ^= 1) {
      int val[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) val[i] = next[i];
      load_chunk(next, ind_c, base + kChunk, m, vec_ind);
      const int e0 = base + kPer * tid;
      unsigned keep = 0;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const unsigned lv = (unsigned)val[i] - (unsigned)v0;
        if (e0 + i >= pos && e0 + i < m && lv < (unsigned)nv) keep |= 1u << i;
      }
      const int mine = __popc(keep);
      int inc = mine;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += u;
      }
      if (lane == 31) sh.wc[buf * kWarps + warp] = inc;
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int u = 0; u < kWarps; ++u) {
        const int x = sh.wc[buf * kWarps + u];
        before += u < warp ? x : 0;
        total += x;
      }
      if (keep != 0) {
        // Counts by runs of equal voxels, one shared atomicAdd a run.
        int slot = kept + before + inc - mine, run = 0, run_lv = 0;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          if (!((keep >> i) & 1u)) continue;
          const int lv = val[i] - v0;
          if (slot < kCap) {
            sh.ke[slot] = e0 + i;
            sh.kv[slot] = (unsigned short)lv;
            if (lv != run_lv && run != 0) {
              atomicAdd(sh.rc + run_lv, run);
              if (kMean && first) atomicAdd(sh.tot + run_lv, run);
              run = 0;
            }
            run_lv = lv;
            ++run;
          } else if (slot == kCap) {
            *sh.over = e0 + i;
          }
          ++slot;
        }
        if (run != 0) {
          atomicAdd(sh.rc + run_lv, run);
          if (kMean && first) atomicAdd(sh.tot + run_lv, run);
        }
      }
      if (kept + total > kCap) {  // block-uniform
        full = true;
        kept = kCap;
        break;
      }
      kept += total;
    }
    __syncthreads();
    pos = full ? *sh.over : m;
    // K2 counts the rest of the list in the first round: the mean of a
    // voxel is taken in the round that adds its last entry.
    if (kMean && first && full) {
      for (int b0 = pos; b0 < m; b0 += kThreads) {
        const int e = b0 + tid;
        const unsigned lv = e < m ? (unsigned)__ldg(ind_c + e) - (unsigned)v0 : ~0u;
        const bool keep = lv < (unsigned)nv;
        if (__ballot_sync(kFull, keep) != 0) {
          const unsigned peers = __match_any_sync(kFull, keep ? (int)lv : -1);
          if (keep && lane == __ffs(peers) - 1) atomicAdd(sh.tot + lv, __popc(peers));
        }
      }
      __syncthreads();
    }
    if (!kMean)  // K4's weights of the kept entries, gathered at once
      for (int i = tid; i < kept; i += kThreads) sh.kw[i] = __ldg(w_c + sh.ke[i]);

    // 2. Group starts: exclusive scan of rc; then the counts (K2).
    {
      const int per = (nv + kThreads - 1) / kThreads;
      const int i0 = min(tid * per, nv), i1 = min(i0 + per, nv);
      int sum = 0;
      for (int i = i0; i < i1; ++i) sum += sh.rc[i];
      int inc = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += u;
      }
      if (lane == 31) sh.wtot[warp] = inc;
      __syncthreads();
      int at = inc - sum;
      for (int u = 0; u < warp; ++u) at += sh.wtot[u];
      for (int i = i0; i < i1; ++i) {
        sh.cur[i] = at;
        at += sh.rc[i];
      }
    }
    if (kMean && first) {
      float* cb = cnt + (size_t)cloud * s + v0;
      if ((reinterpret_cast<uintptr_t>(cb) & 15) == 0) {
        for (int i = 4 * tid; i < nv; i += 4 * kThreads) {
          if (i + 3 < nv)
            *reinterpret_cast<float4*>(cb + i) =
                make_float4((float)sh.tot[i], (float)sh.tot[i + 1], (float)sh.tot[i + 2],
                            (float)sh.tot[i + 3]);
          else
            for (int k = i; k < nv; ++k) cb[k] = (float)sh.tot[k];
        }
      } else {
        for (int i = tid; i < nv; i += kThreads) cb[i] = (float)sh.tot[i];
      }
    }
    __syncthreads();

    // Place the kept entries into their groups. Warp w owns the voxels
    // [w·nv/8, (w+1)·nv/8) and walks the whole list, 32 entries in list
    // order at a time, ranking its equal voxels by lane.
    {
      const int lo = warp * nv / kWarps, hi = (warp + 1) * nv / kWarps;
      for (int i0 = 0; i0 < kept; i0 += 32) {
        const int i = i0 + lane;
        const int lv = i < kept ? (int)sh.kv[i] : -1;
        const bool mine = lv >= lo && lv < hi;
        if (__ballot_sync(kFull, mine) == 0) continue;  // warp-uniform
        const unsigned peers = __match_any_sync(kFull, mine ? lv : -1);
        const int slot = mine ? sh.cur[lv] + __popc(peers & lt) : 0;
        __syncwarp();
        if (mine) {
          sh.ge[slot] = sh.ke[i];
          if (!kMean) sh.gw[slot] = sh.kw[i];
          if (lane == 31 - __clz(peers)) sh.cur[lv] = slot + 1;
        }
        __syncwarp();
      }
    }
    __syncthreads();

    // 3. Sum each group in order and write.
    if (first && c > 0) {
      // The whole span, 4 floats a thread at a time, zeros included.
      const int span = nv * c, step = 4 * kThreads;
      const int dlv = step / c, dch = step - dlv * c;
      int f = 4 * tid;
      int lv = f / c, ch = f - lv * c;
      const bool aligned = kVec || (reinterpret_cast<uintptr_t>(ob) & 15) == 0;
      for (; f < span; f += step) {
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (kVec) {
          const int g = sh.rc[lv];
          if (g != 0) {
            v = group_sum4<T, kMean, true>(sh, src_c, c, ch, sh.cur[lv], g, v);
            if (kMean && g == sh.tot[lv]) v = scale4(v, __frcp_rn((float)g));
          }
          *reinterpret_cast<float4*>(ob + f) = v;
        } else {
          // The 4 floats lie in voxels lv and, past the row's end, lv + 1
          // (c >= 4), or in up to 4 voxels (c < 4).
          const bool one = ch + 3 < c;
          const bool empty = c >= 4 && f + 3 < span && (sh.rc[lv] | sh.rc[lv + !one]) == 0;
          if (!empty) {
            if (one) {
              const int g = sh.rc[lv];
              if (g != 0) {
                v = group_sum4<T, kMean, false>(sh, src_c, c, ch, sh.cur[lv], g, v);
                if (kMean && g == sh.tot[lv]) v = scale4(v, __frcp_rn((float)g));
              }
            } else {
              float x[4];
              int l = lv, h = ch;
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                x[k] = 0.0f;
                if (f + k < span) {
                  const int g = sh.rc[l];
                  if (g != 0) {
                    x[k] = group_sum1<T, kMean>(sh, src_c, c, h, sh.cur[l], g, 0.0f);
                    if (kMean && g == sh.tot[l]) x[k] = __fmul_rn(x[k], __frcp_rn((float)g));
                  }
                }
                if (++h == c) {
                  h = 0;
                  ++l;
                }
              }
              v = make_float4(x[0], x[1], x[2], x[3]);
            }
          }
          if (aligned && f + 3 < span) {
            *reinterpret_cast<float4*>(ob + f) = v;
          } else {
            const float x[4] = {v.x, v.y, v.z, v.w};
            for (int k = 0; k < 4 && f + k < span; ++k) ob[f + k] = x[k];
          }
        }
        ch += dch;
        lv += dlv;
        if (ch >= c) {
          ch -= c;
          ++lv;
        }
      }
    } else if (!first) {
      // A later round: add to the partial sums of its voxels, a warp each.
      for (int l = warp; l < nv; l += kWarps) {
        const int g = sh.rc[l];
        if (g == 0) continue;
        const int end = sh.cur[l];
        const bool last = kMean && sh.seen[l] + g == sh.tot[l];
        const float r = kMean ? __frcp_rn((float)sh.tot[l]) : 1.0f;
        float* row = ob + l * c;
        if (kVec) {
          for (int h = 4 * lane; h < c; h += 128) {
            float4 a = group_sum4<T, kMean, true>(sh, src_c, c, h, end, g,
                                                  *reinterpret_cast<float4*>(row + h));
            *reinterpret_cast<float4*>(row + h) = last ? scale4(a, r) : a;
          }
        } else {
          for (int h = lane; h < c; h += 32) {
            const float a = group_sum1<T, kMean>(sh, src_c, c, h, end, g, row[h]);
            row[h] = last ? __fmul_rn(a, r) : a;
          }
        }
      }
    }
    __syncthreads();
    if (kMean)
      for (int i = tid; i < nv; i += kThreads) sh.seen[i] += sh.rc[i];
    first = false;
  } while (pos < m);
}

// One launch of voxel_sum_kernel over b clouds of m entries (rows feature
// rows each), s voxels, `tile` voxels per block.
template <typename T, bool kMean>
int launch_voxel_sum(const T* src, const int* ind, const float* w, int b, int m, int rows, int c,
                     int s, int tile, float* out, float* cnt, cudaStream_t st) {
  if (b <= 0 || s <= 0 || c < 0) return 0;
  if (tile < 1 || tile > kTileLimit) return (int)cudaErrorInvalidValue;
  tile = tile < s ? tile : s;
  if ((long long)tile * c >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  const int tiles = (s + tile - 1) / tile;
  const size_t bytes = shared_bytes(tile, kMean);
  const bool vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(src) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto kernel = vec ? voxel_sum_kernel<T, kMean, true> : voxel_sum_kernel<T, kMean, false>;
  kernel<<<(unsigned int)((long long)b * tiles), kThreads, bytes, st>>>(src, ind, w, m, rows, c,
                                                                        s, tile, tiles, out, cnt);
  return (int)cudaGetLastError();
}

// K3: a block covers `blockDim.y` consecutive points of one cloud
// (blockIdx.y) and its threads, along x, the point's row of channels in
// V-wide vectors (V = 4 f32 or 8 bf16: 16 bytes a load; V = 1 for the
// scalar tail). The block's 8 corner indices and weights a point are read
// once, as 16-byte loads where aligned, checked against [0, s) (int32 or
// int64, by I) and kept in shared memory for the point's threads.
constexpr int kGatherThreads = 128;      // threads a K3 block has at most (256 and 512: slower)
constexpr int kGatherPoints = kGatherThreads;  // points a K3 block covers at most

template <typename I>
__device__ __forceinline__ int corner_or_skip(I v, int s) {
  return v >= 0 && v < (I)s ? (int)v : -1;
}

// Element i of 16 bytes of a grid row, as a float: 4 f32, or 8 bf16 widened
// exactly. The rows stay raw words in registers until their add.
__device__ __forceinline__ unsigned word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}
template <typename T>
__device__ __forceinline__ float element(const uint4& u, int i) {
  if constexpr (sizeof(T) == 4) return __uint_as_float(word(u, i));
  const unsigned w = word(u, i >> 1);
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}

template <typename T, typename I, int V>
__global__ void __launch_bounds__(kGatherThreads)
corner_gather_kernel(const T* __restrict__ grid, const I* __restrict__ idx,
                     const float* __restrict__ w, float* __restrict__ out, int n, int s, int c,
                     bool vec_stage) {
  __shared__ int sv[kGatherPoints * 8];
  __shared__ float sw[kGatherPoints * 8];
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * blockDim.y;
  const int np = min((int)blockDim.y, n - p0);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  // The block's [np, 8] indices and weights: one contiguous span of each.
  const size_t base = ((size_t)b * n + p0) * 8;
  const int count = np * 8;
  if (vec_stage) {
    constexpr int kI = 16 / sizeof(I);   // indices a 16-byte load holds
    const I* ix = idx + base;
    for (int e = tid; e < count / kI; e += nthreads) {
      if constexpr (kI == 4) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(ix) + e);
        sv[4 * e] = corner_or_skip(v.x, s);
        sv[4 * e + 1] = corner_or_skip(v.y, s);
        sv[4 * e + 2] = corner_or_skip(v.z, s);
        sv[4 * e + 3] = corner_or_skip(v.w, s);
      } else {
        const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(ix) + e);
        sv[2 * e] = corner_or_skip(v.x, s);
        sv[2 * e + 1] = corner_or_skip(v.y, s);
      }
    }
    for (int e = tid; e < count / 4; e += nthreads) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(w + base) + e);
      sw[4 * e] = v.x; sw[4 * e + 1] = v.y; sw[4 * e + 2] = v.z; sw[4 * e + 3] = v.w;
    }
  } else {
    for (int e = tid; e < count; e += nthreads) {
      sv[e] = corner_or_skip(__ldg(idx + base + e), s);
      sw[e] = __ldg(w + base + e);
    }
  }
  __syncthreads();
  const int pl = threadIdx.y;
  if (pl >= np) return;
  int v[8];
  float wt[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    v[k] = sv[pl * 8 + k];
    wt[k] = sw[pl * 8 + k];
  }
  const T* g = grid + (size_t)b * s * c;   // s·c < 2^31: 32-bit offsets inside the cloud
  float* o = out + ((size_t)b * n + p0 + pl) * c;
  if constexpr (V == 1) {
    for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
      float x[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = v[k] >= 0 ? to_f32(g[v[k] * c + ch]) : 0.0f;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (v[k] >= 0) acc = __fadd_rn(acc, __fmul_rn(wt[k], x[k]));
      o[ch] = acc;
    }
  } else {
    for (int ch = threadIdx.x * V; ch < c; ch += blockDim.x * V) {
      uint4 x[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)   // the 8 row loads in flight together
        x[k] = v[k] >= 0 ? __ldg(reinterpret_cast<const uint4*>(g + v[k] * c + ch))
                         : make_uint4(0u, 0u, 0u, 0u);
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (v[k] >= 0) {
#pragma unroll
          for (int i = 0; i < V; ++i)
            acc[i] = __fadd_rn(acc[i], __fmul_rn(wt[k], element<T>(x[k], i)));
        }
      }
#pragma unroll
      for (int i = 0; i < V; i += 4)
        *reinterpret_cast<float4*>(o + ch + i) = make_float4(acc[i], acc[i + 1], acc[i + 2],
                                                             acc[i + 3]);
    }
  }
}

template <typename T, typename I>
int launch_corner_gather(const T* grid, const I* idx, const float* w, int b, int n, int c, int s,
                         float* out, cudaStream_t st) {
  if (b <= 0 || n <= 0 || c <= 0) return 0;
  if (b > 65535 || (long long)s * c >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  constexpr int V = sizeof(T) == 4 ? 4 : 8;   // 16 bytes of grid row a load
  const bool vec = c % V == 0 && reinterpret_cast<uintptr_t>(grid) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const bool vec_stage = reinterpret_cast<uintptr_t>(idx) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int lanes = vec ? c / V : c;           // threads a row wants
  const int x = lanes < 64 ? lanes : 64;       // at least 2 points a block
  const int y = kGatherThreads / x;            // points a block covers
  const dim3 block(x, y), blocks((n + y - 1) / y, b);
  if (vec)
    corner_gather_kernel<T, I, V><<<blocks, block, 0, st>>>(grid, idx, w, out, n, s, c,
                                                            vec_stage);
  else
    corner_gather_kernel<T, I, 1><<<blocks, block, 0, st>>>(grid, idx, w, out, n, s, c,
                                                            vec_stage);
  return (int)cudaGetLastError();
}

template <typename T>
int corner_gather_by_index(const T* grid, const void* idx, int idx_type, const float* w, int b,
                           int n, int c, int s, float* out, cudaStream_t st) {
  if (idx_type == 1)
    return launch_corner_gather(grid, (const long long*)idx, w, b, n, c, s, out, st);
  return launch_corner_gather(grid, (const int*)idx, w, b, n, c, s, out, st);
}

}  // namespace

// features [b, n, c], f32 (dtype 0) or bf16 (dtype 1); inds [b, n] int32
// (outside [0, s) = dropped); outputs out [b, s, c] and cnt [b, s] f32;
// `tile` voxels per block (1..1024). b·s and b·n below 2^31. One launch;
// returns cudaGetLastError() after it.
extern "C" int rift_scatter_mean(const void* features, int dtype, const int* inds, int b, int n,
                                 int c, int s, int tile, float* out, float* cnt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_voxel_sum<__nv_bfloat16, true>((const __nv_bfloat16*)features, inds, nullptr,
                                                 b, n, n, c, s, tile, out, cnt, st);
  return launch_voxel_sum<float, true>((const float*)features, inds, nullptr, b, n, n, c, s, tile,
                                       out, cnt, st);
}

// grid [b, s, c], f32 (dtype 0) or bf16 (dtype 1); idx [b, n, 8], int32
// (idx_type 0) or int64 (idx_type 1), outside [0, s) = skipped; w [b, n, 8]
// f32 -> out [b, n, c] f32. b <= 65535, s·c below 2^31. One launch;
// returns cudaGetLastError() after it.
extern "C" int rift_corner_gather(const void* grid, int dtype, const void* idx, int idx_type,
                                  const float* w, int b, int n, int c, int s, float* out,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return corner_gather_by_index((const __nv_bfloat16*)grid, idx, idx_type, w, b, n, c, s, out,
                                  st);
  return corner_gather_by_index((const float*)grid, idx, idx_type, w, b, n, c, s, out, st);
}

// dout [b, n, c] f32, idx [b, n, 8] int32 (outside [0, s) = skipped),
// w [b, n, 8] f32 -> dgrid [b, s, c] f32, every voxel written; `tile`
// voxels per block (1..1024). b·s and 8·b·n below 2^31. One launch;
// returns cudaGetLastError() after it.
extern "C" int rift_corner_scatter(const float* dout, const int* idx, const float* w, int b,
                                   int n, int c, int s, int tile, float* dgrid, void* stream) {
  return launch_voxel_sum<float, false>(dout, idx, w, b, 8 * n, n, c, s, tile, dgrid, nullptr,
                                        (cudaStream_t)stream);
}

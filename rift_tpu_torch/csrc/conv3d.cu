// K5 — 3×3×3 SAME Conv3d over a channels-last voxel grid, bf16 in, f32
// sums, bf16 out.
//
// Replaces: scripts/conv3d_kernel_experiment.py, `_conv3d_kernel` (launched
// by `conv3d_same_pallas`), the eval-mode drop-in for the voxel branch's
// `nn.Conv(cout, (3, 3, 3), padding="SAME", dtype=bfloat16)` of PVConv.
//   out[b, g, a, e, o] = bf16( Σ_{i,j,k ∈ {0,1,2}} Σ_c
//       x[b, g+i-1, a+j-1, e+k-1, c] · wt[(i·3 + j)·3 + k, o, c] )
//   with zero padding on all three axes (the α axis wraps in the
//   devoxelization but not here, as in the reference), bf16 × bf16
//   products, f32 sums, one rounding to bf16 at the end. No bias: the
//   caller adds it in bf16 to the rounded output, as flax does.
// Bound on this card: operations. At the bf16 model's shapes (b = 32
// clouds, r = 32, cin → cout of 71 → 64, 64 → 64, 64 → 128, 128 → 128)
// the four calls are 1.9e12 operations (2 · 27 · r³ · cin · cout · b),
// 1.90 ms at 989 TFLOP/s bf16, against 1.5 GB of grids read and written
// once: ~1300 operations per byte, above the H100's bf16 ridge of ~295.
//
// Design: an implicit GEMM on Hopper's tensor cores. M = voxels, N = the
// whole cout (one block of N = 64 or 128 output channels, so each input
// tile is loaded once per block when cout <= 128), K = 27 taps × cin in
// chunks of 16 channels (one MMA depth).
// - Tile: TG γ planes × 128/r α rows × all r β of one cloud, TG = 2 for
//   N = 128 (256 voxels) and TG = 4 for N = 64 (512 voxels), so each
//   consumer thread holds 128 f32 sums. The halo the 27 taps read is
//   (TG + 2) × (128/r + 2) × (r + 2) voxels: 3.2 input voxels loaded per
//   output voxel at r = 32, N = 128 (4.8 before), 2.4 at N = 64.
// - TMA, not im2col: the halo of one chunk is one tiled TMA load of a 5-D
//   tensor map over x, (c, β, α, γ, b), from (c0, −1, a0 − 1, g0 − 1, bi).
//   TMA fills coordinates outside the tensor with zeros, which is exactly
//   SAME padding, so no edge code; channels past cin are outside too, so a
//   cin of 71 reads zeros in the MMA's pad (the weights are zero there as
//   well). A tensor map needs every stride a multiple of 16 bytes: x may
//   have a voxel stride above cin (72 for 71 channels, see the wrapper).
//   The weights of 3 taps come by a 3-D map over [27, cout_p, cin_p].
//   Both use the 32-byte swizzle: a voxel's 16 channels are 32 bytes.
// - A ring of 2 halo stages and 6 weight stages (3 taps each) in shared
//   memory, each with a full and an empty mbarrier. One producer thread
//   (warpgroup 2, registers cut to 40 by setmaxnreg) keeps the loads in
//   flight; two consumer warpgroups (232 registers) run the MMAs. The
//   grid is persistent (one block per SM walking the tiles), so a tile's
//   epilogue overlaps the producer's loads of the next.
// - The shifted-window A operand: tap (i, j, k) reads the halo shifted by
//   (i, j, k), and a 64-row MMA tile spans several α rows whose halo rows
//   are r + 2 voxels apart, which no shared-memory descriptor describes.
//   So A comes from registers: each lane gives its own row address to
//   ldmatrix.x4 (16 voxels × 16 channels, the m16n8k16 A fragment that
//   wgmma takes per warp). The 32-byte swizzle TMA wrote (16-byte half
//   h of voxel P at h ^ bit 2 of P) makes the 8 rows of each ldmatrix
//   phase hit 8 distinct bank groups: no conflicts for any shift.
// - B (the weights, [tap][n][16 channels], K-major) is read by wgmma
//   through a descriptor in the 32-byte swizzle layout (8-row groups 256
//   bytes apart). wgmma.mma_async m64nNk16, f32 accumulators in
//   registers, each warpgroup 2 (N = 128) or 4 (N = 64) 64-row slices.
//   A consumer loads tap t + 1's A fragments while tap t's MMAs run (one
//   wgmma group in flight, three fragment buffers); a weight stage is
//   freed once its last tap's MMAs are done, a halo stage once its last
//   fragments are in registers.
// - Epilogue: each sum rounded once to bf16 and stored as bf16 pairs
//   straight from the accumulators; no bias, BatchNorm or activation (that
//   would move where bf16 rounds relative to the reference).
// The tensor maps are built per call on the host from the data pointers
// (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
// nothing beyond the CUDA runtime is linked) and passed as
// __grid_constant__ parameters.
#include <cuda.h>  // CUtensorMap and its enums (types only; the encoder is looked up at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;         // input channels per K step (one MMA depth, 32 bytes)
constexpr int kTapsPerStage = 3;   // weight taps per ring stage
constexpr int kHaloStages = 2;
constexpr int kWeightStages = 6;
constexpr int kConsumerWarps = 8;  // two warpgroups
constexpr int kThreads = 384;      // + one producer warpgroup

template <int N>
struct Tile {
  static constexpr int kPlanes = N == 128 ? 2 : 4;            // TG: γ planes per tile
  static constexpr int kRows = kPlanes * 128;                 // voxels per tile
  static constexpr int kSlices = kRows / 2 / 64;              // 64-row slices per warpgroup
  static constexpr int kWeightBytes = kTapsPerStage * N * kChunk * 2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spins until the barrier's phase of the given parity has completed. A
// wait of more than ~2^35 cycles (tens of seconds) can only be a fault:
// it traps, so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 35)) __trap();
  } while (!done);
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// wgmma descriptor of a K-major operand in the 32-byte swizzle layout:
// rows of 16 bf16 (32 bytes), 8-row groups 256 bytes apart.
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(256 >> 4) << 32) | ((uint64_t)3 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// D[64 × N] += A[64 × 16] (registers, this warp's 16 rows) · B[16 × N]
// (shared memory, descriptor b).
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64,%65,%66,%67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_tile(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 128) wgmma_n128(d, a, b); else wgmma_n64(d, a, b);
}

// x: tensor map over [b, r, r, r, cin] bf16 (box 16 × (r+2) × (128/r+2) ×
// (TG+2) × 1); w: over [27, cout_p, cin_p] bf16 (box 16 × N × 3); out
// [b, r, r, r, cout] bf16. `chunks` = cin_p / 16, `nblocks` = cout_p / N;
// `halo_stride` is one halo stage's bytes rounded up to 1024.
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
conv3d_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, uint16_t* __restrict__ out,
                    int b, int r, int cout, int chunks, int nblocks, int halo_bytes,
                    int halo_stride) {
  using T = Tile<N>;
  extern __shared__ uint8_t smem_raw[];
  // Stages aligned to 1024 bytes, so the swizzle is a function of the
  // offset inside a stage.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t halo0 = base;
  const uint32_t weight0 = halo0 + kHaloStages * halo_stride;
  const uint32_t bar0 = weight0 + kWeightStages * T::kWeightBytes;
  // Barriers, 8 bytes each: halo full, halo empty, weight full, weight empty.
  auto halo_full = [&](int s) { return bar0 + 8u * s; };
  auto halo_empty = [&](int s) { return bar0 + 8u * (kHaloStages + s); };
  auto weight_full = [&](int s) { return bar0 + 8u * (2 * kHaloStages + s); };
  auto weight_empty = [&](int s) {
    return bar0 + 8u * (2 * kHaloStages + kWeightStages + s);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kHaloStages; ++s) {
      mbar_init(halo_full(s), 1);
      mbar_init(halo_empty(s), kConsumerWarps);
    }
    for (int s = 0; s < kWeightStages; ++s) {
      mbar_init(weight_full(s), 1);
      mbar_init(weight_empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int ta = 128 / r;                        // α rows per tile
  const int alpha_tiles = r / ta;
  const int tiles_per_cloud = (r / T::kPlanes) * alpha_tiles;
  const int items = b * tiles_per_cloud * nblocks;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // Producer: one thread keeps the TMA loads in flight.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int hs = 0, hph = 0, ws = 0, wph = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int mt = item / nblocks, nb = item % nblocks;
        const int bi = mt / tiles_per_cloud, t = mt % tiles_per_cloud;
        const int g0 = (t / alpha_tiles) * T::kPlanes, a0 = (t % alpha_tiles) * ta;
        for (int c = 0; c < chunks; ++c) {
          mbar_wait(halo_empty(hs), hph ^ 1);
          mbar_expect_tx(halo_full(hs), halo_bytes);
          tma_load_5d(halo0 + hs * halo_stride, &xmap, halo_full(hs), c * kChunk, -1, a0 - 1,
                      g0 - 1, bi);
          if (++hs == kHaloStages) { hs = 0; hph ^= 1; }
          for (int g = 0; g < 27 / kTapsPerStage; ++g) {
            mbar_wait(weight_empty(ws), wph ^ 1);
            mbar_expect_tx(weight_full(ws), T::kWeightBytes);
            tma_load_3d(weight0 + ws * T::kWeightBytes, &wmap, weight_full(ws), c * kChunk,
                        nb * N, g * kTapsPerStage);
            if (++ws == kWeightStages) { ws = 0; wph ^= 1; }
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int rp = r + 2, ap = ta + 2;          // halo extents along β and α
    const int half_rows = T::kRows / 2;
    // Halo position read by this lane's ldmatrix row at tap (0, 0, 0), per
    // slice: tile row m -> (γ, α, β) inside the tile -> the halo voxel
    // offset by −1 on each axis.
    int p0[T::kSlices];
#pragma unroll
    for (int s = 0; s < T::kSlices; ++s) {
      const int m = wg * half_rows + s * 64 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int dg = m / (ta * r), rem = m % (ta * r);
      p0[s] = (dg * ap + rem / r) * rp + rem % r;
    }
    const uint32_t khalf = (uint32_t)(lane >> 4);  // which 8 of the 16 channels
    // The A fragments of one tap (16 rows of each slice) from the halo at
    // tap offset `off`.
    auto load_a = [&](uint32_t (&frag)[T::kSlices][4], uint32_t halo, int off) {
#pragma unroll
      for (int s = 0; s < T::kSlices; ++s) {
        const uint32_t p = (uint32_t)(p0[s] + off);
        ldmatrix_x4(frag[s], halo + p * 32u + ((khalf ^ ((p >> 2) & 1u)) << 4));
      }
    };
    // One buffer per tap of a weight stage: tap t + 1's fragments load while
    // tap t's MMAs run, with one wgmma group in flight.
    uint32_t a[kTapsPerStage][T::kSlices][4];
    int hs = 0, hph = 0, ws = 0, wph = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int mt = item / nblocks, nb = item % nblocks;
      const int bi = mt / tiles_per_cloud, t = mt % tiles_per_cloud;
      const int g0 = (t / alpha_tiles) * T::kPlanes, a0 = (t % alpha_tiles) * ta;
      float acc[T::kSlices][N / 2];
#pragma unroll
      for (int s = 0; s < T::kSlices; ++s)
#pragma unroll
        for (int e = 0; e < N / 2; ++e) acc[s][e] = 0.0f;

      mbar_wait(halo_full(hs), hph);
      uint32_t halo = halo0 + hs * halo_stride;
      load_a(a[0], halo, 0);
      int held = -1;  // the weight stage whose last tap's MMAs may still run
      for (int c = 0; c < chunks; ++c) {
        for (int g = 0; g < 27 / kTapsPerStage; ++g) {
          mbar_wait(weight_full(ws), wph);
          const uint32_t wts = weight0 + ws * T::kWeightBytes;
          const int i = g / 3, j = g % 3;       // taps (i, j, 0..2)
#pragma unroll
          for (int k = 0; k < kTapsPerStage; ++k) {
            wgmma_fence();
            const uint64_t desc = sw32_desc(wts + k * N * kChunk * 2);
#pragma unroll
            for (int s = 0; s < T::kSlices; ++s) wgmma_tile<N>(acc[s], a[k][s], desc);
            wgmma_commit();
            wgmma_wait<1>();  // the previous tap's MMAs are done
            if (k == 0 && held >= 0 && lane == 0) mbar_arrive(weight_empty(held));
            if (k + 1 < kTapsPerStage) {
              load_a(a[k + 1], halo, (i * ap + j) * rp + k + 1);
            } else if (g + 1 < 27 / kTapsPerStage) {
              load_a(a[0], halo, ((g + 1) / 3 * ap + (g + 1) % 3) * rp);
            } else {
              // The chunk's last fragments are in registers: free its halo.
              if (lane == 0) mbar_arrive(halo_empty(hs));
              if (++hs == kHaloStages) { hs = 0; hph ^= 1; }
              if (c + 1 < chunks) {
                mbar_wait(halo_full(hs), hph);
                halo = halo0 + hs * halo_stride;
                load_a(a[0], halo, 0);
              }
            }
          }
          held = ws;
          if (++ws == kWeightStages) { ws = 0; wph ^= 1; }
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(weight_empty(held));

      // Epilogue: accumulator (row g or g + 8 of the warp's 16, columns
      // 8j + 2(lane % 4) + {0, 1}) -> one bf16 rounding -> out.
      const bool pairs = (cout % 2) == 0;
#pragma unroll
      for (int s = 0; s < T::kSlices; ++s) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = wg * half_rows + s * 64 + warp * 16 + (lane >> 2) + h * 8;
          const int dg = m / (ta * r), rem = m % (ta * r);
          const size_t voxel =
              (((size_t)bi * r + g0 + dg) * r + a0 + rem / r) * (size_t)r + rem % r;
          uint16_t* o = out + voxel * (size_t)cout;
#pragma unroll
          for (int jn = 0; jn < N / 8; ++jn) {
            const int col = nb * N + jn * 8 + 2 * (lane & 3);
            const float v0 = acc[s][4 * jn + 2 * h], v1 = acc[s][4 * jn + 2 * h + 1];
            if (pairs) {
              if (col < cout)
                *reinterpret_cast<__nv_bfloat162*>(o + col) = __floats2bfloat162_rn(v0, v1);
            } else {
              if (col < cout) o[col] = __bfloat16_as_ushort(__float2bfloat16_rn(v0));
              if (col + 1 < cout) o[col + 1] = __bfloat16_as_ushort(__float2bfloat16_rn(v1));
            }
          }
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

template <int N>
int launch(const void* x, int x_stride, const void* wt, void* out, int b, int r, int cin,
           int cin_p, int cout, int cout_p, cudaStream_t stream) {
  using T = Tile<N>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const int ta = 128 / r;
  CUtensorMap xmap, wmap;
  const cuuint64_t row = (cuuint64_t)x_stride * 2;  // bytes between voxels
  const cuuint64_t xdim[5] = {(cuuint64_t)cin, (cuuint64_t)r, (cuuint64_t)r, (cuuint64_t)r,
                              (cuuint64_t)b};
  const cuuint64_t xstride[4] = {row, row * r, row * r * r, row * r * r * r};
  const cuuint32_t xbox[5] = {kChunk, (cuuint32_t)(r + 2), (cuuint32_t)(ta + 2),
                              (cuuint32_t)(T::kPlanes + 2), 1};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x), xdim, xstride,
             xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t wdim[3] = {(cuuint64_t)cin_p, (cuuint64_t)cout_p, 27};
  const cuuint64_t wstride[2] = {(cuuint64_t)cin_p * 2, (cuuint64_t)cin_p * cout_p * 2};
  const cuuint32_t wbox[3] = {kChunk, N, kTapsPerStage};
  if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(wt), wdim, wstride,
             wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;

  const int halo_bytes = kChunk * 2 * (r + 2) * (ta + 2) * (T::kPlanes + 2);
  const int halo_stride = (halo_bytes + 1023) & ~1023;
  const int smem = 1024 + kHaloStages * halo_stride + kWeightStages * T::kWeightBytes +
                   8 * 2 * (kHaloStages + kWeightStages);
  cudaError_t err = cudaFuncSetAttribute(conv3d_wgmma_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int nblocks = cout_p / N;
  const long long items = (long long)b * (r / T::kPlanes) * (r / ta) * nblocks;
  const int grid = (int)(items < sms ? items : sms);
  conv3d_wgmma_kernel<N><<<grid, kThreads, smem, stream>>>(
      xmap, wmap, (uint16_t*)out, b, r, cout, cin_p / kChunk, nblocks, halo_bytes, halo_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// x [b, r, r, r, cin] bf16 with voxel stride x_stride >= cin elements
// (x_stride · 2 and the address multiples of 16 bytes); wt [27, cout_p,
// cin_p] bf16, tap (i·3 + j)·3 + k holding the Conv3d weight w[:, :, i, j, k]
// zero-padded (cin_p a multiple of 16; cout_p a multiple of n_tile);
// out [b, r, r, r, cout] bf16 contiguous. r must be 16, 32, 64 or 128 and
// n_tile 64 or 128. Returns cudaGetLastError() after the launch.
extern "C" int rift_conv3d_same(const void* x, int x_stride, const void* wt, void* out, int b,
                                int r, int cin, int cin_p, int cout, int cout_p, int n_tile,
                                void* stream) {
  if (b <= 0 || cout <= 0) return 0;
  if ((r != 16 && r != 32 && r != 64 && r != 128) || cin <= 0 || cin_p % kChunk != 0 ||
      cin_p < cin || x_stride < cin || (x_stride * 2) % 16 != 0 || (uintptr_t)x % 16 != 0 ||
      (uintptr_t)wt % 16 != 0 || (uintptr_t)out % 4 != 0 || (n_tile != 64 && n_tile != 128) ||
      cout_p % n_tile != 0 || cout_p < cout)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_tile == 128) return launch<128>(x, x_stride, wt, out, b, r, cin, cin_p, cout, cout_p, st);
  return launch<64>(x, x_stride, wt, out, b, r, cin, cin_p, cout, cout_p, st);
}

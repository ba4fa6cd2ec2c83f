// K5 — 3×3×3 SAME Conv3d over a channels-last voxel grid, bf16 in, f32
// sums, bf16 out.
//
// Replaces: scripts/conv3d_kernel_experiment.py, `_conv3d_kernel` (launched
// by `conv3d_same_pallas`), the eval-mode drop-in for the voxel branch's
// `nn.Conv(cout, (3, 3, 3), padding="SAME", dtype=bfloat16)` of PVConv.
//   out[b, g, a, e, o] = bf16( Σ_{i,j,k ∈ {0,1,2}} Σ_c
//       x[b, g+i-1, a+j-1, e+k-1, c] · wt[(i·3 + j)·3 + k, c, o] )
//   with zero padding on all three axes (the α axis wraps in the
//   devoxelization but not here, as in the reference), bf16 × bf16
//   products, f32 sums, one rounding to bf16 at the end. No bias: the
//   caller adds it in bf16 to the rounded output, as flax does.
// Bound on this card: operations. At the bf16 model's shapes (b = 32
// clouds, r = 32, cin → cout of 71 → 64, 64 → 64, 64 → 128, 128 → 128)
// the four calls are 1.9e12 operations (2 · 27 · r³ · cin · cout · b)
// against 1.5 GB of grids read and written once: ~1300 operations per
// byte, above the H100's bf16 ridge of ~295.
// Design (simple first, see PERF.md): an implicit GEMM on the tensor cores
// through nvcuda::wmma bf16 16×16×16 fragments with f32 accumulators.
// M = the voxels of a cloud, N = cout, K = 27 taps × cin padded to 16.
// A block owns 128 output voxels (one γ, 128/r α rows, all r β) and 64
// output channels, four warps of 32 voxels × 64 channels each. For every
// chunk of 16 input channels it stages in shared memory the input voxels
// that the 27 taps of its tile read (3 × (128/r + 2) × (r + 2) positions,
// zeros outside the grid) and the 27 × 16 × 64 weights; a tap is then a
// shifted row window of the staged halo, so every input voxel is read
// from device memory once per chunk and block rather than once per tap.
// No TMA, wgmma or pipelining yet; the ported reference's K-stacked tap
// pairs and sublane-aligned slices exist for the TPU's MXU and are not
// carried over.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kRows = 128;             // output voxels per block
constexpr int kCols = 64;              // output channels per block
constexpr int kChunk = 16;             // input channels per staging step (one MMA depth)
constexpr int kWarps = 4;              // each warp: 32 voxels × 64 channels = 2 × 4 fragments
constexpr int kThreads = kWarps * 32;
constexpr int kBStride = kCols + 8;    // padded weight row (bf16), against bank conflicts
constexpr int kCStride = kCols + 4;    // padded row of the f32 output tile

__host__ __device__ inline int halo_positions(int r) { return 3 * (kRows / r + 2) * (r + 2); }

size_t smem_bytes(int r) {
  const size_t halo = (size_t)halo_positions(r) * kChunk * sizeof(uint16_t);
  const size_t weights = (size_t)27 * kChunk * kBStride * sizeof(uint16_t);
  const size_t tile = (size_t)kRows * kCStride * sizeof(float);
  return halo + weights > tile ? halo + weights : tile;
}

union Pack8 {
  uint4 u;
  uint16_t h[8];
};

// x [b, r, r, r, cin] and the result [b, r, r, r, cout] are bf16 bit
// patterns; wt [27, cin_p, cout_p] bf16, zero-padded. `vec` says that cin
// is a multiple of 8 and x is 16-byte aligned, so 8 channels load at once.
__global__ void __launch_bounds__(kThreads)
conv3d_same_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ wt,
                   uint16_t* __restrict__ out, int r, int cin, int cin_p, int cout,
                   int cout_p, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ta = kRows / r;  // α rows of the tile
  const int hp = halo_positions(r);
  uint16_t* as = reinterpret_cast<uint16_t*>(smem);  // [3][ta + 2][r + 2][kChunk]
  uint16_t* bs = as + (size_t)hp * kChunk;            // [27][kChunk][kBStride]
  float* cs = reinterpret_cast<float*>(smem);         // [kRows][kCStride], after the K loop

  const long long r3 = (long long)r * r * r;
  const long long tile0 = (long long)blockIdx.x * kRows;  // first voxel, flat over b · r³
  const int bi = (int)(tile0 / r3);
  const int f0 = (int)(tile0 % r3);
  const int g0 = f0 / (r * r);
  const int a0 = (f0 / r) % r;
  const int n0 = blockIdx.y * kCols;
  const int warp = threadIdx.x / 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf) wmma::fill_fragment(acc[mf][nf], 0.0f);

  for (int c0 = 0; c0 < cin_p; c0 += kChunk) {
    // The halo of this chunk: two groups of 8 channels per position.
    for (int it = threadIdx.x; it < hp * 2; it += kThreads) {
      const int pos = it >> 1;
      const int ch = c0 + (it & 1) * 8;
      const int db = pos % (r + 2);
      const int da = (pos / (r + 2)) % (ta + 2);
      const int dg = pos / ((r + 2) * (ta + 2));
      const int gg = g0 + dg - 1, aa = a0 + da - 1, bb = db - 1;
      Pack8 v;
      v.u = make_uint4(0u, 0u, 0u, 0u);
      if (gg >= 0 && gg < r && aa >= 0 && aa < r && bb >= 0 && bb < r && ch < cin) {
        const uint16_t* src = x + ((((size_t)bi * r + gg) * r + aa) * r + bb) * cin + ch;
        if (vec) {
          v.u = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v.h[e] = (ch + e < cin) ? src[e] : (uint16_t)0;
        }
      }
      *reinterpret_cast<uint4*>(as + (size_t)pos * kChunk + (it & 1) * 8) = v.u;
    }
    // The 27 taps' weights of this chunk and this block's 64 channels.
    for (int it = threadIdx.x; it < 27 * kChunk * (kCols / 8); it += kThreads) {
      const int col8 = it % (kCols / 8);
      const int row = it / (kCols / 8);  // tap · kChunk + k
      const int tap = row / kChunk, k = row % kChunk;
      *reinterpret_cast<uint4*>(bs + (size_t)row * kBStride + col8 * 8) =
          *reinterpret_cast<const uint4*>(wt + ((size_t)tap * cin_p + c0 + k) * cout_p + n0 +
                                          col8 * 8);
    }
    __syncthreads();

    for (int tap = 0; tap < 27; ++tap) {
      const int i = tap / 9, j = (tap / 3) % 3, k = tap % 3;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
#pragma unroll
      for (int mf = 0; mf < 2; ++mf) {
        // 16 voxels along β of one α row; tap (i, j, k) reads them shifted
        // by (i, j, k) - 1, which is the staged position (i, row + j, β + k).
        const int m = warp * 32 + mf * 16;
        const int row = m / r, be = m % r;
        const uint16_t* p = as + ((size_t)(i * (ta + 2) + row + j) * (r + 2) + be + k) * kChunk;
        wmma::load_matrix_sync(a[mf], reinterpret_cast<const __nv_bfloat16*>(p), kChunk);
      }
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(
            b, reinterpret_cast<const __nv_bfloat16*>(bs + (size_t)tap * kChunk * kBStride +
                                                      nf * 16),
            kBStride);
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) wmma::mma_sync(acc[mf][nf], a[mf], b, acc[mf][nf]);
      }
    }
    __syncthreads();
  }

  // Epilogue: the f32 tile through shared memory, rounded once to bf16.
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
      wmma::store_matrix_sync(cs + (size_t)(warp * 32 + mf * 16) * kCStride + nf * 16,
                              acc[mf][nf], kCStride, wmma::mem_row_major);
  __syncthreads();
  for (int it = threadIdx.x; it < kRows * kCols; it += kThreads) {
    const int m = it / kCols, n = it % kCols;
    if (n0 + n < cout)
      out[((size_t)tile0 + m) * cout + n0 + n] =
          __bfloat16_as_ushort(__float2bfloat16_rn(cs[(size_t)m * kCStride + n]));
  }
}

}  // namespace

// x [b, r, r, r, cin] bf16; wt [27, cin_p, cout_p] bf16 with tap
// (i·3 + j)·3 + k holding the Conv3d weight w[:, :, i, j, k] transposed to
// [cin, cout] and zero-padded (cin_p a multiple of 16, cout_p of 64);
// out [b, r, r, r, cout] bf16. r must be 16, 32, 64 or 128. Returns
// cudaGetLastError() after the launch.
extern "C" int rift_conv3d_same(const void* x, const void* wt, void* out, int b, int r, int cin,
                                int cin_p, int cout, int cout_p, void* stream) {
  if (b <= 0 || cout <= 0) return 0;
  if (r % 16 != 0 || kRows % r != 0 || cin_p % kChunk != 0 || cin_p < cin ||
      cout_p % kCols != 0 || cout_p < cout)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(r);
  cudaError_t err = cudaFuncSetAttribute(conv3d_same_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = (cin % 8 == 0) && ((uintptr_t)x % 16 == 0);
  const dim3 grid((unsigned int)((long long)b * r * r * r / kRows),
                  (unsigned int)(cout_p / kCols));
  conv3d_same_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint16_t*)x, (const uint16_t*)wt, (uint16_t*)out, r, cin, cin_p, cout, cout_p, vec);
  return (int)cudaGetLastError();
}

// Hand-written Hopper (sm_90a) kernel for the device SGB composer.
//
// K3  spgemm_bool_u8  replaces repro/kernels/spgemm_bsr.py::_spgemm_kernel
//
// Boolean product of tile-padded 0/1 matrices, out = (A @ B) > 0, where the
// (mi, ki) x (ki, ni) pair of 128 x 128 tiles is multiplied only when both
// tile-occupancy bits are set.  The TPU kernel runs a grid (Mt, Nt, Kt) with
// k innermost and carries the output tile in VMEM across the k steps.  Here
// one CTA owns one output tile and loops over ki itself: the liveness test
// a_occ[mi*Kt+ki] && b_occ[ki*Nt+ni] is uniform across the CTA, so a dead
// pair costs two bitmap reads and no tile loads.  On store the tile is
// saturated to 0/1 and the CTA writes the tile's occupancy bit as well
// (__syncthreads_or of "any nonzero"), so the composer's next step needs no
// second scan of the output.
//
// Exactness: operands are uint8 0/1, products are 0 or 1 and each output sums
// at most K <= 14,336 of them in int32 (__dp4a, four k values per word), so
// the result is exact whatever the order of the sums; runs repeat bit for bit.
//
// Bound: the work is 2 * 128^3 operations per live tile pair; at the shapes of
// the SGB plans (98-99 % of ACM's and IMDB's pairs live, about half of DBLP's
// on its .PA steps) that is far above the bytes of the uint8 operands, so the
// kernel is bound by operations.  The int8 tensor cores (1,979 TOP/s, exact
// for 0/1) set the bound; this first kernel runs on the CUDA cores' __dp4a,
// well below it.  Tensor cores (mma.sync / wgmma on int8), TMA and per-tile
// lists of live k are later work.
//
// Layout: 256 threads as 16 x 16; thread (ty, tx) owns the 8 x 8 outputs at
// rows ty + 16 i and columns tx + 16 j.  Per live pair the CTA stages four
// 128 x 32 slabs of A (rows, k contiguous) and of B (transposed to columns,
// k contiguous) in shared memory; rows are padded by one word so that the
// 16 column reads of a warp hit 16 banks.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;             // TILE
constexpr int kBK = 32;                // k depth of one staged slab
constexpr int kThreads = 256;          // 16 x 16
constexpr int kPitch = kBK / 4 + 1;    // words per staged row (+1 pad word)

__global__ void __launch_bounds__(kThreads)
spgemm_bool_tile_kernel(const uint8_t* __restrict__ a,
                        const uint8_t* __restrict__ b,
                        const int* __restrict__ a_occ,
                        const int* __restrict__ b_occ,
                        uint8_t* __restrict__ out,
                        int* __restrict__ out_occ,
                        int nt, int kt) {
  // s_a[m * kPitch + k / 4]: byte k % 4 of the word is A[m][k] of the slab
  // s_b[n * kPitch + k / 4]: byte k % 4 of the word is B[k][n] of the slab
  __shared__ uint32_t s_a[kTile * kPitch];
  __shared__ uint32_t s_b[kTile * kPitch];

  const int ni = blockIdx.x;
  const int mi = blockIdx.y;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t lda = (size_t)kt * kTile;  // K
  const size_t ldb = (size_t)nt * kTile;  // N

  unsigned int acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0u;

  for (int ki = 0; ki < kt; ++ki) {
    if (a_occ[mi * kt + ki] <= 0 || b_occ[ki * nt + ni] <= 0) continue;
    const uint8_t* a_tile = a + (size_t)mi * kTile * lda + (size_t)ki * kTile;
    const uint8_t* b_tile = b + (size_t)ki * kTile * ldb + (size_t)ni * kTile;
    for (int kk = 0; kk < kTile; kk += kBK) {
      __syncthreads();  // every thread is done with the previous slab
      {  // A: 128 rows x 32 bytes, 16 bytes per thread
        const int row = threadIdx.x >> 1;
        const int half = threadIdx.x & 1;
        const uint4 v = *reinterpret_cast<const uint4*>(
            a_tile + row * lda + kk + half * 16);
        uint32_t* dst = s_a + row * kPitch + half * 4;
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      }
      {  // B: 32 rows (k) x 128 bytes, 16 bytes per thread, transposed
        const int k = threadIdx.x >> 3;
        const int n0 = (threadIdx.x & 7) * 16;
        const uint4 v = *reinterpret_cast<const uint4*>(
            b_tile + (size_t)(kk + k) * ldb + n0);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
        uint8_t* sb = reinterpret_cast<uint8_t*>(s_b);
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          sb[(n0 + q) * kPitch * 4 + k] = (uint8_t)(w[q >> 2] >> (8 * (q & 3)));
        }
      }
      __syncthreads();
#pragma unroll
      for (int k4 = 0; k4 < kBK / 4; ++k4) {
        unsigned int av[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = s_a[(ty + 16 * i) * kPitch + k4];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = s_b[(tx + 16 * j) * kPitch + k4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
      }
    }
  }

  int any = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint8_t* row = out + ((size_t)mi * kTile + ty + 16 * i) * ldb + (size_t)ni * kTile;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int bit = acc[i][j] > 0u ? 1 : 0;
      row[tx + 16 * j] = (uint8_t)bit;
      any |= bit;
    }
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) out_occ[mi * nt + ni] = any ? 1 : 0;
}

}  // namespace

extern "C" int spgemm_bool_u8(const void* a, const void* b, const void* a_occ,
                              const void* b_occ, void* out, void* out_occ,
                              int mt, int nt, int kt, void* stream) {
  if (mt <= 0 || nt <= 0 || kt < 0 || mt > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(nt, mt);
  spgemm_bool_tile_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)a, (const uint8_t*)b, (const int*)a_occ,
      (const int*)b_occ, (uint8_t*)out, (int*)out_occ, nt, kt);
  return (int)cudaGetLastError();
}

// Hand-written Hopper (sm_90a) kernels for the banded NA path.
//
// K1  na_seg_sum_f32        replaces repro/kernels/seg_sum.py::_na_kernel
// K2  na_softmax_stats_f32  replaces repro/kernels/edge_softmax.py::_stats_kernel
//
// Both consume the restructurer's packed edge blocks: block b holds count[b]
// valid slots (the rest is padding) whose sources lie in the 512-row band
// band[b] and whose destinations lie in the 128-row tile dst_tile[b].  The
// TPU kernels run the blocks as a sequential grid: a tile is zeroed on its
// first touch ever and accumulated on every later visit, including visits
// that are not adjacent in the schedule.  CTAs on an H100 run concurrently,
// so here every destination tile has ONE owner CTA that walks the tile's
// blocks (tile_blocks[tile_ptr[t] : tile_ptr[t+1]], ascending schedule order)
// and only the valid prefix of each block.  No atomics; results repeat bit
// for bit; a tile with no blocks writes zeros (K1) or (-1e30, 0) (K2).
//
// Bound: both kernels are bound by bytes.  K1 moves the gathered h rows, the
// valid-slot metadata (int16 src/dst, f32 weight) and the output tile; K2 the
// valid logits and dst ids plus (m, s).  With 88-98% of every 256-slot block
// padding, walking count[b] slots instead of the TPU's full one-hot products
// is what keeps the work proportional to the real edges.
//
// Known limit: a semantic graph has only 24-47 destination tiles at full
// scale, so few CTAs are in flight (K1 launches tiles x ceil(D/32) CTAs, K2
// one CTA per tile).  Splitting a tile's block list across CTAs with a
// deterministic second-pass reduction is later work.
//
// Each C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 128;   // DST_TILE
constexpr int kEdgeBlock = 256;  // EDGE_BLOCK
constexpr int kCols = 32;        // K1 feature columns per CTA: one per lane
constexpr int kWarps = 8;        // K1 warps per CTA
constexpr float kNeg = -1e30f;   // K2 init of m

// K1: one CTA owns (dst tile, 32-column chunk).  Lane l owns column
// chunk*32 + l; warp w owns the tile rows r with r % 8 == w.  Each warp scans
// every valid slot of the block (staged in shared memory) and accumulates the
// slots whose destination row it owns, so every accumulator element has
// exactly one writer and sums its slots in schedule order.
__global__ void __launch_bounds__(kWarps * 32)
seg_sum_tile_kernel(const int* __restrict__ tile_ptr,
                    const int* __restrict__ tile_blocks,
                    const int* __restrict__ band,
                    const int* __restrict__ count,
                    const int16_t* __restrict__ src_local,
                    const int16_t* __restrict__ dst_local,
                    const float* __restrict__ w,
                    const float* __restrict__ h,
                    float* __restrict__ out,
                    int d, int src_band) {
  __shared__ float acc[kTileRows][kCols];
  __shared__ int s_src[kEdgeBlock];
  __shared__ int s_dst[kEdgeBlock];
  __shared__ float s_w[kEdgeBlock];

  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.y * kCols + lane;
  const bool has_col = col < d;

  for (int r = warp; r < kTileRows; r += kWarps) acc[r][lane] = 0.f;

  const int b_end = tile_ptr[tile + 1];
  for (int i = tile_ptr[tile]; i < b_end; ++i) {
    const int b = tile_blocks[i];
    const int n = count[b];
    const int base = band[b] * src_band;
    const size_t off = (size_t)b * kEdgeBlock;
    __syncthreads();  // every warp is done with the previous block's slots
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      s_src[k] = base + src_local[off + k];
      s_dst[k] = dst_local[off + k];
      s_w[k] = w[off + k];
    }
    __syncthreads();
    if (has_col) {
      for (int k = 0; k < n; ++k) {
        const int r = s_dst[k];
        if ((r & (kWarps - 1)) == warp) {
          acc[r][lane] += s_w[k] * h[(size_t)s_src[k] * d + col];
        }
      }
    }
  }
  if (has_col) {
    for (int r = warp; r < kTileRows; r += kWarps) {
      out[((size_t)tile * kTileRows + r) * d + col] = acc[r][lane];
    }
  }
}

// K2: one CTA owns a dst tile, thread r owns row r.  Per block, over the
// valid prefix: the row's block max, then the online update of
// edge_softmax.py:51-61 (scale is 0 while m is still the -1e30 init).
__global__ void __launch_bounds__(kTileRows)
softmax_stats_tile_kernel(const int* __restrict__ tile_ptr,
                          const int* __restrict__ tile_blocks,
                          const int* __restrict__ count,
                          const int16_t* __restrict__ dst_local,
                          const float* __restrict__ logits,
                          float* __restrict__ m_out,
                          float* __restrict__ s_out) {
  __shared__ float s_l[kEdgeBlock];
  __shared__ int s_dst[kEdgeBlock];

  const int tile = blockIdx.x;
  const int row = threadIdx.x;
  float m = kNeg;
  float s = 0.f;

  const int b_end = tile_ptr[tile + 1];
  for (int i = tile_ptr[tile]; i < b_end; ++i) {
    const int b = tile_blocks[i];
    const int n = count[b];
    const size_t off = (size_t)b * kEdgeBlock;
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      s_l[k] = logits[off + k];
      s_dst[k] = dst_local[off + k];
    }
    __syncthreads();
    float bmax = kNeg;
    for (int k = 0; k < n; ++k) {
      if (s_dst[k] == row) bmax = fmaxf(bmax, s_l[k]);
    }
    const float m_new = fmaxf(m, bmax);
    const float scale = (m > 0.5f * kNeg) ? expf(m - m_new) : 0.f;
    float add = 0.f;
    for (int k = 0; k < n; ++k) {
      if (s_dst[k] == row) add += expf(s_l[k] - m_new);
    }
    s = s * scale + add;
    m = m_new;
  }
  m_out[(size_t)tile * kTileRows + row] = m;
  s_out[(size_t)tile * kTileRows + row] = s;
}

}  // namespace

extern "C" int na_seg_sum_f32(const void* tile_ptr, const void* tile_blocks,
                              const void* band, const void* count,
                              const void* src_local, const void* dst_local,
                              const void* w, const void* h, void* out,
                              int num_tiles, int d, int src_band,
                              void* stream) {
  if (num_tiles <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(num_tiles, (d + kCols - 1) / kCols);
  seg_sum_tile_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int*)tile_ptr, (const int*)tile_blocks, (const int*)band,
      (const int*)count, (const int16_t*)src_local, (const int16_t*)dst_local,
      (const float*)w, (const float*)h, (float*)out, d, src_band);
  return (int)cudaGetLastError();
}

extern "C" int na_softmax_stats_f32(const void* tile_ptr,
                                    const void* tile_blocks,
                                    const void* count, const void* dst_local,
                                    const void* logits, void* m_out,
                                    void* s_out, int num_tiles,
                                    void* stream) {
  if (num_tiles <= 0) return (int)cudaErrorInvalidValue;
  softmax_stats_tile_kernel<<<num_tiles, kTileRows, 0, (cudaStream_t)stream>>>(
      (const int*)tile_ptr, (const int*)tile_blocks, (const int*)count,
      (const int16_t*)dst_local, (const float*)logits, (float*)m_out,
      (float*)s_out);
  return (int)cudaGetLastError();
}

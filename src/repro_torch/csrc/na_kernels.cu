// Hand-written Hopper (sm_90a) kernels for the banded NA path.
//
// K1  na_seg_sum_f32        replaces repro/kernels/seg_sum.py::_na_kernel
// K2  na_softmax_stats_f32  replaces repro/kernels/edge_softmax.py::_stats_kernel
//
// Both read the row-major view of a packing that PackedEdges.row_edges()
// builds on the host: row_ptr / row_src / row_slot list every destination
// row's valid in-edges in schedule order (row_slot indexes the (nb, 256)
// blocked weights or logits), and a work list of int4 items
// (row, kind, edge_begin, edge_end), one per warp, 8 per CTA:
//   kind > 0   a run of `kind` whole rows (<= 64 edges, <= 32 rows);
//   kind == 0  idle padding;
//   kind < 0   one slice of a heavy row; the first slice holds -k for the
//              row's k slices, which follow it in the same CTA.
// A warp writes each of its rows once: no atomics, no tile in shared
// memory, results repeat bit for bit, a row with no edges reads 0 (K1) or
// (-1e30, 0) (K2).  A heavy row's partials meet in shared memory and the
// warp of its first slice adds them in slice order.
//
// Bound: both are bound by bytes.  On ACM PAP at scale 1.0 and D = 64 the
// least traffic is 0.75 us (K1) and 0.22 us (K2) at 3.35 TB/s, below the
// cost of one launch, so at these sizes even half the bound is out of
// reach; what counts is keeping the card busy for the few microseconds
// the work takes.  The TPU kernels' tile-owner walk, ported first, lost
// 10x to index_add_ for three reasons, and the design answers each:
//  - too few CTAs (one per 128-row tile: 24-48 on 132 SMs): the work list
//    gives one warp per <= 64 edges, some 2,000 warps on ACM PAP;
//  - a serial walk over a tile's ~300 mostly-padding blocks with two
//    barriers and a chain of dependent loads per block: a warp reads its
//    edges' (src, slot) pairs and weights in one coalesced pass and never
//    meets a barrier unless its CTA holds a heavy row;
//  - one dependent gather per slot per warp, each warp scanning every
//    slot: a warp touches only its own edges and keeps 16 gathered h rows
//    in flight before it adds them up, in edge order.
// Skew (in-degree up to 1,483 on DBLP APTPA) is met by splitting a row
// with more than 64 edges over up to 8 warps of one CTA.
//
// Each C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;     // work items (warps) per CTA: ITEMS_PER_CTA
constexpr int kGroup = 64;    // edges a warp holds in registers, 2 a lane
constexpr int kBatch = 16;    // K1: gathered h rows in flight per lane
constexpr float kNeg = -1e30f;  // K2: m of a row with no edges
constexpr unsigned kAll = 0xffffffffu;

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[V]) {
  if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[V]) {
  if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    p[0] = x[0];
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kAll, x, o));
  return x;
}

// Butterfly sum: a + b rounds like b + a, so every lane ends with the same
// value, and the order is fixed.
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kAll, x, o);
  return x;
}

// K1.  Lane l owns columns [c0 + l*V, c0 + l*V + V) of each column chunk of
// 32*V (V = 2 for an even D, else 1); the warp walks its item's edges in
// order, 64 at a time, and adds w * h[src] into the current row's
// accumulator, storing a row when its edges end (rows without edges store
// zeros).  A heavy slice leaves its partial in part[warp]; the first
// slice's warp adds the partials in order.
// At most 85 registers, so that three CTAs fit an SM.
template <int V>
__global__ void __launch_bounds__(kWarps * 32, 3)
seg_sum_rows_kernel(const int4* __restrict__ items,
                    const int* __restrict__ row_ptr,
                    const int* __restrict__ row_src,
                    const int* __restrict__ row_slot,
                    const float* __restrict__ w,
                    const float* __restrict__ h,
                    float* __restrict__ out, int d) {
  __shared__ float part[kWarps][32 * V];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int4 it = items[blockIdx.x * kWarps + warp];
  const int row0 = it.x, kind = it.y, e0 = it.z, e1 = it.w;
  const bool heavy_cta = __syncthreads_or(kind < 0);  // uniform per CTA
  const int nrows = kind > 0 ? kind : (kind < 0 ? 1 : 0);
  // lane r holds the end of the item's row r; a heavy slice ends at e1
  const int my_end = (kind > 0 && lane < nrows) ? row_ptr[row0 + lane + 1] : e1;

  for (int c0 = 0; c0 < d; c0 += 32 * V) {
    const int col = c0 + lane * V;
    const bool has_col = col < d;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    if (nrows > 0) {
      int lr = 0;  // the item's current row
      int cur_end = __shfl_sync(kAll, my_end, 0);
      for (int g = e0; g < e1; g += kGroup) {
        const int n = min(kGroup, e1 - g);
        int s0 = 0, s1 = 0;
        float w0 = 0.f, w1 = 0.f;
        if (lane < n) {
          s0 = row_src[g + lane];
          w0 = w[row_slot[g + lane]];
        }
        if (lane + 32 < n) {
          s1 = row_src[g + 32 + lane];
          w1 = w[row_slot[g + 32 + lane]];
        }
        for (int k0 = 0; k0 < n; k0 += kBatch) {
          float x[kBatch][V];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {  // the gathers need no weight
            const int k = k0 + u;
            const int src = __shfl_sync(kAll, k < 32 ? s0 : s1, k & 31);
            if (k < n && has_col) {
              load_vec<V>(h + (size_t)src * d + col, x[u]);
            } else {
#pragma unroll
              for (int v = 0; v < V; ++v) x[u][v] = 0.f;
            }
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int k = k0 + u;
            const float wk = __shfl_sync(kAll, k < 32 ? w0 : w1, k & 31);
            if (k < n) {
              while (g + k == cur_end) {  // row lr has no edges left
                if (has_col) store_vec<V>(out + (size_t)(row0 + lr) * d + col, acc);
#pragma unroll
                for (int v = 0; v < V; ++v) acc[v] = 0.f;
                ++lr;
                cur_end = __shfl_sync(kAll, my_end, lr);
              }
#pragma unroll
              for (int v = 0; v < V; ++v) acc[v] = fmaf(wk, x[u][v], acc[v]);
            }
          }
        }
      }
      if (kind > 0) {  // the last row, then any rows without edges after it
        for (; lr < nrows; ++lr) {
          if (has_col) store_vec<V>(out + (size_t)(row0 + lr) * d + col, acc);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = 0.f;
        }
      } else if (has_col) {
#pragma unroll
        for (int v = 0; v < V; ++v) part[warp][lane * V + v] = acc[v];
      }
    }
    if (heavy_cta) {
      __syncthreads();
      if (kind <= -2 && has_col) {
        float tot[V];
#pragma unroll
        for (int v = 0; v < V; ++v) tot[v] = part[warp][lane * V + v];
        for (int i = 1; i < -kind; ++i) {
#pragma unroll
          for (int v = 0; v < V; ++v) tot[v] += part[warp + i][lane * V + v];
        }
        store_vec<V>(out + (size_t)row0 * d + col, tot);
      }
      __syncthreads();  // part is free for the next column chunk
    }
  }
}

// K2.  A light item's <= 64 logits sit in two registers a lane; for each
// row with edges the warp takes the max (exact, order-free), then the sum
// of exp(l - m) by a butterfly.  A heavy slice folds 64 logits at a time
// online; the first slice's warp combines the slices' (m_i, s_i) in order.
__global__ void __launch_bounds__(kWarps * 32)
softmax_stats_rows_kernel(const int4* __restrict__ items,
                          const int* __restrict__ row_ptr,
                          const int* __restrict__ row_slot,
                          const float* __restrict__ logits,
                          float* __restrict__ m_out,
                          float* __restrict__ s_out) {
  __shared__ float pm[kWarps];
  __shared__ float ps[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int4 it = items[blockIdx.x * kWarps + warp];
  const int row0 = it.x, kind = it.y, e0 = it.z, e1 = it.w;
  const bool heavy_cta = __syncthreads_or(kind < 0);

  if (kind > 0) {
    const int n = e1 - e0;  // <= kGroup
    const bool mine = lane < kind;
    const int start = mine ? row_ptr[row0 + lane] : e1;
    const int end = mine ? row_ptr[row0 + lane + 1] : e1;
    const float v0 = lane < n ? logits[row_slot[e0 + lane]] : kNeg;
    const float v1 = lane + 32 < n ? logits[row_slot[e0 + 32 + lane]] : kNeg;
    if (mine && start == end) {
      m_out[row0 + lane] = kNeg;
      s_out[row0 + lane] = 0.f;
    }
    unsigned live = __ballot_sync(kAll, mine && start < end);
    while (live) {
      const int r = __ffs(live) - 1;
      live &= live - 1;
      const int a = __shfl_sync(kAll, start, r) - e0;
      const int b = __shfl_sync(kAll, end, r) - e0;
      const bool in0 = lane >= a && lane < b;
      const bool in1 = lane + 32 >= a && lane + 32 < b;
      const float m = warp_max(fmaxf(in0 ? v0 : kNeg, in1 ? v1 : kNeg));
      const float s = warp_sum((in0 ? expf(v0 - m) : 0.f) + (in1 ? expf(v1 - m) : 0.f));
      if (lane == r) {
        m_out[row0 + r] = m;
        s_out[row0 + r] = s;
      }
    }
  } else if (kind < 0) {
    float m = kNeg, s = 0.f;
    for (int g = e0; g < e1; g += kGroup) {
      const int n = min(kGroup, e1 - g);
      const float v0 = lane < n ? logits[row_slot[g + lane]] : kNeg;
      const float v1 = lane + 32 < n ? logits[row_slot[g + 32 + lane]] : kNeg;
      const float m_new = fmaxf(m, warp_max(fmaxf(v0, v1)));
      const float add = warp_sum((lane < n ? expf(v0 - m_new) : 0.f) +
                                 (lane + 32 < n ? expf(v1 - m_new) : 0.f));
      s = s * expf(m - m_new) + add;  // 0 * 0 on the first group
      m = m_new;
    }
    if (lane == 0) {
      pm[warp] = m;
      ps[warp] = s;
    }
  }
  if (heavy_cta) {
    __syncthreads();
    if (kind <= -2 && lane == 0) {
      float m = pm[warp];
      for (int i = 1; i < -kind; ++i) m = fmaxf(m, pm[warp + i]);
      float s = 0.f;
      for (int i = 0; i < -kind; ++i) s += ps[warp + i] * expf(pm[warp + i] - m);
      m_out[row0] = m;
      s_out[row0] = s;
    }
  }
}

// Two floats a lane where rows of d floats and both base pointers stay
// 8-byte aligned, else one.
bool pairs_aligned(const void* h, const void* out, int d) {
  return d % 2 == 0 && (((uintptr_t)h | (uintptr_t)out) % 8) == 0;
}

}  // namespace

extern "C" int na_seg_sum_f32(const void* items, const void* row_ptr,
                              const void* row_src, const void* row_slot,
                              const void* w, const void* h, void* out,
                              int num_items, int d, void* stream) {
  if (num_items <= 0 || num_items % kWarps != 0 || d <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int grid = num_items / kWarps;
  const cudaStream_t st = (cudaStream_t)stream;
  const int4* it = (const int4*)items;
  const int* rp = (const int*)row_ptr;
  const int* rs = (const int*)row_src;
  const int* sl = (const int*)row_slot;
  const float* wf = (const float*)w;
  const float* hf = (const float*)h;
  float* of = (float*)out;
  if (pairs_aligned(h, out, d)) {
    seg_sum_rows_kernel<2><<<grid, kWarps * 32, 0, st>>>(it, rp, rs, sl, wf, hf, of, d);
  } else {
    seg_sum_rows_kernel<1><<<grid, kWarps * 32, 0, st>>>(it, rp, rs, sl, wf, hf, of, d);
  }
  return (int)cudaGetLastError();
}

extern "C" int na_softmax_stats_f32(const void* items, const void* row_ptr,
                                    const void* row_slot, const void* logits,
                                    void* m_out, void* s_out, int num_items,
                                    void* stream) {
  if (num_items <= 0 || num_items % kWarps != 0) return (int)cudaErrorInvalidValue;
  softmax_stats_rows_kernel<<<num_items / kWarps, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int4*)items, (const int*)row_ptr, (const int*)row_slot,
      (const float*)logits, (float*)m_out, (float*)s_out);
  return (int)cudaGetLastError();
}

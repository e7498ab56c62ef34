// Hand-written Hopper (sm_90a) kernels for the LM prefill path.
//
// K4  fa_forward  replaces repro/kernels/flash_attention.py::_fa_kernel
//
// Forward attention with an online softmax: (B, Hq, S, Dqk) queries against
// (B, Hkv, T, Dqk) keys and (B, Hkv, T, Dv) values, GQA (kv head = q head /
// (Hq / Hkv)),
// queries end-aligned at key position T - S, optional causal mask, sliding
// window and tanh softcap, output divided by max(l, 1e-20).  The TPU kernel
// runs a grid (B*Hq, q blocks, kv blocks) with the kv axis innermost and
// carries (m, l, acc) in VMEM scratch from one grid step to the next.  Here
// one CTA owns one (batch, q head, query tile) and loops over the key tiles
// itself, keeping m, l and the accumulator in registers.  Dead key tiles
// (causal: k_lo > q_hi; window: k_hi <= q_lo - w) are never visited: the
// loop bounds skip them.  Fully masked rows keep m = -1e30: alpha is 0 while
// m_prev <= -1e30 / 2 and masked p are 0, as in the TPU kernel, so such a row
// ends 0.  Causal query tiles differ in work by up to S / 128 times, so the
// heaviest are launched first.  (Dqk, Dv) is (64, 64), (128, 128) or (256,
// 256) in both types, and also (80, 80) (hubert-xlarge) or (96, 64) (MLA's
// prefill) in bf16.  Every tensor comes with its batch, head and row strides
// (the last dimension has stride 1), so views such as (B, S, H,
// Dh).transpose(1, 2), or the first Dqk columns of a wider buffer, need no
// copy.  Sums run in a fixed order and there are no atomics: a run repeats
// bit for bit.
//
// Bound: at the prefill shapes (S = T = 2048..32768, Dh = 64) the work is
// 4 * Dh * (live q.k pairs) flops per (batch, q head), far above the q/k/v/o
// bytes, so the kernel is bound by operations: the bf16 tensor cores' 989
// TFLOP/s, which only wgmma reaches.
//
// Two kernels, one per input type:
//
// * bfloat16 (the LM path), in the style of FlashAttention-3.  A CTA owns
//   128 query rows: three warpgroups, one producer and two consumers of 64
//   rows each; setmaxnreg moves registers from the producer (40) to the
//   consumers (232).  The producer's one thread loads the Q tile once by
//   TMA and keeps K and V tiles of BK keys in flight in a 2-stage ring
//   (BK = 128 at head dim 64 and 128, 64 at head dim 256, where 128 would not
//   fit in shared memory);
//   each stage has a "full" and an "empty" mbarrier for K and for V, so
//   that K is released right after Q K^T and V after P V.  The tensor maps
//   use the 128-byte swizzle that the wgmma descriptors name, and carry the
//   tensors' strides; TMA's zero fill covers the ragged S and T edges.  Per
//   key tile a consumer computes S = Q K^T with wgmma m64nBKk16 (A = Q,
//   B = K, both K-major in shared memory, float32 accumulators), runs the
//   online softmax on the accumulators in registers, re-packs P to bf16 A
//   fragments in registers and adds P V with wgmma m64nDh k16 (B = V read
//   MN-major through the descriptor's transpose bit; at head dim 256 two
//   m64n128k16 on the two halves of V's columns).  The loop is software
//   pipelined: Q K^T of tile j and P V of tile j - 1 are issued together,
//   and the softmax of tile j runs while P V still executes.  Head dims
//   that are not a multiple of 64 (80, 96) need no padded copy in device
//   memory: the tensor maps are encoded at the true Dqk and Dv columns, so
//   TMA zero-fills each 64-column panel past them in shared memory (the
//   transaction still counts whole boxes), Q K^T issues k16 steps only over
//   the Dqk live columns (5 at 80, 6 at 96, in place of 8 at 128), and P V
//   takes N = Dv (m64n80k16 over the two panels of V at 80: the second
//   swizzle atom is read for its first 16 columns).  The two
//   consumers take turns to issue (two named barriers), so one's softmax
//   overlaps the other's products.  The last pass divides by max(l, 1e-20)
//   in float32 and stores bf16 once.
//   What this design does about the mma.sync kernel it replaces:
//   1. instruction: wgmma.mma_async instead of mma.sync.m16n8k16;
//   2. overlap: the producer's TMA ring loads the next K/V tiles while the
//      consumers compute, instead of a single-buffered copy by all threads
//      between two __syncthreads;
//   3. V: read MN-major by wgmma, no transpose pass through shared memory;
//   4. K: read by wgmma through a descriptor, no 32-bit fragment loads;
//   5. masking: a warpgroup classifies each key tile once; only tiles that
//      cross the causal diagonal, the window edge or the end of T run the
//      element mask, softcap is a template parameter, and the softmax runs
//      in base 2: the row max is taken on the raw scores and p = 2^(s *
//      scale * log2(e) - m) is one FFMA and one ex2 (hence scale > 0);
//   6. tiles: 128 query rows and BK keys per tile (was 64 x 64), so each
//      staged K/V tile serves twice the queries;
//   7. head dims 80 and 96 / 64: (Dqk, Dv) instantiations read q, k and v
//      in place, so no zero-padded copy at 128 is made and no product runs
//      over padding (128 / Dqk of the Q K^T and 128 / Dv of the P V work).
//   Left for later: a persistent tile scheduler (a CTA's Q load and first
//   Q K^T are not hidden behind another tile's work), a TMA store of the
//   output, and a third consumer warpgroup at head dim 64.
// * float32: CUDA-core FMAs, all float32 (the reference's 2e-5 tolerance
//   leaves no room for bf16 or TF32 products).  256 threads as 16 x 16;
//   Q, K, V and P tiles in float32 shared memory.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (or the error of building a tensor map).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per CTA (float32 path)
constexpr int kBK = 64;          // keys per tile (float32 path)
constexpr int kThreads = 256;    // 16 x 16
constexpr int kRows = kBQ / 16;  // query rows per thread
constexpr int kCols = kBK / 16;  // score columns per thread
constexpr float kNeg = -1e30f;

// Element strides of a (B, H, rows, Dh) tensor; the last dimension has stride 1.
struct Strides {
  long long b, h, s;
};

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * DH + kBK * (DH + 4) + kBK * DH + kBQ * (kBK + 4));
}

// ---- float32 path: CUDA cores --------------------------------------------
//
// Thread (ty, tx) owns query rows ty + 16 i (i < 4); for the scores it owns
// key columns tx + 16 j (j < 4), for the output the columns 4 tx + 64 jj +
// (0..3).  K rows are padded by 4 floats so that the float4 reads of 8
// consecutive keys hit 8 distinct bank groups.  Row max and row sum are
// butterfly reductions over the 16 lanes of a half-warp, so every lane holds
// the same bits.

template <int DH>
__global__ void __launch_bounds__(kThreads)
fa_forward_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      Strides sq, Strides sk, Strides sv, Strides so, int hq,
                      int hkv, int s_len, int t_len, float scale, int causal,
                      int window, float softcap) {
  constexpr int kKP = DH + 4;   // K pitch (floats)
  constexpr int kPP = kBK + 4;  // P pitch (floats)
  constexpr int kOut = DH / 16; // output columns per thread
  extern __shared__ float4 smem4[];
  float* s_q = reinterpret_cast<float*>(smem4);  // [kBQ][DH]
  float* s_k = s_q + kBQ * DH;                   // [kBK][kKP]
  float* s_v = s_k + kBK * kKP;                  // [kBK][DH]
  float* s_p = s_v + kBK * DH;                   // [kBQ][kPP]

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int bi = bh / hq;               // batch
  const int hi = bh % hq;               // q head
  const int kvh = hi / (hq / hkv);      // kv head
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = qt * kBQ;
  const int rows = min(kBQ, s_len - q0);
  const int q_lo = q0 + (t_len - s_len);  // key position of the tile's first row
  const int q_hi = q_lo + rows - 1;

  const float* qg = q + bi * sq.b + hi * sq.h + q0 * sq.s;
  const float* kg = k + bi * sk.b + kvh * sk.h;
  const float* vg = v + bi * sv.b + kvh * sv.h;

  for (int e = tid; e < kBQ * DH; e += kThreads) {
    const int r = e / DH;
    s_q[e] = r < rows ? qg[r * sq.s + (e - r * DH)] : 0.f;
  }

  int kt_end = (t_len + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, q_hi < 0 ? 0 : q_hi / kBK + 1);
  int kt_begin = 0;
  if (window > 0 && q_lo - window + 1 > 0) kt_begin = (q_lo - window + 1) / kBK;

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // every thread is done with the previous K, V and P
    for (int e = tid; e < kBK * DH; e += kThreads) {
      const int r = e / DH;
      const int d = e - r * DH;
      const bool in = k0 + r < t_len;
      s_k[r * kKP + d] = in ? kg[(k0 + r) * sk.s + d] : 0.f;
      s_v[e] = in ? vg[(k0 + r) * sv.s + d] : 0.f;
    }
    __syncthreads();

    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(s_q + (ty + 16 * i) * DH + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kv[j] = *reinterpret_cast<const float4*>(s_k + (tx + 16 * j) * kKP + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          sc[i][j] = fmaf(qv[i].x, kv[j].x, sc[i][j]);
          sc[i][j] = fmaf(qv[i].y, kv[j].y, sc[i][j]);
          sc[i][j] = fmaf(qv[i].z, kv[j].z, sc[i][j]);
          sc[i][j] = fmaf(qv[i].w, kv[j].w, sc[i][j]);
        }
    }

    float alpha[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q_lo + ty + 16 * i;
      bool live[kCols];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float s = sc[i][j] * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        live[j] = kpos < t_len && (!causal || kpos <= qpos) &&
                  (window <= 0 || kpos > qpos - window);
        sc[i][j] = live[j] ? s : kNeg;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = m[i] > kNeg / 2 ? expf(m[i] - m_new) : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = live[j] ? expf(sc[i][j] - m_new) : 0.f;
        s_p[(ty + 16 * i) * kPP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();  // P complete

#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[i][c] *= alpha[i];
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = *reinterpret_cast<const float4*>(s_p + (ty + 16 * i) * kPP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int jj = 0; jj < DH / 64; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(
              s_v + (c + cc) * DH + 4 * tx + 64 * jj);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y : cc == 2 ? pv[i].z : pv[i].w;
            acc[i][4 * jj + 0] = fmaf(p, vv.x, acc[i][4 * jj + 0]);
            acc[i][4 * jj + 1] = fmaf(p, vv.y, acc[i][4 * jj + 1]);
            acc[i][4 * jj + 2] = fmaf(p, vv.z, acc[i][4 * jj + 2]);
            acc[i][4 * jj + 3] = fmaf(p, vv.w, acc[i][4 * jj + 3]);
          }
        }
      }
    }
  }

  float* og = o + bi * so.b + hi * so.h + q0 * so.s;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int jj = 0; jj < DH / 64; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        og[r * so.s + 4 * tx + 64 * jj + c] = acc[i][4 * jj + c] * inv;
  }
}

// ---- bf16 path: wgmma fed by TMA, warp-specialised ------------------------

constexpr int kBlockQ = 128;                // query rows per CTA
constexpr int kBlockKWide = 128;            // keys per K/V tile at head dim 64 and 128
constexpr int kBlockKDh256 = 64;            // keys per K/V tile at head dim 256
constexpr int kStages = 2;                  // depth of the K/V ring
// At head dim 256 a tile of 128 keys would need Q (64 KB) + 2 stages of K
// and V (4 x 64 KB) = 320 KB; with 64 keys it is 64 + 4 x 32 = 192 KB, and a
// consumer thread holds O (128 floats), S (32) and P (16 registers).
template <int DQK>
constexpr int kBlockK = DQK == 256 ? kBlockKDh256 : kBlockKWide;
constexpr int kWgThreads = 128;             // one warpgroup
constexpr int kFaThreads = 3 * kWgThreads;  // producer + 2 consumer warpgroups
constexpr int kRowBytes = 128;              // one swizzled row: 64 bf16
constexpr int kConsumerWarps = 8;

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle repeats
// every 8 rows): Q, then the K stages, the V stages and the mbarriers.  A
// Q or K tile is stored as ceil(Dqk / 64) panels of [rows][64], a V tile as
// ceil(Dv / 64), one TMA box each; columns past the head dim are TMA's zeros.
template <int DQK, int DV>
struct FaSmem {
  static constexpr int kQkPanels = (DQK + 63) / 64;
  static constexpr int kVPanels = (DV + 63) / 64;
  static constexpr uint32_t kQBytes = kBlockQ * kQkPanels * kRowBytes;
  static constexpr uint32_t kKTileBytes = kBlockK<DQK> * kQkPanels * kRowBytes;
  static constexpr uint32_t kVTileBytes = kBlockK<DQK> * kVPanels * kRowBytes;
  static constexpr uint32_t kK = kQBytes;
  static constexpr uint32_t kV = kK + kStages * kKTileBytes;
  static constexpr uint32_t kBars = kV + kStages * kVTileBytes;
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 4 * kStages) + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar)
               : "memory");
}

// Spins until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One TMA box of a 4-D tensor map (Dh, rows, heads, batch) into shared
// memory, completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte swizzled operand: start
// address, leading and stride byte offsets (all >> 4), layout type 1 (B128).
// K-major (Q, K): the K extent of one instruction lies inside a 128-byte row,
// LBO is unused (16) and SBO = 1024 steps to the next 8 rows.  MN-major (V):
// LBO steps to the next 64-column panel, SBO = 1024 to the next 8 keys.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma registers across
// the asynchronous instructions that own them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define FA_D8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define FA_D32 FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
#define FA_D40 FA_D32, FA_D8(32)
#define FA_D64 FA_D32, FA_D8(32), FA_D8(40), FA_D8(48), FA_D8(56)

// Accumulator layout of m64nN (per warpgroup thread: warp w, lane = 4 g + t):
// d[4 j + 2 i + c] is row 16 w + g + 8 i, column 8 j + 2 t + c.

// D (64 x 128) = A (64 x 16) * B (16 x 128), both K-major in shared memory;
// accumulate = 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : FA_D64
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 64) = A (64 x 16) * B (16 x 64), both K-major in shared memory;
// accumulate = 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_D32
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 64) += A (64 x 16, bf16 in registers) * B (16 x 64, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 80) += A (64 x 16, bf16 in registers) * B (16 x 80, MN-major in
// shared memory: columns 0-63 in one swizzle atom, 64-79 in the next, LBO on)
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : FA_D40
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 128) += A (64 x 16, bf16 in registers) * B (16 x 128, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FA_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef FA_D8
#undef FA_D32
#undef FA_D40
#undef FA_D64

// 2^x in one MUFU instruction (inputs far below -126 flush to 0)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Online softmax over one 64 x BK score tile in the accumulator layout, in
// base 2.  Without softcap the scores stay raw: the row max is taken on them
// and scaled once (scale > 0 keeps the order), and p = 2^(s * scale_log2 -
// m) is one FFMA and one MUFU per score.  With softcap, x = softcap *
// tanh(s * scale / softcap) * log2(e) comes first.  Each thread holds 2 rows
// (qpos, qpos + 8) x BK / 4 keys; row max and row sum are reduced over the 4
// threads of a quad.  kMask applies the element mask (causal, window, kpos <
// T); a tile that needs none skips it.  On return s holds p (float32), alpha
// the rescale of the previous row state.
template <int BK, bool kMask, bool kCap>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2], float (&m)[2],
                                               float (&l)[2], float (&alpha)[2], int kpos0,
                                               int qpos, int t_len, int causal, int window,
                                               float scale_log2, float cap_in, float cap_out) {
  const float mul = kCap ? 1.f : scale_log2;  // from s as stored below to base-2 logits
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = qpos + 8 * i;
    float mx = kNeg;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x = s[4 * j + 2 * i + c];
        if (kCap) x = tanhf(x * cap_in) * cap_out;
        if (kMask) {
          const int kpos = kpos0 + 8 * j + c;
          const bool live = kpos < t_len && (!causal || kpos <= q) &&
                            (window <= 0 || kpos > q - window);
          x = live ? x : kNeg;
        }
        s[4 * j + 2 * i + c] = x;
        mx = fmaxf(mx, x);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], (!kMask || mx > kNeg / 2) ? mx * mul : kNeg);
    alpha[i] = m[i] > kNeg / 2 ? exp2_fast(m[i] - m_new) : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float x = s[4 * j + 2 * i + c];
        const float p = (!kMask || x > kNeg / 2) ? exp2_fast(fmaf(x, mul, -m_new)) : 0.f;
        s[4 * j + 2 * i + c] = p;
        sum += p;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[i] = l[i] * alpha[i] + sum;
    m[i] = m_new;
  }
}

// One consumer warpgroup (c = 0 or 1: rows 64 c .. 64 c + 63 of the query
// tile) over key tiles kt_begin .. kt_end - 1, then its part of the output.
template <int DQK, int DV, bool kCap>
__device__ __forceinline__ void consume(int c, uint32_t s_q, uint32_t s_k, uint32_t s_v,
                                        uint32_t bar_q, __nv_bfloat16* __restrict__ o,
                                        const Strides& so, int bi, int hi, int q0, int q_lo,
                                        int kt_begin, int kt_end, int s_len, int t_len,
                                        float scale_log2, int causal, int window, float cap_in,
                                        float cap_out) {
  using L = FaSmem<DQK, DV>;
  constexpr int BK = kBlockK<DQK>;
  auto full_k = [&](int st) { return bar_q + 8u * (1 + st); };
  auto full_v = [&](int st) { return bar_q + 8u * (1 + kStages + st); };
  auto empty_k = [&](int st) { return bar_q + 8u * (1 + 2 * kStages + st); };
  auto empty_v = [&](int st) { return bar_q + 8u * (1 + 3 * kStages + st); };
  const int tid = threadIdx.x % kWgThreads;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wg_lo = q_lo + 64 * c;           // key position of the warpgroup's first row
  const int qpos = wg_lo + 16 * warp + g;    // this thread's rows: qpos and qpos + 8

  float o_acc[DV / 2];
  float s_acc[BK / 2];
  uint32_t pa[BK / 16][4];  // P in bf16 A fragments: keys 16 kk .. 16 kk + 15
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s_acc[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  // S = Q K^T on stage st, committed as one wgmma group: one k16 step per
  // 16 live columns of Q and K (Dqk is a multiple of 16); the zero-filled
  // columns of a last panel are never issued
  auto issue_qk = [&](int st) {
#pragma unroll
    for (int ks = 0; ks < DQK / 16; ++ks) {
      const uint32_t qa = s_q + (ks / 4) * kBlockQ * kRowBytes + c * 64 * kRowBytes + (ks % 4) * 32;
      const uint32_t kb = s_k + st * L::kKTileBytes + (ks / 4) * BK * kRowBytes + (ks % 4) * 32;
      if constexpr (BK == 64) {
        wgmma_ss_n64(s_acc, sw128_desc(qa, 16, 1024), sw128_desc(kb, 16, 1024), ks > 0);
      } else {
        wgmma_ss_n128(s_acc, sw128_desc(qa, 16, 1024), sw128_desc(kb, 16, 1024), ks > 0);
      }
    }
    wgmma_commit();
  };
  // O += P V on stage st, committed as one wgmma group, N = Dv.  At head
  // dim 256 the product is two of 128 columns: panels 0-1 into
  // o_acc[0..63], panels 2-3 into o_acc[64..127] (the accumulator layout
  // then reads column 8 n + 2 t + c at o_acc[4 n + 2 i + c] over all 256
  // columns, as at 64, 80 and 128).
  auto issue_pv = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t va = s_v + st * L::kVTileBytes + kk * 16 * kRowBytes;
      const uint64_t vb = sw128_desc(va, BK * kRowBytes, 1024);
      if constexpr (DV == 64) {
        wgmma_rs_n64(o_acc, pa[kk], vb);
      } else if constexpr (DV == 80) {
        wgmma_rs_n80(o_acc, pa[kk], vb);
      } else if constexpr (DV == 128) {
        wgmma_rs_n128(o_acc, pa[kk], vb);
      } else {
        wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&o_acc[0]), pa[kk], vb);
        wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&o_acc[64]), pa[kk],
                      sw128_desc(va + 2 * BK * kRowBytes, BK * kRowBytes, 1024));
      }
    }
    wgmma_commit();
  };
  // the softmax of key tile kt on s_acc (p left in s_acc), alpha for O.  A
  // tile needs the element mask only where some pair of the warpgroup's 64
  // rows and its keys is dead or lies past T.
  auto softmax = [&](int kt, float (&alpha)[2]) {
    const int k0 = kt * BK;
    const bool full = k0 + BK <= t_len && (!causal || k0 + BK - 1 <= wg_lo) &&
                      (window <= 0 || k0 > wg_lo + 63 - window);
    if (full) {
      online_softmax<BK, false, kCap>(s_acc, m, l, alpha, k0 + 2 * t4, qpos, t_len, causal,
                                      window, scale_log2, cap_in, cap_out);
    } else {
      online_softmax<BK, true, kCap>(s_acc, m, l, alpha, k0 + 2 * t4, qpos, t_len, causal,
                                     window, scale_log2, cap_in, cap_out);
    }
  };
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s_acc[8 * kk + 0], s_acc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s_acc[8 * kk + 2], s_acc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s_acc[8 * kk + 4], s_acc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s_acc[8 * kk + 6], s_acc[8 * kk + 7]);
    }
  };
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  // The two warpgroups take turns to issue their wgmma batches (named
  // barriers 1 and 2, 256 threads: one side waits, the other arrives), so
  // that one's softmax runs while the tensor cores work for the other.
  // Warpgroup 0 goes first; the waits and arrivals pair up exactly.
  int turn = 0;
  auto my_turn = [&]() {
    if (c == 1 || turn > 0) asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory");
  };
  auto your_turn = [&](bool last) {
    if (c == 0 || !last) asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - c) : "memory");
    ++turn;
  };

  // Software pipeline: while the softmax of tile j runs on the CUDA cores,
  // the tensor cores finish P V of tile j - 1; Q K^T of tile j was issued
  // just before it.
  mbar_wait(bar_q, 0);
  if (kt_begin < kt_end) {
    int st = 0;
    uint32_t ph = 0;
    float alpha[2];
    mbar_wait(full_k(st), ph);
    fence_regs(s_acc);
    wgmma_fence();
    my_turn();
    issue_qk(st);
    your_turn(false);
    wgmma_wait<0>();
    fence_regs(s_acc);
    release(empty_k(st));
    softmax(kt_begin, alpha);  // O is still 0: alpha has nothing to scale
    pack_p();
    for (int kt = kt_begin + 1; kt < kt_end; ++kt) {
      const int sn = st + 1 == kStages ? 0 : st + 1;
      const uint32_t pn = sn == 0 ? ph ^ 1 : ph;
      mbar_wait(full_k(sn), pn);
      mbar_wait(full_v(st), ph);
      fence_regs(s_acc);
      fence_regs(o_acc);
      wgmma_fence();
      my_turn();
      issue_qk(sn);
      issue_pv(st);
      your_turn(false);
      wgmma_wait<1>();  // Q K^T of tile kt done; P V of tile kt - 1 may run on
      fence_regs(s_acc);
      release(empty_k(sn));
      softmax(kt, alpha);
      wgmma_wait<0>();
      fence_regs(o_acc);
      release(empty_v(st));
#pragma unroll
      for (int n = 0; n < DV / 8; ++n) {
        o_acc[4 * n + 0] *= alpha[0];
        o_acc[4 * n + 1] *= alpha[0];
        o_acc[4 * n + 2] *= alpha[1];
        o_acc[4 * n + 3] *= alpha[1];
      }
      pack_p();
      st = sn;
      ph = pn;
    }
    mbar_wait(full_v(st), ph);
    fence_regs(o_acc);
    wgmma_fence();
    my_turn();
    issue_pv(st);
    your_turn(true);
    wgmma_wait<0>();
    fence_regs(o_acc);
    release(empty_v(st));
  }

  __nv_bfloat16* og = o + bi * so.b + hi * so.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + 64 * c + 16 * warp + g + 8 * i;
    if (r >= s_len) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
    __nv_bfloat16* orow = og + r * so.s + 2 * t4;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          pack_bf16(o_acc[4 * n + 2 * i] * inv, o_acc[4 * n + 2 * i + 1] * inv);
    }
  }
}

template <int DQK, int DV, bool kCap>
__global__ void __launch_bounds__(kFaThreads, 1)
fa_forward_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        __nv_bfloat16* __restrict__ o, Strides so, int hq, int hkv,
                        int s_len, int t_len, float scale_log2, int causal, int window,
                        float cap_in, float cap_out) {
  using L = FaSmem<DQK, DV>;
  constexpr int BK = kBlockK<DQK>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_k = base + L::kK;
  const uint32_t s_v = base + L::kV;
  const uint32_t bar_q = base + L::kBars;
  // per stage: K and V "full" (the producer's TMA landed), K and V "empty"
  // (the 8 consumer warps are done with the tile); K and V are released
  // apart, K after Q K^T and V after P V
  auto full_k = [&](int st) { return bar_q + 8u * (1 + st); };
  auto full_v = [&](int st) { return bar_q + 8u * (1 + kStages + st); };
  auto empty_k = [&](int st) { return bar_q + 8u * (1 + 2 * kStages + st); };
  auto empty_v = [&](int st) { return bar_q + 8u * (1 + 3 * kStages + st); };

  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int bi = blockIdx.x / hq;             // batch
  const int hi = blockIdx.x % hq;             // q head
  const int kvh = hi / (hq / hkv);            // kv head
  const int q0 = qt * kBlockQ;
  const int rows = min(kBlockQ, s_len - q0);
  const int q_lo = q0 + (t_len - s_len);  // key position of the tile's first row
  const int q_hi = q_lo + rows - 1;
  int kt_end = (t_len + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, q_hi < 0 ? 0 : q_hi / BK + 1);
  int kt_begin = 0;
  if (window > 0 && q_lo - window + 1 > 0) kt_begin = (q_lo - window + 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty_k(st), kConsumerWarps);
      mbar_init(empty_v(st), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, broadcast so that the compiler sees it uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWgThreads, 0);
  if (wg == 0) {  // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_k))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_v))
                   : "memory");
      mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
      for (int p = 0; p < L::kQkPanels; ++p)
        tma_load_4d(s_q + p * kBlockQ * kRowBytes, &tm_q, bar_q, 64 * p, q0, hi, bi);
      int st = 0;
      uint32_t ph = 0;
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        mbar_wait(empty_k(st), ph ^ 1);
        mbar_expect_tx(full_k(st), L::kKTileBytes);
#pragma unroll
        for (int p = 0; p < L::kQkPanels; ++p)
          tma_load_4d(s_k + st * L::kKTileBytes + p * BK * kRowBytes, &tm_k, full_k(st),
                      64 * p, kt * BK, kvh, bi);
        mbar_wait(empty_v(st), ph ^ 1);
        mbar_expect_tx(full_v(st), L::kVTileBytes);
#pragma unroll
        for (int p = 0; p < L::kVPanels; ++p)
          tma_load_4d(s_v + st * L::kVTileBytes + p * BK * kRowBytes, &tm_v, full_v(st),
                      64 * p, kt * BK, kvh, bi);
        if (++st == kStages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    // consumer warpgroups: wg 1 owns rows 0..63 of the tile, wg 2 rows 64..127
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    consume<DQK, DV, kCap>(wg - 1, s_q, s_k, s_v, bar_q, o, so, bi, hi, q0, q_lo, kt_begin,
                           kt_end, s_len, t_len, scale_log2, causal, window, cap_in, cap_out);
  }
}

// ---- host side -------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime, so that
// the library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D bf16 tensor map (Dh, rows, heads, batch) with 64 x box_rows boxes
// and the 128-byte swizzle; reads past `rows` or past column `dh` (a box
// that starts at column 64 of an 80- or 96-column tensor) fill with zeros.
int tensor_map(CUtensorMap* map, const void* base, int rows, int heads, int batch, int dh,
               const Strides& st, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)rows, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DQK, int DV, bool kCap>
int launch_wgmma(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, void* o,
                 const Strides& so, int b, int hq, int hkv, int s_len, int t_len, float scale,
                 int causal, int window, float softcap, cudaStream_t stream) {
  constexpr float kLog2e = 1.4426950408889634f;
  auto kern = fa_forward_wgmma_kernel<DQK, DV, kCap>;
  const int smem = (int)FaSmem<DQK, DV>::kBytes;
  // the shared-memory attribute is set once per device (a bit each)
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !(configured >> dev & 1ull)) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) configured |= 1ull << dev;
  }
  const dim3 grid(b * hq, (s_len + kBlockQ - 1) / kBlockQ);
  kern<<<grid, kFaThreads, smem, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, so, hq, hkv, s_len, t_len, scale * kLog2e, causal, window,
      kCap ? scale / softcap : 0.f, kCap ? softcap * kLog2e : 0.f);
  return (int)cudaGetLastError();
}

// The float32 kernel takes (Dh, Dh) with Dh a multiple of 64 only.
template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, const Strides* st, int b,
           int hq, int hkv, int s_len, int t_len, int bf16, float scale, int causal, int window,
           float softcap, cudaStream_t stream) {
  if (bf16) {
    CUtensorMap mq, mk, mv;
    int rc = tensor_map(&mq, q, s_len, hq, b, DQK, st[0], kBlockQ);
    if (rc == 0) rc = tensor_map(&mk, k, t_len, hkv, b, DQK, st[1], kBlockK<DQK>);
    if (rc == 0) rc = tensor_map(&mv, v, t_len, hkv, b, DV, st[2], kBlockK<DQK>);
    if (rc != 0) return rc;
    return softcap > 0.f
               ? launch_wgmma<DQK, DV, true>(mq, mk, mv, o, st[3], b, hq, hkv, s_len, t_len,
                                             scale, causal, window, softcap, stream)
               : launch_wgmma<DQK, DV, false>(mq, mk, mv, o, st[3], b, hq, hkv, s_len, t_len,
                                              scale, causal, window, softcap, stream);
  }
  if constexpr (DQK == DV && DQK % 64 == 0) {
    const dim3 grid((s_len + kBQ - 1) / kBQ, b * hq);
    auto kern = fa_forward_f32_kernel<DQK>;
    const size_t smem = smem_bytes<DQK>();
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, kThreads, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, st[0], st[1], st[2],
        st[3], hq, hkv, s_len, t_len, scale, causal, window, softcap);
    return (int)cudaGetLastError();
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

// What the loaded bf16 kernel at (DQK, DV) (no softcap) takes per CTA.
template <int DQK, int DV>
int wgmma_info(int* info) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fa_forward_wgmma_kernel<DQK, DV, false>);
  if (err != cudaSuccess) return (int)err;
  info[0] = attr.numRegs;
  info[1] = (int)FaSmem<DQK, DV>::kBytes;
  info[2] = (int)attr.localSizeBytes;
  info[3] = kFaThreads;
  info[4] = kBlockK<DQK>;
  return 0;
}

}  // namespace

// q (b, hq, s_len, dh), k (b, hkv, t_len, dh), v (b, hkv, t_len, dv) and o
// (b, hq, s_len, dv), all of one type (bf16 != 0: bfloat16, else float32).
// (dh, dv) is (64, 64), (128, 128) or (256, 256), or in bfloat16 also (80,
// 80) or (96, 64).  strides holds 12 element strides, (batch, head, row) of
// q, k, v and o in turn; the last dimension has stride 1.  For bfloat16
// every stride and address is a multiple of 16 bytes (the tensor maps'
// rule).  window <= 0 means no window; softcap <= 0 means no softcap.
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o,
                          int b, int hq, int hkv, int s_len, int t_len, int dh, int dv,
                          int bf16, float scale, int causal, int window,
                          float softcap, const long long* strides, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || s_len <= 0 ||
      t_len <= 0 || b * hq > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Strides st[4];
  for (int i = 0; i < 4; ++i) st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t cs = (cudaStream_t)stream;
  if (dh == 64 && dv == 64) {
    return launch<64, 64>(q, k, v, o, st, b, hq, hkv, s_len, t_len, bf16, scale, causal,
                          window, softcap, cs);
  }
  if (dh == 128 && dv == 128) {
    return launch<128, 128>(q, k, v, o, st, b, hq, hkv, s_len, t_len, bf16, scale, causal,
                            window, softcap, cs);
  }
  if (dh == 256 && dv == 256) {
    return launch<256, 256>(q, k, v, o, st, b, hq, hkv, s_len, t_len, bf16, scale, causal,
                            window, softcap, cs);
  }
  if (dh == 80 && dv == 80) {
    return launch<80, 80>(q, k, v, o, st, b, hq, hkv, s_len, t_len, bf16, scale, causal,
                          window, softcap, cs);
  }
  if (dh == 96 && dv == 64) {
    return launch<96, 64>(q, k, v, o, st, b, hq, hkv, s_len, t_len, bf16, scale, causal,
                          window, softcap, cs);
  }
  return (int)cudaErrorInvalidValue;
}

// What the loaded bf16 kernel at (dqk, dv) (no softcap) takes per CTA:
// info[0] registers a thread at launch, info[1] dynamic shared memory bytes,
// info[2] local memory bytes a thread (stack and spills), info[3] threads,
// info[4] keys per K/V tile.
extern "C" int fa_wgmma_info(int dqk, int dv, int* info) {
  if (dqk == 64 && dv == 64) return wgmma_info<64, 64>(info);
  if (dqk == 128 && dv == 128) return wgmma_info<128, 128>(info);
  if (dqk == 256 && dv == 256) return wgmma_info<256, 256>(info);
  if (dqk == 80 && dv == 80) return wgmma_info<80, 80>(info);
  if (dqk == 96 && dv == 64) return wgmma_info<96, 64>(info);
  return (int)cudaErrorInvalidValue;
}

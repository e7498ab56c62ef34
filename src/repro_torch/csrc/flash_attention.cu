// Hand-written Hopper (sm_90a) kernels for the LM prefill path.
//
// K4  fa_forward  replaces repro/kernels/flash_attention.py::_fa_kernel
//
// Forward attention with an online softmax: (B, Hq, S, Dh) queries against
// (B, Hkv, T, Dh) keys and values, GQA (kv head = q head / (Hq / Hkv)),
// queries end-aligned at key position T - S, optional causal mask, sliding
// window and tanh softcap, output divided by max(l, 1e-20).  The TPU kernel
// runs a grid (B*Hq, q blocks, kv blocks) with the kv axis innermost and
// carries (m, l, acc) in VMEM scratch from one grid step to the next.  Here
// one CTA owns one (batch * q head, 64-row query tile) and loops over the key
// tiles itself, keeping m, l and the accumulator in registers.  Dead key
// tiles (causal: k_lo > q_hi; window: k_hi <= q_lo - w) are never visited:
// the loop bounds skip them.  Within a live tile each element is masked by
// causality, window and kpos < T, so the ragged edges of S and T need no
// padding.  Fully masked rows keep m = -1e30: alpha is 0 while m_prev <=
// -1e30 / 2 and masked p are 0, as in the TPU kernel, so such a row ends 0.
// Causal query tiles differ in work by up to S / 64 times, so the heaviest
// are launched first (blockIdx.x runs the tiles in reverse).  Dh is 64 or
// 128.  Sums run in a fixed order: a run repeats bit for bit.
//
// Two kernels, one per input type:
//
// * bfloat16 (the LM path): tensor cores, mma.sync.m16n8k16 with float32
//   accumulators.  4 warps, each owning 16 query rows; Q fragments stay in
//   registers, K and V^T tiles are staged in shared memory (rows padded so
//   that the 32-bit fragment reads hit 32 distinct banks), P is re-packed
//   from the S accumulators into bf16 A fragments without leaving
//   registers.  The softmax runs in float32; P enters the P V product
//   rounded to bf16, as in FlashAttention-2.
// * float32: CUDA-core FMAs, all float32 (the reference's 2e-5 tolerance
//   leaves no room for bf16 or TF32 products).  256 threads as 16 x 16;
//   Q, K, V and P tiles in float32 shared memory.
//
// Bound: at the prefill shapes (S = T = 2048..32768, Dh = 64) the work is
// 4 * Dh * (live q.k pairs) flops per (batch, q head), far above the q/k/v/o
// bytes, so the kernels are bound by operations; the card's bound is the
// bf16 tensor cores' 989 TFLOP/s, which only wgmma reaches.  mma.sync with
// no copy/compute overlap reaches a fraction of it; wgmma, TMA-fed K/V
// rings and warp specialisation are later work.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per CTA
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kRows = kBQ / 16;  // query rows per thread
constexpr int kCols = kBK / 16;  // score columns per thread
constexpr float kNeg = -1e30f;

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
                      int hq, int hkv, int s_len, int t_len, float scale,
                      int causal, int window, float softcap) {
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
  const int group = hq / hkv;
  const int kvh = (bh / hq) * hkv + (bh % hq) / group;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = qt * kBQ;
  const int rows = min(kBQ, s_len - q0);
  const int q_lo = q0 + (t_len - s_len);  // key position of the tile's first row
  const int q_hi = q_lo + rows - 1;

  const float* qg = q + ((size_t)bh * s_len + q0) * DH;
  const float* kg = k + (size_t)kvh * t_len * DH;
  const float* vg = v + (size_t)kvh * t_len * DH;

  for (int e = tid; e < kBQ * DH; e += kThreads) {
    const int r = e / DH;
    s_q[e] = r < rows ? qg[e] : 0.f;
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
      s_k[r * kKP + d] = in ? kg[(size_t)k0 * DH + e] : 0.f;
      s_v[e] = in ? vg[(size_t)k0 * DH + e] : 0.f;
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

  float* og = o + ((size_t)bh * s_len + q0) * DH;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int jj = 0; jj < DH / 64; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        og[(size_t)r * DH + 4 * tx + 64 * jj + c] = acc[i][4 * jj + c] * inv;
  }
}

// ---- bf16 path: tensor cores (mma.sync.m16n8k16, float32 accumulate) ----
//
// 4 warps per CTA; warp w owns query rows 16 w .. 16 w + 15 of the 64-row
// tile.  Per key tile of 64: S = Q K^T by mma (Q fragments held in
// registers for the whole CTA, K fragments read from shared memory as
// 32-bit words), the online softmax on the S accumulators (each thread
// holds 2 rows x 16 keys; row reductions over the 4 threads of a quad),
// then O += P V by mma with P re-packed from the S accumulators to bf16 A
// fragments in registers and V staged transposed in shared memory.

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows

template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
fa_forward_mma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, int hq, int hkv, int s_len,
                      int t_len, float scale, int causal, int window, float softcap) {
  constexpr int kKP = DH + 8;    // K pitch (bf16): 32-bit fragment reads hit 32 banks
  constexpr int kVP = kBK + 8;   // V^T pitch (bf16)
  constexpr int kKS = DH / 16;   // k-steps of S = Q K^T
  constexpr int kNT = kBK / 8;   // key n-tiles of S
  constexpr int kOT = DH / 8;    // dim n-tiles of O
  __shared__ __align__(16) __nv_bfloat16 s_k[kBK * kKP];
  __shared__ __align__(16) __nv_bfloat16 s_vt[DH * kVP];

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int group = hq / hkv;
  const int kvh = (bh / hq) * hkv + (bh % hq) / group;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // groupID: fragment row
  const int t = lane & 3;   // thread in group: fragment column pair
  const int q0 = qt * kBQ;
  const int rows = min(kBQ, s_len - q0);
  const int q_lo = q0 + (t_len - s_len);
  const int q_hi = q_lo + rows - 1;
  const int r0 = warp * 16 + g;  // this thread's two rows: r0 and r0 + 8

  const __nv_bfloat16* qg = q + ((size_t)bh * s_len + q0) * DH;
  const __nv_bfloat16* kg = k + (size_t)kvh * t_len * DH;
  const __nv_bfloat16* vg = v + (size_t)kvh * t_len * DH;

  // Q fragments for the whole key loop (rows past s_len read as zeros)
  uint32_t qa[kKS][4];
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int r = r0 + (h & 1) * 8;
      const int d = 16 * ks + 2 * t + (h >> 1) * 8;
      qa[ks][h] = r < rows ? *reinterpret_cast<const uint32_t*>(qg + (size_t)r * DH + d)
                           : 0u;
    }
  }

  int kt_end = (t_len + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, q_hi < 0 ? 0 : q_hi / kBK + 1);
  int kt_begin = 0;
  if (window > 0 && q_lo - window + 1 > 0) kt_begin = (q_lo - window + 1) / kBK;

  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[kOT][4];
#pragma unroll
  for (int n = 0; n < kOT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // every warp is done with the previous K and V^T
    for (int e = tid; e < kBK * DH / 8; e += kMmaThreads) {  // K: 8 bf16 per load
      const int r = e / (DH / 8);
      const int d = (e - r * (DH / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < t_len) kv = *reinterpret_cast<const uint4*>(kg + (size_t)(k0 + r) * DH + d);
      *reinterpret_cast<uint4*>(s_k + r * kKP + d) = kv;
    }
    for (int e = tid; e < kBK * DH / 8; e += kMmaThreads) {  // V^T: lanes walk keys
      const int r = e % kBK;
      const int d = (e / kBK) * 8;
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < t_len) vv = *reinterpret_cast<const uint4*>(vg + (size_t)(k0 + r) * DH + d);
      const __nv_bfloat16* vh = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int c = 0; c < 8; ++c) s_vt[(d + c) * kVP + r] = vh[c];
    }
    __syncthreads();

    float sc[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[j][c] = 0.f;
      const __nv_bfloat16* krow = s_k + (8 * j + g) * kKP + 2 * t;
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + 16 * ks);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + 16 * ks + 8);
        mma_bf16(sc[j], qa[ks][0], qa[ks][1], qa[ks][2], qa[ks][3], b0, b1);
      }
    }

    // online softmax; element (j, c): row r0 + 8 (c >> 1), key 8 j + 2 t + (c & 1)
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qpos = q_lo + r0 + 8 * h;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int c = 2 * h; c < 2 * h + 2; ++c) {
          const int kpos = k0 + 8 * j + 2 * t + (c & 1);
          float s = sc[j][c] * scale;
          if (softcap > 0.f) s = softcap * tanhf(s / softcap);
          const bool live = kpos < t_len && (!causal || kpos <= qpos) &&
                            (window <= 0 || kpos > qpos - window);
          sc[j][c] = live ? s : kNeg;
          mx = fmaxf(mx, sc[j][c]);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      alpha[h] = m[h] > kNeg / 2 ? expf(m[h] - m_new) : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int c = 2 * h; c < 2 * h + 2; ++c) {
          const float p = sc[j][c] > kNeg / 2 ? expf(sc[j][c] - m_new) : 0.f;
          sc[j][c] = p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[h] = l[h] * alpha[h] + sum;
      m[h] = m_new;
    }

#pragma unroll
    for (int n = 0; n < kOT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a0 = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      const uint32_t a1 = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      const uint32_t a2 = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < kOT; ++n) {
        const __nv_bfloat16* vrow = s_vt + (8 * n + g) * kVP + 16 * kk + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(vrow);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(vrow + 8);
        mma_bf16(acc[n], a0, a1, a2, a3, b0, b1);
      }
    }
  }

  __nv_bfloat16* og = o + ((size_t)bh * s_len + q0) * DH;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= rows) continue;
    const float inv = 1.f / fmaxf(l[h], 1e-20f);
#pragma unroll
    for (int n = 0; n < kOT; ++n) {
      *reinterpret_cast<uint32_t*>(og + (size_t)r * DH + 8 * n + 2 * t) =
          pack_bf16(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int b, int hq,
           int hkv, int s_len, int t_len, int bf16, float scale, int causal,
           int window, float softcap, cudaStream_t stream) {
  const dim3 grid((s_len + kBQ - 1) / kBQ, b * hq);
  if (bf16) {
    fa_forward_mma_kernel<DH><<<grid, kMmaThreads, 0, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (__nv_bfloat16*)o, hq, hkv, s_len, t_len, scale, causal, window, softcap);
    return (int)cudaGetLastError();
  }
  auto kern = fa_forward_f32_kernel<DH>;
  const size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, hq, hkv, s_len,
      t_len, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// q (b, hq, s_len, dh), k and v (b, hkv, t_len, dh), o (b, hq, s_len, dh), all
// contiguous and of one type (bf16 != 0: bfloat16, else float32).
// window <= 0 means no window; softcap <= 0 means no softcap.
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o,
                          int b, int hq, int hkv, int s_len, int t_len, int dh,
                          int bf16, float scale, int causal, int window,
                          float softcap, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || s_len <= 0 ||
      t_len <= 0 || b * hq > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (dh == 64) {
    return launch<64>(q, k, v, o, b, hq, hkv, s_len, t_len, bf16, scale, causal,
                      window, softcap, st);
  }
  if (dh == 128) {
    return launch<128>(q, k, v, o, b, hq, hkv, s_len, t_len, bf16, scale, causal,
                       window, softcap, st);
  }
  return (int)cudaErrorInvalidValue;
}

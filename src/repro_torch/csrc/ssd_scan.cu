// Hand-written Hopper (sm_90a) kernel for the Mamba2 prefill path.
//
// K5  ssd_scan_f32  replaces repro/kernels/ssd_scan.py::_ssd_kernel
//
// Mamba2 SSD chunked scan.  For every (batch, head) the sequence is cut into
// chunks of L steps that run in order and carry a float32 (P, N) state h:
//
//   cum     = inclusive cumsum of a over the chunk (a <= 0)
//   G[t,s]  = (C_t . B_s) * exp(cum[t] - cum[s]) * [s <= t]
//   y       = G @ x + exp(cum)[:, None] * (C @ h^T)
//   h      <- exp(cum[L-1]) * h + (x * exp(cum[L-1] - cum)[:, None])^T @ B
//
// The TPU kernel runs a grid (B*H, chunks) with the chunk axis innermost and
// carries h in VMEM scratch; its wrapper repeats B and C over the heads of a
// group and moves the head axis in front of time.  Here one CTA owns one
// (batch, head) and walks the chunks itself, h living in registers (each
// thread owns 32 of its entries) and in shared memory for the C h^T product.
// B and C are read by group (head / (H / G)) straight from the (B, S, G, N)
// inputs, and x, a and y keep their (B, S, H, .) layouts: the moveaxis
// relayouts become strides.
//
// Shared memory (design taken: one chunk of x and B resident, C and G tiled
// over rows): x (L x P), B (L x (N+4)), h (P x (N+4)), and for one block of
// 32 rows C (32 x (N+4)) and G (32 x (L+4)), plus cum and the two exp
// vectors.  At mamba2-370m's shapes (L = 128, P = 64, N = 128) that is
// 169,472 bytes, above the 48 KB default, so the entry point raises the
// kernel's dynamic shared-memory limit first.  G is computed only where
// s < t0 + 32 (the tril skips the upper column groups of each row block).
//
// Arithmetic: all float32; cum is summed in order by one thread; every exp
// argument is <= 0, so every factor is <= 1 and no rescaling is needed.
// Sums run in a fixed order and a run repeats bit for bit.
//
// Bound: per chunk the work is L*L*N + L*L*P (intra, about half of it live),
// 2*L*P*N (inter and state), so at L = P = 64..128 the kernel is bound by
// operations, on the CUDA cores (float32, 67 TFLOP/s peak).  What bounds it
// in practice is parallelism: the launch has B*H CTAs (128 at B = 4, H = 32),
// about one per SM of the 132, each walking S / L chunks in sequence with 8
// warps.  Splitting the scan over chunks (a second pass that carries the
// states) and tensor cores (TF32 / 3xTF32 mma) are later work.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps; ty = warp, tx = lane
constexpr int kTR = 32;        // rows of G per block
constexpr int kMaxL = 128;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kHP = kMaxP / 8;   // state rows per thread
constexpr int kHN = kMaxN / 32;  // state columns per thread
constexpr int kGC = kMaxL / 32;  // G column groups per thread

size_t smem_floats(int l, int p, int n) {
  const int np = n + 4;
  return (size_t)l * p + (size_t)l * np + (size_t)kTR * np + (size_t)p * np +
         (size_t)kTR * (l + 4) + 3 * (size_t)l;
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_scan_kernel(const float* __restrict__ x, const float* __restrict__ a,
                      const float* __restrict__ bm, const float* __restrict__ cm,
                      float* __restrict__ y, int seq, int h, int g, int p_dim,
                      int n_dim, int chunk) {
  extern __shared__ float4 smem4[];
  const int np = n_dim + 4;
  const int lp = chunk + 4;
  float* s_x = reinterpret_cast<float*>(smem4);  // [chunk][p_dim]
  float* s_b = s_x + chunk * p_dim;               // [chunk][np]
  float* s_c = s_b + chunk * np;                  // [kTR][np]
  float* s_h = s_c + kTR * np;                    // [p_dim][np]
  float* s_g = s_h + p_dim * np;                  // [kTR][lp]
  float* s_cum = s_g + kTR * lp;                  // [chunk]
  float* s_e = s_cum + chunk;                     // exp(cum[t])
  float* s_w = s_e + chunk;                       // exp(cum[L-1] - cum[t])

  const int bi = blockIdx.x / h;
  const int hi = blockIdx.x % h;
  const int gi = hi / (h / g);
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const size_t x_t = (size_t)h * p_dim;   // x / y stride between time steps
  const size_t b_t = (size_t)g * n_dim;   // B / C stride between time steps
  const float* xg = x + (size_t)bi * seq * x_t + (size_t)hi * p_dim;
  float* yg = y + (size_t)bi * seq * x_t + (size_t)hi * p_dim;
  const float* ag = a + (size_t)bi * seq * h + hi;
  const float* bg = bm + (size_t)bi * seq * b_t + (size_t)gi * n_dim;
  const float* cg = cm + (size_t)bi * seq * b_t + (size_t)gi * n_dim;

  float hreg[kHP][kHN];  // h[ty + 8 i][tx + 32 j]
#pragma unroll
  for (int i = 0; i < kHP; ++i)
#pragma unroll
    for (int j = 0; j < kHN; ++j) hreg[i][j] = 0.f;
  for (int e = tid; e < p_dim * np; e += kThreads) s_h[e] = 0.f;

  for (int c0 = 0; c0 < seq; c0 += chunk) {
    // ---- stage the chunk: x, B, a ------------------------------------
    for (int e = tid; e < chunk * p_dim; e += kThreads) {
      const int t = e / p_dim;
      s_x[e] = xg[(size_t)(c0 + t) * x_t + (e - t * p_dim)];
    }
    for (int e = tid; e < chunk * n_dim; e += kThreads) {
      const int t = e / n_dim;
      const int n = e - t * n_dim;
      s_b[t * np + n] = bg[(size_t)(c0 + t) * b_t + n];
    }
    for (int t = tid; t < chunk; t += kThreads) s_cum[t] = ag[(size_t)(c0 + t) * h];
    __syncthreads();
    if (tid == 0) {  // inclusive cumsum, in order
      float run = 0.f;
      for (int t = 0; t < chunk; ++t) {
        run += s_cum[t];
        s_cum[t] = run;
      }
    }
    __syncthreads();
    for (int t = tid; t < chunk; t += kThreads) {
      s_e[t] = expf(s_cum[t]);
      s_w[t] = expf(s_cum[chunk - 1] - s_cum[t]);
    }
    // s_e / s_w are first read after the next barrier

    // ---- outputs, 32 rows at a time ------------------------------------
    for (int t0 = 0; t0 < chunk; t0 += kTR) {
      const int rows = min(kTR, chunk - t0);
      for (int e = tid; e < kTR * n_dim; e += kThreads) {
        const int r = e / n_dim;
        const int n = e - r * n_dim;
        s_c[r * np + n] = r < rows ? cg[(size_t)(c0 + t0 + r) * b_t + n] : 0.f;
      }
      __syncthreads();

      // G rows r = ty + 8 i, columns s = tx + 32 j with s < t0 + kTR
      const int jg = min((chunk + 31) / 32, (t0 + kTR + 31) / 32);
      float gacc[4][kGC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kGC; ++j) gacc[i][j] = 0.f;
      for (int n = 0; n < n_dim; n += 4) {
        float4 cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cv[i] = *reinterpret_cast<const float4*>(s_c + (ty + 8 * i) * np + n);
#pragma unroll
        for (int j = 0; j < kGC; ++j) {
          const int s = tx + 32 * j;
          if (j >= jg || s >= chunk) continue;
          const float4 bv = *reinterpret_cast<const float4*>(s_b + s * np + n);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            gacc[i][j] = fmaf(cv[i].x, bv.x, gacc[i][j]);
            gacc[i][j] = fmaf(cv[i].y, bv.y, gacc[i][j]);
            gacc[i][j] = fmaf(cv[i].z, bv.z, gacc[i][j]);
            gacc[i][j] = fmaf(cv[i].w, bv.w, gacc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 8 * i;
        const int t = t0 + r;
#pragma unroll
        for (int j = 0; j < kGC; ++j) {
          const int s = tx + 32 * j;
          if (j >= jg || s >= chunk) continue;
          s_g[r * lp + s] =
              (r < rows && s <= t) ? gacc[i][j] * expf(s_cum[t] - s_cum[s]) : 0.f;
        }
      }
      __syncthreads();

      // y rows r = ty + 8 i, columns p = tx + 32 k
      const int s_end = t0 + rows;
      float yi[4][2], yh[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 2; ++k) yi[i][k] = yh[i][k] = 0.f;
      const bool p0 = tx < p_dim;
      const bool p1 = tx + 32 < p_dim;
      for (int s = 0; s < s_end; ++s) {
        const float x0 = p0 ? s_x[s * p_dim + tx] : 0.f;
        const float x1 = p1 ? s_x[s * p_dim + tx + 32] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float gv = s_g[(ty + 8 * i) * lp + s];
          yi[i][0] = fmaf(gv, x0, yi[i][0]);
          yi[i][1] = fmaf(gv, x1, yi[i][1]);
        }
      }
      for (int n = 0; n < n_dim; n += 4) {
        float4 hv[2];
        hv[0] = p0 ? *reinterpret_cast<const float4*>(s_h + tx * np + n)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
        hv[1] = p1 ? *reinterpret_cast<const float4*>(s_h + (tx + 32) * np + n)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 cv = *reinterpret_cast<const float4*>(s_c + (ty + 8 * i) * np + n);
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            yh[i][k] = fmaf(cv.x, hv[k].x, yh[i][k]);
            yh[i][k] = fmaf(cv.y, hv[k].y, yh[i][k]);
            yh[i][k] = fmaf(cv.z, hv[k].z, yh[i][k]);
            yh[i][k] = fmaf(cv.w, hv[k].w, yh[i][k]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 8 * i;
        if (r >= rows) continue;
        const float e = s_e[t0 + r];
        float* yrow = yg + (size_t)(c0 + t0 + r) * x_t;
        if (p0) yrow[tx] = yi[i][0] + e * yh[i][0];
        if (p1) yrow[tx + 32] = yi[i][1] + e * yh[i][1];
      }
      __syncthreads();  // s_c and s_g are rewritten by the next row block
    }

    // ---- carry the state ------------------------------------------------
    const float decay = expf(s_cum[chunk - 1]);
    float hacc[kHP][kHN];
#pragma unroll
    for (int i = 0; i < kHP; ++i)
#pragma unroll
      for (int j = 0; j < kHN; ++j) hacc[i][j] = 0.f;
    for (int t = 0; t < chunk; ++t) {
      const float w = s_w[t];
      float xv[kHP], bv[kHN];
#pragma unroll
      for (int i = 0; i < kHP; ++i) {
        const int p = ty + 8 * i;
        xv[i] = p < p_dim ? s_x[t * p_dim + p] * w : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kHN; ++j) {
        const int n = tx + 32 * j;
        bv[j] = n < n_dim ? s_b[t * np + n] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kHP; ++i)
#pragma unroll
        for (int j = 0; j < kHN; ++j) hacc[i][j] = fmaf(xv[i], bv[j], hacc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kHP; ++i) {
      const int p = ty + 8 * i;
#pragma unroll
      for (int j = 0; j < kHN; ++j) {
        const int n = tx + 32 * j;
        hreg[i][j] = decay * hreg[i][j] + hacc[i][j];
        if (p < p_dim && n < n_dim) s_h[p * np + n] = hreg[i][j];
      }
    }
    __syncthreads();  // h, x and B are read / rewritten by the next chunk
  }
}

}  // namespace

// x (batch, seq, h, p_dim), a (batch, seq, h), b and c (batch, seq, g, n_dim),
// y (batch, seq, h, p_dim); all float32 and contiguous.
extern "C" int ssd_scan_f32(const void* x, const void* a, const void* b, const void* c,
                            void* y, int batch, int seq, int h, int g, int p_dim,
                            int n_dim, int chunk, void* stream) {
  if (batch <= 0 || seq <= 0 || h <= 0 || g <= 0 || h % g != 0 || chunk <= 0 ||
      chunk > kMaxL || chunk % 4 != 0 || seq % chunk != 0 || p_dim <= 0 ||
      p_dim > kMaxP || p_dim % 4 != 0 || n_dim <= 0 || n_dim > kMaxN ||
      n_dim % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_floats(chunk, p_dim, n_dim) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_scan_kernel<<<batch * h, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)a, (const float*)b, (const float*)c, (float*)y,
      seq, h, g, p_dim, n_dim, chunk);
  return (int)cudaGetLastError();
}

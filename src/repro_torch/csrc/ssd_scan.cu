// Hand-written Hopper (sm_90a) kernels for the Mamba2 prefill path.
//
// K5  ssd_scan_f32  replaces repro/kernels/ssd_scan.py::_ssd_kernel
//
// Mamba2 SSD chunked scan.  For every (batch, head) the sequence is cut into
// chunks of L steps that carry a float32 (P, N) state h from one to the next:
//
//   cum     = inclusive cumsum of a over the chunk (a <= 0)
//   G[t,s]  = (C_t . B_s) * exp(cum[t] - cum[s]) * [s <= t]
//   y       = G @ x + exp(cum)[:, None] * (C @ h^T)
//   h      <- exp(cum[L-1]) * h + (x * exp(cum[L-1] - cum)[:, None])^T @ B
//
// The TPU kernel runs a grid (B*H, chunks) with the chunk axis innermost and
// carries h in VMEM scratch.  Only the state update is sequential over the
// chunks, and it is elementwise; everything else is independent per chunk
// (Mamba2's own chunked algorithm, arXiv:2405.21060 section 6).  So
// ssd_scan_f32 launches four passes in turn on the caller's stream, over
// scratch that the wrapper allocates:
//
//   1. chunk pass, a CTA per (b, h, chunk): cum by a warp scan (each lane
//      sums 4 steps in order, then a shuffle scan of the lane totals), and
//      the chunk's own state contribution S_c = (x * exp(cum[L-1] - cum))^T B,
//      a (P x L)(L x N) product.  Writes cum and S_c.
//   2. C B^T pass, a CTA per (b, group, chunk): G = C B^T (L x L), which
//      depends on the group only, computed once for the H / G heads that
//      share it, lower 32 x 32 tiles only.  8.4 MB at mamba2-370m's B = 4,
//      S = 4096, read back from L2.
//   3. state pass, a CTA per (b, h) and 1024 state entries: h_0 = 0,
//      h_{c+1} = exp(cum_c[L-1]) h_c + S_c in chunk order, each thread
//      owning 4 entries; the state entering chunk c overwrites S_c.  This
//      pass is bound by memory: B*H*(S/L)*P*N*4 bytes each way, 134 MB at
//      B = 4, S = 4096 (about 0.08 ms at 3.35 TB/s).
//   4. output pass, a CTA per (b, h, chunk): y = (G o decay) x + (exp(cum) o
//      C) h_c^T, the masked L x L product first (summing only to the end of
//      each 16-row slab: the rest is 0; a warp takes slabs q and L/16 - 1 - q
//      so that all do the same work) then the state term.
//
// Arithmetic: the four products run on the tensor cores as 3xTF32
// (mma.sync.m16n8k8.tf32, float32 accumulators): each float32 operand is
// split into hi = tf32(a) and lo = tf32(a - hi), both cut to TF32 (the low
// 13 mantissa bits dropped), and every k step adds lo*hi, hi*lo, then hi*hi.
// That keeps about 20 bits of each product, where TF32 alone keeps 11,
// which at |y| of tens would miss the 3e-4 tolerance.  A warp owns a 32 x 32
// output tile, eight warps a CTA.  No atomics; every sum runs in a fixed
// order, so a run repeats bit for bit.  Every exp argument is clamped to
// <= 0 (the warp scan need not give a non-increasing cum bit for bit).
//
// Bound: the operations (per (b, h, chunk) 2*live*P + 4*L*P*N, per (b, g,
// chunk) 2*live*N, live = L(L+1)/2): 21.7 GFLOP at B = 4, S = 4096, three
// TF32 products each, 0.13 ms at 495 TFLOP/s; the inputs and output take
// 0.086 ms at 3.35 TB/s.  What the design does about the one-CTA-per-(b, h)
// kernel it replaces (128 CTAs, 8 warps an SM, scalar FFMA, C B^T per head):
// B*H*S/L CTAs (4096 at that shape) of 104 KB shared memory, two an SM;
// products on the tensor cores; C B^T once per group.  What holds it above
// the bound now: each CTA stages its operands through registers between
// barriers, so its loads and its products do not overlap, and an SM's two
// CTAs tend to run the same phase at the same time.
//
// The C entry point allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, each owning a 32 x 32 output tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 128;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kScanSteps = kMaxL / 32;  // steps a lane sums in the chunk scan
constexpr int kStateThreads = 256;      // state pass: 4 entries a thread

// Padded extents: every product dimension is a multiple of 32 in shared
// memory, zero filled past the real one.
__host__ __device__ constexpr int pad32(int v) { return (v + 31) / 32 * 32; }

// Row pitches (floats).  A fragment read walks 8 rows (lane / 4) and 4
// columns (lane % 4), or the transpose; a pitch of 4 mod 32 (data read along
// the row) or 8 mod 32 (data read down the column) puts the 32 lanes on 32
// banks.
__host__ __device__ constexpr int pitch_k(int cols) { return pad32(cols) + 4; }
__host__ __device__ constexpr int pitch_mn(int cols) { return pad32(cols) + 8; }

size_t chunk_smem(int l, int p, int n) {  // x * w, B, cum, w
  return sizeof(float) * ((size_t)pad32(l) * (pitch_mn(p) + pitch_mn(n)) + 2 * pad32(l));
}
size_t cb_smem(int l, int n) {  // C, B
  return sizeof(float) * 2 * (size_t)pad32(l) * pitch_k(n);
}
size_t out_smem(int l, int p, int n) {  // max(G o decay + x, C o e + h), then cum, e
  const size_t a = (size_t)pad32(l) * (pitch_k(l) + pitch_mn(p));
  const size_t b = (size_t)(pad32(l) + pad32(p)) * pitch_k(n);
  return sizeof(float) * ((a > b ? a : b) + 2 * pad32(l));
}

// ---- warp products ---------------------------------------------------------

// v = hi + lo: hi is v cut to TF32 (its 13 low mantissa bits dropped), lo
// the exact rest, which the tensor core reads as TF32 the same way (it
// ignores those bits of a float32 register).  Two instructions an operand.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d (16 x 8) += a (16 x 8) b (8 x 8), tf32 in, float32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp: acc += A B for a tile of two 16-row halves by 32 columns,
// A(m, k) = a_i[m am + k ak] for half i (a_i at its first row) over k in
// [0, k_i), and B(k, n) = b[k bk + n bn] (b at the tile's first column), in
// shared memory; k_0 and k_1 are multiples of 8.  acc[i][j][2 h + c] is row
// g + 8 h of half i, column 8 j + 2 t + c (g = lane / 4, t = lane % 4): the
// accumulator layout of mma.m16n8k8.
__device__ __forceinline__ void warp_tile(float (&acc)[2][4][4], const float* a0,
                                          const float* a1, int am, int ak, const float* b,
                                          int bk, int bn, int k_0, int k_1) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float* a[2] = {a0, a1};
  const int k_end = max(k_0, k_1);
  for (int k = 0; k < k_end; k += 8) {
    const bool live[2] = {k < k_0, k < k_1};  // uniform across the warp
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (live[i])
          split_tf32(a[i][(g + 8 * (r & 1)) * am + (k + t + 4 * (r >> 1)) * ak], ah[i][r],
                     al[i][r]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        split_tf32(b[(k + t + 4 * r) * bk + (8 * j + g) * bn], bh[j][r], bl[j][r]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!live[i]) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_tf32(acc[i][j], al[i], bh[j]);
        mma_tf32(acc[i][j], ah[i], bl[j]);
        mma_tf32(acc[i][j], ah[i], bh[j]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
}

// Stores a warp's tile, its halves at rows r0 and r1 on, at out[row * ld +
// col] for row < rows, col < cols (cols even), two columns at a time.
__device__ __forceinline__ void store_tile(const float (&acc)[2][4][4], float* out, size_t ld,
                                           int r0, int r1, int n0, int rows, int cols) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (i == 0 ? r0 : r1) + g + 8 * h;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + 8 * j + 2 * t;
        if (c < cols)
          *reinterpret_cast<float2*>(out + r * ld + c) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

// Copies rows x cols floats (row stride `stride`) into shared memory at
// `pitch`, scaled by row_scale[r] where given, zero filled to rows_p x
// pad32(cols); cols and the addresses are multiples of 4 floats.  Each
// thread issues kStageBatch 16-byte loads before it stores any, so that the
// copy is not one load's latency per element.
constexpr int kStageBatch = 4;

__device__ __forceinline__ void stage(float* dst, int pitch, const float* __restrict__ src,
                                      size_t stride, int rows, int cols, int rows_p,
                                      const float* row_scale) {
  const int c4 = pad32(cols) / 4;
  const int total = rows_p * c4;
  for (int e0 = threadIdx.x; e0 < total; e0 += kStageBatch * kThreads) {
    float4 v[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int e = e0 + u * kThreads;
      const int r = e / c4;
      const int q = (e - r * c4) * 4;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < total && r < rows && q < cols)
        v[u] = *reinterpret_cast<const float4*>(src + r * stride + q);
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int e = e0 + u * kThreads;
      const int r = e / c4;
      const int q = (e - r * c4) * 4;
      if (e >= total) break;
      if (row_scale != nullptr && r < rows) {
        const float s = row_scale[r];
        v[u].x *= s;
        v[u].y *= s;
        v[u].z *= s;
        v[u].w *= s;
      }
      *reinterpret_cast<float4*>(dst + r * pitch + q) = v[u];
    }
  }
}

// ---- pass 1: cum and the chunk's own state contribution ---------------------

__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_state_kernel(const float* __restrict__ x, const float* __restrict__ a,
                       const float* __restrict__ bm, float* __restrict__ cum_out,
                       float* __restrict__ states, int seq, int h, int g, int p_dim,
                       int n_dim, int chunk) {
  extern __shared__ float4 smem4[];
  const int lp = pad32(chunk);
  const int xp = pitch_mn(p_dim);
  const int bp = pitch_mn(n_dim);
  float* s_x = reinterpret_cast<float*>(smem4);  // [lp][xp]: x * w, then A = its transpose
  float* s_b = s_x + lp * xp;                     // [lp][bp]
  float* s_cum = s_b + lp * bp;                   // [lp]
  float* s_w = s_cum + lp;                        // [lp]: exp(cum[L-1] - cum)

  const int c = blockIdx.x;
  const int nc = gridDim.x;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int gi = hi / (h / g);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t t0 = (size_t)bi * seq + (size_t)c * chunk;  // first time step
  const size_t bhc = ((size_t)bi * h + hi) * nc + c;

  if (warp == 0) {  // inclusive cumsum: 4 steps a lane in order, then the lane totals
    const float* ag = a + t0 * h + hi;
    float v[kScanSteps];
    float run = 0.f;
#pragma unroll
    for (int i = 0; i < kScanSteps; ++i) {
      const int t = kScanSteps * lane + i;
      run += t < chunk ? ag[(size_t)t * h] : 0.f;
      v[i] = run;
    }
    float incl = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += o;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
#pragma unroll
    for (int i = 0; i < kScanSteps; ++i) {
      const int t = kScanSteps * lane + i;
      if (t < lp) s_cum[t] = excl + v[i];  // past the chunk: unused
    }
  }
  stage(s_b, bp, bm + t0 * g * n_dim + (size_t)gi * n_dim, (size_t)g * n_dim, chunk, n_dim,
        lp, nullptr);
  __syncthreads();
  const float last = s_cum[chunk - 1];
  for (int t = threadIdx.x; t < lp; t += kThreads) {
    s_w[t] = t < chunk ? expf(fminf(last - s_cum[t], 0.f)) : 0.f;
    if (t < chunk) cum_out[bhc * chunk + t] = s_cum[t];
  }
  __syncthreads();
  stage(s_x, xp, x + t0 * h * p_dim + (size_t)hi * p_dim, (size_t)h * p_dim, chunk, p_dim, lp,
        s_w);
  __syncthreads();

  // S_c (P x N): A(p, t) = s_x[t][p], B(t, n) = s_b[t][n]; at most 2 x 4 tiles
  const int tn = pad32(n_dim) / 32;
  if (warp < pad32(p_dim) / 32 * tn) {
    const int m0 = warp / tn * 32;
    const int n0 = warp % tn * 32;
    float acc[2][4][4];
    zero(acc);
    warp_tile(acc, s_x + m0, s_x + m0 + 16, 1, xp, s_b + n0, bp, 1, lp, lp);
    store_tile(acc, states + bhc * p_dim * n_dim, n_dim, m0, m0 + 16, n0, p_dim, n_dim);
  }
}

// ---- pass 2: G = C B^T once per group ---------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
ssd_cb_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
              float* __restrict__ gmat, int seq, int g, int n_dim, int chunk) {
  extern __shared__ float4 smem4[];
  const int lp = pad32(chunk);
  const int cp = pitch_k(n_dim);
  float* s_c = reinterpret_cast<float*>(smem4);  // [lp][cp]
  float* s_b = s_c + lp * cp;                     // [lp][cp]
  const int c = blockIdx.x;
  const int nc = gridDim.x;
  const int gi = blockIdx.y;
  const int bi = blockIdx.z;
  const size_t off = ((size_t)bi * seq + (size_t)c * chunk) * g * n_dim + (size_t)gi * n_dim;
  stage(s_c, cp, cm + off, (size_t)g * n_dim, chunk, n_dim, lp, nullptr);
  stage(s_b, cp, bm + off, (size_t)g * n_dim, chunk, n_dim, lp, nullptr);
  __syncthreads();
  // A(t, n) = s_c[t][n], B(n, s) = s_b[s][n]; tiles (mt, nt) with nt <= mt
  const int tl = lp / 32;
  float* out = gmat + (((size_t)bi * g + gi) * nc + c) * lp * lp;
  for (int tile = threadIdx.x >> 5; tile < tl * (tl + 1) / 2; tile += kWarps) {
    int mt = 0;
    while ((mt + 1) * (mt + 2) / 2 <= tile) ++mt;
    const int nt = tile - mt * (mt + 1) / 2;
    float acc[2][4][4];
    zero(acc);
    const float* a = s_c + mt * 32 * cp;
    warp_tile(acc, a, a + 16 * cp, cp, 1, s_b + nt * 32 * cp, 1, cp, pad32(n_dim),
                   pad32(n_dim));
    store_tile(acc, out, lp, mt * 32, mt * 32 + 16, nt * 32, lp, lp);
  }
}

// ---- pass 3: the states entering each chunk ---------------------------------

__global__ void __launch_bounds__(kStateThreads)
ssd_state_pass_kernel(const float* __restrict__ cum, float* __restrict__ states, int nc,
                      int h, int pn, int chunk) {
  const int e4 = blockIdx.x * kStateThreads + threadIdx.x;  // 4 entries of the (P, N) state
  if (4 * e4 >= pn) return;
  const size_t bh = (size_t)blockIdx.z * h + blockIdx.y;
  float4* st = reinterpret_cast<float4*>(states + bh * nc * pn) + e4;
  const float* last = cum + bh * nc * chunk + chunk - 1;
  const int step = pn / 4;  // float4s between consecutive chunks' states
  constexpr int kAhead = 8;  // chunks loaded before the dependent updates
  float4 hc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float4 s[kAhead];
    float d[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (c0 + u < nc) {
        s[u] = st[(size_t)(c0 + u) * step];
        d[u] = expf(last[(size_t)(c0 + u) * chunk]);
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (c0 + u < nc) {
        st[(size_t)(c0 + u) * step] = hc;
        hc.x = fmaf(d[u], hc.x, s[u].x);
        hc.y = fmaf(d[u], hc.y, s[u].y);
        hc.z = fmaf(d[u], hc.z, s[u].z);
        hc.w = fmaf(d[u], hc.w, s[u].w);
      }
    }
  }
}

// ---- pass 4: outputs --------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 2)
ssd_output_kernel(const float* __restrict__ x, const float* __restrict__ cm,
                  const float* __restrict__ cum, const float* __restrict__ states,
                  const float* __restrict__ gmat, float* __restrict__ y, int seq, int h, int g,
                  int p_dim, int n_dim, int chunk) {
  extern __shared__ float4 smem4[];
  const int lp = pad32(chunk);
  const int gp = pitch_k(chunk);
  const int xp = pitch_mn(p_dim);
  const int cp = pitch_k(n_dim);
  const size_t region = max((size_t)lp * (gp + xp), (size_t)(lp + pad32(p_dim)) * cp);
  float* s_g = reinterpret_cast<float*>(smem4);  // phase 1: [lp][gp] G o decay
  float* s_x = s_g + lp * gp;                     //          [lp][xp] x
  float* s_c = reinterpret_cast<float*>(smem4);  // phase 2: [lp][cp] exp(cum) o C
  float* s_h = s_c + lp * cp;                     //          [pad32(p)][cp] h_c
  float* s_cum = s_g + region;                    // [lp]
  float* s_e = s_cum + lp;                        // [lp]: exp(cum)

  const int c = blockIdx.x;
  const int nc = gridDim.x;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int gi = hi / (h / g);
  const int warp = threadIdx.x >> 5;
  const size_t t0 = (size_t)bi * seq + (size_t)c * chunk;
  const size_t bhc = ((size_t)bi * h + hi) * nc + c;

  for (int t = threadIdx.x; t < lp; t += kThreads) {
    const float v = cum[bhc * chunk + min(t, chunk - 1)];
    s_cum[t] = v;
    s_e[t] = t < chunk ? expf(v) : 0.f;
  }
  __syncthreads();
  // G o decay, zero above the diagonal and past the chunk
  const float* gsrc = gmat + (((size_t)bi * g + gi) * nc + c) * lp * lp;
  const int l4 = lp / 4;
  for (int e0 = threadIdx.x; e0 < lp * l4; e0 += kStageBatch * kThreads) {
    float4 v[kStageBatch];  // loads first, as in stage()
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int e = e0 + u * kThreads;
      const int t = e / l4;
      const int s0 = (e - t * l4) * 4;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < lp * l4 && t < chunk && s0 <= t)
        v[u] = *reinterpret_cast<const float4*>(gsrc + t * lp + s0);
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int e = e0 + u * kThreads;
      if (e >= lp * l4) break;
      const int t = e / l4;
      const int s0 = (e - t * l4) * 4;
      if (t < chunk && s0 <= t) {
        const float ct = s_cum[t];
        v[u].x = v[u].x * expf(fminf(ct - s_cum[s0], 0.f));
        v[u].y = s0 + 1 <= t ? v[u].y * expf(fminf(ct - s_cum[s0 + 1], 0.f)) : 0.f;
        v[u].z = s0 + 2 <= t ? v[u].z * expf(fminf(ct - s_cum[s0 + 2], 0.f)) : 0.f;
        v[u].w = s0 + 3 <= t ? v[u].w * expf(fminf(ct - s_cum[s0 + 3], 0.f)) : 0.f;
      }
      *reinterpret_cast<float4*>(s_g + t * gp + s0) = v[u];
    }
  }
  stage(s_x, xp, x + t0 * h * p_dim + (size_t)hi * p_dim, (size_t)h * p_dim, chunk, p_dim, lp,
        nullptr);
  __syncthreads();

  // y (L x P): a warp owns 32 columns of two 16-row slabs, slab q and slab
  // lp / 16 - 1 - q, so that the masked product (summing over s up to the
  // end of each slab) costs every warp the same; at most 4 x 2 warps
  const int tn = pad32(p_dim) / 32;
  const bool owner = warp < lp / 32 * tn;
  const int r0 = warp / tn * 16;
  const int r1 = lp - 16 - r0;
  const int n0 = warp % tn * 32;
  float acc[2][4][4];
  zero(acc);
  if (owner)  // A(t, s) = s_g[t][s], B(s, p) = s_x[s][p]; s past a slab's rows is 0
    warp_tile(acc, s_g + r0 * gp, s_g + r1 * gp, gp, 1, s_x + n0, xp, 1, r0 + 16,
                   r1 + 16);
  __syncthreads();  // phase 2 overwrites s_g and s_x
  stage(s_c, cp, cm + t0 * g * n_dim + (size_t)gi * n_dim, (size_t)g * n_dim, chunk, n_dim, lp,
        s_e);
  stage(s_h, cp, states + bhc * p_dim * n_dim, n_dim, p_dim, n_dim, pad32(p_dim), nullptr);
  __syncthreads();
  if (owner) {  // A(t, n) = s_c[t][n], B(n, p) = s_h[p][n]
    warp_tile(acc, s_c + r0 * cp, s_c + r1 * cp, cp, 1, s_h + n0 * cp, 1, cp,
                   pad32(n_dim), pad32(n_dim));
    store_tile(acc, y + t0 * h * p_dim + (size_t)hi * p_dim, (size_t)h * p_dim, r0, r1, n0, chunk,
               p_dim);
  }
}

// Raises the three kernels' dynamic shared-memory limit to what the largest
// shape takes, once per device (a bit each); a launch takes only its own.
cudaError_t configure() {
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && (configured >> dev & 1ull))) return err;
  err = cudaFuncSetAttribute(ssd_chunk_state_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)chunk_smem(kMaxL, kMaxP, kMaxN));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_cb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)cb_smem(kMaxL, kMaxN));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_output_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)out_smem(kMaxL, kMaxP, kMaxN));
  if (err == cudaSuccess && dev < 64) configured |= 1ull << dev;
  return err;
}

int launch(const float* x, const float* a, const float* b, const float* c, float* y, float* cum,
           float* states, float* gmat, int batch, int seq, int h, int g, int p_dim, int n_dim,
           int chunk, cudaStream_t stream) {
  const int nc = seq / chunk;
  const size_t s1 = chunk_smem(chunk, p_dim, n_dim);
  const size_t s2 = cb_smem(chunk, n_dim);
  const size_t s4 = out_smem(chunk, p_dim, n_dim);
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_state_kernel<<<dim3(nc, h, batch), kThreads, s1, stream>>>(
      x, a, b, cum, states, seq, h, g, p_dim, n_dim, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_cb_kernel<<<dim3(nc, g, batch), kThreads, s2, stream>>>(b, c, gmat, seq, g, n_dim, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int pn = p_dim * n_dim;
  const int blocks = (pn / 4 + kStateThreads - 1) / kStateThreads;
  ssd_state_pass_kernel<<<dim3(blocks, h, batch), kStateThreads, 0, stream>>>(cum, states, nc, h,
                                                                              pn, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_output_kernel<<<dim3(nc, h, batch), kThreads, s4, stream>>>(
      x, c, cum, states, gmat, y, seq, h, g, p_dim, n_dim, chunk);
  return (int)cudaGetLastError();
}

bool valid(int batch, int seq, int h, int g, int p_dim, int n_dim, int chunk) {
  return batch > 0 && seq > 0 && h > 0 && g > 0 && h % g == 0 && chunk > 0 &&
         chunk <= kMaxL && chunk % 4 == 0 && seq % chunk == 0 && p_dim > 0 &&
         p_dim <= kMaxP && p_dim % 4 == 0 && n_dim > 0 && n_dim <= kMaxN && n_dim % 4 == 0 &&
         h <= 65535 && batch <= 65535;  // grid y and z
}

}  // namespace

// Floats of scratch a call takes: sizes[0] cum (batch, h, seq), sizes[1] the
// chunk states (batch, h, seq / chunk, p_dim, n_dim), sizes[2] C B^T
// (batch, g, seq / chunk, pad32(chunk), pad32(chunk)).
extern "C" int ssd_scan_scratch(int batch, int seq, int h, int g, int p_dim, int n_dim,
                                int chunk, long long* sizes) {
  if (!valid(batch, seq, h, g, p_dim, n_dim, chunk)) return (int)cudaErrorInvalidValue;
  const long long nc = seq / chunk;
  sizes[0] = (long long)batch * h * seq;
  sizes[1] = (long long)batch * h * nc * p_dim * n_dim;
  sizes[2] = (long long)batch * g * nc * pad32(chunk) * pad32(chunk);
  return 0;
}

// x (batch, seq, h, p_dim), a (batch, seq, h), b and c (batch, seq, g, n_dim),
// y (batch, seq, h, p_dim); all float32 and contiguous.  cum, states and gmat
// are scratch of the sizes ssd_scan_scratch gives.
extern "C" int ssd_scan_f32(const void* x, const void* a, const void* b, const void* c,
                            void* y, void* cum, void* states, void* gmat, int batch, int seq,
                            int h, int g, int p_dim, int n_dim, int chunk, void* stream) {
  if (!valid(batch, seq, h, g, p_dim, n_dim, chunk)) return (int)cudaErrorInvalidValue;
  return launch((const float*)x, (const float*)a, (const float*)b, (const float*)c, (float*)y,
                (float*)cum, (float*)states, (float*)gmat, batch, seq, h, g, p_dim, n_dim, chunk,
                (cudaStream_t)stream);
}

// Hand-written Hopper (sm_90a) kernels for the device SGB composer.
//
// K3  spgemm_bool_u8  replaces repro/kernels/spgemm_bsr.py::_spgemm_kernel
//
// Boolean product of tile-padded 0/1 matrices, out = (A @ B) > 0, where the
// (mi, ki) x (ki, ni) pair of 128 x 128 tiles is multiplied only when both
// tile-occupancy bits are set.  The TPU kernel runs a grid (Mt, Nt, Kt) with
// k innermost and carries the output tile in VMEM across the k steps.  Here
// a CTA owns one output tile (or, for narrow products, one slice of its k
// range) and walks the list of its live ki itself: a dead pair costs a
// bitmap test and no tile load.  On store the tile is saturated to 0/1 and
// the CTA writes the tile's occupancy bit as well, so the composer's next
// step needs no second scan of the output.  Stale bitmaps are honoured: a
// cleared bit drops that tile's pairs whatever the tile holds.
//
// Exactness: operands are uint8 0/1, products are 0 or 1 and each output sums
// at most K of them in int32, so the result is exact in any order of the
// sums; with split k the partial tiles meet by a bitwise OR, which is
// associative and idempotent.  Runs repeat bit for bit.
//
// Bound: the work is 2 * 128^3 operations per live tile pair; at the shapes
// of the SGB plans that is far above the bytes of the uint8 operands, so the
// kernel is bound by operations, the int8 tensor cores' 1,979 TOP/s, which
// only wgmma reaches.  Each live pair also brings 32 KB of operand tiles
// into shared memory (mostly from L2).
//
// Two kernels, launched in order on the caller's stream:
//
// 1. transpose_tiles_kernel, the B^T pre-pass.  wgmma reads 8-bit operands
//    only K-major from shared memory (its transpose bits exist for 16-bit
//    types alone), and B arrives (K, N) row-major, which is N-major.  One
//    CTA per B tile whose bit is set copies it through shared memory and
//    writes its transpose into the (N, K) scratch bt that the wrapper
//    allocates; 4 x 4 byte blocks are transposed with __byte_perm.  Tiles
//    whose bit is clear are never read by the main kernel, so they are left
//    as they were (no zeroing).
// 2. spgemm_wgmma_kernel.  Two consumer warpgroups (64 output rows each, a
//    64 x 128 int32 accumulator: 64 registers a thread) and one producer
//    warp.  Before the roles split, the CTA counts the live ki of its slice
//    (__syncthreads_count).  The producer warp then tests the slice 32 ki
//    at a time, compacts the live ones in order with __ballot_sync and
//    __popc into a list in shared memory, and for each issues two TMA loads
//    into a kStages-deep ring: A's tile (mi, ki) and B^T's tile (ni, ki),
//    128 rows of 128 bytes each in the 128-byte swizzle, 32 KB a stage.
//    Any Kt is streamed chunk by chunk.  A consumer runs four wgmma
//    m64n128k32.s32.u8.u8 a stage (the descriptors move 32 bytes a k step)
//    and releases a stage once the next one's products are issued.  The
//    epilogue stages the saturated tile in shared memory (ring stage 0, free
//    by then) and writes it with 16-byte stores; the occupancy bit is the OR
//    of both warpgroups' bits.  Shared memory is sized for two CTAs an SM,
//    so that one CTA's epilogue and list scan overlap the other's products.
//    Output tiles are rasterised in groups of kGroupM tile rows, so the CTAs
//    in flight share their A and B^T tiles in L2.
//
// Split k.  Where Mt * Nt is under kSplitCtas (two waves of the 132 SMs),
// split_count() cuts each output tile's ki range into `splits` equal slices,
// keeping at least kMinSplitK ki a slice; the slices are picked from the
// shapes alone.  The wrapper then zero-fills out and out_occ and each CTA
// ORs its partial tile in with atomicOr on 32-bit words (four output bytes;
// words that are 0 are skipped) and sets the occupancy bit the same way.
// With one split the CTA stores plainly into uninitialised memory.
//
// The C entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError() (or the error of building a tensor map).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached at run time
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;          // TILE: output tile side and k depth of a stage
constexpr int kStages = 3;          // depth of the TMA ring (two CTAs an SM)
constexpr int kKStep = 32;          // k bytes of one wgmma (m64n128k32)
constexpr int kWgThreads = 128;     // one warpgroup
constexpr int kConsumers = 2;       // consumer warpgroups, 64 output rows each
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kThreads = kConsumers * kWgThreads + 32;  // + one producer warp
constexpr int kChunk = 32;          // ki values one ballot tests
constexpr int kGroupM = 8;          // raster: tile rows per group
constexpr int kSplitCtas = 264;     // split k while Mt * Nt < kSplitCtas
constexpr int kMinSplitK = 8;       // ki a slice at least
constexpr int kTransposeThreads = 256;
constexpr uint32_t kTileBytes = kTile * kTile;      // one 128 x 128 uint8 tile
constexpr uint32_t kStageBytes = 2 * kTileBytes;    // A and B^T tiles
constexpr int kOutPitch = 144;      // bytes a row of the staged output tile
constexpr uint32_t kBarOffset = kStages * kStageBytes;
constexpr uint32_t kListOffset = kBarOffset + 16 * kStages;
constexpr uint32_t kAnyOffset = kListOffset + 4 * kChunk;
constexpr uint32_t kSmemBytes = kAnyOffset + 16 + 1024;  // + alignment slack
static_assert(kTile * kOutPitch <= kStageBytes, "output staging must fit in stage 0");

// Splits of each output tile's ki range: 1 unless the product has fewer
// than kSplitCtas output tiles; then enough for kSplitCtas CTAs, but at
// least kMinSplitK ki a slice.
int split_count(int mt, int nt, int kt) {
  const long long tiles = (long long)mt * nt;
  if (tiles <= 0 || tiles >= kSplitCtas) return 1;
  int s = (int)((kSplitCtas + tiles - 1) / tiles);
  const int most = kt / kMinSplitK;
  if (s > most) s = most;
  return s < 1 ? 1 : s;
}

// ---- B^T pre-pass ------------------------------------------------------------

// 4 x 4 byte transpose: y[c] byte r = x[r] byte c
__device__ __forceinline__ void transpose4(const uint32_t (&x)[4], uint32_t (&y)[4]) {
  const uint32_t lo01 = __byte_perm(x[0], x[1], 0x5140);  // x0.b0 x1.b0 x0.b1 x1.b1
  const uint32_t hi01 = __byte_perm(x[0], x[1], 0x7362);  // x0.b2 x1.b2 x0.b3 x1.b3
  const uint32_t lo23 = __byte_perm(x[2], x[3], 0x5140);
  const uint32_t hi23 = __byte_perm(x[2], x[3], 0x7362);
  y[0] = __byte_perm(lo01, lo23, 0x5410);
  y[1] = __byte_perm(lo01, lo23, 0x7632);
  y[2] = __byte_perm(hi01, hi23, 0x5410);
  y[3] = __byte_perm(hi01, hi23, 0x7632);
}

// One CTA per B tile (ni, ki); bt (N, K) gets tile (ni, ki) = B tile (ki, ni)^T
// where b_occ[ki * nt + ni] > 0.  Shared rows are padded to 33 words, and
// lane (r, q) = (lane % 8, lane / 8) of a warp reads 4 x 4 block (br, bc) =
// (r + 8 i, q + 4 warp): its 32 reads hit 32 banks, and each store
// instruction writes 4 rows x 32 contiguous bytes of bt.
__global__ void __launch_bounds__(kTransposeThreads)
transpose_tiles_kernel(const uint8_t* __restrict__ b, const int* __restrict__ b_occ,
                       uint8_t* __restrict__ bt, int kt, int nt) {
  const int ni = blockIdx.x;
  const int ki = blockIdx.y;
  if (b_occ[(size_t)ki * nt + ni] <= 0) return;
  __shared__ uint32_t s[kTile * 33];
  const size_t ldb = (size_t)nt * kTile;
  const size_t ldbt = (size_t)kt * kTile;
  const uint8_t* src = b + (size_t)ki * kTile * ldb + (size_t)ni * kTile;
#pragma unroll
  for (int q = 0; q < kTileBytes / 16 / kTransposeThreads; ++q) {
    const int idx = q * kTransposeThreads + threadIdx.x;
    const int row = idx >> 3, ch = idx & 7;
    const uint4 v = *reinterpret_cast<const uint4*>(src + row * ldb + ch * 16);
    uint32_t* d = s + row * 33 + ch * 4;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int bc = (lane >> 3) + 4 * (threadIdx.x >> 5);  // n / 4
  uint8_t* dst = bt + ((size_t)ni * kTile + 4 * bc) * ldbt + (size_t)ki * kTile;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int br = (lane & 7) + 8 * i;  // k / 4
    uint32_t x[4], y[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = s[(4 * br + r) * 33 + bc];
    transpose4(x, y);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<uint32_t*>(dst + c * ldbt + 4 * br) = y[c];
  }
}

// ---- main kernel: wgmma fed by TMA ---------------------------------------------

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

// One TMA box of a 2-D tensor map (bytes, rows) into shared memory,
// completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor for a K-major operand in the 128-byte
// swizzle: start address, leading byte offset (unused, 16) and stride byte
// offset (1024: the next 8 rows), all >> 4, layout type 1 (B128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
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
__device__ __forceinline__ void fence_regs(int (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define SP_D8(i)                                                                       \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
      "+r"(d[i + 6]), "+r"(d[i + 7])

// Accumulator layout of m64n128 (per warpgroup thread: warp w, lane = 4 g + t):
// d[4 j + 2 i + c] is row 16 w + g + 8 i, column 8 j + 2 t + c.

// D (64 x 128, int32) += A (64 x 32) * B (32 x 128), uint8, both K-major in
// shared memory
__device__ __forceinline__ void wgmma_u8_n128(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : SP_D8(0), SP_D8(8), SP_D8(16), SP_D8(24), SP_D8(32), SP_D8(40), SP_D8(48), SP_D8(56)
      : "l"(a), "l"(b), "r"(1));
}

#undef SP_D8

// Output tile of CTA `id`: groups of kGroupM tile rows, column-major inside
// a group, so that the CTAs in flight read few A rows and B^T columns.
__device__ __forceinline__ void tile_of(int id, int mt, int nt, int& mi, int& ni) {
  const int per_group = kGroupM * nt;
  const int group = id / per_group;
  const int first = group * kGroupM;
  const int rows = min(mt - first, kGroupM);
  const int r = id - group * per_group;
  mi = first + r % rows;
  ni = r / rows;
}

__global__ void __launch_bounds__(kThreads, 2)
spgemm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                    const __grid_constant__ CUtensorMap tm_bt,
                    const int* __restrict__ a_occ, const int* __restrict__ b_occ,
                    uint8_t* __restrict__ out, int* __restrict__ out_occ, int mt, int nt,
                    int kt, int splits) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sbase = smem_raw + (base - raw);  // generic pointer to the aligned base
  auto stage_a = [&](int st) { return base + st * kStageBytes; };
  auto stage_b = [&](int st) { return base + st * kStageBytes + kTileBytes; };
  auto full = [&](int st) { return base + kBarOffset + 8u * st; };
  auto empty = [&](int st) { return base + kBarOffset + 8u * (kStages + st); };
  int* s_list = reinterpret_cast<int*>(sbase + kListOffset);
  volatile int* s_any = reinterpret_cast<volatile int*>(sbase + kAnyOffset);

  int mi, ni;
  tile_of(blockIdx.x, mt, nt, mi, ni);
  const int k_lo = (int)((long long)kt * blockIdx.y / splits);
  const int k_hi = (int)((long long)kt * (blockIdx.y + 1) / splits);
  const int* a_row = a_occ + (size_t)mi * kt;
  const int* b_col = b_occ + ni;
  auto live = [&](int ki) { return a_row[ki] > 0 && b_col[(size_t)ki * nt] > 0; };

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumerWarps);
    }
    *s_any = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the live pairs of this CTA's slice, counted by every thread
  int n_live = 0;
  for (int k0 = k_lo; k0 < k_hi; k0 += kThreads) {
    const int ki = k0 + threadIdx.x;
    n_live += __syncthreads_count(ki < k_hi && live(ki));
  }
  __syncthreads();

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  if (warp == kConsumerWarps) {  // producer warp: lane 0 issues every load
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_bt))
                   : "memory");
    }
    int st = 0;
    uint32_t ph = 0;
    for (int k0 = k_lo; k0 < k_hi; k0 += kChunk) {
      const int ki = k0 + lane;
      const bool is_live = ki < k_hi && live(ki);
      const unsigned mask = __ballot_sync(0xffffffffu, is_live);
      if (is_live) s_list[__popc(mask & ((1u << lane) - 1u))] = ki;
      __syncwarp();
      if (lane == 0) {
        const int count = __popc(mask);
        for (int i = 0; i < count; ++i) {
          const int k = s_list[i];
          mbar_wait(empty(st), ph ^ 1);
          mbar_expect_tx(full(st), kStageBytes);
          tma_load_2d(stage_a(st), &tm_a, full(st), k * kTile, mi * kTile);
          tma_load_2d(stage_b(st), &tm_bt, full(st), k * kTile, ni * kTile);
          if (++st == kStages) {
            st = 0;
            ph ^= 1;
          }
        }
      }
      __syncwarp();
    }
    return;
  }

  // consumer warpgroup c: rows 64 c .. 64 c + 63 of the output tile
  const int c = warp / 4;
  const int tid = threadIdx.x % kWgThreads;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  int st = 0, prev = 0;
  uint32_t ph = 0;
  for (int i = 0; i < n_live; ++i) {
    mbar_wait(full(st), ph);
    fence_regs(acc);
    wgmma_fence();
    const uint32_t a0 = stage_a(st) + c * 64 * kTile;
    const uint32_t b0 = stage_b(st);
#pragma unroll
    for (int ks = 0; ks < kTile / kKStep; ++ks)
      wgmma_u8_n128(acc, sw128_desc(a0 + ks * kKStep), sw128_desc(b0 + ks * kKStep));
    wgmma_commit();
    if (i > 0) {  // the previous stage's products are done: release it
      wgmma_wait<1>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(prev));
    }
    prev = st;
    if (++st == kStages) {
      st = 0;
      ph ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Epilogue.  Both warpgroups are done with the ring (every load they
  // waited for has landed, every product has read its operands), so stage
  // 0 takes the saturated tile, 0/1 bytes at a 144-byte row pitch.
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  uint8_t* s_out = sbase;
  int any = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint8_t* row = s_out + (64 * c + 16 * w + g + 8 * i) * kOutPitch + 2 * t4;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      const int v0 = acc[4 * j + 2 * i] > 0;
      const int v1 = acc[4 * j + 2 * i + 1] > 0;
      any |= v0 | v1;
      *reinterpret_cast<uint16_t*>(row + 8 * j) = (uint16_t)(v0 | (v1 << 8));
    }
  }
  if (any) *s_any = 1;
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory");  // this warpgroup's rows
  const size_t ldo = (size_t)nt * kTile;
  uint8_t* dst = out + ((size_t)mi * kTile + 64 * c) * ldo + (size_t)ni * kTile;
#pragma unroll
  for (int q = 0; q < 64 * kTile / 16 / kWgThreads; ++q) {
    const int idx = q * kWgThreads + tid;
    const int r = idx >> 3, ch = idx & 7;
    const uint4 v = *reinterpret_cast<const uint4*>(s_out + (64 * c + r) * kOutPitch + ch * 16);
    uint8_t* p = dst + r * ldo + ch * 16;
    if (splits == 1) {
      *reinterpret_cast<uint4*>(p) = v;
    } else {
      unsigned int* pw = reinterpret_cast<unsigned int*>(p);
      if (v.x) atomicOr(pw + 0, v.x);
      if (v.y) atomicOr(pw + 1, v.y);
      if (v.z) atomicOr(pw + 2, v.z);
      if (v.w) atomicOr(pw + 3, v.w);
    }
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // both warpgroups' bits
  if (threadIdx.x == 0) {
    int* occ = out_occ + (size_t)mi * nt + ni;
    if (splits == 1) {
      *occ = *s_any;
    } else if (*s_any) {
      atomicOr(occ, 1);
    }
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

// A 2-D uint8 tensor map over a row-major (rows, cols) matrix with 128 x 128
// boxes in the 128-byte swizzle.
int tensor_map(CUtensorMap* map, const void* base, long long rows, long long cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {kTile, kTile};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int launch_transpose(const void* b, const void* b_occ, void* bt, int kt, int nt,
                     cudaStream_t stream) {
  if (kt <= 0 || nt <= 0 || kt > 65535) return (int)cudaErrorInvalidValue;
  transpose_tiles_kernel<<<dim3(nt, kt), kTransposeThreads, 0, stream>>>(
      (const uint8_t*)b, (const int*)b_occ, (uint8_t*)bt, kt, nt);
  return (int)cudaGetLastError();
}

}  // namespace

// Splits of each output tile's k range that spgemm_bool_u8 expects for a
// product of mt x nt output tiles over kt k tiles (1: no split; then out and
// out_occ may be uninitialised, else they must hold zeros).
extern "C" int spgemm_split_count(int mt, int nt, int kt) { return split_count(mt, nt, kt); }

// The B^T pre-pass alone: bt (nt * 128, kt * 128) gets the transpose of
// every tile of b (kt * 128, nt * 128) whose b_occ bit is set; its other
// tiles are left as they were.
extern "C" int spgemm_transpose_u8(const void* b, const void* b_occ, void* bt, int kt, int nt,
                                   void* stream) {
  return launch_transpose(b, b_occ, bt, kt, nt, (cudaStream_t)stream);
}

// out (mt * 128, nt * 128) = (a @ b) > 0 over the tile pairs whose bits are
// both set, and out_occ (mt * nt) its tile bits.  a (mt * 128, kt * 128) and
// b (kt * 128, nt * 128) are uint8 0/1, row-major, 16-byte aligned; bt is
// (nt * 128, kt * 128) scratch.  splits is spgemm_split_count(mt, nt, kt);
// above 1, out and out_occ must hold zeros.
extern "C" int spgemm_bool_u8(const void* a, const void* b, const void* a_occ,
                              const void* b_occ, void* bt, void* out, void* out_occ, int mt,
                              int nt, int kt, int splits, void* stream) {
  if (mt <= 0 || nt <= 0 || kt <= 0 || (long long)mt * nt > 0x7fffffffLL ||
      splits != split_count(mt, nt, kt) || splits > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t cs = (cudaStream_t)stream;
  int rc = launch_transpose(b, b_occ, bt, kt, nt, cs);
  if (rc != 0) return rc;
  CUtensorMap ma, mb;
  rc = tensor_map(&ma, a, (long long)mt * kTile, (long long)kt * kTile);
  if (rc == 0) rc = tensor_map(&mb, bt, (long long)nt * kTile, (long long)kt * kTile);
  if (rc != 0) return rc;
  // the shared-memory attributes are set once per device (a bit each)
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !(configured >> dev & 1ull)) {
    err = cudaFuncSetAttribute(spgemm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(spgemm_wgmma_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) configured |= 1ull << dev;
  }
  spgemm_wgmma_kernel<<<dim3(mt * nt, splits), kThreads, kSmemBytes, cs>>>(
      ma, mb, (const int*)a_occ, (const int*)b_occ, (uint8_t*)out, (int*)out_occ, mt, nt, kt,
      splits);
  return (int)cudaGetLastError();
}

// What the loaded main kernel takes per CTA: info[0] registers a thread,
// info[1] dynamic shared memory bytes, info[2] local memory bytes a thread
// (stack and spills), info[3] threads, info[4] ring stages, info[5] CTAs
// an SM can hold.
extern "C" int spgemm_info(int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, spgemm_wgmma_kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(spgemm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, spgemm_wgmma_kernel, kThreads,
                                                      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  info[0] = attr.numRegs;
  info[1] = (int)kSmemBytes;
  info[2] = (int)attr.localSizeBytes;
  info[3] = kThreads;
  info[4] = kStages;
  info[5] = blocks;
  return 0;
}

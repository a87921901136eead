// Tile code shared by the port's attention kernels on Hopper (sm_90a):
//   * the mask and the exact dead-tile map (which tiles of the other side a
//     block's rows see at all, from positions and segments only);
//   * asynchronous copies into shared memory: bf16 tiles by the Tensor
//     Memory Accelerator (one thread issues a tile, an mbarrier reports its
//     bytes) into the 128-byte-swizzled layout wgmma reads; f32 rows and
//     the small per-tile vectors by 16- and 4-byte cp.async, f32 into a
//     padded layout the CUDA-core products read without bank conflicts;
//   * wgmma (bf16 in, f32 accumulators): shared-memory descriptors, the
//     instructions the kernels use, and the split of an f32 accumulator
//     fragment into a bf16 hi + lo pair that feeds the register-A form;
//   * register-tiled f32 products on the CUDA cores (float4 fragments).
//
// Layouts. A bf16 tile of ROWS rows x D columns is kept as D / 64 column
// blocks of ROWS x 128 bytes; line r of a block holds 64 elements and its
// 16-byte chunk c sits at chunk c ^ (r % 8) (the hardware's 128-byte
// swizzle, which needs every tile 1024-byte aligned). Read with rows as
// M or N and columns as K it is the K-major operand of wgmma (S = Q K^T);
// read with rows as K and columns as N it is the MN-major operand (O += P V,
// where V's rows are keys): the same bytes serve both.
#pragma once

#include <cuda.h>   // CUtensorMap (the encoder is reached through the runtime)

#include "common.cuh"

namespace repro {
namespace tiles {

__device__ __forceinline__ bool visible(int qp, int qg, int kp, int kg, int window) {
  bool a = kp <= qp && (kg == 0 || kg == qg);
  if (window > 0) a = a && (qp - kp) < window;
  return a;
}

// ---------------------------------------------------------------------------
// Dead-tile map
// ---------------------------------------------------------------------------

// Positions and segments of a block's own rows (in shared memory), with the
// ranges that let most dead entries of the other side be refused in a few
// compares before the exact scan.
struct Side {
  int n;                    // valid rows (a prefix of the tile)
  int pmin, pmax, gmin, gmax;
  bool zero;                // some row has segment 0
};

// The Side of n rows, each thread passing its own row (valid false for
// threads past the rows): warp shuffles, then the NT / 32 warps' parts
// through red (5 ints a warp). Ends with __syncthreads, so shared-memory
// writes made before the call are visible after it.
template <int NT>
__device__ __forceinline__ Side side_of_rows(int p, int g, bool valid, int n, int* red) {
  int v[5] = {valid ? p : 0x7fffffff, valid ? p : -0x7fffffff - 1, valid ? g : 0x7fffffff,
              valid ? g : -0x7fffffff - 1, valid && g == 0};
#pragma unroll
  for (int x = 16; x > 0; x >>= 1) {
    v[0] = min(v[0], __shfl_xor_sync(0xffffffffu, v[0], x));
    v[1] = max(v[1], __shfl_xor_sync(0xffffffffu, v[1], x));
    v[2] = min(v[2], __shfl_xor_sync(0xffffffffu, v[2], x));
    v[3] = max(v[3], __shfl_xor_sync(0xffffffffu, v[3], x));
    v[4] |= __shfl_xor_sync(0xffffffffu, v[4], x);
  }
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int e = 0; e < 5; ++e) red[5 * (threadIdx.x / 32) + e] = v[e];
  __syncthreads();
  Side s{n, 0x7fffffff, -0x7fffffff - 1, 0x7fffffff, -0x7fffffff - 1, false};
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    s.pmin = min(s.pmin, red[5 * w]);
    s.pmax = max(s.pmax, red[5 * w + 1]);
    s.gmin = min(s.gmin, red[5 * w + 2]);
    s.gmax = max(s.gmax, red[5 * w + 3]);
    s.zero = s.zero || red[5 * w + 4] != 0;
  }
  return s;
}

// A block's own rows (the first `rows` threads each take one): position
// and segment from global memory into p_s / g_s (fill_seg past n), and
// their Side. Every thread calls it; ends with __syncthreads.
template <int NT>
__device__ __forceinline__ Side own_rows(const int* pos, const int* seg, int n, int rows,
                                         int fill_seg, int* p_s, int* g_s, int* red) {
  const int i = threadIdx.x;
  const bool ok = i < n;
  const int p = ok ? pos[i] : 0, g = ok ? seg[i] : fill_seg;
  if (i < rows) {
    p_s[i] = p;
    g_s[i] = g;
  }
  return side_of_rows<NT>(p, g, ok, n, red);
}

// Does some query of `qs` (positions qp, segments qg) see key (kp, kg)?
__device__ __forceinline__ bool key_seen(int kp, int kg, const int* qp, const int* qg,
                                         const Side& qs, int window) {
  if (kp > qs.pmax) return false;
  if (kg != 0 && (kg < qs.gmin || kg > qs.gmax)) return false;
  if (window > 0 && qs.pmin - kp >= window) return false;
  for (int i = 0; i < qs.n; ++i)
    if (visible(qp[i], qg[i], kp, kg, window)) return true;
  return false;
}

// Does every query of `qs` see key (kp, kg)? (Rows past qs.n may be left
// unmasked: they are never written and feed no other row.)
__device__ __forceinline__ bool key_seen_by_all(int kp, int kg, const Side& qs, int window) {
  return kp <= qs.pmin && (kg == 0 || (qs.gmin == kg && qs.gmax == kg)) &&
         (window <= 0 || qs.pmax - kp < window);
}

// Does query (qp, qg) see some key of `ks` (positions kp, segments kg)?
__device__ __forceinline__ bool query_sees(int qp, int qg, const int* kp, const int* kg,
                                           const Side& ks, int window) {
  if (qp < ks.pmin) return false;
  if (!ks.zero && (qg < ks.gmin || qg > ks.gmax)) return false;
  if (window > 0 && qp - ks.pmax >= window) return false;
  for (int j = 0; j < ks.n; ++j)
    if (visible(qp, qg, kp[j], kg[j], window)) return true;
  return false;
}

// Does query (qp, qg) see every key of `ks`? (A sufficient test: a tile it
// refuses is masked element by element, which is exact anyway. Keys past
// ks.n may be left unmasked: they are never written and feed no other row.)
__device__ __forceinline__ bool query_sees_all(int qp, int qg, const Side& ks, int window) {
  return qp >= ks.pmax &&
         ((ks.gmin == 0 && ks.gmax == 0) || (ks.gmin == qg && ks.gmax == qg)) &&
         (window <= 0 || qp - ks.pmin < window);
}

enum : uint8_t { DEAD = 0, LIVE = 1, FULL = 2 };

// The block's map of the other side's tiles (TILE consecutive entries of
// n, positions pos and segments seg in global memory): map[t] = DEAD if no
// pair of the block's rows and tile t is visible, FULL if every pair with
// an in-range entry is (the tile needs no mask), else LIVE. Every thread
// of the block (NT) calls it; map needs 2 * ceil(n / TILE) bytes. A warp's
// 32 entries lie in one tile, so ballots mark it: plain stores, no
// atomics. The loads of the first U entries a thread go out before
// setup() (which reads the block's own rows and ends with __syncthreads)
// runs, so setup and the scan share their memory latency.
template <int TILE, int NT, typename Setup, typename Seen, typename All>
__device__ __forceinline__ void map_tiles(int n, const int* pos, const int* seg, Setup setup,
                                          Seen seen, All all, uint8_t* map) {
  static_assert(TILE % 32 == 0 && NT % 32 == 0, "a warp's entries must share a tile");
  constexpr int U = 4;
  const int ntiles = (n + TILE - 1) / TILE;
  uint8_t* partial = map + ntiles;           // some entry is not seen by every row
  int p[U], g[U];
  auto load = [&](int base) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * NT + (int)threadIdx.x;
      p[u] = j < n ? pos[j] : 0;
      g[u] = j < n ? seg[j] : 0;
    }
  };
  load(0);
  for (int t = threadIdx.x; t < 2 * ntiles; t += NT) map[t] = DEAD;
  setup();
  for (int base = 0; base < n; base += NT * U) {
    if (base > 0) load(base);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * NT + (int)threadIdx.x;
      const bool a = j < n && seen(p[u], g[u]);
      const bool f = j < n && all(p[u], g[u]);
      const unsigned any = __ballot_sync(0xffffffffu, a);
      const unsigned every = __ballot_sync(0xffffffffu, f);
      const int t = (base + u * NT + (int)(threadIdx.x & ~31u)) / TILE;
      if ((threadIdx.x & 31) == 0 && t < ntiles) {
        if (any != 0u) map[t] = LIVE;
        if (every != 0xffffffffu) partial[t] = 1;
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < ntiles; t += NT)
    if (map[t] == LIVE && !partial[t]) map[t] = FULL;
  __syncthreads();
}

// The first live tile after t (ntiles if none); the same for every thread.
__device__ __forceinline__ int next_live(const uint8_t* map, int t, int ntiles) {
  for (++t; t < ntiles && map[t] == DEAD; ++t) {}
  return t;
}

// ---------------------------------------------------------------------------
// Asynchronous copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; with valid false nothing is read and the
// 16 bytes are zero-filled (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Makes this thread's completed shared-memory writes visible to wgmma (the
// async proxy); the __syncthreads after it publishes every thread's.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk `chunk` of row r in a swizzled bf16 tile of
// `rows` rows (see the layout note at the top).
__device__ __forceinline__ uint32_t sw128(int rows, int r, int chunk) {
  return (uint32_t)((chunk >> 3) * rows * 128 + r * 128 + (((chunk & 7) ^ (r & 7)) << 4));
}

// Copy ROWS rows of D bf16 into the swizzled tile at shared address dst;
// row_ptr(r) is row r's first element or nullptr (zero-filled row).
template <int D, int ROWS, int NT, typename RowPtr>
__device__ __forceinline__ void stage_bf16(uint32_t dst, RowPtr row_ptr, const void* any) {
  constexpr int CPR = D / 8;
  static_assert((ROWS * CPR) % NT == 0, "tile does not split evenly");
#pragma unroll
  for (int u = 0; u < ROWS * CPR / NT; ++u) {
    const int i = threadIdx.x + u * NT, r = i / CPR, c = i % CPR;
    const __nv_bfloat16* p = row_ptr(r);
    cp_async16(dst + sw128(ROWS, r, c), p ? (const void*)(p + c * 8) : any, p != nullptr);
  }
}

// Copy ROWS rows of D f32 into a tile with row stride D + 4 floats.
template <int D, int ROWS, int NT, typename RowPtr>
__device__ __forceinline__ void stage_f32(uint32_t dst, RowPtr row_ptr, const void* any) {
  constexpr int CPR = D / 4;
  static_assert((ROWS * CPR) % NT == 0, "tile does not split evenly");
#pragma unroll
  for (int u = 0; u < ROWS * CPR / NT; ++u) {
    const int i = threadIdx.x + u * NT, r = i / CPR, c = i % CPR;
    const float* p = row_ptr(r);
    cp_async16(dst + (uint32_t)((r * (D + 4) + c * 4) * 4), p ? (const void*)(p + c * 4) : any,
               p != nullptr);
  }
}

// A (B, S, heads, D) tensor's rows s0 .. s0 + n - 1 of batch row b and head
// h, as the row_ptr the staging functions take (nullptr past n).
template <typename T, int D>
__device__ __forceinline__ auto head_rows(const void* base, int b, int s0, int n, int S,
                                          int heads, int h) {
  const T* p = static_cast<const T*>(base);
  return [=](int r) -> const T* {
    return r < n ? p + (((size_t)b * S + s0 + r) * heads + h) * D : nullptr;
  };
}

// Copy n (<= NT) ints or floats; entries past `valid` get `fill` by a plain
// store (no read past the end of the tensor).
template <typename V>
__device__ __forceinline__ void stage_meta(V* dst, const V* src, int n, int valid, V fill) {
  const int i = threadIdx.x;
  if (i < n) {
    if (i < valid) cp_async4(smem_u32(dst + i), src + i);
    else dst[i] = fill;
  }
}

// Positions and segments of KV tile t (BK keys from t * BK) of batch row b;
// keys past Skv get INVALID_POS and segment -2.
template <int BK>
__device__ __forceinline__ void stage_kv_meta(const int* kvpos, const int* kvseg, int Skv,
                                              int b, int t, int* kp_s, int* kg_s) {
  const int k0 = t * BK, nk = min(BK, Skv - k0);
  stage_meta(kp_s, kvpos + (size_t)b * Skv + k0, BK, nk, INVALID_POS);
  stage_meta(kg_s, kvseg + (size_t)b * Skv + k0, BK, nk, -2);
}

// The f32 kernels' KV tile t of KV head hk: K and V rows by cp.async into
// padded tiles at kdst / vdst (keys past Skv: zero rows), and its metadata.
template <int D, int BK, int NT>
__device__ __forceinline__ void stage_kv_f32(const void* k, const void* v, const int* kvpos,
                                             const int* kvseg, int Skv, int Hkv, int b, int hk,
                                             int t, uint32_t kdst, uint32_t vdst, int* kp_s,
                                             int* kg_s) {
  const int k0 = t * BK, nk = min(BK, Skv - k0);
  stage_f32<D, BK, NT>(kdst, head_rows<float, D>(k, b, k0, nk, Skv, Hkv, hk), k);
  stage_f32<D, BK, NT>(vdst, head_rows<float, D>(v, b, k0, nk, Skv, Hkv, hk), v);
  stage_kv_meta<BK>(kvpos, kvseg, Skv, b, t, kp_s, kg_s);
}

// ---------------------------------------------------------------------------
// TMA and mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Orders the mbarrier inits before their use by other threads and by the
// TMA unit (a __syncthreads must follow).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The one arrival a stage's barrier expects, announcing `bytes` to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// A ROWS x D bf16 tile of a (B, S, heads, D) tensor (rows s0 .., head h,
// batch row b) into the swizzled layout at dst: D / 64 boxes of ROWS x 64,
// rows past S zero-filled by the hardware. One thread issues it; the bytes
// land on bar.
template <int D, int ROWS>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                         int s0, int h, int b) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(dst + (uint32_t)(cb * ROWS * 128)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_u32(bar)), "r"(cb * 64), "r"(h), "r"(s0), "r"(b)
        : "memory");
}

// The tensor map of a contiguous (B, S, heads, D) bf16 tensor read in boxes
// of `rows` rows x 64 columns of one head, 128-byte swizzled (host code;
// cuTensorMapEncodeTiled is looked up through the CUDA runtime, so the
// libraries link no libcuda).
inline cudaError_t head_map(CUtensorMap* map, const void* base, int B, int S, int heads, int D,
                            int rows) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1}, unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand at shared address addr; lbo and
// sbo in bytes. K-major (rows of 128 bytes along K): sbo = 1024, the stride
// of 8-row groups; lbo unused. MN-major (rows are K, 64 MN elements per
// line): lbo = the stride of 64-wide MN blocks, sbo = 1024, the stride of
// 8-row K groups.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

// K step kk (16 elements) of a K-major swizzled tile of `rows` rows.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int kk) {
  return desc_sw128(tile + (uint32_t)((kk >> 2) * rows * 128 + (kk & 3) * 32), 16, 1024);
}

// K step kk (16 rows) of an MN-major swizzled tile of `rows` rows.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int kk) {
  return desc_sw128(tile + (uint32_t)(kk * 16 * 128), (uint32_t)(rows * 128), 1024);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// 2^x on the special-function unit (relative error about 2^-22; results
// below 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Pins registers that an asynchronous wgmma reads or writes: no access to
// them moves across this point (put after wg_wait, before the next reads).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e]) :: "memory");
}

// D (64 x 64, f32) (+)= A (64 x 16, smem) * B (16 x 64, smem), both K-major;
// scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x D) += A (64 x 16 registers) * B (MN-major smem) for D 64 or 128.
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 128) wgmma_rs_m64n128k16(d, a, db);
  else wgmma_rs_m64n64k16(d, a, db);
}

// S (64 x 64) = A (64 x D) * B^T, A and B K-major swizzled tiles of 64 rows
// (A: the first 64 rows of a tile of a_rows).
template <int D>
__device__ __forceinline__ void wgmma_scores(float (&s)[32], uint32_t a, uint32_t b, int a_rows = 64) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_m64n64k16(s, desc_k(a, a_rows, kk), desc_k(b, 64, kk), kk > 0);
}

// Fragment layout of a 64 x N f32 accumulator (N / 2 registers a thread):
// register i holds row 16 * warp + lane / 4 + 8 * ((i / 2) & 1) and column
// 8 * (i / 4) + 2 * (lane % 4) + i % 2. Registers 8 kk .. 8 kk + 7 hold
// columns 16 kk .. 16 kk + 15 exactly as the register-A operand of a k16
// step wants them, so a score tile turns into the A operand of the next
// product with no data movement.
__device__ __forceinline__ int frag_row(int i) { return 16 * (threadIdx.x / 32 % 4) + (threadIdx.x & 31) / 4 + 8 * ((i >> 1) & 1); }
__device__ __forceinline__ int frag_col(int i) { return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1); }

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);   // .x = first column
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Split p (32 f32, a 64 x 64 fragment) into bf16 hi = rn(p) and lo =
// rn(p - hi): hi + lo carries p to about 2^-16 of its value, where hi alone
// would carry 2^-8 and break the bf16 tolerance (tests/test_torch_kernels.py
// shows both).
__device__ __forceinline__ void split_hi_lo(const float (&p)[32], uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float a = p[8 * kk + 2 * e], b = p[8 * kk + 2 * e + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      hi[kk][e] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][e] = pack_bf16(a - __low2float(h), b - __high2float(h));
    }
}

// One 64 x 64 score tile of a warpgroup through the online softmax, in
// log2 units: raw scores s in, exp2 probabilities out (masked pairs exactly
// 0); the maxima and sums of the thread's two fragment rows (m0, l0 and m1,
// l1 of rows frag_row(0) and frag_row(0) + 8) updated, and the accumulator
// o rescaled where some row's max moved. ok(c, hi) says whether the row
// (hi: the second) sees column c; a full tile (every pair visible) skips it.
template <int D, typename Visible>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&o)[D / 2], bool full,
                                             Visible ok, float sl2, float& m0, float& m1,
                                             float& l0, float& l1) {
  uint32_t allow = 0xffffffffu;
  float mx0 = NEG_INF, mx1 = NEG_INF;
  if (full) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if ((i >> 1) & 1) mx1 = fmaxf(mx1, s[i]);
      else mx0 = fmaxf(mx0, s[i]);
    }
  } else {
    allow = 0u;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool hi_row = (i >> 1) & 1;
      const bool v = ok(frag_col(i), hi_row);
      allow |= (uint32_t)v << i;
      if (v && hi_row) mx1 = fmaxf(mx1, s[i]);
      if (v && !hi_row) mx0 = fmaxf(mx0, s[i]);
    }
  }
  // a row's 64 scores sit in the 4 adjacent lanes of one quad
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
  }
  // raw scores: the max commutes with the positive scale, which goes into
  // one FFMA per element with the exponent; a row with no visible key in
  // this tile keeps its max (NEG_INF stays NEG_INF: no scale applied)
  const float mn0 = mx0 == NEG_INF ? m0 : fmaxf(m0, mx0 * sl2);
  const float mn1 = mx1 == NEG_INF ? m1 : fmaxf(m1, mx1 * sl2);
  const float c0 = ex2(m0 - mn0), c1 = ex2(m1 - mn1);
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const bool hi_row = (i >> 1) & 1;
    const float p = (allow >> i) & 1u ? ex2(fmaf(s[i], sl2, -(hi_row ? mn1 : mn0))) : 0.f;
    s[i] = p;
    if (hi_row) sum1 += p;
    else sum0 += p;
  }
  l0 = l0 * c0 + sum0;             // this thread's part of the row sums
  l1 = l1 * c1 + sum1;
  m0 = mn0;
  m1 = mn1;
  if (__any_sync(0xffffffffu, c0 != 1.f || c1 != 1.f)) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= ((i >> 1) & 1) ? c1 : c0;
  }
}

// O (64 x D) += P V on the tensor cores, P (a 64 x 64 fragment of
// probabilities) fed as a bf16 hi + lo pair, V a swizzled tile of 64 key
// rows read MN-major; returns once the products are done.
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const float (&p)[32], uint32_t vt) {
  uint32_t hi[4][4], lo[4][4];
  split_hi_lo(p, hi, lo);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(o, hi[kk], desc_mn(vt, 64, kk));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(o, lo[kk], desc_mn(vt, 64, kk));
  wg_commit();
  wg_wait<0>();
  fence_regs(o);
  fence_regs(hi);
  fence_regs(lo);
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores: F_NT = 128 threads; thread (ty = tid / 8, tx =
// tid % 8) owns rows ty + 16 i (i < 4) of a 64-row tile, columns tx + 8 j
// (j < 4) of a 64 x 32 score tile and head-dim columns 4 tx + 32 m + e
// (e < 4) of a 64 x D output. Tiles have row stride D + 4 floats (score
// tiles 32 + 4), so every float4 load of a warp hits distinct banks. (256
// threads with 2 rows each measured slower on the H100 in every case.)
// ---------------------------------------------------------------------------

constexpr int F_COLS = 32, F_NT = 128, F_NI = 4, F_RS = 16, F_PLD = F_COLS + 4;

// acc[i][j] += sum_d A[ty + 16 i][d] * B[tx + 8 j][d]
template <int D>
__device__ __forceinline__ void f32_nt(const float* A, const float* B, float (&acc)[F_NI][4]) {
  constexpr int LD = D + 4;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[F_NI], b[4];
#pragma unroll
    for (int i = 0; i < F_NI; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ty + F_RS * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(B + (tx + 8 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < F_NI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// acc[i][4 m + e] += sum_c P[ty + 16 i][c] * V[c][4 tx + 32 m + e], c < 32;
// P has row stride F_PLD, V row stride D + 4.
template <int D>
__device__ __forceinline__ void f32_nn(const float* P, const float* V, float (&acc)[F_NI][D / 8]) {
  constexpr int LD = D + 4;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
#pragma unroll 2
  for (int c = 0; c < F_COLS; c += 4) {
    float4 p[F_NI];
#pragma unroll
    for (int i = 0; i < F_NI; ++i) p[i] = *reinterpret_cast<const float4*>(P + (ty + F_RS * i) * F_PLD + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int m = 0; m < D / 32; ++m) {
        const float4 v = *reinterpret_cast<const float4*>(V + (c + cc) * LD + 4 * tx + 32 * m);
#pragma unroll
        for (int i = 0; i < F_NI; ++i) {
          const float pc = cc == 0 ? p[i].x : cc == 1 ? p[i].y : cc == 2 ? p[i].z : p[i].w;
          acc[i][4 * m] = fmaf(pc, v.x, acc[i][4 * m]);
          acc[i][4 * m + 1] = fmaf(pc, v.y, acc[i][4 * m + 1]);
          acc[i][4 * m + 2] = fmaf(pc, v.z, acc[i][4 * m + 2]);
          acc[i][4 * m + 3] = fmaf(pc, v.w, acc[i][4 * m + 3]);
        }
      }
    }
  }
}

// One 64 x 32 score tile (f32_nt's layout) through the online softmax, in
// natural units: each row's max and sum (m, l) updated, its accumulator o
// rescaled, and the probabilities written to ps (row stride F_PLD; masked
// pairs exactly 0). ok(i, c) says whether the thread's row i sees column c;
// a full tile skips it. The caller syncs the warp before reading ps. (Read
// `full` before the score product: read after it, ptxas gave the SPA
// forward at D 128 168 registers instead of 254 and it ran 8 % slower on
// the H100.)
template <int D, typename Visible>
__device__ __forceinline__ void softmax_tile_f32(float (&s)[F_NI][4], float (&o)[F_NI][D / 8],
                                                 float* ps, bool full, Visible ok, float scale,
                                                 float (&m)[F_NI], float (&l)[F_NI]) {
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < F_NI; ++i) {
    bool v[4];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = full || ok(i, tx + 8 * j);
      s[i][j] = v[j] ? s[i][j] * scale : NEG_INF;
      mx = fmaxf(mx, s[i][j]);
    }
    // a row's 32 scores sit in 8 adjacent lanes
#pragma unroll
    for (int x = 1; x <= 4; x <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
    const float mn = fmaxf(m[i], mx), corr = expf(m[i] - mn);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = v[j] ? expf(s[i][j] - mn) : 0.f;
      ps[(ty + F_RS * i) * F_PLD + tx + 8 * j] = p;
      sum += p;
    }
    l[i] = l[i] * corr + sum;
    m[i] = mn;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) o[i][c] *= corr;
  }
}

// 1024-byte-aligned start of a kernel's dynamic shared memory (the launch
// asks for 1024 bytes more than the layout needs).
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

}  // namespace tiles
}  // namespace repro

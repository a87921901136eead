// Helpers shared by the port's attention kernels: f32 <-> storage type
// conversion and 16-byte staging of row tiles into shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr float NEG_INF = -1e30f;       // finite: a fully masked tile stays finite
constexpr int INVALID_POS = 1 << 30;    // pos of unwritten / padding slots

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);   // round to nearest even, once, at the output
}

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);      // exact
}

// One 16-byte vector of T (4 f32 or 8 bf16) unpacked to f32; bf16 -> f32 is
// exact (the bf16 bits are the top half of the f32).
template <typename T> __device__ __forceinline__ void unpack16(const uint4& r, float* dst);
template <> __device__ __forceinline__ void unpack16<float>(const uint4& r, float* dst) {
  dst[0] = __uint_as_float(r.x);
  dst[1] = __uint_as_float(r.y);
  dst[2] = __uint_as_float(r.z);
  dst[3] = __uint_as_float(r.w);
}
template <> __device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& r, float* dst) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    dst[2 * e] = __uint_as_float(w[e] << 16);
    dst[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}

// Stage ROWS rows of D elements of T into a shared f32 tile (row stride ld)
// with 16-byte loads, up to 4 per thread in flight before any is stored, so
// a tile costs a few memory latencies, not one per row. row_ptr(r) gives
// row r's first element (16-byte aligned), or nullptr for a row of zeros.
template <typename T, int D, int ROWS, int NT, typename RowPtr>
__device__ __forceinline__ void stage_rows(RowPtr row_ptr, float* dst, int ld) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  static_assert(D % VEC == 0 && (ROWS * VPR) % NT == 0, "tile does not split evenly");
  constexpr int NV = ROWS * VPR / NT;
  constexpr int BATCH = NV < 4 ? NV : 4;
  static_assert(NV % BATCH == 0, "tile does not split evenly");
#pragma unroll
  for (int b0 = 0; b0 < NV; b0 += BATCH) {
    uint4 r[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = threadIdx.x + (b0 + u) * NT;
      const T* p = row_ptr(i / VPR);
      r[u] = p ? __ldg(reinterpret_cast<const uint4*>(p + (i % VPR) * VEC))
               : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = threadIdx.x + (b0 + u) * NT;
      unpack16<T>(r[u], dst + (i / VPR) * ld + (i % VPR) * VEC);
    }
  }
}

}  // namespace repro

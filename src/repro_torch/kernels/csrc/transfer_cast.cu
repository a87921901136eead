// Fused cast+copy of one weight-plane leaf: f32 -> bf16 (or f16), one pass.
//
// Replaces the Pallas TPU kernel `transfer_cast` of
// src/repro/kernels/transfer_cast.py (body `_cast_kernel`, call `_cast_call`):
// the weight-plane streams an f32-mastered parameter tree to the rollout
// pool as a bf16 payload, and the cast IS the copy into the wire buffer.
// Rounding is round to nearest even (__float2bfloat16_rn / __float2half_rn),
// bitwise equal to PyTorch's `x.to(dtype)` on every finite value, +-0 and
// +-Inf; a NaN stays a NaN.
//
// What bounds it on an H100: bytes. It reads 4 and writes 2 bytes per
// element and does one conversion each, so the bound is 6 bytes per element
// over 3.35 TB/s. What the design does about it: each thread moves 8
// elements per step with two 16-byte loads and one 16-byte store, in a
// grid-stride loop; any element count is taken as it is (the TPU version's
// zero-padded lane grid is a TPU layout artifact): the tail of fewer than 8
// elements, and a whole leaf whose pointers are not 16-byte aligned, take
// the scalar path.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

template <typename T> __device__ __forceinline__ T cast_rn(float x);
template <> __device__ __forceinline__ __nv_bfloat16 cast_rn<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half cast_rn<__half>(float x) {
  return __float2half_rn(x);
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const T lo = cast_rn<T>(a), hi = cast_rn<T>(b);
  return (uint32_t)(*reinterpret_cast<const uint16_t*>(&lo)) |
         ((uint32_t)(*reinterpret_cast<const uint16_t*>(&hi)) << 16);
}

// n8 groups of 8 elements: two float4 loads, one uint4 store each
template <typename T>
__global__ void __launch_bounds__(NT)
cast_vec8(const float4* __restrict__ src, uint4* __restrict__ dst, size_t n8) {
  for (size_t i = (size_t)blockIdx.x * NT + threadIdx.x; i < n8;
       i += (size_t)gridDim.x * NT) {
    const float4 a = __ldg(src + 2 * i);
    const float4 b = __ldg(src + 2 * i + 1);
    dst[i] = make_uint4(pack2<T>(a.x, a.y), pack2<T>(a.z, a.w),
                        pack2<T>(b.x, b.y), pack2<T>(b.z, b.w));
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
cast_scalar(const float* __restrict__ src, T* __restrict__ dst, size_t n) {
  for (size_t i = (size_t)blockIdx.x * NT + threadIdx.x; i < n;
       i += (size_t)gridDim.x * NT)
    dst[i] = cast_rn<T>(src[i]);
}

unsigned grid_for(size_t work) {
  // enough blocks to fill 132 SMs several times over; the loop strides the rest
  const size_t want = (work + NT - 1) / NT;
  return (unsigned)(want < 132 * 16 ? (want ? want : 1) : 132 * 16);
}

template <typename T>
cudaError_t launch(const float* src, T* dst, size_t n, cudaStream_t stream) {
  size_t done = 0;
  const bool aligned = (reinterpret_cast<uintptr_t>(src) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(dst) % 16 == 0);
  if (aligned && n >= 8) {
    const size_t n8 = n / 8;
    cast_vec8<T><<<grid_for(n8), NT, 0, stream>>>(
        reinterpret_cast<const float4*>(src), reinterpret_cast<uint4*>(dst), n8);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    done = n8 * 8;
  }
  if (done < n) {
    cast_scalar<T><<<grid_for(n - done), NT, 0, stream>>>(src + done, dst + done,
                                                         n - done);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dst_dtype: 1 = bfloat16, 2 = float16 (the source is float32).
int transfer_cast_launch(const void* src, void* dst, long long n, int dst_dtype,
                         void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(src);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dst_dtype == 1) return launch(s, static_cast<__nv_bfloat16*>(dst), (size_t)n, st);
  if (dst_dtype == 2) return launch(s, static_cast<__half*>(dst), (size_t)n, st);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

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
// over 3.35 TB/s. What the design does about it: one 16-byte load and one
// 8-byte store per thread, a warp's loads and stores each one contiguous
// run (512 and 256 bytes), and one block of 128 threads per 512 elements
// with no grid-stride loop, so the whole leaf is requested at once and the
// card's block scheduler keeps every SM full to the last wave. Timed on the
// H100 against variants of this kernel, each leaf of the training tree
// beside x.to in turns, none was faster: more loads in flight per thread
// (2 to 16 float4s), L1-bypassing loads and streaming stores
// (ld.global.nc.L1::no_allocate, st.global.cs), a grid of whole waves of
// resident blocks walking the leaf in a grid-stride loop, 16-byte stores
// (lane pairs swapping halves).
// Any element count is taken as it is (the TPU version's zero-padded lane
// grid is a TPU layout artifact): the elements after the last whole float4
// are cast by block 0's first threads in the same launch; a leaf whose
// storage is not 16-byte aligned takes the scalar kernel.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;   // threads per block: one float4 each

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

// float4 i of the leaf per thread; block 0's first threads also cast the
// tail [4 * n4, n) one by one.
template <typename T>
__global__ void __launch_bounds__(NT)
cast_vec(const float4* __restrict__ src, uint2* __restrict__ dst, size_t n, size_t n4) {
  const int tid = threadIdx.x;
  if (blockIdx.x == 0 && 4 * n4 + tid < n) {
    const size_t i = 4 * n4 + tid;
    reinterpret_cast<T*>(dst)[i] = cast_rn<T>(reinterpret_cast<const float*>(src)[i]);
  }
  const size_t i = (size_t)blockIdx.x * NT + tid;
  if (i < n4) {
    const float4 x = src[i];
    dst[i] = make_uint2(pack2<T>(x.x, x.y), pack2<T>(x.z, x.w));
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
cast_scalar(const float* __restrict__ src, T* __restrict__ dst, size_t n) {
  const size_t i = (size_t)blockIdx.x * NT + threadIdx.x;
  if (i < n) dst[i] = cast_rn<T>(src[i]);
}

template <typename T>
cudaError_t launch(const float* src, T* dst, size_t n, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && reinterpret_cast<uintptr_t>(dst) % 8 == 0) {
    const size_t n4 = n / 4;
    const size_t blocks = (n4 + NT - 1) / NT;
    cast_vec<T><<<(unsigned)(blocks ? blocks : 1), NT, 0, stream>>>(
        reinterpret_cast<const float4*>(src), reinterpret_cast<uint2*>(dst), n, n4);
  } else {
    cast_scalar<T><<<(unsigned)((n + NT - 1) / NT), NT, 0, stream>>>(src, dst, n);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dst_dtype: 1 = bfloat16, 2 = float16 (the source is float32).
int transfer_cast_launch(const void* src, void* dst, long long n, int dst_dtype,
                         void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
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

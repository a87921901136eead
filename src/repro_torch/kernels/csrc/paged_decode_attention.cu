// Flash decode over a paged KV pool: one new query token per row.
//
// Replaces the Pallas TPU kernel `paged_decode_attention` in
// src/repro/kernels/decode_attention.py:242 (`_gather_pages` ->
// `decode_attention` -> `_flash_rows` -> body `_kernel`); the contiguous
// `decode_attention` (:119) launches it through a one-page-per-row view.
// Mask: kv_pos <= q_pos [&& q_pos - kv_pos < window]; null page 0 and every
// unwritten slot carry pos 2^30, so they are masked for any live row.
//
// What bounds it on an H100: decode attention does 4 * D flops per
// (query, key) pair and reads 2 * D values per key, so it is bound by the
// bytes of K/V it reads. It is the verify block's Split-L kernel
// (splitl.cuh) with S = 1: the context is split over blocks so that B * Hkv
// (32 at the serving batch) becomes hundreds of blocks, each block reads a
// K/V row once for all G query heads of its KV head (any G: groups of 16
// heads past 16), keys no query sees are never read, and each warp keeps
// its next steps' K/V rows in flight through its own cp.async ring. The
// page table is walked inside the kernel, so nothing gathers the
// (B, L, Hkv, D) context first (the JAX wrapper's `_gather_pages` did).
#include "splitl.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. window <= 0: no window. splits >= 1
// runs of ks keys each (a multiple of 32, covering n_max * page); above 1
// split, part_acc (splits, B*H, D) and part_ml (splits, B*H, 2) are f32
// scratch the wrapper allocated.
int paged_decode_attention_launch(const void* q, const void* k_pages, const void* v_pages,
                                  const void* pos_pages, const void* page_table,
                                  const void* q_pos, void* out, void* part_acc, void* part_ml,
                                  int B, int H, int Hkv, int D, int page, int n_max, int dtype,
                                  int window, int splits, int ks, float scale, void* stream) {
  using namespace repro::splitl;
  const Args a{q, k_pages, v_pages,
               static_cast<const int*>(pos_pages), static_cast<const int*>(page_table),
               static_cast<const int*>(q_pos), out,
               static_cast<float*>(part_acc), static_cast<float*>(part_ml),
               B, 1, H, Hkv, page, n_max, window, splits, ks, scale * LOG2E};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch<float, 64>(a, st);
  if (dtype == 0 && D == 128) return launch<float, 128>(a, st);
  if (dtype == 1 && D == 64) return launch<__nv_bfloat16, 64>(a, st);
  if (dtype == 1 && D == 128) return launch<__nv_bfloat16, 128>(a, st);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Flash decode over a paged KV pool: one new query token per row.
//
// Replaces the Pallas TPU kernel `paged_decode_attention` in
// src/repro/kernels/decode_attention.py (`_gather_pages` -> `decode_attention`
// -> `_flash_rows` -> body `_kernel`). Mask: kv_pos <= q_pos
// [&& q_pos - kv_pos < window]; null page 0 and every unwritten slot carry
// pos 2^30, so they are masked for any live row.
//
// What bounds it on an H100: decode attention does 4 * D flops per
// (query, key) pair and reads 2 * D values per key, so it is bound by the
// bytes of K/V it reads. What the design does about that:
//   * the page table is walked inside the kernel: each key's page id comes
//     from the row's table, so nothing gathers the (B, L, Hkv, D) context
//     into memory first (the JAX wrapper's `_gather_pages` did, every step);
//   * one block per (KV head, row) handles that head's G query heads
//     together, so each K/V row is read once for all G queries, staged
//     with 16-byte loads, several in flight per thread;
//   * keys are walked in chunks of 64; a chunk's positions are read first
//     and its K/V only if some key of it is visible, and a masked key's K/V
//     is never read — the null-page tail of a short row costs no K/V bytes.
// Splitting the context across blocks (for long contexts at small batch,
// where B * Hkv blocks leave SMs idle) is later work.
#include "common.cuh"

namespace {

using repro::INVALID_POS;
using repro::NEG_INF;

constexpr int CK = 64;     // keys per chunk
constexpr int NT = 128;    // threads
constexpr int GMAX = 8;    // query heads per KV head

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (GMAX * D + CK * (D + 1) + CK * D + GMAX * CK + 3 * GMAX) +
         sizeof(int) * (2 * CK);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ pos_pages,
                    const int* __restrict__ page_table, const int* __restrict__ q_pos,
                    T* __restrict__ out, int H, int Hkv, int page, int n_max,
                    int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                   // G x D
  float* ks = qs + GMAX * D;          // CK x (D+1), padded: no bank conflicts
  float* vs = ks + CK * (D + 1);      // CK x D
  float* ps = vs + CK * D;            // G x CK scores, then probabilities
  float* m_s = ps + GMAX * CK;        // running max per query head
  float* l_s = m_s + GMAX;            // running sum
  float* c_s = l_s + GMAX;            // this chunk's rescale factor
  int* slot_s = reinterpret_cast<int*>(c_s + GMAX);  // flat pool slot per key
  int* ok_s = slot_s + CK;                           // key visible

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int G = H / Hkv;
  const int L = n_max * page;
  const int qp = q_pos[b];
  const int* table = page_table + (size_t)b * n_max;

  for (int i = tid; i < G * D; i += NT)
    qs[i] = static_cast<float>(q[((size_t)b * H + hk * G) * D + i]);
  for (int g = tid; g < G; g += NT) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  constexpr int NPAIR = GMAX * D / NT;   // (query head, column) pairs per thread
  float acc[NPAIR];
#pragma unroll
  for (int j = 0; j < NPAIR; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < L; c0 += CK) {
    bool any = false;
    for (int c = tid; c < CK; c += NT) {
      const int j = c0 + c;
      int slot = 0, kp = INVALID_POS;
      if (j < L) {
        slot = table[j / page] * page + j % page;
        kp = pos_pages[slot];
      }
      bool a = j < L && kp <= qp;
      if (window > 0) a = a && (qp - kp) < window;
      slot_s[c] = slot;
      ok_s[c] = a;
      any = any || a;
    }
    if (!__syncthreads_or(any)) continue;   // no key of this chunk is visible

    // masked keys are never read (their probability is exactly 0)
    const auto page_row = [&](const T* pool, int c) -> const T* {
      return ok_s[c] ? pool + ((size_t)slot_s[c] * Hkv + hk) * D : nullptr;
    };
    repro::stage_rows<T, D, CK, NT>([&](int c) { return page_row(k_pages, c); },
                                    ks, D + 1);
    repro::stage_rows<T, D, CK, NT>([&](int c) { return page_row(v_pages, c); },
                                    vs, D);
    __syncthreads();

    for (int i = tid; i < G * CK; i += NT) {
      const int g = i / CK, c = i % CK;
      float s = NEG_INF;
      if (ok_s[c]) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += qs[g * D + d] * ks[c * (D + 1) + d];
        s = dot * scale;
      }
      ps[g * CK + c] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += NT / 32) {   // one warp per query head
      const float s0 = ps[g * CK + lane], s1 = ps[g * CK + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = ok_s[lane] ? expf(s0 - m_new) : 0.f;
      const float p1 = ok_s[lane + 32] ? expf(s1 - m_new) : 0.f;
      ps[g * CK + lane] = p0;
      ps[g * CK + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < NPAIR; ++j) {
      const int idx = tid + j * NT;
      if (idx < G * D) {
        const int g = idx / D, d = idx % D;
        float a = acc[j] * c_s[g];
        for (int c = 0; c < CK; ++c) a += ps[g * CK + c] * vs[c * D + d];
        acc[j] = a;
      }
    }
    __syncthreads();   // before the next chunk overwrites ks/vs/ps
  }

#pragma unroll
  for (int j = 0; j < NPAIR; ++j) {
    const int idx = tid + j * NT;
    if (idx < G * D) {
      const int g = idx / D;
      out[((size_t)b * H + hk * G) * D + idx] = repro::from_f<T>(acc[j] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* pos_pages, const int* page_table, const int* q_pos,
                   void* out, int B, int H, int Hkv, int page, int n_max, int window,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B);
  paged_decode_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), pos_pages, page_table, q_pos,
      static_cast<T*>(out), H, Hkv, page, n_max, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. window <= 0: no window.
int paged_decode_attention_launch(const void* q, const void* k_pages,
                                  const void* v_pages, const void* pos_pages,
                                  const void* page_table, const void* q_pos,
                                  void* out, int B, int H, int Hkv, int D, int page,
                                  int n_max, int dtype, int window, float scale,
                                  void* stream) {
  if (H % Hkv != 0 || H / Hkv > GMAX) return cudaErrorInvalidValue;
  const int* pp = static_cast<const int*>(pos_pages);
  const int* pt = static_cast<const int*>(page_table);
  const int* qp = static_cast<const int*>(q_pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k_pages, v_pages, pp, pt, qp, out, B, H, Hkv, page, n_max, window, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k_pages, v_pages, pp, pt, qp, out, B, H, Hkv, page, n_max, window, scale, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k_pages, v_pages, pp, pt, qp, out, B, H, Hkv, page, n_max, window, scale, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k_pages, v_pages, pp, pt, qp, out, B, H, Hkv, page, n_max, window, scale, st);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

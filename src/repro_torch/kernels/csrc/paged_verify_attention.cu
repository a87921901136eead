// Flash attention of S query tokens per row over a paged KV pool, each token
// masked by its own position: the spec-decode verify block (S = k+1) and the
// radix cache's warm suffix prefill (S = the bucketed suffix).
//
// Replaces the Pallas TPU kernel `paged_verify_attention` in
// src/repro/kernels/decode_attention.py (`_gather_pages` -> `verify_attention`
// -> `_flash_rows` -> body `_kernel`). Rows are flattened as the JAX kernel
// flattens them: R = S * G query rows per (row, KV head), s-major and
// g-minor, so query row r is token s = r / G of query head hk * G + r % G
// and carries that token's position. Mask: kv_pos <= q_pos
// [&& q_pos - kv_pos < window]; the null page 0 and every unwritten slot
// carry pos 2^30, so they are masked for live tokens (a token at pos 2^30,
// a masked slot of the verify block, sees every slot, as in JAX).
//
// R ranges from 15 (spec verify of llama3.2-3b: S 5, G 3) to thousands (a
// suffix prefill), so the grid tiles the query rows: one block per (tile of
// RT rows, KV head, row). What the design does:
//   * the page table is walked inside the kernel (no gathered context);
//   * keys are walked in chunks of 64; a chunk's positions are read first
//     and its K/V staged (16-byte loads, common.cuh) only when some row of
//     the tile sees some key of it, and a key no row sees is never read —
//     a suffix tile skips every chunk past its last position;
//   * each staged K/V row serves all RT query rows of the tile (the G heads
//     of up to RT / G tokens), so K/V bytes are read once per tile;
//   * online softmax per query row, f32 accumulation on the CUDA cores,
//     one rounding at the output.
// Tensor-core (wgmma) tiles and TMA staging are later work.
#include "common.cuh"

namespace {

using repro::INVALID_POS;
using repro::NEG_INF;

constexpr int CK = 64;     // keys per chunk
constexpr int NT = 128;    // threads
constexpr int RT = 16;     // query rows per block

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (RT * D + CK * (D + 1) + CK * D + RT * CK + 3 * RT) +
         sizeof(int) * (3 * CK + RT);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
paged_verify_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ pos_pages,
                    const int* __restrict__ page_table, const int* __restrict__ q_pos,
                    T* __restrict__ out, int S, int H, int Hkv, int page, int n_max,
                    int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                   // RT x D
  float* ks = qs + RT * D;            // CK x (D+1), padded: no bank conflicts
  float* vs = ks + CK * (D + 1);      // CK x D
  float* ps = vs + CK * D;            // RT x CK scores, then probabilities
  float* m_s = ps + RT * CK;          // running max per query row
  float* l_s = m_s + RT;              // running sum
  float* c_s = l_s + RT;              // this chunk's rescale factor
  int* slot_s = reinterpret_cast<int*>(c_s + RT);  // flat pool slot per key
  int* kp_s = slot_s + CK;                         // key position
  int* any_s = kp_s + CK;                          // some row sees the key
  int* qp_s = any_s + CK;                          // row position (-1: no row)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * RT, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int R = S * G;
  const int L = n_max * page;
  const int* table = page_table + (size_t)b * n_max;

  // query row r -> (token s, query head hk*G + g); element offset of its q/out row
  const auto row_off = [&](int r) -> size_t {
    return (((size_t)b * S + r / G) * H + hk * G + r % G) * D;
  };
  for (int i = tid; i < RT * D; i += NT) {
    const int r = r0 + i / D;
    qs[i] = r < R ? repro::to_f<T>(q[row_off(r) + i % D]) : 0.f;
  }
  for (int i = tid; i < RT; i += NT) {
    const int r = r0 + i;
    qp_s[i] = r < R ? q_pos[(size_t)b * S + r / G] : -1;
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }
  __syncthreads();

  // key position kp visible to row i (a padding row sees nothing)
  const auto sees = [&](int i, int kp) -> bool {
    const int qp = qp_s[i];
    bool a = qp >= 0 && kp <= qp;
    if (window > 0) a = a && (qp - kp) < window;
    return a;
  };

  static_assert(NT % D == 0 && (RT * D) % NT == 0, "rows do not split evenly");
  constexpr int NPAIR = RT * D / NT;   // (row, column) pairs per thread
  constexpr int RSTEP = NT / D;        // rows between a thread's pairs
  const int d_own = tid % D, r_own = tid / D;
  float acc[NPAIR];
#pragma unroll
  for (int j = 0; j < NPAIR; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < L; c0 += CK) {
    bool any = false;
    for (int c = tid; c < CK; c += NT) {
      const int j = c0 + c;
      int slot = 0, kp = INVALID_POS;
      bool a = false;
      if (j < L) {
        slot = table[j / page] * page + j % page;
        kp = pos_pages[slot];
        for (int i = 0; i < RT && !a; ++i) a = sees(i, kp);
      }
      slot_s[c] = slot;
      kp_s[c] = kp;
      any_s[c] = a;
      any = any || a;
    }
    if (!__syncthreads_or(any)) continue;   // no row sees any key of the chunk

    // keys no row sees are never read (their probability is exactly 0)
    const auto page_row = [&](const T* pool, int c) -> const T* {
      return any_s[c] ? pool + ((size_t)slot_s[c] * Hkv + hk) * D : nullptr;
    };
    repro::stage_rows<T, D, CK, NT>([&](int c) { return page_row(k_pages, c); },
                                    ks, D + 1);
    repro::stage_rows<T, D, CK, NT>([&](int c) { return page_row(v_pages, c); },
                                    vs, D);
    __syncthreads();

    for (int i = tid; i < RT * CK; i += NT) {
      const int r = i / CK, c = i % CK;
      float s = NEG_INF;
      if (any_s[c] && sees(r, kp_s[c])) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += qs[r * D + d] * ks[c * (D + 1) + d];
        s = dot * scale;
      }
      ps[i] = s;
    }
    __syncthreads();

    for (int r = warp; r < RT; r += NT / 32) {   // one warp per query row
      const float s0 = ps[r * CK + lane], s1 = ps[r * CK + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = (any_s[lane] && sees(r, kp_s[lane])) ? expf(s0 - m_new) : 0.f;
      const float p1 = (any_s[lane + 32] && sees(r, kp_s[lane + 32]))
                           ? expf(s1 - m_new) : 0.f;
      ps[r * CK + lane] = p0;
      ps[r * CK + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // each thread owns column d_own of rows r_own, r_own + RSTEP, ...: one
    // read of V[c, d_own] serves all of them
#pragma unroll
    for (int j = 0; j < NPAIR; ++j) acc[j] *= c_s[r_own + j * RSTEP];
    for (int c = 0; c < CK; ++c) {
      const float v = vs[c * D + d_own];
#pragma unroll
      for (int j = 0; j < NPAIR; ++j) acc[j] += ps[(r_own + j * RSTEP) * CK + c] * v;
    }
    __syncthreads();   // before the next chunk overwrites ks/vs/ps
  }

#pragma unroll
  for (int j = 0; j < NPAIR; ++j) {
    const int i = r_own + j * RSTEP;
    const int r = r0 + i;
    if (r < R)
      out[row_off(r) + d_own] = repro::from_f<T>(acc[j] / fmaxf(l_s[i], 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* pos_pages, const int* page_table, const int* q_pos,
                   void* out, int B, int S, int H, int Hkv, int page, int n_max,
                   int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(paged_verify_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int R = S * (H / Hkv);
  dim3 grid((R + RT - 1) / RT, Hkv, B);
  paged_verify_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), pos_pages, page_table, q_pos,
      static_cast<T*>(out), S, H, Hkv, page, n_max, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. window <= 0: no window.
int paged_verify_attention_launch(const void* q, const void* k_pages,
                                  const void* v_pages, const void* pos_pages,
                                  const void* page_table, const void* q_pos,
                                  void* out, int B, int S, int H, int Hkv, int D,
                                  int page, int n_max, int dtype, int window,
                                  float scale, void* stream) {
  if (H % Hkv != 0 || S < 1 || B < 1) return cudaErrorInvalidValue;
  const int* pp = static_cast<const int*>(pos_pages);
  const int* pt = static_cast<const int*>(page_table);
  const int* qp = static_cast<const int*>(q_pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k_pages, v_pages, pp, pt, qp, out, B, S, H, Hkv, page, n_max, window, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k_pages, v_pages, pp, pt, qp, out, B, S, H, Hkv, page, n_max, window, scale, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k_pages, v_pages, pp, pt, qp, out, B, S, H, Hkv, page, n_max, window, scale, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k_pages, v_pages, pp, pt, qp, out, B, S, H, Hkv, page, n_max, window, scale, st);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

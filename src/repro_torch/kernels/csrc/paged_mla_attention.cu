// Absorbed MLA attention over a paged LATENT pool: S query tokens per row
// (S == 1 a decode step, S == k+1 the spec verify block), each masked by its
// own position.
//
// Replaces the Pallas TPU kernels `paged_mla_decode_attention` and
// `paged_mla_verify_attention` in src/repro/kernels/decode_attention.py
// (`_gather_latent_pages` -> `decode_attention` / `verify_attention` ->
// `_flash_rows` -> body `_kernel`). With w_uk folded into q, absorbed MLA is
// MQA over one latent head: K = [ckv | kr] (Dk = r + rd), V = ckv (Dv = r),
// G = H. Rows are flattened as the JAX kernel flattens them: R = S * H query
// rows per batch row, s-major and h-minor, so query row i is token i / H of
// head i % H and carries that token's position; q and out are (B, S, H, .)
// and their rows lie contiguous. Mask: kv_pos <= q_pos [&& q_pos - kv_pos <
// window]; the null page 0 and every unwritten slot carry pos 2^30 (masked
// for live tokens; a token at pos 2^30 sees every slot, as in JAX). A row
// with no visible key returns 0.
//
// Bound: at serving shapes the kernel must read each visible latent row
// once (576 elements at full width) and do 2 (Dk + Dv) operations per
// (query row, key) pair; at B 4 it is far from either, because it runs one
// block per (tile of RT query rows, batch row), i.e. B blocks on 132 SMs
// for decode at H 16. What the design does:
//   * the page table is walked inside the kernel (no gathered context);
//   * keys are walked in chunks of CK = 32, one per lane; a chunk's
//     positions are read first and its latent rows staged (16-byte loads)
//     only when some row of the tile sees some key of it; ckv and kr are
//     read from their own pools into one f32 row [ckv | kr] of the staged
//     chunk, and V is the first r columns of that row (read once);
//   * each staged key serves all RT query rows (the H heads of 16 / H
//     tokens), scores with 16-byte shared-memory loads (rows padded by 4
//     floats: no bank conflicts), online softmax per query row in f32, one
//     rounding at the output.
// Split-L across blocks and tensor-core (wgmma) tiles are later work.
#include "common.cuh"

namespace {

using repro::INVALID_POS;
using repro::NEG_INF;

constexpr int CK = 32;     // keys per chunk: one per lane
constexpr int RT = 16;     // query rows per block

template <int R, int RD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (RT * (R + RD) + CK * (R + RD + 4) + RT * CK + 3 * RT) +
         sizeof(int) * (3 * CK + RT);
}

// Copy the D-element rows of the visible keys of a chunk from a pool into
// columns [col0, col0 + D) of the staged f32 chunk (zeros for keys no row
// sees: their probability is exactly 0, and 0 * a stale NaN would not be).
template <typename T, int D, int NT>
__device__ __forceinline__ void stage_chunk(const T* __restrict__ pool,
                                            const int* slot_s, const int* any_s,
                                            float* ks, int ld, int col0) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;                 // 16-byte vectors per row
  static_assert(D % VEC == 0, "a row is not a whole number of 16-byte vectors");
  constexpr int NV = CK * VPR;
  constexpr int BATCH = 4;                     // loads in flight per thread
#pragma unroll
  for (int i0 = 0; i0 < NV; i0 += BATCH * NT) {
    uint4 r[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = i0 + u * NT + threadIdx.x;
      r[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < NV) {
        const int c = i / VPR;
        if (any_s[c])
          r[u] = __ldg(reinterpret_cast<const uint4*>(pool + (size_t)slot_s[c] * D) +
                       i % VPR);
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = i0 + u * NT + threadIdx.x;
      if (i < NV) repro::unpack16<T>(r[u], ks + (i / VPR) * ld + col0 + (i % VPR) * VEC);
    }
  }
}

template <typename T, int R, int RD, int NT>
__global__ void __launch_bounds__(NT)
paged_mla_kernel(const T* __restrict__ q, const T* __restrict__ ckv_pages,
                 const T* __restrict__ kr_pages, const int* __restrict__ pos_pages,
                 const int* __restrict__ page_table, const int* __restrict__ q_pos,
                 T* __restrict__ out, int S, int H, int page, int n_max, int window,
                 float scale) {
  constexpr int DK = R + RD;
  constexpr int LDK = DK + 4;        // staged row stride: 16-byte aligned, no bank conflicts
  constexpr int NW = NT / 32;
  constexpr int RPW = RT / NW;       // query rows per warp in the score pass
  // output ownership: thread owns columns d_own + k * NT (k < CPT) of rows
  // r_own + j * RSTEP (j < RPT)
  constexpr int DMIN = R < NT ? R : NT;
  constexpr int CPT = R / DMIN;
  constexpr int RSTEP = NT / DMIN;
  constexpr int RPT = RT / RSTEP;
  static_assert(DK % 4 == 0 && RT % NW == 0 && NT % 32 == 0, "bad tile shape");
  static_assert(R % DMIN == 0 && NT % DMIN == 0 && RT % RSTEP == 0, "bad output split");

  extern __shared__ float smem[];
  float* qs = smem;                  // RT x DK queries
  float* ks = qs + RT * DK;          // CK x LDK staged keys [ckv | kr]; V = first R columns
  float* ps = ks + CK * LDK;         // RT x CK probabilities
  float* m_s = ps + RT * CK;         // running max per query row
  float* l_s = m_s + RT;             // running sum
  float* c_s = l_s + RT;             // this chunk's rescale factor
  int* slot_s = reinterpret_cast<int*>(c_s + RT);  // flat pool slot per key
  int* kp_s = slot_s + CK;                         // key position
  int* any_s = kp_s + CK;                          // some row sees the key
  int* qp_s = any_s + CK;                          // row position (-1: no row)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * RT, b = blockIdx.y;
  const int Rq = S * H;
  const int L = n_max * page;
  const int* table = page_table + (size_t)b * n_max;
  const T* qb = q + (size_t)b * Rq * DK;
  T* ob = out + (size_t)b * Rq * R;

  for (int i = tid; i < RT * DK; i += NT) {
    const int r = r0 + i / DK;
    qs[i] = r < Rq ? repro::to_f<T>(qb[(size_t)r * DK + i % DK]) : 0.f;
  }
  for (int i = tid; i < RT; i += NT) {
    const int r = r0 + i;
    qp_s[i] = r < Rq ? q_pos[(size_t)b * S + r / H] : -1;
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

  const int d_own = tid % DMIN, r_own = tid / DMIN;
  float acc[RPT][CPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j)
#pragma unroll
    for (int k = 0; k < CPT; ++k) acc[j][k] = 0.f;

  for (int c0 = 0; c0 < L; c0 += CK) {
    bool any = false;
    if (tid < CK) {
      const int j = c0 + tid;
      int slot = 0, kp = INVALID_POS;
      bool a = false;
      if (j < L) {
        slot = table[j / page] * page + j % page;
        kp = pos_pages[slot];
        for (int i = 0; i < RT && !a; ++i) a = sees(i, kp);
      }
      slot_s[tid] = slot;
      kp_s[tid] = kp;
      any_s[tid] = a;
      any = a;
    }
    if (!__syncthreads_or(any)) continue;   // no row sees any key of the chunk

    stage_chunk<T, R, NT>(ckv_pages, slot_s, any_s, ks, LDK, 0);
    stage_chunk<T, RD, NT>(kr_pages, slot_s, any_s, ks, LDK, R);
    __syncthreads();

    // scores and online softmax: warp w takes rows w, w + NW, ...; lane =
    // key. Only warp w touches those rows' m/l/c, so no block barrier
    // between the scores and the softmax.
    {
      const bool kvis = any_s[lane];
      const int kp = kp_s[lane];
      const float4* k4 = reinterpret_cast<const float4*>(ks + lane * LDK);
      float dot[RPW];
#pragma unroll
      for (int j = 0; j < RPW; ++j) dot[j] = 0.f;
#pragma unroll 4
      for (int d4 = 0; d4 < DK / 4; ++d4) {
        const float4 kv = k4[d4];
#pragma unroll
        for (int j = 0; j < RPW; ++j) {
          const float4 qv = reinterpret_cast<const float4*>(qs + (warp + j * NW) * DK)[d4];
          dot[j] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
        }
      }
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        const int i = warp + j * NW;
        const bool vis = kvis && sees(i, kp);
        const float s = vis ? dot[j] * scale : NEG_INF;
        const float m_old = m_s[i];
        float mx = s;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m_old, mx);
        const float p = vis ? expf(s - m_new) : 0.f;
        ps[i * CK + lane] = p;
        float sum = p;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        __syncwarp();
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          c_s[i] = corr;
          l_s[i] = l_s[i] * corr + sum;
          m_s[i] = m_new;
        }
      }
    }
    __syncthreads();

    // P V: V[c, d] is the staged ckv column d of key c
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const float corr = c_s[r_own + j * RSTEP];
#pragma unroll
      for (int k = 0; k < CPT; ++k) acc[j][k] *= corr;
    }
    for (int c = 0; c < CK; c += 4) {
      float v[4][CPT];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int k = 0; k < CPT; ++k) v[u][k] = ks[(c + u) * LDK + d_own + k * NT];
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const float4 p = *reinterpret_cast<const float4*>(ps + (r_own + j * RSTEP) * CK + c);
#pragma unroll
        for (int k = 0; k < CPT; ++k)
          acc[j][k] += p.x * v[0][k] + p.y * v[1][k] + p.z * v[2][k] + p.w * v[3][k];
      }
    }
    __syncthreads();   // before the next chunk overwrites ks/ps/slots
  }

#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int i = r_own + j * RSTEP;
    const int r = r0 + i;
    if (r < Rq) {
      const float inv_l = 1.f / fmaxf(l_s[i], 1e-30f);
#pragma unroll
      for (int k = 0; k < CPT; ++k)
        ob[(size_t)r * R + d_own + k * NT] = repro::from_f<T>(acc[j][k] * inv_l);
    }
  }
}

template <typename T, int R, int RD, int NT>
cudaError_t launch(const void* q, const void* ckv_pages, const void* kr_pages,
                   const int* pos_pages, const int* page_table, const int* q_pos,
                   void* out, int B, int S, int H, int page, int n_max, int window,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<R, RD>();
  cudaError_t err = cudaFuncSetAttribute(paged_mla_kernel<T, R, RD, NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S * H + RT - 1) / RT, B);
  paged_mla_kernel<T, R, RD, NT><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ckv_pages),
      static_cast<const T*>(kr_pages), pos_pages, page_table, q_pos,
      static_cast<T*>(out), S, H, page, n_max, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. (r, rd): (512, 64) full-width and
// (64, 16) reduced deepseek-v2-lite. window <= 0: no window.
int paged_mla_attention_launch(const void* q, const void* ckv_pages,
                               const void* kr_pages, const void* pos_pages,
                               const void* page_table, const void* q_pos, void* out,
                               int B, int S, int H, int r, int rd, int page, int n_max,
                               int dtype, int window, float scale, void* stream) {
  if (S < 1 || B < 1 || H < 1 || page < 1 || n_max < 1) return cudaErrorInvalidValue;
  const int* pp = static_cast<const int*>(pos_pages);
  const int* pt = static_cast<const int*>(page_table);
  const int* qp = static_cast<const int*>(q_pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && r == 512 && rd == 64)
    return launch<float, 512, 64, 256>(q, ckv_pages, kr_pages, pp, pt, qp, out, B, S, H, page, n_max, window, scale, st);
  if (dtype == 1 && r == 512 && rd == 64)
    return launch<__nv_bfloat16, 512, 64, 256>(q, ckv_pages, kr_pages, pp, pt, qp, out, B, S, H, page, n_max, window, scale, st);
  if (dtype == 0 && r == 64 && rd == 16)
    return launch<float, 64, 16, 128>(q, ckv_pages, kr_pages, pp, pt, qp, out, B, S, H, page, n_max, window, scale, st);
  if (dtype == 1 && r == 64 && rd == 16)
    return launch<__nv_bfloat16, 64, 16, 128>(q, ckv_pages, kr_pages, pp, pt, qp, out, B, S, H, page, n_max, window, scale, st);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

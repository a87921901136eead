// Block-sparse shared-prompt flash attention, forward (prefill and SPA rows).
//
// Replaces the Pallas TPU kernel `spa_attention` in
// src/repro/kernels/spa_attention.py (body `_kernel`, host `block_map`).
// Mask: kv visible iff kv_pos <= q_pos && (kv_seg == 0 || kv_seg == q_seg)
// [&& q_pos - kv_pos < window]. Online softmax in f32, output rounded once.
// For training, the launch may also ask for each (row, head, query)'s
// log-sum-exp of the scaled scores and an f32 copy of the output: the
// backward kernel (spa_attention_bwd.cu) recomputes the probabilities from
// the former and takes rowsum(dO * O) from the latter, so a bf16 forward's
// gradient does not carry the output's bf16 rounding.
//
// What bounds it on an H100: at prefill lengths the work is O(S^2 D) and
// the kernel is compute bound. This first version keeps Q, K and V tiles
// in shared memory as f32 and runs the two products on the CUDA cores
// (FMA), so shared-memory loads, not the tensor cores, set its speed;
// wgmma/TMA tiles are later work. What the design does about the bound:
//   * one block per (query tile of 32, head, batch row); the KV head is
//     indexed as h / G instead of repeating K/V per query head, so K/V are
//     read once per query tile and never copied; tiles are staged with
//     16-byte loads, several in flight per thread;
//   * dead tiles are skipped exactly: each KV tile's (pos, seg) are loaded
//     first and the tile's K/V are read only if some query of the tile sees
//     some key of it (__syncthreads_or over the mask), which drops the
//     response_i x response_j and non-causal tiles the TPU block map drops;
//   * masked scores are the finite NEG_INF = -1e30 and masked probabilities
//     are exactly 0, so fully masked tiles and padding rows stay finite,
//     and a row that sees no key at all outputs 0.
#include "common.cuh"

namespace {

using repro::INVALID_POS;
using repro::NEG_INF;

constexpr int BQ = 32;     // query rows per block
constexpr int BK = 64;     // keys per KV tile
constexpr int NT = 128;    // threads: 4 per query row

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1)) +
         sizeof(int) * (2 * BQ + 2 * BK);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
spa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const int* __restrict__ qpos, const int* __restrict__ kvpos,
           const int* __restrict__ qseg, const int* __restrict__ kvseg,
           T* __restrict__ out, float* __restrict__ lse, float* __restrict__ o32,
           int Sq, int Skv, int H, int Hkv, int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                    // BQ x (D+1), padded: no bank conflicts
  float* ks = qs + BQ * (D + 1);       // BK x (D+1)
  float* vs = ks + BK * (D + 1);       // BK x D
  float* ps = vs + BK * D;             // BQ x (BK+1) probabilities
  int* qp_s = reinterpret_cast<int*>(ps + BQ * (BK + 1));
  int* qg_s = qp_s + BQ;
  int* kp_s = qg_s + BQ;
  int* kg_s = kp_s + BK;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);

  repro::stage_rows<T, D, BQ, NT>(
      [&](int r) -> const T* {
        return q0 + r < Sq ? q + (((size_t)b * Sq + q0 + r) * H + h) * D : nullptr;
      },
      qs, D + 1);
  for (int r = tid; r < BQ; r += NT) {
    const int s = q0 + r;
    qp_s[r] = s < Sq ? qpos[(size_t)b * Sq + s] : 0;
    qg_s[r] = s < Sq ? qseg[(size_t)b * Sq + s] : -1;   // pad q seg -1
  }
  __syncthreads();

  const int row = tid >> 2;            // this thread's query row
  const int sub = tid & 3;             // keys sub + 4j, columns sub + 4j
  constexpr int KPT = BK / 4, DPT = D / 4;
  const bool row_valid = q0 + row < Sq;
  const int my_qp = qp_s[row], my_qg = qg_s[row];
  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;
  float m = NEG_INF, l = 0.f;

  for (int k0 = 0; k0 < Skv; k0 += BK) {
    for (int c = tid; c < BK; c += NT) {
      const int j = k0 + c;
      kp_s[c] = j < Skv ? kvpos[(size_t)b * Skv + j] : INVALID_POS;  // pad kv
      kg_s[c] = j < Skv ? kvseg[(size_t)b * Skv + j] : -2;
    }
    __syncthreads();
    bool allow[KPT];
    bool any = false;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int c = sub + 4 * j, kp = kp_s[c], kg = kg_s[c];
      bool a = row_valid && kp <= my_qp && (kg == 0 || kg == my_qg);
      if (window > 0) a = a && (my_qp - kp) < window;
      allow[j] = a;
      any = any || a;
    }
    // exact tile skip: no query of this tile sees any key of this tile
    if (!__syncthreads_or(any)) continue;

    const auto kv_row = [&](const T* base, int c) -> const T* {
      return k0 + c < Skv ? base + (((size_t)b * Skv + k0 + c) * Hkv + hk) * D
                          : nullptr;
    };
    repro::stage_rows<T, D, BK, NT>([&](int c) { return kv_row(k, c); }, ks, D + 1);
    repro::stage_rows<T, D, BK, NT>([&](int c) { return kv_row(v, c); }, vs, D);
    __syncthreads();

    float s[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = qs[row * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[j] += qd * ks[(sub + 4 * j) * (D + 1) + d];
    }
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      s[j] = allow[j] ? s[j] * scale : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    // the 4 threads of a row are adjacent lanes of one warp
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float p = allow[j] ? expf(s[j] - m_new) : 0.f;
      ps[row * (BK + 1) + sub + 4 * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();   // the row's probabilities were written by its own warp

#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[j] *= corr;
    for (int c = 0; c < BK; ++c) {
      const float p = ps[row * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[j] += p * vs[c * D + sub + 4 * j];
    }
    __syncthreads();   // before the next tile overwrites ks/vs/kp_s
  }

  if (row_valid) {
    const float denom = fmaxf(l, 1e-30f);
    const size_t at = (((size_t)b * Sq + q0 + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) out[at + sub + 4 * j] = repro::from_f<T>(acc[j] / denom);
    if (o32 != nullptr) {
#pragma unroll
      for (int j = 0; j < DPT; ++j) o32[at + sub + 4 * j] = acc[j] / denom;
    }
    // a row that sees no key keeps m = NEG_INF: its lse stays about -1e30,
    // and the backward masks all of its probabilities to 0 anyway
    if (lse != nullptr && sub == 0)
      lse[((size_t)b * H + h) * Sq + q0 + row] = m + logf(denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* qpos,
                   const int* kvpos, const int* qseg, const int* kvseg, void* out,
                   float* lse, float* o32, int B, int Sq, int Skv, int H, int Hkv,
                   int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      spa_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  spa_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      qpos, kvpos, qseg, kvseg, static_cast<T*>(out), lse, o32, Sq, Skv, H, Hkv,
      window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. window <= 0: no window. lse (B, H, Sq)
// and o32 (B, Sq, H, D), both f32, may each be null (serving passes neither).
int spa_attention_launch(const void* q, const void* k, const void* v,
                         const void* qpos, const void* kvpos, const void* qseg,
                         const void* kvseg, void* out, void* lse, void* o32,
                         int B, int Sq, int Skv, int H, int Hkv, int D, int dtype,
                         int window, float scale, void* stream) {
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kvpos);
  const int* qg = static_cast<const int*>(qseg);
  const int* kg = static_cast<const int*>(kvseg);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  float* o3 = static_cast<float*>(o32);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, qp, kp, qg, kg, out, ls, o3, B, Sq, Skv, H, Hkv, window, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, qp, kp, qg, kg, out, ls, o3, B, Sq, Skv, H, Hkv, window, scale, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, qp, kp, qg, kg, out, ls, o3, B, Sq, Skv, H, Hkv, window, scale, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, qp, kp, qg, kg, out, ls, o3, B, Sq, Skv, H, Hkv, window, scale, st);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Block-sparse shared-prompt flash attention, backward (training).
//
// The gradient of the forward in spa_attention.cu, which replaces the Pallas
// TPU kernel `spa_attention` of src/repro/kernels/spa_attention.py. That
// kernel has no VJP: the JAX package differentiates its pure-JAX
// `chunked_attention` with XLA's autodiff, and this is the port's kernel for
// the same gradient. Same mask, same NEG_INF, same treatment of a query row
// that sees no key: its dq is 0 and it adds nothing to dk or dv.
//
// Inputs: q (B,Sq,H,D), k and v (B,Skv,Hkv,D), positions and segments, the
// forward's f32 output O (B,Sq,H,D) and log-sum-exp L (B,H,Sq), and dO.
// With P = exp(scale * q.k - L) on visible pairs (0 elsewhere):
//   delta_i = rowsum(dO_i * O_i)
//   dS = P * (dO.v - delta)
//   dq = scale * dS k,   dk = scale * dS^T q,   dv = P^T dO
// Three launches on the caller's stream:
//   1. delta_kernel: one warp per (row, query, head) row of dO and O;
//   2. dq_kernel: one block per (query tile of 32, head, batch row), looping
//      over KV tiles, with the forward kernel's thread layout;
//   3. dkdv_kernel: one block per (KV tile of 64, KV head, batch row),
//      looping over the query tiles and the G = H / Hkv query heads of its KV
//      head; each thread keeps one key's K and V row slice and its dk/dv
//      sums in registers, and every output element is written once.
// No atomics: every sum runs in a fixed order, so two launches on the same
// inputs give bitwise-equal gradients.
//
// What bounds it on an H100: the five products over visible (query, key)
// pairs are compute; this first version runs them in f32 on the CUDA cores
// out of shared memory and registers (the forward's design), so it is far
// from the tensor-core bound. Dead tiles are skipped exactly as in the
// forward: a tile's positions and segments are loaded first and its rows are
// read only if some pair in it is visible (__syncthreads_or).
#include "common.cuh"

namespace {

using repro::INVALID_POS;
using repro::NEG_INF;

constexpr int BQ = 32;      // query rows per tile
constexpr int BK = 64;      // keys per tile
constexpr int NTQ = 128;    // dq kernel: 4 threads per query row
constexpr int NTK = 256;    // dk/dv kernel: 4 threads per key

__device__ __forceinline__ bool visible(int qp, int qg, int kp, int kg, int window) {
  bool a = kp <= qp && (kg == 0 || kg == qg);
  if (window > 0) a = a && (qp - kp) < window;
  return a;
}

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dO * O)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void delta_kernel(const T* __restrict__ dout, const float* __restrict__ o32,
                             float* __restrict__ delta, int Sq, int H, long rows) {
  const long r = (long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (r >= rows) return;                     // whole warps leave together
  const int lane = threadIdx.x & 31;
  const T* g = dout + r * D;
  const float* o = o32 + r * D;
  float s = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) s += repro::to_f<T>(g[d]) * o[d];
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) {                           // r = (b * Sq + i) * H + h
    const int h = (int)(r % H);
    const long bi = r / H;
    const int i = (int)(bi % Sq);
    const long b = bi / Sq;
    delta[(b * H + h) * Sq + i] = s;
  }
}

// ---------------------------------------------------------------------------
// 2. dq
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1)) +
         sizeof(int) * (2 * BQ + 2 * BK);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTQ)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const int* __restrict__ qpos, const int* __restrict__ kvpos,
          const int* __restrict__ qseg, const int* __restrict__ kvseg,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Skv,
          int H, int Hkv, int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                      // BQ x (D+1)
  float* gs = qs + BQ * (D + 1);         // BQ x (D+1): dO
  float* ks = gs + BQ * (D + 1);         // BK x (D+1)
  float* vs = ks + BK * (D + 1);         // BK x (D+1)
  float* dss = vs + BK * (D + 1);        // BQ x (BK+1): dS
  int* qp_s = reinterpret_cast<int*>(dss + BQ * (BK + 1));
  int* qg_s = qp_s + BQ;
  int* kp_s = qg_s + BQ;
  int* kg_s = kp_s + BK;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const auto q_row = [&](const T* base, int r) -> const T* {
    return q0 + r < Sq ? base + (((size_t)b * Sq + q0 + r) * H + h) * D : nullptr;
  };
  repro::stage_rows<T, D, BQ, NTQ>([&](int r) { return q_row(q, r); }, qs, D + 1);
  repro::stage_rows<T, D, BQ, NTQ>([&](int r) { return q_row(dout, r); }, gs, D + 1);
  for (int r = tid; r < BQ; r += NTQ) {
    const int s = q0 + r;
    qp_s[r] = s < Sq ? qpos[(size_t)b * Sq + s] : 0;
    qg_s[r] = s < Sq ? qseg[(size_t)b * Sq + s] : -1;
  }
  __syncthreads();

  const int row = tid >> 2, sub = tid & 3;
  constexpr int KPT = BK / 4, DPT = D / 4;
  const bool row_valid = q0 + row < Sq;
  const int my_qp = qp_s[row], my_qg = qg_s[row];
  const size_t stat = ((size_t)b * H + h) * Sq + q0 + row;
  const float my_lse = row_valid ? lse[stat] : 0.f;
  const float my_delta = row_valid ? delta[stat] : 0.f;
  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < Skv; k0 += BK) {
    for (int c = tid; c < BK; c += NTQ) {
      const int j = k0 + c;
      kp_s[c] = j < Skv ? kvpos[(size_t)b * Skv + j] : INVALID_POS;
      kg_s[c] = j < Skv ? kvseg[(size_t)b * Skv + j] : -2;
    }
    __syncthreads();
    bool allow[KPT];
    bool any = false;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int c = sub + 4 * j;
      allow[j] = row_valid && visible(my_qp, my_qg, kp_s[c], kg_s[c], window);
      any = any || allow[j];
    }
    if (!__syncthreads_or(any)) continue;    // dead tile: no visible pair

    const auto kv_row = [&](const T* base, int c) -> const T* {
      return k0 + c < Skv ? base + (((size_t)b * Skv + k0 + c) * Hkv + hk) * D
                          : nullptr;
    };
    repro::stage_rows<T, D, BK, NTQ>([&](int c) { return kv_row(k, c); }, ks, D + 1);
    repro::stage_rows<T, D, BK, NTQ>([&](int c) { return kv_row(v, c); }, vs, D + 1);
    __syncthreads();

    float s[KPT], dp[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) s[j] = dp[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = qs[row * (D + 1) + d];
      const float gd = gs[row * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        s[j] += qd * ks[(sub + 4 * j) * (D + 1) + d];
        dp[j] += gd * vs[(sub + 4 * j) * (D + 1) + d];
      }
    }
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float p = allow[j] ? expf(s[j] * scale - my_lse) : 0.f;
      dss[row * (BK + 1) + sub + 4 * j] = p * (dp[j] - my_delta);
    }
    __syncwarp();   // the row's dS was written by its own warp

    for (int c = 0; c < BK; ++c) {
      const float ds = dss[row * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[j] += ds * ks[c * (D + 1) + sub + 4 * j];
    }
    __syncthreads();   // before the next tile overwrites ks/vs/kp_s
  }

  if (row_valid) {
    T* o = dq + (((size_t)b * Sq + q0 + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) o[sub + 4 * j] = repro::from_f<T>(acc[j] * scale);
  }
}

// ---------------------------------------------------------------------------
// 3. dk, dv
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * (2 * BQ * D + 2 * BQ) + sizeof(int) * 2 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(NTK)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const int* __restrict__ qpos, const int* __restrict__ kvpos,
            const int* __restrict__ qseg, const int* __restrict__ kvseg,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
            int Sq, int Skv, int H, int Hkv, int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                  // BQ x D
  float* gs = qs + BQ * D;           // BQ x D: dO
  float* ls = gs + BQ * D;           // BQ: lse
  float* dl = ls + BQ;               // BQ: delta
  int* qp_s = reinterpret_cast<int*>(dl + BQ);
  int* qg_s = qp_s + BQ;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int c = tid >> 2, sub = tid & 3;   // this thread's key; columns sub + 4j
  constexpr int DPT = D / 4;
  const int key = k0 + c;
  const bool key_valid = key < Skv;
  const int my_kp = key_valid ? kvpos[(size_t)b * Skv + key] : INVALID_POS;
  const int my_kg = key_valid ? kvseg[(size_t)b * Skv + key] : -2;
  float kr[DPT], vr[DPT], dka[DPT], dva[DPT];
  const size_t at = (((size_t)b * Skv + key) * Hkv + hk) * D;
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    kr[j] = key_valid ? repro::to_f<T>(k[at + sub + 4 * j]) : 0.f;
    vr[j] = key_valid ? repro::to_f<T>(v[at + sub + 4 * j]) : 0.f;
    dka[j] = dva[j] = 0.f;
  }

  for (int q0 = 0; q0 < Sq; q0 += BQ) {
    __syncthreads();   // the previous tile's readers are done
    for (int r = tid; r < BQ; r += NTK) {
      const int s = q0 + r;
      qp_s[r] = s < Sq ? qpos[(size_t)b * Sq + s] : 0;
      qg_s[r] = s < Sq ? qseg[(size_t)b * Sq + s] : -1;
    }
    __syncthreads();
    bool any = false;
    for (int i = sub; i < BQ; i += 4)
      any = any || (key_valid && q0 + i < Sq &&
                    visible(qp_s[i], qg_s[i], my_kp, my_kg, window));
    if (!__syncthreads_or(any)) continue;    // dead tile: no visible pair

    for (int g = 0; g < G; ++g) {
      const int h = hk * G + g;
      const auto q_row = [&](const T* base, int r) -> const T* {
        return q0 + r < Sq ? base + (((size_t)b * Sq + q0 + r) * H + h) * D
                           : nullptr;
      };
      __syncthreads();   // the previous head's tiles are consumed
      repro::stage_rows<T, D, BQ, NTK>([&](int r) { return q_row(q, r); }, qs, D);
      repro::stage_rows<T, D, BQ, NTK>([&](int r) { return q_row(dout, r); }, gs, D);
      for (int r = tid; r < BQ; r += NTK) {
        const bool ok = q0 + r < Sq;
        const size_t stat = ((size_t)b * H + h) * Sq + q0 + r;
        ls[r] = ok ? lse[stat] : 0.f;
        dl[r] = ok ? delta[stat] : 0.f;
      }
      __syncthreads();

      for (int i = 0; i < BQ; ++i) {
        const bool a = key_valid && q0 + i < Sq &&
                       visible(qp_s[i], qg_s[i], my_kp, my_kg, window);
        // the 4 threads of a key are adjacent lanes: partial dot products
        // over their columns, summed with two shuffles
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          s += qs[i * D + sub + 4 * j] * kr[j];
          dp += gs[i * D + sub + 4 * j] * vr[j];
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        dp += __shfl_xor_sync(0xffffffffu, dp, 1);
        dp += __shfl_xor_sync(0xffffffffu, dp, 2);
        const float p = a ? expf(s * scale - ls[i]) : 0.f;
        const float ds = p * (dp - dl[i]);
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          dva[j] += p * gs[i * D + sub + 4 * j];
          dka[j] += ds * qs[i * D + sub + 4 * j];
        }
      }
    }
  }

  if (key_valid) {
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      dk[at + sub + 4 * j] = repro::from_f<T>(dka[j] * scale);
      dv[at + sub + 4 * j] = repro::from_f<T>(dva[j]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* qpos,
                   const int* kvpos, const int* qseg, const int* kvseg,
                   const float* o32, const float* lse, const void* dout, float* delta,
                   void* dq, void* dk, void* dv, int B, int Sq, int Skv, int H,
                   int Hkv, int window, float scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const long rows = (long)B * Sq * H;
  constexpr int WARPS = 8;
  delta_kernel<T, D><<<(unsigned)((rows + WARPS - 1) / WARPS), 32 * WARPS, 0, stream>>>(
      gt, o32, delta, Sq, H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem_q = dq_smem_bytes<D>();
  err = cudaFuncSetAttribute(dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return err;
  dq_kernel<T, D><<<dim3((Sq + BQ - 1) / BQ, H, B), NTQ, smem_q, stream>>>(
      qt, kt, vt, qpos, kvpos, qseg, kvseg, gt, lse, delta, static_cast<T*>(dq), Sq,
      Skv, H, Hkv, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem_k = dkdv_smem_bytes<D>();
  err = cudaFuncSetAttribute(dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_k);
  if (err != cudaSuccess) return err;
  dkdv_kernel<T, D><<<dim3((Skv + BK - 1) / BK, Hkv, B), NTK, smem_k, stream>>>(
      qt, kt, vt, qpos, kvpos, qseg, kvseg, gt, lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), Sq, Skv, H, Hkv, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. window <= 0: no window. o32 (B,Sq,H,D)
// and lse (B,H,Sq) are the forward's f32 output and log-sum-exp; delta
// (B,H,Sq) f32 is scratch. dq is (B,Sq,H,D), dk and dv (B,Skv,Hkv,D), in
// the dtype of q.
int spa_attention_bwd_launch(const void* q, const void* k, const void* v,
                             const void* qpos, const void* kvpos, const void* qseg,
                             const void* kvseg, const void* o32, const void* lse,
                             const void* dout, void* delta, void* dq, void* dk,
                             void* dv, int B, int Sq, int Skv, int H, int Hkv, int D,
                             int dtype, int window, float scale, void* stream) {
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kvpos);
  const int* qg = static_cast<const int*>(qseg);
  const int* kg = static_cast<const int*>(kvseg);
  const float* o3 = static_cast<const float*>(o32);
  const float* ls = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_BWD(T, DD)                                                              \
  return launch<T, DD>(q, k, v, qp, kp, qg, kg, o3, ls, dout, dl, dq, dk, dv, B, Sq, \
                       Skv, H, Hkv, window, scale, st)
  if (dtype == 0 && D == 64) REPRO_BWD(float, 64);
  if (dtype == 0 && D == 128) REPRO_BWD(float, 128);
  if (dtype == 1 && D == 64) REPRO_BWD(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) REPRO_BWD(__nv_bfloat16, 128);
#undef REPRO_BWD
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

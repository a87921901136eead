// Block-sparse shared-prompt flash attention, forward (prefill and SPA rows).
//
// Replaces the Pallas TPU kernel `spa_attention` in
// src/repro/kernels/spa_attention.py:104 (body `_kernel` :29, host
// `block_map` :75). Mask: kv visible iff kv_pos <= q_pos && (kv_seg == 0 ||
// kv_seg == q_seg) [&& q_pos - kv_pos < window]. Online softmax in f32,
// output rounded once. For training, the launch may also ask for each (row,
// head, query)'s log-sum-exp of the scaled scores and an f32 copy of the
// output: the backward kernel (spa_attention_bwd.cu) recomputes the
// probabilities from the former and takes rowsum(dO * O) from the latter.
//
// What bounds it on an H100: at prefill lengths the work is O(S^2 D): 4 D
// flops per visible (query, key) pair and head, 6.4 GFLOP at the 1024-token
// prompt (H 24, D 128), 6.5 us at the bf16 tensor-core peak against 6.4 MB
// of bytes (1.9 us): the kernel is compute bound. What the design does:
//   * bf16 runs both products on the tensor cores (wgmma, f32 accumulators):
//     one warpgroup per block of 64 queries, S = Q K^T as m64n64k16 steps
//     from shared memory, then O += P V with P in registers. P is split into
//     bf16 hi + lo and both go through the product (O += P_hi V + P_lo V):
//     P rounded once to bf16 would miss the one-ulp bar on about a tenth of
//     the outputs; the pair carries P to 2^-16 for 1.5 times the tensor-core
//     work of the unsplit product;
//   * f32 stays on the CUDA cores (TF32's 10-bit mantissa cannot meet the
//     f32 bar): 64 x 32 tiles over 128 threads, each a 4 x 4 block of
//     scores and a 4 x D/8 block of the output, fed by float4 loads from
//     conflict-free padded tiles, so one shared load feeds 4 to 16 FMAs;
//   * K/V tiles go through a two-stage ring: the next live tile is in
//     flight while the current one is computed. bf16 tiles are copied by
//     the Tensor Memory Accelerator (one thread issues them, an mbarrier
//     per stage counts their bytes) and stay bf16 in shared memory (16 KB
//     per K or V tile at D 128); f32 tiles by cp.async;
//   * dead tiles are skipped exactly: before any K/V is read, the block maps
//     which KV tiles some query of it sees (positions and segments only,
//     attn_tiles.cuh), so response_i x response_j, past-the-diagonal and
//     out-of-window tiles are never staged; tiles whose every pair is
//     visible skip the per-element mask;
//   * blocks of the longest query tiles launch first (causal work grows with
//     the tile index), and the G query heads of a KV head are neighbours in
//     the grid, so their K/V reads hit the 50 MB L2;
//   * masked probabilities are exactly 0 and masked scores the finite
//     NEG_INF, so a row that sees no key outputs 0.
#include "attn_tiles.cuh"

namespace {

using namespace repro::tiles;
using repro::NEG_INF;
using bf16 = __nv_bfloat16;

constexpr int NT = 128;      // bf16: one warpgroup
constexpr int BQ = 64;       // query rows per block
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared-memory layout of the bf16 kernel (byte offsets from a 1024-aligned
// base): Q, K[2], V[2] swizzled tiles, then key/query metadata and the map.
template <int D>
struct Bf16Layout {
  static constexpr int BK = 64;
  static constexpr uint32_t TILE = BK * D * 2;
  static constexpr uint32_t Q = 0, K = TILE, V = K + 2 * TILE, KP = V + 2 * TILE,
                            KG = KP + 2 * BK * 4, QP = KG + 2 * BK * 4, QG = QP + BQ * 4,
                            RED = QG + BQ * 4, BAR = RED + 32 * 4, MAP = BAR + 2 * 8;
  static size_t bytes(int Skv) { return 1024 + MAP + 2 * ((Skv + BK - 1) / BK); }
};

// The same for the f32 kernel: padded Q, K[2], V[2] tiles and a P tile.
template <int D>
struct F32Layout {
  static constexpr int BK = F_COLS, LD = D + 4;
  static constexpr uint32_t QB = BQ * LD * 4, KB = BK * LD * 4;
  static constexpr uint32_t Q = 0, K = QB, V = K + 2 * KB, P = V + 2 * KB,
                            KP = P + BQ * F_PLD * 4, KG = KP + 2 * BK * 4, QP = KG + 2 * BK * 4,
                            QG = QP + BQ * 4, RED = QG + BQ * 4, MAP = RED + 32 * 4;
  static size_t bytes(int Skv) { return 1024 + MAP + 2 * ((Skv + BK - 1) / BK); }
};

struct Args {
  const void *q, *k, *v;
  const int *qpos, *kvpos, *qseg, *kvseg;
  void* out;
  float *lse, *o32;
  int Sq, Skv, H, Hkv, window;
  float scale;
  CUtensorMap tk, tv;        // bf16: K and V in 64-key boxes of one KV head
};

// Block setup shared by both kernels: the query rows' positions and
// segments into shared memory, then the map of the KV tiles.
template <int BK, int NTHREADS>
__device__ __forceinline__ void block_setup(const Args& a, int b, int q0, int nq, int* qp_s,
                                            int* qg_s, int* red, uint8_t* map) {
  Side qs;
  map_tiles<BK, NTHREADS>(
      a.Skv, a.kvpos + (size_t)b * a.Skv, a.kvseg + (size_t)b * a.Skv,
      [&] {
        qs = own_rows<NTHREADS>(a.qpos + (size_t)b * a.Sq + q0, a.qseg + (size_t)b * a.Sq + q0,
                                nq, BQ, -1, qp_s, qg_s, red);
      },
      [&](int kp, int kg) { return key_seen(kp, kg, qp_s, qg_s, qs, a.window); },
      [&](int kp, int kg) { return key_seen_by_all(kp, kg, qs, a.window); }, map);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NT) spa_fwd_bf16(const __grid_constant__ Args a) {
  using L = Bf16Layout<D>;
  constexpr int BK = L::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  const uint32_t sb = smem_u32(sm);
  int* kp_s = reinterpret_cast<int*>(sm + L::KP);
  int* kg_s = reinterpret_cast<int*>(sm + L::KG);
  int* qp_s = reinterpret_cast<int*>(sm + L::QP);
  int* qg_s = reinterpret_cast<int*>(sm + L::QG);
  uint8_t* map = sm + L::MAP;

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;     // longest tiles first
  const int hk = h / (a.H / a.Hkv);
  const int nq = min(BQ, a.Sq - q0);
  const int nkt = (a.Skv + BK - 1) / BK;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::BAR);   // one per stage
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    fence_mbar_init();
  }
  stage_bf16<D, BQ, NT>(sb + L::Q, head_rows<bf16, D>(a.q, b, q0, nq, a.Sq, a.H, h), a.q);
  block_setup<BK, NT>(a, b, q0, nq, qp_s, qg_s, reinterpret_cast<int*>(sm + L::RED), map);
  // K/V by TMA (one thread), positions and segments by cp.async
  auto prefetch = [&](int t, int st) {
    const int k0 = t * BK;
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar + st, 2 * L::TILE);
      tma_tile<D, BK>(sb + L::K + st * L::TILE, &a.tk, bar + st, k0, hk, b);
      tma_tile<D, BK>(sb + L::V + st * L::TILE, &a.tv, bar + st, k0, hk, b);
    }
    stage_kv_meta<BK>(a.kvpos, a.kvseg, a.Skv, b, t, kp_s + st * BK, kg_s + st * BK);
  };
  uint32_t phase = 0;              // bit s: parity of stage s's next completion

  const int lane = threadIdx.x & 31;
  const int r0 = frag_row(0), r1 = r0 + 8;
  const bool v0 = r0 < nq, v1 = r1 < nq;
  const int qp0 = qp_s[r0], qg0 = qg_s[r0], qp1 = qp_s[r1], qg1 = qg_s[r1];
  const float sl2 = a.scale * LOG2E;     // scores in log2 units: exp2
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  int t = next_live(map, -1, nkt), st = 0;
  if (t < nkt) prefetch(t, 0);
  cp_async_commit();
  while (t < nkt) {
    const int tn = next_live(map, t, nkt);
    if (tn < nkt) prefetch(tn, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();            // Q and tile t's positions have landed
    mbar_wait(bar + st, (phase >> st) & 1u);                  // and its K/V
    phase ^= 1u << st;
    fence_async_smem();            // Q (cp.async) is read by wgmma
    __syncthreads();

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wg_fence();
    wgmma_scores<D>(s, sb + L::Q, sb + L::K + st * L::TILE);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);

    const int* kp = kp_s + st * BK;
    const int* kg = kg_s + st * BK;
    softmax_tile<D>(s, o, map[t] == FULL, [&](int c, bool hi) {
      return hi ? v1 && visible(qp1, qg1, kp[c], kg[c], a.window)
                : v0 && visible(qp0, qg0, kp[c], kg[c], a.window);
    }, sl2, m0, m1, l0, l1);
    wgmma_pv<D>(o, s, sb + L::V + st * L::TILE);
    __syncthreads();                 // stage st is free for the next prefetch
    t = tn;
    st ^= 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
      if (!(half ? v1 : v0)) continue;
      const float den = half ? den1 : den0;
      const float x0 = o[4 * j + 2 * half] / den, x1 = o[4 * j + 2 * half + 1] / den;
      const size_t at = (((size_t)b * a.Sq + q0 + r) * a.H + h) * D + 8 * j + 2 * (lane & 3);
      *reinterpret_cast<__nv_bfloat162*>(out + at) = __floats2bfloat162_rn(x0, x1);
      if (a.o32 != nullptr) *reinterpret_cast<float2*>(a.o32 + at) = make_float2(x0, x1);
    }
  // a row that sees no key keeps m = NEG_INF: its lse stays about -1e30,
  // and the backward masks all of its probabilities to 0 anyway
  if (a.lse != nullptr && (lane & 3) == 0) {
    const size_t at = ((size_t)b * a.H + h) * a.Sq + q0;
    if (v0) a.lse[at + r0] = m0 * LN2 + logf(den0);
    if (v1) a.lse[at + r1] = m1 * LN2 + logf(den1);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, register tiles
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(F_NT) spa_fwd_f32(const __grid_constant__ Args a) {
  using L = F32Layout<D>;
  constexpr int BK = L::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  const uint32_t sb = smem_u32(sm);
  float* ps = reinterpret_cast<float*>(sm + L::P);
  int* kp_s = reinterpret_cast<int*>(sm + L::KP);
  int* kg_s = reinterpret_cast<int*>(sm + L::KG);
  int* qp_s = reinterpret_cast<int*>(sm + L::QP);
  int* qg_s = reinterpret_cast<int*>(sm + L::QG);
  uint8_t* map = sm + L::MAP;

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int hk = h / (a.H / a.Hkv);
  const int nq = min(BQ, a.Sq - q0);
  const int nkt = (a.Skv + BK - 1) / BK;
  stage_f32<D, BQ, F_NT>(sb + L::Q, head_rows<float, D>(a.q, b, q0, nq, a.Sq, a.H, h), a.q);
  block_setup<BK, F_NT>(a, b, q0, nq, qp_s, qg_s, reinterpret_cast<int*>(sm + L::RED), map);
  auto prefetch = [&](int t, int st) {
    stage_kv_f32<D, BK, F_NT>(a.k, a.v, a.kvpos, a.kvseg, a.Skv, a.Hkv, b, hk, t,
                              sb + L::K + st * L::KB, sb + L::V + st * L::KB, kp_s + st * BK,
                              kg_s + st * BK);
  };

  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  int qp[F_NI], qg[F_NI];
  bool vr[F_NI];
  float m[F_NI], l[F_NI], o[F_NI][D / 8];
#pragma unroll
  for (int i = 0; i < F_NI; ++i) {
    const int r = ty + F_RS * i;
    vr[i] = r < nq;
    qp[i] = qp_s[r];
    qg[i] = qg_s[r];
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) o[i][c] = 0.f;
  }
  const float* qs = reinterpret_cast<const float*>(sm + L::Q);

  int t = next_live(map, -1, nkt), st = 0;
  if (t < nkt) prefetch(t, 0);
  cp_async_commit();
  while (t < nkt) {
    const int tn = next_live(map, t, nkt);
    if (tn < nkt) prefetch(tn, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const float* ks = reinterpret_cast<const float*>(sm + L::K + st * L::KB);
    const float* vs = reinterpret_cast<const float*>(sm + L::V + st * L::KB);
    const int* kp = kp_s + st * BK;
    const int* kg = kg_s + st * BK;
    const bool full = map[t] == FULL;   // read before the products
    float s[F_NI][4];
#pragma unroll
    for (int i = 0; i < F_NI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    f32_nt<D>(qs, ks, s);
    softmax_tile_f32<D>(s, o, ps, full, [&](int i, int c) {
      return vr[i] && visible(qp[i], qg[i], kp[c], kg[c], a.window);
    }, a.scale, m, l);
    __syncwarp();                    // a row's P was written by its own warp
    f32_nn<D>(ps, vs, o);
    __syncthreads();
    t = tn;
    st ^= 1;
  }
  cp_async_wait<0>();

  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < F_NI; ++i) {
#pragma unroll
    for (int x = 1; x <= 4; x <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], x);
    if (!vr[i]) continue;
    const int r = ty + F_RS * i;
    const float den = fmaxf(l[i], 1e-30f);
    const size_t at = (((size_t)b * a.Sq + q0 + r) * a.H + h) * D;
#pragma unroll
    for (int mm = 0; mm < D / 32; ++mm)
      *reinterpret_cast<float4*>(out + at + 4 * tx + 32 * mm) =
          make_float4(o[i][4 * mm] / den, o[i][4 * mm + 1] / den, o[i][4 * mm + 2] / den,
                      o[i][4 * mm + 3] / den);
    if (a.lse != nullptr && tx == 0) a.lse[((size_t)b * a.H + h) * a.Sq + q0 + r] = m[i] + logf(den);
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t smem, const Args& a, int B,
                   cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.H, (a.Sq + BQ - 1) / BQ, B), threads, smem, stream>>>(a);
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
  Args a{q, k, v,
         static_cast<const int*>(qpos), static_cast<const int*>(kvpos),
         static_cast<const int*>(qseg), static_cast<const int*>(kvseg),
         out, static_cast<float*>(lse), static_cast<float*>(o32),
         Sq, Skv, H, Hkv, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && (D == 64 || D == 128)) {
    cudaError_t err = head_map(&a.tk, k, B, Skv, Hkv, D, Bf16Layout<128>::BK);
    if (err == cudaSuccess) err = head_map(&a.tv, v, B, Skv, Hkv, D, Bf16Layout<128>::BK);
    if (err != cudaSuccess) return err;
  }
  if (dtype == 0 && D == 64) return launch(spa_fwd_f32<64>, F_NT, F32Layout<64>::bytes(Skv), a, B, st);
  if (dtype == 0 && D == 128) return launch(spa_fwd_f32<128>, F_NT, F32Layout<128>::bytes(Skv), a, B, st);
  if (dtype == 1 && D == 64) return launch(spa_fwd_bf16<64>, NT, Bf16Layout<64>::bytes(Skv), a, B, st);
  if (dtype == 1 && D == 128) return launch(spa_fwd_bf16<128>, NT, Bf16Layout<128>::bytes(Skv), a, B, st);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Block-sparse shared-prompt flash attention, backward (training).
//
// The gradient of the forward in spa_attention.cu, which replaces the Pallas
// TPU kernel `spa_attention` of src/repro/kernels/spa_attention.py:104. That
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
// Three launches on the caller's stream (the FlashAttention-2 split):
//   1. delta_kernel: one warp per (row, query, head) row of dO and O;
//   2. bwd_tiles, one grid of two kinds of block:
//      dq: one block per (64-query tile, query head, batch row), walking the
//      KV tiles its queries see;
//      dkdv: one block per (64-key tile, query head, batch row), walking the
//      query tiles that see its keys; it writes this head's part of dk and
//      dv, unrounded, to f32 scratch of shape (B, Skv, H, D) that the
//      wrapper allocates;
//   3. sum_heads: dk and dv of each KV head = the sum of its G query heads'
//      parts in the order g = 0 .. G-1, rounded once.
// No atomics: every sum runs in a fixed order, so two launches on the same
// inputs give bitwise-equal gradients.
//
// What bounds it on an H100: five products over the visible (query, key)
// pairs, 10 D flops per pair and head: 16.1 GFLOP at the 1024-token prompt
// (H 24, D 128), 16.3 us at the bf16 tensor-core peak, against 12 MB of
// bytes (3.7 us), plus the f32 scratch's 25 MB written and read once (15
// us at 3.35 TB/s, the price of summing without atomics); at the f32
// training shape (prompt 120 + 8 x 65) 2.7 GFLOP, 40 us at the 67 TFLOP/s
// f32 peak. What the design does:
//   * bf16 on the tensor cores (wgmma m64n64k16 for S and dP from shared
//     memory, m64nDk16 with the register-A form for the three gradient
//     products); P and dS are split into bf16 hi + lo and both halves go
//     through the product, since either rounded once to bf16 would miss the
//     one-ulp gradient bar on 5 to 10 % of the elements;
//   * f32 on the CUDA cores with the forward's register tiles (no TF32);
//   * the dk/dv grid has one block per query head, not per KV head (240
//     blocks at the training shape, 3 times the KV-head grid), and each
//     block streams whole query tiles through its products instead of one
//     query at a time;
//   * Q/dO (dkdv) and K/V (dq) tiles go through a two-stage ring, copied by
//     the Tensor Memory Accelerator for bf16 (one thread, an mbarrier per
//     stage) and by cp.async for f32; dead tiles are mapped from positions
//     and segments before any of their rows is read, and never staged;
//     tiles whose every pair is visible skip the per-element mask;
//   * dq and dk/dv blocks share one launch, longest first, so dq blocks fill
//     the SMs beside the long dk/dv blocks of an SPA row's prompt keys.
#include <algorithm>

#include "attn_tiles.cuh"

namespace {

using namespace repro::tiles;
using repro::NEG_INF;
using bf16 = __nv_bfloat16;

constexpr int NT = 128;      // bf16: one warpgroup
constexpr int BR = 64;       // rows a block owns: queries (dq) or keys (dkdv)
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void *q, *k, *v;
  const int *qpos, *kvpos, *qseg, *kvseg;
  const float *o32, *lse;
  const void* dout;
  float *delta, *dkp, *dvp;
  void *dq, *dk, *dv;
  int Sq, Skv, H, Hkv, window;
  float scale;
  CUtensorMap tk, tv, tq, tg;  // bf16: K, V (KV heads) and Q, dO (query heads), 64-row boxes
};

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
struct DqBf16 {
  static constexpr int BK = 64;
  static constexpr uint32_t TILE = BK * D * 2;
  static constexpr uint32_t Q = 0, G = TILE, K = 2 * TILE, V = K + 2 * TILE, KP = V + 2 * TILE,
                            KG = KP + 2 * BK * 4, QP = KG + 2 * BK * 4, QG = QP + BR * 4,
                            RED = QG + BR * 4, BAR = RED + 32 * 4, MAP = BAR + 2 * 8;
  static size_t bytes(int Skv) { return 1024 + MAP + 2 * ((Skv + BK - 1) / BK); }
};

template <int D>
struct DqF32 {
  static constexpr int BK = F_COLS, LD = D + 4;
  static constexpr uint32_t QB = BR * LD * 4, KB = BK * LD * 4;
  static constexpr uint32_t Q = 0, G = QB, K = 2 * QB, V = K + 2 * KB, DS = V + 2 * KB,
                            KP = DS + BR * F_PLD * 4, KG = KP + 2 * BK * 4, QP = KG + 2 * BK * 4,
                            QG = QP + BR * 4, RED = QG + BR * 4, MAP = RED + 32 * 4;
  static size_t bytes(int Skv) { return 1024 + MAP + 2 * ((Skv + BK - 1) / BK); }
};

template <int D>
__device__ __forceinline__ void dq_bf16(const Args& a, uint8_t* sm, int h, int tile, int b) {
  using L = DqBf16<D>;
  constexpr int BK = L::BK;
  const uint32_t sb = smem_u32(sm);
  int* kp_s = reinterpret_cast<int*>(sm + L::KP);
  int* kg_s = reinterpret_cast<int*>(sm + L::KG);
  int* qp_s = reinterpret_cast<int*>(sm + L::QP);
  int* qg_s = reinterpret_cast<int*>(sm + L::QG);
  uint8_t* map = sm + L::MAP;

  const int q0 = tile * BR;
  const int hk = h / (a.H / a.Hkv);
  const int nq = min(BR, a.Sq - q0);
  const int nkt = (a.Skv + BK - 1) / BK;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::BAR);   // one per stage
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    fence_mbar_init();
  }
  stage_bf16<D, BR, NT>(sb + L::Q, head_rows<bf16, D>(a.q, b, q0, nq, a.Sq, a.H, h), a.q);
  stage_bf16<D, BR, NT>(sb + L::G, head_rows<bf16, D>(a.dout, b, q0, nq, a.Sq, a.H, h), a.dout);
  Side qs;
  map_tiles<BK, NT>(
      a.Skv, a.kvpos + (size_t)b * a.Skv, a.kvseg + (size_t)b * a.Skv,
      [&] {
        qs = own_rows<NT>(a.qpos + (size_t)b * a.Sq + q0, a.qseg + (size_t)b * a.Sq + q0, nq, BR,
                            -1, qp_s, qg_s, reinterpret_cast<int*>(sm + L::RED));
      },
      [&](int kp, int kg) { return key_seen(kp, kg, qp_s, qg_s, qs, a.window); },
      [&](int kp, int kg) { return key_seen_by_all(kp, kg, qs, a.window); }, map);
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
  const size_t stat = ((size_t)b * a.H + h) * a.Sq + q0;
  const float ls0 = v0 ? a.lse[stat + r0] * LOG2E : 0.f, ls1 = v1 ? a.lse[stat + r1] * LOG2E : 0.f;
  const float dl0 = v0 ? a.delta[stat + r0] : 0.f, dl1 = v1 ? a.delta[stat + r1] : 0.f;
  const float sl2 = a.scale * LOG2E;
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  int t = next_live(map, -1, nkt), st = 0;
  if (t < nkt) prefetch(t, 0);
  cp_async_commit();
  while (t < nkt) {
    const int tn = next_live(map, t, nkt);
    if (tn < nkt) prefetch(tn, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    mbar_wait(bar + st, (phase >> st) & 1u);                  // the TMA tiles
    phase ^= 1u << st;
    fence_async_smem();            // tiles staged by cp.async are read by wgmma
    __syncthreads();

    const uint32_t kt = sb + L::K + st * L::TILE;
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wg_fence();
    wgmma_scores<D>(s, sb + L::Q, kt);
    wgmma_scores<D>(dp, sb + L::G, sb + L::V + st * L::TILE);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const int* kp = kp_s + st * BK;
    const int* kg = kg_s + st * BK;
    const bool full = map[t] == FULL;  // every pair visible: no mask
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = frag_col(i);
      const bool hi_row = (i >> 1) & 1;
      const bool ok = full || (hi_row ? v1 && visible(qp1, qg1, kp[c], kg[c], a.window)
                                      : v0 && visible(qp0, qg0, kp[c], kg[c], a.window));
      const float p = ok ? ex2(fmaf(s[i], sl2, -(hi_row ? ls1 : ls0))) : 0.f;
      s[i] = p * (dp[i] - (hi_row ? dl1 : dl0));        // dS
    }
    uint32_t hi[4][4], lo[4][4];
    split_hi_lo(s, hi, lo);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dq, hi[kk], desc_mn(kt, BK, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dq, lo[kk], desc_mn(kt, BK, kk));
    wg_commit();
    wg_wait<0>();
    fence_regs(dq);
    fence_regs(hi);
    fence_regs(lo);
    __syncthreads();
    t = tn;
    st ^= 1;
  }
  cp_async_wait<0>();

  bf16* out = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (!(half ? v1 : v0)) continue;
      const size_t at = (((size_t)b * a.Sq + q0 + (half ? r1 : r0)) * a.H + h) * D + 8 * j +
                        2 * (lane & 3);
      *reinterpret_cast<__nv_bfloat162*>(out + at) = __floats2bfloat162_rn(
          dq[4 * j + 2 * half] * a.scale, dq[4 * j + 2 * half + 1] * a.scale);
    }
}

template <int D>
__device__ __forceinline__ void dq_f32(const Args& a, uint8_t* sm, int h, int tile, int b) {
  using L = DqF32<D>;
  constexpr int BK = L::BK;
  const uint32_t sb = smem_u32(sm);
  float* dss = reinterpret_cast<float*>(sm + L::DS);
  int* kp_s = reinterpret_cast<int*>(sm + L::KP);
  int* kg_s = reinterpret_cast<int*>(sm + L::KG);
  int* qp_s = reinterpret_cast<int*>(sm + L::QP);
  int* qg_s = reinterpret_cast<int*>(sm + L::QG);
  uint8_t* map = sm + L::MAP;

  const int q0 = tile * BR;
  const int hk = h / (a.H / a.Hkv);
  const int nq = min(BR, a.Sq - q0);
  const int nkt = (a.Skv + BK - 1) / BK;
  stage_f32<D, BR, F_NT>(sb + L::Q, head_rows<float, D>(a.q, b, q0, nq, a.Sq, a.H, h), a.q);
  stage_f32<D, BR, F_NT>(sb + L::G, head_rows<float, D>(a.dout, b, q0, nq, a.Sq, a.H, h), a.dout);
  Side qs;
  map_tiles<BK, F_NT>(
      a.Skv, a.kvpos + (size_t)b * a.Skv, a.kvseg + (size_t)b * a.Skv,
      [&] {
        qs = own_rows<F_NT>(a.qpos + (size_t)b * a.Sq + q0, a.qseg + (size_t)b * a.Sq + q0, nq, BR,
                            -1, qp_s, qg_s, reinterpret_cast<int*>(sm + L::RED));
      },
      [&](int kp, int kg) { return key_seen(kp, kg, qp_s, qg_s, qs, a.window); },
      [&](int kp, int kg) { return key_seen_by_all(kp, kg, qs, a.window); }, map);
  auto prefetch = [&](int t, int st) {
    stage_kv_f32<D, BK, F_NT>(a.k, a.v, a.kvpos, a.kvseg, a.Skv, a.Hkv, b, hk, t,
                              sb + L::K + st * L::KB, sb + L::V + st * L::KB, kp_s + st * BK,
                              kg_s + st * BK);
  };

  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  int qp[F_NI], qg[F_NI];
  bool vr[F_NI];
  float ls[F_NI], dl[F_NI], dq[F_NI][D / 8];
  const size_t stat = ((size_t)b * a.H + h) * a.Sq + q0;
#pragma unroll
  for (int i = 0; i < F_NI; ++i) {
    const int r = ty + F_RS * i;
    vr[i] = r < nq;
    qp[i] = qp_s[r];
    qg[i] = qg_s[r];
    ls[i] = vr[i] ? a.lse[stat + r] : 0.f;
    dl[i] = vr[i] ? a.delta[stat + r] : 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) dq[i][c] = 0.f;
  }
  const float* qsm = reinterpret_cast<const float*>(sm + L::Q);
  const float* gsm = reinterpret_cast<const float*>(sm + L::G);

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
    const bool full = map[t] == FULL;
    float s[F_NI][4], dp[F_NI][4];
#pragma unroll
    for (int i = 0; i < F_NI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    f32_nt<D>(qsm, ks, s);
    f32_nt<D>(gsm, vs, dp);
#pragma unroll
    for (int i = 0; i < F_NI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 8 * j;
        const bool ok = full || (vr[i] && visible(qp[i], qg[i], kp[c], kg[c], a.window));
        const float p = ok ? expf(s[i][j] * a.scale - ls[i]) : 0.f;
        dss[(ty + F_RS * i) * F_PLD + c] = p * (dp[i][j] - dl[i]);
      }
    __syncwarp();                    // a row's dS was written by its own warp
    f32_nn<D>(dss, ks, dq);
    __syncthreads();
    t = tn;
    st ^= 1;
  }
  cp_async_wait<0>();

  float* out = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < F_NI; ++i) {
    if (!vr[i]) continue;
    const size_t at = (((size_t)b * a.Sq + q0 + ty + F_RS * i) * a.H + h) * D;
#pragma unroll
    for (int mm = 0; mm < D / 32; ++mm)
      *reinterpret_cast<float4*>(out + at + 4 * tx + 32 * mm) =
          make_float4(dq[i][4 * mm] * a.scale, dq[i][4 * mm + 1] * a.scale,
                      dq[i][4 * mm + 2] * a.scale, dq[i][4 * mm + 3] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// 3. dk, dv: this query head's part, f32, to scratch (B, Skv, H, D)
// ---------------------------------------------------------------------------
template <int D>
struct DkvBf16 {
  static constexpr int BQ = 64;
  static constexpr uint32_t TILE = BQ * D * 2;
  static constexpr uint32_t K = 0, V = TILE, Q = 2 * TILE, G = Q + 2 * TILE, QP = G + 2 * TILE,
                            QG = QP + 2 * BQ * 4, LS = QG + 2 * BQ * 4, DL = LS + 2 * BQ * 4,
                            KP = DL + 2 * BQ * 4, KG = KP + BR * 4, RED = KG + BR * 4,
                            BAR = RED + 32 * 4, MAP = BAR + 2 * 8;
  static size_t bytes(int Sq) { return 1024 + MAP + 2 * ((Sq + BQ - 1) / BQ); }
};

template <int D>
struct DkvF32 {
  static constexpr int BQ = F_COLS, LD = D + 4;
  static constexpr uint32_t RB = BR * LD * 4, CB = BQ * LD * 4, SB = BR * F_PLD * 4;
  static constexpr uint32_t K = 0, V = RB, Q = 2 * RB, G = Q + 2 * CB, PT = G + 2 * CB,
                            DST = PT + SB, QP = DST + SB, QG = QP + 2 * BQ * 4,
                            LS = QG + 2 * BQ * 4, DL = LS + 2 * BQ * 4, KP = DL + 2 * BQ * 4,
                            KG = KP + BR * 4, RED = KG + BR * 4, MAP = RED + 32 * 4;
  static size_t bytes(int Sq) { return 1024 + MAP + 2 * ((Sq + BQ - 1) / BQ); }
};

// Query tile t of query head h into stage st: Q and dO rows, positions,
// segments, log-sum-exp and delta (both dkdv kernels).
template <int BQ>
__device__ __forceinline__ void stage_q_meta(const Args& a, int b, int h, int t, int* qp_s,
                                             int* qg_s, float* ls_s, float* dl_s) {
  const int q0 = t * BQ, nq = min(BQ, a.Sq - q0);
  const size_t stat = ((size_t)b * a.H + h) * a.Sq + q0;
  stage_meta(qp_s, a.qpos + (size_t)b * a.Sq + q0, BQ, nq, 0);
  stage_meta(qg_s, a.qseg + (size_t)b * a.Sq + q0, BQ, nq, -1);
  stage_meta(ls_s, a.lse + stat, BQ, nq, 0.f);
  stage_meta(dl_s, a.delta + stat, BQ, nq, 0.f);
}

// The f32 dkdv kernel's query tile t: Q and dO rows by cp.async into padded
// tiles, and its metadata.
template <int D, int BQ, int NTHREADS>
__device__ __forceinline__ void stage_q_f32(const Args& a, int b, int h, int t, uint32_t qdst,
                                            uint32_t gdst, int* qp_s, int* qg_s, float* ls_s,
                                            float* dl_s) {
  const int q0 = t * BQ, nq = min(BQ, a.Sq - q0);
  stage_f32<D, BQ, NTHREADS>(qdst, head_rows<float, D>(a.q, b, q0, nq, a.Sq, a.H, h), a.q);
  stage_f32<D, BQ, NTHREADS>(gdst, head_rows<float, D>(a.dout, b, q0, nq, a.Sq, a.H, h),
                             a.dout);
  stage_q_meta<BQ>(a, b, h, t, qp_s, qg_s, ls_s, dl_s);
}

template <int D>
__device__ __forceinline__ void dkdv_bf16(const Args& a, uint8_t* sm, int h, int tile, int b) {
  using L = DkvBf16<D>;
  constexpr int BQ = L::BQ;
  const uint32_t sb = smem_u32(sm);
  int* qp_s = reinterpret_cast<int*>(sm + L::QP);
  int* qg_s = reinterpret_cast<int*>(sm + L::QG);
  float* ls_s = reinterpret_cast<float*>(sm + L::LS);
  float* dl_s = reinterpret_cast<float*>(sm + L::DL);
  int* kp_s = reinterpret_cast<int*>(sm + L::KP);
  int* kg_s = reinterpret_cast<int*>(sm + L::KG);
  uint8_t* map = sm + L::MAP;

  const int k0 = tile * BR;
  const int hk = h / (a.H / a.Hkv);
  const int nk = min(BR, a.Skv - k0);
  const int nqt = (a.Sq + BQ - 1) / BQ;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::BAR);   // one per stage
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    fence_mbar_init();
  }
  stage_bf16<D, BR, NT>(sb + L::K, head_rows<bf16, D>(a.k, b, k0, nk, a.Skv, a.Hkv, hk), a.k);
  stage_bf16<D, BR, NT>(sb + L::V, head_rows<bf16, D>(a.v, b, k0, nk, a.Skv, a.Hkv, hk), a.v);
  Side ks;
  map_tiles<BQ, NT>(
      a.Sq, a.qpos + (size_t)b * a.Sq, a.qseg + (size_t)b * a.Sq,
      [&] {
        ks = own_rows<NT>(a.kvpos + (size_t)b * a.Skv + k0, a.kvseg + (size_t)b * a.Skv + k0, nk,
                            BR, -2, kp_s, kg_s, reinterpret_cast<int*>(sm + L::RED));
      },
      [&](int qp, int qg) { return query_sees(qp, qg, kp_s, kg_s, ks, a.window); },
      [&](int qp, int qg) { return query_sees_all(qp, qg, ks, a.window); }, map);
  // Q/dO by TMA (one thread), the rest of the query tile by cp.async
  auto prefetch = [&](int t, int st) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar + st, 2 * L::TILE);
      tma_tile<D, BQ>(sb + L::Q + st * L::TILE, &a.tq, bar + st, t * BQ, h, b);
      tma_tile<D, BQ>(sb + L::G + st * L::TILE, &a.tg, bar + st, t * BQ, h, b);
    }
    stage_q_meta<BQ>(a, b, h, t, qp_s + st * BQ, qg_s + st * BQ, ls_s + st * BQ, dl_s + st * BQ);
  };
  uint32_t phase = 0;              // bit s: parity of stage s's next completion

  const int lane = threadIdx.x & 31;
  const int r0 = frag_row(0), r1 = r0 + 8;   // this thread's keys
  const bool v0 = r0 < nk, v1 = r1 < nk;
  const int kp0 = kp_s[r0], kg0 = kg_s[r0], kp1 = kp_s[r1], kg1 = kg_s[r1];
  const float sl2 = a.scale * LOG2E;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  int t = next_live(map, -1, nqt), st = 0;
  if (t < nqt) prefetch(t, 0);
  cp_async_commit();
  while (t < nqt) {
    const int tn = next_live(map, t, nqt);
    if (tn < nqt) prefetch(tn, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    mbar_wait(bar + st, (phase >> st) & 1u);                  // the TMA tiles
    phase ^= 1u << st;
    fence_async_smem();            // tiles staged by cp.async are read by wgmma
    __syncthreads();

    const uint32_t qt = sb + L::Q + st * L::TILE, gt = sb + L::G + st * L::TILE;
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wg_fence();
    wgmma_scores<D>(s, sb + L::K, qt);       // S^T = K Q^T
    wgmma_scores<D>(dp, sb + L::V, gt);      // dP^T = V dO^T
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const int q0 = t * BQ;
    const int* qp = qp_s + st * BQ;
    const int* qg = qg_s + st * BQ;
    const float* ls = ls_s + st * BQ;
    const float* dl = dl_s + st * BQ;
    const bool full = map[t] == FULL;  // every pair visible: no mask
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = frag_col(i);               // query q0 + c
      const bool hi_row = (i >> 1) & 1;
      const bool ok = full || (q0 + c < a.Sq &&
                               (hi_row ? v1 && visible(qp[c], qg[c], kp1, kg1, a.window)
                                       : v0 && visible(qp[c], qg[c], kp0, kg0, a.window)));
      const float p = ok ? ex2(fmaf(s[i], sl2, -ls[c] * LOG2E)) : 0.f;
      dp[i] = p * (dp[i] - dl[c]);             // dS^T
      s[i] = p;                                // P^T
    }
    uint32_t phi[4][4], plo[4][4], dhi[4][4], dlo[4][4];
    split_hi_lo(s, phi, plo);
    split_hi_lo(dp, dhi, dlo);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dv, phi[kk], desc_mn(gt, BQ, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dv, plo[kk], desc_mn(gt, BQ, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dk, dhi[kk], desc_mn(qt, BQ, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dk, dlo[kk], desc_mn(qt, BQ, kk));
    wg_commit();
    wg_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(phi);
    fence_regs(plo);
    fence_regs(dhi);
    fence_regs(dlo);
    __syncthreads();
    t = tn;
    st ^= 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (!(half ? v1 : v0)) continue;
      const size_t at = (((size_t)b * a.Skv + k0 + (half ? r1 : r0)) * a.H + h) * D + 8 * j +
                        2 * (lane & 3);
      *reinterpret_cast<float2*>(a.dkp + at) = make_float2(dk[4 * j + 2 * half], dk[4 * j + 2 * half + 1]);
      *reinterpret_cast<float2*>(a.dvp + at) = make_float2(dv[4 * j + 2 * half], dv[4 * j + 2 * half + 1]);
    }
}

template <int D>
__device__ __forceinline__ void dkdv_f32(const Args& a, uint8_t* sm, int h, int tile, int b) {
  using L = DkvF32<D>;
  constexpr int BQ = L::BQ;
  const uint32_t sb = smem_u32(sm);
  float* pts = reinterpret_cast<float*>(sm + L::PT);
  float* dsts = reinterpret_cast<float*>(sm + L::DST);
  int* qp_s = reinterpret_cast<int*>(sm + L::QP);
  int* qg_s = reinterpret_cast<int*>(sm + L::QG);
  float* ls_s = reinterpret_cast<float*>(sm + L::LS);
  float* dl_s = reinterpret_cast<float*>(sm + L::DL);
  int* kp_s = reinterpret_cast<int*>(sm + L::KP);
  int* kg_s = reinterpret_cast<int*>(sm + L::KG);
  uint8_t* map = sm + L::MAP;

  const int k0 = tile * BR;
  const int hk = h / (a.H / a.Hkv);
  const int nk = min(BR, a.Skv - k0);
  const int nqt = (a.Sq + BQ - 1) / BQ;
  stage_f32<D, BR, F_NT>(sb + L::K, head_rows<float, D>(a.k, b, k0, nk, a.Skv, a.Hkv, hk), a.k);
  stage_f32<D, BR, F_NT>(sb + L::V, head_rows<float, D>(a.v, b, k0, nk, a.Skv, a.Hkv, hk), a.v);
  Side ks;
  map_tiles<BQ, F_NT>(
      a.Sq, a.qpos + (size_t)b * a.Sq, a.qseg + (size_t)b * a.Sq,
      [&] {
        ks = own_rows<F_NT>(a.kvpos + (size_t)b * a.Skv + k0, a.kvseg + (size_t)b * a.Skv + k0, nk,
                            BR, -2, kp_s, kg_s, reinterpret_cast<int*>(sm + L::RED));
      },
      [&](int qp, int qg) { return query_sees(qp, qg, kp_s, kg_s, ks, a.window); },
      [&](int qp, int qg) { return query_sees_all(qp, qg, ks, a.window); }, map);
  auto prefetch = [&](int t, int st) {
    stage_q_f32<D, BQ, F_NT>(a, b, h, t, sb + L::Q + st * L::CB, sb + L::G + st * L::CB,
                          qp_s + st * BQ, qg_s + st * BQ, ls_s + st * BQ, dl_s + st * BQ);
  };

  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  int kp[F_NI], kg[F_NI];
  bool vk[F_NI];
  float dk[F_NI][D / 8], dv[F_NI][D / 8];
#pragma unroll
  for (int i = 0; i < F_NI; ++i) {
    const int r = ty + F_RS * i;
    vk[i] = r < nk;
    kp[i] = kp_s[r];
    kg[i] = kg_s[r];
#pragma unroll
    for (int c = 0; c < D / 8; ++c) dk[i][c] = dv[i][c] = 0.f;
  }
  const float* ksm = reinterpret_cast<const float*>(sm + L::K);
  const float* vsm = reinterpret_cast<const float*>(sm + L::V);

  int t = next_live(map, -1, nqt), st = 0;
  if (t < nqt) prefetch(t, 0);
  cp_async_commit();
  while (t < nqt) {
    const int tn = next_live(map, t, nqt);
    if (tn < nqt) prefetch(tn, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const float* qs = reinterpret_cast<const float*>(sm + L::Q + st * L::CB);
    const float* gs = reinterpret_cast<const float*>(sm + L::G + st * L::CB);
    const int q0 = t * BQ;
    const int* qp = qp_s + st * BQ;
    const int* qg = qg_s + st * BQ;
    const float* ls = ls_s + st * BQ;
    const float* dl = dl_s + st * BQ;
    const bool full = map[t] == FULL;
    float s[F_NI][4], dp[F_NI][4];
#pragma unroll
    for (int i = 0; i < F_NI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    f32_nt<D>(ksm, qs, s);           // S^T = K Q^T
    f32_nt<D>(vsm, gs, dp);          // dP^T = V dO^T
#pragma unroll
    for (int i = 0; i < F_NI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 8 * j;
        const bool ok = full || (vk[i] && q0 + c < a.Sq &&
                                 visible(qp[c], qg[c], kp[i], kg[i], a.window));
        const float p = ok ? expf(s[i][j] * a.scale - ls[c]) : 0.f;
        pts[(ty + F_RS * i) * F_PLD + c] = p;
        dsts[(ty + F_RS * i) * F_PLD + c] = p * (dp[i][j] - dl[c]);
      }
    __syncwarp();                    // a key row's P^T and dS^T came from its own warp
    f32_nn<D>(pts, gs, dv);
    f32_nn<D>(dsts, qs, dk);
    __syncthreads();
    t = tn;
    st ^= 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < F_NI; ++i) {
    if (!vk[i]) continue;
    const size_t at = (((size_t)b * a.Skv + k0 + ty + F_RS * i) * a.H + h) * D;
#pragma unroll
    for (int mm = 0; mm < D / 32; ++mm) {
      const int c = 4 * tx + 32 * mm;
      *reinterpret_cast<float4*>(a.dkp + at + c) =
          make_float4(dk[i][4 * mm], dk[i][4 * mm + 1], dk[i][4 * mm + 2], dk[i][4 * mm + 3]);
      *reinterpret_cast<float4*>(a.dvp + at + c) =
          make_float4(dv[i][4 * mm], dv[i][4 * mm + 1], dv[i][4 * mm + 2], dv[i][4 * mm + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// 4. dk, dv = the G query heads' parts, summed in order and rounded once
// ---------------------------------------------------------------------------
__device__ __forceinline__ void store4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }
__device__ __forceinline__ void store4(bf16* p, float4 x) {
  reinterpret_cast<__nv_bfloat162*>(p)[0] = __floats2bfloat162_rn(x.x, x.y);
  reinterpret_cast<__nv_bfloat162*>(p)[1] = __floats2bfloat162_rn(x.z, x.w);
}

template <typename T>
__global__ void sum_heads(const float* __restrict__ dkp, const float* __restrict__ dvp,
                          T* __restrict__ dk, T* __restrict__ dv, long n4, int G, int D,
                          float scale) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const long e = 4 * i;                      // element of (B, Skv, Hkv, D)
  const long row = e / D;                    // (b * Skv + j) * Hkv + hk
  const int d = (int)(e % D);
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int g = 0; g < G; ++g) {              // query head hk * G + g
    const long at = (row * G + g) * D + d;
    const float4 x = *reinterpret_cast<const float4*>(dkp + at);
    const float4 y = *reinterpret_cast<const float4*>(dvp + at);
    sk.x += x.x; sk.y += x.y; sk.z += x.z; sk.w += x.w;
    sv.x += y.x; sv.y += y.y; sv.z += y.z; sv.w += y.w;
  }
  store4(dk + e, make_float4(sk.x * scale, sk.y * scale, sk.z * scale, sk.w * scale));
  store4(dv + e, sv);
}

// dq and dk/dv in one launch: blocks x < H take dk/dv of key tile y, blocks
// x >= H dq of query tile (number of query tiles - 1 - y). Causal work
// shrinks with the key tile and grows with the query tile, so the blocks
// launched first (low y) are the longest of both kinds; a dq block runs
// beside a long dk/dv block instead of after the whole dk/dv grid (the
// prompt's key tiles of an SPA row see every query tile).
template <typename T, int D>
__global__ void __launch_bounds__(NT) bwd_tiles(const __grid_constant__ Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  const int y = blockIdx.y, b = blockIdx.z;
  const int nqt = (a.Sq + BR - 1) / BR, nkt = (a.Skv + BR - 1) / BR;
  if ((int)blockIdx.x < a.H) {
    if (y >= nkt) return;
    if constexpr (sizeof(T) == 2) dkdv_bf16<D>(a, sm, blockIdx.x, y, b);
    else dkdv_f32<D>(a, sm, blockIdx.x, y, b);
  } else {
    if (y >= nqt) return;
    if constexpr (sizeof(T) == 2) dq_bf16<D>(a, sm, blockIdx.x - a.H, nqt - 1 - y, b);
    else dq_f32<D>(a, sm, blockIdx.x - a.H, nqt - 1 - y, b);
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, int B, cudaStream_t st) {
  constexpr bool BF = sizeof(T) == 2;
  const long rows = (long)B * a.Sq * a.H;
  constexpr int WARPS = 8;
  delta_kernel<T, D><<<(unsigned)((rows + WARPS - 1) / WARPS), 32 * WARPS, 0, st>>>(
      static_cast<const T*>(a.dout), a.o32, a.delta, a.Sq, a.H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem = BF ? std::max(DqBf16<D>::bytes(a.Skv), DkvBf16<D>::bytes(a.Sq))
                        : std::max(DqF32<D>::bytes(a.Skv), DkvF32<D>::bytes(a.Sq));
  err = cudaFuncSetAttribute(bwd_tiles<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (std::max(a.Sq, a.Skv) + BR - 1) / BR;
  bwd_tiles<T, D><<<dim3(2 * a.H, tiles, B), NT, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long n4 = (long)B * a.Skv * a.Hkv * D / 4;
  sum_heads<T><<<(unsigned)((n4 + 255) / 256), 256, 0, st>>>(
      a.dkp, a.dvp, static_cast<T*>(a.dk), static_cast<T*>(a.dv), n4, a.H / a.Hkv, D, a.scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. window <= 0: no window. o32 (B,Sq,H,D)
// and lse (B,H,Sq) are the forward's f32 output and log-sum-exp; delta
// (B,H,Sq) and dkp, dvp (B,Skv,H,D), all f32, are scratch. dq is
// (B,Sq,H,D), dk and dv (B,Skv,Hkv,D), in the dtype of q.
int spa_attention_bwd_launch(const void* q, const void* k, const void* v,
                             const void* qpos, const void* kvpos, const void* qseg,
                             const void* kvseg, const void* o32, const void* lse,
                             const void* dout, void* delta, void* dkp, void* dvp, void* dq,
                             void* dk, void* dv, int B, int Sq, int Skv, int H, int Hkv, int D,
                             int dtype, int window, float scale, void* stream) {
  Args a{q, k, v,
         static_cast<const int*>(qpos), static_cast<const int*>(kvpos),
         static_cast<const int*>(qseg), static_cast<const int*>(kvseg),
         static_cast<const float*>(o32), static_cast<const float*>(lse), dout,
         static_cast<float*>(delta), static_cast<float*>(dkp), static_cast<float*>(dvp),
         dq, dk, dv, Sq, Skv, H, Hkv, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && (D == 64 || D == 128)) {   // 64-row boxes: DqBf16::BK, DkvBf16::BQ
    cudaError_t err = head_map(&a.tk, k, B, Skv, Hkv, D, 64);
    if (err == cudaSuccess) err = head_map(&a.tv, v, B, Skv, Hkv, D, 64);
    if (err == cudaSuccess) err = head_map(&a.tq, q, B, Sq, H, D, 64);
    if (err == cudaSuccess) err = head_map(&a.tg, dout, B, Sq, H, D, 64);
    if (err != cudaSuccess) return err;
  }
  if (dtype == 0 && D == 64) return launch<float, 64>(a, B, st);
  if (dtype == 0 && D == 128) return launch<float, 128>(a, B, st);
  if (dtype == 1 && D == 64) return launch<bf16, 64>(a, B, st);
  if (dtype == 1 && D == 128) return launch<bf16, 128>(a, B, st);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

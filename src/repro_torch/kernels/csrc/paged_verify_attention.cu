// Flash attention of S query tokens per row over a paged KV pool, each token
// masked by its own position: the spec-decode verify block (S = k+1) and the
// radix cache's warm suffix prefill (S = the bucketed suffix).
//
// Replaces the Pallas TPU kernel `paged_verify_attention` in
// src/repro/kernels/decode_attention.py:262 (`_gather_pages` ->
// `verify_attention` -> `_flash_rows` -> body `_kernel`); the contiguous
// `verify_attention` (:138) launches it through a one-page-per-row view.
// Rows are flattened as the JAX kernel flattens them: R = S * G query rows
// per (row, KV head), s-major and g-minor, so query row r is token s = r / G
// of query head hk * G + r % G and carries that token's position. Mask:
// kv_pos <= q_pos [&& q_pos - kv_pos < window]; the null page 0 and every
// unwritten slot carry pos 2^30, so they are masked for live tokens (a
// token at pos 2^30, a masked slot of the verify block, sees every slot,
// as in JAX).
//
// R ranges from 15 (spec verify of llama3.2-3b: S 5, G 3) to thousands (a
// suffix prefill), and what bounds the kernel changes with it, so the
// wrapper picks one of two regimes by R (splits > 0: the first):
//   * small R (R <= 64): bound by the bytes of K/V, like decode. The
//     Split-L kernel of splitl.cuh: the context split over blocks, each
//     block's rows sharing every K/V row it reads, keys no row sees never
//     read, per-warp cp.async rings, f32 partials merged in split order;
//   * large R: bound by operations (the 512-token suffix prefill over 1024
//     keys is 4.8 GFLOP against 6 MB). Query tiles of 64 flattened rows, so
//     the G heads of a token share each K/V tile, over 64-key (bf16) or
//     32-key (f32) tiles; a bf16 block runs two such tiles, one warpgroup
//     each, on every K/V tile it stages (half the gathers from L2, and one
//     warpgroup's softmax beside the other's products); the context is
//     split (the same partials and combine) only when the grid would
//     leave most SMs idle. Before any K/V is read, the block maps which keys
//     some row sees (positions only) into per-key bits: a dead tile is
//     skipped (a suffix tile skips every tile past its last position), a
//     full tile (every pair visible) skips the mask, and an unseen key of a
//     live tile is zero-filled, not read. K/V rows are gathered from the
//     pages by cp.async (one row pointer per key, so the page-table walk
//     needs no TMA) into a two-stage ring: the next live tile is in flight
//     while the current one computes. bf16 runs both products on the
//     tensor cores (wgmma from the 128-byte-swizzled tiles, P fed as a bf16
//     hi + lo pair: rounded once it misses the bf16 bar); f32 stays on the
//     CUDA cores in register tiles (no TF32). The tile code is the SPA
//     forward's (attn_tiles.cuh).
#include "splitl.cuh"

namespace {

using namespace repro::tiles;
using repro::NEG_INF;
using repro::splitl::UNSEEN;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;       // query rows per warpgroup (f32: per block)
constexpr int WGS = 2;       // bf16: warpgroups per block, sharing each K/V tile
constexpr int NT = 128 * WGS;
constexpr float LOG2E = 1.4426950408889634f;

struct TArgs {
  const void *q, *k, *v;
  const int *pos_pages, *page_table, *q_pos;
  void* out;
  float *part_acc, *part_ml;   // (splits, B*S*H, D) and (splits, B*S*H, 2) above 1 split
  int B, S, H, Hkv, page, n_max, window, splits;
  int ks;                      // keys per split (the wrapper's plan), a multiple of 64
  float scale;
};

// The key range of a block's split, its page-table entries and live-key
// words (shared memory after the tiles): their bytes for ks keys a split.
inline size_t keys_bytes(int ks, int page) {
  return 8 * (size_t)((ks + 31) / 32) + 4 * (size_t)((ks + page - 1) / page + 1);
}

// bf16 layout (byte offsets from a 1024-aligned base): Q (the block's
// WGS * 64 rows), K[2], V[2] swizzled tiles, positions, then the split's
// key bits and page table.
template <int D>
struct Bf16Layout {
  static constexpr int BK = 64, ROWS = WGS * BQ;
  static constexpr uint32_t TILE = BK * D * 2;
  static constexpr uint32_t Q = 0, K = WGS * TILE, V = K + 2 * TILE, KP = V + 2 * TILE,
                            QP = KP + 2 * BK * 4, RED = QP + ROWS * 4, W = RED + 64 * 4;
  static size_t bytes(int ks, int page) { return 1024 + W + keys_bytes(ks, page); }
};

// f32 layout: padded Q, K[2], V[2] tiles and a P tile, then the same.
template <int D>
struct F32Layout {
  static constexpr int BK = F_COLS, LD = D + 4;
  static constexpr uint32_t QB = BQ * LD * 4, KB = BK * LD * 4;
  static constexpr uint32_t Q = 0, K = QB, V = K + 2 * KB, P = V + 2 * KB,
                            KP = P + BQ * F_PLD * 4, QP = KP + 2 * BK * 4, RED = QP + BQ * 4,
                            W = RED + 32 * 4;
  static size_t bytes(int ks, int page) { return 1024 + W + keys_bytes(ks, page); }
};

// What a block of query tile q0 .. q0 + nq - 1 knows of its split's keys
// k0 .. k1 - 1 of row b: its page-table entries and two bits per key
// (seen by some row of the tile, seen by every row).
struct Keys {
  const int* tab;              // entries from k0 / page
  const uint32_t *seen_w, *all_w;
  int page, k0, k1, e0, nwords;
  __device__ int slot(int j) const { return tab[j / page - e0] * page + j % page; }
  __device__ bool seen(int j) const {
    return j < k1 && ((seen_w[(j - k0) >> 5] >> ((j - k0) & 31)) & 1u);
  }
  // 0 dead, 1 live, 2 full for the split's key tile t of BK keys
  template <int BK>
  __device__ int state(int t) const {
    bool any = false, all = true;
#pragma unroll
    for (int w = 0; w < BK / 32; ++w) {
      const int i = t * (BK / 32) + w;
      const bool in = i < nwords;
      any = any || (in && seen_w[i] != 0u);
      all = all && in && all_w[i] == 0xffffffffu;
    }
    return any ? (all ? 2 : 1) : 0;
  }
  template <int BK>
  __device__ int next_live(int t, int ntiles) const {
    for (++t; t < ntiles && state<BK>(t) == 0; ++t) {}
    return t;
  }
};

// Rows' positions (first ROWS threads) into qp_s, the split's page-table
// entries and the key bits into `words`; every thread calls it; ends with
// __syncthreads.
template <int NTH, int ROWS>
__device__ __forceinline__ Keys map_keys(const TArgs& a, int b, int q0, int nq, int split,
                                         int* qp_s, int* red, uint8_t* words) {
  const int G = a.H / a.Hkv, Lk = a.n_max * a.page;
  const int k0 = split * a.ks, k1 = min(Lk, k0 + a.ks);
  const int nwords = k1 > k0 ? (k1 - k0 + 31) / 32 : 0;
  const int e0 = k0 / a.page, ne = k1 > k0 ? (k1 - 1) / a.page - e0 + 1 : 0;
  uint32_t* seen_w = reinterpret_cast<uint32_t*>(words);
  uint32_t* all_w = seen_w + nwords;
  int* tab = reinterpret_cast<int*>(all_w + nwords);
  const int i = threadIdx.x, lane = i & 31;
  const bool ok = i < nq;
  const int p = ok ? a.q_pos[(size_t)b * a.S + (q0 + i) / G] : -1;
  if (i < ROWS) qp_s[i] = p;
  for (int e = i; e < ne; e += NTH) tab[e] = a.page_table[(size_t)b * a.n_max + e0 + e];
  const Side qs = side_of_rows<NTH>(p, 0, ok, nq, red);
  const Keys keys{tab, seen_w, all_w, a.page, k0, k1, e0, nwords};
  const int window = a.window;
  const auto seen = [&](int kp) -> bool {
    if (kp > qs.pmax) return false;
    if (window <= 0) return true;            // the row at pmax sees it
    if (qs.pmin - kp >= window) return false;
    for (int r = 0; r < nq; ++r)
      if (visible(qp_s[r], 0, kp, 0, window)) return true;
    return false;
  };
  constexpr int U = 4;
  for (int base = 0; base < nwords * 32; base += NTH * U) {
    int kp[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = k0 + base + u * NTH + i;
      kp[u] = j < k1 ? __ldg(a.pos_pages + keys.slot(j)) : UNSEEN;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int off = base + u * NTH + (i & ~31);
      const bool in = kp[u] != UNSEEN;
      const unsigned s = __ballot_sync(0xffffffffu, in && seen(kp[u]));
      const unsigned f = __ballot_sync(0xffffffffu, in && key_seen_by_all(kp[u], 0, qs, window));
      if (lane == 0 && off < nwords * 32) {
        seen_w[off >> 5] = s;
        all_w[off >> 5] = f;
      }
    }
  }
  __syncthreads();
  return keys;
}

// K or V rows of the split's key tile t by cp.async, gathered through the
// page table: NTH / BK threads per key, one slot lookup each; bf16 into the
// 128-byte-swizzled layout, f32 into rows of D + 4 floats. Keys no row
// sees are zero rows, never read. With kp, the keys' positions go there
// too (UNSEEN for those keys).
template <typename T, int D, int BK, int NTH>
__device__ __forceinline__ void stage_tile(const TArgs& a, const void* pool, const Keys& keys,
                                           int hk, int t, uint32_t dst, int* kp) {
  constexpr int CPR = D * (int)sizeof(T) / 16;      // 16-byte chunks per row
  constexpr int TPK = NTH / BK;                      // threads per key
  static_assert(NTH % BK == 0 && CPR % TPK == 0, "tile does not split evenly");
  const int c = threadIdx.x / TPK, part = threadIdx.x % TPK;
  const int j = keys.k0 + t * BK + c;
  const bool live = keys.seen(j);
  const int slot = live ? keys.slot(j) : 0;
  const char* src = static_cast<const char*>(pool) + ((size_t)slot * a.Hkv + hk) * D * sizeof(T);
#pragma unroll
  for (int u = 0; u < CPR / TPK; ++u) {
    const int ch = part + TPK * u;
    const uint32_t off = sizeof(T) == 2 ? sw128(BK, c, ch) : (uint32_t)((c * (D + 4) + ch * 4) * 4);
    cp_async16(dst + off, src + ch * 16, live);
  }
  if (kp != nullptr && part == 0) {
    if (live) cp_async4(smem_u32(kp + c), a.pos_pages + slot);
    else kp[c] = UNSEEN;
  }
}

// ---------------------------------------------------------------------------
// large R, bf16: tensor cores
// ---------------------------------------------------------------------------
// Two warpgroups, 64 query rows each, share every K/V tile a block stages:
// the tiles move from L2 once per 128 rows, and one warpgroup's softmax
// runs beside the other's products. The next live tile is in flight while
// the current one computes.
template <int D>
__global__ void __launch_bounds__(NT) verify_tiles_bf16(const __grid_constant__ TArgs a) {
  using L = Bf16Layout<D>;
  constexpr int BK = L::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  const uint32_t sb = smem_u32(sm);
  int* kp_s = reinterpret_cast<int*>(sm + L::KP);
  int* qp_s = reinterpret_cast<int*>(sm + L::QP);

  const int hk = blockIdx.y, b = blockIdx.z, split = blockIdx.x % a.splits;
  const int G = a.H / a.Hkv, R = a.S * G;
  const int q0 = (gridDim.x / a.splits - 1 - blockIdx.x / a.splits) * L::ROWS;   // longest first
  const int nq = min(L::ROWS, R - q0);
  const auto row_off = [&](int r) -> size_t {
    return (((size_t)b * a.S + r / G) * a.H + hk * G + r % G) * D;
  };
  const bf16* q = static_cast<const bf16*>(a.q);
  stage_bf16<D, L::ROWS, NT>(sb + L::Q, [&](int i) -> const bf16* {
    return i < nq ? q + row_off(q0 + i) : nullptr;
  }, a.q);
  const Keys keys = map_keys<NT, L::ROWS>(a, b, q0, nq, split, qp_s,
                                          reinterpret_cast<int*>(sm + L::RED), sm + L::W);
  const int ntiles = (keys.nwords * 32 + BK - 1) / BK;
  auto prefetch = [&](int t, int st) {
    stage_tile<bf16, D, BK, NT>(a, a.k, keys, hk, t, sb + L::K + st * L::TILE, kp_s + st * BK);
    stage_tile<bf16, D, BK, NT>(a, a.v, keys, hk, t, sb + L::V + st * L::TILE, nullptr);
  };

  // this warpgroup's rows wr .. wr + 63 of the block (Q rows at the same
  // offset of the 128-row swizzled tile, 8-row groups 1024-byte aligned)
  const int lane = threadIdx.x & 31, wr = BQ * (threadIdx.x / 128);
  const uint32_t qt = sb + L::Q + wr * 128;
  const int fr0 = wr + frag_row(0), fr1 = fr0 + 8;
  const bool v0 = fr0 < nq, v1 = fr1 < nq;
  const int qp0 = qp_s[fr0], qp1 = qp_s[fr1];
  const float sl2 = a.scale * LOG2E;     // scores in log2 units: exp2
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  int t = keys.next_live<BK>(-1, ntiles), st = 0;
  if (t < ntiles) prefetch(t, 0);
  cp_async_commit();
  while (t < ntiles) {
    const int tn = keys.next_live<BK>(t, ntiles);
    if (tn < ntiles) prefetch(tn, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();            // Q and tile t have landed
    fence_async_smem();            // cp.async writes are read by wgmma
    __syncthreads();

    float s[32];
    wg_fence();
    wgmma_scores<D>(s, qt, sb + L::K + st * L::TILE, L::ROWS);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    const int* kp = kp_s + st * BK;
    softmax_tile<D>(s, o, keys.state<BK>(t) == 2, [&](int c, bool hi) {
      return hi ? v1 && visible(qp1, 0, kp[c], 0, a.window)
                : v0 && visible(qp0, 0, kp[c], 0, a.window);
    }, sl2, m0, m1, l0, l1);
    wgmma_pv<D>(o, s, sb + L::V + st * L::TILE);
    __syncthreads();               // stage st is free for the next prefetch
    t = tn;
    st ^= 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  // one split: the output; more: f32 partials (m in log2 units, l, acc;
  // no acc where l is 0), merged by splitl.cuh's combine kernel
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  const size_t rows_total = (size_t)a.B * a.S * a.H;
  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!(half ? v1 : v0)) continue;
    const size_t off = row_off(q0 + (half ? fr1 : fr0));
    const size_t prow = (size_t)split * rows_total + off / D;
    const float l = half ? l1 : l0;
    if (a.splits > 1 && (lane & 3) == 0) {
      a.part_ml[2 * prow] = half ? m1 : m0;
      a.part_ml[2 * prow + 1] = l;
    }
    if (a.splits > 1 && l == 0.f) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      const float y0 = o[4 * j + 2 * half], y1 = o[4 * j + 2 * half + 1];
      if (a.splits > 1) {
        *reinterpret_cast<float2*>(a.part_acc + prow * D + col) = make_float2(y0, y1);
      } else {
        const float den = half ? den1 : den0;
        *reinterpret_cast<__nv_bfloat162*>(out + off + col) = __floats2bfloat162_rn(y0 / den, y1 / den);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// large R, f32: CUDA cores, register tiles
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(F_NT) verify_tiles_f32(const __grid_constant__ TArgs a) {
  using L = F32Layout<D>;
  constexpr int BK = L::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  const uint32_t sb = smem_u32(sm);
  float* ps = reinterpret_cast<float*>(sm + L::P);
  int* kp_s = reinterpret_cast<int*>(sm + L::KP);
  int* qp_s = reinterpret_cast<int*>(sm + L::QP);

  const int hk = blockIdx.y, b = blockIdx.z, split = blockIdx.x % a.splits;
  const int G = a.H / a.Hkv, R = a.S * G;
  const int q0 = (gridDim.x / a.splits - 1 - blockIdx.x / a.splits) * BQ;
  const int nq = min(BQ, R - q0);
  const auto row_off = [&](int r) -> size_t {
    return (((size_t)b * a.S + r / G) * a.H + hk * G + r % G) * D;
  };
  const float* q = static_cast<const float*>(a.q);
  stage_f32<D, BQ, F_NT>(sb + L::Q, [&](int i) -> const float* {
    return i < nq ? q + row_off(q0 + i) : nullptr;
  }, a.q);
  const Keys keys = map_keys<F_NT, BQ>(a, b, q0, nq, split, qp_s,
                                   reinterpret_cast<int*>(sm + L::RED), sm + L::W);
  const int ntiles = (keys.nwords * 32 + BK - 1) / BK;
  auto prefetch = [&](int t, int st) {
    stage_tile<float, D, BK, F_NT>(a, a.k, keys, hk, t, sb + L::K + st * L::KB, kp_s + st * BK);
    stage_tile<float, D, BK, F_NT>(a, a.v, keys, hk, t, sb + L::V + st * L::KB, nullptr);
  };

  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  int qp[F_NI];
  bool vr[F_NI];
  float m[F_NI], l[F_NI], o[F_NI][D / 8];
#pragma unroll
  for (int i = 0; i < F_NI; ++i) {
    const int r = ty + F_RS * i;
    vr[i] = r < nq;
    qp[i] = qp_s[r];
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) o[i][c] = 0.f;
  }
  const float* qs = reinterpret_cast<const float*>(sm + L::Q);

  int t = keys.next_live<BK>(-1, ntiles), st = 0;
  if (t < ntiles) prefetch(t, 0);
  cp_async_commit();
  while (t < ntiles) {
    const int tn = keys.next_live<BK>(t, ntiles);
    if (tn < ntiles) prefetch(tn, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const float* ks = reinterpret_cast<const float*>(sm + L::K + st * L::KB);
    const float* vs = reinterpret_cast<const float*>(sm + L::V + st * L::KB);
    const int* kp = kp_s + st * BK;
    const bool full = keys.state<BK>(t) == 2;   // read before the products
    float s[F_NI][4];
#pragma unroll
    for (int i = 0; i < F_NI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    f32_nt<D>(qs, ks, s);
    softmax_tile_f32<D>(s, o, ps, full, [&](int i, int c) {
      return vr[i] && visible(qp[i], 0, kp[c], 0, a.window);
    }, a.scale, m, l);
    __syncwarp();                    // a row's P was written by its own warp
    f32_nn<D>(ps, vs, o);
    __syncthreads();
    t = tn;
    st ^= 1;
  }
  cp_async_wait<0>();

  // one split: the output; more: f32 partials (m in log2 units)
  const size_t rows_total = (size_t)a.B * a.S * a.H;
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < F_NI; ++i) {
#pragma unroll
    for (int x = 1; x <= 4; x <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], x);
    if (!vr[i]) continue;
    const size_t at = row_off(q0 + ty + F_RS * i);
    const float den = a.splits > 1 ? 1.f : fmaxf(l[i], 1e-30f);
    float* dst = out + at;
    if (a.splits > 1) {
      const size_t prow = (size_t)split * rows_total + at / D;
      if (tx == 0) {
        a.part_ml[2 * prow] = m[i] * LOG2E;
        a.part_ml[2 * prow + 1] = l[i];
      }
      if (l[i] == 0.f) continue;
      dst = a.part_acc + prow * D;
    }
#pragma unroll
    for (int mm = 0; mm < D / 32; ++mm)
      *reinterpret_cast<float4*>(dst + 4 * tx + 32 * mm) =
          make_float4(o[i][4 * mm] / den, o[i][4 * mm + 1] / den, o[i][4 * mm + 2] / den,
                      o[i][4 * mm + 3] / den);
  }
}

template <typename T, int D, typename Kernel>
cudaError_t launch_tiles(Kernel kernel, int threads, size_t smem, TArgs a, cudaStream_t stream) {
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int R = a.S * (a.H / a.Hkv), rows = sizeof(T) == 2 ? WGS * BQ : BQ;
  kernel<<<dim3((R + rows - 1) / rows * a.splits, a.Hkv, a.B), threads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  return repro::splitl::combine<T, D>(a.part_acc, a.part_ml, a.out, a.B * a.S * a.H, a.splits,
                                      stream);
}

// tiles == 0: the Split-L regime; else the query-tile regime, whose splits
// are runs of ks keys, whole 64-key tiles covering n_max * page.
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* pos, const int* table,
                   const int* qpos, void* out, float* part_acc, float* part_ml, int B, int S,
                   int H, int Hkv, int page, int n_max, int window, int splits, int ks, int tiles,
                   float scale, cudaStream_t st) {
  if (splits > 1 && (part_acc == nullptr || part_ml == nullptr)) return cudaErrorInvalidValue;
  if (!tiles) {
    const repro::splitl::Args a{q, k, v, pos, table, qpos, out, part_acc, part_ml,
                                B, S, H, Hkv, page, n_max, window, splits, ks, scale * LOG2E};
    return repro::splitl::launch<T, D>(a, st);
  }
  if (ks < 64 || ks % 64 != 0 || (long long)ks * splits < (long long)n_max * page)
    return cudaErrorInvalidValue;
  const TArgs a{q, k, v, pos, table, qpos, out, part_acc, part_ml,
                B, S, H, Hkv, page, n_max, window, splits, ks, scale};
  if constexpr (sizeof(T) == 2)
    return launch_tiles<T, D>(verify_tiles_bf16<D>, NT, Bf16Layout<D>::bytes(a.ks, page), a, st);
  else
    return launch_tiles<T, D>(verify_tiles_f32<D>, F_NT, F32Layout<D>::bytes(a.ks, page), a, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. window <= 0: no window. tiles: 0 the
// Split-L regime, 1 the query-tile regime. splits >= 1 context splits of
// ks keys each (the wrapper's plan: a multiple of 32, of 64 for tiles);
// above 1, part_acc (splits, B*S*H, D) and part_ml (splits, B*S*H, 2) are
// f32 scratch the wrapper allocated.
int paged_verify_attention_launch(const void* q, const void* k_pages, const void* v_pages,
                                  const void* pos_pages, const void* page_table,
                                  const void* q_pos, void* out, void* part_acc, void* part_ml,
                                  int B, int S, int H, int Hkv, int D, int page, int n_max,
                                  int dtype, int window, int splits, int ks, int tiles, float scale,
                                  void* stream) {
  if (Hkv < 1 || H % Hkv != 0 || S < 1 || B < 1 || page < 1 || n_max < 1 || splits < 1)
    return cudaErrorInvalidValue;
  const int* pp = static_cast<const int*>(pos_pages);
  const int* pt = static_cast<const int*>(page_table);
  const int* qp = static_cast<const int*>(q_pos);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k_pages, v_pages, pp, pt, qp, out, pa, pm, B, S, H, Hkv, page, n_max, window, splits, ks, tiles, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k_pages, v_pages, pp, pt, qp, out, pa, pm, B, S, H, Hkv, page, n_max, window, splits, ks, tiles, scale, st);
  if (dtype == 1 && D == 64)
    return launch<bf16, 64>(q, k_pages, v_pages, pp, pt, qp, out, pa, pm, B, S, H, Hkv, page, n_max, window, splits, ks, tiles, scale, st);
  if (dtype == 1 && D == 128)
    return launch<bf16, 128>(q, k_pages, v_pages, pp, pt, qp, out, pa, pm, B, S, H, Hkv, page, n_max, window, splits, ks, tiles, scale, st);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

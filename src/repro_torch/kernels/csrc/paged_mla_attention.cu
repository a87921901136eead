// Absorbed MLA attention over a paged LATENT pool: S query tokens per row
// (S == 1 a decode step, S == k+1 the spec verify block), each masked by its
// own position.
//
// Replaces the Pallas TPU kernels `paged_mla_decode_attention` (:277) and
// `paged_mla_verify_attention` (:301) in src/repro/kernels/decode_attention.py
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
// What bounds it on an H100. 16 query rows (the H heads of a token) share
// every latent row, so a visible key costs (r + rd) elements read and
// 2 * 16 * (Dk + Dv) operations: about 30 operations per byte in bf16 at
// full width (r 512, rd 64), above the CUDA cores' ridge (67 TFLOP/s over
// 3.35 TB/s = 20) and far below the tensor cores' (295). So bf16 is bound
// by the latent bytes only if its products run on the tensor cores; f32
// (15 operations per byte) stays near its CUDA-core ridge. At the phase-2
// shapes: serving decode (B 4, contexts 64-1088, 2.7 MB of latent rows)
// and the spec verify block (B 4, S 5) are far too small to fill the card
// and are bound by latency (two launches, the prologue, a few tiles);
// B 16 with contexts to 8k reads 85 MB (0.025 ms at 3.35 TB/s) and is
// bound by bytes. The design:
//   * Split-L: grid (splits, row groups, B). Each block takes one row
//     group of 16 query rows (decode: the 16 heads; verify: one token's
//     16 heads at H 16) and one contiguous run of the row's keys, as the
//     wrapper's plan says (`mla_plan`: two blocks per SM in one wave where
//     the context allows; 256 to 1024 keys a split, fewer only where the
//     call is too small to be bound by bytes). A split writes f32 partials
//     (m, l, acc) and `splitl.cuh`'s combine kernel merges them in split
//     order (no atomics: two launches give the same bits); one split
//     writes the output directly;
//   * the block first scans its keys' positions (page table walked in the
//     kernel; the loads go out before the rows' positions are read) into a
//     live-key bit map and per-key slots; a 32-key tile no row of the group
//     sees is never read, and a dead key of a live tile is staged as zeros
//     (stale NaNs in unwritten slots stay out);
//   * each latent row is read once: ckv and kr land side by side in one
//     staged row [ckv | kr] by 16-byte cp.async, into a two-stage ring of
//     32-key tiles, so the next tile's copy is in flight while a tile
//     computes (bf16: about 90 KB of shared memory, two blocks per SM).
//     Warp w copies keys 8 w .. 8 w + 7, the rows' 16-byte chunks spread
//     over its lanes with no per-chunk branch or division (a flat chunk
//     loop, divided per chunk, took a large share of the loop's
//     instructions). TMA bulk copies of each row part, completing on
//     per-stage mbarriers, were no faster on the H100, so cp.async stays;
//   * bf16 runs both products on the tensor cores (mma.sync m16n8k16, f32
//     accumulators; 16 rows are exactly one m16 tile, so decode wastes no
//     row, where wgmma's 64-row tiles would be three-quarters empty). The
//     scores are split over the four warps by k steps: each warp keeps its
//     query fragments in registers for the whole split and scores all 32
//     keys over its quarter of Dk; the partial sums meet in shared memory
//     (added in warp order), the row maxima too, and each warp then owns
//     Dv / 4 output columns for P V over the 32 keys (MLA's wide V split
//     over warps keeps a thread's accumulators at 64 registers). P is fed
//     as a bf16 hi + lo pair (rounded once, P misses the bf16 bar in some
//     outputs: tests/test_torch_kernels.py); a warp whose rows kept their
//     maxima skips the rescale;
//   * f32 runs on the CUDA cores in register tiles (no TF32): each warp
//     scores its 8 keys over all Dk, then owns Dv / 4 columns of P V.
//     f32 accumulation, one rounding at the output.
// What is left (timed with variants that leave one part out; PERF.md):
// at B 16 with contexts to 8k the products alone take about as long as
// the copies alone, mma.sync far below the card's dense bf16 rate, and
// the two overlap only in part; a block's
// prologue and epilogue and the separate combine add a fixed cost. wgmma
// with the keys as its 64 rows (S^T = K Q^T) is the way to cut the
// products.
#include "splitl.cuh"

namespace {

using repro::NEG_INF;
using repro::tiles::cp_async16;
using repro::tiles::cp_async_commit;
using repro::tiles::cp_async_wait;
using repro::tiles::ex2;
using repro::tiles::smem_u32;

constexpr int NW = 4;                 // warps
constexpr int NT = 32 * NW;           // threads
constexpr int BK = 32;                // keys per tile: one live word
constexpr int KW = BK / NW;           // keys a warp scores
constexpr int RB = 16;                // query rows per block
constexpr int NSTAGE = 2;             // ring stages (bf16: two blocks share an SM)
constexpr int UNSEEN = 0x7fffffff;    // position given to a key no row sees
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void *q, *ckv, *kr;
  const int *pos_pages, *page_table, *q_pos;
  void* out;
  float *part_acc, *part_ml;   // (splits, B*S*H, r) and (splits, B*S*H, 2); unused at 1 split
  int B, S, H, page, n_max, window, splits;
  int ks;                      // keys per split (the wrapper's plan), a multiple of BK
  float sl2;                   // scale * log2(e): scores in log2 units
};

// Dynamic shared memory (byte offsets; every region 16-byte aligned). Staged
// latent rows and the queries have one 16-byte pad per row, so eight rows
// read at one column fall in eight distinct bank groups. bf16 reads the
// queries into registers before the first tile, so they are staged in the
// ring's last stage (which the first tile's copy overwrites later), and it
// keeps the warps' partial scores (SP); f32 keeps its queries in their own
// region throughout.
template <typename T, int R, int RD>
struct Layout {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int DK = R + RD;
  static constexpr int LD = DK + 16 / (int)sizeof(T);         // row stride, elements
  static constexpr int ROWB = LD * (int)sizeof(T);
  static constexpr int LDP = BF16 ? BK + 8 : BK + 4;          // P row stride, elements
  static constexpr uint32_t STAGEB = BK * ROWB;
  static constexpr uint32_t RING = 0;                           // NSTAGE stages
  static constexpr uint32_t Q = BF16 ? (NSTAGE - 1) * STAGEB : NSTAGE * STAGEB;
  static constexpr uint32_t SP = BF16 ? NSTAGE * STAGEB : Q + RB * ROWB;   // [NW][4][32] float4
  static constexpr uint32_t P = SP + (BF16 ? NW * 4 * 32 * 16 : 0);       // bf16: hi then lo
  static constexpr uint32_t RED = P + (BF16 ? 2 * RB * LDP * 2 : RB * LDP * 4);
  static constexpr uint32_t QP = RED + 2 * NW * RB * 4;         // row maxima, row sums
  static constexpr uint32_t KEYS = QP + RB * 4;
  static_assert(RB * ROWB <= STAGEB, "the queries do not fit a stage");
  static_assert(ROWB % 16 == 0 && Q % 16 == 0 && SP % 16 == 0 && P % 16 == 0 &&
                RED % 16 == 0 && KEYS % 16 == 0, "misaligned layout");
  // per key of the split: position (UNSEEN if no row sees it) and pool
  // slot; then one live word per tile
  static size_t bytes(int ks) { return KEYS + (size_t)ks * 8 + (size_t)(ks / BK) * 4; }
};

// ---------------------------------------------------------------------------
// Tensor-core fragments (mma.sync m16n8k16, bf16 in, f32 accumulators)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
// d += a (16 x 16, row-major) * b (16 x 8, column-major)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ bool sees(int qp, int kp, int window) {
  return kp <= qp && (window <= 0 || qp - kp < window);
}

// ---------------------------------------------------------------------------
// The per-dtype tile math. A Tile holds a thread's rows, running max and
// partial sums, and its output accumulators; score() computes the warp's
// raw scores of a staged tile and their row maxima (written to red), then
// update() turns them into probabilities (written to shared memory) and
// rescales the accumulators, and pv() adds P V over the tile's 32 keys.
// ---------------------------------------------------------------------------

template <typename T, int R, int RD> struct Tile;

// bf16: the scores of a tile are split over the warps by k steps (warp w
// takes k16 steps w, w + 4, ...: its query fragments stay in registers for
// the whole split, so no warp reads the queries again), each warp scoring
// all 32 keys; the four partial sums meet in shared memory, added in warp
// order. From there lane holds rows g = lane / 4 and g + 8 of the m16
// fragments; its keys are 8 w + 2 (lane % 4) + {0, 1}; its output columns
// are (R / 4) w + 8 j + 2 (lane % 4) + {0, 1} of n8 tile j.
template <int R, int RD>
struct Tile<__nv_bfloat16, R, RD> {
  using L = Layout<__nv_bfloat16, R, RD>;
  static constexpr bool PARTIAL = true;   // scores need a cross-warp sum
  static constexpr int CW = R / NW;       // output columns per warp
  static constexpr int NJ = CW / 8;       // n8 tiles per warp
  static constexpr int KS = L::DK / 16;   // k16 steps
  static constexpr int KPW = (KS + NW - 1) / NW;   // k steps per warp
  static_assert(CW % 16 == 0 && L::DK % 16 == 0 && BK == 32, "shape does not tile");
  float o[NJ][4];
  float m[2], l[2];
  int qp[2];
  float s[4];
  uint32_t qf[KPW][4];                    // this warp's query fragments

  __device__ void init(const uint8_t* sm, const int* qp_s) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = NEG_INF;
      l[h] = 0.f;
      qp[h] = qp_s[g + 8 * h];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    // A: rows (lane % 8) + 8 ((lane / 8) % 2), columns + 8 (lane / 16)
    const uint32_t qa = smem_u32(sm + L::Q) + ((lane & 7) + ((lane >> 3) & 1) * 8) * L::ROWB +
                        (lane >> 4) * 16;
#pragma unroll
    for (int j = 0; j < KPW; ++j)
      if (warp + NW * j < KS) ldsm_x4(qf[j], qa + (warp + NW * j) * 32);
  }

  // this warp's k steps of the scores of all 32 keys, to SP
  __device__ void score(uint8_t* sm, const uint8_t* stage) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    // B, two n8 tiles a load: keys 16 n + (lane % 8) + 8 (lane / 16),
    // columns + 8 ((lane / 8) % 2)
    const uint32_t kb = smem_u32(stage) + ((lane & 7) + ((lane >> 4) & 1) * 8) * L::ROWB +
                        ((lane >> 3) & 1) * 16;
    float sp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < KPW; ++j) {
      const int kk = warp + NW * j;
      if (kk < KS) {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t b[4];
          ldsm_x4(b, kb + np * 16 * L::ROWB + kk * 32);
          mma16816(sp[2 * np], qf[j], b[0], b[1]);
          mma16816(sp[2 * np + 1], qf[j], b[2], b[3]);
        }
      }
    }
    float4* part = reinterpret_cast<float4*>(sm + L::SP);
#pragma unroll
    for (int n = 0; n < 4; ++n)
      part[(warp * 4 + n) * 32 + lane] = make_float4(sp[n][0], sp[n][1], sp[n][2], sp[n][3]);
  }

  // the warps' partial scores of this warp's 8 keys, summed in warp order;
  // the mask, and the row maxima to red
  __device__ void reduce(const uint8_t* sm, const int* kp_tile, float* red, int window,
                         bool (&ok)[4]) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const float4* part = reinterpret_cast<const float4*>(sm + L::SP);
    float4 a = part[warp * 32 + lane];
#pragma unroll
    for (int w = 1; w < NW; ++w) {
      const float4 b = part[(w * 4 + warp) * 32 + lane];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    s[0] = a.x;
    s[1] = a.y;
    s[2] = a.z;
    s[3] = a.w;
    const int c = warp * KW + 2 * (lane & 3);
    const int kp0 = kp_tile[c], kp1 = kp_tile[c + 1];
    float mx[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ok[2 * h] = sees(qp[h], kp0, window);
      ok[2 * h + 1] = sees(qp[h], kp1, window);
      mx[h] = fmaxf(ok[2 * h] ? s[2 * h] : NEG_INF, ok[2 * h + 1] ? s[2 * h + 1] : NEG_INF);
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], x));
    }
    if ((lane & 3) == 0) {
      red[warp * RB + (lane >> 2)] = mx[0];
      red[warp * RB + (lane >> 2) + 8] = mx[1];
    }
  }

  __device__ void update(uint8_t* sm, const float* red, const bool (&ok)[4], float sl2) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
    __nv_bfloat16* ph = reinterpret_cast<__nv_bfloat16*>(sm + L::P);
    __nv_bfloat16* pl = ph + RB * L::LDP;
    const int c = warp * KW + 2 * (lane & 3);
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = g + 8 * h;
      float tmax = NEG_INF;
#pragma unroll
      for (int w = 0; w < NW; ++w) tmax = fmaxf(tmax, red[w * RB + row]);
      // the max commutes with the positive scale; a row that sees no key of
      // the tile keeps its max
      const float mn = tmax == NEG_INF ? m[h] : fmaxf(m[h], tmax * sl2);
      corr[h] = ex2(m[h] - mn);
      const float p0 = ok[2 * h] ? ex2(fmaf(s[2 * h], sl2, -mn)) : 0.f;
      const float p1 = ok[2 * h + 1] ? ex2(fmaf(s[2 * h + 1], sl2, -mn)) : 0.f;
      l[h] = l[h] * corr[h] + (p0 + p1);    // this lane's keys; summed at the end
      m[h] = mn;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      ph2(ph, row, c) = hi;
      ph2(pl, row, c) = __floats2bfloat162_rn(p0 - __low2float(hi), p1 - __high2float(hi));
    }
    // a warp whose rows kept their maxima skips the rescale
    if (__any_sync(FULL, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        o[j][0] *= corr[0];
        o[j][1] *= corr[0];
        o[j][2] *= corr[1];
        o[j][3] *= corr[1];
      }
    }
  }

  static __device__ __nv_bfloat162& ph2(__nv_bfloat16* p, int row, int c) {
    return *reinterpret_cast<__nv_bfloat162*>(p + row * L::LDP + c);
  }

  __device__ void pv(const uint8_t* sm, const uint8_t* stage) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const uint32_t ph = smem_u32(sm + L::P);
    const uint32_t pl = ph + RB * L::LDP * 2;
    const uint32_t pa = ((lane & 7) + ((lane >> 3) & 1) * 8) * L::LDP * 2 + (lane >> 4) * 16;
    // V (the staged rows' first R columns) read transposed: keys
    // (lane % 8) + 8 ((lane / 8) % 2), columns + 8 (lane / 16)
    const uint32_t vb = smem_u32(stage) + ((lane & 7) + ((lane >> 3) & 1) * 8) * L::ROWB +
                        (warp * CW + (lane >> 4) * 8) * 2;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ahi[4], alo[4];
      ldsm_x4(ahi, ph + pa + kk * 32);
      ldsm_x4(alo, pl + pa + kk * 32);
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        uint32_t b[4];
        ldsm_x4_t(b, vb + kk * 16 * L::ROWB + jp * 32);
        mma16816(o[2 * jp], ahi, b[0], b[1]);
        mma16816(o[2 * jp + 1], ahi, b[2], b[3]);
        mma16816(o[2 * jp], alo, b[0], b[1]);
        mma16816(o[2 * jp + 1], alo, b[2], b[3]);
      }
    }
  }

  // each warp's row sums of this lane's rows (its quad's keys) into lsum
  // [NW][RB]; warp 0 writes the row maxima (every warp holds the same) to mx
  __device__ void finish(float* lsum, float* mx) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) l[h] += __shfl_xor_sync(FULL, l[h], x);
      if ((lane & 3) == 0) {
        lsum[warp * RB + (lane >> 2) + 8 * h] = l[h];
        if (warp == 0) mx[(lane >> 2) + 8 * h] = m[h];
      }
    }
  }

  // f(row, column, value pair) for each of the lane's output pairs
  template <typename F>
  __device__ void each_out(F f) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        f((lane >> 2) + 8 * h, warp * CW + 8 * j + 2 * (lane & 3),
          make_float2(o[j][2 * h], o[j][2 * h + 1]));
  }
};

// f32: lane = 4 c + q4 holds rows q4 + 4 i (i < 4); its score key is
// 8 w + c; its output columns are (R / 4) w + V c + 8 V v + e (e < V,
// v < CPL / V), V = 4 (or 2 at the reduced width).
template <int R, int RD>
struct Tile<float, R, RD> {
  using L = Layout<float, R, RD>;
  static constexpr bool PARTIAL = false;  // each warp scores its own keys whole
  static constexpr int CW = R / NW;
  static constexpr int CPL = CW / 8;                // output columns per lane
  static constexpr int V = CPL < 4 ? CPL : 4;       // columns per vector
  static_assert(CW % 8 == 0 && CPL % V == 0 && (V == 2 || V == 4) && L::DK % 4 == 0,
                "shape does not tile");
  float o[4][CPL];
  float m[4], l[4];
  int qp[4];
  float s[4];

  __device__ void init(const uint8_t*, const int* qp_s) {
    const int q4 = threadIdx.x & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = NEG_INF;
      l[i] = 0.f;
      qp[i] = qp_s[q4 + 4 * i];
#pragma unroll
      for (int e = 0; e < CPL; ++e) o[i][e] = 0.f;
    }
  }

  __device__ void score(uint8_t* sm, const uint8_t* stage) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c = lane >> 2, q4 = lane & 3;
    const float* qs = reinterpret_cast<const float*>(sm + L::Q);
    const float* krow = reinterpret_cast<const float*>(stage + (warp * KW + c) * L::ROWB);
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < L::DK; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (q4 + 4 * i) * L::LD + d);
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
    }
  }

  __device__ void reduce(const uint8_t*, const int* kp_tile, float* red, int window,
                         bool (&ok)[4]) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c = lane >> 2, q4 = lane & 3;
    const int kp = kp_tile[warp * KW + c];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ok[i] = sees(qp[i], kp, window);
      float mx = ok[i] ? s[i] : NEG_INF;
      // a row's 8 key scores sit in the 8 lanes of one q4
#pragma unroll
      for (int x = 4; x < 32; x <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, x));
      if (c == 0) red[warp * RB + q4 + 4 * i] = mx;
    }
  }

  __device__ void update(uint8_t* sm, const float* red, const bool (&ok)[4], float sl2) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c = lane >> 2, q4 = lane & 3;
    float* ps = reinterpret_cast<float*>(sm + L::P);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q4 + 4 * i;
      float tmax = NEG_INF;
#pragma unroll
      for (int w = 0; w < NW; ++w) tmax = fmaxf(tmax, red[w * RB + row]);
      const float mn = tmax == NEG_INF ? m[i] : fmaxf(m[i], tmax * sl2);
      const float corr = ex2(m[i] - mn);
      const float p = ok[i] ? ex2(fmaf(s[i], sl2, -mn)) : 0.f;
      l[i] = l[i] * corr + p;
      m[i] = mn;
      ps[row * L::LDP + warp * KW + c] = p;
#pragma unroll
      for (int e = 0; e < CPL; ++e) o[i][e] *= corr;
    }
  }

  __device__ void pv(const uint8_t* sm, const uint8_t* stage) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, cg = lane >> 2, q4 = lane & 3;
    const float* ps = reinterpret_cast<const float*>(sm + L::P);
    const float* vt = reinterpret_cast<const float*>(stage) + warp * CW + V * cg;
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(ps + (q4 + 4 * i) * L::LDP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vr = vt + (c + cc) * L::LD;
#pragma unroll
        for (int v = 0; v < CPL / V; ++v) {
          float x[V];
          if constexpr (V == 4) {
            const float4 t = *reinterpret_cast<const float4*>(vr + 8 * V * v);
            x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(vr + 8 * V * v);
            x[0] = t.x; x[1] = t.y;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pc = cc == 0 ? p[i].x : cc == 1 ? p[i].y : cc == 2 ? p[i].z : p[i].w;
#pragma unroll
            for (int e = 0; e < V; ++e) o[i][V * v + e] = fmaf(pc, x[e], o[i][V * v + e]);
          }
        }
      }
    }
  }

  __device__ void finish(float* lsum, float* mx) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c = lane >> 2, q4 = lane & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int x = 4; x < 32; x <<= 1) l[i] += __shfl_xor_sync(FULL, l[i], x);
      if (c == 0) {
        lsum[warp * RB + q4 + 4 * i] = l[i];
        if (warp == 0) mx[q4 + 4 * i] = m[i];
      }
    }
  }

  template <typename F>
  __device__ void each_out(F f) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, cg = lane >> 2, q4 = lane & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int v = 0; v < CPL / V; ++v)
#pragma unroll
        for (int e = 0; e < V; e += 2)
          f(q4 + 4 * i, warp * CW + V * cg + 8 * V * v + e,
            make_float2(o[i][V * v + e], o[i][V * v + e + 1]));
  }
};

template <typename T> __device__ __forceinline__ void store2(T* p, float2 x);
template <> __device__ __forceinline__ void store2<float>(float* p, float2 x) {
  *reinterpret_cast<float2*>(p) = x;
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float2 x) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x.x, x.y);
}

// Block (split, row group, B): query rows r0 .. r0 + 15 of batch row b over
// keys [k0, k1) of its context.
template <typename T, int R, int RD>
__global__ void __launch_bounds__(NT, sizeof(T) == 2 ? 2 : 1)
paged_mla_kernel(const __grid_constant__ Args a) {
  using L = Layout<T, R, RD>;
  constexpr int DK = L::DK;
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int CKV = R / VEC, CPR = DK / VEC;    // 16-byte chunks: ckv, staged row
  static_assert(R % VEC == 0 && RD % VEC == 0, "rows are not whole 16-byte vectors");
  extern __shared__ __align__(16) uint8_t sm[];
  const uint32_t sb = smem_u32(sm);
  float* red = reinterpret_cast<float*>(sm + L::RED);    // [NW][RB] row maxima
  float* lsum = red + NW * RB;                           // [NW][RB] row sums
  int* qp_s = reinterpret_cast<int*>(sm + L::QP);
  int* kpos = reinterpret_cast<int*>(sm + L::KEYS);
  int* kslot = kpos + a.ks;
  uint32_t* live = reinterpret_cast<uint32_t*>(kslot + a.ks);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, b = blockIdx.z;
  const int Rq = a.S * a.H;
  const int r0 = blockIdx.y * RB, nrows = min(RB, Rq - r0);
  const int page = a.page, Lk = a.n_max * page;
  const int k0 = split * a.ks, k1 = min(Lk, k0 + a.ks);
  const int ntiles = k1 > k0 ? (k1 - k0 + BK - 1) / BK : 0;

  // the group's queries (rows past nrows zero), then the positions and
  // slots of the split's first keys (their loads need no query position, so
  // they go out before the rows' positions are read), then the rows'
  // positions (-1: no key)
  const T* q = static_cast<const T*>(a.q) + ((size_t)b * Rq + r0) * DK;
  for (int i = tid; i < RB * CPR; i += NT) {
    const int r = i / CPR, v = i % CPR;
    cp_async16(sb + L::Q + r * L::ROWB + v * 16, r < nrows ? (const void*)(q + r * DK + v * VEC) : a.q,
               r < nrows);
  }
  cp_async_commit();
  constexpr int U = 4;
  const int span = ntiles * BK;
  const int* table = a.page_table + (size_t)b * a.n_max;
  int kp[U], slot[U];
  const auto load_keys = [&](int base) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = k0 + base + u * NT + tid;
      slot[u] = j < k1 ? __ldg(table + j / page) * page + j % page : 0;
      kp[u] = j < k1 ? __ldg(a.pos_pages + slot[u]) : UNSEEN;
    }
  };
  load_keys(0);
  for (int i = tid; i < RB; i += NT)
    qp_s[i] = i < nrows ? a.q_pos[(size_t)b * a.S + (r0 + i) / a.H] : -1;
  __syncthreads();

  int qmax = -1;
  for (int i = 0; i < nrows; ++i) qmax = max(qmax, qp_s[i]);
  const auto seen = [&](int kp) -> bool {      // by some row of the group
    if (kp > qmax) return false;
    if (a.window <= 0) return true;
    for (int i = 0; i < nrows; ++i)
      if (sees(qp_s[i], kp, a.window)) return true;
    return false;
  };

  // the live map: bit c of word t = key k0 + 32 t + c is seen by some row
  for (int base = 0; base < span; base += NT * U) {
    if (base > 0) load_keys(base);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int off = base + u * NT + tid;
      const bool s = kp[u] != UNSEEN && seen(kp[u]);
      const unsigned word = __ballot_sync(FULL, s);
      if (off < span) {
        kpos[off] = s ? kp[u] : UNSEEN;
        kslot[off] = slot[u];
      }
      if (lane == 0 && off < span) live[off / BK] = word;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // tile t's latent rows [ckv | kr] into stage st: warp w copies the
  // tile's keys 8 w .. 8 w + 7, their ckv chunks and then their kr chunks
  // spread over the lanes (no lane idles while another copies; zero rows
  // for keys no row sees: nothing is read for them, and a key past the
  // context has slot 0, a mapped address)
  constexpr int CKR = RD / VEC;                   // 16-byte chunks of a kr row
  static_assert((CKV & (CKV - 1)) == 0 && (CKR & (CKR - 1)) == 0, "chunk counts are not powers of 2");
  const T* ckv = static_cast<const T*>(a.ckv);
  const T* kr = static_cast<const T*>(a.kr);
  const auto issue = [&](int t, int st) {
    const uint32_t dst0 = sb + L::RING + st * L::STAGEB + warp * KW * L::ROWB;
    const int key0 = t * BK + warp * KW;
#pragma unroll
    for (int u = 0; u < (KW * CKV + 31) / 32; ++u) {
      const int i = lane + 32 * u, k = i / CKV, j = i % CKV;
      if ((KW * CKV) % 32 == 0 || i < KW * CKV)
        cp_async16(dst0 + k * L::ROWB + j * 16, ckv + (size_t)kslot[key0 + k] * R + j * VEC,
                   kpos[key0 + k] != UNSEEN);
    }
#pragma unroll
    for (int u = 0; u < (KW * CKR + 31) / 32; ++u) {
      const int i = lane + 32 * u, k = i / CKR, j = i % CKR;
      if ((KW * CKR) % 32 == 0 || i < KW * CKR)
        cp_async16(dst0 + k * L::ROWB + (CKV + j) * 16, kr + (size_t)kslot[key0 + k] * RD + j * VEC,
                   kpos[key0 + k] != UNSEEN);
    }
  };
  const auto next_live = [&](int t) -> int {
    for (++t; t < ntiles && live[t] == 0u; ++t) {}
    return t;
  };

  Tile<T, R, RD> tile;
  tile.init(sm, qp_s);
  // the ring: tile cur computes from stage st while the next live tile's
  // copy is in flight into the other stage
  int cur = next_live(-1), st = 0;
  if (cur < ntiles) issue(cur, 0);
  cp_async_commit();
  while (cur < ntiles) {
    const int nxt = next_live(cur);
    cp_async_wait<0>();
    __syncthreads();   // tile cur landed; every warp is done with the other stage and with P
    if (nxt < ntiles) issue(nxt, st ^ 1);
    cp_async_commit();
    const uint8_t* stage = sm + L::RING + st * L::STAGEB;
    bool ok[4];
    tile.score(sm, stage);
    if constexpr (Tile<T, R, RD>::PARTIAL) __syncthreads();   // every warp's partial scores
    tile.reduce(sm, kpos + cur * BK, red, a.window, ok);
    __syncthreads();   // every warp's row maxima
    tile.update(sm, red, ok, a.sl2);
    __syncthreads();   // P
    tile.pv(sm, stage);
    cur = nxt;
    st ^= 1;
  }

  // the row sums over the warps, then the output (one split) or the f32
  // partials (m in log2 units); a row that saw no key keeps m = NEG_INF and
  // l = 0, and its acc is not written (the combine drops it). red is free:
  // every warp is past its last read of it.
  tile.finish(lsum, red);
  __syncthreads();
  const size_t rows_total = (size_t)a.B * Rq;
  const size_t row0 = (size_t)b * Rq + r0;
  const auto row_sum = [&](int row) -> float {
    float lt = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) lt += lsum[w * RB + row];
    return lt;
  };
  tile.each_out([&](int row, int col, float2 x) {
    if (row >= nrows) return;
    const float lt = row_sum(row);
    if (a.splits == 1) {
      const float den = fmaxf(lt, 1e-30f);
      store2<T>(static_cast<T*>(a.out) + (row0 + row) * R + col,
                make_float2(x.x / den, x.y / den));
    } else if (lt != 0.f) {
      *reinterpret_cast<float2*>(a.part_acc + ((size_t)split * rows_total + row0 + row) * R +
                                 col) = x;
    }
  });
  if (a.splits > 1 && tid < nrows) {
    float* ml = a.part_ml + 2 * ((size_t)split * rows_total + row0 + tid);
    ml[0] = red[tid];
    ml[1] = row_sum(tid);
  }
}

template <typename T, int R, int RD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using L = Layout<T, R, RD>;
  const size_t smem = L::bytes(a.ks);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(paged_mla_kernel<T, R, RD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int groups = (a.S * a.H + RB - 1) / RB;
  paged_mla_kernel<T, R, RD><<<dim3(a.splits, groups, a.B), NT, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  return repro::splitl::combine<T, R>(a.part_acc, a.part_ml, a.out, a.B * a.S * a.H, a.splits,
                                      stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. (r, rd): (512, 64) full-width and
// (64, 16) reduced deepseek-v2-lite. window <= 0: no window. splits >= 1
// runs of ks keys each (a multiple of 32, covering n_max * page: the
// wrapper's plan; the kernel works out no split of its own); above 1
// split, part_acc (splits, B*S*H, r) and part_ml (splits, B*S*H, 2) are
// f32 scratch the wrapper allocated.
int paged_mla_attention_launch(const void* q, const void* ckv_pages,
                               const void* kr_pages, const void* pos_pages,
                               const void* page_table, const void* q_pos, void* out,
                               void* part_acc, void* part_ml, int B, int S, int H, int r,
                               int rd, int page, int n_max, int dtype, int window, int splits,
                               int ks, float scale, void* stream) {
  if (S < 1 || B < 1 || H < 1 || page < 1 || n_max < 1 || splits < 1) return cudaErrorInvalidValue;
  if (ks < BK || ks % BK != 0 || (long long)ks * splits < (long long)n_max * page)
    return cudaErrorInvalidValue;
  if (splits > 1 && (part_acc == nullptr || part_ml == nullptr)) return cudaErrorInvalidValue;
  const Args a{q, ckv_pages, kr_pages,
               static_cast<const int*>(pos_pages), static_cast<const int*>(page_table),
               static_cast<const int*>(q_pos), out,
               static_cast<float*>(part_acc), static_cast<float*>(part_ml),
               B, S, H, page, n_max, window, splits, ks, scale * repro::splitl::LOG2E};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && r == 512 && rd == 64) return launch<float, 512, 64>(a, st);
  if (dtype == 1 && r == 512 && rd == 64) return launch<__nv_bfloat16, 512, 64>(a, st);
  if (dtype == 0 && r == 64 && rd == 16) return launch<float, 64, 16>(a, st);
  if (dtype == 1 && r == 64 && rd == 16) return launch<__nv_bfloat16, 64, 16>(a, st);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

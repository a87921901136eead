// Split-L flash decoding over a paged KV pool, shared by the paged decode
// kernel (one query token per row) and the paged verify kernel's small-R
// regime (the spec-decode verify block, S = k+1 tokens per row).
//
// Rows are flattened as the JAX kernel flattens them: R = S * G query rows
// per (row, KV head), s-major and g-minor, so query row r is token r / G of
// query head hk * G + r % G and carries that token's position. Mask:
// kv_pos <= q_pos [&& q_pos - kv_pos < window]; the null page 0 and every
// unwritten slot carry pos 2^30, so a live token never sees them and a
// token at pos 2^30 (a masked slot) sees every slot, as in JAX.
//
// What bounds it on an H100: 4 * D flops per visible (query, key) pair
// against 2 * D K/V values per key, so the bytes of K/V bound it; the old
// kernels reached a few percent of that bound because one block per (KV
// head, row) walked the whole context alone, one synchronous chunk at a
// time. What this design does:
//   * the context is split: grid (splits, Hkv * row groups, B), each block
//     a contiguous run of 32-key steps of one row, so B * Hkv blocks
//     become enough to fill 132 SMs (the wrapper picks `splits`); each
//     block writes f32 partials (m, l, acc) of its rows, and a second small
//     kernel merges the splits in split order (no atomics: two launches
//     give the same bits). One split skips the partials and the merge;
//   * a block's rows share every K/V row it reads: all G query heads of a
//     KV head (decode) or the R = S * G rows of the verify block, in groups
//     of up to 16 rows (more rows: more groups, each reading the K/V again);
//   * before any K/V is read, the block scans its keys' positions (many
//     loads in flight) into a live-key bit map; a key no row sees is never
//     read, and a warp step with no live key costs nothing;
//   * the four warps walk their own keys (8 per step) through their own
//     cp.async ring of NSTAGE stages: the next steps' K/V rows and
//     positions are in flight while a step computes, and no block-wide
//     barrier stands in the loop;
//   * scores without a scalar loop: lanes (key c, row subset q4) hold a
//     whole 16-byte K vector in registers and reuse it over their rows'
//     f32 queries (shared memory, padded rows: no bank conflicts); P V by
//     lanes (column slice, q4) with each probability fetched by a shuffle.
//     f32 accumulation, one rounding at the output.
#pragma once

#include "attn_tiles.cuh"

namespace repro {
namespace splitl {

using tiles::cp_async16;
using tiles::cp_async4;
using tiles::cp_async_commit;
using tiles::cp_async_wait;
using tiles::ex2;
using tiles::smem_u32;

constexpr int NW = 4;                 // warps
constexpr int NT = 32 * NW;           // threads
constexpr int KW = 8;                 // keys per warp step
constexpr int KSTEP = KW * NW;        // keys per block step: one 32-bit live word
constexpr int NSTAGE = 3;             // per-warp ring depth
constexpr int UNSEEN = 0x7fffffff;    // position given to a key no row sees
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void *q, *k, *v;
  const int *pos_pages, *page_table, *q_pos;
  void* out;
  float *part_acc, *part_ml;   // (splits, B*S*H, D) and (splits, B*S*H, 2); unused at 1 split
  int B, S, H, Hkv, page, n_max, window, splits;
  int ks;                      // keys per split (the wrapper's plan), a multiple of KSTEP
  float sl2;                   // scale * log2(e): scores in log2 units
};

// Dynamic shared memory (byte offsets; every region 16-byte aligned).
template <typename T, int D, int RB>
struct Layout {
  static constexpr int ROWB = D * (int)sizeof(T) + 16;          // padded K/V row
  static constexpr uint32_t STAGEB = 2 * KW * ROWB;             // K rows, then V rows
  static constexpr uint32_t RINGB = NW * NSTAGE * STAGEB;
  static constexpr uint32_t MERGEB = NW * RB * (D + 2) * 4;     // reuses the ring
  static constexpr uint32_t RING = 0;
  static constexpr uint32_t Q = RINGB > MERGEB ? RINGB : MERGEB;
  static constexpr uint32_t QP = Q + RB * (D + 4) * 4;
  static constexpr uint32_t KP = QP + ((RB * 4 + 15) / 16) * 16;
  static constexpr uint32_t LIVE = KP + NW * NSTAGE * KW * 4;
  static_assert(Q % 16 == 0 && QP % 16 == 0 && LIVE % 16 == 0, "misaligned layout");
  // live words, then the split's page-table entries
  static size_t bytes(int words, int entries) {
    return LIVE + (size_t)words * 4 + (size_t)entries * 4;
  }
};

// 4 elements of T from global memory as f32 (bf16 -> f32 is exact)
template <typename T> __device__ __forceinline__ float4 load4(const T* p);
template <> __device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <> __device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xffff0000u));
}

template <typename T> __device__ __forceinline__ void store4(T* p, float4 x);
template <> __device__ __forceinline__ void store4<float>(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
template <> __device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y), b = __floats2bfloat162_rn(x.z, x.w);
  uint2 r;
  r.x = *reinterpret_cast<const uint32_t*>(&a);
  r.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = r;
}

// Block (split, Hkv * row groups, B): rows r0 .. r0 + RB - 1 of KV head hk
// of row b over keys [k0, k1).
template <typename T, int D, int RB>
__global__ void __launch_bounds__(NT) splitl_kernel(const __grid_constant__ Args a) {
  using L = Layout<T, D, RB>;
  constexpr int VEC = 16 / (int)sizeof(T);     // elements per 16-byte vector
  constexpr int VPR = D / VEC;                 // vectors per K/V row
  constexpr int RPL = RB / 4;                  // rows per lane
  constexpr int CPL = D / 8;                   // P V columns per lane
  constexpr int VPL = CPL / VEC;               // V vectors per lane per key
  static_assert(VPR % 4 == 0 && CPL % VEC == 0 && RB % 4 == 0, "shape does not split evenly");
  extern __shared__ __align__(16) uint8_t sm[];
  const uint32_t sb = smem_u32(sm);
  float* qs = reinterpret_cast<float*>(sm + L::Q);
  int* qp_s = reinterpret_cast<int*>(sm + L::QP);
  int* kp_ring = reinterpret_cast<int*>(sm + L::KP);
  uint32_t* live_s = reinterpret_cast<uint32_t*>(sm + L::LIVE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ngroups = gridDim.y / a.Hkv;
  const int split = blockIdx.x, hk = blockIdx.y / ngroups, b = blockIdx.z;
  const int G = a.H / a.Hkv, R = a.S * G;
  const int r0 = (blockIdx.y % ngroups) * RB;
  const int nrows = min(RB, R - r0);
  const int page = a.page;
  const int Lk = a.n_max * page;
  const int k0 = split * a.ks, k1 = min(Lk, k0 + a.ks);
  const int nsteps = k1 > k0 ? (k1 - k0 + KSTEP - 1) / KSTEP : 0;
  const int e0 = k0 / page;
  const int ne = k1 > k0 ? (k1 - 1) / page - e0 + 1 : 0;
  int* tab_s = reinterpret_cast<int*>(live_s + nsteps);
  // query row r of this group -> element offset of its q / out row
  const auto row_off = [&](int r) -> size_t {
    return (((size_t)b * a.S + r / G) * a.H + hk * G + r % G) * D;
  };

  const T* q = static_cast<const T*>(a.q);
  for (int i = tid; i < RB * (D / 4); i += NT) {
    const int r = i / (D / 4), c = i % (D / 4);
    const float4 x = r < nrows ? load4<T>(q + row_off(r0 + r) + 4 * c) : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(qs + r * (D + 4) + 4 * c) = x;
  }
  for (int i = tid; i < RB; i += NT)
    qp_s[i] = i < nrows ? a.q_pos[(size_t)b * a.S + (r0 + i) / G] : -1;
  for (int e = tid; e < ne; e += NT) tab_s[e] = a.page_table[(size_t)b * a.n_max + e0 + e];
  __syncthreads();

  int qmax = -1;
  for (int i = 0; i < nrows; ++i) qmax = max(qmax, qp_s[i]);
  const auto sees = [&](int qp, int kp) -> bool {
    return kp <= qp && (a.window <= 0 || qp - kp < a.window);
  };
  const auto seen = [&](int kp) -> bool {     // by some row of the group
    if (kp > qmax) return false;
    if (a.window <= 0) return true;
    for (int i = 0; i < nrows; ++i)
      if (sees(qp_s[i], kp)) return true;
    return false;
  };
  const auto slot_of = [&](int j) -> int { return tab_s[j / page - e0] * page + j % page; };

  // the live-key map: bit 8 w + c of word t = key k0 + 32 t + 8 w + c
  {
    constexpr int U = 8;
    const int span = nsteps * KSTEP;
    for (int base = 0; base < span; base += NT * U) {
      int kp[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = k0 + base + u * NT + tid;
        kp[u] = j < k1 ? __ldg(a.pos_pages + slot_of(j)) : UNSEEN;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int off = base + u * NT + warp * 32;
        const unsigned word = __ballot_sync(FULL, kp[u] != UNSEEN && seen(kp[u]));
        if (lane == 0 && off < span) live_s[off / 32] = word;
      }
    }
  }
  __syncthreads();

  // this warp's keys: 8 per step; lane = 4 c + q4 (key c, row subset q4)
  const int c = lane >> 2, q4 = lane & 3;
  const auto warp_live = [&](int t) -> uint32_t { return (live_s[t] >> (KW * warp)) & 0xffu; };
  const auto next_live = [&](int t) -> int {
    for (++t; t < nsteps && warp_live(t) == 0u; ++t) {}
    return t;
  };
  const uint32_t ring = sb + L::RING + warp * NSTAGE * L::STAGEB;
  int* kp_w = kp_ring + warp * NSTAGE * KW;
  const char* kbase = static_cast<const char*>(a.k);
  const char* vbase = static_cast<const char*>(a.v);
  // K and V rows of key c of step t into stage st (zero rows for keys no
  // row sees: nothing is read for them), and its position
  const auto issue = [&](int t, int st) {
    const int j = k0 + t * KSTEP + KW * warp + c;
    const bool live = (warp_live(t) >> c) & 1u;
    const int slot = live ? slot_of(j) : 0;
    const size_t row = ((size_t)slot * a.Hkv + hk) * D * sizeof(T);
    const uint32_t kd = ring + st * L::STAGEB + c * L::ROWB;
    const uint32_t vd = kd + KW * L::ROWB;
#pragma unroll
    for (int u = 0; u < VPR / 4; ++u) {
      const int vi = 4 * u + q4;
      cp_async16(kd + vi * 16, kbase + row + vi * 16, live);
      cp_async16(vd + vi * 16, vbase + row + vi * 16, live);
    }
    if (q4 == 0) {
      if (live) cp_async4(smem_u32(kp_w + st * KW + c), a.pos_pages + slot);
      else kp_w[st * KW + c] = UNSEEN;
    }
  };

  const float sl2 = a.sl2;
  float m[RPL], l[RPL], acc[RPL][CPL];
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < CPL; ++e) acc[i][e] = 0.f;
  }
  int qp[RPL];
#pragma unroll
  for (int i = 0; i < RPL; ++i) qp[i] = qp_s[q4 + 4 * i];

  // the ring: NSTAGE - 1 live steps in flight ahead of the one computed
  int ts[NSTAGE - 1];
  int t = next_live(-1);
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) {
    ts[i] = t;
    if (t < nsteps) issue(t, i);
    cp_async_commit();
    if (t < nsteps) t = next_live(t);
  }
  int st = 0, ist = NSTAGE - 1;
  while (ts[0] < nsteps) {
    if (t < nsteps) issue(t, ist);
    cp_async_commit();
    cp_async_wait<NSTAGE - 1>();
    __syncwarp();
    {                               // compute step ts[0] from stage st
      const uint8_t* stage = sm + L::RING + (warp * NSTAGE + st) * L::STAGEB;
      const int kp = kp_w[st * KW + c];
      // scores of key c for rows q4 + 4 i
      float s[RPL];
#pragma unroll
      for (int i = 0; i < RPL; ++i) s[i] = 0.f;
      const uint8_t* krow = stage + c * L::ROWB;
#pragma unroll 4
      for (int v = 0; v < VPR; ++v) {
        float kf[VEC];
        unpack16<T>(*reinterpret_cast<const uint4*>(krow + v * 16), kf);
#pragma unroll
        for (int i = 0; i < RPL; ++i) {
          const float* qr = qs + (q4 + 4 * i) * (D + 4) + v * VEC;
#pragma unroll
          for (int e4 = 0; e4 < VEC / 4; ++e4) {
            const float4 qv = *reinterpret_cast<const float4*>(qr + 4 * e4);
            s[i] = fmaf(qv.x, kf[4 * e4], s[i]);
            s[i] = fmaf(qv.y, kf[4 * e4 + 1], s[i]);
            s[i] = fmaf(qv.z, kf[4 * e4 + 2], s[i]);
            s[i] = fmaf(qv.w, kf[4 * e4 + 3], s[i]);
          }
        }
      }
      // online softmax over the step's 8 keys: a row's scores sit in the 8
      // lanes of one q4 (xor 4, 8, 16: every lane gets the same bits)
      float p[RPL], corr[RPL];
      bool moved = false;
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        const bool ok = sees(qp[i], kp);
        const float sc = ok ? s[i] * sl2 : NEG_INF;
        float mx = sc;
#pragma unroll
        for (int x = 4; x < 32; x <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, x));
        const float mn = fmaxf(m[i], mx);
        corr[i] = ex2(m[i] - mn);
        p[i] = ok ? ex2(sc - mn) : 0.f;
        float sum = p[i];
#pragma unroll
        for (int x = 4; x < 32; x <<= 1) sum += __shfl_xor_sync(FULL, sum, x);
        l[i] = l[i] * corr[i] + sum;
        m[i] = mn;
        moved = moved || corr[i] != 1.f;
      }
      // P V: lane = 4 c' + q4 owns columns CPL c' .. CPL c' + CPL - 1 of rows
      // q4 + 4 i (the same rows as its scores: corr is already at hand)
      if (__any_sync(FULL, moved)) {
#pragma unroll
        for (int i = 0; i < RPL; ++i)
#pragma unroll
          for (int e = 0; e < CPL; ++e) acc[i][e] *= corr[i];
      }
      const uint8_t* vcol = stage + KW * L::ROWB + c * CPL * (int)sizeof(T);
#pragma unroll
      for (int cc = 0; cc < KW; ++cc) {
        float pc[RPL];
#pragma unroll
        for (int i = 0; i < RPL; ++i) pc[i] = __shfl_sync(FULL, p[i], 4 * cc + q4);
#pragma unroll
        for (int vv = 0; vv < VPL; ++vv) {
          float vf[VEC];
          unpack16<T>(*reinterpret_cast<const uint4*>(vcol + cc * L::ROWB + vv * 16), vf);
#pragma unroll
          for (int i = 0; i < RPL; ++i)
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[i][vv * VEC + e] = fmaf(pc[i], vf[e], acc[i][vv * VEC + e]);
        }
      }
    }
    __syncwarp();                   // stage st is free for the next issue
#pragma unroll
    for (int i = 0; i < NSTAGE - 2; ++i) ts[i] = ts[i + 1];
    ts[NSTAGE - 2] = t;
    if (t < nsteps) t = next_live(t);
    st = st + 1 == NSTAGE ? 0 : st + 1;
    ist = ist + 1 == NSTAGE ? 0 : ist + 1;
  }
  cp_async_wait<0>();
  __syncthreads();                  // every warp is done with its ring

  // merge the four warps' states (in warp order), then write the block's
  // rows: the output at one split, else its f32 partials
  float* macc = reinterpret_cast<float*>(sm + L::RING);     // [NW][RB][D]
  float* mm = macc + NW * RB * D;                           // [NW][RB]
  float* ml = mm + NW * RB;
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int r = q4 + 4 * i;
    float* dst = macc + (warp * RB + r) * D + c * CPL;
#pragma unroll
    for (int e = 0; e < CPL; e += 4)
      *reinterpret_cast<float4*>(dst + e) = make_float4(acc[i][e], acc[i][e + 1], acc[i][e + 2], acc[i][e + 3]);
    if (c == 0) {
      mm[warp * RB + r] = m[i];
      ml[warp * RB + r] = l[i];
    }
  }
  __syncthreads();
  const size_t rows_total = (size_t)a.B * a.S * a.H;
  for (int i = tid; i < nrows * (D / 4); i += NT) {
    const int r = i / (D / 4), d4 = i % (D / 4);
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, mm[w * RB + r]);
    float lsum = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float cw = ex2(mm[w * RB + r] - mx);
      lsum += cw * ml[w * RB + r];
      const float4 x = *reinterpret_cast<const float4*>(macc + (w * RB + r) * D + 4 * d4);
      o.x += cw * x.x;
      o.y += cw * x.y;
      o.z += cw * x.z;
      o.w += cw * x.w;
    }
    const size_t off = row_off(r0 + r);
    if (a.splits == 1) {
      const float den = fmaxf(lsum, 1e-30f);
      store4<T>(static_cast<T*>(a.out) + off + 4 * d4,
                make_float4(o.x / den, o.y / den, o.z / den, o.w / den));
    } else {
      const size_t row = (size_t)split * rows_total + off / D;
      if (lsum != 0.f) *reinterpret_cast<float4*>(a.part_acc + row * D + 4 * d4) = o;
      if (d4 == 0) {
        a.part_ml[2 * row] = mx;
        a.part_ml[2 * row + 1] = lsum;
      }
    }
  }
}

// One thread per 4 output elements: the splits' partials merged in split
// order. m is in log2 units. A split that saw no key of a row has m =
// NEG_INF and l = 0 and weighs exactly 0; its acc is not written, and what
// is read there is dropped by a select (no load waits on a branch).
template <typename T, int D>
__global__ void __launch_bounds__(256) combine_kernel(const float* __restrict__ part_acc,
                                                      const float* __restrict__ part_ml,
                                                      T* __restrict__ out, int rows, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * (D / 4)) return;
  const int row = i / (D / 4), d4 = i % (D / 4);
  float mx = NEG_INF;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_ml[2 * ((size_t)s * rows + row)]);
  float lsum = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int s = 0; s < splits; ++s) {
    const size_t at = (size_t)s * rows + row;
    const float2 ml = *reinterpret_cast<const float2*>(part_ml + 2 * at);
    const float4 x = *reinterpret_cast<const float4*>(part_acc + at * D + 4 * d4);
    const bool live = ml.y != 0.f;
    const float cw = ex2(ml.x - mx);
    lsum += live ? cw * ml.y : 0.f;
    o.x += live ? cw * x.x : 0.f;
    o.y += live ? cw * x.y : 0.f;
    o.z += live ? cw * x.z : 0.f;
    o.w += live ? cw * x.w : 0.f;
  }
  const float den = fmaxf(lsum, 1e-30f);
  store4<T>(out + (size_t)row * D + 4 * d4, make_float4(o.x / den, o.y / den, o.z / den, o.w / den));
}

template <typename T, int D>
cudaError_t combine(const float* part_acc, const float* part_ml, void* out, int rows, int splits,
                    cudaStream_t stream) {
  const int n = rows * (D / 4);
  combine_kernel<T, D><<<(n + 255) / 256, 256, 0, stream>>>(part_acc, part_ml,
                                                            static_cast<T*>(out), rows, splits);
  return cudaGetLastError();
}

template <typename T, int D, int RB>
cudaError_t launch_rb(const Args& a, cudaStream_t stream) {
  using L = Layout<T, D, RB>;
  const int Lk = a.n_max * a.page;
  const int words = (a.ks + KSTEP - 1) / KSTEP;
  const int entries = (a.ks + a.page - 1) / a.page + 1;
  const size_t smem = L::bytes(words, entries);
  if (smem > 232448 || Lk <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(splitl_kernel<T, D, RB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int R = a.S * (a.H / a.Hkv);
  const int ngroups = (R + RB - 1) / RB;
  splitl_kernel<T, D, RB><<<dim3(a.splits, a.Hkv * ngroups, a.B), NT, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  return combine<T, D>(a.part_acc, a.part_ml, a.out, a.B * a.S * a.H, a.splits, stream);
}

// rows per block: the fewest of 4, 8, 16 that hold R (more rows: groups of
// 16). The splits must cover the context in runs of whole steps.
template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.splits < 1 || a.Hkv < 1 || a.H % a.Hkv != 0 || a.S < 1 || a.B < 1 || a.page < 1)
    return cudaErrorInvalidValue;
  if (a.ks < KSTEP || a.ks % KSTEP != 0 || (long long)a.ks * a.splits < (long long)a.n_max * a.page)
    return cudaErrorInvalidValue;
  if (a.splits > 1 && (a.part_acc == nullptr || a.part_ml == nullptr)) return cudaErrorInvalidValue;
  const int R = a.S * (a.H / a.Hkv);
  if (R <= 4) return launch_rb<T, D, 4>(a, stream);
  if (R <= 8) return launch_rb<T, D, 8>(a, stream);
  return launch_rb<T, D, 16>(a, stream);
}

}  // namespace splitl
}  // namespace repro

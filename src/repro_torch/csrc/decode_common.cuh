// Split-T (flash-decoding) GQA decode attention, shared by the contiguous
// (decode_attention.cu) and paged (paged_attention.cu) kernels.
//
// Bound on the H100: decode reads len x Hkv x D x 2 cache bytes per step and
// does 4 flops per cache element and query head, far below the card's ~295
// flops/byte ridge, so it is bound by device memory (3.35 TB/s).  The
// design moves each cache byte once and keeps enough loads in flight to
// reach that rate.  The T axis is split over blocks (grid = splits x Hkv x
// head chunks x B: the (B, Hkv) grid alone is 32 blocks at 4 slots, far too
// few for 132 SMs); splits past lengths[b] (or before the window) read no
// K/V at all.  Three kernels, chosen by (dtype, G) and nothing else:
//   * decode_fused_mma (bf16 at G <= 8: llama's serve shape, every paged
//     launch of its engine) and decode_fused (fp32 at any G): one launch a
//     call.  A block's K/V tiles stream through a cp.async ring in shared
//     memory; the block that arrives last at a per-row counter merges the
//     splits' partials, and a row whose valid tokens lie in one split
//     skips the partials.  In bf16 the scores and sums run on the tensor
//     cores (mma.sync, the G heads as rows of M = 16): on the CUDA cores
//     they took more issue slots than the bytes leave time for.  In fp32
//     (4 bytes an element, half the work a byte) they stay on the CUDA
//     cores, exact fp32.
//   * split_mma + merge_kernel (bf16 at G > 8; recurrentgemma: 16 heads over
//     1 KV head): one block serves 16 query heads of the KV group on the
//     tensor cores and reads each K/V row once, and a second launch merges
//     the splits in parallel.
// The wrapper's split plan (kernels/__init__.py::split_plan) counts the head
// chunks when filling the card, keeps a split at G <= 8 between 64 and 256
// tokens (few merges for short rows, long rows spread over many blocks),
// and keeps the fp32 partials to 1/8 of the K/V bytes.  Scores, softmax
// and accumulation are fp32; p is rounded to the cache's type before the PV
// product, as the Pallas kernels do, and l sums the unrounded p.  A row
// with no valid token (lengths <= 0) yields 0, as the Pallas kernels do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sync.cuh"

namespace decode {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

// 16 bytes of fp32 at p into f[0..3]
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  f[0] = r.x;
  f[1] = r.y;
  f[2] = r.z;
  f[3] = r.w;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Contiguous cache (B, T, Hkv, D).  page_id() and at() mirror PagedKV's, so
// that a kernel can load page ids ahead of the rows; here there are none.
template <typename T> struct ContiguousKV {
  const T* k;
  const T* v;
  int T_len, Hkv, D;
  __device__ __forceinline__ size_t row(int b, int h, int t) const {
    return ((static_cast<size_t>(b) * T_len + t) * Hkv + h) * D;
  }
  __device__ __forceinline__ int page_id(int, int) const { return 0; }
  __device__ __forceinline__ size_t at(int, int b, int h, int t) const {
    return row(b, h, t);
  }
};

// Pages (NP, page, Hkv, D) read in place through page_table (B, maxp).
// Page ids are clipped to [0, NP-1] before any address is formed: a FAIL
// (-1) id or garbage past the length never leaves the page array.
// page_id(b, t) is the (clipped) page of token t < maxp * page of row b,
// at(p, b, h, t) its row in page p.
// page_shift is log2(page) for a power-of-two page (8 and 16 among them),
// whose page and offset are a shift and a mask, else -1.
template <typename T> struct PagedKV {
  const T* k;
  const T* v;
  const int* page_table;
  int NP, page, maxp, Hkv, D, page_shift;
  __device__ __forceinline__ int page_id(int b, int t) const {
    const int i = page_shift >= 0 ? t >> page_shift : t / page;
    return min(max(page_table[b * maxp + i], 0), NP - 1);
  }
  __device__ __forceinline__ size_t at(int p, int b, int h, int t) const {
    const int r = page_shift >= 0 ? t & (page - 1) : t % page;
    return ((static_cast<size_t>(p) * page + r) * Hkv + h) * D;
  }
  __device__ __forceinline__ size_t row(int b, int h, int t) const {
    return at(page_id(b, t), b, h, t);
  }
};

// The rows of a K/V tile one thread copies with cp.async: CH 16-byte chunks
// a row, so chunk column tid % CH of rows tid / CH + i * kThreads / CH, i <
// RPT.  Their page ids (PagedKV) are loaded a tile ahead: before lengths is
// known for the split's first tile (tokens from split * split_len, reloaded
// if a window moves the start), then each right after the previous tile's
// copies are issued, so no copy waits on a page-table read.
template <int TILE, int CH, class KV>
struct RingRows {
  static constexpr int RSTEP = kThreads / CH;
  static constexpr int RPT = (TILE + RSTEP - 1) / RSTEP;
  static_assert(kThreads % CH == 0 && (TILE % RSTEP == 0 || TILE < RSTEP),
                "a tile's chunks split evenly over the block");
  int pid[RPT];
  __device__ __forceinline__ void load(const KV& kv, int b, int t0, int lim) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int t = t0 + static_cast<int>(threadIdx.x) / CH + i * RSTEP;
      pid[i] = t < lim ? kv.page_id(b, t) : 0;
    }
  }
  // copies rows [t0, t0 + TILE) (rows at or past t_end zero-filled) of K
  // and V to ks + row * ld and vs + row * ld
  template <typename T>
  __device__ __forceinline__ void copy(const KV& kv, int b, int h, int t0,
                                       int t_end, T* ks, T* vs,
                                       int ld) const {
    constexpr int EPC = 16 / sizeof(T);  // elements a chunk
    const int ch = threadIdx.x % CH;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = threadIdx.x / CH + i * RSTEP;
      if (TILE < RSTEP && row >= TILE) break;  // threads past a short tile
      const bool in = t0 + row < t_end;
      const size_t off = (in ? kv.at(pid[i], b, h, t0 + row) : 0) + ch * EPC;
      tc::cp_async16(ks + row * ld + ch * EPC, kv.k + off, in);
      tc::cp_async16(vs + row * ld + ch * EPC, kv.v + off, in);
    }
  }
};

// ---------------------------------------------------------------------------
// One launch a call: fp32 at any G (decode_fused, CUDA cores), bf16 at G <= 8
// (decode_fused_mma, tensor cores)
// ---------------------------------------------------------------------------
// Both run on grid (n_splits, Hkv * n_hc, B): block (split, h * n_hc + hc, b)
// owns query heads [hc * MAXG, hc * MAXG + Gc) of KV head h (n_hc = ceil(G /
// MAXG) head chunks) and the valid tokens of its split, [max(split *
// split_len, lo), min(split * split_len + split_len, hi)) with hi =
// min(lengths[b], cap) and lo = lengths[b] - window (or 0).
//   * A split with no valid token exits at once.  The row's live splits are
//     the n_live consecutive splits from lo / split_len to (hi - 1) /
//     split_len (kernels/__init__.py::decode_arrivals); every block of the
//     row computes n_live alike.  A row with none (lengths <= 0) is written
//     0 by its split-0 block.
//   * The split's K/V tiles stream through a ring of stages in shared
//     memory, fed by cp.async (16 bytes a thread; rows past the split's end
//     zero-filled and masked), so the next tiles stay in flight while the
//     block computes on one.
//   * The softmax runs in the exp2 domain (scores scaled by scale x
//     log2(e)); the block merges its thread groups (or warps) in shared
//     memory into one partial (m, l, acc) of its heads (finish_split).
//   * n_live == 1: the block writes out = acc / l itself.  Otherwise it
//     writes its partial to the fp32 scratch ml, acc_out, then bumps the
//     (b, h, hc) arrival counter (after __threadfence); the block that
//     arrives last resets the counter to 0 and merges the row's partials,
//     out = sum 2^(m - M) acc / sum 2^(m - M) l over the live splits (M the
//     max m), with thread groups over the splits and D in 4-float slices
//     (merge_kernel's reduction), each group keeping its own running max,
//     so that the partials are read in one pass.  So a call is one launch,
//     and the counters are zero again when it ends.
// A call's counters must not be in use by a concurrent launch: the wrapper
// keeps one buffer per stream (kernels/__init__.py::arrival_counters), and
// the launches of one stream run one after another.
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU (about 2 ulp; 0 far below zero).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The valid tokens of one split of row b, and the row's live splits.
struct Span {
  int t_begin, t_end, s_first, n_live;
  __device__ __forceinline__ Span(int len, int cap, int window, int split_len,
                                  int split) {
    const int hi = min(len, cap);
    const int lo = window > 0 ? max(len - window, 0) : 0;
    s_first = lo / split_len;
    n_live = hi > lo ? (hi - 1) / split_len - s_first + 1 : 0;
    t_begin = max(split * split_len, lo);
    t_end = min(split * split_len + split_len, hi);
  }
};

// The end of a block whose split holds valid tokens: part(e) is element e =
// g * D + d of the block's acc (its heads g < Gc, rescaled to the block's
// max), fin[g] its (m, l), both in shared memory and visible to every
// thread.  Writes out directly (one live split), or the partial and, in the
// last block to arrive, the merge of the row (see above).  red: shared
// memory for 1.5 x max(kThreads, Gc * D / 4) float4 values, free to
// overwrite.
template <typename T, int D, class Part>
__device__ __forceinline__ void finish_split(
    Part part, float (*fin)[2], int* is_last, float4* red, const Span& sp,
    int split, size_t row0, int G, int g0, int Gc, T* outp, float* ml,
    float* acc_out, int* cnt) {
  const int tid = threadIdx.x;
  if (sp.n_live == 1) {  // the row's only split: no partial, no counter
    for (int e = tid; e < Gc * D; e += kThreads)
      store(outp + e, part(e) / fin[e / D][1]);
    return;
  }
  const size_t prow = (row0 + split) * G + g0;
  for (int e = tid; e < Gc * D; e += kThreads) acc_out[prow * D + e] = part(e);
  if (tid < Gc) {
    ml[(prow + tid) * 2] = fin[tid][0];
    ml[(prow + tid) * 2 + 1] = fin[tid][1];
  }
  // the arrival, as cooperative groups' grid barrier arrives: the block's
  // writes, ordered by the barrier, made visible device-wide by thread 0's
  // fence before its atomic
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    *is_last = atomicAdd(cnt, 1) == sp.n_live - 1;
    if (*is_last) atomicExch(cnt, 0);  // every block of the row has arrived
  }
  __syncthreads();
  if (!*is_last) return;
  __threadfence();  // the other blocks' partials, read past L1 (__ldcg)

  // The last block merges the row in one pass over the partials: thread
  // group gs of `groups` takes the splits gs, gs + groups, ... of one head
  // and one 4-float slice of D, and keeps its own running max mg with den
  // = sum 2^(m - mg) l and num = sum 2^(m - mg) acc (rescaled when mg
  // grows); the groups then meet in shared memory under the head's max.
  constexpr int SL = D / 4;
  const int n_live = sp.n_live, nsl = Gc * SL;
  const int groups = nsl >= kThreads ? 1 : kThreads / nsl;
  const size_t r0 = (row0 + sp.s_first) * G + g0;  // split s, head g: r0 + s G + g
  float* gm = reinterpret_cast<float*>(red + max(kThreads, nsl));  // [groups][nsl]
  float* gd = gm + max(kThreads, nsl);
  constexpr int kBatch = 8;  // splits whose loads are in flight together
  for (int i = tid; i < nsl * groups; i += kThreads) {
    const int pair = i % nsl, gs = i / nsl, g = pair / SL;
    float mg = kNegInf, den = 0.f;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = gs; s0 < n_live; s0 += kBatch * groups) {
      float2 m_l[kBatch];
      float4 a[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {  // the batch's loads first
        const int s = s0 + u * groups;
        const size_t r = r0 + static_cast<size_t>(min(s, n_live - 1)) * G + g;
        m_l[u] = __ldcg(reinterpret_cast<const float2*>(ml + r * 2));
        a[u] = __ldcg(reinterpret_cast<const float4*>(acc_out + r * D) +
                      pair % SL);
        if (s >= n_live) m_l[u] = make_float2(kNegInf, 0.f);  // weight 0
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const float mn = fmaxf(mg, m_l[u].x);
        const float c = ex2(mg - mn), w = ex2(m_l[u].x - mn);
        den = den * c + w * m_l[u].y;
        num.x = num.x * c + w * a[u].x;
        num.y = num.y * c + w * a[u].y;
        num.z = num.z * c + w * a[u].z;
        num.w = num.w * c + w * a[u].w;
        mg = mn;
      }
    }
    red[gs * nsl + pair] = num;
    gm[gs * nsl + pair] = mg;
    gd[gs * nsl + pair] = den;
  }
  __syncthreads();
  for (int pair = tid; pair < nsl; pair += kThreads) {
    float M = kNegInf;
    for (int j = 0; j < groups; ++j) M = fmaxf(M, gm[j * nsl + pair]);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    float den = 0.f;
    for (int j = 0; j < groups; ++j) {
      const float w = ex2(gm[j * nsl + pair] - M);
      const float4 x = red[j * nsl + pair];
      den += w * gd[j * nsl + pair];
      sum.x += w * x.x;
      sum.y += w * x.y;
      sum.z += w * x.z;
      sum.w += w * x.w;
    }
    store(outp + pair * 4, sum.x / den);
    store(outp + pair * 4 + 1, sum.y / den);
    store(outp + pair * 4 + 2, sum.z / den);
    store(outp + pair * 4 + 3, sum.w / den);
  }
}

// decode_fused (fp32): up to MAXG query heads a block on the CUDA cores, so
// a K/V row loaded once serves them all.  A group of TPG = min(32, D / 8)
// threads covers one token row, 8 elements (two float4) a thread, and keeps
// an online softmax (m, l, acc) of its rows in registers.  A stage holds
// kStageBytes of K (and as much of V): 16 rows at D 128.
constexpr int kStages = 4;
constexpr int kStageBytes = 8192;

template <int D, int MAXG>
struct Fused {
  static constexpr int TPG = D / 8 < 32 ? D / 8 : 32;  // threads a row
  static constexpr int NV = D / (TPG * 4);    // float4 a thread and row
  static constexpr int E = NV * 4;            // elements a thread and row
  static constexpr int NGROUPS = kThreads / TPG;
  static constexpr int ROW = D * 4;           // bytes a row
  static constexpr int TILE0 = kStageBytes / ROW < 64 ? kStageBytes / ROW : 64;
  static constexpr int TILE = TILE0 > NGROUPS ? TILE0 : NGROUPS;  // rows a stage
  static constexpr int TPT = TILE / NGROUPS;  // rows a thread group and tile
  static constexpr int CH = ROW / 16;         // 16-byte chunks a row
  static constexpr int ring = kStages * 2 * TILE * D * 4;
  static constexpr int groups = NGROUPS * MAXG * D * 4;  // the groups' merge
  static constexpr int bytes = ring > groups ? ring : groups;
  static_assert(TPG >= 1 && (TPG & (TPG - 1)) == 0 && TPG * E == D,
                "a token row must map onto a power-of-two part of a warp");
  static_assert(TPT * NGROUPS == TILE, "a tile's rows split over the groups");
  static_assert(bytes >= 24 * (MAXG * D / 4 > kThreads ? MAXG * D / 4
                                                         : kThreads),
                "the splits' merge fits where the ring was");
};

template <int D, int MAXG, class KV>
__global__ void __launch_bounds__(kThreads)
decode_fused(const float* __restrict__ q, KV kv,
             const int* __restrict__ lengths, int cap, int G, int window,
             float scale, int split_len, float* __restrict__ out,
             float* __restrict__ ml, float* __restrict__ acc_out,
             int* __restrict__ counters) {
  using F = Fused<D, MAXG>;
  constexpr int TPG = F::TPG, NV = F::NV, E = F::E;
  constexpr int NGROUPS = F::NGROUPS, TILE = F::TILE, TPT = F::TPT;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  __shared__ float sm_m[NGROUPS][MAXG];
  __shared__ float sm_l[NGROUPS][MAXG];
  __shared__ float fin[MAXG][2];
  __shared__ int is_last;

  const int n_hc = (G + MAXG - 1) / MAXG;
  const int split = blockIdx.x, b = blockIdx.z;
  const int h = blockIdx.y / n_hc, g0 = (blockIdx.y % n_hc) * MAXG;
  const int Gc = min(MAXG, G - g0);
  const int n_splits = gridDim.x, Hkv = gridDim.y / n_hc;
  const int tid = threadIdx.x, lane = tid % TPG, grp = tid / TPG;
  const size_t row0 = (static_cast<size_t>(b) * Hkv + h) * n_splits;
  float* outp = out + ((static_cast<size_t>(b) * Hkv + h) * G + g0) * D;

  // this thread's columns of a row: float4 j covers (j * TPG + lane) * 4;
  // q, with the score scale in the exp2 domain, before lengths is known
  const float scale2 = scale * kLog2e;
  float qf[MAXG][E];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < Gc) {
      const float* qp =
          q + ((static_cast<size_t>(b) * Hkv + h) * G + g0 + g) * D;
#pragma unroll
      for (int j = 0; j < NV; ++j)
        load4(qp + (j * TPG + lane) * 4, qf[g] + j * 4);
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i) qf[g][i] = 0.f;
    }
  }

  RingRows<TILE, F::CH, KV> rows;
  rows.load(kv, b, split * split_len, cap);
  const Span sp(lengths[b], cap, window, split_len, split);
  const int t_begin = sp.t_begin, t_end = sp.t_end;
  if (t_begin >= t_end) {  // uniform over the block: no K/V to read
    if (sp.n_live == 0 && split == 0)
      for (int e = tid; e < Gc * D; e += kThreads) store(outp + e, 0.f);
    return;
  }
  if (t_begin != split * split_len) rows.load(kv, b, t_begin, t_end);

  const int n_tiles = (t_end - t_begin + TILE - 1) / TILE;
  auto issue = [&](int j) {  // tile j into stage j % kStages (or nothing)
    if (j < n_tiles) {
      float* ks = ring + (j % kStages) * 2 * TILE * D;
      rows.copy(kv, b, h, t_begin + j * TILE, t_end, ks, ks + TILE * D, D);
      if (j + 1 < n_tiles) rows.load(kv, b, t_begin + (j + 1) * TILE, t_end);
    }
    tc::cp_async_commit();  // an empty group past the last tile
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) issue(j);

  float m[MAXG], l[MAXG], acc[MAXG][E];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[g][i] = 0.f;
  }

  // The trip count is uniform over the block, so every lane reaches every
  // shuffle and barrier; rows past t_end are masked.
  for (int j = 0; j < n_tiles; ++j) {
    tc::cp_async_wait<kStages - 2>();  // tile j has landed
    __syncthreads();  // ... for every thread; stage (j - 1) % kStages is free
    issue(j + kStages - 1);
    const float* ks = ring + (j % kStages) * 2 * TILE * D;
    const float* vs = ks + TILE * D;
    const int t0 = t_begin + j * TILE;

    float s[TPT][MAXG];
    bool valid[TPT];
#pragma unroll
    for (int u = 0; u < TPT; ++u) {
      const int r = u * NGROUPS + grp;
      valid[u] = t0 + r < t_end;
      float kf[E];
#pragma unroll
      for (int jv = 0; jv < NV; ++jv)
        load4(ks + r * D + (jv * TPG + lane) * 4, kf + jv * 4);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < E; ++i) d = fmaf(qf[g][i], kf[i], d);
        s[u][g] = d;
      }
    }
#pragma unroll
    for (int u = 0; u < TPT; ++u)
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
#pragma unroll
        for (int o = TPG / 2; o > 0; o >>= 1)
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], o);

    float p[TPT][MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < TPT; ++u) {
        s[u][g] *= scale2;
        if (valid[u]) mx = fmaxf(mx, s[u][g]);
      }
      const float alpha = ex2(m[g] - mx);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < TPT; ++u) {
        p[u][g] = valid[u] ? ex2(s[u][g] - mx) : 0.f;
        psum += p[u][g];
      }
      l[g] = l[g] * alpha + psum;
      m[g] = mx;
#pragma unroll
      for (int i = 0; i < E; ++i) acc[g][i] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < TPT; ++u) {
      const int r = u * NGROUPS + grp;
      float vf[E];
#pragma unroll
      for (int jv = 0; jv < NV; ++jv)
        load4(vs + r * D + (jv * TPG + lane) * 4, vf + jv * 4);
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
#pragma unroll
        for (int i = 0; i < E; ++i) acc[g][i] = fmaf(p[u][g], vf[i], acc[g][i]);
    }
  }
  tc::cp_async_wait<0>();  // only empty groups remain
  __syncthreads();         // every thread is done with the ring

  // Merge the block's thread groups: rescale each group to the block max.
  float* sm_acc = reinterpret_cast<float*>(smem);  // [NGROUPS][MAXG][D]
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      sm_m[grp][g] = m[g];
      sm_l[grp][g] = l[g];
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < Gc) {
      float M = kNegInf;
      for (int j = 0; j < NGROUPS; ++j) M = fmaxf(M, sm_m[j][g]);
      const float f = ex2(m[g] - M);
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          sm_acc[(grp * MAXG + g) * D + (j * TPG + lane) * 4 + i] =
              acc[g][j * 4 + i] * f;
    }
  }
  if (tid < Gc) {
    float M = kNegInf;
    for (int j = 0; j < NGROUPS; ++j) M = fmaxf(M, sm_m[j][tid]);
    float L = 0.f;
    for (int j = 0; j < NGROUPS; ++j) L += sm_l[j][tid] * ex2(sm_m[j][tid] - M);
    fin[tid][0] = M;
    fin[tid][1] = L;
  }
  __syncthreads();
  finish_split<float, D>(
      [&](int e) {
        const int g = e / D, d = e % D;
        float sum = 0.f;
        for (int j = 0; j < NGROUPS; ++j) sum += sm_acc[(j * MAXG + g) * D + d];
        return sum;
      },
      fin, &is_last, reinterpret_cast<float4*>(smem), sp, split, row0, G, g0,
      Gc, outp, ml, acc_out,
      counters + static_cast<size_t>(b) * gridDim.y + blockIdx.y);
}

// ---------------------------------------------------------------------------
// bf16 at G > 8: the tensor cores
// ---------------------------------------------------------------------------
// 16 query heads are the M = 16 of mma.sync m16n8k16, so one block serves
// 16 heads of a KV group (a larger group runs as chunks of 16) and reads each
// K/V row of its split once:
//   * the split's tokens stream through a two-stage ring of 64-token tiles
//     (cp.async, 16 bytes a thread; rows padded by 8 elements, so fragment
//     reads hit 32 banks); rows past the split's end are zero-filled;
//   * warp w takes tokens 16w..16w+15 of each tile: S (16 heads x 16 tokens)
//     = Q K^T on the tensor cores, an online softmax per head in registers,
//     then O (16 x D) += P V with the S accumulator rounded to bf16 in place
//     as P's A fragment (as flash_fwd_bf16 in flash_attention.cu): p is
//     rounded to the cache's type before P V, l sums the unrounded p, as in
//     decode_fused;
//   * the block merges its four warps through shared memory (over the idle
//     ring) and writes one partial (m, l, acc) per head and split.
constexpr int kMmaHeads = 16;
constexpr int kTileT = 64;

template <int D>
struct MmaSmem {
  static constexpr int LD = D + 8;                   // padded row, elements
  static constexpr int ring = 2 * kTileT * LD;       // two stages of K (or V)
  static constexpr int merge = 4 * kMmaHeads * LD;   // floats: warps x heads
  static constexpr int bytes = (2 * ring + kMmaHeads * LD) * 2 +
                               4 * kMmaHeads * 2 * 4;
  static_assert(merge * 4 <= 2 * ring * 2, "the warps' merge fits the ring");
};

template <int D, class KV>
__global__ void __launch_bounds__(kThreads)
split_mma(const __nv_bfloat16* __restrict__ q, KV kv,
          const int* __restrict__ lengths, int cap, int G, int window,
          float scale, int split_len, float* __restrict__ ml,
          float* __restrict__ acc_out) {
  using Sm = MmaSmem<D>;
  constexpr int LD = Sm::LD, CH = D / 8;  // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + Sm::ring;
  __nv_bfloat16* Qs = Vs + Sm::ring;
  float* red = reinterpret_cast<float*>(Qs + kMmaHeads * LD);  // [4][16][2]

  const int n_hc = (G + kMmaHeads - 1) / kMmaHeads;
  const int split = blockIdx.x, b = blockIdx.z;
  const int h = blockIdx.y / n_hc, g0 = (blockIdx.y % n_hc) * kMmaHeads;
  const int Gc = min(kMmaHeads, G - g0);
  const int n_splits = gridDim.x, Hkv = gridDim.y / n_hc;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, t4 = lane % 4;
  const size_t out_row = (static_cast<size_t>(b) * Hkv + h) * n_splits + split;

  const int len = lengths[b];
  const int hi = min(len, cap);
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int t_begin = max(split * split_len, lo);
  const int t_end = min(split * split_len + split_len, hi);
  if (t_begin >= t_end) {  // uniform over the block: no K/V to read
    if (tid < Gc) {
      ml[(out_row * G + g0 + tid) * 2] = kNegInf;
      ml[(out_row * G + g0 + tid) * 2 + 1] = 0.f;
    }
    return;
  }

  const int n_tiles = (t_end - t_begin + kTileT - 1) / kTileT;
  auto issue = [&](int i) {  // tile i into stage i % 2
    const int t0 = t_begin + i * kTileT;
    for (int c = tid; c < kTileT * CH; c += kThreads) {
      const int row = c / CH, ch = c % CH, t = t0 + row;
      const bool in = t < t_end;
      const size_t off = in ? kv.row(b, h, t) + ch * 8 : 0;
      const int so = ((i & 1) * kTileT + row) * LD + ch * 8;
      tc::cp_async16(Ks + so, kv.k + off, in);
      tc::cp_async16(Vs + so, kv.v + off, in);
    }
    tc::cp_async_commit();
  };
  issue(0);
  if (n_tiles > 1) issue(1);

  // the chunk's query heads; rows past Gc are zero
  for (int c = tid; c < kMmaHeads * CH; c += kThreads) {
    const int r = c / CH, ch = c % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < Gc)
      val = *reinterpret_cast<const uint4*>(
          q + ((static_cast<size_t>(b) * Hkv + h) * G + g0 + r) * D + ch * 8);
    *reinterpret_cast<uint4*>(Qs + r * LD + ch * 8) = val;
  }

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // heads gr, gr + 8

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles)
      tc::cp_async_wait<1>();
    else
      tc::cp_async_wait<0>();
    __syncthreads();  // tile i (and, at i = 0, Qs) visible to every warp
    const __nv_bfloat16* Kt = Ks + ((i & 1) * kTileT + 16 * warp) * LD;
    const __nv_bfloat16* Vt = Vs + ((i & 1) * kTileT + 16 * warp) * LD;

    // two accumulators a token column (even and odd k steps) halve the
    // chain of dependent products
    float sp[2][2][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* qp = Qs + gr * LD + kk * 16 + 2 * t4;
      const uint32_t a[4] = {tc::load_pair(qp), tc::load_pair(qp + 8 * LD),
                             tc::load_pair(qp + 8),
                             tc::load_pair(qp + 8 * LD + 8)};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const __nv_bfloat16* kp = Kt + (nt * 8 + gr) * LD + kk * 16 + 2 * t4;
        tc::mma_bf16(sp[kk & 1][nt], a, tc::load_pair(kp),
                     tc::load_pair(kp + 8));
      }
    }
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = sp[0][nt][e] + sp[1][nt][e];

    // tokens past the split's end score -inf: p = 0 (m stays finite)
    const int tw = t_begin + i * kTileT + 16 * warp + 2 * t4;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = tw + 8 * nt + (e & 1) < t_end ? sc[nt][e] * scale
                                                      : -INFINITY;
        sc[nt][e] = x;
        if (e < 2)
          mx0 = fmaxf(mx0, x);
        else
          mx1 = fmaxf(mx1, x);
      }
    }
    const float mn0 = fmaxf(m0, tc::quad_max(mx0));
    const float mn1 = fmaxf(m1, tc::quad_max(mx1));
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      sc[nt][0] = expf(sc[nt][0] - mn0);
      sc[nt][1] = expf(sc[nt][1] - mn0);
      sc[nt][2] = expf(sc[nt][2] - mn1);
      sc[nt][3] = expf(sc[nt][3] - mn1);
      rs0 += sc[nt][0] + sc[nt][1];
      rs1 += sc[nt][2] + sc[nt][3];
    }
    l0 = l0 * a0 + tc::quad_sum(rs0);
    l1 = l1 * a1 + tc::quad_sum(rs1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= a0;
      o[j][1] *= a0;
      o[j][2] *= a1;
      o[j][3] *= a1;
    }

    // O += P V over the warp's 16 tokens
    const uint32_t pa[4] = {tc::pack(sc[0][0], sc[0][1]),
                            tc::pack(sc[0][2], sc[0][3]),
                            tc::pack(sc[1][0], sc[1][1]),
                            tc::pack(sc[1][2], sc[1][3])};
    const __nv_bfloat16* vp = Vt + 2 * t4 * LD + gr;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const __nv_bfloat16* p = vp + j * 8;
      tc::mma_bf16(o[j], pa, tc::pack(p[0], p[LD]),
                   tc::pack(p[8 * LD], p[9 * LD]));
    }
    __syncthreads();  // every warp is done with stage i % 2
    if (i + 2 < n_tiles) issue(i + 2);
  }

  // Merge the four warps: rescale each to the block max per head.
  if (t4 == 0) {
    red[(warp * kMmaHeads + gr) * 2] = m0;
    red[(warp * kMmaHeads + gr) * 2 + 1] = l0;
    red[(warp * kMmaHeads + gr + 8) * 2] = m1;
    red[(warp * kMmaHeads + gr + 8) * 2 + 1] = l1;
  }
  __syncthreads();
  float M0 = kNegInf, M1 = kNegInf;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    M0 = fmaxf(M0, red[(w * kMmaHeads + gr) * 2]);
    M1 = fmaxf(M1, red[(w * kMmaHeads + gr + 8) * 2]);
  }
  const float f0 = expf(m0 - M0), f1 = expf(m1 - M1);
  float* accs = reinterpret_cast<float*>(smem);  // [4][16][LD] over the ring
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    float* r = accs + (warp * kMmaHeads + gr) * LD + j * 8 + 2 * t4;
    *reinterpret_cast<float2*>(r) = make_float2(o[j][0] * f0, o[j][1] * f0);
    *reinterpret_cast<float2*>(r + 8 * LD) =
        make_float2(o[j][2] * f1, o[j][3] * f1);
  }
  __syncthreads();
  for (int e = tid; e < Gc * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) sum += accs[(w * kMmaHeads + r) * LD + d];
    acc_out[(out_row * G + g0) * D + e] = sum;
  }
  if (tid < Gc) {
    float M = kNegInf, L = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) M = fmaxf(M, red[(w * kMmaHeads + tid) * 2]);
#pragma unroll
    for (int w = 0; w < 4; ++w)
      L += red[(w * kMmaHeads + tid) * 2 + 1] *
           expf(red[(w * kMmaHeads + tid) * 2] - M);
    ml[(out_row * G + g0 + tid) * 2] = M;
    ml[(out_row * G + g0 + tid) * 2 + 1] = L;
  }
}

// decode_fused_mma (bf16 at G <= 8): split_mma's products in one launch.
// The block serves all G <= 8 heads of a KV group as rows 0..G-1 of the
// M = 16 of mma.sync (rows G..15 are zero: the tensor cores have the room,
// the CUDA cores had not the issue slots for the scores and the shuffles).
// The tiles are kFusedTile = 32 tokens, through a kMmaStages-stage
// cp.async ring; warp w takes tokens 16 (w % 2).. 16 (w % 2) + 15 of a tile
// and, for P V, half w / 2 of D: S = Q K^T over all of D (the two warps of
// a token half compute it alike), an online softmax per head in the exp2
// domain (lane quads), O += P V over its half of D with p rounded to bf16
// in place as P's A fragment (l sums the unrounded p).  Q's A fragments
// stay in registers, loaded before lengths is known; K and V fragments come
// from shared memory by ldmatrix (V transposed).  So a block takes ~52 KB of
// shared memory at D 128 and four fit an SM: the paged cache's rows, a page
// table read and a TLB walk away, need many blocks' loads in flight.  The
// four warps merge in shared memory, then finish_split.
constexpr int kMmaStages = 3;
constexpr int kFusedTile = 32;

template <int D>
struct FusedMmaSmem {
  static constexpr int LD = D + 8;                          // padded row
  static constexpr int stage = 2 * kFusedTile * LD;         // K then V
  static constexpr int bytes = kMmaStages * stage * 2;
  static_assert(2 * 8 * LD * 4 <= bytes, "the warps' merge fits the ring");
  static_assert((2 * D > kThreads ? 2 * D : kThreads) * 24 <= bytes,
                "the splits' merge fits the ring");
};

template <int D, class KV>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 4 : 2)
decode_fused_mma(const __nv_bfloat16* __restrict__ q, KV kv,
                 const int* __restrict__ lengths, int cap, int G, int window,
                 float scale, int split_len, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ ml, float* __restrict__ acc_out,
                 int* __restrict__ counters) {
  using Sm = FusedMmaSmem<D>;
  constexpr int LD = Sm::LD, CH = D / 8;  // 16-byte chunks of a row
  constexpr int NT = D / 16;  // 8-column tiles of a warp's half of D
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __shared__ float wred[4][8][2];
  __shared__ float fin[8][2];
  __shared__ int is_last;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x, Hkv = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, t4 = lane % 4, th = warp & 1, dh = warp >> 1;
  const size_t row0 = (static_cast<size_t>(b) * Hkv + h) * n_splits;
  __nv_bfloat16* outp = out + (static_cast<size_t>(b) * Hkv + h) * G * D;

  // head gr's A fragments (columns 2 t4.. and 2 t4 + 8.. of each 16-wide k
  // step; rows gr + 8 >= G are zero), and the first tile's page ids, both
  // loaded before lengths is known
  uint32_t qa[D / 16][2];
  {
    const __nv_bfloat16* qp =
        q + ((static_cast<size_t>(b) * Hkv + h) * G + gr) * D + 2 * t4;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = gr < G ? tc::load_pair(qp + kk * 16) : 0u;
      qa[kk][1] = gr < G ? tc::load_pair(qp + kk * 16 + 8) : 0u;
    }
  }
  RingRows<kFusedTile, CH, KV> rows;
  rows.load(kv, b, split * split_len, cap);
  const Span sp(lengths[b], cap, window, split_len, split);
  const int t_begin = sp.t_begin, t_end = sp.t_end;
  if (t_begin >= t_end) {  // uniform over the block: no K/V to read
    if (sp.n_live == 0 && split == 0)
      for (int e = tid; e < G * D; e += kThreads) store(outp + e, 0.f);
    return;
  }
  if (t_begin != split * split_len) rows.load(kv, b, t_begin, t_end);

  const int n_tiles = (t_end - t_begin + kFusedTile - 1) / kFusedTile;
  auto issue = [&](int j) {  // tile j into stage j % kMmaStages (or nothing)
    if (j < n_tiles) {
      __nv_bfloat16* ks = ring + (j % kMmaStages) * Sm::stage;
      rows.copy(kv, b, h, t_begin + j * kFusedTile, t_end, ks,
                ks + kFusedTile * LD, LD);
      if (j + 1 < n_tiles)
        rows.load(kv, b, t_begin + (j + 1) * kFusedTile, t_end);
    }
    tc::cp_async_commit();  // an empty group past the last tile
  };
#pragma unroll
  for (int j = 0; j < kMmaStages - 1; ++j) issue(j);

  const float scale2 = scale * kLog2e;
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, l0 = 0.f;  // head gr (rows gr + 8 are zero)

  for (int j = 0; j < n_tiles; ++j) {
    tc::cp_async_wait<kMmaStages - 2>();  // tile j has landed
    __syncthreads();  // ... for every warp; stage (j - 1) % kMmaStages is free
    issue(j + kMmaStages - 1);
    const __nv_bfloat16* Kt =
        ring + (j % kMmaStages) * Sm::stage + 16 * th * LD;
    const __nv_bfloat16* Vt = Kt + kFusedTile * LD;

    // one accumulator a token column: at four blocks an SM the warps hide
    // the chain of dependent products, and the registers stay within 128
    float sc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
      uint32_t bk[4];
      tc::frag_b(bk, Kt, LD, 0, kk * 16, lane);
      tc::mma_bf16(sc[0], a, bk[0], bk[1]);
      tc::mma_bf16(sc[1], a, bk[2], bk[3]);
    }
    // head gr's scores of tokens tw + 8 nt + e; past the split's end -inf
    const int tw = t_begin + j * kFusedTile + 16 * th + 2 * t4;
    float x[2][2], mx = kNegInf;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        x[nt][e] = tw + 8 * nt + e < t_end ? sc[nt][e] * scale2 : -INFINITY;
        mx = fmaxf(mx, x[nt][e]);
      }
    const float mn = fmaxf(m0, tc::quad_max(mx));
    const float a0 = ex2(m0 - mn);
    float rs = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        x[nt][e] = ex2(x[nt][e] - mn);
        rs += x[nt][e];
      }
    l0 = l0 * a0 + tc::quad_sum(rs);
    m0 = mn;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
    }

    // O += P V over the warp's 16 tokens and half of D
    const uint32_t pa[4] = {tc::pack(x[0][0], x[0][1]), 0u,
                            tc::pack(x[1][0], x[1][1]), 0u};
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t bv[4];
      tc::frag_b_t(bv, Vt, LD, dh * (D / 2) + 8 * n, 0, lane);
      tc::mma_bf16(o[n], pa, bv[0], bv[1]);
      if (n + 1 < NT) tc::mma_bf16(o[n + 1], pa, bv[2], bv[3]);
    }
  }
  tc::cp_async_wait<0>();  // only empty groups remain
  __syncthreads();         // every warp is done with the ring

  // Merge the two token halves (warps th = 0, 1 of each half of D):
  // rescale each to the block max per head.
  if (t4 == 0) {
    wred[warp][gr][0] = m0;
    wred[warp][gr][1] = l0;
  }
  __syncthreads();
  const float M = fmaxf(wred[dh * 2][gr][0], wred[dh * 2 + 1][gr][0]);
  const float f = ex2(m0 - M);
  float* accs = reinterpret_cast<float*>(smem);  // [2][8][LD] over the ring
#pragma unroll
  for (int n = 0; n < NT; ++n)
    *reinterpret_cast<float2*>(accs + (th * 8 + gr) * LD + dh * (D / 2) +
                               8 * n + 2 * t4) =
        make_float2(o[n][0] * f, o[n][1] * f);
  if (tid < G) {
    const float Mb = fmaxf(wred[0][tid][0], wred[1][tid][0]);
    fin[tid][0] = Mb;
    fin[tid][1] = wred[0][tid][1] * ex2(wred[0][tid][0] - Mb) +
                  wred[1][tid][1] * ex2(wred[1][tid][0] - Mb);
  }
  __syncthreads();
  finish_split<__nv_bfloat16, D>(
      [&](int e) {
        const int g = e / D, d = e % D;
        return accs[g * LD + d] + accs[(8 + g) * LD + d];
      },
      fin, &is_last, reinterpret_cast<float4*>(smem), sp, split, row0, G, 0,
      G, outp, ml, acc_out,
      counters + static_cast<size_t>(b) * Hkv + h);
}

// grid (Hq, B); block kThreads.  out[b, hq, :] = sum_s w_s acc_s / sum_s w_s
// l_s with w_s = exp(m_s - max m), over the splits that saw a valid token,
// the splits reduced in parallel: thread group j of kThreads / (D / 4) sums
// splits j, j + groups, ... over a 4-float slice of D each, and the groups
// meet in shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ ml, const float* __restrict__ acc,
             T* __restrict__ out, int n_splits, int G, int D) {
  __shared__ __align__(16) float red[kThreads * 4];  // [groups][D]
  __shared__ float dred[kThreads];
  __shared__ float wmax[kThreads / 32];
  const int hq = blockIdx.x, b = blockIdx.y, Hq = gridDim.x;
  const int h = hq / G, g = hq % G, Hkv = Hq / G;
  const size_t row0 = (static_cast<size_t>(b) * Hkv + h) * n_splits;
  const int tid = threadIdx.x;

  float mx = kNegInf;  // max m over the splits that saw a valid token
  for (int s = tid; s < n_splits; s += kThreads) {
    const size_t r = (row0 + s) * G + g;
    if (ml[r * 2 + 1] > 0.f) mx = fmaxf(mx, ml[r * 2]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (tid % 32 == 0) wmax[tid / 32] = mx;
  __syncthreads();
  float M = kNegInf;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) M = fmaxf(M, wmax[w]);

  const int lanes = D / 4, groups = kThreads / lanes;
  const int lane = tid % lanes, grp = tid / lanes;
  float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
  float den = 0.f;
  // the loads come before the test of l, so that several splits' loads are
  // in flight at once; a split that saw no valid token (its acc never
  // written) is then skipped
#pragma unroll 4
  for (int s = grp; s < n_splits; s += groups) {
    const size_t r = (row0 + s) * G + g;
    const float2 m_l = *reinterpret_cast<const float2*>(ml + r * 2);
    const float4 a = *reinterpret_cast<const float4*>(acc + r * D + 4 * lane);
    if (m_l.y > 0.f) {
      const float w = expf(m_l.x - M);
      den += m_l.y * w;
      num.x += w * a.x;
      num.y += w * a.y;
      num.z += w * a.z;
      num.w += w * a.w;
    }
  }
  *reinterpret_cast<float4*>(red + grp * D + 4 * lane) = num;
  if (lane == 0) dred[grp] = den;
  __syncthreads();
  float den_all = 0.f;
  for (int j = 0; j < groups; ++j) den_all += dred[j];
  for (int d = tid; d < D; d += kThreads) {
    float sum = 0.f;
    for (int j = 0; j < groups; ++j) sum += red[j * D + d];
    store(out + (static_cast<size_t>(b) * Hq + hq) * D + d,
          den_all > 0.f ? sum / den_all : 0.f);
  }
}

template <int D, class KV>
cudaError_t launch_mma(const __nv_bfloat16* q, KV kv, const int* lengths,
                       float* ml, float* acc, int B, int Hkv, int G, int cap,
                       int window, float scale, int split_len, int n_splits,
                       cudaStream_t stream) {
  constexpr int smem = MmaSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      split_mma<D, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_hc = (G + kMmaHeads - 1) / kMmaHeads;
  split_mma<D, KV><<<dim3(n_splits, Hkv * n_hc, B), kThreads, smem, stream>>>(
      q, kv, lengths, cap, G, window, scale, split_len, ml, acc);
  return cudaGetLastError();
}

// Query heads a block of decode_fused: 8, or 4 when G <= 4 or for fp32 at
// D 256, which keeps qf and acc in registers.
template <int D, int MAXG, class KV>
cudaError_t launch_fused(const float* q, KV kv, const int* lengths,
                         float* out, float* ml, float* acc, int* counters,
                         int B, int Hkv, int G, int cap, int window,
                         float scale, int split_len, int n_splits,
                         cudaStream_t stream) {
  constexpr int smem = Fused<D, MAXG>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      decode_fused<D, MAXG, KV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_hc = (G + MAXG - 1) / MAXG;
  decode_fused<D, MAXG, KV>
      <<<dim3(n_splits, Hkv * n_hc, B), kThreads, smem, stream>>>(
          q, kv, lengths, cap, G, window, scale, split_len, out, ml, acc,
          counters);
  return cudaGetLastError();
}

template <int D, class KV>
cudaError_t launch_fused_mma(const __nv_bfloat16* q, KV kv, const int* lengths,
                             __nv_bfloat16* out, float* ml, float* acc,
                             int* counters, int B, int Hkv, int G, int cap,
                             int window, float scale, int split_len,
                             int n_splits, cudaStream_t stream) {
  constexpr int smem = FusedMmaSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      decode_fused_mma<D, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  decode_fused_mma<D, KV><<<dim3(n_splits, Hkv, B), kThreads, smem, stream>>>(
      q, kv, lengths, cap, G, window, scale, split_len, out, ml, acc,
      counters);
  return cudaGetLastError();
}

template <typename T, int D, class KV>
cudaError_t launch_d(const T* q, KV kv, const int* lengths, T* out, float* ml,
                     float* acc, int* counters, int B, int Hkv, int G,
                     int cap, int window, float scale, int split_len,
                     int n_splits, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (G <= 8)
      return launch_fused_mma<D, KV>(q, kv, lengths, out, ml, acc, counters,
                                     B, Hkv, G, cap, window, scale, split_len,
                                     n_splits, stream);
    cudaError_t err = launch_mma<D, KV>(q, kv, lengths, ml, acc, B, Hkv, G,
                                        cap, window, scale, split_len,
                                        n_splits, stream);
    if (err != cudaSuccess) return err;
    merge_kernel<T><<<dim3(Hkv * G, B), kThreads, 0, stream>>>(
        ml, acc, out, n_splits, G, D);
    return cudaGetLastError();
  } else if (G <= 4 || D > 128) {
    return launch_fused<D, 4, KV>(q, kv, lengths, out, ml, acc, counters, B,
                                  Hkv, G, cap, window, scale, split_len,
                                  n_splits, stream);
  } else {
    return launch_fused<D, 8, KV>(q, kv, lengths, out, ml, acc, counters, B,
                                  Hkv, G, cap, window, scale, split_len,
                                  n_splits, stream);
  }
}

// Supported: D in {16, 32, 64, 128, 256} in fp32 and bf16, any G >= 1
// (query heads per KV head).  Heads a block serves (kernels/__init__.py::
// decode_heads_per_block mirrors this): bf16 at G > 8, 16 (split_mma, then
// merge_kernel: two launches); bf16 at G <= 8, all G (decode_fused_mma: one
// launch); fp32, 8, or 4 when G <= 4 or at D 256 (decode_fused: one launch);
// a larger group runs as head chunks, each reading the KV group's cache
// once.  counters: B x Hkv x chunks int32,
// zero before and after the call (decode_fused's arrivals).
template <typename T, class KV>
cudaError_t launch(const void* q, KV kv, const int* lengths, void* out,
                   float* ml, float* acc, int* counters, int B, int Hkv, int G,
                   int D, int cap, int window, float scale, int split_len,
                   int n_splits, cudaStream_t stream) {
  if (G < 1) return cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  T* ot = static_cast<T*>(out);
#define DECODE_CASE(DD)                                                      \
  case DD:                                                                   \
    return launch_d<T, DD, KV>(qt, kv, lengths, ot, ml, acc, counters, B,    \
                               Hkv, G, cap, window, scale, split_len,        \
                               n_splits, stream);
  switch (D) {
    DECODE_CASE(16)
    DECODE_CASE(32)
    DECODE_CASE(64)
    DECODE_CASE(128)
    DECODE_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef DECODE_CASE
}

}  // namespace decode

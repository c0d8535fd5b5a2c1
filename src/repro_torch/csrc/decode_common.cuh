// Split-T (flash-decoding) GQA decode attention, shared by the contiguous
// (decode_attention.cu) and paged (paged_attention.cu) kernels.
//
// Bound on the H100: decode reads len x Hkv x D x 2 cache bytes per step and
// does 4 flops per cache element, far below the card's ~295 flops/byte ridge,
// so it is bound by device memory (3.35 TB/s).  The design moves each cache
// byte once and keeps enough loads in flight to reach that rate.  Two split
// kernels, chosen by (dtype, G) and nothing else:
//   * split_mma (bf16 at G > 8; recurrentgemma: 16 heads over 1 KV head):
//     one block serves 16 query heads of the KV group on the tensor cores
//     and reads each K/V row once (below);
//   * split_kernel (fp32, and bf16 at G <= 8: the llama serve shape and
//     every paged launch): CUDA cores, as follows.
// split_kernel:
//   * one block owns one (batch row, KV head, T split) and up to 8 query
//     heads of the KV group, so a K/V row loaded once serves them all; a
//     larger group (fp32 at G > 8) runs as head chunks, each reading the
//     rows once;
//   * the T axis is split over blocks (grid = splits x Hkv x chunks x B): the
//     (B, Hkv) grid alone is 32 blocks at 4 slots, far too few for 132 SMs;
//   * inside a block, a group of TPG = min(32, D*sizeof(T)/16) threads
//     covers one token row with 16-byte loads (neighbouring threads on
//     neighbouring addresses; two vectors a thread for fp32 at D = 256), so
//     a block streams 128/TPG rows at a time, kUnroll vectors deep;
//   * each thread group keeps an online softmax (m, l, acc) in registers;
//     the block merges its groups through shared memory and writes one
//     partial (m, l, acc) per split;
//   * splits past lengths[b] (or before the window) read no K/V at all.
// A second small kernel merges the splits: merge_kernel (the splits reduced
// in parallel) at G > 8; combine_kernel (one thread a value walking the
// splits) at G <= 8, kept so that the llama and paged paths give the outputs
// they gave before merge_kernel existed.  The wrapper's
// split plan (kernels/__init__.py::split_plan) counts the head chunks when
// filling the card and keeps the fp32 partials to 1/8 of the K/V bytes.
// Scores, softmax and accumulation are fp32; p is rounded to the cache's
// type before the PV product, as the Pallas kernels do.  A row with no
// valid token (lengths <= 0) yields 0, as the Pallas kernels do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sync.cuh"

namespace decode {

constexpr int kThreads = 128;
constexpr int kUnroll = 4;
constexpr float kNegInf = -1e30f;

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  using Raw = float4;
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
};

__device__ __forceinline__ void to_float(const float4& r, float* f) {
  f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
}

__device__ __forceinline__ void to_float(const uint4& r, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Contiguous cache (B, T, Hkv, D).
template <typename T> struct ContiguousKV {
  const T* k;
  const T* v;
  int T_len, Hkv, D;
  __device__ __forceinline__ size_t row(int b, int h, int t) const {
    return ((static_cast<size_t>(b) * T_len + t) * Hkv + h) * D;
  }
};

// Pages (NP, page, Hkv, D) read in place through page_table (B, maxp).
// Page ids are clipped to [0, NP-1] before any address is formed: a FAIL
// (-1) id or garbage past the length never leaves the page array.
template <typename T> struct PagedKV {
  const T* k;
  const T* v;
  const int* page_table;
  int NP, page, maxp, Hkv, D;
  __device__ __forceinline__ size_t row(int b, int h, int t) const {
    int p = page_table[b * maxp + t / page];
    p = min(max(p, 0), NP - 1);
    return ((static_cast<size_t>(p) * page + t % page) * Hkv + h) * D;
  }
};

// grid (n_splits, Hkv * n_hc, B); block kThreads.  Block (split, h * n_hc +
// hc, b) owns query heads [hc * MAXG, hc * MAXG + MAXG) of KV head h, with
// n_hc = ceil(G / MAXG) head chunks (kChunked; otherwise n_hc = 1 and the
// block owns all G <= MAXG heads), and writes, per (b, h, split, g) of its
// heads, ml = (running max m, sum l) and acc (D,) = sum_t exp(s_t - m) v_t.
template <typename T, int D, int MAXG, bool kChunked, class KV>
__global__ void __launch_bounds__(kThreads)
split_kernel(const T* __restrict__ q, KV kv, const int* __restrict__ lengths,
             int cap, int G, int window, float scale, int split_len,
             float* __restrict__ ml, float* __restrict__ acc_out) {
  using Raw = typename Vec<T>::Raw;
  constexpr int VEC = Vec<T>::N;
  constexpr int TPG = D / VEC < 32 ? D / VEC : 32;  // threads per token row
  constexpr int NV = D / (TPG * VEC);  // 16-byte vectors per thread and row
  constexpr int E = NV * VEC;          // elements per thread and row
  constexpr int UNROLL = kUnroll / NV > 0 ? kUnroll / NV : 1;
  static_assert(TPG >= 1 && (TPG & (TPG - 1)) == 0 && TPG * E == D,
                "a token row must map onto a power-of-two part of a warp");
  constexpr int NGROUPS = kThreads / TPG;

  const int n_hc = kChunked ? (G + MAXG - 1) / MAXG : 1;
  const int split = blockIdx.x, b = blockIdx.z;
  const int h = kChunked ? blockIdx.y / n_hc : blockIdx.y;
  const int g0 = kChunked ? (blockIdx.y % n_hc) * MAXG : 0;
  const int Gc = kChunked ? min(MAXG, G - g0) : G;
  const int n_splits = gridDim.x, Hkv = gridDim.y / n_hc;
  const int tid = threadIdx.x, lane = tid % TPG, grp = tid / TPG;
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

  // this thread's columns of a row: vector j covers (j * TPG + lane) * VEC
  float qf[MAXG][E];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < Gc) {
      const T* qp = q + ((static_cast<size_t>(b) * Hkv + h) * G + g0 + g) * D;
#pragma unroll
      for (int j = 0; j < NV; ++j)
        to_float(*reinterpret_cast<const Raw*>(qp + (j * TPG + lane) * VEC),
                 qf[g] + j * VEC);
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i) qf[g][i] = 0.f;
    }
  }

  float m[MAXG], l[MAXG], acc[MAXG][E];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[g][i] = 0.f;
  }

  // The trip count is uniform over the block, so every lane reaches every
  // shuffle; rows past t_end load nothing and are masked.
  for (int base = t_begin; base < t_end; base += NGROUPS * UNROLL) {
    Raw kr[UNROLL][NV], vr[UNROLL][NV];
    bool valid[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = base + u * NGROUPS + grp;
      valid[u] = t < t_end;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (valid[u]) {
          const size_t off = kv.row(b, h, t) + (j * TPG + lane) * VEC;
          kr[u][j] = *reinterpret_cast<const Raw*>(kv.k + off);
          vr[u][j] = *reinterpret_cast<const Raw*>(kv.v + off);
        } else {
          kr[u][j] = Raw{};
          vr[u][j] = Raw{};
        }
      }
    }

    float s[UNROLL][MAXG];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kf[E];
#pragma unroll
      for (int j = 0; j < NV; ++j) to_float(kr[u][j], kf + j * VEC);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < E; ++i) d = fmaf(qf[g][i], kf[i], d);
        s[u][g] = d;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
#pragma unroll
        for (int o = TPG / 2; o > 0; o >>= 1)
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], o);

    float p[UNROLL][MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        s[u][g] *= scale;
        if (valid[u]) mx = fmaxf(mx, s[u][g]);
      }
      const float alpha = expf(m[g] - mx);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        p[u][g] = valid[u] ? expf(s[u][g] - mx) : 0.f;
        psum += p[u][g];
      }
      l[g] = l[g] * alpha + psum;
      m[g] = mx;
#pragma unroll
      for (int i = 0; i < E; ++i) acc[g][i] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float vf[E];
#pragma unroll
      for (int j = 0; j < NV; ++j) to_float(vr[u][j], vf + j * VEC);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        const float pr = round_to(p[u][g], T{});
#pragma unroll
        for (int i = 0; i < E; ++i) acc[g][i] = fmaf(pr, vf[i], acc[g][i]);
      }
    }
  }

  // Merge the block's thread groups: rescale each group to the block max.
  __shared__ float sm_m[NGROUPS][MAXG];
  __shared__ float sm_l[NGROUPS][MAXG];
  __shared__ float sm_acc[NGROUPS][MAXG][D];
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
      const float f = expf(m[g] - M);
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          sm_acc[grp][g][(j * TPG + lane) * VEC + i] = acc[g][j * VEC + i] * f;
    }
  }
  __syncthreads();
  for (int e = tid; e < Gc * D; e += kThreads) {
    const int g = e / D, d = e % D;
    float sum = 0.f;
    for (int j = 0; j < NGROUPS; ++j) sum += sm_acc[j][g][d];
    acc_out[(out_row * G + g0) * D + e] = sum;
  }
  if (tid < Gc) {
    float M = kNegInf;
    for (int j = 0; j < NGROUPS; ++j) M = fmaxf(M, sm_m[j][tid]);
    float L = 0.f;
    for (int j = 0; j < NGROUPS; ++j) L += sm_l[j][tid] * expf(sm_m[j][tid] - M);
    ml[(out_row * G + g0 + tid) * 2] = M;
    ml[(out_row * G + g0 + tid) * 2 + 1] = L;
  }
}

// grid (Hq, B); block kThreads.  out[b, hq, :] = sum_s w_s acc_s / sum_s w_s l_s
// with w_s = exp(m_s - max m), over the splits that saw a valid token.
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ ml, const float* __restrict__ acc,
               T* __restrict__ out, int n_splits, int G, int D) {
  const int hq = blockIdx.x, b = blockIdx.y, Hq = gridDim.x;
  const int h = hq / G, g = hq % G, Hkv = Hq / G;
  const size_t row0 = (static_cast<size_t>(b) * Hkv + h) * n_splits;
  float M = kNegInf;
  for (int s = 0; s < n_splits; ++s) {
    const size_t r = (row0 + s) * G + g;
    if (ml[r * 2 + 1] > 0.f) M = fmaxf(M, ml[r * 2]);
  }
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float num = 0.f, den = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const size_t r = (row0 + s) * G + g;
      const float L = ml[r * 2 + 1];
      if (L > 0.f) {
        const float w = expf(ml[r * 2] - M);
        den += L * w;
        num += w * acc[r * D + d];
      }
    }
    store(out + (static_cast<size_t>(b) * Hq + hq) * D + d,
          den > 0.f ? num / den : 0.f);
  }
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
//     split_kernel;
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

// grid (Hq, B); block kThreads.  The same merge as combine_kernel with the
// splits reduced in parallel: thread group j of kThreads / (D / 4) sums
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

// Query heads per block: 8, or 4 when G <= 4 or when a thread holds more
// than one 16-byte vector of a row (fp32 at D = 256), which keeps qf and acc
// in registers and sm_acc within 32 KB.
template <typename T, int D, int MAXG, class KV>
cudaError_t launch_g(const T* q, KV kv, const int* lengths, float* ml,
                     float* acc, int B, int Hkv, int G, int cap, int window,
                     float scale, int split_len, int n_splits,
                     cudaStream_t stream) {
  const int n_hc = (G + MAXG - 1) / MAXG;
  const dim3 grid(n_splits, Hkv * n_hc, B);
  if (n_hc > 1)
    split_kernel<T, D, MAXG, true, KV><<<grid, kThreads, 0, stream>>>(
        q, kv, lengths, cap, G, window, scale, split_len, ml, acc);
  else
    split_kernel<T, D, MAXG, false, KV><<<grid, kThreads, 0, stream>>>(
        q, kv, lengths, cap, G, window, scale, split_len, ml, acc);
  return cudaGetLastError();
}

template <typename T, int D, class KV>
cudaError_t launch_d(const T* q, KV kv, const int* lengths, T* out, float* ml,
                     float* acc, int B, int Hkv, int G, int cap, int window,
                     float scale, int split_len, int n_splits,
                     cudaStream_t stream) {
  cudaError_t err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (G > 8)
      err = launch_mma<D, KV>(q, kv, lengths, ml, acc, B, Hkv, G, cap, window,
                              scale, split_len, n_splits, stream);
    else if (G <= 4)
      err = launch_g<T, D, 4, KV>(q, kv, lengths, ml, acc, B, Hkv, G, cap,
                                  window, scale, split_len, n_splits, stream);
    else
      err = launch_g<T, D, 8, KV>(q, kv, lengths, ml, acc, B, Hkv, G, cap,
                                  window, scale, split_len, n_splits, stream);
  } else if constexpr (D / Vec<T>::N > 32) {
    err = launch_g<T, D, 4, KV>(q, kv, lengths, ml, acc, B, Hkv, G, cap,
                                window, scale, split_len, n_splits, stream);
  } else if (G <= 4) {
    err = launch_g<T, D, 4, KV>(q, kv, lengths, ml, acc, B, Hkv, G, cap,
                                window, scale, split_len, n_splits, stream);
  } else {
    err = launch_g<T, D, 8, KV>(q, kv, lengths, ml, acc, B, Hkv, G, cap,
                                window, scale, split_len, n_splits, stream);
  }
  if (err != cudaSuccess) return err;
  if (G > 8)
    merge_kernel<T><<<dim3(Hkv * G, B), kThreads, 0, stream>>>(
        ml, acc, out, n_splits, G, D);
  else
    combine_kernel<T><<<dim3(Hkv * G, B), kThreads, 0, stream>>>(
        ml, acc, out, n_splits, G, D);
  return cudaGetLastError();
}

// Supported: D in {16, 32, 64, 128, 256} in fp32 and bf16, any G >= 1
// (query heads per KV head).  Heads a block serves (kernels/__init__.py::
// decode_heads_per_block mirrors this): bf16 at G > 8, 16 (split_mma);
// otherwise 8, or 4 when G <= 4 or for fp32 at D 256; a larger group runs
// as head chunks, each reading the KV group's cache once.
template <typename T, class KV>
cudaError_t launch(const void* q, KV kv, const int* lengths, void* out,
                   float* ml, float* acc, int B, int Hkv, int G, int D,
                   int cap, int window, float scale, int split_len,
                   int n_splits, cudaStream_t stream) {
  if (G < 1) return cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  T* ot = static_cast<T*>(out);
#define DECODE_CASE(DD)                                                     \
  case DD:                                                                  \
    return launch_d<T, DD, KV>(qt, kv, lengths, ot, ml, acc, B, Hkv, G, cap, \
                               window, scale, split_len, n_splits, stream);
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

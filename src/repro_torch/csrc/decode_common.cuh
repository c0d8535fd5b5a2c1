// Split-T (flash-decoding) GQA decode attention, shared by the contiguous
// (decode_attention.cu) and paged (paged_attention.cu) kernels.
//
// Bound on the H100: decode reads len x Hkv x D x 2 cache bytes per step and
// does 4 flops per cache element, far below the card's ~295 flops/byte ridge,
// so it is bound by device memory (3.35 TB/s).  The design moves each cache
// byte once and keeps enough loads in flight to reach that rate:
//   * one block owns one (batch row, KV head, T split) and up to 8 query
//     heads of the KV group, so a K/V row loaded once serves them all; a
//     group of more heads (recurrentgemma: 16 over 1 KV head) runs as
//     head chunks, each reading the rows once (so 16 heads read them twice);
//   * the T axis is split over blocks (grid = splits x Hkv x chunks x B): the
//     (B, Hkv) grid alone is 32 blocks at 4 slots, far too few for 132 SMs;
//   * inside a block, a group of TPG = min(32, D*sizeof(T)/16) threads
//     covers one token row with 16-byte loads (neighbouring threads on
//     neighbouring addresses; two vectors a thread for fp32 at D = 256), so
//     a block streams 128/TPG rows at a time, kUnroll vectors deep;
//   * each thread group keeps an online softmax (m, l, acc) in registers;
//     the block merges its groups through shared memory and writes one
//     partial (m, l, acc) per split; a second small kernel merges splits;
//   * splits past lengths[b] (or before the window) read no K/V at all.
// Scores, softmax and accumulation are fp32; p is rounded to the cache's
// type before the PV product, as the Pallas kernels do.  A row with no
// valid token (lengths <= 0) yields 0, as the Pallas kernels do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  if constexpr (D / Vec<T>::N > 32) {
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
  combine_kernel<T><<<dim3(Hkv * G, B), kThreads, 0, stream>>>(
      ml, acc, out, n_splits, G, D);
  return cudaGetLastError();
}

// Supported: D in {16, 32, 64, 128, 256} in fp32 and bf16, any G >= 1
// (query heads per KV head; more than 8 run as several head chunks, each
// reading the KV group's cache once).
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

// Split-T (flash-decoding) GQA decode attention, shared by the contiguous
// (decode_attention.cu) and paged (paged_attention.cu) kernels.
//
// Bound on the H100: decode reads len x Hkv x D x 2 cache bytes per step and
// does 4 flops per cache element, far below the card's ~295 flops/byte ridge,
// so it is bound by device memory (3.35 TB/s).  The design moves each cache
// byte once and keeps enough loads in flight to reach that rate:
//   * one block owns one (batch row, KV head, T split) and all G query heads
//     of the KV group, so a K/V row loaded once serves G heads;
//   * the T axis is split over blocks (grid = splits x Hkv x B): the
//     (B, Hkv) grid alone is 32 blocks at 4 slots, far too few for 132 SMs;
//   * inside a block, a group of TPG = D*sizeof(T)/16 threads covers one
//     token row with 16-byte loads (neighbouring threads on neighbouring
//     addresses), so a block streams 128/TPG rows at a time, kUnroll deep;
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

// grid (n_splits, Hkv, B); block kThreads.  Writes, per (b, h, split, g),
// ml = (running max m, sum l) and acc (D,) = sum_t exp(s_t - m) v_t.
template <typename T, int D, int MAXG, class KV>
__global__ void __launch_bounds__(kThreads)
split_kernel(const T* __restrict__ q, KV kv, const int* __restrict__ lengths,
             int cap, int G, int window, float scale, int split_len,
             float* __restrict__ ml, float* __restrict__ acc_out) {
  using Raw = typename Vec<T>::Raw;
  constexpr int VEC = Vec<T>::N;
  constexpr int TPG = D / VEC;
  static_assert(TPG >= 1 && TPG <= 32 && (TPG & (TPG - 1)) == 0,
                "a token row must map onto a power-of-two part of a warp");
  constexpr int NGROUPS = kThreads / TPG;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x, Hkv = gridDim.y;
  const int tid = threadIdx.x, lane = tid % TPG, grp = tid / TPG;
  const size_t out_row = (static_cast<size_t>(b) * Hkv + h) * n_splits + split;

  const int len = lengths[b];
  const int hi = min(len, cap);
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int t_begin = max(split * split_len, lo);
  const int t_end = min(split * split_len + split_len, hi);
  if (t_begin >= t_end) {  // uniform over the block: no K/V to read
    if (tid < G) {
      ml[(out_row * G + tid) * 2] = kNegInf;
      ml[(out_row * G + tid) * 2 + 1] = 0.f;
    }
    return;
  }

  float qf[MAXG][VEC];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      const T* qp = q + ((static_cast<size_t>(b) * Hkv + h) * G + g) * D +
                    lane * VEC;
      to_float(*reinterpret_cast<const Raw*>(qp), qf[g]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) qf[g][i] = 0.f;
    }
  }

  float m[MAXG], l[MAXG], acc[MAXG][VEC];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }

  // The trip count is uniform over the block, so every lane reaches every
  // shuffle; rows past t_end load nothing and are masked.
  for (int base = t_begin; base < t_end; base += NGROUPS * kUnroll) {
    Raw kr[kUnroll], vr[kUnroll];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * NGROUPS + grp;
      valid[u] = t < t_end;
      if (valid[u]) {
        const size_t off = kv.row(b, h, t) + lane * VEC;
        kr[u] = *reinterpret_cast<const Raw*>(kv.k + off);
        vr[u] = *reinterpret_cast<const Raw*>(kv.v + off);
      } else {
        kr[u] = Raw{};
        vr[u] = Raw{};
      }
    }

    float s[kUnroll][MAXG];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[VEC];
      to_float(kr[u], kf);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) d = fmaf(qf[g][i], kf[i], d);
        s[u][g] = d;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
#pragma unroll
        for (int o = TPG / 2; o > 0; o >>= 1)
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], o);

    float p[kUnroll][MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[u][g] *= scale;
        if (valid[u]) mx = fmaxf(mx, s[u][g]);
      }
      const float alpha = expf(m[g] - mx);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u][g] = valid[u] ? expf(s[u][g] - mx) : 0.f;
        psum += p[u][g];
      }
      l[g] = l[g] * alpha + psum;
      m[g] = mx;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][i] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float vf[VEC];
      to_float(vr[u], vf);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        const float pr = round_to(p[u][g], T{});
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[g][i] = fmaf(pr, vf[i], acc[g][i]);
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
    if (g < G) {
      float M = kNegInf;
      for (int j = 0; j < NGROUPS; ++j) M = fmaxf(M, sm_m[j][g]);
      const float f = expf(m[g] - M);
#pragma unroll
      for (int i = 0; i < VEC; ++i) sm_acc[grp][g][lane * VEC + i] = acc[g][i] * f;
    }
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D, d = e % D;
    float sum = 0.f;
    for (int j = 0; j < NGROUPS; ++j) sum += sm_acc[j][g][d];
    acc_out[out_row * G * D + e] = sum;
  }
  if (tid < G) {
    float M = kNegInf;
    for (int j = 0; j < NGROUPS; ++j) M = fmaxf(M, sm_m[j][tid]);
    float L = 0.f;
    for (int j = 0; j < NGROUPS; ++j) L += sm_l[j][tid] * expf(sm_m[j][tid] - M);
    ml[(out_row * G + tid) * 2] = M;
    ml[(out_row * G + tid) * 2 + 1] = L;
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

template <typename T, int D, class KV>
cudaError_t launch_d(const T* q, KV kv, const int* lengths, T* out, float* ml,
                     float* acc, int B, int Hkv, int G, int cap, int window,
                     float scale, int split_len, int n_splits,
                     cudaStream_t stream) {
  if constexpr (D / Vec<T>::N <= 32) {
    dim3 grid(n_splits, Hkv, B);
    if (G <= 4)
      split_kernel<T, D, 4, KV><<<grid, kThreads, 0, stream>>>(
          q, kv, lengths, cap, G, window, scale, split_len, ml, acc);
    else
      split_kernel<T, D, 8, KV><<<grid, kThreads, 0, stream>>>(
          q, kv, lengths, cap, G, window, scale, split_len, ml, acc);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    combine_kernel<T><<<dim3(Hkv * G, B), kThreads, 0, stream>>>(
        ml, acc, out, n_splits, G, D);
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
}

// Supported: D in {16, 32, 64, 128} (fp32) or {16, ..., 256} (bf16), G <= 8.
template <typename T, class KV>
cudaError_t launch(const void* q, KV kv, const int* lengths, void* out,
                   float* ml, float* acc, int B, int Hkv, int G, int D,
                   int cap, int window, float scale, int split_len,
                   int n_splits, cudaStream_t stream) {
  if (G < 1 || G > 8) return cudaErrorInvalidValue;
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

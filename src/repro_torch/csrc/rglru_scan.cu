// Diagonal linear recurrence h_t = a_t * h_{t-1} + b_t (the RG-LRU core of
// the hybrid family) over (B, S, W), from a zero state.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/rglru_scan/kernel.py::linear_scan_pallas (body
// _lru_kernel, block scan _scan_block).
//
// Bound on the H100: one multiply-add per element against at least 8 bytes
// read (a and b) and 4 written (h), so it is bound by device memory.  At the
// serving shape (B 2, S 3072, W 4096, fp32) a and b are read once and h is
// written once: 302 MB, 90 us at 3.35 TB/s.
//
// Design.  The Pallas grid (B, S/256) walks each row's sequence blocks in
// order with a (1, W) carry in VMEM.  On the card a thread per (batch,
// channel) alone would be 8192 threads at the serving shape, too few to keep
// enough loads in flight, so the sequence is cut into chunks of L steps and
// the scan runs in three launches, each parallel where order does not matter:
//   1. chunk_aggregates: per (batch, chunk, 4 channels), the chunk's product
//      of a and its end value from a zero state (the last chunk needs none);
//   2. chunk_carries: per (batch, 4 channels), a walk over the chunks that
//      turns the aggregates into the carry entering each chunk (in place);
//   3. chunk_scan: per (batch, chunk, 4 channels), the recurrence from the
//      chunk's carry, writing h in b's dtype; the last chunk writes h_last
//      from its fp32 carry (never rounded to b's dtype).
// Each thread owns 4 neighbouring channels: 16-byte loads of fp32 (8 bytes
// of bf16), neighbouring threads on neighbouring addresses along W, and an
// unrolled loop over t keeps kUnroll steps of loads in flight ahead of the
// dependent multiply-adds.  a and b are read twice (passes 1 and 3), so the
// kernel moves 5/3 of the bound's bytes; a fused single pass is a later
// speed item.  All arithmetic is fp32; any S works (the last chunk is
// ragged), where the Pallas kernel asserts S % blk == 0.  W % 4 == 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  f[0] = lo.x; f[1] = lo.y; f[2] = hi.x; f[3] = hi.y;
}

__device__ __forceinline__ void store4(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* f) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

// h = a * h + b for t in [t0, t1) of one row, 4 channels at column w; with
// an output, each h is stored.  The product and the sum are rounded apart
// (no fused multiply-add), as the plain version's eager products and sums.
template <typename TA, typename TB, bool kStore>
__device__ __forceinline__ void scan_run(const TA* a, const TB* b, TB* h_out,
                                         size_t row0, int W, int t0, int t1,
                                         float* h, float* prod) {
  int t = t0;
  for (; t + kUnroll <= t1; t += kUnroll) {
    float av[kUnroll][4], bv[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t off = row0 + static_cast<size_t>(t + u) * W;
      load4(a + off, av[u]);
      load4(b + off, bv[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[i] = __fadd_rn(__fmul_rn(av[u][i], h[i]), bv[u][i]);
        if constexpr (!kStore) prod[i] = __fmul_rn(prod[i], av[u][i]);
      }
      if constexpr (kStore)
        store4(h_out + row0 + static_cast<size_t>(t + u) * W, h);
    }
  }
  for (; t < t1; ++t) {
    float av[4], bv[4];
    const size_t off = row0 + static_cast<size_t>(t) * W;
    load4(a + off, av);
    load4(b + off, bv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __fadd_rn(__fmul_rn(av[i], h[i]), bv[i]);
      if constexpr (!kStore) prod[i] = __fmul_rn(prod[i], av[i]);
    }
    if constexpr (kStore) store4(h_out + off, h);
  }
}

// grid (ceil(W/4 / kThreads), nc - 1, B).  agg_a, agg_h (B, nc - 1, W).
template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
chunk_aggregates(const TA* __restrict__ a, const TB* __restrict__ b,
                 float* __restrict__ agg_a, float* __restrict__ agg_h, int S,
                 int W, int L) {
  const int w = (blockIdx.x * kThreads + threadIdx.x) * 4;
  if (w >= W) return;
  const int c = blockIdx.y, bb = blockIdx.z, nagg = gridDim.y;
  const int t0 = c * L, t1 = min(S, t0 + L);
  float h[4] = {0.f, 0.f, 0.f, 0.f}, prod[4] = {1.f, 1.f, 1.f, 1.f};
  const size_t row0 = static_cast<size_t>(bb) * S * W + w;
  scan_run<TA, TB, false>(a, b, nullptr, row0, W, t0, t1, h, prod);
  const size_t o = (static_cast<size_t>(bb) * nagg + c) * W + w;
  store4(agg_a + o, prod);
  store4(agg_h + o, h);
}

// grid (ceil(W/4 / kThreads), B).  Overwrites agg_h[b, c] with the carry
// entering chunk c + 1.
__global__ void __launch_bounds__(kThreads)
chunk_carries(const float* __restrict__ agg_a, float* __restrict__ agg_h,
              int W, int nagg) {
  const int w = (blockIdx.x * kThreads + threadIdx.x) * 4;
  if (w >= W) return;
  const int bb = blockIdx.y;
  float carry[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < nagg; ++c) {
    const size_t o = (static_cast<size_t>(bb) * nagg + c) * W + w;
    float pa[4], ph[4];
    load4(agg_a + o, pa);
    load4(agg_h + o, ph);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      carry[i] = __fadd_rn(__fmul_rn(pa[i], carry[i]), ph[i]);
    store4(agg_h + o, carry);
  }
}

// grid (ceil(W/4 / kThreads), nc, B).  h (B, S, W) in b's dtype; h_last
// (B, W) fp32.
template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
chunk_scan(const TA* __restrict__ a, const TB* __restrict__ b,
           const float* __restrict__ carries, TB* __restrict__ h_out,
           float* __restrict__ h_last, int S, int W, int L) {
  const int w = (blockIdx.x * kThreads + threadIdx.x) * 4;
  if (w >= W) return;
  const int c = blockIdx.y, bb = blockIdx.z, nc = gridDim.y;
  const int t0 = c * L, t1 = min(S, t0 + L);
  float h[4] = {0.f, 0.f, 0.f, 0.f};
  if (c > 0)
    load4(carries + (static_cast<size_t>(bb) * (nc - 1) + c - 1) * W + w, h);
  const size_t row0 = static_cast<size_t>(bb) * S * W + w;
  scan_run<TA, TB, true>(a, b, h_out, row0, W, t0, t1, h, nullptr);
  if (c == nc - 1) store4(h_last + static_cast<size_t>(bb) * W + w, h);
}

template <typename TA, typename TB>
cudaError_t launch(const void* a, const void* b, void* h, float* h_last,
                   float* agg_a, float* agg_h, int B, int S, int W, int L,
                   cudaStream_t st) {
  const TA* at = static_cast<const TA*>(a);
  const TB* bt = static_cast<const TB*>(b);
  const int nc = (S + L - 1) / L;
  const int wblocks = (W / 4 + kThreads - 1) / kThreads;
  if (nc > 1) {
    chunk_aggregates<TA, TB><<<dim3(wblocks, nc - 1, B), kThreads, 0, st>>>(
        at, bt, agg_a, agg_h, S, W, L);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    chunk_carries<<<dim3(wblocks, B), kThreads, 0, st>>>(agg_a, agg_h, W,
                                                         nc - 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  chunk_scan<TA, TB><<<dim3(wblocks, nc, B), kThreads, 0, st>>>(
      at, bt, agg_h, static_cast<TB*>(h), h_last, S, W, L);
  return cudaGetLastError();
}

}  // namespace

// a_dtype, b_dtype: 0 = float32, 1 = bfloat16.  a, b, h (B, S, W)
// contiguous, h in b's dtype; h_last (B, W) fp32; agg_a, agg_h (B, nc - 1,
// W) fp32 scratch with nc = ceil(S / L).  W % 4 == 0, 1 <= L.  Returns the
// CUDA error of the launches (0 on success).
extern "C" int rglru_scan_fwd(int a_dtype, int b_dtype, const void* a,
                              const void* b, void* h, float* h_last,
                              float* agg_a, float* agg_h, int B, int S, int W,
                              int L, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || W % 4 != 0 || L <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (a_dtype == 0 && b_dtype == 0)
    return launch<float, float>(a, b, h, h_last, agg_a, agg_h, B, S, W, L, st);
  if (a_dtype == 0 && b_dtype == 1)
    return launch<float, bf16>(a, b, h, h_last, agg_a, agg_h, B, S, W, L, st);
  if (a_dtype == 1 && b_dtype == 0)
    return launch<bf16, float>(a, b, h, h_last, agg_a, agg_h, B, S, W, L, st);
  if (a_dtype == 1 && b_dtype == 1)
    return launch<bf16, bf16>(a, b, h, h_last, agg_a, agg_h, B, S, W, L, st);
  return cudaErrorInvalidValue;
}

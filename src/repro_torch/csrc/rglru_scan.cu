// Diagonal linear recurrence h_t = a_t * h_{t-1} + b_t (the RG-LRU core of
// the hybrid family) over (B, S, W), from a zero state.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/rglru_scan/kernel.py::linear_scan_pallas (body
// _lru_kernel, block scan _scan_block).
//
// Bound on the H100: one multiply and one add per element against at least
// 8 bytes read (a and b) and 4 written (h), so it is bound by device
// memory.  At the serving shape (B 2, S 3072, W 4096, fp32) a and b are
// read once and h is written once: 302 MB, 90 us at 3.35 TB/s.
//
// Design: one launch, one streaming pass, no state between blocks.  The
// Pallas grid (B, S/256) walks each row's sequence blocks in order with a
// (1, W) carry in VMEM.  Here a block of kWarps = 8 warps owns 32
// neighbouring channels of the B x W channels (lane j: channel j) and
// walks the whole sequence in rounds of 8 chunks of L steps, one chunk a
// warp.  a and b are read exactly once and h written once (the bytes the
// bound counts); the carry between rounds stays in registers, so nothing
// crosses blocks: no carries in device memory, no status buffer, nothing
// to clear between calls, and concurrent calls on different streams share
// nothing.  What the design does about each limit:
//  * The serial chain.  One warp walking all S steps of its channels (the
//    simpler design, measured first) spends ~15 ns a step on its chain,
//    shared loads and stores even with no copies at all: ~46 us at S 3072,
//    which held bf16 at 0.084 ms against a 0.045 ms bound.  In a round each
//    warp folds its chunk into an aggregate from zero (A = the product of
//    its a, H = its recurrence from 0; two independent chains), the block
//    meets once (__syncthreads), each warp folds the round's earlier
//    aggregates into the carry entering its chunk (c = A c + H, in chunk
//    order, from the round's carry) and every warp the whole round's into
//    the next round's carry, and each warp then runs its chunk's h from its
//    carry.  Eight chunks run side by side, so a round's chain is ~2 L + 8
//    steps long for 8 L steps of sequence.
//  * Loads in flight.  Each warp streams its own chunks through a ring of
//    kRounds = 3 rounds in shared memory (two in flight while one is
//    computed), fed by cp.async: 16 bytes a copy (4 fp32 or 8 bf16
//    channels of one step; 4 bf16, 8 bytes, when W % 8 != 0), so one
//    instruction covers 4 or 8 steps.  A warp waits only for its own
//    copies.  L is the wrapper's plan (kernel.py::scan_plan): the longest
//    chunk that keeps two blocks an SM (16 steps in fp32, 32 in bf16;
//    100 KB of shared memory a block), so one block's meeting overlaps the
//    other's streaming.
//  * Stores.  Lane j stores h of its channel each step: a warp writes 128
//    contiguous bytes of h (64 in bf16) per step.
// Past S a chunk reads a = 1 and b = 0, which leave A, H and h exact.  The
// product and the sum are rounded apart (no fused multiply-add), as the
// plain version's eager products and sums, so h is bit-equal on every
// call to its twin in the same chunk order
// (ref.py::linear_scan_sequential_reference with chunk = L); the chunk
// boundaries round differently from a step-by-step walk (within 2e-6 at
// fp32).  h is written in b's dtype, h_last (fp32) from the register of
// step S - 1, never rounded to b's dtype.  Any S works; W % 4 == 0, so a
// copy never crosses a batch row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;   // channels a block
constexpr int kWarps = 8;    // chunks a round, one a warp
constexpr int kRounds = 3;   // ring of rounds, kRounds - 1 in flight

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// CH channels of type T (16 bytes, or 8 of 4 bf16) from global to shared
// memory.
template <typename T, int CH>
__device__ __forceinline__ void copy_ch(T* dst, const T* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (CH * sizeof(T) == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

// The copies of one lane into its warp's chunk of L steps x 32 channels
// of one tensor: CH channels a copy, 32 / CH lanes a step, so lane copies
// channels CH g .. + CH - 1 of steps r + CH i (i < L / CH).
template <typename T, int CH, int L>
struct Copies {
  static_assert(L % CH == 0, "a copy instruction covers CH steps");
  const T* src;  // channel c0 + CH g of step r of the sequence
  int so;        // shared offset of (step r, channel CH g) in a chunk
  bool in;       // the channels exist

  __device__ Copies(const T* x, int lane, int c0, int C, int S, int W) {
    const int g = lane % (kLanes / CH), r = lane / (kLanes / CH);
    const int cc = c0 + CH * g;
    in = cc < C;
    src = x + (in ? static_cast<size_t>(cc / W) * S * W + cc % W +
                        static_cast<size_t>(r) * W
                  : 0);
    so = r * kLanes + CH * g;
  }
  // steps t0 .. t0 + n - 1 into the chunk at dst (n = L: no checks)
  __device__ __forceinline__ void fetch(T* dst, int t0, int n,
                                        size_t W) const {
    if (!in) return;
    const T* p = src + static_cast<size_t>(t0) * W;
    const int r = so / kLanes;
    if (n == L) {
#pragma unroll
      for (int i = 0; i < L / CH; ++i)
        copy_ch<T, CH>(dst + so + CH * i * kLanes, p + CH * i * W);
    } else {
      for (int i = 0; i < L / CH && r + CH * i < n; ++i)
        copy_ch<T, CH>(dst + so + CH * i * kLanes, p + CH * i * W);
    }
  }
};

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float mul_add(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

// Shared memory of one block: each warp's ring of a and of b, then the
// chunk aggregates (A, H) of two rounds.
template <typename TA, typename TB, int L>
constexpr int smem_bytes() {
  return kWarps * kRounds * L * kLanes *
             static_cast<int>(sizeof(TA) + sizeof(TB)) +
         2 * kWarps * kLanes * 8;
}

// grid ceil(B W / 32) blocks of kWarps warps, dynamic shared memory
// smem_bytes().  a, b, h (B, S, W); h_last (B, W) fp32; C = B W channels,
// channel c is (c / W, c % W).
template <typename TA, typename TB, int L, int CA, int CB>
__global__ void __launch_bounds__(kWarps * kLanes)
    rglru_stream(const TA* __restrict__ a, const TB* __restrict__ b,
                 TB* __restrict__ h, float* __restrict__ h_last, int S, int W,
                 int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  constexpr int ring = kRounds * L * kLanes;  // elements of a warp's ring
  TA* as = reinterpret_cast<TA*>(smem) + warp * ring;
  TB* bs = reinterpret_cast<TB*>(reinterpret_cast<TA*>(smem) +
                                 kWarps * ring) + warp * ring;
  float2* agg = reinterpret_cast<float2*>(
      reinterpret_cast<TB*>(reinterpret_cast<TA*>(smem) + kWarps * ring) +
      kWarps * ring);  // [2][kWarps][32]

  const int c0 = blockIdx.x * kLanes;
  const Copies<TA, CA, L> ca(a, lane, c0, C, S, W);
  const Copies<TB, CB, L> cb(b, lane, c0, C, S, W);
  const size_t W_ = W;
  // the recurrence: lane computes channel c
  const int c = c0 + lane;
  const bool owns = c < C;
  TB* h_p = h + (owns ? static_cast<size_t>(c / W) * S * W_ + c % W : 0);
  const int n_rounds = (S + kWarps * L - 1) / (kWarps * L);

  // round q: this warp's chunk is steps (q kWarps + warp) L .. + L - 1
  auto fetch = [&](int q) {
    const int t0 = (q * kWarps + warp) * L;
    if (q < n_rounds && t0 < S) {
      const int n = min(S - t0, L);
      ca.fetch(as + (q % kRounds) * L * kLanes, t0, n, W_);
      cb.fetch(bs + (q % kRounds) * L * kLanes, t0, n, W_);
    }
    commit();  // an empty group past the last chunk keeps the count
  };

#pragma unroll
  for (int q = 0; q < kRounds - 1; ++q) fetch(q);

  float carry = 0.f;  // h entering the round, the same in every warp
  for (int q = 0; q < n_rounds; ++q) {
    wait_groups<kRounds - 2>();  // this warp's chunk of round q has landed
    __syncwarp();                // (every lane's copies); slot q - 1 is read
    fetch(q + kRounds - 1);      // into slot (q - 1) % kRounds
    const TA* ar = as + (q % kRounds) * L * kLanes + lane;
    const TB* br = bs + (q % kRounds) * L * kLanes + lane;
    const int t0 = (q * kWarps + warp) * L, n = min(max(S - t0, 0), L);
    // a and b of the chunk; past S a = 1 and b = 0, which leave h exact
    float av[L], bv[L];
    if (n == L) {
#pragma unroll
      for (int u = 0; u < L; ++u) {
        av[u] = to_f32(ar[u * kLanes]);
        bv[u] = to_f32(br[u * kLanes]);
      }
    } else {
#pragma unroll
      for (int u = 0; u < L; ++u) {
        av[u] = u < n ? to_f32(ar[u * kLanes]) : 1.f;
        bv[u] = u < n ? to_f32(br[u * kLanes]) : 0.f;
      }
    }
    // the chunk's aggregate from zero: h_end = A h_in + H
    float A = 1.f, H = 0.f;
#pragma unroll
    for (int u = 0; u < L; ++u) {
      A = __fmul_rn(A, av[u]);
      H = mul_add(av[u], H, bv[u]);
    }
    float2* ag = agg + (q & 1) * kWarps * kLanes;
    ag[warp * kLanes + lane] = make_float2(A, H);
    __syncthreads();
    // the carry into this warp's chunk folds the round's earlier chunks,
    // the next round's all of them, in chunk order
    float hin = carry;
    for (int j = 0; j < warp; ++j) {
      const float2 e = ag[j * kLanes + lane];
      hin = mul_add(e.x, hin, e.y);
    }
    carry = hin;
    for (int j = warp; j < kWarps; ++j) {
      const float2 e = ag[j * kLanes + lane];
      carry = mul_add(e.x, carry, e.y);
    }
    // the chunk's h from its carry
    float hv = hin;
#pragma unroll
    for (int u = 0; u < L; ++u) bv[u] = hv = mul_add(av[u], hv, bv[u]);
    if (owns && n > 0) {
      TB* hs = h_p + static_cast<size_t>(t0) * W_;
      if (n == L) {
#pragma unroll
        for (int u = 0; u < L; ++u, hs += W_) put(hs, bv[u]);
      } else {
        for (int u = 0; u < n; ++u, hs += W_) put(hs, bv[u]);
      }
      if (t0 + n == S) h_last[c] = hv;
    }
  }
  wait_groups<0>();  // only empty groups remain
}

template <typename TA, typename TB, int L, int CA, int CB>
cudaError_t launch_l(const void* a, const void* b, void* h, float* h_last,
                     int B, int S, int W, cudaStream_t st) {
  constexpr int smem = smem_bytes<TA, TB, L>();
  auto kernel = rglru_stream<TA, TB, L, CA, CB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long C = static_cast<long long>(B) * W;
  if (C > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int blocks = static_cast<int>((C + kLanes - 1) / kLanes);
  kernel<<<blocks, kWarps * kLanes, smem, st>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b),
      static_cast<TB*>(h), h_last, S, W, static_cast<int>(C));
  return cudaGetLastError();
}

// Channels a copy of T: 16 bytes, or 4 bf16 (8 bytes) when W % 8 != 0.
template <typename T>
constexpr int wide_ch() { return 16 / static_cast<int>(sizeof(T)); }

template <typename TA, typename TB, int L>
cudaError_t launch_w(const void* a, const void* b, void* h, float* h_last,
                     int B, int S, int W, cudaStream_t st) {
  constexpr int CA = wide_ch<TA>(), CB = wide_ch<TB>();
  if (W % CA == 0 && W % CB == 0)
    return launch_l<TA, TB, L, CA, CB>(a, b, h, h_last, B, S, W, st);
  return launch_l<TA, TB, L, 4, 4>(a, b, h, h_last, B, S, W, st);
}

template <typename TA, typename TB>
cudaError_t launch(const void* a, const void* b, void* h, float* h_last,
                   int B, int S, int W, int L, cudaStream_t st) {
  switch (L) {
    case 16: return launch_w<TA, TB, 16>(a, b, h, h_last, B, S, W, st);
    case 32: return launch_w<TA, TB, 32>(a, b, h, h_last, B, S, W, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// a_dtype, b_dtype: 0 = float32, 1 = bfloat16.  a, b, h (B, S, W)
// contiguous and 16-byte aligned, h in b's dtype; h_last (B, W) fp32.
// W % 4 == 0; steps (L, steps a chunk) 16 or 32.  Returns the CUDA error
// of the launch (0 on success).
extern "C" int rglru_scan_fwd(int a_dtype, int b_dtype, const void* a,
                              const void* b, void* h, float* h_last, int B,
                              int S, int W, int steps, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || W % 4 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (a_dtype == 0 && b_dtype == 0)
    return launch<float, float>(a, b, h, h_last, B, S, W, steps, st);
  if (a_dtype == 0 && b_dtype == 1)
    return launch<float, bf16>(a, b, h, h_last, B, S, W, steps, st);
  if (a_dtype == 1 && b_dtype == 0)
    return launch<bf16, float>(a, b, h, h_last, B, S, W, steps, st);
  if (a_dtype == 1 && b_dtype == 1)
    return launch<bf16, bf16>(a, b, h, h_last, B, S, W, steps, st);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of one block at (a_dtype, b_dtype, steps), 0 if
// none is built.
extern "C" int rglru_scan_smem(int a_dtype, int b_dtype, int steps) {
  if ((a_dtype != 0 && a_dtype != 1) || (b_dtype != 0 && b_dtype != 1) ||
      (steps != 16 && steps != 32))
    return 0;
  const int ea = a_dtype == 0 ? 4 : 2, eb = b_dtype == 0 ? 4 : 2;
  return kWarps * kRounds * steps * kLanes * (ea + eb) +
         2 * kWarps * kLanes * 8;
}

// Flash-attention forward (GQA; causal, window and q_offset) for training
// and prefill.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas (body
// _flash_kernel).
//
// Bound on the H100.  The two products do 4 * D flops for each visible
// (query, key) pair and query head.  Training shape (B 2, Sq = Sk = 1024,
// Hq 32, Hkv 8, D 128, causal): 17.2 GFLOP against 42 MB of q, k, v and out,
// ~410 flops per byte, above the card's ~295 flops/byte ridge: bound by
// operations, 17.4 us at 989 TFLOP/s in bf16.  recurrentgemma's prefill
// (B 2, S 3072, Hq 16, Hkv 1, D 256, causal, window 2048): 137 GFLOP
// against 107 MB, 0.139 ms, also operations.
//
// Three variants, chosen by (dtype, D) and nothing else:
//  * bf16 at D 64, 128 and 256: flash_fwd_hopper, below.
//  * bf16 at D 16 and 32: flash_fwd_bf16, mma.sync m16n8k16.
//  * fp32 at every D: flash_fwd_f32 on the CUDA cores (the tensor cores
//    would round fp32 inputs to TF32), below.
//
// flash_fwd_f32 is bound by the CUDA cores' FFMA rate (67 TFLOP/s: the
// training shape's 17.2 GFLOP take 0.257 ms).  What it does about each
// limit of the warp-per-16-rows kernel it replaces:
//  * Register-tiled outer products.  128 threads as 16 row groups x 8
//    column groups; thread (rg, cg) owns rows rg + 16 i (TM = BM / 16 of
//    them) and, in S = Q K^T, keys cg + 8 j (8 of a 64-key tile).  Q and
//    each K chunk lie row-major in shared memory with rows padded to
//    4 (mod 32) words, so a float4 along d from 8 neighbouring rows hits
//    all 32 banks: per 4 columns of d a thread loads TM + 8 float4 and
//    does 4 TM x 8 FFMAs (10.7 FFMAs a load at TM 4, 6.4 at D 256's TM 2).
//    In O += P V, P goes through shared memory (row-major) and the thread
//    owns its rows x D / 8 columns of O: per 4 keys TM float4 of P and 4
//    rows of V's columns, the same ratios.
//  * Row reductions.  The 8 threads of a row group share its rows: the
//    tile's max takes 3 shuffles a row; the sum stays per thread until the
//    end (every thread rescales by the same alpha).  exp2 domain, scale *
//    log2(e) folded into one FFMA on full tiles, as flash_fwd_hopper.
//  * Full, edge and skipped tiles, classified once per block from
//    tile_range and the block's rows: full tiles carry no mask.
//  * Copies overlap the products.  K and V stream through a three-stage
//    cp.async ring (16 bytes a thread) in chunks of 64 keys x DC = min(D,
//    64) columns: a tile is D / DC chunks of K, then as many of V; two
//    chunks are in flight while one is computed.  Q is copied once, with
//    the first chunk.
//  * Two blocks an SM at every D: 64 query rows a block at D <= 128, 32
//    at D 256 (shared memory: Q BM x (D + 4), the ring 3 x 64 x (DC + 4),
//    P BM x 68 floats: 37, 54, 87, 103 and 94 KB at D 16, 32, 64, 128 and
//    256; registers at most 255 by __launch_bounds__(128, 2)).
//  * Heaviest tiles first: blocks take query tiles from the last.
// Masked scores are -1e30 in the exp2 domain and keys past Sk -inf, as in
// flash_fwd_hopper; a row for which no tile runs is written as 0.  Its
// plain twin is kernels/flash_attention/ref.py::attention_reference_tiled
// at the tiles of kernel.py::F32_TILES.
//
// flash_fwd_hopper, and what it does about each limit of the mma.sync
// kernel it replaces at those head dims:
//  * Copies overlap the products.  A warp-specialised block: one producer
//    thread issues TMA copies of K/V tiles into a ring of stages (three at
//    D 64 and 128, two at D 256) with full/empty mbarriers; two consumer
//    warpgroups of 64 query rows each (128 rows a block) compute.  The
//    producer warpgroup gives up registers (setmaxnreg 24) and the
//    consumers take them (240).  The query tile is loaded once per item
//    and released after the item's last S, so the next item's query tile
//    lands while this item's last P V and epilogue run.
//  * The tensor cores run wgmma: S = Q K^T is m64nBNk16 with Q and K both
//    K-major in shared memory; O += P V is m64nDk16 (two n128 halves at
//    D 256) with P from registers and V MN-major (the transpose bit).  The
//    fp32 S accumulator is rounded to bf16 A fragments in place, so no
//    fragment is loaded by hand.  As in FlashAttention-3, a warpgroup
//    issues S of tile i with P V of tile i-1 and runs the softmax of tile
//    i while they run, and the two warpgroups take turns at the tensor
//    cores (named barriers), so one's softmax overlaps the other's
//    products.
//  * Shared tiles are 128-byte swizzled, as TMA writes them and wgmma
//    reads them: a row of D bf16 is D / 64 boxes of 64 columns, each box
//    BN rows of 128 bytes; the descriptors walk K across the boxes.
//  * Each key tile is classified once per item: skipped (no row sees it),
//    full (every pair visible) or edge (the diagonal, the window's lower
//    edge or Sk's edge).  Full and edge tiles are separate instantiations,
//    so full tiles carry no per-element mask: the softmax is bound by
//    issue slots, not by the exponentials.  The softmax runs in the exp2
//    domain with scale * log2(e) folded into one FFMA.
//  * Heaviest query tiles first, no tail: one block per SM walks the
//    (query tile, head, batch) items from the last query tile (the
//    longest under a mask) to the first, in a snake order over the grid.
//    An item's first K/V tiles are issued before its query tile.  Both
//    the persistent grid (against one block an item) and the snake order
//    (against the same order every round) are faster on the H100
//    (tools/flash_schedule_ab.py; numbers in PERF.md).
//  * D 256 keeps 128 rows a block: 64-key tiles, 192 KB of shared memory
//    (Q 64 KB, two stages of K and V 128 KB), a 128-register output
//    accumulator per consumer thread.
//  * The epilogue normalises by l, writes the block's rows into the last
//    tile's K/V stage (idle once both warpgroups' last P V is done),
//    swizzled as TMA reads it, and stores them with one TMA store a box,
//    which drops rows past Sq; the stage returns to the ring once the
//    store has read it.  The warps issue no global stores, whose
//    scattered 4-byte writes stalled them.
// TMA zero-fills rows past Sq and Sk; keys past Sk are set to -inf, so
// they add exactly 0.  Masked scores are -1e30 (in the exp2 domain), as in
// the Pallas kernel; P is rounded to bf16 before P V; sums are fp32.  A row
// for which no tile runs (l == 0) is written as 0, as the Pallas finalize
// does.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sync.cuh"
#include "wgmma.cuh"

namespace {

using tc::load_pair;
using tc::mma_bf16;
using tc::pack;
using tc::quad_max;
using tc::quad_sum;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockM = 16 * kWarps;  // query rows per block (mma.sync)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Shape {
  int B, Sq, Sk, Hq, Hkv, G, causal, window, q_offset;
  float scale;
};

// Key tiles [t0, t1) of bn keys that some query row of the block of bm rows
// starting at q0 sees.
__device__ __forceinline__ void tile_range(const Shape& s, int q0, int bm,
                                           int bn, int& t0, int& t1) {
  const int qmin = s.q_offset + q0;
  const int qmax = s.q_offset + min(q0 + bm, s.Sq) - 1;
  int lo = 0, hi = s.Sk;  // keys [lo, hi)
  if (s.causal) hi = min(hi, qmax + 1);
  if (s.window > 0) lo = max(lo, qmin - s.window + 1);
  t0 = lo / bn;
  t1 = hi > lo ? (hi + bn - 1) / bn : t0;
}

__device__ __forceinline__ bool visible(const Shape& s, int qpos, int kpos) {
  bool ok = true;
  if (s.causal) ok = ok && kpos <= qpos;
  if (s.window > 0) ok = ok && kpos > qpos - s.window;
  return ok;
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// bf16 at D 16 and 32: mma.sync m16n8k16 for both products
// ---------------------------------------------------------------------------

// Fragment layouts: mma_sync.cuh.  The S accumulators of two neighbouring
// 8-key tiles are, packed to bf16, the A fragment of P for the 16 keys they
// cover.  Each warp holds
// its 16 query rows' fragments in registers; K/V tiles are static shared
// memory.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ out, Shape s) {
  constexpr int BN = 64;     // keys a tile
  constexpr int LD = D + 8;  // shared row stride: fragment reads hit 32 banks
  __shared__ __align__(16) __nv_bfloat16 Ks[BN * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[BN * LD];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / s.G;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's rows
  const int qp0 = s.q_offset + r0, qp1 = s.q_offset + r1;

  const size_t q_stride = static_cast<size_t>(s.Hq) * D;
  const size_t kv_stride = static_cast<size_t>(s.Hkv) * D;
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * s.Sq * q_stride +
                            static_cast<size_t>(h) * D;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * s.Sk * kv_stride +
                            static_cast<size_t>(hk) * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * s.Sk * kv_stride +
                            static_cast<size_t>(hk) * D;

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    const bool in0 = r0 < s.Sq, in1 = r1 < s.Sq;
    qf[kk][0] = in0 ? load_pair(qb + r0 * q_stride + c) : 0u;
    qf[kk][1] = in1 ? load_pair(qb + r1 * q_stride + c) : 0u;
    qf[kk][2] = in0 ? load_pair(qb + r0 * q_stride + c + 8) : 0u;
    qf[kk][3] = in1 ? load_pair(qb + r1 * q_stride + c + 8) : 0u;
  }

  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  int t0, t1;
  tile_range(s, q0, kBlockM, BN, t0, t1);
  for (int tile = t0; tile < t1; ++tile) {
    const int k0 = tile * BN;
    __syncthreads();  // the previous tile's reads are done
    constexpr int kChunks = BN * D / 8;  // 16-byte chunks of one tile
    for (int i = tid; i < kChunks; i += kThreads) {
      const int row = i / (D / 8), ch = i % (D / 8);
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (k0 + row < s.Sk) {
        const size_t off = static_cast<size_t>(k0 + row) * kv_stride + ch * 8;
        kx = *reinterpret_cast<const uint4*>(kb + off);
        vx = *reinterpret_cast<const uint4*>(vb + off);
      }
      *reinterpret_cast<uint4*>(Ks + row * LD + ch * 8) = kx;
      *reinterpret_cast<uint4*>(Vs + row * LD + ch * 8) = vx;
    }
    __syncthreads();

    // S = Q K^T for the warp's 16 rows and the tile's BN keys
    float sc[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const __nv_bfloat16* kp = Ks + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(sc[nt], qf[kk], load_pair(kp), load_pair(kp + 8));
      }
    }

    // scale and mask; online softmax over the tile
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + nt * 8 + 2 * t + (e & 1);
        float x = sc[nt][e] * s.scale;
        if (kpos >= s.Sk)
          x = -INFINITY;  // past the edge: exp gives exactly 0
        else if (!visible(s, e < 2 ? qp0 : qp1, kpos))
          x = kNegInf;
        sc[nt][e] = x;
        if (e < 2)
          mx0 = fmaxf(mx0, x);
        else
          mx1 = fmaxf(mx1, x);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      sc[nt][0] = expf(sc[nt][0] - mn0);
      sc[nt][1] = expf(sc[nt][1] - mn0);
      sc[nt][2] = expf(sc[nt][2] - mn1);
      sc[nt][3] = expf(sc[nt][3] - mn1);
      rs0 += sc[nt][0] + sc[nt][1];
      rs1 += sc[nt][2] + sc[nt][3];
    }
    l0 = l0 * a0 + quad_sum(rs0);
    l1 = l1 * a1 + quad_sum(rs1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= a0;
      o[dt][1] *= a0;
      o[dt][2] *= a1;
      o[dt][3] *= a1;
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack(sc[2 * kk][0], sc[2 * kk][1]);
      a[1] = pack(sc[2 * kk][2], sc[2 * kk][3]);
      a[2] = pack(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      a[3] = pack(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      const __nv_bfloat16* vp = Vs + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* p = vp + dt * 8;
        mma_bf16(o[dt], a, pack(p[0], p[LD]), pack(p[8 * LD], p[9 * LD]));
      }
    }
  }

  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  __nv_bfloat16* ob = out + static_cast<size_t>(b) * s.Sq * q_stride +
                      static_cast<size_t>(h) * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (r0 < s.Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * q_stride + c) =
          __floats2bfloat162_rn(o[dt][0] * inv0, o[dt][1] * inv0);
    if (r1 < s.Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * q_stride + c) =
          __floats2bfloat162_rn(o[dt][2] * inv1, o[dt][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// fp32: register-tiled on the CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kStages = 3;     // ring of K/V chunks, kStages - 1 in flight

// Tiles at head dim D: BM query rows a block, BN keys a tile; K and V
// stream through the ring in chunks of BN keys x DC columns.
template <int D>
struct Tiles {
  static constexpr int BM = D > 128 ? 32 : 64;
  static constexpr int BN = 64;
  static constexpr int DC = D < 64 ? D : 64;
  static constexpr int NC = D / DC;       // chunks of K (and of V) a tile
  static constexpr int TM = BM / 16;      // rows a thread: rg + 16 i
  static constexpr int TN = BN / 8;       // keys a thread: cg + 8 j
  static constexpr int VW = DC / 8 < 4 ? DC / 8 : 4;   // vector of V, O
  static constexpr int NV = DC / 8 / VW;  // vectors a thread and chunk
  static constexpr int LDQ = D + 4;       // row strides ≡ 4 (mod 32) words:
  static constexpr int LDC = DC + 4;      // float4 reads of 8 rows hit 32
  static constexpr int LDP = BN + 4;      // banks
  static constexpr int floats = BM * LDQ + kStages * BN * LDC + BM * LDP;
  static constexpr int smem = floats * 4;
};

template <int VW>
__device__ __forceinline__ void ld_vec(float* f, const float* p) {
  if constexpr (VW == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    f[0] = v.x; f[1] = v.y;
  }
}

template <int VW>
__device__ __forceinline__ void st_vec(float* p, const float* f) {
  if constexpr (VW == 4)
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
}

// max over the 8 threads of a row group (lanes that differ in bits 0-2)
__device__ __forceinline__ float group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// grid ceil(Sq / BM) Hq B blocks of kThreads, dynamic shared memory
// Tiles<D>::smem.  Block i takes query tile n_m - 1 - i / (Hq B) of head
// and batch i % (Hq B), so the longest tiles under a causal mask start
// first.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  Shape s, float scale_log2) {
  using T = Tiles<D>;
  constexpr int BM = T::BM, BN = T::BN, DC = T::DC, NC = T::NC, TM = T::TM,
                TN = T::TN, VW = T::VW, NV = T::NV;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                          // BM x LDQ
  float* ring = Qs + BM * T::LDQ;            // kStages x BN x LDC
  float* Ps = ring + kStages * BN * T::LDC;  // BM x LDP

  const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;
  const int hb_n = s.Hq * s.B, n_m = (s.Sq + BM - 1) / BM;
  const int q0 = (n_m - 1 - static_cast<int>(blockIdx.x) / hb_n) * BM;
  const int h = blockIdx.x % hb_n % s.Hq, b = blockIdx.x % hb_n / s.Hq;
  const int hk = h / s.G;
  const size_t q_stride = static_cast<size_t>(s.Hq) * D;
  const size_t kv_stride = static_cast<size_t>(s.Hkv) * D;
  const float* qb = q + static_cast<size_t>(b) * s.Sq * q_stride +
                    static_cast<size_t>(h) * D;
  const float* kb = k + static_cast<size_t>(b) * s.Sk * kv_stride +
                    static_cast<size_t>(hk) * D;
  const float* vb = v + static_cast<size_t>(b) * s.Sk * kv_stride +
                    static_cast<size_t>(hk) * D;
  int t0, t1;
  tile_range(s, q0, BM, BN, t0, t1);
  const int n_chunks = (t1 - t0) * 2 * NC;

  // Q rows past Sq and K/V rows past Sk are zero-filled
  for (int i = tid; i < BM * D / 4; i += kThreads) {
    const int r = i / (D / 4), c4 = i % (D / 4);
    const bool in = q0 + r < s.Sq;
    tc::cp_async16(Qs + r * T::LDQ + 4 * c4,
                   in ? qb + (q0 + r) * q_stride + 4 * c4 : qb, in);
  }
  // chunk n: tile t0 + n / (2 NC); K columns (n % 2NC) DC.. first, then V
  auto fetch = [&](int n) {
    if (n < n_chunks) {
      const int w = n % (2 * NC), k0 = (t0 + n / (2 * NC)) * BN;
      const float* src = (w < NC ? kb : vb) + (w % NC) * DC;
      float* dst = ring + (n % kStages) * BN * T::LDC;
      for (int i = tid; i < BN * DC / 4; i += kThreads) {
        const int r = i / (DC / 4), c4 = i % (DC / 4);
        const bool in = k0 + r < s.Sk;
        tc::cp_async16(dst + r * T::LDC + 4 * c4,
                       in ? src + (k0 + r) * kv_stride + 4 * c4 : src, in);
      }
    }
    tc::cp_async_commit();  // Q joins chunk 0's group; empty past the last
  };
#pragma unroll
  for (int n = 0; n < kStages - 1; ++n) fetch(n);
  int n = 0;
  // the next chunk, once every thread's copies have landed and every
  // thread is done with the slot that the copies fetched here refill
  auto acquire = [&]() {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();
    fetch(n + kStages - 1);
    return static_cast<const float*>(ring + (n++ % kStages) * BN * T::LDC);
  };

  const int qmin = s.q_offset + q0;
  const int qmax = s.q_offset + min(q0 + BM, s.Sq) - 1;
  float m[TM], l[TM], acc[NC][TM][NV * VW];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < NV * VW; ++e) acc[c][i][e] = 0.f;
  }

  for (int tile = t0; tile < t1; ++tile) {
    // S = Q K^T: rows rg + 16 i, keys cg + 8 j; TM x TN products a d
    float sc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) sc[i][j] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float* kc = acquire();
#pragma unroll 4
      for (int d = 0; d < DC; d += 4) {
        float4 qv[TM], kv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          qv[i] = *reinterpret_cast<const float4*>(
              Qs + (rg + 16 * i) * T::LDQ + c * DC + d);
#pragma unroll
        for (int j = 0; j < TN; ++j)
          kv[j] = *reinterpret_cast<const float4*>(
              kc + (cg + 8 * j) * T::LDC + d);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            float x = fmaf(qv[i].x, kv[j].x, sc[i][j]);
            x = fmaf(qv[i].y, kv[j].y, x);
            x = fmaf(qv[i].z, kv[j].z, x);
            sc[i][j] = fmaf(qv[i].w, kv[j].w, x);
          }
      }
    }

    // online softmax in the exp2 domain, p = 2^(s * scale * log2(e) - m);
    // edge tiles are scaled and masked here, full tiles keep raw scores
    const int k0 = tile * BN;
    const bool full = k0 + BN <= s.Sk && (!s.causal || k0 + BN - 1 <= qmin) &&
                      (s.window <= 0 || k0 > qmax - s.window);
    if (!full) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int kpos = k0 + cg + 8 * j;
          float x = sc[i][j] * scale_log2;
          if (kpos >= s.Sk)
            x = -INFINITY;  // past the edge: exp2 gives exactly 0
          else if (!visible(s, qmin + rg + 16 * i, kpos))
            x = kNegInf;
          sc[i][j] = x;
        }
    }
    const float cs = full ? scale_log2 : 1.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mx = sc[i][0];
#pragma unroll
      for (int j = 1; j < TN; ++j) mx = fmaxf(mx, sc[i][j]);
      const float mn = fmaxf(m[i], group_max(mx) * cs);
      const float alpha = exp2_approx(m[i] - mn);
      m[i] = mn;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = exp2_approx(fmaf(sc[i][j], cs, -mn));
        rs += p;
        Ps[(rg + 16 * i) * T::LDP + cg + 8 * j] = p;
      }
      l[i] = l[i] * alpha + rs;  // this thread's keys; summed at the end
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < NV * VW; ++e) acc[c][i][e] *= alpha;
    }

    // O += P V: rows rg + 16 i, columns c DC + 8 VW v + VW cg + e
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float* vc = acquire();  // its barrier also publishes P
#pragma unroll 2
      for (int jj = 0; jj < BN; jj += 4) {
        float4 pv[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          pv[i] = *reinterpret_cast<const float4*>(
              Ps + (rg + 16 * i) * T::LDP + jj);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float vv[NV * VW];
#pragma unroll
          for (int w = 0; w < NV; ++w)
            ld_vec<VW>(vv + w * VW,
                       vc + (jj + u) * T::LDC + w * 8 * VW + cg * VW);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                          : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
            for (int e = 0; e < NV * VW; ++e)
              acc[c][i][e] = fmaf(p, vv[e], acc[c][i][e]);
          }
        }
      }
    }
  }
  tc::cp_async_wait<0>();  // only empty groups remain

  float* ob = out + static_cast<size_t>(b) * s.Sq * q_stride +
              static_cast<size_t>(h) * D;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const float ls = group_sum(l[i]);
    const float inv = ls > 0.f ? 1.f / ls : 0.f;
    const int r = q0 + rg + 16 * i;
    if (r >= s.Sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int w = 0; w < NV; ++w) {
        float o[VW];
#pragma unroll
        for (int e = 0; e < VW; ++e) o[e] = acc[c][i][w * VW + e] * inv;
        st_vec<VW>(ob + r * q_stride + c * DC + w * 8 * VW + cg * VW, o);
      }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   float* out, const Shape& s, cudaStream_t st) {
  constexpr int smem = Tiles<D>::smem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>((s.Sq + Tiles<D>::BM - 1) / Tiles<D>::BM) *
      s.Hq * s.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_f32<D><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      q, k, v, out, s, s.scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16 at D 64, 128 and 256: TMA ring, wgmma, warp specialisation
// ---------------------------------------------------------------------------

namespace hopper {

using wg::desc;
using wg::reg_fence;
using wg::wg_commit;
using wg::wg_fence;
using wg::wg_wait;
using wg::wgmma_rs;
using wg::wgmma_ss;

constexpr int kConsumers = 2;           // warpgroups of 64 query rows
constexpr int kBM = 64 * kConsumers;    // query rows per block
constexpr int kThreadsWS = 128 * (kConsumers + 1);  // + the producer's

// Keys per tile and ring stages.  Shared memory: Q kBM x D, then STAGES
// K tiles, then STAGES V tiles (BN x D each), then the barriers; every
// tile starts on a 1024-byte boundary, as the 128-byte swizzle needs.
template <int D>
struct Tiles {
  static constexpr int BN = D == 256 ? 64 : 128;
  static constexpr int STAGES = D == 256 ? 2 : 3;
  static constexpr int q_bytes = kBM * D * 2;
  static constexpr int kv_bytes = BN * D * 2;
  static constexpr int k_off = q_bytes;
  static constexpr int v_off = k_off + STAGES * kv_bytes;
  static constexpr int bar_off = v_off + STAGES * kv_bytes;
  static constexpr int smem = bar_off + (2 * STAGES + 2) * 8 + 1024;
  static_assert(q_bytes % 1024 == 0 && kv_bytes % 1024 == 0, "alignment");
  static_assert(smem <= 232448, "shared memory");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// `count` arrivals at once.
__device__ __forceinline__ void mbar_arrive(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a (D, H, S, B) tensor map into shared memory at dst.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int h, int row,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h),
      "r"(row), "r"(b)
      : "memory");
}

// One box from shared memory at src into a (D, H, S, B) tensor map; rows
// past the map's extent are dropped.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int d, int h, int row,
                                          int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(d), "r"(h), "r"(row), "r"(b)
      : "memory");
}

// Named barriers (0 is __syncthreads): kTurn + wg hands the tensor cores
// from one consumer warpgroup to the other; kEpilogue joins both consumer
// warpgroups, kEpilogue + 1 + wg one of them.
constexpr int kTurn = 1, kEpilogue = 3;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}


// One block per SM walks work items (query tile, head, batch): item
// r * gridDim.x + blockIdx.x in even rounds r and from the other end of the
// grid in odd ones.  Under a mask the items run from the last query tile
// (the longest) to the first, so the long diagonal items do not trail.
struct Work {
  int q0, h, b, t0, t1;
};

template <int D>
__device__ __forceinline__ bool work_of(const Shape& s, int r, Work& w) {
  const int n_m = (s.Sq + kBM - 1) / kBM, hb_n = s.Hq * s.B;
  const int it = r * gridDim.x +
                 (r & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  if (it >= n_m * hb_n) return false;
  int m = it / hb_n;
  if (s.causal || s.window > 0) m = n_m - 1 - m;
  const int hb = it % hb_n;
  w.h = hb % s.Hq;
  w.b = hb / s.Hq;
  w.q0 = m * kBM;
  tile_range(s, w.q0, kBM, Tiles<D>::BN, w.t0, w.t1);
  return true;
}

// Accumulator layout of m64nNk16 (f32), for thread tid of the warpgroup
// (warp w = tid / 32, g = lane / 4, t = lane % 4): d[4j + e] is row
// 16w + g (e < 2) or 16w + g + 8 (e >= 2), column 8j + 2t + (e & 1).  The
// A-fragment of k16 step kk from registers is {d[8kk] d[8kk+1]},
// {d[8kk+2] d[8kk+3]}, {d[8kk+4] d[8kk+5]}, {d[8kk+6] d[8kk+7]} packed to
// bf16: the S accumulator becomes P's A operand in place.
template <int D>
__global__ void __launch_bounds__(kThreadsWS, 1)
    flash_fwd_hopper(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap to,
                     __nv_bfloat16* __restrict__ out, Shape s,
                     float scale_log2) {
  using T = Tiles<D>;
  constexpr int BN = T::BN, ST = T::STAGES, NB = D / 64;  // NB boxes a row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + T::k_off, sv = base + T::v_off;
  const uint32_t full = base + T::bar_off, empty = full + 8 * ST;
  const uint32_t qfull = empty + 8 * ST, qempty = qfull + 8;

  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kConsumers * 128);
    }
    mbar_init(qfull, 1);
    mbar_init(qempty, kConsumers * 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer: one thread keeps the K/V ring full and loads each item's
    // query tile once its predecessor's last S is done.  An item's first
    // tiles go before its query tile (their slots free up while the
    // previous item ends).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers * 128) {
      Work w{};
      for (int r = 0, c = 0; work_of<D>(s, r, w); ++r) {
        const int hk = w.h / s.G, n = w.t1 - w.t0;
        auto load_tile = [&](int i) {
          const int st = (c + i) % ST, t = w.t0 + i;
          mbar_wait(empty + 8 * st, (((c + i) / ST) & 1) ^ 1);
          mbar_expect_tx(full + 8 * st, 2 * T::kv_bytes);
          for (int box = 0; box < NB; ++box) {
            const uint32_t off = st * T::kv_bytes + box * BN * 128;
            tma_load(sk + off, &tk, full + 8 * st, box * 64, hk, t * BN, w.b);
            tma_load(sv + off, &tv, full + 8 * st, box * 64, hk, t * BN, w.b);
          }
        };
        // the previous item's last slot stays busy until its output is out
        const int early = n < ST - 1 ? n : ST - 1;
        for (int i = 0; i < early; ++i) load_tile(i);
        mbar_wait(qempty, (r & 1) ^ 1);
        mbar_expect_tx(qfull, T::q_bytes);
        for (int box = 0; box < NB; ++box)
          tma_load(sq + box * kBM * 128, &tq, qfull, box * 64, w.h, w.q0,
                   w.b);
        for (int i = early; i < n; ++i) load_tile(i);
        c += n;
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, lane = tid % 32, t4 = lane % 4;
    const int r0 = wg * 64 + (tid / 32) * 16 + lane / 4;  // rows r0, r0 + 8
    const uint32_t q_wg = sq + wg * 64 * 128;

    float o[D / 2];
    float m0, m1, l0, l1;     // l: this thread's share of the row sums
    uint32_t pa[BN / 16][4];  // P of the previous tile, bf16 A fragments
    Work w{};
    int qmin, qmax, qp0, qp1;

    // O += P V for the tile in stage st: keys kk*16.. are rows of V; its
    // D columns span the boxes (lbo: one box to the next)
    auto pv = [&](int st) {
      const uint32_t vt = sv + st * T::kv_bytes;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint32_t v_k = vt + kk * 16 * 128;
        if constexpr (D == 256) {
          wgmma_rs<128>(o, pa[kk], desc(v_k, BN * 128, 1024));
          wgmma_rs<128>(o + 64, pa[kk],
                        desc(v_k + 2 * BN * 128, BN * 128, 1024));
        } else {
          wgmma_rs<D>(o, pa[kk], desc(v_k, BN * 128, 1024));
        }
      }
    };

    // Tile i of the item, at ring position c: the products S_i = Q K_i^T
    // and O += P_{i-1} V_{i-1} are issued together in this warpgroup's
    // turn; the softmax of S_i then runs while they and the other
    // warpgroup's products occupy the tensor cores.  O is rescaled once
    // P_{i-1} V_{i-1} is done.  Tile 0 (no P V yet) and edge tiles (masked
    // per element) are instantiations of their own, so that no branch
    // separates the products of a turn from their waits and full tiles
    // carry no mask.
    auto tile = [&](int c, int i, auto first, auto edge) {
      constexpr bool kFirst = decltype(first)::value;
      constexpr bool kEdge = decltype(edge)::value;
      const int st = c % ST, k0 = (w.t0 + i) * BN;
      mbar_wait(full + 8 * st, (c / ST) & 1);
      const uint32_t kt = sk + st * T::kv_bytes;
      float sc[BN / 2];
      bar_sync(kTurn + wg, 256);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t in_box = (kk % 4) * 32;
        wgmma_ss<BN>(sc, desc(q_wg + (kk / 4) * kBM * 128 + in_box, 16, 1024),
                     desc(kt + (kk / 4) * BN * 128 + in_box, 16, 1024),
                     kk > 0);
      }
      wg_commit();
      if constexpr (!kFirst) {
        pv((c - 1) % ST);
        wg_commit();
      }
      bar_arrive(kTurn + 1 - wg, 256);
      wg_wait<kFirst ? 0 : 1>();
      reg_fence<BN / 2>(sc);

      // online softmax in the exp2 domain: p = 2^(s * scale * log2(e) - m)
      float mx0 = kNegInf, mx1 = kNegInf;
      if constexpr (kEdge) {
        // this thread's key 8j + (e & 1) of the tile (from k0 + 2 t4) is
        // present below `in`, and visible to row qp from lo to hi
        const int base = k0 + 2 * t4, in = s.Sk - base;
        const int hi0 = s.causal ? qp0 - base : BN, hi1 = hi0 + 8 * s.causal;
        const int lo0 = s.window > 0 ? qp0 - s.window + 1 - base : -BN;
        const int lo1 = lo0 + 8 * (s.window > 0);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kc = 8 * j + (e & 1);
            float x = sc[4 * j + e] * scale_log2;
            if (kc >= in)
              x = -INFINITY;  // past the edge: exp2 gives exactly 0
            else if (kc > (e < 2 ? hi0 : hi1) || kc < (e < 2 ? lo0 : lo1))
              x = kNegInf;
            sc[4 * j + e] = x;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      // full tiles still hold raw scores: scale the maxima only
      const float c0 = kEdge ? 1.f : scale_log2;
      const float mn0 = fmaxf(m0, quad_max(mx0) * c0);
      const float mn1 = fmaxf(m1, quad_max(mx1) * c0);
      const float a0 = exp2_approx(m0 - mn0), a1 = exp2_approx(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        sc[4 * j + 0] = exp2_approx(fmaf(sc[4 * j + 0], c0, -mn0));
        sc[4 * j + 1] = exp2_approx(fmaf(sc[4 * j + 1], c0, -mn0));
        sc[4 * j + 2] = exp2_approx(fmaf(sc[4 * j + 2], c0, -mn1));
        sc[4 * j + 3] = exp2_approx(fmaf(sc[4 * j + 3], c0, -mn1));
        rs0 += sc[4 * j + 0] + sc[4 * j + 1];
        rs1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * a0 + rs0;
      l1 = l1 * a1 + rs1;

      if constexpr (!kFirst) {
        wg_wait<0>();
        reg_fence<D / 2>(o);
        reg_fence<BN / 16>(pa);
        mbar_arrive(empty + 8 * ((c - 1) % ST));
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 0] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      }
    };
    // a tile is full when every (row, key) pair of the item sees it
    auto is_full = [&](int i) {
      const int k0 = (w.t0 + i) * BN;
      return k0 + BN <= s.Sk && (!s.causal || k0 + BN - 1 <= qmin) &&
             (s.window <= 0 || k0 > qmax - s.window);
    };
    using Yes = std::true_type;
    using No = std::false_type;

    if (wg == 0) bar_arrive(kTurn, 256);  // warpgroup 0 goes first
    for (int r = 0, c = 0; work_of<D>(s, r, w); ++r) {
      qmin = s.q_offset + w.q0;
      qmax = s.q_offset + min(w.q0 + kBM, s.Sq) - 1;
      qp0 = qmin + r0;
      qp1 = qp0 + 8;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      m0 = m1 = kNegInf;
      l0 = l1 = 0.f;
      const int n = w.t1 - w.t0;
      mbar_wait(qfull, r & 1);
      if (n > 0) {
        if (is_full(0))
          tile(c, 0, Yes{}, No{});
        else
          tile(c, 0, Yes{}, Yes{});
      }
      for (int i = 1; i < n; ++i) {
        if (is_full(i))
          tile(c + i, i, No{}, No{});
        else
          tile(c + i, i, No{}, Yes{});
      }
      mbar_arrive(qempty);  // the item's last S is done: the next Q may land
      const int last = (c + n - 1) % ST;
      if (n > 0) {          // the last tile's P V
        wg_fence();
        pv(last);
        wg_commit();
        wg_wait<0>();
        reg_fence<D / 2>(o);
      }
      c += n;

      // epilogue: normalise; write the rows, swizzled as TMA reads them,
      // into the last tile's K/V stage (free once both warpgroups' last
      // P V is done) and store them with one TMA store a box, which drops
      // rows past Sq; the stage is released once the store has read it.
      // An item that sees no key writes its zeros directly.
      const float s0 = quad_sum(l0), s1 = quad_sum(l1);
      const float inv0 = s0 > 0.f ? 1.f / s0 : 0.f;
      const float inv1 = s1 > 0.f ? 1.f / s1 : 0.f;
      const int rr = r0 - wg * 64;  // row in the warpgroup's 64
      if (n == 0) {
        const size_t stride = static_cast<size_t>(s.Hq) * D;
        __nv_bfloat16* ob = out + static_cast<size_t>(w.b) * s.Sq * stride +
                            static_cast<size_t>(w.h) * D + 2 * t4;
        for (int j = 0; j < D / 8; ++j)
          for (int row = w.q0 + r0; row < w.q0 + r0 + 16; row += 8)
            if (row < s.Sq)
              *reinterpret_cast<uint32_t*>(ob + row * stride + 8 * j) = 0u;
        continue;
      }
      // warpgroup wg's box b: at D 256 the whole K (wg 0) or V (wg 1) tile
      // of the stage (64 rows); else rows 64 wg.. of the stage's K tile
      const uint32_t ot = (D == 256 && wg == 1 ? sv : sk) + last * T::kv_bytes +
                          (D == 256 ? 0 : wg * 64 * 128);
      bar_sync(kEpilogue, 256);  // both warpgroups' last products are done
      unsigned char* os = smem_raw + (ot - raw);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int box = j / 8, chunk = (j % 8) ^ (rr % 8);
        unsigned char* p = os + box * BN * 128 + rr * 128 + chunk * 16 + 4 * t4;
        *reinterpret_cast<uint32_t*>(p) =
            pack(o[4 * j] * inv0, o[4 * j + 1] * inv0);
        *reinterpret_cast<uint32_t*>(p + 8 * 128) =
            pack(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(kEpilogue + 1 + wg, 128);
      if (tid == 0) {
        for (int box = 0; box < NB; ++box)
          tma_store(&to, ot + box * BN * 128, box * 64, w.h, w.q0 + wg * 64,
                    w.b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(empty + 8 * last, 128);
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (B, S, H, D) bf16 tensor as a 4-D map (innermost first) whose box is
// 64 columns of one head over `rows` rows, swizzled 128 B; out-of-range
// rows read as zero.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
              int rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(H) * D * 2,
                                 static_cast<cuuint64_t>(S) * H * D * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const Shape& s, cudaStream_t st) {
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, q, s.B, s.Sq, s.Hq, D, kBM) ||
      !make_map(&to, out, s.B, s.Sq, s.Hq, D, 64) ||
      !make_map(&tk, k, s.B, s.Sk, s.Hkv, D, Tiles<D>::BN) ||
      !make_map(&tv, v, s.B, s.Sk, s.Hkv, D, Tiles<D>::BN))
    return cudaErrorInvalidValue;
  constexpr int smem = Tiles<D>::smem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_hopper<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev, sms;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const long long items =
      static_cast<long long>((s.Sq + kBM - 1) / kBM) * s.Hq * s.B;
  if (items * 2 > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int blocks = static_cast<int>(items < sms ? items : sms);
  flash_fwd_hopper<D><<<blocks, kThreadsWS, smem, st>>>(
      tq, tk, tv, to, static_cast<__nv_bfloat16*>(out), s, s.scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace hopper

template <int D>
cudaError_t launch_d(int dtype, const void* q, const void* k, const void* v,
                     void* out, const Shape& s, cudaStream_t st) {
  if (dtype == 1) {
    if constexpr (D <= 32) {
      const dim3 grid((s.Sq + kBlockM - 1) / kBlockM, s.Hq, s.B);
      flash_fwd_bf16<D><<<grid, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<__nv_bfloat16*>(out), s);
      return cudaGetLastError();
    }
    return cudaErrorInvalidValue;  // bf16 at D >= 64: the Hopper entry
  }
  return f32::launch<D>(static_cast<const float*>(q),
                        static_cast<const float*>(k),
                        static_cast<const float*>(v), static_cast<float*>(out),
                        s, st);
}

bool valid(int B, int Sq, int Sk, int Hq, int Hkv) {
  return Hkv > 0 && Hq % Hkv == 0 && Sq > 0 && Sk > 0 && B > 0;
}

}  // namespace

// q, out (B, Sq, Hq, D); k, v (B, Sk, Hkv, D), all contiguous and 16-byte
// aligned; Hq = Hkv * G; causal 0/1; window <= 0 means none; q_offset >= 0
// is the position of q's first row.  Each entry returns the CUDA error of
// the launch (0 on success).

// dtype 0 = float32 at D in {16, 32, 64, 128, 256}; dtype 1 = bfloat16 at
// D in {16, 32} (mma.sync).
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* out, int B, int Sq,
                                   int Sk, int Hq, int Hkv, int D, int causal,
                                   int window, int q_offset, float scale,
                                   void* stream) {
  if ((dtype != 0 && dtype != 1) || !valid(B, Sq, Sk, Hq, Hkv))
    return cudaErrorInvalidValue;
  const Shape s{B, Sq, Sk, Hq, Hkv, Hq / Hkv, causal, window, q_offset, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<16>(dtype, q, k, v, out, s, st);
    case 32: return launch_d<32>(dtype, q, k, v, out, s, st);
    case 64: return launch_d<64>(dtype, q, k, v, out, s, st);
    case 128: return launch_d<128>(dtype, q, k, v, out, s, st);
    case 256: return launch_d<256>(dtype, q, k, v, out, s, st);
    default: return cudaErrorInvalidValue;
  }
}

// bfloat16 at D in {64, 128, 256}: the Hopper kernel (TMA, wgmma).
extern "C" int flash_attention_fwd_wgmma(const void* q, const void* k,
                                         const void* v, void* out, int B,
                                         int Sq, int Sk, int Hq, int Hkv,
                                         int D, int causal, int window,
                                         int q_offset, float scale,
                                         void* stream) {
  if (!valid(B, Sq, Sk, Hq, Hkv)) return cudaErrorInvalidValue;
  const Shape s{B, Sq, Sk, Hq, Hkv, Hq / Hkv, causal, window, q_offset, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return hopper::launch<64>(q, k, v, out, s, st);
    case 128: return hopper::launch<128>(q, k, v, out, s, st);
    case 256: return hopper::launch<256>(q, k, v, out, s, st);
    default: return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of the fp32 kernel at head_dim D (0 if none).
extern "C" int flash_attention_f32_smem(int D) {
  switch (D) {
    case 16: return f32::Tiles<16>::smem;
    case 32: return f32::Tiles<32>::smem;
    case 64: return f32::Tiles<64>::smem;
    case 128: return f32::Tiles<128>::smem;
    case 256: return f32::Tiles<256>::smem;
    default: return 0;
  }
}

// Dynamic shared memory of the Hopper kernel at head_dim D (0 if none).
extern "C" int flash_attention_wgmma_smem(int D) {
  switch (D) {
    case 64: return hopper::Tiles<64>::smem;
    case 128: return hopper::Tiles<128>::smem;
    case 256: return hopper::Tiles<256>::smem;
    default: return 0;
  }
}

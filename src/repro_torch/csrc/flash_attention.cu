// Flash-attention forward (GQA; causal, window and q_offset) for training
// and prefill.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas (body
// _flash_kernel).
//
// Bound on the H100: at the training shape (B 2, Sq = Sk = 1024, Hq 32,
// Hkv 8, D 128, causal) the two products do 4 * D flops for each of the
// B * Hq * 524,800 visible (query, key) pairs, 17.2 GFLOP, against 42 MB of
// q, k, v and out: ~410 flops per byte, above the card's ~295 flops/byte
// ridge, so the kernel is bound by operations (989 TFLOP/s in bf16: 17.4 us).
//
// Design:
//  * One block of 4 warps owns 64 query rows of one (batch, query head):
//    grid = (ceil(Sq / 64), Hq, B), 1024 blocks at the training shape.  Query
//    head h reads KV head h / G; repeated K/V is never formed.
//  * The Pallas grid walks its K axis in order on one core with (m, l, acc)
//    in VMEM scratch.  Here each block loops over K/V tiles staged in shared
//    memory and keeps m, l and acc in registers.
//  * Tiles that no row of the block can see (past the causal diagonal, or
//    before the window) are skipped, as the Pallas kernel's pl.when does.
//    The ragged edge of Sq and Sk is masked, so any Sq and Sk work (the
//    Pallas kernel asserts divisibility).
//  * bf16: each warp keeps its 16 query rows in registers as mma fragments;
//    S = Q K^T and O += P V are mma.sync m16n8k16 (bf16 in, fp32 sums), and
//    P is rounded to bf16 for the second product, as in the Pallas kernel.
//  * bf16 at D = 256 (recurrentgemma): the fp32 output accumulator alone is
//    128 registers a thread, and 64-key K/V tiles would need 67.6 KB, over
//    the 48 KB of static shared memory.  So the query tile sits in shared
//    memory and each k-step reads its fragment there (4 registers instead
//    of 64), the key tiles are 32 rows, and Q, K and V tiles (67.6 KB) are
//    dynamic shared memory.  D <= 128 keep the layout above.
//  * fp32: the same tiling on the CUDA cores, since the tensor cores would
//    round fp32 inputs to TF32 (at D = 256, 141 KB of dynamic shared
//    memory).
// Masked scores are -1e30, as in the Pallas kernel; keys past Sk add exactly
// 0.  A row for which no tile runs (l == 0) is written as 0, as the Pallas
// finalize does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockM = 16 * kWarps;  // query rows per block
constexpr float kNegInf = -1e30f;

struct Shape {
  int B, Sq, Sk, Hq, Hkv, G, causal, window, q_offset;
  float scale;
};

// Key tiles [t0, t1) that some query row of the block starting at q0 sees.
__device__ __forceinline__ void tile_range(const Shape& s, int q0, int bn,
                                           int& t0, int& t1) {
  const int qmin = s.q_offset + q0;
  const int qmax = s.q_offset + min(q0 + kBlockM, s.Sq) - 1;
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16 for both products
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two values into one register, the first in the low half (the element of
// the lower index in every mma fragment).
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layouts (PTX ISA, mma.m16n8k16, g = lane / 4, t = lane % 4):
//   A 16x16: {a0,a1} row g, cols 2t..2t+1; {a2,a3} row g+8; {a4,a5} row g,
//            cols 2t+8..; {a6,a7} row g+8, cols 2t+8..
//   B 16x8:  {b0,b1} rows 2t..2t+1, col g; {b2,b3} rows 2t+8..2t+9
//   C 16x8:  {c0,c1} row g, cols 2t..2t+1; {c2,c3} row g+8
// So the S accumulators of two neighbouring 8-key tiles are, packed to
// bf16, the A fragment of P for the 16 keys they cover.
//
// kQShared: the query tile lives in shared memory (with K and V, all in
// dynamic shared memory of bf16_smem_bytes<D, BN>()) and each k-step reads
// its A fragment there; otherwise each warp holds its rows' fragments in
// registers and K/V tiles are static shared memory.
template <int D, int BN>
constexpr int bf16_smem_bytes() {
  return (kBlockM + 2 * BN) * (D + 8) * 2;
}

template <int D, int BN, bool kQShared>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ out, Shape s) {
  constexpr int LD = D + 8;  // shared row stride: fragment reads hit 32 banks
  __nv_bfloat16 *Qs = nullptr, *Ks, *Vs;
  if constexpr (kQShared) {
    extern __shared__ __align__(16) unsigned char flash_bf16_smem[];
    Qs = reinterpret_cast<__nv_bfloat16*>(flash_bf16_smem);
    Ks = Qs + kBlockM * LD;
    Vs = Ks + BN * LD;
  } else {
    __shared__ __align__(16) __nv_bfloat16 Ks_static[BN * LD];
    __shared__ __align__(16) __nv_bfloat16 Vs_static[BN * LD];
    Ks = Ks_static;
    Vs = Vs_static;
  }

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

  uint32_t qf[kQShared ? 1 : D / 16][4];
  if constexpr (kQShared) {
    // rows past Sq are zero; the first tile's __syncthreads publishes them
    for (int i = tid; i < kBlockM * D / 8; i += kThreads) {
      const int row = i / (D / 8), ch = i % (D / 8);
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + row < s.Sq)
        x = *reinterpret_cast<const uint4*>(qb + (q0 + row) * q_stride +
                                            ch * 8);
      *reinterpret_cast<uint4*>(Qs + row * LD + ch * 8) = x;
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      const bool in0 = r0 < s.Sq, in1 = r1 < s.Sq;
      qf[kk][0] = in0 ? load_pair(qb + r0 * q_stride + c) : 0u;
      qf[kk][1] = in1 ? load_pair(qb + r1 * q_stride + c) : 0u;
      qf[kk][2] = in0 ? load_pair(qb + r0 * q_stride + c + 8) : 0u;
      qf[kk][3] = in1 ? load_pair(qb + r1 * q_stride + c + 8) : 0u;
    }
  }

  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  int t0, t1;
  tile_range(s, q0, BN, t0, t1);
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
      const uint32_t* qa;
      uint32_t qs[4];
      if constexpr (kQShared) {
        const __nv_bfloat16* qp = Qs + (warp * 16 + g) * LD + kk * 16 + 2 * t;
        qs[0] = load_pair(qp);
        qs[1] = load_pair(qp + 8 * LD);
        qs[2] = load_pair(qp + 8);
        qs[3] = load_pair(qp + 8 * LD + 8);
        qa = qs;
      } else {
        qa = qf[kk];
      }
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const __nv_bfloat16* kp = Ks + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(sc[nt], qa, load_pair(kp), load_pair(kp + 8));
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
// fp32: the same tiling on the CUDA cores
// ---------------------------------------------------------------------------

template <int D>
struct F32Tile {
  static constexpr int BN = 32;       // keys per tile: one per lane
  static constexpr int LDQ = D + 4;   // float4 rows; conflict-free K reads
  static constexpr int LDK = D + 4;
  static constexpr int LPR = D < 32 ? D : 32;  // lanes per output row
  static constexpr int RPP = 32 / LPR;         // rows per pass
  static constexpr int NC = D / LPR;           // columns per lane and row
  static constexpr int NPASS = 16 / RPP;
  static constexpr size_t floats = kBlockM * LDQ + BN * LDK + BN * D +
                                   kWarps * 16 * BN + kWarps * 16;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  Shape s) {
  using F = F32Tile<D>;
  constexpr int BN = F::BN;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                     // kBlockM x LDQ
  float* Ks = Qs + kBlockM * F::LDQ;    // BN x LDK
  float* Vs = Ks + BN * F::LDK;         // BN x D
  float* Ps = Vs + BN * D;              // kWarps x 16 x BN
  float* Al = Ps + kWarps * 16 * BN;    // kWarps x 16: alpha, then 1 / l

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / s.G;
  const size_t q_stride = static_cast<size_t>(s.Hq) * D;
  const size_t kv_stride = static_cast<size_t>(s.Hkv) * D;
  const float* qb = q + static_cast<size_t>(b) * s.Sq * q_stride +
                    static_cast<size_t>(h) * D;
  const float* kb = k + static_cast<size_t>(b) * s.Sk * kv_stride +
                    static_cast<size_t>(hk) * D;
  const float* vb = v + static_cast<size_t>(b) * s.Sk * kv_stride +
                    static_cast<size_t>(hk) * D;

  for (int i = tid; i < kBlockM * D; i += kThreads) {
    const int r = i / D, d = i % D;
    Qs[r * F::LDQ + d] = q0 + r < s.Sq ? qb[(q0 + r) * q_stride + d] : 0.f;
  }

  // softmax state of the warp's 16 rows, the same in every lane
  float m[16], l[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  // output (pass p, column chunk c): row p * RPP + lr, column c0 + c * LPR
  const int lr = lane / F::LPR, c0 = lane % F::LPR;
  float acc[F::NPASS][F::NC];
#pragma unroll
  for (int p = 0; p < F::NPASS; ++p)
#pragma unroll
    for (int c = 0; c < F::NC; ++c) acc[p][c] = 0.f;

  float* Pw = Ps + warp * 16 * BN;
  float* Aw = Al + warp * 16;
  int t0, t1;
  tile_range(s, q0, BN, t0, t1);
  for (int tile = t0; tile < t1; ++tile) {
    const int k0 = tile * BN;
    __syncthreads();
    for (int i = tid; i < BN * D; i += kThreads) {
      const int row = i / D, d = i % D;
      const bool in = k0 + row < s.Sk;
      const size_t off = static_cast<size_t>(k0 + row) * kv_stride + d;
      Ks[row * F::LDK + d] = in ? kb[off] : 0.f;
      Vs[row * D + d] = in ? vb[off] : 0.f;
    }
    __syncthreads();

    // scores of the warp's 16 rows against key k0 + lane
    float sc[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) sc[r] = 0.f;
    const float* kr = Ks + lane * F::LDK;
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(
            Qs + (warp * 16 + r) * F::LDQ + d);
        float x = sc[r];
        x = fmaf(qv.x, kv.x, x);
        x = fmaf(qv.y, kv.y, x);
        x = fmaf(qv.z, kv.z, x);
        sc[r] = fmaf(qv.w, kv.w, x);
      }
    }
    const int kpos = k0 + lane;
    const bool in_range = kpos < s.Sk;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int qpos = s.q_offset + q0 + warp * 16 + r;
      float x = sc[r] * s.scale;
      if (!visible(s, qpos, kpos)) x = kNegInf;
      const float mn = fmaxf(m[r], warp_max(in_range ? x : kNegInf));
      const float p = in_range ? expf(x - mn) : 0.f;
      const float alpha = expf(m[r] - mn);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = mn;
      Pw[r * BN + lane] = p;
      if (lane == 0) Aw[r] = alpha;
    }
    __syncwarp();

#pragma unroll
    for (int p = 0; p < F::NPASS; ++p) {
      const int row = p * F::RPP + lr;
      const float al = Aw[row];
      const float* pr = Pw + row * BN;
#pragma unroll
      for (int c = 0; c < F::NC; ++c) {
        const int col = c0 + c * F::LPR;
        float a = acc[p][c] * al;
#pragma unroll 8
        for (int j = 0; j < BN; ++j) a = fmaf(pr[j], Vs[j * D + col], a);
        acc[p][c] = a;
      }
    }
    __syncwarp();
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < 16; ++r) Aw[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  }
  __syncwarp();
  float* ob = out + static_cast<size_t>(b) * s.Sq * q_stride +
              static_cast<size_t>(h) * D;
#pragma unroll
  for (int p = 0; p < F::NPASS; ++p) {
    const int row = p * F::RPP + lr;
    const int qr = q0 + warp * 16 + row;
    if (qr >= s.Sq) continue;
#pragma unroll
    for (int c = 0; c < F::NC; ++c)
      ob[qr * q_stride + c0 + c * F::LPR] = acc[p][c] * Aw[row];
  }
}

template <int D>
cudaError_t launch_d(int dtype, const void* q, const void* k, const void* v,
                     void* out, const Shape& s, cudaStream_t st) {
  const dim3 grid((s.Sq + kBlockM - 1) / kBlockM, s.Hq, s.B);
  if (dtype == 1) {
    const auto* qt = static_cast<const __nv_bfloat16*>(q);
    const auto* kt = static_cast<const __nv_bfloat16*>(k);
    const auto* vt = static_cast<const __nv_bfloat16*>(v);
    auto* ot = static_cast<__nv_bfloat16*>(out);
    if constexpr (D <= 128) {
      flash_fwd_bf16<D, 64, false><<<grid, kThreads, 0, st>>>(qt, kt, vt, ot,
                                                               s);
    } else {
      constexpr int smem = bf16_smem_bytes<D, 32>();
      cudaError_t err = cudaFuncSetAttribute(
          flash_fwd_bf16<D, 32, true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      flash_fwd_bf16<D, 32, true><<<grid, kThreads, smem, st>>>(qt, kt, vt,
                                                                 ot, s);
    }
    return cudaGetLastError();
  }
  const int smem = static_cast<int>(F32Tile<D>::floats * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_f32<D><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), s);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, out (B, Sq, Hq, D); k, v (B, Sk,
// Hkv, D), all contiguous; Hq = Hkv * G; D in {16, 32, 64, 128, 256}; causal
// 0/1; window <= 0 means none; q_offset >= 0 is the position of q's first
// row.  Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* out, int B, int Sq,
                                   int Sk, int Hq, int Hkv, int D, int causal,
                                   int window, int q_offset, float scale,
                                   void* stream) {
  if ((dtype != 0 && dtype != 1) || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 ||
      Sk <= 0 || B <= 0)
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

// Mamba2 SSD (state-space duality) chunked scan, forward.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/ssd_scan/kernel.py::ssd_scan_pallas (body _ssd_kernel).
//
// Per (batch b, head h), with a (P, N) fp32 state, over chunks of Q steps:
//   cs_q   = cumsum_q(dt_q * A_h)                      (within the chunk)
//   y_i    = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j     (intra)
//          + exp(cs_i) C_i . state_in                             (inter)
//          + D_h x_i
//   state  = exp(cs_end) state_in + sum_q exp(cs_end - cs_q) dt_q x_q (x) B_q
//
// Bound on the H100: at the prefill shape (B 4, S 2048, H 24, P 64, N 128,
// Q 256, bf16) x, dt, B and C are read once and y and the final state
// written once, 58.5 MB (17.5 us at 3.35 TB/s); the products are
// 2Q^2 N + H (2Q^2 P + 4QPN) flops per (b, chunk), 13.4 GFLOP in all
// (13.6 us at 989 TFLOP/s), so in bf16 the least time is set by the bytes.
// In fp32 (67 TFLOP/s outside the tensor cores) the operations set it.
//
// Design.  The Pallas grid (B, S/Q) walks the chunks in order on one core and
// keeps the whole (H, P, N) state in VMEM: 0.75 MB for mamba2, more than an
// SM's shared memory, and (B x H) blocks alone would leave most of 132 SMs
// idle at batch 1.  Here the work is split into launches on the caller's
// stream, each parallel over what does not depend on order.  Two paths,
// chosen by (dtypes, P, N) and nothing else.
//
// bf16 x, B and C at P 64 and N 128 (mamba2's widths): four launches,
// every product on the tensor cores with fp32 sums:
//  1. ssd_state_tc per (b, chunk, h): the chunk's cumsum (as ssd_cumsum
//     below, one thread in order), then its state contribution
//     (w x)^T B, a (P, Q) x (Q, N) product, w_q = exp(cs_end - cs_q) dt_q:
//     one warpgroup's wgmma m64n128, A from registers, B from shared memory.
//  2. ssd_cb_tc per (b, chunk, 64 x 64 tile): G = C B^T, as ssd_cb below,
//     on mma.sync m16n8k16 (a small share of the work).
//  3. ssd_state_pass, as below.
//  4. ssd_out_tc per (b, chunk, h, 64 query rows): for each 64-key tile on
//     or below the diagonal, M = G exp(cs_i - cs_j) dt_j masked in
//     registers and split in place into the A fragments of a wgmma m64n64
//     with the tile's x rows as B, y += M x_j; then y += exp(cs_i) C_i
//     state_in^T, a wgmma with both operands in shared memory; then D x.
// The tiles of x, B and C reach shared memory by cp.async through
// two-stage rings, so a tile's copy overlaps the previous tile's products;
// wgmma's operands are 128-byte swizzled as wgmma.cuh describes.
// Three operands carry an fp32 factor: w x (in ssd_state_tc), M and
// state_in (in ssd_out_tc).  Each goes to the tensor cores as two bf16 terms,
// hi = bf16(v) and lo = bf16(v - hi), two products into one fp32 sum: one
// bf16 term alone, as mamba_ssm's kernels round them, moves y by up to 10%
// of 1 + |y| at mamba2's widths, against the 3% tolerance.  state_in is
// split in shared memory only: the fp32 state in device memory is never
// rounded.  C B^T is exact per product.  ssd_scan_reference_tc in
// kernels/ssd_scan/ref.py rounds at the same places.
//
// fp32, bf16 x with fp32 B and C, and the other widths: five launches on
// the CUDA cores:
//  1. ssd_cumsum: cs (B, S, H), one thread per (b, chunk, h) walking the
//     chunk in order with rounded products and sums (torch.cumsum's own
//     order on the card, as of torch 2.11, so the plain version sees the
//     same cs bit for bit: exp(cs_i - cs_j) takes the difference of two sums
//     that reach several hundred, where a different summation order alone
//     moves the result by more than the fp32 tolerance; chip_smoke.py also
//     holds the fp32 kernel against a float64 plain version, which does not
//     depend on that order).
//  2. ssd_cb: G = C B^T (B, nc, Q, Q) fp32, once per (b, chunk) for all
//     heads, in 64 x 64 tiles on or below the diagonal.
//  3. ssd_chunk_state: each chunk's own state contribution per
//     (b, chunk, h), a (P, Q) x (Q, N) product with weights
//     exp(cs_end - cs_q) dt_q.
//  4. ssd_state_pass: the short sequential pass over the chunks per
//     (b, h, state element): replaces each chunk's contribution in place by
//     the state entering that chunk and writes the final state.
//  5. ssd_chunk_out: y per (b, chunk, h, 64 query rows): the masked intra
//     term from G tiles, the inter term C . state_in, and D x.
// Its arithmetic is fp32 (the tensor cores would round fp32 inputs to TF32);
// the decay-weighted M is never rounded.  On both paths the mask is applied
// before the exponential: for j > i the argument cs_i - cs_j is positive and
// can overflow, and a mask applied by multiplication would turn inf * 0 into
// NaN.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sync.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;   // G tile, y row tile
constexpr int kMaxQ = 256;
constexpr int kStepQ = 32;  // chunk steps staged at once in ssd_chunk_state
constexpr int kStepN = 32;  // state columns staged at once

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

struct Dims {
  int batch, S, H, P, N, Q, nc;
};

// 1. cs[b, s, h]: inclusive cumsum of dt * A within each chunk.
__global__ void ssd_cumsum(const float* __restrict__ dt,
                           const float* __restrict__ A, float* __restrict__ cs,
                           Dims d) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z;
  if (h >= d.H) return;
  const float a = A[h];
  const size_t base = (static_cast<size_t>(b) * d.S + c * d.Q) * d.H + h;
  float acc = 0.f;
#pragma unroll 16
  for (int q = 0; q < d.Q; ++q) {
    const size_t i = base + static_cast<size_t>(q) * d.H;
    acc = __fadd_rn(acc, __fmul_rn(dt[i], a));
    cs[i] = acc;
  }
}

// 2. G[b, c, i, j] = sum_n C[b, cQ + i, n] B[b, cQ + j, n] for the 64 x 64
// tiles with tile(j) <= tile(i).  grid (nt * nt, nc, batch).
template <int N, typename TB>
__global__ void __launch_bounds__(kThreads)
    ssd_cb(const TB* __restrict__ Bm, const TB* __restrict__ Cm,
           float* __restrict__ G, Dims d) {
  constexpr int NS = N < kStepN ? N : kStepN;
  const int nt = (d.Q + kTile - 1) / kTile;
  const int it = blockIdx.x / nt, jt = blockIdx.x % nt;
  if (jt > it) return;
  const int c = blockIdx.y, b = blockIdx.z;
  __shared__ float Cs[kTile][NS + 1];
  __shared__ float Bs[kTile][NS + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int i0 = it * kTile, j0 = jt * kTile;
  const size_t row0 = static_cast<size_t>(b) * d.S + static_cast<size_t>(c) * d.Q;
  float acc[4][4] = {};
  for (int n0 = 0; n0 < N; n0 += NS) {
    for (int e = tid; e < kTile * NS; e += kThreads) {
      const int r = e / NS, k = e % NS;
      Cs[r][k] = i0 + r < d.Q ? ld(Cm, (row0 + i0 + r) * N + n0 + k) : 0.f;
      Bs[r][k] = j0 + r < d.Q ? ld(Bm, (row0 + j0 + r) * N + n0 + k) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < NS; ++k) {
      float cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = Cs[ty + 16 * r][k];
#pragma unroll
      for (int s = 0; s < 4; ++s) bv[s] = Bs[tx + 16 * s][k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(cv[r], bv[s], acc[r][s]);
    }
    __syncthreads();
  }
  float* g = G + (static_cast<size_t>(b) * d.nc + c) * d.Q * d.Q;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= d.Q) continue;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = j0 + tx + 16 * s;
      if (j < d.Q) g[static_cast<size_t>(i) * d.Q + j] = acc[r][s];
    }
  }
}

// Thread layout of a (rows x cols) output owned by one block of 256 threads:
// NT_C threads along the columns, each holding TC of them; NT_R along the
// rows, each holding TR.  Threads past NT_R * NT_C only help with loads.
template <int ROWS, int COLS>
struct Layout {
  static constexpr int NT_C = COLS < 16 ? COLS : 16;
  static constexpr int TC = COLS / NT_C;
  static constexpr int NT_R = ROWS < kThreads / NT_C ? ROWS : kThreads / NT_C;
  static constexpr int TR = ROWS / NT_R;
  static_assert(NT_C * TC == COLS && NT_R * TR == ROWS, "uneven layout");
};

// 3. states[b, c, h] (P, N) = sum_q exp(cs_end - cs_q) dt_q x_q (x) B_q.
// grid (nc, H, batch).
template <int P, int N, typename TX, typename TB>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_state(const TX* __restrict__ x, const float* __restrict__ dt,
                    const TB* __restrict__ Bm, const float* __restrict__ cs,
                    float* __restrict__ states, Dims d) {
  using L = Layout<P, N>;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  __shared__ float w[kMaxQ];
  __shared__ float xs[kStepQ][P];
  __shared__ float bs[kStepQ][N];
  const int tid = threadIdx.x;
  const size_t row0 = static_cast<size_t>(b) * d.S + static_cast<size_t>(c) * d.Q;
  const float cs_end = cs[(row0 + d.Q - 1) * d.H + h];
  for (int q = tid; q < d.Q; q += kThreads) {
    const size_t i = (row0 + q) * d.H + h;
    w[q] = expf(cs_end - cs[i]) * dt[i];
  }
  const int tn = tid % L::NT_C, tp = tid / L::NT_C;
  const bool active = tp < L::NT_R;
  float acc[L::TR][L::TC] = {};
  for (int q0 = 0; q0 < d.Q; q0 += kStepQ) {
    __syncthreads();  // w ready / previous tile consumed
    const int nq = min(kStepQ, d.Q - q0);
    for (int e = tid; e < kStepQ * P; e += kThreads) {
      const int q = e / P, p = e % P;
      xs[q][p] = q < nq
          ? w[q0 + q] * ld(x, ((row0 + q0 + q) * d.H + h) * P + p) : 0.f;
    }
    for (int e = tid; e < kStepQ * N; e += kThreads) {
      const int q = e / N, n = e % N;
      bs[q][n] = q < nq ? ld(Bm, (row0 + q0 + q) * N + n) : 0.f;
    }
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int q = 0; q < kStepQ; ++q) {
        float xv[L::TR], bv[L::TC];
#pragma unroll
        for (int r = 0; r < L::TR; ++r) xv[r] = xs[q][tp + L::NT_R * r];
#pragma unroll
        for (int s = 0; s < L::TC; ++s) bv[s] = bs[q][tn + L::NT_C * s];
#pragma unroll
        for (int r = 0; r < L::TR; ++r)
#pragma unroll
          for (int s = 0; s < L::TC; ++s)
            acc[r][s] = fmaf(xv[r], bv[s], acc[r][s]);
      }
    }
  }
  if (!active) return;
  float* out = states + ((static_cast<size_t>(b) * d.nc + c) * d.H + h) * P * N;
#pragma unroll
  for (int r = 0; r < L::TR; ++r)
#pragma unroll
    for (int s = 0; s < L::TC; ++s)
      out[(tp + L::NT_R * r) * N + tn + L::NT_C * s] = acc[r][s];
}

// 4. In place over the chunks: states[b, c, h] becomes the state entering
// chunk c; final[b, h] the state after the last chunk.
// grid (ceil(P*N / 256), H, batch).
__global__ void ssd_state_pass(const float* __restrict__ cs,
                               float* __restrict__ states,
                               float* __restrict__ final_state, Dims d) {
  const int PN4 = d.P * d.N / 4;  // four state elements a thread
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN4) return;
  // loads of kBatch chunks first, then the sequential update: one round trip
  // to memory per kBatch chunks
  constexpr int kBatch = 8;
  const size_t stride = static_cast<size_t>(d.H) * PN4;
  float4* sb = reinterpret_cast<float4*>(states) +
               (static_cast<size_t>(b) * d.nc * d.H + h) * PN4 + e;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < d.nc; c0 += kBatch) {
    float4 own[kBatch];
    float decay[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int c = c0 + k;
      if (c < d.nc) {
        const size_t last = (static_cast<size_t>(b) * d.S +
                             static_cast<size_t>(c) * d.Q + d.Q - 1) * d.H + h;
        decay[k] = expf(cs[last]);
        own[k] = sb[c * stride];
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int c = c0 + k;
      if (c < d.nc) {
        sb[c * stride] = s;
        s.x = __fadd_rn(__fmul_rn(decay[k], s.x), own[k].x);
        s.y = __fadd_rn(__fmul_rn(decay[k], s.y), own[k].y);
        s.z = __fadd_rn(__fmul_rn(decay[k], s.z), own[k].z);
        s.w = __fadd_rn(__fmul_rn(decay[k], s.w), own[k].w);
      }
    }
  }
  reinterpret_cast<float4*>(final_state)[(static_cast<size_t>(b) * d.H + h) * PN4 + e] = s;
}

// 5. y for 64 query rows of one (b, chunk, h).  grid (nt, H, batch * nc).
template <int P, int N, typename TX, typename TB>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_out(const TX* __restrict__ x, const float* __restrict__ dt,
                  const TB* __restrict__ Cm, const float* __restrict__ D,
                  const float* __restrict__ cs, const float* __restrict__ G,
                  const float* __restrict__ states, TX* __restrict__ y,
                  Dims d) {
  using L = Layout<kTile, P>;
  constexpr int kIntra = kTile * (kTile + 1) + kTile * P;   // Ms, xs
  constexpr int kInter = kTile * (kStepN + 1) + P * (kStepN + 1);  // Cs, Ss
  constexpr int kBuf = kIntra > kInter ? kIntra : kInter;
  const int it = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / d.nc, c = blockIdx.z % d.nc;
  __shared__ float cs_s[kMaxQ];
  __shared__ float dt_s[kMaxQ];
  __shared__ float buf[kBuf];
  float(*Ms)[kTile + 1] = reinterpret_cast<float(*)[kTile + 1]>(buf);
  float(*xs)[P] = reinterpret_cast<float(*)[P]>(buf + kTile * (kTile + 1));
  float(*Cs)[kStepN + 1] = reinterpret_cast<float(*)[kStepN + 1]>(buf);
  float(*Ss)[kStepN + 1] =
      reinterpret_cast<float(*)[kStepN + 1]>(buf + kTile * (kStepN + 1));

  const int tid = threadIdx.x;
  const size_t row0 = static_cast<size_t>(b) * d.S + static_cast<size_t>(c) * d.Q;
  const int i0 = it * kTile;
  const int rows_end = min(i0 + kTile, d.Q);
  for (int q = tid; q < rows_end; q += kThreads) {
    const size_t i = (row0 + q) * d.H + h;
    cs_s[q] = cs[i];
    dt_s[q] = dt[i];
  }
  const int tp = tid % L::NT_C, ti = tid / L::NT_C;
  const bool active = ti < L::NT_R;
  float acc[L::TR][L::TC] = {};
  const float* g = G + (static_cast<size_t>(b) * d.nc + c) * d.Q * d.Q;

  // intra-chunk: sum over key tiles up to the diagonal
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kTile;
    __syncthreads();  // cs_s ready / previous tiles consumed
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int ii = e / kTile, jj = e % kTile;
      const int i = i0 + ii, j = j0 + jj;
      float m = 0.f;
      if (i < d.Q && j <= i) {  // mask before the exponential
        m = g[static_cast<size_t>(i) * d.Q + j] * expf(cs_s[i] - cs_s[j]);
        m = m * dt_s[j];
      }
      Ms[ii][jj] = m;
    }
    for (int e = tid; e < kTile * P; e += kThreads) {
      const int jj = e / P, p = e % P;
      const int j = j0 + jj;
      xs[jj][p] = j < d.Q ? ld(x, ((row0 + j) * d.H + h) * P + p) : 0.f;
    }
    __syncthreads();
    if (active) {
#pragma unroll 8
      for (int jj = 0; jj < kTile; ++jj) {
        float mv[L::TR], xv[L::TC];
#pragma unroll
        for (int r = 0; r < L::TR; ++r) mv[r] = Ms[ti + L::NT_R * r][jj];
#pragma unroll
        for (int s = 0; s < L::TC; ++s) xv[s] = xs[jj][tp + L::NT_C * s];
#pragma unroll
        for (int r = 0; r < L::TR; ++r)
#pragma unroll
          for (int s = 0; s < L::TC; ++s)
            acc[r][s] = fmaf(mv[r], xv[s], acc[r][s]);
      }
    }
  }

  // inter-chunk: C_i . state_in over N in steps of kStepN
  const float* s_in = states + ((static_cast<size_t>(b) * d.nc + c) * d.H + h) * P * N;
  float acc2[L::TR][L::TC] = {};
  for (int n0 = 0; n0 < N; n0 += kStepN) {
    const int nn = min(kStepN, N - n0);
    __syncthreads();
    for (int e = tid; e < kTile * kStepN; e += kThreads) {
      const int ii = e / kStepN, k = e % kStepN;
      Cs[ii][k] = (i0 + ii < d.Q && k < nn)
          ? ld(Cm, (row0 + i0 + ii) * N + n0 + k) : 0.f;
    }
    for (int e = tid; e < P * kStepN; e += kThreads) {
      const int p = e / kStepN, k = e % kStepN;
      Ss[p][k] = k < nn ? s_in[p * N + n0 + k] : 0.f;
    }
    __syncthreads();
    if (active) {
#pragma unroll 8
      for (int k = 0; k < kStepN; ++k) {
        float cv[L::TR], sv[L::TC];
#pragma unroll
        for (int r = 0; r < L::TR; ++r) cv[r] = Cs[ti + L::NT_R * r][k];
#pragma unroll
        for (int s = 0; s < L::TC; ++s) sv[s] = Ss[tp + L::NT_C * s][k];
#pragma unroll
        for (int r = 0; r < L::TR; ++r)
#pragma unroll
          for (int s = 0; s < L::TC; ++s)
            acc2[r][s] = fmaf(cv[r], sv[s], acc2[r][s]);
      }
    }
  }
  if (!active) return;
  const float dh = D[h];
#pragma unroll
  for (int r = 0; r < L::TR; ++r) {
    const int i = i0 + ti + L::NT_R * r;
    if (i >= d.Q) continue;
    const float e = expf(cs_s[i]);
#pragma unroll
    for (int s = 0; s < L::TC; ++s) {
      const int p = tp + L::NT_C * s;
      const size_t o = ((row0 + i) * d.H + h) * P + p;
      const float v = (acc[r][s] + e * acc2[r][s]) + dh * ld(x, o);
      st(y, o, v);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 x, B and C at P 64: the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTC = 128;      // threads of 4 warps: 64 rows of 16 each
constexpr int kPT = 64;       // P on this path
constexpr int kStepT = 64;    // chunk steps (keys) a stage
constexpr int kLX = kPT + 8;  // padded rows (elements): ldmatrix hits 32 banks

// (a, b) as two bf16 terms, hi = bf16(v) and lo = bf16(v - hi), each pair
// packed into one register.
__device__ __forceinline__ void split_pack(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = tc::pack(a - f.x, b - f.y);
}

// e^x through the SFU's exp2 (ex2.approx: about 2 ulp; 0 far below zero).
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// cp.async of `rows` rows of W bf16 values (row r at src + r * stride) into a
// shared tile with rows of W + 8; rows at or past `valid` are zero-filled.
template <int W>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t stride, int rows,
                                          int valid) {
  constexpr int CH = W / 8;
  for (int e = threadIdx.x; e < rows * CH; e += kTC) {
    const int r = e / CH, ch = e % CH;
    const bool in = r < valid;
    tc::cp_async16(dst + r * (W + 8) + ch * 8,
                   in ? src + r * stride + ch * 8 : src, in);
  }
}

// cp.async of `rows` rows of 64 W bf16 values (row r at src + r * stride)
// into a 128-byte-swizzled tile of W / 64 boxes of `rows` rows (the layout
// of wgmma.cuh); rows at or past `valid` are zero-filled.
template <int W>
__device__ __forceinline__ void copy_rows_sw(unsigned char* dst,
                                             const __nv_bfloat16* src,
                                             size_t stride, int rows,
                                             int valid) {
  constexpr int CH = W / 8;  // 16-byte chunks of a row
  for (int e = threadIdx.x; e < rows * CH; e += kTC) {
    const int r = e / CH, ch = e % CH, c = ch % 8;
    const bool in = r < valid;
    tc::cp_async16(dst + (ch / 8) * rows * 128 + r * 128 + ((c ^ (r % 8)) * 16),
                   in ? src + r * stride + ch * 8 : src, in);
  }
}

// Shared memory of the wgmma kernels: 1024-byte aligned from the base.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  return raw + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Make this thread's writes to shared memory (stores, cp.async) visible to
// the asynchronous proxy that wgmma reads through.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 1. cs for (b, chunk c, h), then states[b, c, h] (64, 128) =
// sum_q (w_q x_q) (x) B_q, one warpgroup's m64n128 wgmma a k step of 16
// chunk steps: A = (w x)^T from registers (the raw x tile through ldmatrix
// .trans, scaled by w and split into its two bf16 terms), B = B from a
// 128-byte-swizzled tile (MN-major, the transpose bit).  Steps stream
// through a two-stage cp.async ring of raw x and B rows; the cumsum runs
// while the first two land.  grid (nc, H, batch).
struct StateSmem {
  static constexpr int b_bytes = kStepT * 2 * 128;   // 2 boxes of 64 steps
  static constexpr int x_bytes = kStepT * kLX * 2;   // padded [q][p]
  static constexpr int braw = 0;                     // 1024-aligned
  static constexpr int xraw = braw + 2 * b_bytes;
  static constexpr int cs = xraw + 2 * x_bytes;      // cs, w: 2 kMaxQ floats
  static constexpr int bytes = cs + 2 * kMaxQ * 4 + 1024;  // + alignment
};

__global__ void __launch_bounds__(kTC)
    ssd_state_tc(const __nv_bfloat16* __restrict__ x,
                 const float* __restrict__ dt, const float* __restrict__ A,
                 const __nv_bfloat16* __restrict__ Bm, float* __restrict__ cs,
                 float* __restrict__ states, Dims d) {
  constexpr int N = 128;
  using Sm = StateSmem;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  float* cs_s = reinterpret_cast<float*>(smem + Sm::cs);
  float* w_s = cs_s + kMaxQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, t4 = lane % 4;
  const size_t row0 = static_cast<size_t>(b) * d.S + static_cast<size_t>(c) * d.Q;
  const size_t xstride = static_cast<size_t>(d.H) * kPT;
  const __nv_bfloat16* xb = x + row0 * xstride + h * kPT;
  const int n_st = (d.Q + kStepT - 1) / kStepT;
  auto issue = [&](int s) {  // raw x and B of steps 64 s.. into stage s % 2
    const int q0 = s * kStepT;
    copy_rows<kPT>(reinterpret_cast<__nv_bfloat16*>(
                       smem + Sm::xraw + (s & 1) * Sm::x_bytes),
                   xb + q0 * xstride, xstride, kStepT, d.Q - q0);
    copy_rows_sw<N>(smem + Sm::braw + (s & 1) * Sm::b_bytes,
                    Bm + (row0 + q0) * N, N, kStepT, d.Q - q0);
    tc::cp_async_commit();
  };
  issue(0);
  if (n_st > 1) issue(1);

  // the cumsum of dt * A, in order, with the operations of ssd_cumsum;
  // this thread's steps tid and tid + 128 keep their dt
  const float a = A[h];
  float dtq[kMaxQ / kTC];
#pragma unroll
  for (int k = 0; k < kMaxQ / kTC; ++k) {
    const int q = tid + k * kTC;
    dtq[k] = q < d.Q ? dt[(row0 + q) * d.H + h] : 0.f;
    if (q < d.Q) cs_s[q] = __fmul_rn(dtq[k], a);
  }
  __syncthreads();
  if (tid == 0) {
    float acc = 0.f;
#pragma unroll 16
    for (int q = 0; q < d.Q; ++q) {
      acc = __fadd_rn(acc, cs_s[q]);
      cs_s[q] = acc;
    }
  }
  __syncthreads();
  const float cs_end = cs_s[d.Q - 1];
#pragma unroll
  for (int k = 0; k < kMaxQ / kTC; ++k) {
    const int q = tid + k * kTC;
    if (q < d.Q) {
      cs[(row0 + q) * d.H + h] = cs_s[q];
      w_s[q] = expf(cs_end - cs_s[q]) * dtq[k];
    } else {
      w_s[q] = 0.f;  // steps past Q: their zero-filled x gives zero
    }
  }

  float acc[N / 2];  // m64n128: this thread's 64 values of the state tile
#pragma unroll
  for (int j = 0; j < N / 2; ++j) acc[j] = 0.f;
  for (int s = 0; s < n_st; ++s) {
    if (s + 1 < n_st)
      tc::cp_async_wait<1>();
    else
      tc::cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();  // stage s landed (and, at s = 0, w_s is ready)
    const __nv_bfloat16* xr = reinterpret_cast<const __nv_bfloat16*>(
        smem + Sm::xraw + (s & 1) * Sm::x_bytes);
    // A fragments of (w x)^T, rows p = 16 warp.., k steps q = 16 kk..:
    // registers 0, 1 hold steps 2 t4, 2 t4 + 1 of rows gr, gr + 8;
    // registers 2, 3 steps 2 t4 + 8, 2 t4 + 9
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t raw[4];
      tc::frag_a_t(raw, xr, kLX, 16 * warp, kk * 16, lane);
      const float* w = w_s + s * kStepT + kk * 16 + 2 * t4;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&raw[r]));
        const int k = r < 2 ? 0 : 8;
        split_pack(v.x * w[k], v.y * w[k + 1], ah[kk][r], al[kk][r]);
      }
    }
    const uint32_t bt = smem_addr(smem + Sm::braw + (s & 1) * Sm::b_bytes);
    wg::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::wgmma_rs<N>(acc, ah[kk], wg::desc(bt + kk * 16 * 128, kStepT * 128,
                                            1024));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::wgmma_rs<N>(acc, al[kk], wg::desc(bt + kk * 16 * 128, kStepT * 128,
                                            1024));
    wg::wg_commit();
    wg::wg_wait<0>();
    wg::reg_fence<N / 2>(acc);
    __syncthreads();  // stage s consumed
    if (s + 2 < n_st) issue(s + 2);
  }
  // accumulator layout (wgmma m64nNk16): acc[4 j + e] is row 16 warp + gr
  // (e < 2) or + 8, column 8 j + 2 t4 + (e & 1)
  float* out = states + ((static_cast<size_t>(b) * d.nc + c) * d.H + h) * kPT * N;
  const int p = 16 * warp + gr;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int n = j * 8 + 2 * t4;
    *reinterpret_cast<float2*>(out + p * N + n) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(out + (p + 8) * N + n) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// 2. G[b, c, i, j] = sum_n C[b, cQ + i, n] B[b, cQ + j, n] for the 64 x 64
// tiles with tile(j) <= tile(i), fp32 (C B^T is exact per product), once per
// (b, chunk) for all heads, in rows of Qp = 64 nt (whole tiles; zero past
// Q).  Warp w owns rows 16w.. of the tile.  grid (nt * nt, nc, batch).
__global__ void __launch_bounds__(kTC)
    ssd_cb_tc(const __nv_bfloat16* __restrict__ Bm,
              const __nv_bfloat16* __restrict__ Cm, float* __restrict__ G,
              Dims d) {
  constexpr int N = 128, LB = N + 8;
  const int nt = (d.Q + 63) / 64;
  const int it = blockIdx.x / nt, jt = blockIdx.x % nt;
  if (jt > it) return;
  const int c = blockIdx.y, b = blockIdx.z;
  __shared__ __align__(16) __nv_bfloat16 cm[64 * LB];
  __shared__ __align__(16) __nv_bfloat16 bs[64 * LB];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, t4 = lane % 4;
  const size_t row0 = static_cast<size_t>(b) * d.S + static_cast<size_t>(c) * d.Q;
  const int i0 = it * 64, j0 = jt * 64;
  copy_rows<N>(cm, Cm + (row0 + i0) * N, N, 64, d.Q - i0);
  copy_rows<N>(bs, Bm + (row0 + j0) * N, N, 64, d.Q - j0);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  float g[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) g[j][0] = g[j][1] = g[j][2] = g[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t af[4];
    tc::frag_a(af, cm, LB, 16 * warp, kk * 16, lane);
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t bf[4];
      tc::frag_b(bf, bs, LB, n * 8, kk * 16, lane);
      tc::mma_bf16(g[n], af, bf[0], bf[1]);
      tc::mma_bf16(g[n + 1], af, bf[2], bf[3]);
    }
  }
  const int qp = nt * 64;  // G's row stride: whole tiles, zero past Q
  float* gt = G + (static_cast<size_t>(b) * d.nc + c) * qp * qp;
  const int i = i0 + 16 * warp + gr;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int j = j0 + n * 8 + 2 * t4;
    *reinterpret_cast<float2*>(gt + static_cast<size_t>(i) * qp + j) =
        make_float2(g[n][0], g[n][1]);
    *reinterpret_cast<float2*>(gt + static_cast<size_t>(i + 8) * qp + j) =
        make_float2(g[n][2], g[n][3]);
  }
}

// 4. y for 64 query rows of one (b, chunk, h), one warpgroup: warp w owns
// rows 16w.. and all P.  For each key tile on or below the diagonal each
// warp loads its rows of the G tile from device memory in the accumulator
// layout, forms M = G exp(cs_i - cs_j) dt_j (masked before the
// exponential) in registers and splits it into the A fragments of an
// m64n64 wgmma whose B is the key tile's x rows (128-byte swizzled,
// MN-major); x rows stream through a two-stage cp.async ring.  Then the
// inter-chunk term as two m64n64 wgmma chains over N, A = the C rows and
// B = the two bf16 terms of state_in (both K-major, swizzled), and D x.
// grid (ceil(Q / 64), H, batch * nc).
struct OutSmem {
  static constexpr int box = 64 * 128;               // 64 rows of 128 B
  static constexpr int cm = 0;                       // C rows: 2 boxes
  static constexpr int ring = cm + 2 * box;          // x rows: 1 box a stage
  static constexpr int sh = ring, sl = sh + 2 * box; // state_in, over the ring
  static constexpr int cs = sl + 2 * box;            // cs, dt: 2 kMaxQ floats
  static constexpr int bytes = cs + 2 * kMaxQ * 4 + 1024;  // + alignment
};

__global__ void __launch_bounds__(kTC)
    ssd_out_tc(const __nv_bfloat16* __restrict__ x,
               const float* __restrict__ dt, const float* __restrict__ G,
               const __nv_bfloat16* __restrict__ Cm, const float* __restrict__ D,
               const float* __restrict__ cs, const float* __restrict__ states,
               __nv_bfloat16* __restrict__ y, Dims d) {
  constexpr int N = 128;
  using Sm = OutSmem;
  const int it = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / d.nc, c = blockIdx.z % d.nc;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  float* cs_s = reinterpret_cast<float*>(smem + Sm::cs);
  float* dt_s = cs_s + kMaxQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, t4 = lane % 4;
  const size_t row0 = static_cast<size_t>(b) * d.S + static_cast<size_t>(c) * d.Q;
  const size_t xstride = static_cast<size_t>(d.H) * kPT;
  const __nv_bfloat16* xb = x + row0 * xstride + h * kPT;
  const int qp = (d.Q + 63) / 64 * 64;  // G's row stride (ssd_cb_tc)
  const int i0 = it * 64;
  const float* gb = G + (static_cast<size_t>(b) * d.nc + c) * qp * qp;
  const int rows_end = min(i0 + 64, d.Q);
  auto issue = [&](int jt) {  // x rows of key tile jt into stage jt % 2
    const int j0 = jt * 64;
    copy_rows_sw<kPT>(smem + Sm::ring + (jt & 1) * Sm::box, xb + j0 * xstride,
                      xstride, 64, d.Q - j0);
    tc::cp_async_commit();
  };
  copy_rows_sw<N>(smem + Sm::cm, Cm + (row0 + i0) * N, N, 64, d.Q - i0);
  issue(0);  // one group with the C rows
  if (it > 0) issue(1);
#pragma unroll
  for (int k = 0; k < kMaxQ / kTC; ++k) {
    const int q = tid + k * kTC;
    if (q < rows_end) {
      const size_t i = (row0 + q) * d.H + h;
      cs_s[q] = cs[i];
      dt_s[q] = dt[i];
    }
  }

  // this thread's rows; accumulators as in ssd_state_tc (m64n64)
  const int qi0 = i0 + 16 * warp + gr, qi1 = qi0 + 8;
  float acc[kPT / 2];
#pragma unroll
  for (int j = 0; j < kPT / 2; ++j) acc[j] = 0.f;

  // G for the warp's 16 rows and the 64 keys of tile jt, in the
  // accumulator layout; loaded one tile ahead of its use
  float g[8][4];
  auto load_g = [&](int jt) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int j = jt * 64 + n * 8 + 2 * t4;
      const float2 g0 = *reinterpret_cast<const float2*>(
          gb + static_cast<size_t>(qi0) * qp + j);
      const float2 g1 = *reinterpret_cast<const float2*>(
          gb + static_cast<size_t>(qi1) * qp + j);
      g[n][0] = g0.x;
      g[n][1] = g0.y;
      g[n][2] = g1.x;
      g[n][3] = g1.y;
    }
  };
  load_g(0);

  // intra-chunk: key tiles up to the diagonal (tile it)
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * 64;
    if (jt < it)
      tc::cp_async_wait<1>();
    else
      tc::cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();  // tile jt (and, at jt = 0, C, cs_s, dt_s) visible
    // M = G exp(cs_i - cs_j) dt_j where j <= i < Q (the mask before the
    // exponential), else 0; its two bf16 terms are the A fragments of M x
    uint32_t mh[4][4], ml[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float m[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? qi0 : qi1;
        const int j = j0 + n * 8 + 2 * t4 + (e & 1);
        float v = 0.f;
        if (i < d.Q && j <= i) {
          v = g[n][e] * exp_fast(cs_s[i] - cs_s[j]);
          v = v * dt_s[j];
        }
        m[e] = v;
      }
      const int r = n / 2, k = (n & 1) * 2;
      split_pack(m[0], m[1], mh[r][k], ml[r][k]);
      split_pack(m[2], m[3], mh[r][k + 1], ml[r][k + 1]);
    }
    if (jt < it) load_g(jt + 1);  // lands while the products run
    const uint32_t xt = smem_addr(smem + Sm::ring + (jt & 1) * Sm::box);
    wg::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::wgmma_rs<kPT>(acc, mh[kk], wg::desc(xt + kk * 16 * 128, Sm::box,
                                              1024));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::wgmma_rs<kPT>(acc, ml[kk], wg::desc(xt + kk * 16 * 128, Sm::box,
                                              1024));
    wg::wg_commit();
    wg::wg_wait<0>();
    wg::reg_fence<kPT / 2>(acc);
    __syncthreads();  // stage jt % 2 consumed
    if (jt + 2 <= it) issue(jt + 2);
  }

  // this thread's x rows for D x, from the diagonal tile still in its stage
  uint32_t xi[2][kPT / 8];
  {
    const unsigned char* xt = smem + Sm::ring + (it & 1) * Sm::box;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * warp + gr + 8 * half;
#pragma unroll
      for (int j = 0; j < kPT / 8; ++j)
        xi[half][j] = *reinterpret_cast<const uint32_t*>(
            xt + r * 128 + ((j ^ (r % 8)) * 16) + 4 * t4);
    }
  }
  __syncthreads();  // every thread has its x rows: the ring is idle

  // inter-chunk: C_i . state_in, state_in as two bf16 terms, swizzled as
  // wgmma reads a K-major B over the idle ring
  const float4* s_in = reinterpret_cast<const float4*>(
      states + ((static_cast<size_t>(b) * d.nc + c) * d.H + h) * kPT * N);
  constexpr int kPer = kPT * N / 4 / kTC, kBatch = 8;  // float4s a thread
#pragma unroll
  for (int k0 = 0; k0 < kPer; k0 += kBatch) {
    float4 v[kBatch];  // a batch of loads in flight at once
#pragma unroll
    for (int k = 0; k < kBatch; ++k) v[k] = s_in[(k0 + k) * kTC + tid];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int e = (k0 + k) * kTC + tid;
      const int p = e / (N / 4), n = (e % (N / 4)) * 4;
      uint2 oh, ol;
      split_pack(v[k].x, v[k].y, oh.x, ol.x);
      split_pack(v[k].z, v[k].w, oh.y, ol.y);
      const int off = (n / 64) * Sm::box + p * 128 +
                      (((n % 64) / 8) ^ (p % 8)) * 16 + (n % 8) * 2;
      *reinterpret_cast<uint2*>(smem + Sm::sh + off) = oh;
      *reinterpret_cast<uint2*>(smem + Sm::sl + off) = ol;
    }
  }
  fence_async_smem();
  __syncthreads();
  float acc2[kPT / 2];
#pragma unroll
  for (int j = 0; j < kPT / 2; ++j) acc2[j] = 0.f;
  const uint32_t ct = smem_addr(smem + Sm::cm);
  const uint32_t st_h = smem_addr(smem + Sm::sh), st_l = smem_addr(smem + Sm::sl);
  wg::wg_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint32_t off = (kk / 4) * Sm::box + (kk % 4) * 32;
    wg::wgmma_ss<kPT>(acc2, wg::desc(ct + off, 16, 1024),
                      wg::desc(st_h + off, 16, 1024), 1);
  }
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint32_t off = (kk / 4) * Sm::box + (kk % 4) * 32;
    wg::wgmma_ss<kPT>(acc2, wg::desc(ct + off, 16, 1024),
                      wg::desc(st_l + off, 16, 1024), 1);
  }
  wg::wg_commit();
  wg::wg_wait<0>();
  wg::reg_fence<kPT / 2>(acc2);

  const float dh = D[h];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = half ? qi1 : qi0;
    if (i >= d.Q) continue;
    const float e = expf(cs_s[i]);
    __nv_bfloat16* yr = y + ((row0 + i) * d.H + h) * kPT;
#pragma unroll
    for (int j = 0; j < kPT / 8; ++j) {
      const int p = j * 8 + 2 * t4;
      const int a0 = 4 * j + 2 * half;
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&xi[half][j]));
      const float v0 = (acc[a0] + e * acc2[a0]) + dh * xv.x;
      const float v1 = (acc[a0 + 1] + e * acc2[a0 + 1]) + dh * xv.y;
      *reinterpret_cast<__nv_bfloat162*>(yr + p) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* D;
  void* y;
  float* final_state;
  float* cs;
  float* G;
  float* states;
  Dims d;
};

cudaError_t run_tc(const Args& a, cudaStream_t st) {
  constexpr int N = 128;
  const Dims& d = a.d;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* Bm = static_cast<const __nv_bfloat16*>(a.B);
  const __nv_bfloat16* Cm = static_cast<const __nv_bfloat16*>(a.C);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(ssd_state_tc,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  StateSmem::bytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_out_tc,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  OutSmem::bytes)) != cudaSuccess)
    return err;
  const int nt = (d.Q + 63) / 64;
  ssd_state_tc<<<dim3(d.nc, d.H, d.batch), kTC, StateSmem::bytes, st>>>(
      x, a.dt, a.A, Bm, a.cs, a.states, d);
  ssd_cb_tc<<<dim3(nt * nt, d.nc, d.batch), kTC, 0, st>>>(Bm, Cm, a.G, d);
  ssd_state_pass<<<dim3((kPT * N / 4 + kThreads - 1) / kThreads, d.H, d.batch),
                   kThreads, 0, st>>>(a.cs, a.states, a.final_state, d);
  ssd_out_tc<<<dim3(nt, d.H, d.batch * d.nc), kTC, OutSmem::bytes, st>>>(
      x, a.dt, a.G, Cm, a.D, a.cs, a.states, static_cast<__nv_bfloat16*>(a.y),
      d);
  return cudaGetLastError();
}

template <int P, int N, typename TX, typename TB>
cudaError_t run(const Args& a, cudaStream_t st) {
  if constexpr (P == kPT && N == 128 &&
                std::is_same<TX, __nv_bfloat16>::value &&
                std::is_same<TB, __nv_bfloat16>::value)
    return run_tc(a, st);
  const Dims& d = a.d;
  const TX* x = static_cast<const TX*>(a.x);
  const TB* Bm = static_cast<const TB*>(a.B);
  const TB* Cm = static_cast<const TB*>(a.C);
  const int nt = (d.Q + kTile - 1) / kTile;
  ssd_cumsum<<<dim3((d.H + 31) / 32, d.nc, d.batch), 32, 0, st>>>(
      a.dt, a.A, a.cs, d);
  ssd_cb<N, TB><<<dim3(nt * nt, d.nc, d.batch), kThreads, 0, st>>>(
      Bm, Cm, a.G, d);
  ssd_chunk_state<P, N, TX, TB><<<dim3(d.nc, d.H, d.batch), kThreads, 0,
                                  st>>>(x, a.dt, Bm, a.cs, a.states, d);
  ssd_state_pass<<<dim3((P * N / 4 + kThreads - 1) / kThreads, d.H, d.batch),
                   kThreads, 0, st>>>(a.cs, a.states, a.final_state, d);
  ssd_chunk_out<P, N, TX, TB><<<dim3(nt, d.H, d.batch * d.nc), kThreads, 0,
                                st>>>(x, a.dt, Cm, a.D, a.cs, a.G, a.states,
                                      static_cast<TX*>(a.y), d);
  return cudaGetLastError();
}

template <typename TX, typename TB>
cudaError_t by_shape(const Args& a, cudaStream_t st) {
  switch (a.d.P * 1000 + a.d.N) {
    case 4008: return run<4, 8, TX, TB>(a, st);
    case 4016: return run<4, 16, TX, TB>(a, st);
    case 4128: return run<4, 128, TX, TB>(a, st);
    case 8008: return run<8, 8, TX, TB>(a, st);
    case 8016: return run<8, 16, TX, TB>(a, st);
    case 8128: return run<8, 128, TX, TB>(a, st);
    case 16008: return run<16, 8, TX, TB>(a, st);
    case 16016: return run<16, 16, TX, TB>(a, st);
    case 16128: return run<16, 128, TX, TB>(a, st);
    case 64008: return run<64, 8, TX, TB>(a, st);
    case 64016: return run<64, 16, TX, TB>(a, st);
    case 64128: return run<64, 128, TX, TB>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16 (x and y); bc_dtype: the same codes for
// B and C (float32 B and C with bfloat16 x are allowed, bfloat16 B and C with
// float32 x are not).  x, y (batch, S, H, P); dt (batch, S, H) fp32; A, D
// (H,) fp32; B, C (batch, S, N); final_state (batch, H, P, N) fp32.  Scratch,
// fp32: cs (batch, S, H), G (batch, S/Q, Q, Q; on the tensor-core path,
// bf16 x, B and C at P 64 and N 128, (batch, S/Q, Qp, Qp) with Qp = Q
// rounded up to a multiple of 64), states (batch, S/Q, H, P, N).
// All contiguous; S % Q == 0, 1 <= Q <= 256, P in {4, 8, 16, 64}, N in
// {8, 16, 128}.  Returns the CUDA error of the launches (0 on success).
extern "C" int ssd_scan_fwd(int x_dtype, int bc_dtype, const void* x,
                            const float* dt, const float* A, const void* B,
                            const void* C, const float* D, void* y,
                            float* final_state, float* cs, float* G,
                            float* states, int batch, int S, int H, int P,
                            int N, int Q, void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || Q <= 0 || Q > kMaxQ || S % Q != 0)
    return cudaErrorInvalidValue;
  const Args a{x, dt, A, B, C, D, y, final_state, cs, G, states,
               Dims{batch, S, H, P, N, Q, S / Q}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && bc_dtype == 0) return by_shape<float, float>(a, st);
  if (x_dtype == 1 && bc_dtype == 1)
    return by_shape<__nv_bfloat16, __nv_bfloat16>(a, st);
  if (x_dtype == 1 && bc_dtype == 0)
    return by_shape<__nv_bfloat16, float>(a, st);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of the tensor-core kernels: kernel 0 =
// ssd_state_tc, 1 = ssd_out_tc.
extern "C" int ssd_scan_tc_smem(int kernel) {
  return kernel ? OutSmem::bytes : StateSmem::bytes;
}

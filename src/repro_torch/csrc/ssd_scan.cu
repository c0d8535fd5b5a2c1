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
// idle at batch 1.  Here the work is split into five launches on the
// caller's stream, each parallel over what does not depend on order:
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
// All arithmetic is fp32 on the CUDA cores, in bf16 too (the tensor cores
// would round fp32 inputs to TF32, and this first version keeps one path);
// the decay-weighted M is never rounded to bf16.  The mask is applied before
// the exponential: for j > i the argument cs_i - cs_j is positive and can
// overflow, and a mask applied by multiplication would turn inf * 0 into NaN.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  const int PN = d.P * d.N;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  float s = 0.f;
  for (int c = 0; c < d.nc; ++c) {
    const size_t last = (static_cast<size_t>(b) * d.S +
                         static_cast<size_t>(c) * d.Q + d.Q - 1) * d.H + h;
    const float decay = expf(cs[last]);
    float* sc = states + ((static_cast<size_t>(b) * d.nc + c) * d.H + h) * PN + e;
    const float own = *sc;
    *sc = s;
    s = __fadd_rn(__fmul_rn(decay, s), own);
  }
  final_state[(static_cast<size_t>(b) * d.H + h) * PN + e] = s;
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

template <int P, int N, typename TX, typename TB>
cudaError_t run(const Args& a, cudaStream_t st) {
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
  ssd_state_pass<<<dim3((P * N + kThreads - 1) / kThreads, d.H, d.batch),
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
// fp32: cs (batch, S, H), G (batch, S/Q, Q, Q), states (batch, S/Q, H, P, N).
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

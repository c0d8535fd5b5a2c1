// Decode attention over a contiguous KV cache: one query token per sequence.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention/kernel.py::decode_attention_pallas
// (body _decode_kernel).  Bound and design: see decode_common.cuh (memory
// bound; each cache byte read once, T split over blocks, splits merged in
// the same launch by the block that arrives last, except bf16 at G > 8).
// Unlike the Pallas kernel, any T works: the last split is masked instead of
// asserting T % blk_t == 0.
#include "decode_common.cuh"

// dtype: 0 = float32, 1 = bfloat16.  q, out (B, Hkv*G, D); k, v (B, T, Hkv, D);
// lengths (B,) int32; window <= 0 means none.  ml (B, Hkv, n_splits, G, 2)
// and acc (B, Hkv, n_splits, G, D) are fp32 scratch; counters (B, Hkv,
// head chunks) int32 are zero before the call and after it (the last
// argument, so a caller that passes it to an older library is ignored).
// Returns the CUDA error of the launches (0 on success).
extern "C" int decode_attention_fwd(int dtype, const void* q, const void* k,
                                    const void* v, const int* lengths,
                                    void* out, float* ml, float* acc, int B,
                                    int T, int Hkv, int G, int D, int window,
                                    float scale, int split_len, int n_splits,
                                    void* stream, int* counters) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    decode::ContiguousKV<float> kv{static_cast<const float*>(k),
                                   static_cast<const float*>(v), T, Hkv, D};
    return decode::launch<float>(q, kv, lengths, out, ml, acc, counters, B,
                                 Hkv, G, D, T, window, scale, split_len,
                                 n_splits, s);
  }
  if (dtype == 1) {
    decode::ContiguousKV<__nv_bfloat16> kv{
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), T, Hkv, D};
    return decode::launch<__nv_bfloat16>(q, kv, lengths, out, ml, acc,
                                         counters, B, Hkv, G, D, T, window,
                                         scale, split_len, n_splits, s);
  }
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of the tensor-core split kernel at head_dim D (0 if
// none).
extern "C" int decode_attention_mma_smem(int D) {
  switch (D) {
    case 16: return decode::MmaSmem<16>::bytes;
    case 32: return decode::MmaSmem<32>::bytes;
    case 64: return decode::MmaSmem<64>::bytes;
    case 128: return decode::MmaSmem<128>::bytes;
    case 256: return decode::MmaSmem<256>::bytes;
    default: return 0;
  }
}

// Dynamic shared memory of the one-launch kernels for dtype (0 = float32:
// decode_fused with maxg = 4 or 8 query heads a block; 1 = bfloat16:
// decode_fused_mma, maxg ignored) and head_dim D; 0 if none.
template <int MAXG>
static int fused_smem(int D) {
  switch (D) {
    case 16: return decode::Fused<16, MAXG>::bytes;
    case 32: return decode::Fused<32, MAXG>::bytes;
    case 64: return decode::Fused<64, MAXG>::bytes;
    case 128: return decode::Fused<128, MAXG>::bytes;
    case 256: return decode::Fused<256, MAXG>::bytes;
    default: return 0;
  }
}

extern "C" int decode_attention_fused_smem(int dtype, int D, int maxg) {
  if (dtype == 0 && (maxg == 4 || maxg == 8))
    return maxg == 4 ? fused_smem<4>(D) : fused_smem<8>(D);
  if (dtype == 1) {
    switch (D) {
      case 16: return decode::FusedMmaSmem<16>::bytes;
      case 32: return decode::FusedMmaSmem<32>::bytes;
      case 64: return decode::FusedMmaSmem<64>::bytes;
      case 128: return decode::FusedMmaSmem<128>::bytes;
      case 256: return decode::FusedMmaSmem<256>::bytes;
    }
  }
  return 0;
}

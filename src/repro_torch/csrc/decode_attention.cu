// Decode attention over a contiguous KV cache: one query token per sequence.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention/kernel.py::decode_attention_pallas
// (body _decode_kernel).  Bound and design: see decode_common.cuh (memory
// bound; each cache byte read once, T split over blocks, splits merged by a
// second kernel).  Unlike the Pallas kernel, any T works: the last split is
// masked instead of asserting T % blk_t == 0.
#include "decode_common.cuh"

// dtype: 0 = float32, 1 = bfloat16.  q, out (B, Hkv*G, D); k, v (B, T, Hkv, D);
// lengths (B,) int32; window <= 0 means none.  ml (B, Hkv, n_splits, G, 2)
// and acc (B, Hkv, n_splits, G, D) are fp32 scratch.  Returns the CUDA error
// of the launches (0 on success).
extern "C" int decode_attention_fwd(int dtype, const void* q, const void* k,
                                    const void* v, const int* lengths,
                                    void* out, float* ml, float* acc, int B,
                                    int T, int Hkv, int G, int D, int window,
                                    float scale, int split_len, int n_splits,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    decode::ContiguousKV<float> kv{static_cast<const float*>(k),
                                   static_cast<const float*>(v), T, Hkv, D};
    return decode::launch<float>(q, kv, lengths, out, ml, acc, B, Hkv, G, D,
                                 T, window, scale, split_len, n_splits, s);
  }
  if (dtype == 1) {
    decode::ContiguousKV<__nv_bfloat16> kv{
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), T, Hkv, D};
    return decode::launch<__nv_bfloat16>(q, kv, lengths, out, ml, acc, B, Hkv,
                                         G, D, T, window, scale, split_len,
                                         n_splits, s);
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

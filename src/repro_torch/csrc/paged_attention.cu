// Paged decode attention: one query token per sequence, K/V read in place
// from (NP, page, Hkv, D) pages through the page table.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention/kernel.py::paged_decode_attention_pallas
// (body _paged_kernel).  Bound and design: see decode_common.cuh (memory
// bound; each cache byte read once, T split over blocks, splits merged by a
// second kernel).  A split covers whole token ranges, not whole pages, so
// page sizes down to 8 need no special case; page ids are clipped to
// [0, NP-1] as the Pallas wrapper does, and pages wholly past lengths[b] are
// never read.
#include "decode_common.cuh"

// dtype: 0 = float32, 1 = bfloat16.  q, out (B, Hkv*G, D); k_pages, v_pages
// (NP, page, Hkv, D); page_table (B, maxp) int32; lengths (B,) int32;
// window <= 0 means none.  ml (B, Hkv, n_splits, G, 2) and acc
// (B, Hkv, n_splits, G, D) are fp32 scratch.  Returns the CUDA error of the
// launches (0 on success).
extern "C" int paged_attention_fwd(int dtype, const void* q, const void* k_pages,
                                   const void* v_pages, const int* page_table,
                                   const int* lengths, void* out, float* ml,
                                   float* acc, int B, int NP, int page,
                                   int maxp, int Hkv, int G, int D, int window,
                                   float scale, int split_len, int n_splits,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cap = maxp * page;
  if (dtype == 0) {
    decode::PagedKV<float> kv{static_cast<const float*>(k_pages),
                              static_cast<const float*>(v_pages), page_table,
                              NP, page, maxp, Hkv, D};
    return decode::launch<float>(q, kv, lengths, out, ml, acc, B, Hkv, G, D,
                                 cap, window, scale, split_len, n_splits, s);
  }
  if (dtype == 1) {
    decode::PagedKV<__nv_bfloat16> kv{
        static_cast<const __nv_bfloat16*>(k_pages),
        static_cast<const __nv_bfloat16*>(v_pages), page_table, NP, page, maxp,
        Hkv, D};
    return decode::launch<__nv_bfloat16>(q, kv, lengths, out, ml, acc, B, Hkv,
                                         G, D, cap, window, scale, split_len,
                                         n_splits, s);
  }
  return cudaErrorInvalidValue;
}

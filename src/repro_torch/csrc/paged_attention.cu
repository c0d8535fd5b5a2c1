// Paged decode attention: one query token per sequence, K/V read in place
// from (NP, page, Hkv, D) pages through the page table.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention/kernel.py::paged_decode_attention_pallas
// (body _paged_kernel).  Bound and design: see decode_common.cuh (memory
// bound; each cache byte read once, T split over blocks, splits merged in
// the same launch by the block that arrives last, except bf16 at G > 8).  A
// page of one KV head is `page` rows of D with a row stride of Hkv x D, so
// the ring's tiles are gathered row by row through the page table: a split
// covers whole token ranges, not whole pages, and any page size (8 and 16
// among them) needs no special case.  Page ids are clipped to [0, NP-1]
// before any address is formed, as the Pallas wrapper does, and pages
// wholly past lengths[b] are never read.
#include "decode_common.cuh"

// dtype: 0 = float32, 1 = bfloat16.  q, out (B, Hkv*G, D); k_pages, v_pages
// (NP, page, Hkv, D); page_table (B, maxp) int32; lengths (B,) int32;
// window <= 0 means none.  ml (B, Hkv, n_splits, G, 2) and acc
// (B, Hkv, n_splits, G, D) are fp32 scratch; counters (B, Hkv, head chunks)
// int32 are zero before the call and after it (the last argument, so a
// caller that passes it to an older library is ignored).  Returns the CUDA
// error of the launches (0 on success).
extern "C" int paged_attention_fwd(int dtype, const void* q, const void* k_pages,
                                   const void* v_pages, const int* page_table,
                                   const int* lengths, void* out, float* ml,
                                   float* acc, int B, int NP, int page,
                                   int maxp, int Hkv, int G, int D, int window,
                                   float scale, int split_len, int n_splits,
                                   void* stream, int* counters) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cap = maxp * page;
  const int shift = page > 0 && (page & (page - 1)) == 0 ? __builtin_ctz(page)
                                                        : -1;
  if (dtype == 0) {
    decode::PagedKV<float> kv{static_cast<const float*>(k_pages),
                              static_cast<const float*>(v_pages), page_table,
                              NP, page, maxp, Hkv, D, shift};
    return decode::launch<float>(q, kv, lengths, out, ml, acc, counters, B,
                                 Hkv, G, D, cap, window, scale, split_len,
                                 n_splits, s);
  }
  if (dtype == 1) {
    decode::PagedKV<__nv_bfloat16> kv{
        static_cast<const __nv_bfloat16*>(k_pages),
        static_cast<const __nv_bfloat16*>(v_pages), page_table, NP, page, maxp,
        Hkv, D, shift};
    return decode::launch<__nv_bfloat16>(q, kv, lengths, out, ml, acc,
                                         counters, B, Hkv, G, D, cap, window,
                                         scale, split_len, n_splits, s);
  }
  return cudaErrorInvalidValue;
}

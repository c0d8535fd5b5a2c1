// Device-side building blocks for pinned, host-mapped memory, shared by the
// host RPC's kernels: rpc_channel.cu (rpc_post's staging copies and reply
// flag) and rpc_async.cu (the async queue's epoch hand-off).
//
// A flag in mapped memory is published with st.release.sys and read with
// ld.acquire.sys, so the words written before a release are visible to the
// host (or to the device) that acquires it; waits are bounded by
// %globaltimer.  Copies between device memory and a staging region stride
// the grid's threads over 16-byte words where both ends allow it, 4-byte
// ones where they do not, and bytes for the rest; reads of mapped memory
// are cache-volatile (__ldcv), since a region is reused call after call.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace mapped {

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void store_release_sys(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned load_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Copy n bytes as T, the grid's threads striding (thread t of nt); the tail
// byte by byte.
template <class T, bool kFromHost>
__device__ __forceinline__ void copy_as(unsigned char* dst,
                                        const unsigned char* src, size_t n,
                                        size_t t, size_t nt) {
  const size_t k = n / sizeof(T);
  const T* s = reinterpret_cast<const T*>(src);
  T* d = reinterpret_cast<T*>(dst);
  for (size_t i = t; i < k; i += nt) d[i] = kFromHost ? __ldcv(s + i) : s[i];
  for (size_t i = k * sizeof(T) + t; i < n; i += nt)
    dst[i] = kFromHost ? __ldcv(src + i) : src[i];
}

// Copy n bytes from src to dst (addresses as integers), in the widest
// words that both ends' alignment allows; kFromHost: src is mapped memory.
template <bool kFromHost>
__device__ void copy_slot(unsigned long long dst, unsigned long long src,
                          size_t n, size_t t, size_t nt) {
  unsigned char* d = reinterpret_cast<unsigned char*>(dst);
  const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
  const unsigned long long both = dst | src;
  if ((both & 15) == 0)
    copy_as<uint4, kFromHost>(d, s, n, t, nt);
  else if ((both & 3) == 0)
    copy_as<unsigned, kFromHost>(d, s, n, t, nt);
  else
    copy_as<unsigned char, kFromHost>(d, s, n, t, nt);
}

}  // namespace mapped

// Immediate host RPC (paper §3.2): device code posts a record into pinned,
// host-mapped memory, a host thread drains it, and the device waits on a
// reply flag.
//
// Replaces no Pallas kernel.  The JAX package's transport is XLA's ordered
// io_callback (src/repro/core/rpc.py:1317, rpc_call), since a TPU program
// cannot poll host memory; on the H100 the port builds the paper's own
// design, which the TPU could not.
//
// Bound on the H100: the host link.  A round trip moves the operands
// device -> host and the result and the write-back refs host -> device
// over PCIe (cudaMemcpyAsync on the copy engines), plus two flag
// transfers and the host thread's reaction; the reply depends on the
// operands, so the two directions cannot overlap.  An empty call is bound
// by latency: the flag's trip to the host, the host's poll, the reply
// flag's trip back and the device's poll.
//
// Design, per call, all on the caller's stream (rpc_roundtrip):
//  1. cudaMemcpyAsync device -> pinned of each tensor operand into the
//     call's staging region (one region per landing pad and result shape,
//     or per queue geometry, on a channel, sized at its first use; the
//     record carries the region's channel-local id);
//  2. rpc_post: one warp writes the call's scalar operands (passed as
//     kernel arguments, so a Python number never needs a host-to-device
//     copy) into the staging region, takes a sequence number from the
//     channel's counter in device memory (so a replay of a captured CUDA
//     graph posts a fresh record), writes the record, makes it visible with
//     __threadfence_system() and publishes it with st.release.sys of the
//     state word; it then spins on ld.acquire.sys of that word, backing off
//     with __nanosleep, until the host stores DONE.  The wait is bounded by
//     %globaltimer: past the channel's timeout the kernel traps, so a lost
//     host thread fails the run instead of hanging it;
//  3. cudaMemcpyAsync pinned -> device of the result and of each WRITE or
//     READWRITE ref (a READ ref is not copied back).
// The host side (rpc_wait / rpc_complete) runs on a drain thread that
// waits in C, with Python's lock released, and reads the record after an
// acquire load of the state word; the callee's writes to the staging
// region precede its release store of DONE.  A stream holds at most one
// posted record at a time (each post waits for its reply), so a channel
// has one record.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>
#include <time.h>

namespace {

enum : unsigned { kEmpty = 0, kPosted = 1, kDone = 2 };

// Scalar operands of one call, written by the kernel into the staging
// region's first words.
constexpr int kInlineWords = 16;

// The channel's record, in mapped host memory.
struct Record {
  unsigned state;                // kEmpty / kPosted / kDone
  unsigned seq;                  // from the channel's device counter
  unsigned long long staging;    // the staging region's channel-local id
  unsigned long long waited_ns;  // device clock: post to DONE seen
  unsigned status;               // host: 0 served, 1 the callee raised
  unsigned reserved[9];
};
static_assert(sizeof(Record) == 64, "one 64-byte record");

struct Inline {
  unsigned w[kInlineWords];
};

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

__global__ void rpc_post(Record* rec, unsigned* counter,
                         unsigned long long staging,
                         unsigned long long timeout_ns, Inline words,
                         int n_inline, unsigned* inline_dst) {
  const int lane = threadIdx.x;
  if (lane < n_inline) inline_dst[lane] = words.w[lane];
  __threadfence_system();
  __syncwarp();
  if (lane != 0) return;
  const unsigned seq = atomicAdd(counter, 1u) + 1u;
  rec->seq = seq;
  rec->staging = staging;
  rec->status = 0;
  __threadfence_system();
  store_release_sys(&rec->state, kPosted);
  const unsigned long long t0 = global_ns();
  unsigned sleep_ns = 32;
  while (load_acquire_sys(&rec->state) != kDone) {
    if (global_ns() - t0 > timeout_ns) {
      printf("rpc_post: no reply to staging %llu (seq %u) within %llu ns\n", staging,
             seq, timeout_ns);
      __trap();
    }
    __nanosleep(sleep_ns);
    if (sleep_ns < 1024) sleep_ns <<= 1;
  }
  rec->waited_ns = global_ns() - t0;
  store_release_sys(&rec->state, kEmpty);
}

double now_us() {
  timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return t.tv_sec * 1e6 + t.tv_nsec * 1e-3;
}

}  // namespace

extern "C" {

// Pinned host memory mapped into the device's address space, zeroed.
// Writes its host and device pointers.
int rpc_host_alloc(size_t bytes, void** host, void** dev) {
  cudaError_t e =
      cudaHostAlloc(host, bytes, cudaHostAllocMapped | cudaHostAllocPortable);
  if (e != cudaSuccess) return e;
  memset(*host, 0, bytes);
  return cudaHostGetDevicePointer(dev, *host, 0);
}

int rpc_record_bytes() { return sizeof(Record); }

// One call in stream order: n_in copies device -> staging, rpc_post,
// n_out copies staging -> device.  Returns the first CUDA error, or 0.
int rpc_roundtrip(void* rec, unsigned* counter, unsigned long long staging,
                  unsigned long long timeout_ns, int n_in,
                  void* const* in_dst, const void* const* in_src,
                  const size_t* in_bytes, const unsigned* inline_words,
                  int n_inline, void* inline_dst, int n_out,
                  void* const* out_dst, const void* const* out_src,
                  const size_t* out_bytes, void* stream) {
  if (n_inline < 0 || n_inline > kInlineWords) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < n_in; ++i) {
    cudaError_t e = cudaMemcpyAsync(in_dst[i], in_src[i], in_bytes[i],
                                    cudaMemcpyDeviceToHost, st);
    if (e != cudaSuccess) return e;
  }
  Inline words{};
  for (int i = 0; i < n_inline; ++i) words.w[i] = inline_words[i];
  rpc_post<<<1, 32, 0, st>>>(static_cast<Record*>(rec), counter, staging,
                             timeout_ns, words, n_inline,
                             static_cast<unsigned*>(inline_dst));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  for (int i = 0; i < n_out; ++i) {
    e = cudaMemcpyAsync(out_dst[i], out_src[i], out_bytes[i],
                        cudaMemcpyHostToDevice, st);
    if (e != cudaSuccess) return e;
  }
  return 0;
}

// Host side: wait up to timeout_us for a posted record.  Spins for the
// first spin_us (a burst of calls finds the thread awake), then naps 20 us
// between polls up to 10x spin_us, then 500 us (an idle channel costs its
// process ~2000 wake-ups a second).  Returns 1 with the record's staging
// id written, 0 on timeout.
int rpc_wait(void* rec_host, long long timeout_us, long long spin_us,
             unsigned long long* staging) {
  Record* r = static_cast<Record*>(rec_host);
  const double t0 = now_us();
  long nap_ns = 0;
  for (unsigned i = 1;; ++i) {
    if (__atomic_load_n(&r->state, __ATOMIC_ACQUIRE) == kPosted) {
      *staging = r->staging;
      return 1;
    }
    if (nap_ns || (i & 255) == 0) {
      const double dt = now_us() - t0;
      if (dt > timeout_us) return 0;
      nap_ns = dt <= spin_us ? 0 : dt <= 10 * spin_us ? 20000 : 500000;
    }
    if (nap_ns) {
      timespec nap{0, nap_ns};
      nanosleep(&nap, nullptr);
    } else {
#if defined(__x86_64__)
      asm volatile("pause" ::: "memory");
#endif
    }
  }
}

// Host side: publish the reply (the staging region's result and
// write-backs are written) with a release store of DONE.
void rpc_complete(void* rec_host, unsigned status) {
  Record* r = static_cast<Record*>(rec_host);
  r->status = status;
  __atomic_store_n(&r->state, kDone, __ATOMIC_RELEASE);
}

// The device's wait of the last call (post to DONE seen), ns.
unsigned long long rpc_waited_ns(void* rec_host) {
  return static_cast<Record*>(rec_host)->waited_ns;
}

// Wait for the stream (the effects barrier), with Python's lock released.
int rpc_stream_sync(void* stream) {
  return cudaStreamSynchronize(static_cast<cudaStream_t>(stream));
}

}  // extern "C"

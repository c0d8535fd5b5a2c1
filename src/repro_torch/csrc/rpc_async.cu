// The async batched queue's epoch hand-off (paper §3.2's host RPC with the
// drain overlapped with device work): a flush publishes the closing
// epoch's records to a host thread without waiting, and installs the
// previous epoch's replies once that epoch's drain has answered.
//
// Replaces no Pallas kernel.  The JAX package's async flush is one ordered
// io_callback (src/repro/core/rpc.py:3180, RpcQueue.flush with
// mode="async") whose host side submits the epoch to a single-thread
// executor and waits for the previous one (_async_flush_shard, :2488);
// the TPU cannot poll host memory.  On the H100 the two halves become two
// kernels on the caller's stream, and the host never blocks the stream
// for the epoch it was just handed.
//
// Memory, per queue, in pinned host-mapped memory (kernels/rpc_async):
// two records (one per epoch parity, so a drain never reads lanes that
// the device is writing for the next epoch), a word mirroring the host's
// carried-record depth, and per parity an "in" region (the queue's words
// [0, in_end): records, arena, heads and window, copied by one
// cudaMemcpyAsync) and an "out" region (carried depth, reply offsets,
// lengths, statuses and the reply arena, written by the host's drain).
// Epochs are numbered from 1 by the host (the flush count); epoch e uses
// parity e & 1.  Every field of a record holds the number of the last
// epoch that reached its stage, so no field is ever reset.
//
//  rpc_async_post (one warp, lane 0): after the stream's copy of epoch e's
//    words into in[e & 1], moves the queue's window on the device
//    (rbase, rcount <- pbase, pcount on a reply-carrying queue; pbase,
//    pcount <- base, head; base += head; heads zeroed; fonce = 1) and
//    publishes `posted = e` with st.release.sys.  It does not wait.
//  rpc_async_collect (one block): lane 0 waits with ld.acquire.sys for
//    `done == e - 1` on the other parity's record, backing off with
//    __nanosleep, bounded by %globaltimer: past the queue's deadline it
//    gives up, past the channel's timeout (no deadline) it traps, so a
//    lost host thread fails the run instead of hanging it.  Then the block
//    copies out[(e - 1) & 1] into the queue's reply fields with
//    cache-volatile loads.  On a deadline overrun it writes the stamped
//    window itself (zero offsets, lengths and replies, every status
//    TIMEOUT, the host's live carried depth), raises `abandoned = e - 1`
//    (the late drain reads it before it carries records) and waits for
//    the host to have taken epoch e - 1's records (`consumed`), so that
//    the next post on that parity cannot overwrite them.  The first
//    flush (no previous epoch, nothing carried yet) installs zeros.
//
// Bound on the H100: latency.  post moves ten words; collect moves
// 1 + 3 * capacity + reply_capacity words over the host link, plus the
// flag's trip.  The host side (rpc_async_wait, rpc_async_store,
// rpc_async_load) runs on the queue's ingest thread and its drain
// executor, with Python's lock released while it waits.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <time.h>

namespace {

// A record's fields, as rpc_async_store / rpc_async_load number them.
enum : int { kPosted = 0, kConsumed = 1, kDone = 2, kAbandoned = 3 };

// The reply status a deadline overrun stamps (STATUS_TIMEOUT in
// core/rpc.py).
constexpr int kStatusTimeout = 2;

// What collect found.
enum : unsigned { kServed = 0, kFirst = 1, kTimedOut = 2 };

struct AsyncRecord {
  unsigned stage[4];  // posted, consumed, done, abandoned
  unsigned reserved[12];
};
static_assert(sizeof(AsyncRecord) == 64, "one 64-byte record");

// The queue's words from `head` on (core/rpc.py's _HEADS + _WINDOW).
enum : int {
  kHead = 0, kPhead, kAdrops, kBase, kRbase, kRcount, kFonce, kPbase,
  kPcount, kCdepth
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

// Spin until *p == want (with back-off); false once `limit_ns` passed.
__device__ bool wait_for(const unsigned* p, unsigned want,
                         unsigned long long limit_ns) {
  const unsigned long long t0 = global_ns();
  unsigned sleep_ns = 32;
  while (load_acquire_sys(p) != want) {
    if (global_ns() - t0 > limit_ns) return false;
    __nanosleep(sleep_ns);
    if (sleep_ns < 1024) sleep_ns <<= 1;
  }
  return true;
}

__global__ void rpc_async_post(AsyncRecord* rec, unsigned epoch, int* h,
                               int has_reply) {
  if (threadIdx.x != 0) return;
  const int head = h[kHead], base = h[kBase];
  if (has_reply) {
    h[kRbase] = h[kPbase];
    h[kRcount] = h[kPcount];
  }
  h[kPbase] = base;
  h[kPcount] = head;
  h[kBase] = static_cast<int>(static_cast<unsigned>(base) +
                              static_cast<unsigned>(head));
  h[kHead] = 0;
  h[kPhead] = 0;
  h[kAdrops] = 0;
  h[kFonce] = 1;
  __threadfence_system();
  store_release_sys(&rec->stage[kPosted], epoch);
}

__global__ void rpc_async_collect(AsyncRecord* rec, unsigned epoch,
                                  int have_prev,
                                  unsigned long long deadline_ns,
                                  unsigned long long timeout_ns,
                                  const int* src, int* dst, int rslots,
                                  int rc, const int* live_cdepth) {
  __shared__ unsigned outcome;
  const int n = 1 + 3 * rslots + rc;
  if (threadIdx.x == 0) {
    unsigned o = kFirst;
    if (have_prev) {
      const unsigned long long limit = deadline_ns ? deadline_ns : timeout_ns;
      if (wait_for(&rec->stage[kDone], epoch, limit)) {
        o = kServed;
      } else if (deadline_ns) {
        o = kTimedOut;
      } else {
        printf("rpc_async_collect: epoch %u not drained within %llu ns\n",
               epoch, timeout_ns);
        __trap();
      }
    }
    outcome = o;
  }
  __syncthreads();
  const unsigned o = outcome;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int v = 0;
    if (o == kServed) {
      v = __ldcv(src + i);
    } else if (o == kTimedOut) {
      if (i == 0) {
        v = *reinterpret_cast<const volatile int*>(live_cdepth);
      } else if (i > 2 * rslots && i <= 3 * rslots) {
        v = kStatusTimeout;
      }
    }
    dst[i] = v;
  }
  if (o == kTimedOut && threadIdx.x == 0) {
    store_release_sys(&rec->stage[kAbandoned], epoch);
    if (!wait_for(&rec->stage[kConsumed], epoch, timeout_ns)) {
      printf("rpc_async_collect: epoch %u never taken by the host\n", epoch);
      __trap();
    }
  }
}

double now_us() {
  timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return t.tv_sec * 1e6 + t.tv_nsec * 1e-3;
}

}  // namespace

extern "C" {

int rpc_async_record_bytes() { return sizeof(AsyncRecord); }

// Epoch `epoch`'s hand-off on `stream`: copy the queue's words [0,
// in_bytes) into the pinned "in" region, then rpc_async_post.
int rpc_async_post_launch(void* rec, unsigned epoch, void* in_host,
                          const void* state, size_t in_bytes, int* h,
                          int has_reply, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemcpyAsync(in_host, state, in_bytes,
                                  cudaMemcpyDeviceToHost, st);
  if (e != cudaSuccess) return e;
  rpc_async_post<<<1, 32, 0, st>>>(static_cast<AsyncRecord*>(rec), epoch, h,
                                   has_reply);
  return cudaGetLastError();
}

// Install epoch `epoch`'s replies (have_prev 0: the first flush, zeros).
int rpc_async_collect_launch(void* rec, unsigned epoch, int have_prev,
                             unsigned long long deadline_ns,
                             unsigned long long timeout_ns, const int* src,
                             int* dst, int rslots, int rc,
                             const int* live_cdepth, void* stream) {
  rpc_async_collect<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<AsyncRecord*>(rec), epoch, have_prev, deadline_ns,
      timeout_ns, src, dst, rslots, rc, live_cdepth);
  return cudaGetLastError();
}

// Host side: wait up to timeout_us for `posted == epoch` (spin for
// spin_us, then nap 20 us, then 500 us, as rpc_wait).  1 on success.
int rpc_async_wait(void* rec_host, unsigned epoch, long long timeout_us,
                   long long spin_us) {
  const unsigned* p = static_cast<AsyncRecord*>(rec_host)->stage + kPosted;
  const double t0 = now_us();
  long nap_ns = 0;
  for (unsigned i = 1;; ++i) {
    if (__atomic_load_n(p, __ATOMIC_ACQUIRE) == epoch) return 1;
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

// Host side: a release store of one stage (consumed, done).
void rpc_async_store(void* rec_host, int field, unsigned epoch) {
  __atomic_store_n(static_cast<AsyncRecord*>(rec_host)->stage + field, epoch,
                   __ATOMIC_RELEASE);
}

// Host side: an acquire load of one stage (abandoned).
unsigned rpc_async_load(void* rec_host, int field) {
  return __atomic_load_n(static_cast<AsyncRecord*>(rec_host)->stage + field,
                         __ATOMIC_ACQUIRE);
}

}  // extern "C"

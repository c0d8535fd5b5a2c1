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
// A queue has one or more rows: a single queue one, a sharded queue one
// per shard (its (rows, words) state), all handed over by the same two
// launches.  Memory, per queue, in pinned host-mapped memory
// (kernels/rpc_async): per epoch parity a record per row (two parities,
// so a drain never reads lanes that the device is writing for the next
// epoch), a word per row mirroring the host's carried-record depth, and
// per parity an "in" region (each row's words [0, in_end): records,
// arena, heads and window) and an "out" region (each row's carried depth,
// reply offsets, lengths, statuses and reply arena, written by the host's
// drain of that row); the regions' rows start 16 bytes apart or a multiple
// of it.  Epochs are numbered from 1 by the host (the flush count); epoch
// e uses parity e & 1.  `posted` and `consumed` live in the parity's first
// record (one hand-off an epoch), `done` and `abandoned` in each row's
// (each row drains on its own).  Every field of a record holds the number
// of the last epoch that reached its stage, so no field is ever reset.
//
// Both kernels take one AsyncFlush (kernel.py::_AsyncFlush): both
// parities' addresses, the state's geometry, the copy route, and the
// epoch, parity and deadline that each flush patches (a queue's cached
// kernel.py::AsyncFlushPlan; one C call, rpc_async_flush_launch, issues
// both launches on the caller's stream).
//
//  rpc_async_post (a grid sized by bytes: about a block per 16 KB of rows,
//    at least a block a row, at most one an SM): the blocks copy each
//    row's words [0, in_end) into in[e & 1] with 16-byte stores where
//    both ends allow it (mapped.cuh::copy_slot), and each block arrives
//    at the ring's counter in device memory after a barrier.  The last
//    block to arrive moves each row's window (rbase, rcount <- pbase,
//    pcount on a reply-carrying queue; pbase, pcount <- base, head; base
//    += head; heads zeroed; fonce = 1: only after every block has read
//    them), resets the counter and publishes `posted = e` with
//    st.release.sys, which is cumulative over every block's stores (the
//    barriers and the counter order them before it), so the host, which
//    reads `in` after its acquire load of `posted`, sees them all; no
//    store takes a system fence of its own.  No block waits, so the grid
//    needs no cooperative launch.  When the rows hold more than
//    kernel.py::COPY_LIMIT bytes in all, the copy engines copy instead (a
//    cudaMemcpyAsync, or cudaMemcpy2DAsync for several rows, before a
//    one-block launch), as rpc_post's large slots do; the plan chooses.
//    `post(e + 2)` reuses in[e & 1] safely only because it follows
//    `collect(e + 1)` on the same stream, which waits for done(e), which
//    the host releases after taking epoch e's records.
//  rpc_async_collect (one block a row): thread 0 polls `done == e - 1` on
//    the row's record of the other parity with ld.acquire.sys (the first
//    poll at once, then backing off with __nanosleep), bounded by
//    %globaltimer: past the queue's deadline it gives up, past the
//    channel's timeout (no deadline) it traps, so a lost host thread fails
//    the run instead of hanging it.  The rows wait side by side, so the
//    deadline is one budget for all of them.  Then the block reads the
//    row's out[(e - 1) & 1] with 16-byte cache-volatile loads, up to
//    kLoads of them a thread issued before any store (one round over the
//    link for up to 4,096 words), and stores 4-byte words into the reply
//    fields (state + out_start + cdepth is not 16-byte aligned in
//    general).  On a deadline overrun it writes the stamped window itself
//    (zero offsets, lengths and replies, every status TIMEOUT, the host's
//    live carried depth of the row), raises the row's `abandoned = e - 1`
//    (the late drain reads it before it carries records) and waits for
//    the host to have taken epoch e - 1's records (`consumed`), so that
//    the next post on that parity cannot overwrite them.  The first flush
//    (no previous epoch, nothing carried yet) installs zeros.
//
// Bound on the H100: latency.  post moves in_end words a row device ->
// host and ten words a row on the device; collect moves 1 + 3 * capacity
// + reply_capacity words a row over the host link, after the flag's round
// trip.  The floor under both is an empty launch and one ld.acquire.sys
// round trip of a mapped word (chip_smoke.py's rpc_async_time line).  The
// host side (rpc_async_wait, rpc_async_store, rpc_async_load) runs on the
// queue's ingest thread and its drain executor, with Python's lock
// released while it waits.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <time.h>

#include "mapped.cuh"

// The launch's parameters, named (not in the anonymous namespace) so the C
// entries that take them keep external linkage.
namespace rpc_async {

// One flush of a queue's ring: what kernel.py::pack_flush packs.  A plan
// patches epoch, prev, parity, have_prev and deadline_ns every flush.
struct AsyncFlush {
  unsigned long long rec[2];       // device view: parity p's first record
  unsigned long long in[2];        // device view: parity p's in region
  unsigned long long in_host[2];   // its host view (the copy engines')
  unsigned long long out[2];       // device view: parity p's out region
  unsigned long long state;        // row 0's word 0 (device memory)
  unsigned long long live;         // device view: a live carried depth a row
  unsigned long long arrivals;     // the ring's counter (device memory)
  unsigned long long deadline_ns;  // 0: no deadline
  unsigned long long timeout_ns;   // the channel's wait (then a trap)
  long long pitch;                 // words between two rows of the state
  long long in_bytes;              // a row's words [0, in_end), bytes
  long long in_pitch;              // bytes between two rows of in
  long long out_pitch;             // words between two rows of out
  int rows;
  int out_start;                   // the state's word of `head`
  int rslots;                      // the queue's capacity
  int rc;                          // its reply capacity
  int has_reply;
  int grid;                        // rpc_async_post's blocks
  int engine;                      // 1: the copy engines copy the rows
  unsigned epoch;                  // the epoch posted
  unsigned prev;                   // epoch - 1, the epoch collected
  int parity;                      // epoch & 1
  int have_prev;                   // 0 at the first flush
  int reserved;
};
static_assert(sizeof(AsyncFlush) == 184, "kernel.py::_AsyncFlush");

}  // namespace rpc_async

using namespace rpc_async;
using mapped::global_ns;
using mapped::load_acquire_sys;
using mapped::store_release_sys;

namespace {

// A record's fields, as rpc_async_store / rpc_async_load number them.
enum : int { kPosted = 0, kConsumed = 1, kDone = 2, kAbandoned = 3 };

// The reply status a deadline overrun stamps (STATUS_TIMEOUT in
// core/rpc.py).
constexpr int kStatusTimeout = 2;

// What collect found.
enum : unsigned { kServed = 0, kFirst = 1, kTimedOut = 2 };

constexpr int kThreads = 256;
// 16-byte loads a thread of rpc_async_collect issues before it stores.
constexpr int kLoads = 4;

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

// Poll until *p == want: the first poll at once, then with back-off;
// false once `limit_ns` passed.
__device__ bool wait_for(const unsigned* p, unsigned want,
                         unsigned long long limit_ns) {
  if (load_acquire_sys(p) == want) return true;
  const unsigned long long t0 = global_ns();
  unsigned sleep_ns = 32;
  for (;;) {
    if (global_ns() - t0 > limit_ns) return false;
    __nanosleep(sleep_ns);
    if (sleep_ns < 1024) sleep_ns <<= 1;
    if (load_acquire_sys(p) == want) return true;
  }
}

// A row's window hand-off (h: the row's words from `head` on).
__device__ __forceinline__ void move_window(int* h, int has_reply) {
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
}

__global__ void __launch_bounds__(kThreads)
    rpc_async_post(const __grid_constant__ AsyncFlush p) {
  unsigned* const arrivals = reinterpret_cast<unsigned*>(p.arrivals);
  int* const state = reinterpret_cast<int*>(p.state);
  if (!p.engine) {
    const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
    const size_t nt = static_cast<size_t>(gridDim.x) * blockDim.x;
    for (int d = 0; d < p.rows; ++d)
      mapped::copy_slot<false>(
          p.in[p.parity] + d * p.in_pitch,
          p.state + 4ull * static_cast<unsigned long long>(d * p.pitch),
          p.in_bytes, t, nt);
  }
  // The stores to `in` take no system fence of their own: the barrier
  // orders a block's stores before its thread 0's arrival (a release at
  // the card's scope), the last block acquires every arrival, and its
  // st.release.sys of `posted` is cumulative over all of them, so the
  // host, which acquires `posted`, sees every store.  (A system fence a
  // thread and one before the release cost ~4.3 us of the kernel's 12.8
  // on an H100 at 700 W: chip_smoke.py's rpc_async_time line.)
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    if (gridDim.x > 1) __threadfence();
    last = gridDim.x == 1 || atomicAdd(arrivals, 1u) == gridDim.x - 1;
    if (last && gridDim.x > 1) {
      __threadfence();
      *arrivals = 0u;
    }
  }
  __syncthreads();
  if (!last) return;
  // Every block has read its words: the windows may move.
  for (int d = threadIdx.x; d < p.rows; d += blockDim.x)
    move_window(state + d * p.pitch + p.out_start, p.has_reply);
  __syncthreads();
  if (threadIdx.x == 0) {
    AsyncRecord* rec = reinterpret_cast<AsyncRecord*>(p.rec[p.parity]);
    store_release_sys(&rec->stage[kPosted], p.epoch);
  }
}

__global__ void __launch_bounds__(kThreads)
    rpc_async_collect(const __grid_constant__ AsyncFlush p) {
  __shared__ unsigned outcome;
  const int q = p.parity ^ 1;            // the previous epoch's parity
  const int n = 1 + 3 * p.rslots + p.rc;
  const int n4 = (n + 3) / 4;
  const int d = blockIdx.x;
  AsyncRecord* const rec = reinterpret_cast<AsyncRecord*>(p.rec[q]);
  AsyncRecord* const own = rec + d;
  const uint4* const src = reinterpret_cast<const uint4*>(
      p.out[q] + 4ull * static_cast<unsigned long long>(d * p.out_pitch));
  int* const dst = reinterpret_cast<int*>(p.state) + d * p.pitch +
                   p.out_start + kCdepth;
  if (threadIdx.x == 0) {
    unsigned o = kFirst;
    if (p.have_prev) {
      const unsigned long long limit =
          p.deadline_ns ? p.deadline_ns : p.timeout_ns;
      if (wait_for(&own->stage[kDone], p.prev, limit)) {
        o = kServed;
      } else if (p.deadline_ns) {
        o = kTimedOut;
      } else {
        printf("rpc_async_collect: epoch %u row %d not drained within "
               "%llu ns\n", p.prev, d, p.timeout_ns);
        __trap();
      }
    }
    outcome = o;
  }
  __syncthreads();
  const unsigned o = outcome;
  for (int j0 = 0; j0 < n4; j0 += kThreads * kLoads) {
    uint4 v[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int j = j0 + k * kThreads + static_cast<int>(threadIdx.x);
      v[k] = o == kServed && j < n4 ? __ldcv(src + j)
                                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int j = j0 + k * kThreads + static_cast<int>(threadIdx.x);
      const unsigned w[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 4 * j + c;
        if (i >= n) break;
        int x = static_cast<int>(w[c]);
        if (o == kTimedOut)
          x = i == 0 ? *(reinterpret_cast<const volatile int*>(p.live) + d)
              : i > 2 * p.rslots && i <= 3 * p.rslots ? kStatusTimeout
                                                      : 0;
        dst[i] = x;
      }
    }
  }
  if (o == kTimedOut && threadIdx.x == 0) {
    store_release_sys(&own->stage[kAbandoned], p.prev);
    if (!wait_for(&rec->stage[kConsumed], p.prev, p.timeout_ns)) {
      printf("rpc_async_collect: epoch %u never taken by the host\n",
             p.prev);
      __trap();
    }
  }
}

// The latency floor under both kernels: an empty launch (word null), or
// one whose thread 0 makes one ld.acquire.sys round trip of a mapped word.
__global__ void rpc_async_floor(const unsigned* word) {
  if (word != nullptr && threadIdx.x == 0) (void)load_acquire_sys(word);
}

// CUDA API calls that the launch entries made since the library was
// loaded (any thread may flush: counted atomically).
unsigned long long g_api_calls = 0;

inline void count_api_call() {
  __atomic_add_fetch(&g_api_calls, 1ull, __ATOMIC_RELAXED);
}

cudaError_t launch(const void* kernel, int grid, const AsyncFlush* p,
                   cudaStream_t st) {
  void* args[] = {const_cast<AsyncFlush*>(p)};
  count_api_call();
  return cudaLaunchKernel(kernel, dim3(grid), dim3(kThreads), args, 0, st);
}

cudaError_t post(const AsyncFlush* p, cudaStream_t st) {
  if (p->engine) {
    void* dst = reinterpret_cast<void*>(p->in_host[p->parity]);
    const void* src = reinterpret_cast<const void*>(p->state);
    count_api_call();
    const cudaError_t e =
        p->rows == 1
            ? cudaMemcpyAsync(dst, src, p->in_bytes, cudaMemcpyDeviceToHost,
                              st)
            : cudaMemcpy2DAsync(dst, p->in_pitch, src, 4 * p->pitch,
                                p->in_bytes, p->rows, cudaMemcpyDeviceToHost,
                                st);
    if (e != cudaSuccess) return e;
  }
  return launch(reinterpret_cast<const void*>(rpc_async_post), p->grid, p,
                st);
}

cudaError_t collect(const AsyncFlush* p, cudaStream_t st) {
  return launch(reinterpret_cast<const void*>(rpc_async_collect), p->rows, p,
                st);
}

double now_us() {
  timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return t.tv_sec * 1e6 + t.tv_nsec * 1e-3;
}

}  // namespace

extern "C" {

int rpc_async_record_bytes() { return sizeof(AsyncRecord); }
int rpc_async_flush_bytes() { return sizeof(AsyncFlush); }

// Epoch p->epoch's hand-off on `stream` (the copy engines first on that
// route), then nothing waits.
int rpc_async_post_launch(const AsyncFlush* p, void* stream) {
  return post(p, static_cast<cudaStream_t>(stream));
}

// Install epoch p->prev's replies (p->have_prev 0: the first flush,
// zeros), one block a row.
int rpc_async_collect_launch(const AsyncFlush* p, void* stream) {
  return collect(p, static_cast<cudaStream_t>(stream));
}

// A flush: rpc_async_post then rpc_async_collect on `stream`, in that
// order (two launches, and a copy before them above COPY_LIMIT).  Returns
// the first CUDA error, or 0.
int rpc_async_flush_launch(const AsyncFlush* p, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = post(p, st);
  return e != cudaSuccess ? e : collect(p, st);
}

// The floor's launch (rpc_async_floor): word null for an empty one.
int rpc_async_floor_launch(const void* word, void* stream) {
  rpc_async_floor<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(word));
  return cudaGetLastError();
}

unsigned long long rpc_async_api_calls() {
  return __atomic_load_n(&g_api_calls, __ATOMIC_RELAXED);
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

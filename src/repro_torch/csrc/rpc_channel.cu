// Immediate host RPC (paper §3.2): device code posts a record into pinned,
// host-mapped memory, a host thread drains it, and the device waits on a
// reply flag.
//
// Replaces no Pallas kernel.  The JAX package's transport is XLA's ordered
// io_callback (src/repro/core/rpc.py:1317, rpc_call), since a TPU program
// cannot poll host memory; on the H100 the port builds the paper's own
// design, which the TPU could not.
//
// Bound on the H100: the host link for the bytes (the operands device ->
// host, the result and the write-back refs host -> device; the reply
// depends on the operands, so the two directions cannot overlap) and, for
// a small call, latency: the record's trip to the host, the host's poll,
// the reply flag's trip back and the device's poll.  `rpc_floor_serve`
// below answers records in a C loop with no Python, which measures that
// floor on the card.  On the host side a CUDA API call costs tens of
// microseconds on the chip machine, so a call's enqueue is held to one.
//
// Design, per call, on the caller's stream (rpc_roundtrip, one C call):
//  1. the host marks a record as due in the channel's host memory (a
//     ticket) and wakes the drain thread if it sleeps;
//  2. one launch of rpc_post, whose `__grid_constant__` argument carries
//     the call's slot table: for each tensor slot the device address, the
//     slot's address in the staging region (one region per landing pad and
//     result shape, or per queue geometry, on a channel; the record
//     carries its channel-local id), the byte count and the direction, and
//     the call's scalar operands as inline words (so a Python number never
//     needs a host-to-device copy).  The blocks copy the operands into the
//     mapped staging region with 16-byte stores where both ends allow it,
//     fence with __threadfence_system() and arrive at the channel's arrival
//     counter in device memory; the last block to arrive takes a sequence
//     number from the channel's counter in device memory (so a replay of a
//     captured CUDA graph posts a fresh record), writes the record and
//     publishes it with st.release.sys of the state word, then spins on
//     ld.acquire.sys of that word, backing off with __nanosleep, until the
//     host stores DONE.  The wait is bounded by %globaltimer: past the
//     channel's timeout the kernel traps, so a lost host thread fails the
//     run instead of hanging it.  It then releases the other blocks (a
//     generation word in device memory), and all blocks copy the result and
//     the WRITE / READWRITE refs out of the staging region into their
//     device tensors.  Only the blocks that copy results back wait (the
//     table's `out_grid`, one per 16 KB of results); the others exit when
//     they have arrived.  A waiting block needs the grid resident at once,
//     so a grid of more than one block is launched cooperatively (the card
//     starts it only when every block fits) and never has more blocks than
//     the card has SMs (rpc_max_blocks): while the host serves a call it
//     holds at most one block of 256 threads an SM;
//  3. a slot above the plan's size limit (kernel.py::COPY_LIMIT, measured
//     on the card) is not in the table: it keeps a cudaMemcpyAsync on the
//     copy engines, device -> staging before the launch and staging ->
//     device after it.  A call whose every slot is at or below the limit
//     makes one CUDA API call, the launch.
// The host side (rpc_drain) runs on a drain thread that
// waits in C, with Python's lock released, and reads the record after an
// acquire load of the state word; the callee's writes to the staging
// region precede its release store of DONE.  While a launched record is
// due the drain spins; otherwise it spins for a while after each wait
// starts and then sleeps on a futex that the next launch wakes, so an idle
// channel costs its process little.  A graph replay posts with no host
// launch and marks nothing due: it is answered on that idle schedule (the
// futex's naps, 20 us and then 500 us).  A stream holds at most one posted
// record at a time (each post waits for its reply), so a channel has one
// record.
#include <cuda_runtime.h>
#include <linux/futex.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/syscall.h>
#include <time.h>
#include <unistd.h>

#include "mapped.cuh"

// The descriptor's types, named (not in the anonymous namespace) so the C
// entries that take them keep external linkage.
namespace rpc_channel {

enum : unsigned { kEmpty = 0, kPosted = 1, kDone = 2 };

// Scalar operands of one call, written by the kernel into the staging
// region's first words.
constexpr int kInlineWords = 16;
// The slot table fills the 32,764 bytes a kernel's parameters may take
// (CUDA 12.1 on).  Slots past it are refused (kernel.py::MAX_SLOTS);
// copy-engine slots are not counted.  RPC_SLOTS builds a shorter table, to
// time the argument's size against it (evaluation/rpc_ab.py; NVIDIA H100
// 80GB HBM3, 700 W, three runs each, 1344 slots against 32): the latency
// floor 0.0141-0.0143 ms against 0.0134-0.0138, the empty round trip
// 0.285-0.504 ms against 0.290-0.964, the 4 KB ref 0.28-0.34 against
// 0.47-1.21.  The full table costs under 1 us, inside the spread, so the
// kernel has one table.
#ifndef RPC_SLOTS
#define RPC_SLOTS 1344
#endif
constexpr int kSlots = RPC_SLOTS;
constexpr int kThreads = 256;

// The channel's record, in mapped host memory.
struct Record {
  unsigned state;                // kEmpty / kPosted / kDone
  unsigned seq;                  // from the channel's device counter
  unsigned long long staging;    // the staging region's channel-local id
  unsigned long long waited_ns;  // device clock: post to DONE seen
  unsigned status;               // host: 0 served, 1 the callee raised
  unsigned ticket;               // the launch's host ticket
  unsigned reserved[8];
};
static_assert(sizeof(Record) == 64, "one 64-byte record");

// The channel's host-only words, in ordinary host memory: what is due and
// whether the drain sleeps.
struct Waker {
  unsigned launched;             // tickets handed out by launches (futex)
  unsigned served;               // the newest ticket answered
  unsigned sleeping;             // the drain sleeps on `launched`
  unsigned reserved;
  long long due_ns;              // host clock of the last launch
  unsigned long long reserved2[5];
};
static_assert(sizeof(Waker) == 64, "one 64-byte line");

// A tensor slot that the kernel copies.
struct Slot {
  unsigned long long dev;    // the tensor's device address (each call)
  unsigned long long host;   // its slot in the staging region (device view)
  unsigned bytes;
  unsigned out;              // 0: operand, device -> staging; 1: back
};
static_assert(sizeof(Slot) == 24, "24-byte slots");

// rpc_post's argument.
struct Params {
  Record* rec;               // device view
  unsigned* counter;         // device memory: sequence, arrivals, release
  unsigned* inline_dst;      // the staging region's first word (device view)
  unsigned long long staging;
  unsigned long long timeout_ns;
  unsigned ticket;
  int n_inline;
  int n_slots;
  int out_grid;              // blocks that copy the out = 1 slots (0: none)
  unsigned words[kInlineWords];
  Slot slot[kSlots];
};
static_assert(sizeof(Params) <= 32764, "a kernel's parameters");

// A slot on the copy engines: a cudaMemcpyAsync between the tensor and
// the staging region's host address.
struct Copy {
  unsigned long long dev;
  unsigned long long host;
  unsigned long long bytes;
};

// One kind of round trip, filled by the plan; each call sets the slots'
// device addresses and the inline words in `params`.
struct Call {
  Params* params;
  Waker* waker;
  Copy* copy;                // n_copy_in device -> staging, then n_copy_out
  int grid;
  int n_copy_in;
  int n_copy_out;
};

}  // namespace rpc_channel

using namespace rpc_channel;

using mapped::copy_slot;
using mapped::global_ns;
using mapped::load_acquire_sys;
using mapped::store_release_sys;

namespace {

__device__ __forceinline__ void store_release_gpu(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned load_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A wait that outlives the channel's timeout traps: a lost host thread
// fails the run instead of hanging it.
__device__ __forceinline__ void check_timeout(unsigned long long t0,
                                              const Params& p,
                                              const char* what) {
  if (global_ns() - t0 > p.timeout_ns) {
    printf("rpc_post: no %s for staging %llu within %llu ns\n", what,
           p.staging, p.timeout_ns);
    __trap();
  }
}

__global__ void __launch_bounds__(kThreads)
    rpc_post(const __grid_constant__ Params p) {
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t nt = static_cast<size_t>(gridDim.x) * blockDim.x;
  const bool copies_out = static_cast<int>(blockIdx.x) < p.out_grid;
  unsigned* const arrivals = p.counter + 1;
  unsigned* const release = p.counter + 2;
  for (int s = 0; s < p.n_slots; ++s)
    if (!p.slot[s].out)
      copy_slot<false>(p.slot[s].host, p.slot[s].dev, p.slot[s].bytes, t, nt);
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < p.n_inline)
    p.inline_dst[threadIdx.x] = p.words[threadIdx.x];
  // Every thread's staging writes are visible to the host before its
  // block arrives; the last block to arrive publishes the record.
  __threadfence_system();
  __shared__ bool last;
  __shared__ unsigned generation;
  __syncthreads();
  if (threadIdx.x == 0) {
    generation = load_acquire_gpu(release);
    last = gridDim.x == 1 || atomicAdd(arrivals, 1u) == gridDim.x - 1;
    if (last && gridDim.x > 1) *arrivals = 0u;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence_system();
    Record* rec = p.rec;
    const unsigned seq = atomicAdd(p.counter, 1u) + 1u;
    rec->seq = seq;
    rec->staging = p.staging;
    rec->ticket = p.ticket;
    rec->status = 0;
    __threadfence_system();
    store_release_sys(&rec->state, kPosted);
    const unsigned long long t0 = global_ns();
    unsigned sleep_ns = 32;
    while (load_acquire_sys(&rec->state) != kDone) {
      check_timeout(t0, p, "reply");
      __nanosleep(sleep_ns);
      if (sleep_ns < 1024) sleep_ns <<= 1;
    }
    rec->waited_ns = global_ns() - t0;
    store_release_sys(&rec->state, kEmpty);
    if (p.out_grid && gridDim.x > 1)
      store_release_gpu(release, generation + 1u);
  }
  if (!copies_out) return;
  if (threadIdx.x == 0 && !last) {
    const unsigned long long t0 = global_ns();
    while (load_acquire_gpu(release) == generation) {
      check_timeout(t0, p, "release");
      __nanosleep(256);
    }
  }
  __syncthreads();
  const size_t nt_out = static_cast<size_t>(p.out_grid) * blockDim.x;
  for (int s = 0; s < p.n_slots; ++s)
    if (p.slot[s].out)
      copy_slot<true>(p.slot[s].dev, p.slot[s].host, p.slot[s].bytes, t,
                      nt_out);
}

long long now_ns() {
  timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return t.tv_sec * 1000000000LL + t.tv_nsec;
}

inline void cpu_relax() {
#if defined(__x86_64__)
  asm volatile("pause" ::: "memory");
#endif
}

// CUDA API calls made by rpc_roundtrip since the library was loaded (any
// thread may launch: counted atomically).
unsigned long long g_api_calls = 0;

inline void count_api_call() {
  __atomic_add_fetch(&g_api_calls, 1ull, __ATOMIC_RELAXED);
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
int rpc_params_bytes() { return sizeof(Params); }
int rpc_table_slots() { return kSlots; }
int rpc_call_bytes() { return sizeof(Call); }

// The most blocks an rpc_post grid has: one an SM, so the card always
// holds the whole grid at once (its cooperative launch needs that) and a
// call that waits for the host holds at most 256 of each SM's threads.
// -1 if the kernel cannot run a block.
int rpc_max_blocks(int device) {
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rpc_post,
                                                    kThreads, 0) ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) ||
      per_sm < 1)
    return -1;
  return sms;
}

// One call in stream order: mark a record due (and wake the drain), the
// copy-engine slots' operands device -> staging, the rpc_post launch, their
// results staging -> device.  Returns the first CUDA error, or 0.
int rpc_roundtrip(Call* c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Waker* w = c->waker;
  __atomic_store_n(&w->due_ns, now_ns(), __ATOMIC_RELAXED);
  c->params->ticket = __atomic_add_fetch(&w->launched, 1u, __ATOMIC_SEQ_CST);
  if (__atomic_load_n(&w->sleeping, __ATOMIC_SEQ_CST))
    syscall(SYS_futex, &w->launched, FUTEX_WAKE_PRIVATE, 1, nullptr, nullptr,
            0);
  for (int i = 0; i < c->n_copy_in; ++i) {
    const Copy& k = c->copy[i];
    count_api_call();
    cudaError_t e = cudaMemcpyAsync(reinterpret_cast<void*>(k.host),
                                    reinterpret_cast<void*>(k.dev), k.bytes,
                                    cudaMemcpyDeviceToHost, st);
    if (e != cudaSuccess) return e;
  }
  // A grid of several blocks waits on itself (the release word): it is
  // launched cooperatively, so the card starts it only when every block
  // fits beside whatever else runs.
  cudaLaunchAttribute cooperative;
  cooperative.id = cudaLaunchAttributeCooperative;
  cooperative.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c->grid);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cfg.attrs = &cooperative;
  cfg.numAttrs = c->grid > 1 ? 1 : 0;
  void* args[] = {c->params};
  count_api_call();
  cudaError_t e = cudaLaunchKernelExC(
      &cfg, reinterpret_cast<const void*>(rpc_post), args);
  if (e != cudaSuccess) return e;
  for (int i = c->n_copy_in; i < c->n_copy_in + c->n_copy_out; ++i) {
    const Copy& k = c->copy[i];
    count_api_call();
    e = cudaMemcpyAsync(reinterpret_cast<void*>(k.dev),
                        reinterpret_cast<void*>(k.host), k.bytes,
                        cudaMemcpyHostToDevice, st);
    if (e != cudaSuccess) return e;
  }
  return 0;
}

unsigned long long rpc_api_calls() {
  return __atomic_load_n(&g_api_calls, __ATOMIC_RELAXED);
}

// The channel's host-only words, zeroed; they live as long as the process.
void* rpc_waker_alloc() { return calloc(1, sizeof(Waker)); }

// Host side: wait up to timeout_us for a posted record.  While a launched
// record is due (a ticket not yet answered, marked less than due_us ago)
// it spins.  Otherwise it spins for the first spin_us (a burst of calls
// finds the thread awake), then sleeps on the waker's futex, which the
// next launch wakes, for naps of 20 us up to 10x spin_us and then of
// 500 us (an idle channel costs its process ~2000 wake-ups a second).
// Returns 1 with the record's staging id and the host clock (ns) when the
// post was seen written, 0 on timeout.
int rpc_wait(void* rec_host, void* waker, long long timeout_us,
             long long spin_us, long long due_us, unsigned long long* staging,
             long long* seen_ns) {
  Record* r = static_cast<Record*>(rec_host);
  Waker* w = static_cast<Waker*>(waker);
  const long long t0 = now_ns();
  bool napped = false;
  for (unsigned i = 1;; ++i) {
    if (__atomic_load_n(&r->state, __ATOMIC_ACQUIRE) == kPosted) {
      *staging = r->staging;
      *seen_ns = now_ns();
      return 1;
    }
    if (!napped && (i & 255) != 0) {
      cpu_relax();
      continue;
    }
    const long long now = now_ns(), dt = now - t0;
    if (dt > timeout_us * 1000) return 0;
    const unsigned launched = __atomic_load_n(&w->launched, __ATOMIC_SEQ_CST);
    const bool due =
        static_cast<int>(launched - __atomic_load_n(&w->served,
                                                    __ATOMIC_RELAXED)) > 0 &&
        now - __atomic_load_n(&w->due_ns, __ATOMIC_RELAXED) < due_us * 1000;
    napped = false;
    if (due || dt <= spin_us * 1000) {
      cpu_relax();
      continue;
    }
    timespec nap{0, dt <= 10 * spin_us * 1000 ? 20000 : 500000};
    __atomic_store_n(&w->sleeping, 1u, __ATOMIC_SEQ_CST);
    if (__atomic_load_n(&r->state, __ATOMIC_ACQUIRE) != kPosted &&
        __atomic_load_n(&w->launched, __ATOMIC_SEQ_CST) == launched)
      syscall(SYS_futex, &w->launched, FUTEX_WAIT_PRIVATE, launched, &nap,
              nullptr, 0);
    __atomic_store_n(&w->sleeping, 0u, __ATOMIC_SEQ_CST);
    napped = true;
  }
}

// Host side: publish the reply (the staging region's result and
// write-backs are written) with a release store of DONE; the record's
// ticket is answered.
void rpc_complete(void* rec_host, void* waker, unsigned status) {
  Record* r = static_cast<Record*>(rec_host);
  Waker* w = static_cast<Waker*>(waker);
  r->status = status;
  if (static_cast<int>(r->ticket - w->served) > 0)
    __atomic_store_n(&w->served, r->ticket, __ATOMIC_RELAXED);
  __atomic_store_n(&r->state, kDone, __ATOMIC_RELEASE);
}

// The drain thread's arguments and results, one struct so that each of its
// calls passes two arguments.
struct Drain {
  void* rec;
  void* waker;
  long long timeout_us, spin_us, due_us;
  unsigned long long staging;    // out: the posted record's staging id
  long long seen_ns;             // out: host clock when the post was seen
};

// The drain's one call: answer the record it served (status >= 0), then
// wait for the next (rpc_wait).  It does not take Python's lock between
// answering and waiting, when the caller's thread wants it back.
int rpc_drain(Drain* d, int status) {
  if (status >= 0) rpc_complete(d->rec, d->waker, status);
  return rpc_wait(d->rec, d->waker, d->timeout_us, d->spin_us, d->due_us,
                  &d->staging, &d->seen_ns);
}

// The latency floor: answer n records posted on rec_host, each as soon as
// it is seen, with no Python and no callee.  Run on a thread of its own
// (through ctypes, so without Python's lock).  Returns the records
// answered before timeout_us passed.
int rpc_floor_serve(void* rec_host, void* waker, int n, long long timeout_us) {
  Record* r = static_cast<Record*>(rec_host);
  const long long t0 = now_ns();
  for (int k = 0; k < n; ++k) {
    while (__atomic_load_n(&r->state, __ATOMIC_ACQUIRE) != kPosted) {
      if (now_ns() - t0 > timeout_us * 1000) return k;
      cpu_relax();
    }
    rpc_complete(rec_host, waker, 0);
  }
  return n;
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

// Batched host RPC (paper §3.2, §3.5): append one record to an on-device
// RpcQueue in one launch.
//
// Replaces no Pallas kernel.  The JAX package's enqueue
// (src/repro/core/rpc.py:2984, RpcQueue._enqueue) is about thirty array
// updates (row selects under `where`, the payloads' dynamic_update_slices,
// the head bumps) that XLA fuses into the jitted program.  Eager PyTorch
// would launch each of them, and a card's CUDA call costs tens of
// microseconds of host time, more than the immediate round trip that a
// batched call exists to avoid; so the whole enqueue is one launch here.
//
// Bound on the H100: the record's bytes at 3.35 TB/s (the row's lanes, the
// payload read once and written once, the heads), nanoseconds for a scalar
// record.  Launch latency bounds it in fact.
//
// Design.  Every scalar the host knows (a Python number, the callee id,
// the masks, the declared reply) rides as a kernel argument, so nothing is
// copied to the device first; 0-d tensors and payloads are read through
// their pointers on the device, converted to int32 words as JAX's
// `_payload_words` does (integers and bools as int32, floats as float32
// bits).  Every block reads `head`, `phead` and `where` before any block
// changes them and takes the same keep decision: keep = where and, for a
// record with payloads, phead + words <= capacity (else an atomic drop,
// counted in `adrops`).  The blocks copy the payloads (a grid-stride loop
// over each argument's words) to phead + the argument's static offset; the
// block that arrives last at the queue's arrival counter (an int32 in
// device memory, reset by that block) writes the row at head % capacity,
// bumps head and phead, counts a drop and writes the ticket (base + head,
// or -1).  A payload of up to 1024 words is one block and needs no
// counter.  Parameters are `__grid_constant__`, so a thread's lane reads
// its argument in place.
//
// A sanitized queue (`sanitize`, a kernel argument) brackets each payload
// reservation as [CANARY][words][CANARY], as JAX's enqueue does
// (src/repro/core/rpc.py:3044-3055): an argument's `offset` is then the
// reservation's start, its words and its descriptor one word in, and the
// record's `npay` (which the arena-full test reads) counts the canaries.
// An unsanitized queue's arena is as before.
//
// The host side (kernels/rpc_queue/kernel.py) packs a queue's lanes once
// and a record signature's static fields once, and patches per call only
// the immediate words, the source and `where` addresses and the ticket's.
// A record whose ticket nobody reads passes a null ticket, and the kernel
// writes none.  One instantiation takes every record (1,032 bytes of
// parameters): instantiations for at most 4 and 8 arguments, launched for
// records that fit them, measured no better on the H100 (PERF.md).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The kernel's parameters, named (not in the anonymous namespace) so the
// C entry that takes them keeps external linkage.
namespace rpc_queue {

// At most 31 arguments: imask and pmask are int32 bit masks (JAX's limit).
constexpr int kMaxArgs = 31;
constexpr int kThreads = 256;
// A block's share of the payload words in one launch, and the most blocks.
constexpr int kWordsPerBlock = 1024;
constexpr int kMaxBlocks = 264;
// JAX's CANARY (kernels/rpc_queue/ref.py).
constexpr int kCanary = 0x7FC0FFEE;

enum : int { kImmediate = 0, kDevice = 1, kPayload = 2 };
// Source dtypes (kernel.py::DTYPES).
enum : int {
  kF32 = 0, kBF16 = 1, kF16 = 2, kF64 = 3, kI32 = 4, kI64 = 5, kI16 = 6,
  kI8 = 7, kU8 = 8, kBool = 9
};

struct QueueLanes {
  int* callee;
  int* nargs;
  int* imask;
  int* pmask;
  int* ivals;
  int* fvals;  // float32 lanes as their bits
  int* plens;
  int* pbuf;
  int* head;
  int* phead;
  int* adrops;
  int* rwant;  // null on a queue without a reply arena
  int* base;
  unsigned* arrivals;
  int* ticket;
  int capacity;
  int width;
  int payload_capacity;
  int sanitize;  // 1: canary-bracketed payload reservations
};

struct RecordArg {
  const void* src;  // device scalar or payload
  int kind;
  int dtype;
  int is_int;       // int32 lane (1) or float32 lane (0)
  int length;       // payload words
  int offset;       // payload words into the record's reservation
  unsigned word;    // an immediate's 32 bits
};
static_assert(sizeof(RecordArg) == 32, "ctypes layout");

struct Record {
  int callee;
  int nargs;
  int imask;
  int pmask;
  int rwant;
  int npay;
  int where_mode;  // 0 none, 1 constant, 2 device bool
  int where_const;
  const unsigned char* where;
  RecordArg args[kMaxArgs];
};

}  // namespace rpc_queue

namespace {

using namespace rpc_queue;

__device__ __forceinline__ float as_float(const void* p, int dtype, long i) {
  switch (dtype) {
    case kF32: return static_cast<const float*>(p)[i];
    case kBF16: return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case kF16: return __half2float(static_cast<const __half*>(p)[i]);
    default: return static_cast<float>(static_cast<const double*>(p)[i]);
  }
}

__device__ __forceinline__ int as_int(const void* p, int dtype, long i) {
  switch (dtype) {
    case kI32: return static_cast<const int*>(p)[i];
    case kI64: return static_cast<int>(static_cast<const long long*>(p)[i]);
    case kI16: return static_cast<const short*>(p)[i];
    case kI8: return static_cast<const signed char*>(p)[i];
    case kU8: return static_cast<const unsigned char*>(p)[i];
    default: return static_cast<const unsigned char*>(p)[i] != 0;
  }
}

// Word i of an argument: an int32, or a float32's bits.
__device__ __forceinline__ int word_of(const void* p, int dtype, int is_int,
                                       long i) {
  return is_int ? as_int(p, dtype, i) : __float_as_int(as_float(p, dtype, i));
}

__global__ void __launch_bounds__(kThreads)
    rpc_enqueue(const __grid_constant__ QueueLanes q,
                const __grid_constant__ Record r) {
  const int head = *q.head;
  const int phead = *q.phead;
  bool keep = r.where_mode == 0   ? true
              : r.where_mode == 1 ? r.where_const != 0
                                  : *r.where != 0;
  bool dropped = false;
  if (r.npay) {
    const bool fits =
        static_cast<long long>(phead) + r.npay <= q.payload_capacity;
    dropped = keep && !fits;
    keep = keep && fits;
  }
  if (keep && r.npay) {
    const long stride = static_cast<long>(gridDim.x) * blockDim.x;
    for (int j = 0; j < r.nargs; ++j) {
      const RecordArg& a = r.args[j];
      if (a.kind != kPayload) continue;
      int* dst = q.pbuf + phead + a.offset + q.sanitize;
      for (long w = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
           w < a.length; w += stride)
        dst[w] = word_of(a.src, a.dtype, a.is_int, w);
      if (q.sanitize && blockIdx.x == 0 && threadIdx.x < 2)
        dst[threadIdx.x == 0 ? -1 : a.length] = kCanary;
    }
  }
  // Every read of the state above precedes every write below (in this
  // block by the barrier; across blocks by the arrival counter).
  __shared__ bool last;
  __syncthreads();
  if (gridDim.x > 1) {
    if (threadIdx.x == 0) {
      __threadfence();
      last = atomicAdd(q.arrivals, 1u) == gridDim.x - 1;
      if (last) *q.arrivals = 0u;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
  }
  const int cap = q.capacity;
  const long row = static_cast<long>(((head % cap) + cap) % cap);
  const int t = threadIdx.x;
  if (keep && t < q.width) {
    int iv = 0, fv = 0, pl = 0;
    if (t < r.nargs) {
      const RecordArg& a = r.args[t];
      if (a.kind == kPayload) {
        iv = phead + a.offset + q.sanitize;
        pl = a.length;
      } else {
        const int v = a.kind == kImmediate
                          ? static_cast<int>(a.word)
                          : word_of(a.src, a.dtype, a.is_int, 0);
        if (a.is_int)
          iv = v;
        else
          fv = v;
      }
    }
    q.ivals[row * q.width + t] = iv;
    q.fvals[row * q.width + t] = fv;
    q.plens[row * q.width + t] = pl;
  }
  if (t == 0) {
    if (keep) {
      q.callee[row] = r.callee;
      q.nargs[row] = r.nargs;
      q.imask[row] = r.imask;
      q.pmask[row] = r.pmask;
      if (q.rwant) q.rwant[row] = r.rwant;
      *q.head = static_cast<int>(static_cast<unsigned>(head) + 1u);
      if (r.npay) *q.phead = phead + r.npay;
    }
    if (dropped) *q.adrops += 1;
    if (q.ticket)
      *q.ticket = keep ? static_cast<int>(static_cast<unsigned>(*q.base) +
                                          static_cast<unsigned>(head))
                       : -1;
  }
}

}  // namespace

using rpc_queue::kMaxArgs;
using rpc_queue::QueueLanes;
using rpc_queue::Record;
using rpc_queue::RecordArg;

extern "C" {

int rpc_queue_max_args() { return kMaxArgs; }
int rpc_queue_arg_bytes() { return sizeof(RecordArg); }

// One record: copies the host's description into the kernel's parameters
// (a null `lanes->ticket` writes no ticket) and launches on `stream`.
// Returns the launch's CUDA error, or 0.
int rpc_enqueue_launch(const QueueLanes* lanes, const Record* record,
                       void* stream) {
  if (record->nargs < 0 || record->nargs > kMaxArgs ||
      lanes->width < 1 || lanes->width > kMaxArgs || lanes->capacity < 1)
    return cudaErrorInvalidValue;
  int blocks = (record->npay + rpc_queue::kWordsPerBlock - 1) /
               rpc_queue::kWordsPerBlock;
  blocks = blocks < 1 ? 1 : blocks > rpc_queue::kMaxBlocks
                                ? rpc_queue::kMaxBlocks : blocks;
  rpc_enqueue<<<blocks, rpc_queue::kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      *lanes, *record);
  return cudaGetLastError();
}

}  // extern "C"

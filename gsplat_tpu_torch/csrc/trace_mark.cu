// Stage marks: one-thread kernels that a CUDA graph keeps as nodes, so a
// replay still says where each stage of the call began on the card's clock.
//
// Replaces no TPU kernel: the JAX package's profiler sees the stages of a
// jitted program by name; a CUDA graph's replay shows one cudaGraphLaunch,
// and its host `record_function` spans are not replayed. A mark enqueued
// while a body is captured (gsplat_tpu_torch/utils/trace.py) becomes a node
// of the graph and runs on every replay.
//
// What bounds it on an H100: the launch. A mark reads one flag and, when
// recording is off, returns; when on, it takes `%globaltimer`, claims one
// slot of a ring with an atomicAdd on a cursor and writes 48 bytes there.
// Design: one thread, no shared memory, the timer read first so that it
// stands as close to the mark's start as the kernel can place it. A slot
// past the ring's end is not written; the cursor still counts it, so the
// host knows how many marks were lost.
//
// `gsplat_trace_clock` measures the offset between the host's
// CLOCK_MONOTONIC and `%globaltimer`: a one-thread kernel waits on a word in
// mapped host memory, and for each ping of the host answers with the timer
// and an acknowledgement. The host reads its clock before the ping and
// after the answer; the tightest bracket of `tries` is the measurement. Both
// sides give up after kTimeoutNs, so a kernel that never starts cannot hang
// the card or the host.

#include <cuda_runtime.h>
#include <stdint.h>
#include <time.h>

namespace {

// One record of the ring: the call, the stage, whether the mark ends the
// call or a copy (1) or begins a stage (0), the timer, a count read on the
// card (-1 without one) and a static number (the keys a sort ordered).
struct Record {
  long long call;
  long long stage;
  long long end;
  long long t_ns;
  long long count;
  long long keys;
};
static_assert(sizeof(Record) == 48, "a record is six int64 words");

constexpr long long kTimeoutNs = 2000000000LL;
constexpr int kMaxTries = 64;

__device__ __forceinline__ long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

__global__ void mark_kernel(const int* __restrict__ on,
                            unsigned long long* cursor, long long* calls,
                            Record* ring, long long capacity, int stage,
                            int end, int begins_call, int call_delta,
                            const void* count, int count_bytes,
                            long long keys) {
  if (*on == 0) return;
  const long long t = globaltimer();
  long long call;
  if (begins_call) {
    call = (long long)atomicAdd((unsigned long long*)calls, 1ULL) + 1;
  } else {
    call = *(volatile long long*)calls + call_delta;
  }
  const unsigned long long i = atomicAdd(cursor, 1ULL);
  if (i >= (unsigned long long)capacity) return;
  long long c = -1;
  if (count != nullptr) {
    c = count_bytes == 8 ? *(const long long*)count
                         : (long long)*(const int*)count;
  }
  Record r;
  r.call = call;
  r.stage = stage;
  r.end = end;
  r.t_ns = t;
  r.count = c;
  r.keys = keys;
  ring[i] = r;
}

__global__ void clock_kernel(volatile int* go, volatile int* ack,
                             volatile long long* t_dev, int tries) {
  const long long start = globaltimer();
  for (int i = 1; i <= tries; ++i) {
    while (*go < i) {
      if (*go < 0 || globaltimer() - start > kTimeoutNs) return;
    }
    t_dev[i - 1] = globaltimer();
    __threadfence_system();
    *ack = i;
    __threadfence_system();
  }
}

long long host_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (long long)ts.tv_sec * 1000000000LL + ts.tv_nsec;
}

}  // namespace

extern "C" int gsplat_trace_mark(const int* on, unsigned long long* cursor,
                                 long long* calls, void* ring,
                                 long long capacity, int stage, int end,
                                 int begins_call, int call_delta,
                                 const void* count, int count_bytes,
                                 long long keys, void* stream) {
  if (count != nullptr && count_bytes != 4 && count_bytes != 8) {
    return (int)cudaErrorInvalidValue;
  }
  mark_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      on, cursor, calls, (Record*)ring, capacity, stage, end, begins_call,
      call_delta, count, count_bytes, keys);
  return (int)cudaGetLastError();
}

// For i < tries: host_before[i] and host_after[i], CLOCK_MONOTONIC ns around
// the i-th ping, and dev_t[i], `%globaltimer` when the card answered it;
// tries <= kMaxTries. The mapped host words are allocated on the first call
// and kept, so a later measurement allocates nothing. Returns a CUDA error,
// or cudaErrorTimeout when the card did not answer.
extern "C" int gsplat_trace_clock(int tries, long long* host_before,
                                  long long* host_after, long long* dev_t,
                                  void* stream) {
  static void* host = nullptr;
  static void* dev = nullptr;
  if (tries <= 0 || tries > kMaxTries) return (int)cudaErrorInvalidValue;
  if (host == nullptr) {
    const size_t bytes = 16 + sizeof(long long) * (size_t)kMaxTries;
    cudaError_t err = cudaHostAlloc(&host, bytes, cudaHostAllocMapped);
    if (err == cudaSuccess) err = cudaHostGetDevicePointer(&dev, host, 0);
    if (err != cudaSuccess) {
      if (host != nullptr) cudaFreeHost(host);
      host = dev = nullptr;
      return (int)err;
    }
  }
  int* go = (int*)host;
  int* ack = go + 1;
  long long* t_host = (long long*)((char*)host + 16);
  __atomic_store_n(go, 0, __ATOMIC_SEQ_CST);
  __atomic_store_n(ack, 0, __ATOMIC_SEQ_CST);
  clock_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (int*)dev, (int*)dev + 1, (long long*)((char*)dev + 16), tries);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int result = (int)cudaSuccess;
  for (int i = 1; i <= tries && result == (int)cudaSuccess; ++i) {
    const long long before = host_ns();
    __atomic_store_n(go, i, __ATOMIC_SEQ_CST);
    while (__atomic_load_n(ack, __ATOMIC_SEQ_CST) < i) {
      if (host_ns() - before > kTimeoutNs) {
        __atomic_store_n(go, -1, __ATOMIC_SEQ_CST);
        result = (int)cudaErrorTimeout;
        break;
      }
    }
    host_before[i - 1] = before;
    host_after[i - 1] = host_ns();
  }
  err = cudaStreamSynchronize((cudaStream_t)stream);
  if (result == (int)cudaSuccess) {
    result = (int)err;
    for (int i = 0; i < tries; ++i) {
      dev_t[i] = __atomic_load_n(&t_host[i], __ATOMIC_SEQ_CST);
    }
  }
  return result;
}

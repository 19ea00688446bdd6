// K4: segmented suffix sum over the gid-major gradient stream.
//
// Replaces the TPU kernel gsplat_tpu/ops/pallas/segsum.py::_kernel. After
// the gather backward sorts the per-slot gradients by gid << kbits | k, each
// Gaussian's slots form one contiguous run; this kernel computes
//   out[f, j] = sum_{k >= j, k < j + depth, rows[k] == rows[j]} x[f, k]
// for the (F, M) float32 stream, so every run's total sits at its first
// slot. depth is kmax rounded up to a power of two: the reach of the plain
// version's doubling (ops/cuda/segsum.py), so the two agree even on a run
// longer than kmax (the invalid-slot tail, whose values are zero). The
// output is (F, M): the TPU kernel's padding of M to its block size has no
// counterpart.
//
// What bounds it on an H100: bytes. It must read the stream (F M 4 bytes)
// and the run ids (M 4 bytes) and write (F M 4 bytes), about 0.1 ms at the
// bench shape; the adds are a few per element. Design: one thread per
// position j, which walks right while the run id matches, at most depth
// steps, and sums each of the F rows over that span. Neighbouring threads
// read neighbouring addresses at every step, so the loads coalesce and the
// re-reads of a run hit in cache. There is no carry between blocks: CUDA
// blocks run in no order, and because runs are at most kmax long each output
// depends only on data its own thread reads (the TPU kernel's right-to-left
// carry has no counterpart). The cost is the sum over runs of L^2 / 2 reads;
// the invalid tail is one long run, and every position in it walks the full
// depth.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void segsum_kernel(const float* __restrict__ x,
                              const int32_t* __restrict__ rows, int64_t m,
                              int f, int depth, float* __restrict__ out) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const int32_t row = rows[j];
  const int64_t last = j + depth < m ? j + depth : m;
  int64_t k_end = j + 1;
  while (k_end < last && rows[k_end] == row) ++k_end;
  for (int r = 0; r < f; ++r) {
    const float* xr = x + r * m;
    float acc = 0.f;
    for (int64_t k = j; k < k_end; ++k) acc += xr[k];
    out[r * m + j] = acc;
  }
}

}  // namespace

extern "C" int gsplat_segsum(const float* x, const int32_t* rows, int64_t m,
                             int f, int depth, float* out, void* stream) {
  const int threads = 256;
  if (m > 0) {
    const int64_t blocks = (m + threads - 1) / threads;
    segsum_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        x, rows, m, f, depth, out);
  }
  return (int)cudaGetLastError();
}
